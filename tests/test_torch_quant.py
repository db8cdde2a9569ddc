"""The port's 8bit path against vlm_tpu on the CPU: int8 quantization, the
plain versions of B5 (weight-only int8 GEMM), B6 (int8 x int8 GEMM), and
the int8 forms of B2 (decode attention) and B3 (KV write), the int8
``Dense`` in every prefill mode, the 8bit VLM with the int8 KV cache and a
quantized vision tower, the bridge and the batcher.

Inputs come from numpy seeds; the Pallas kernels run in interpret mode as
the JAX package's own tests run them. Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from vlm_tpu.generate.batcher import ContinuousBatcher as JaxBatcher
from vlm_tpu.models.configs import paligemma_config as jax_config
from vlm_tpu.models.decoder import QuantizedKV as JQuantizedKV
from vlm_tpu.models.decoder import _write_kv as jax_write_kv
from vlm_tpu.models.decoder import dequantize_kv as jax_dequantize_kv
from vlm_tpu.models.decoder import quantize_kv_rows as jax_quantize_kv_rows
from vlm_tpu.models.layers import Dense as JDense
from vlm_tpu.models.vlm import init_kv_cache as jax_init_cache
from vlm_tpu.models.vlm import init_vlm
from vlm_tpu.ops import quant as jq
from vlm_tpu.ops.attention import _xla_attention
from vlm_tpu.ops.decode_attention import flash_decode_attention
from vlm_tpu_torch.generate.batcher import ContinuousBatcher
from vlm_tpu_torch.models.configs import paligemma_config
from vlm_tpu_torch.models.decoder import (QuantizedKV, dequantize_kv,
                                          init_kv_cache, quantize_kv_rows,
                                          write_kv)
from vlm_tpu_torch.models.layers import Dense
from vlm_tpu_torch.models.vlm import VLMModule, num_image_tokens
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.ops import quant as tq
from vlm_tpu_torch.ops.decode_attention import (decode_attention,
                                                decode_attention_plain)
from vlm_tpu_torch.testing.bridge import flax_to_state_dict, load_flax_params

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_values(rng, shape, scale=1.0):
    """fp32 values that bf16 represents exactly: the Pallas kernels round
    their activations to bf16, so only their accumulation order differs."""
    x = torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def _int8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


# ------------------------------ quantize ------------------------------

def test_quantize_int8_bitwise():
    """Weights [in, out] in vlm_tpu, [out, in] in the port: same q and
    scale, bit for bit."""
    w = np.random.default_rng(0).normal(size=(48, 24)).astype(np.float32)
    w[:, 3] = 0.0                                      # the 1e-8 floor
    ref = jq.quantize_int8(jnp.asarray(w))
    got = tq.quantize_int8(_t(w.T))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q).T)
    np.testing.assert_array_equal(got.scale.numpy(),
                                  np.asarray(ref.scale).reshape(-1))
    np.testing.assert_allclose(tq.dequantize(got).numpy(),
                               np.asarray(jq.dequantize(ref)).T, **TOL)
    # the int4 half is ported too: groups of 16 along in = 48
    ref4 = jq.quantize_int4(jnp.asarray(w), group_size=16)
    got4 = tq.quantize_int4(_t(w.T), group_size=16)
    np.testing.assert_array_equal(got4.q.numpy(), np.asarray(ref4.q).T)
    np.testing.assert_array_equal(got4.scale.numpy(),
                                  np.asarray(ref4.scale).T)
    with pytest.raises(ValueError, match="group_size"):
        tq.quantize_int4(_t(w.T))                  # 48 % 128 != 0


def test_quantize_activations_and_kv_rows_bitwise():
    """Many rows, so ties at .5 after the division and values at the
    clamp occur: round half to even and IEEE division, bit for bit."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(4, 300, 2, 64)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0
    qr, sr = jq.quantize_activations(jnp.asarray(x))
    q, s = tq.quantize_activations(_t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    kv = quantize_kv_rows(_t(x))
    jkv = jax_quantize_kv_rows(jnp.asarray(x))
    np.testing.assert_array_equal(kv.q.numpy(), np.asarray(jkv.q))
    np.testing.assert_array_equal(kv.scale.numpy(), np.asarray(jkv.scale))
    np.testing.assert_array_equal(
        dequantize_kv(kv, torch.bfloat16).float().numpy(),
        np.asarray(jax_dequantize_kv(jkv, jnp.bfloat16).astype(jnp.float32)))


# ------------------------------- B5 -------------------------------

@pytest.mark.parametrize("m,k,n", [(8, 64, 48), (37, 96, 80), (300, 32, 512)])
def test_b5_plain_matches_pallas_and_dequant(m, k, n):
    """Against ``_int8_matmul_pallas`` (interpret) and the dequantized
    product ``quant_matmul(use_pallas=False)``: fp32 sums in another order
    (and q*s formed first in the latter): atol = rtol = 1e-5."""
    rng = np.random.default_rng(m)
    x = _bf16_values(rng, (m, k))
    w = rng.normal(size=(k, n)).astype(np.float32)
    qw = jq.quantize_int8(jnp.asarray(w))
    got = tq.int8_matmul(_t(x), _t(np.asarray(qw.q).T),
                         _t(np.asarray(qw.scale).reshape(-1))).numpy()
    pallas = jq._int8_matmul_pallas(jnp.asarray(x), qw.q, qw.scale,
                                    block_m=32, block_n=128)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    dq = jq.quant_matmul(jnp.asarray(x), qw, out_dtype=jnp.float32,
                         use_pallas=False)
    np.testing.assert_allclose(got, np.asarray(dq), **TOL)


# ------------------------------- B6 -------------------------------

@pytest.mark.parametrize("m,k,n", [(64, 64, 128), (70, 144, 96)])
def test_b6_plain_matches_pallas_exactly(m, k, n):
    """Integer sums are exact and both apply ``float(acc) * sx * sw`` in
    that order: bitwise equal, and with unit scales the int32 sum itself."""
    rng = np.random.default_rng(k)
    qx, qw = _int8(rng, (m, k)), _int8(rng, (k, n))
    sx = rng.random((m, 1)).astype(np.float32) / 127
    sw = rng.random((1, n)).astype(np.float32) / 127
    ref = jq._int8xint8_matmul_pallas(jnp.asarray(qx), jnp.asarray(sx),
                                      jnp.asarray(qw), jnp.asarray(sw),
                                      block_m=32, block_n=128)
    got = tq.int8xint8_matmul(_t(qx), _t(sx), _t(qw.T), _t(sw.reshape(-1)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ones = tq.int8xint8_matmul(_t(qx), torch.ones(m, 1), _t(qw.T),
                               torch.ones(n))
    np.testing.assert_array_equal(
        ones.numpy(), (qx.astype(np.int64) @ qw.astype(np.int64)))
    bf16 = tq.int8xint8_matmul(_t(qx), _t(sx), _t(qw.T), _t(sw.reshape(-1)),
                               out_dtype=torch.bfloat16)
    assert torch.equal(bf16, got.to(torch.bfloat16))


# --------------------------- the int8 Dense ---------------------------

def _dense_pair(k=64, n=48, seed=0):
    jd = JDense(n, quant_bits=8, dtype=jnp.float32)
    params = meta.unbox(jd.init(jax.random.key(seed), jnp.zeros((1, k))))
    p = jax.tree.map(np.asarray, params)["params"]
    p["bias"] = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    params = {"params": p}
    td = Dense(k, n, quant_bits=8)
    load_flax_params(td, params)
    return jd, params, td


@pytest.mark.parametrize("mode,m", [("dynamic", 600), ("dynamic_noout", 600),
                                    ("dequant", 600), ("dynamic", 8)],
                         ids=["dynamic_m600", "dynamic_noout_m600",
                              "dequant_m600", "weight_only_m8"])
def test_dense_int8_matches_jax(monkeypatch, mode, m):
    """Every ``VLM_TPU_INT8_PREFILL`` mode at m = 600 and the weight-only
    product (B5) at m = 8, on bridged weights with a bias. The int8 modes
    take identical int8 activations and exact integer sums: the outputs
    agree to fp32 rounding (atol = rtol = 1e-5)."""
    monkeypatch.setenv("VLM_TPU_INT8_PREFILL", mode)
    jd, params, td = _dense_pair()
    assert td.int8_mode == mode
    x = np.random.default_rng(3).normal(size=(m, 64)).astype(np.float32)
    x[:, 5] *= 20                                  # an outlier column
    _lib.reset_counts()
    got = td(_t(x)).numpy()
    want = np.asarray(jd.apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)
    used = {k for k, v in _lib.plain_calls.items() if v}
    assert used == ({"int8_matmul"} if m < 512 else
                    set() if mode == "dequant" else {"int8xint8_matmul"})


def test_dense_int8_params_and_mode_validation(monkeypatch):
    d = Dense(16, 8, quant_bits=8)
    gen = torch.Generator().manual_seed(0)
    d.reset_parameters(gen)
    assert d.q.dtype == torch.int8 and d.q.shape == (8, 16)
    assert int(d.q.min()) >= -112 and int(d.q.max()) < 112
    assert d.scale.dtype == torch.float32
    assert float(d.scale[0]) == np.float32((1 / 16) ** 0.5 / 64)
    assert not hasattr(d, "weight")
    monkeypatch.setenv("VLM_TPU_INT8_PREFILL", "fast")
    with pytest.raises(ValueError, match="VLM_TPU_INT8_PREFILL"):
        Dense(16, 8, quant_bits=8)


# ------------------------------- B2 int8 -------------------------------

B, S, W, PCOL = 4, 40, 8, 30


def _window_valid(acol, gcnt):
    cols = np.arange(S)[None, :]
    j = np.mod(cols - PCOL - acol[:, None], W)
    key = np.where(cols < PCOL, -1, np.where(cols < PCOL + W, j, W))
    return key < gcnt[:, None]


@pytest.mark.parametrize("kvh", [1, 2], ids=["mqa", "gqa"])
@pytest.mark.parametrize("mode", ["window", "kv_len", "kv_valid"])
def test_b2_int8_plain_matches_xla_and_decode_kernel(mode, kvh):
    """int8 cache with per-row scales on scores and probabilities, against
    ``_xla_attention`` with the scales (fp32: atol = rtol = 1e-5) and the
    TPU kernel's has_scales mode (interpret; it rounds its probabilities to
    bf16: atol 2e-2 on outputs below 2)."""
    rng = np.random.default_rng(10 + kvh)
    d = 64
    q = _bf16_values(rng, (B, 8, 1, d))
    k8, v8 = _int8(rng, (B, S, kvh, d)), _int8(rng, (B, S, kvh, d))
    ks = (0.5 + rng.random((B, S, kvh, 1))).astype(np.float32) / 64
    vs = (0.5 + rng.random((B, S, kvh, 1))).astype(np.float32) / 64
    acol = np.asarray([0, 3, 7, 5], np.int32)
    gcnt = np.asarray([1, 8, 0, 4], np.int32)
    kv_len = np.asarray([S, 17, 0, 33], np.int32)
    targs, jargs = {}, {}
    if mode == "window":
        valid = _window_valid(acol, gcnt)
        targs["kv_window"] = (PCOL, W, _t(acol), _t(gcnt))
        jargs["kv_window"] = (PCOL, W, jnp.asarray(acol), jnp.asarray(gcnt))
    elif mode == "kv_len":
        valid = np.arange(S)[None, :] < kv_len[:, None]
        targs["kv_len"], jargs["kv_len"] = _t(kv_len), jnp.asarray(kv_len)
    else:
        valid = rng.random((B, S)) < 0.5
        valid[2] = False
        targs["kv_valid"], jargs["kv_valid"] = _t(valid), jnp.asarray(valid)
    _lib.reset_counts()
    port = decode_attention(_t(q), _t(k8), _t(v8), k_scale=_t(ks),
                            v_scale=_t(vs), **targs).numpy()
    assert _lib.plain_calls["decode_attention_int8"] == 1
    live = valid.any(axis=1)
    xla = np.asarray(_xla_attention(
        jnp.asarray(q), jnp.asarray(k8.astype(np.float32)),
        jnp.asarray(v8.astype(np.float32)), causal=False, scale=d ** -0.5,
        kv_valid=jnp.asarray(valid), kv_layout="bshd",
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    np.testing.assert_allclose(port[live], xla[live], **TOL)
    assert (port[~live] == 0).all()
    kern = np.asarray(flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), **jargs))
    np.testing.assert_allclose(port, kern, atol=2e-2, rtol=0)


def test_b2_scales_go_with_int8_caches_only():
    q = torch.zeros(1, 2, 1, 8)
    c8 = torch.zeros(1, 4, 1, 8, dtype=torch.int8)
    s = torch.ones(1, 4, 1, 1)
    with pytest.raises(ValueError, match="k_scale"):
        decode_attention_plain(q, c8, c8)
    with pytest.raises(ValueError, match="together"):
        decode_attention(q, c8, c8, k_scale=s)
    with pytest.raises(ValueError, match="int8 cache"):
        decode_attention(q, c8.float(), c8.float(), k_scale=s, v_scale=s)


# ------------------------------- B3 int8 -------------------------------

@pytest.mark.parametrize("case", ["uniform", "scatter", "prefill"])
def test_b3_int8_plain_matches_write_kv_bitwise(case):
    """``write_kv`` on ``QuantizedKV`` layers against ``_write_kv`` (the
    Pallas write in interpret mode for one row, the slice update for the
    prefill): int8 values and fp32 scales bit for bit."""
    rng = np.random.default_rng(20)
    b, length, kvh, d = 3, 12, 2, 16
    s = 5 if case == "prefill" else 1

    def layer():
        return (_int8(rng, (b, length, kvh, d)),
                rng.random((b, length, kvh, 1)).astype(np.float32))
    ck, cv = layer(), layer()
    k = (rng.normal(size=(b, s, kvh, d)) * 2).astype(np.float32)
    v = (rng.normal(size=(b, s, kvh, d)) * 2).astype(np.float32)
    start = {"uniform": [7, 7, 7], "scatter": [7, 0, 11],
             "prefill": [0, 0, 0]}[case]
    start = np.asarray(start, np.int32)
    jk, jv = jax_write_kv(
        JQuantizedKV(*map(jnp.asarray, ck)),
        JQuantizedKV(*map(jnp.asarray, cv)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(start),
        uniform=case != "scatter")
    tk = QuantizedKV(*(_t(a.copy()) for a in ck))
    tv = QuantizedKV(*(_t(a.copy()) for a in cv))
    _lib.reset_counts()
    write_kv(tk, tv, _t(k), _t(v), 0 if case == "prefill" else _t(start),
             uniform=case != "scatter")
    assert _lib.plain_calls["kv_write_int8"] == 1
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))


def test_int8_cache_layout():
    cfg = paligemma_config("test").decoder
    cache = init_kv_cache(cfg, 2, 10, "int8")
    jcache = jax_init_cache(cfg, 2, 10, "int8")
    for layer, jlayer in zip(cache["k"] + cache["v"],
                             jcache["k"] + jcache["v"]):
        assert isinstance(layer, QuantizedKV)
        assert layer.q.dtype == torch.int8
        assert layer.scale.dtype == torch.float32
        assert tuple(layer.q.shape) == jlayer.q.shape
        assert tuple(layer.scale.shape) == jlayer.scale.shape


# ------------------------------ the 8bit VLM ------------------------------

@pytest.fixture(scope="module")
def pair8():
    """vlm_tpu's 8bit VLM (int8 decoder and vision blocks, fp32 compute)
    and the port's, on the same weights through the bridge."""
    jcfg = jax_config("test")
    jmod, params = init_vlm(jcfg, jax.random.key(0), dtype=jnp.float32,
                            quant_bits=8, vision_quant_bits=8)
    cfg = paligemma_config("test")
    tmod = VLMModule(cfg, dtype=torch.float32, quant_bits=8,
                     vision_quant_bits=8)
    tree = jax.tree.map(np.asarray, meta.unbox(params))
    load_flax_params(tmod, tree)
    return jmod, params, tmod, cfg, tree


def test_bridge_covers_the_8bit_tree(pair8):
    """q_kernel -> q [out, in] and a Dense's scale -> scale [out]; a norm's
    scale still -> weight; nothing missing or extra."""
    _, _, tmod, _, tree = pair8
    state = flax_to_state_dict(tree)
    assert set(state) == set(tmod.state_dict())
    blk = "decoder.blocks.0"
    assert state[f"{blk}.mlp.gate_proj.q"].dtype == torch.int8
    assert tuple(state[f"{blk}.mlp.gate_proj.q"].shape) == (128, 64)
    assert tuple(state[f"{blk}.mlp.gate_proj.scale"].shape) == (128,)
    assert f"{blk}.input_norm.weight" in state
    assert "vision.blocks.1.fc2.q" in state
    assert "vision.patch_embed.weight" in state        # stays unquantized
    assert "projector.proj.weight" in state


def _vlm_inputs(cfg, b, n_post, seed):
    s = cfg.vision.image_size
    rng = np.random.default_rng(seed)
    px = rng.normal(size=(b, s, s, 3)).astype(np.float32)
    pre = rng.integers(3, 500, (b, 3)).astype(np.int32)
    post = rng.integers(3, 500, (b, n_post)).astype(np.int32)
    plen = np.full((b,), 3 + num_image_tokens(cfg) + n_post, np.int32)
    return px, pre, post, plen


def _prefill_and_decode(pair8, b, n_post, seed):
    jmod, params, tmod, cfg, _ = pair8
    px, pre, post, plen = _vlm_inputs(cfg, b, n_post, seed)
    length = int(plen[0]) + 2
    jcache = jax_init_cache(cfg.decoder, b, length, "int8")
    jlast, jcache = jmod.apply(params, jnp.asarray(px), jnp.asarray(pre),
                               jnp.asarray(post), jcache, jnp.asarray(plen),
                               method="prefill")
    cache = init_kv_cache(cfg.decoder, b, length, "int8")
    last = tmod.prefill(_t(px), _t(pre), _t(post), cache, _t(plen))
    nxt = np.asarray(jnp.argmax(jlast, -1))[:, None].astype(np.int32)
    jstep, _ = jmod.apply(params, jnp.asarray(nxt), jnp.asarray(plen),
                          jcache, method="decode_step")
    step = tmod.decode_step(_t(nxt), _t(plen), cache)
    return (last.numpy(), np.asarray(jlast)), (step.numpy(), np.asarray(jstep))


def test_8bit_vlm_weight_only_path_matches_jax(pair8):
    """b x prompt < 512 rows: every int8 product is the weight-only one (B5)
    and the int8 cache holds the same rows: logits to fp32 rounding
    (atol = rtol = 1e-4, the bf16 path's logit tolerance)."""
    _lib.reset_counts()
    (last, jlast), (step, jstep) = _prefill_and_decode(pair8, 2, 4, seed=1)
    np.testing.assert_allclose(last, jlast, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(step, jstep, atol=1e-4, rtol=1e-4)
    assert _lib.plain_calls["int8xint8_matmul"] == 0
    assert min(_lib.plain_calls[k] for k in (
        "int8_matmul", "kv_write_int8", "decode_attention_int8")) > 0


def _within_two_int8_steps(got, want):
    """|got - want| <= 2/127 of max|want|: two int8 steps at the output's
    own scale. fp32 activations that differ from XLA's in the last ulp can
    move an int8 activation across a rounding boundary by one step (1/127
    of its row's abs-max) where a product quantizes them; the flip then
    spreads through the later layers. Measured: 1.8e-3 of 0.64 on the
    prefill logits, 1.5e-2 of 4.2 on the tower's features."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 / 127 * np.abs(want).max())


def test_8bit_vlm_llm_int8_prefill_matches_jax(pair8):
    """4 x 149 = 596 prefill rows take llm.int8 (outlier decomposition + B6
    plain): prefill and decode logits within two int8 steps (see
    ``_within_two_int8_steps``)."""
    _lib.reset_counts()
    (last, jlast), (step, jstep) = _prefill_and_decode(pair8, 4, 130, seed=2)
    assert _lib.plain_calls["int8xint8_matmul"] > 0
    _within_two_int8_steps(last, jlast)
    _within_two_int8_steps(step, jstep)


def test_quantized_vision_tower_matches_jax(pair8):
    """32 images x 16 patches = 512 rows: the tower's int8 Denses take the
    llm.int8 path; features within two int8 steps."""
    jmod, params, tmod, cfg, _ = pair8
    px = np.random.default_rng(4).normal(
        size=(32, cfg.vision.image_size, cfg.vision.image_size, 3)).astype(
        np.float32)
    _lib.reset_counts()
    got = tmod.encode_images(_t(px)).numpy()
    assert _lib.plain_calls["int8xint8_matmul"] > 0
    want = np.asarray(jmod.apply(params, jnp.asarray(px),
                                 method="encode_images"))
    _within_two_int8_steps(got, want)


@pytest.mark.parametrize("slots,admit,caps", [
    (3, 2, [5, 1, 3, 1, 2, 5, 1, 4, 2]),
    (4, 4, [6, 6, 2, 3, 6, 1, 5, 6, 4, 2, 6]),
], ids=["3slots_admit2", "4slots_admit4"])
def test_8bit_int8kv_greedy_tokens_identical_to_jax_batcher(pair8, slots,
                                                            admit, caps):
    """8bit weights and the int8 KV cache through both continuous batchers:
    identical greedy tokens per image (admissions stay below 512 rows, so
    no activation is quantized and no boundary flip can occur)."""
    jmod, params, tmod, cfg, _ = pair8
    jcfg = jax_config("test")
    n, max_new = len(caps), max(caps)
    px = np.random.default_rng(n).normal(
        size=(n, cfg.vision.image_size, cfg.vision.image_size, 3)).astype(
        np.float32)
    post = np.asarray([2, 7, 9], np.int32)
    plen = num_image_tokens(cfg) + len(post)
    run_kw = dict(pre_ids_row=np.zeros((0,), np.int32), post_ids_row=post,
                  prompt_len_scalar=plen, n_images=n, max_new_per_image=caps)
    ref = JaxBatcher(jmod, jcfg, batch_size=slots, max_prompt_len=plen,
                     max_new_tokens=max_new, cache_dtype="int8",
                     admit_block=admit).run(
        params, pixel_fn=lambda idxs: jnp.asarray(px[idxs]), **run_kw)
    _lib.reset_counts()
    got = ContinuousBatcher(tmod, cfg, batch_size=slots, max_prompt_len=plen,
                            max_new_tokens=max_new, admit_block=admit,
                            cache_dtype="int8").run(
        lambda idxs: torch.from_numpy(px[idxs]), **run_kw)
    assert got == ref
    assert _lib.launches == dict.fromkeys(_lib.KERNELS, 0)
    assert min(_lib.plain_calls[k] for k in (
        "int8_matmul", "kv_write_int8", "decode_attention_int8")) > 0
    assert _lib.plain_calls["kv_write"] == 0


def test_8bit_model_class_serves(tmp_path):
    """``VLMModel`` with 8bit, the int8 cache and the quantized tower on
    the CPU: bf16 compute, int8 block weights everywhere but the patch
    embedding, the projector and the tied head."""
    from vlm_tpu_torch.models.factory import create_model
    m = create_model("paligemma", quantization="8bit", kv_cache="int8",
                     quantize_vision=True, size="test", device="cpu",
                     batch_size=2)
    assert m.dtype == torch.bfloat16 and m.cache_dtype == "int8"
    mod = m.module
    assert mod.decoder.blocks[0].attn.q_proj.q.dtype == torch.int8
    assert mod.vision.blocks[0].fc1.q.dtype == torch.int8
    assert mod.vision.patch_embed.weight.dtype == torch.bfloat16
    assert mod.projector.proj.weight.dtype == torch.bfloat16
    from PIL import Image
    paths = []
    for i in range(3):
        p = tmp_path / f"{i}.png"
        Image.fromarray(np.random.default_rng(i).integers(
            0, 256, (40, 30, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    _lib.reset_counts()
    texts = m.generate_dataset(paths, "color?", max_tokens=3)
    assert len(texts) == 3 and all(t is not None for t in texts)
    assert _lib.plain_calls["kv_write_int8"] > 0
    assert _lib.plain_calls["kv_write"] == 0
