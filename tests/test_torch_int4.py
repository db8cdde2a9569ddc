"""The port's 4bit path against vlm_tpu on the CPU: grouped int4
quantization, unpacking and dequantization, the plain version of B7 (the
grouped int4 GEMM), the int4 ``Dense`` with its group fallback and row
dispatch, ``VLM_TPU_INT4_PREFILL``, the bridge over the 4bit tree, the 4bit
VLM and the continuous batcher with either KV cache; and the env fallbacks
``VLM_TPU_QUANT_VISION`` and ``VLM_TPU_KV_CACHE`` of the model class.

Inputs come from numpy seeds; the Pallas kernel runs in interpret mode as
the JAX package's own tests run it. Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from vlm_tpu.generate.batcher import ContinuousBatcher as JaxBatcher
from vlm_tpu.models.configs import paligemma_config as jax_config
from vlm_tpu.models.layers import Dense as JDense
from vlm_tpu.models.layers import _int4_prefill_mode as jax_int4_prefill_mode
from vlm_tpu.models.vlm import init_kv_cache as jax_init_cache
from vlm_tpu.models.vlm import init_vlm
from vlm_tpu.ops import quant as jq
from vlm_tpu_torch.generate.batcher import ContinuousBatcher
from vlm_tpu_torch.models.configs import paligemma_config
from vlm_tpu_torch.models.decoder import init_kv_cache
from vlm_tpu_torch.models.factory import create_model
from vlm_tpu_torch.models.layers import (Dense, int4_group_size,
                                         int4_prefill_mode)
from vlm_tpu_torch.models.vlm import VLMModule, num_image_tokens
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.ops import quant as tq
from vlm_tpu_torch.testing.bridge import flax_to_state_dict, load_flax_params

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _packed(q):
    """vlm_tpu's [in/2, out] bytes -> the port's [out, in/2]."""
    return _t(np.asarray(q).T)


# ------------------------------ quantize ------------------------------

@pytest.mark.parametrize("gs", [128, 64, 32, 16])
def test_quantize_int4_bitwise(gs):
    """Weights [in, out] in vlm_tpu, [out, in] in the port: packed bytes
    and group scales bit for bit, with an all-zero group (the 1e-8 floor),
    a group of abs-max 7 whose values sit on .5 ties (round half to even)
    and values at +-7."""
    rng = np.random.default_rng(gs)
    k, n = 256, 24
    w = rng.normal(size=(k, n)).astype(np.float32)
    w[:gs, 3] = 0.0                                   # a zero group
    w[gs:2 * gs, 5] = rng.choice([-7.0, 7.0, 2.5, -3.5, 0.5, -0.5, 6.5],
                                 gs)                  # scale 1: exact ties
    w[gs, 5] = 7.0
    ref = jq.quantize_int4(jnp.asarray(w), group_size=gs)
    got = tq.quantize_int4(_t(w.T), group_size=gs)
    assert got.q.dtype == torch.int8 and got.group_size == gs
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q).T)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale).T)
    nib = tq.unpack_int4(got.q).numpy()
    assert nib.min() >= -7 and nib.max() <= 7
    np.testing.assert_array_equal(nib[5, gs:2 * gs],
                                  np.round(w[gs:2 * gs, 5]))


@pytest.mark.parametrize("gs", [128, 64, 32, 16])
def test_unpack_and_dequantize_bitwise(gs):
    """Every byte value, so nibbles of -8 occur (random init draws bytes in
    [-112, 112)): sign-extended nibbles and ``nibble * scale`` rounded once,
    in fp32 and in bf16, bit for bit."""
    rng = np.random.default_rng(100 + gs)
    k, n = 512, 16
    q = rng.integers(-128, 128, (k // 2, n)).astype(np.int8)
    q[:128, 0] = np.arange(-128, 128).reshape(128, 2)[:, 0]
    q[:128, 1] = np.arange(-128, 128).reshape(128, 2)[:, 1]
    scale = (rng.random((k // gs, n)) / 64).astype(np.float32)
    ref = jq.QuantizedWeight(jnp.asarray(q), jnp.asarray(scale), gs)
    got = tq.QuantizedWeight(_packed(q), _t(scale.T), gs)
    nib = tq.unpack_int4(got.q)
    assert int(nib.min()) == -8 and int(nib.max()) == 7
    np.testing.assert_array_equal(nib.numpy(),
                                  np.asarray(jq._unpack_int4(ref.q)).T)
    np.testing.assert_array_equal(tq.dequantize(got).numpy(),
                                  np.asarray(jq.dequantize(ref)).T)
    np.testing.assert_array_equal(
        tq.dequantize(got, torch.bfloat16).float().numpy(),
        np.asarray(jq.dequantize(ref, jnp.bfloat16).astype(jnp.float32)).T)


# ------------------------------- B7 -------------------------------

@pytest.mark.parametrize("m,k,n,gs", [(9, 128, 100, 32), (9, 144, 100, 16),
                                      (32, 256, 64, 128), (300, 512, 96, 64)])
def test_b7_plain_matches_pallas_and_dequant(m, k, n, gs):
    """Against ``_int4_matmul_pallas`` in interpret mode (its dots run in
    fp32 there, over even and odd columns apart) and against
    ``quant_matmul(use_pallas=False)``: fp32 sums in another order over
    weights of lecun scale (outputs of order 1), atol = rtol = 1e-5."""
    rng = np.random.default_rng(m + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32) / np.sqrt(k)
    qw = jq.quantize_int4(jnp.asarray(w), group_size=gs)
    _lib.reset_counts()
    got = tq.int4_matmul(_t(x), _packed(qw.q), _t(np.asarray(qw.scale).T),
                         gs).numpy()
    assert _lib.plain_calls["int4_matmul"] == 1
    assert got.shape == (m, n)
    pallas = jq._int4_matmul_pallas(jnp.asarray(x), qw.q, qw.scale,
                                    group_size=gs, block_m=32, block_n=128)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    dq = jq.quant_matmul(jnp.asarray(x), qw, out_dtype=jnp.float32,
                         use_pallas=False)
    np.testing.assert_allclose(got, np.asarray(dq), **TOL)


# --------------------------- the int4 Dense ---------------------------

def _dense_pair(k, n=48, seed=0):
    jd = JDense(n, quant_bits=4, dtype=jnp.float32)
    params = meta.unbox(jd.init(jax.random.key(seed), jnp.zeros((1, k))))
    p = jax.tree.map(np.asarray, params)["params"]
    p["bias"] = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    params = {"params": p}
    td = Dense(k, n, quant_bits=4)
    load_flax_params(td, params)
    return jd, params, td


@pytest.mark.parametrize("m", [8, 600, 1536],
                         ids=["b7_m8", "dequant_m600", "gate_m1536"])
@pytest.mark.parametrize("k", [256, 144], ids=["gs128", "gs16"])
def test_dense_int4_matches_jax(m, k):
    """Bridged random-init weights (bytes with -8 nibbles) and a bias,
    below 512 rows and above (``vlm_tpu`` takes its dequantized product
    there; the port takes B7, whose plain version is that product, except
    from 1,536 rows at K % 32 != 0, where it takes that product too):
    fp32 sums in another order, atol = rtol = 1e-5."""
    jd, params, td = _dense_pair(k)
    assert td.group_size == {256: 128, 144: 16}[k]
    x = np.random.default_rng(3).normal(size=(m, k)).astype(np.float32)
    _lib.reset_counts()
    got = td(_t(x)).numpy()
    want = np.asarray(jd.apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)
    assert _lib.plain_calls["int4_matmul"] == (
        0 if m >= 1536 and k % 32 else 1)


@pytest.mark.parametrize("in_dim", [4304, 1152, 2048, 16384, 144, 64, 48])
def test_int4_group_fallback_and_init(in_dim):
    """The group and parameter shapes of ``vlm_tpu``'s int4 Dense (SigLIP
    mlp_dim 4304 -> 16, 1152 and the Gemma dims -> 128), and its init:
    bytes in [-112, 112), scale (1/in)^0.5 / 64 in fp32."""
    jd = JDense(2, quant_bits=4, dtype=jnp.float32)
    jp = meta.unbox(jd.init(jax.random.key(0), jnp.zeros((1, in_dim))))
    jp = jp["params"]
    d = Dense(in_dim, 2, quant_bits=4)
    assert tuple(d.q.shape) == jp["q_kernel"].shape[::-1]
    assert tuple(d.scale.shape) == jp["scale"].shape[::-1]
    assert d.group_size == in_dim // jp["scale"].shape[0] == \
        int4_group_size(in_dim)
    d.reset_parameters(torch.Generator().manual_seed(0))
    assert d.q.dtype == torch.int8 and d.scale.dtype == torch.float32
    assert int(d.q.min()) >= -112 and int(d.q.max()) < 112
    np.testing.assert_array_equal(d.scale.numpy(),
                                  np.asarray(jp["scale"]).T)


def test_int4_prefill_mode_validation(monkeypatch):
    """``dequant`` (default) is the port's mode; ``fused`` is on ROADMAP's
    do-not-port list; anything else is refused, as ``vlm_tpu`` refuses
    it."""
    assert int4_prefill_mode() == "dequant"
    monkeypatch.setenv("VLM_TPU_INT4_PREFILL", "DEQUANT")
    assert int4_prefill_mode() == jax_int4_prefill_mode() == "dequant"
    monkeypatch.setenv("VLM_TPU_INT4_PREFILL", "fused")
    assert jax_int4_prefill_mode() == "fused"
    with pytest.raises(NotImplementedError, match="do-not-port"):
        Dense(64, 8, quant_bits=4)
    monkeypatch.setenv("VLM_TPU_INT4_PREFILL", "fast")
    with pytest.raises(ValueError, match="VLM_TPU_INT4_PREFILL"):
        jax_int4_prefill_mode()
    with pytest.raises(ValueError, match="VLM_TPU_INT4_PREFILL"):
        Dense(64, 8, quant_bits=4)
    Dense(64, 8, quant_bits=8)                 # the int8 layers don't read it


# ------------------------------ the 4bit VLM ------------------------------

@pytest.fixture(scope="module")
def pair4():
    """vlm_tpu's 4bit VLM (int4 decoder and vision blocks, fp32 compute)
    and the port's, on the same weights through the bridge."""
    jcfg = jax_config("test")
    jmod, params = init_vlm(jcfg, jax.random.key(0), dtype=jnp.float32,
                            quant_bits=4, vision_quant_bits=4)
    cfg = paligemma_config("test")
    tmod = VLMModule(cfg, dtype=torch.float32, quant_bits=4,
                     vision_quant_bits=4)
    tree = jax.tree.map(np.asarray, meta.unbox(params))
    load_flax_params(tmod, tree)
    return jmod, params, tmod, cfg, tree


def test_bridge_covers_the_4bit_tree(pair4):
    """q_kernel [in/2, out] -> q [out, in/2]; a one-group scale [1, out]
    -> [out] in the state dict and [out, 1] in the module; a multi-group
    scale [g, out] -> [out, g]; norms and the unquantized layers as
    before; nothing missing or extra."""
    _, _, tmod, _, tree = pair4
    state = flax_to_state_dict(tree)
    own = tmod.state_dict()
    assert set(state) == set(own)
    gate = "decoder.blocks.0.mlp.gate_proj"
    assert state[f"{gate}.q"].dtype == torch.int8
    assert tuple(state[f"{gate}.q"].shape) == (128, 32)
    assert tuple(state[f"{gate}.scale"].shape) == (128,)
    assert tuple(own[f"{gate}.scale"].shape) == (128, 1)
    assert torch.equal(own[f"{gate}.q"], state[f"{gate}.q"])
    assert torch.equal(own[f"{gate}.scale"][:, 0], state[f"{gate}.scale"])
    assert "vision.blocks.1.fc2.q" in state
    assert "vision.patch_embed.weight" in state        # stays unquantized
    assert "decoder.blocks.0.input_norm.weight" in state
    _, params, td = _dense_pair(144, n=8)
    multi = flax_to_state_dict(params)["scale"]
    assert tuple(multi.shape) == (8, 9)
    np.testing.assert_array_equal(multi.numpy(),
                                  params["params"]["scale"].T)
    assert torch.equal(td.scale, multi)


def _vlm_inputs(cfg, b, n_post, seed):
    s = cfg.vision.image_size
    rng = np.random.default_rng(seed)
    px = rng.normal(size=(b, s, s, 3)).astype(np.float32)
    pre = rng.integers(3, 500, (b, 3)).astype(np.int32)
    post = rng.integers(3, 500, (b, n_post)).astype(np.int32)
    plen = np.full((b,), 3 + num_image_tokens(cfg) + n_post, np.int32)
    return px, pre, post, plen


@pytest.mark.parametrize("b,n_post,b7_prefill", [(2, 4, True),
                                                 (4, 130, False)],
                         ids=["b7_prefill_46rows", "dequant_prefill_596rows"])
@pytest.mark.parametrize("cache", ["compute", "int8"])
def test_4bit_vlm_logits_match_jax(pair4, b, n_post, b7_prefill, cache):
    """Prefill and one decode step of the 4bit VLM (int4 tower too) with
    either KV cache, against ``vlm_tpu``'s: both sides form the same fp32
    weights and differ only in summation order, so logits agree to
    atol = rtol = 1e-4 (the bf16 path's logit tolerance). 4 x 149 prompt
    rows take ``vlm_tpu``'s dequantized product, 2 x 23 its kernel; the
    port takes B7 (plain here) at both."""
    jmod, params, tmod, cfg, _ = pair4
    px, pre, post, plen = _vlm_inputs(cfg, b, n_post, seed=b)
    length = int(plen[0]) + 2
    dtype = "int8" if cache == "int8" else None
    jcache = jax_init_cache(cfg.decoder, b, length, dtype or jnp.float32)
    jlast, jcache = jmod.apply(params, jnp.asarray(px), jnp.asarray(pre),
                               jnp.asarray(post), jcache, jnp.asarray(plen),
                               method="prefill")
    tcache = init_kv_cache(cfg.decoder, b, length, dtype or torch.float32)
    _lib.reset_counts()
    last = tmod.prefill(_t(px), _t(pre), _t(post), tcache, _t(plen))
    # the tower's 2 or 4 x 16 rows and the decoder's at any row count take
    # B7: 7 Denses a block, 2 blocks
    tower = 6 * cfg.vision.layers
    assert _lib.plain_calls["int4_matmul"] == tower + 7 * cfg.decoder.layers
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **LOGIT_TOL)
    nxt = np.asarray(jnp.argmax(jlast, -1))[:, None].astype(np.int32)
    jstep, _ = jmod.apply(params, jnp.asarray(nxt), jnp.asarray(plen),
                          jcache, method="decode_step")
    step = tmod.decode_step(_t(nxt), _t(plen), tcache)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), **LOGIT_TOL)


def test_4bit_tower_dequant_branch_matches_jax(pair4):
    """32 images x 16 patches = 512 rows: ``vlm_tpu``'s tower takes its
    dequantized product there, the port's B7 (its plain version: the same
    product); features to fp32 rounding (atol 1e-5, rtol 1e-4, the bf16
    tower's tolerance)."""
    jmod, params, tmod, cfg, _ = pair4
    px = np.random.default_rng(4).normal(
        size=(32, cfg.vision.image_size, cfg.vision.image_size, 3)).astype(
        np.float32)
    _lib.reset_counts()
    got = tmod.encode_images(_t(px)).numpy()
    assert _lib.plain_calls["int4_matmul"] == 6 * cfg.vision.layers
    want = np.asarray(jmod.apply(params, jnp.asarray(px),
                                 method="encode_images"))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("cache", ["compute", "int8"])
@pytest.mark.parametrize("slots,admit,caps", [
    (3, 2, [5, 1, 3, 1, 2, 5, 1, 4, 2]),
    (4, 4, [6, 6, 2, 3, 6, 1, 5, 6, 4, 2, 6]),
], ids=["3slots_admit2", "4slots_admit4"])
def test_4bit_greedy_tokens_identical_to_jax_batcher(pair4, slots, admit,
                                                     caps, cache):
    """4bit weights through both continuous batchers, with the
    compute-dtype cache and with the int8 cache: identical greedy tokens
    per image."""
    jmod, params, tmod, cfg, _ = pair4
    jcfg = jax_config("test")
    n, max_new = len(caps), max(caps)
    px = np.random.default_rng(n).normal(
        size=(n, cfg.vision.image_size, cfg.vision.image_size, 3)).astype(
        np.float32)
    post = np.asarray([2, 7, 9], np.int32)
    plen = num_image_tokens(cfg) + len(post)
    run_kw = dict(pre_ids_row=np.zeros((0,), np.int32), post_ids_row=post,
                  prompt_len_scalar=plen, n_images=n, max_new_per_image=caps)
    int8 = cache == "int8"
    ref = JaxBatcher(jmod, jcfg, batch_size=slots, max_prompt_len=plen,
                     max_new_tokens=max_new,
                     cache_dtype="int8" if int8 else jnp.float32,
                     admit_block=admit).run(
        params, pixel_fn=lambda idxs: jnp.asarray(px[idxs]), **run_kw)
    _lib.reset_counts()
    got = ContinuousBatcher(tmod, cfg, batch_size=slots, max_prompt_len=plen,
                            max_new_tokens=max_new, admit_block=admit,
                            cache_dtype="int8" if int8 else None).run(
        lambda idxs: torch.from_numpy(px[idxs]), **run_kw)
    assert got == ref
    assert _lib.launches == dict.fromkeys(_lib.KERNELS, 0)
    assert _lib.plain_calls["int4_matmul"] > 0
    assert _lib.plain_calls["int8_matmul"] == 0
    written = "kv_write_int8" if int8 else "kv_write"
    assert _lib.plain_calls[written] > 0


def _images(tmp_path, n=3):
    from PIL import Image
    paths = []
    for i in range(n):
        p = tmp_path / f"{i}.png"
        Image.fromarray(np.random.default_rng(i).integers(
            0, 256, (40, 30, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


def test_4bit_model_class_serves(tmp_path):
    """``create_model(..., quantization="4bit")`` on the CPU: bf16 compute,
    packed int4 q [out, in/2] with fp32 group scales [out, in/gs] in every
    decoder block Dense, the bf16 tower, patch embedding, projector and
    tied head; serves through the continuous batcher."""
    m = create_model("paligemma", quantization="4bit", size="test",
                     device="cpu", batch_size=2)
    assert m.dtype == torch.bfloat16 and m.policy.quantized_bits == 4
    for blk in m.module.decoder.blocks:
        for d in (blk.attn.q_proj, blk.attn.k_proj, blk.attn.v_proj,
                  blk.attn.o_proj, blk.mlp.gate_proj, blk.mlp.up_proj,
                  blk.mlp.down_proj):
            assert d.q.dtype == torch.int8 and d.scale.dtype == torch.float32
            assert tuple(d.q.shape) == (d.out_dim, d.in_dim // 2)
            assert tuple(d.scale.shape) == (d.out_dim,
                                            d.in_dim // d.group_size)
    assert m.module.vision.blocks[0].fc1.weight.dtype == torch.bfloat16
    assert m.module.decoder.embed.weight.dtype == torch.bfloat16
    assert m.cache_dtype == torch.bfloat16
    _lib.reset_counts()
    texts = m.generate_dataset(_images(tmp_path), "color?", max_tokens=3)
    assert len(texts) == 3 and all(t is not None for t in texts)
    assert _lib.plain_calls["int4_matmul"] > 0
    assert _lib.plain_calls["kv_write"] > 0


# ------------------- the env fallbacks of the model class -------------------

def _vision_quantized_jax(model):
    block = model.params["params"]["vision"]["block_0"]
    return "q_kernel" in meta.unbox(block)["fc1"]


@pytest.mark.parametrize("quantization", ["8bit", "4bit"])
def test_quant_vision_env_fallback_matches_vlm_tpu(monkeypatch,
                                                   quantization):
    """``VLM_TPU_QUANT_VISION=1`` with ``quantize_vision`` unset quantizes
    the tower in both packages (the port built a bf16 tower before); an
    explicit ``quantize_vision=False`` still wins."""
    from vlm_tpu.models.factory import VLMModelFactory
    monkeypatch.setenv("VLM_TPU_QUANT_VISION", "1")
    jm = VLMModelFactory.create_model("paligemma", quantization=quantization,
                                      size="test")
    tm = create_model("paligemma", quantization=quantization, size="test",
                      device="cpu")
    assert _vision_quantized_jax(jm) and jm.vision_quant_bits == \
        tm.policy.quantized_bits
    fc1 = tm.module.vision.blocks[0].fc1
    assert tm.quantize_vision and fc1.quant_bits == jm.vision_quant_bits
    assert fc1.q.shape[::-1] == meta.unbox(
        jm.params["params"]["vision"]["block_0"]["fc1"]["q_kernel"]).shape
    off = create_model("paligemma", quantization=quantization, size="test",
                       device="cpu", quantize_vision=False)
    assert off.module.vision.blocks[0].fc1.quant_bits == 0
    monkeypatch.setenv("VLM_TPU_QUANT_VISION", "0")
    assert not create_model("paligemma", quantization=quantization,
                            size="test", device="cpu").quantize_vision


def test_kv_cache_env_fallback_matches_vlm_tpu(monkeypatch, tmp_path):
    """``VLM_TPU_KV_CACHE=int8`` with ``kv_cache`` unset gives the int8
    cache in both packages, read at generation time as ``vlm_tpu`` reads
    it (the port ignored it before); an explicit ``kv_cache`` wins."""
    from vlm_tpu.models.factory import VLMModelFactory
    tm = create_model("paligemma", quantization="4bit", size="test",
                      device="cpu", batch_size=2)
    jm = VLMModelFactory.create_model("paligemma", quantization="4bit",
                                      size="test")
    assert tm.cache_dtype == torch.bfloat16
    assert jm.kv_cache_dtype() == jnp.bfloat16
    monkeypatch.setenv("VLM_TPU_KV_CACHE", "int8")    # after both were built
    assert jm.kv_cache_dtype() == tm.cache_dtype == "int8"
    _lib.reset_counts()
    tm.generate_dataset(_images(tmp_path, 2), "color?", max_tokens=2)
    assert _lib.plain_calls["kv_write_int8"] > 0
    assert _lib.plain_calls["kv_write"] == 0
    explicit = create_model("paligemma", quantization="4bit", size="test",
                            device="cpu", kv_cache="bf16")
    assert explicit.cache_dtype == torch.bfloat16
    monkeypatch.delenv("VLM_TPU_KV_CACHE")
    assert create_model("paligemma", size="test", device="cpu",
                        kv_cache="int8").cache_dtype == "int8"
