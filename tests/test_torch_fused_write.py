"""B3's decode-step row write inside B2's launch, on the CPU.

``decode_attention(..., k_new=, v_new=, write_start=, uniform=)`` writes
each slot's new K and V row into the caches in place (an int8 cache:
quantized, values and scales) and attends over the caches with the row in
place. On the CPU it runs B3's plain write and then B2's plain attention;
the card runs both in one launch (``csrc/decode_attention.cu``).

- The plain path against ``vlm_tpu``: its writers (``kv_uniform_write`` /
  ``kv_scatter_write``, Pallas in interpret mode as the JAX package's tests
  run them; for a column outside the cache its masked write, since the
  interpreted writers clamp the column to the last row where B3 and the
  masked write write nothing) then ``flash_decode_attention`` (interpret).
  Caches bitwise; the output within atol = rtol = 1e-5 of the fp32
  attention over the written caches (``_xla_attention``), the tolerance of
  ``test_torch_decode_split.py`` (a bf16 cache: one bf16 ulp of the bf16
  output, 2^-7 at |out| < 2), and within 2e-2 of the TPU kernel, which
  rounds its probabilities to bf16.
- The kernel's ownership rule, emulated over ``split_plan``: for every
  column, exactly one block per (slot, kv head) writes the row, and every
  block whose rows hold it substitutes it for the cache's row, so the
  split-S result over the substituted tiles is the write followed by the
  attention.
- Greedy tokens of the "test" PaliGemma through both continuous batchers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from vlm_tpu.generate.batcher import ContinuousBatcher as JaxBatcher
from vlm_tpu.models.configs import paligemma_config as jax_config
from vlm_tpu.models.decoder import quantize_kv_rows as j_quantize_kv_rows
from vlm_tpu.models.vlm import init_vlm
from vlm_tpu.ops.attention import _xla_attention
from vlm_tpu.ops.decode_attention import flash_decode_attention
from vlm_tpu.ops.kvcache import kv_masked_write as j_masked
from vlm_tpu.ops.kvcache import kv_scatter_write as j_scatter
from vlm_tpu.ops.kvcache import kv_uniform_write as j_uniform
from vlm_tpu_torch.generate.batcher import ContinuousBatcher
from vlm_tpu_torch.models.configs import paligemma_config
from vlm_tpu_torch.models.decoder import quantize_kv_rows
from vlm_tpu_torch.models.vlm import VLMModule, num_image_tokens
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.ops.decode_attention import (NEG_INF, TILE_ROWS,
                                                TILE_ROWS_FP32,
                                                decode_attention,
                                                decode_attention_plain,
                                                live_rows, split_plan)
from vlm_tpu_torch.ops.preprocess import unfold_patches
from vlm_tpu_torch.testing.bridge import load_flax_params

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
B, H, S, D = 4, 8, 40, 64
PCOL, W = 30, 8
ACOL = np.asarray([0, 3, 7, 5], np.int32)
GCNT = np.asarray([4, 8, 0, 6], np.int32)

# (uniform, per-slot columns, mask): the batcher's rotating window at one
# shared column; per-slot columns with kv_len = column + 1 (the decode
# loop without a window), across the cache and outside it
CASES = {
    "window_uniform": (True, [PCOL + 3] * B, "window"),
    "kv_len_scatter": (False, [5, 39, 0, 17], "kv_len"),
    "outside_scatter": (False, [-1, S, 12, S + 3], "kv_len"),
    "outside_uniform": (True, [S] * B, "window"),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _inputs(kind, kvh, seed=0):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        x = rng.normal(size=shape).astype(np.float32)
        return _bf16(x) if kind == "bf16" else x
    return (normal(B, H, 1, D), normal(B, S, kvh, D), normal(B, S, kvh, D),
            normal(B, 1, kvh, D), normal(B, 1, kvh, D))


def _masks(cols, mode):
    """(the port's kwargs, the JAX kernel's kwargs, [B, S] liveness)."""
    rows = np.arange(S)[None, :]
    if mode == "window":
        key = np.where(rows < PCOL, -1, np.where(
            rows < PCOL + W, np.mod(rows - PCOL - ACOL[:, None], W), W))
        return (dict(kv_window=(PCOL, W, _t(ACOL), _t(GCNT))),
                dict(kv_window=(PCOL, W, jnp.asarray(ACOL),
                                jnp.asarray(GCNT))),
                key < GCNT[:, None])
    kv_len = np.clip(np.asarray(cols) + 1, 0, S).astype(np.int32)
    return (dict(kv_len=_t(kv_len)), dict(kv_len=jnp.asarray(kv_len)),
            rows < kv_len[:, None])


def _jax_write(ck, cv, kn, vn, cols, uniform):
    """vlm_tpu's write of one row a slot: the Pallas writers for columns
    inside the cache, its masked write otherwise."""
    start = jnp.asarray(cols, jnp.int32)
    inside = all(0 <= c < S for c in cols)
    if not inside:
        return j_masked(ck, kn, start), j_masked(cv, vn, start)
    return (j_uniform if uniform else j_scatter)(ck, cv, kn, vn, start)


@pytest.mark.parametrize("kvh", [1, 2], ids=["mqa", "gqa"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_fused_plain_matches_vlm_tpu(kind, case, kvh):
    uniform, cols, mode = CASES[case]
    q, k, v, kn, vn = _inputs(kind, kvh)
    port_kw, jax_kw, live = _masks(cols, mode)
    start = _t(np.asarray(cols[:1] if uniform else cols, np.int32))
    dt = torch.bfloat16 if kind == "bf16" else torch.float32
    qt = _t(q).to(dt)
    if kind == "int8":
        kq, ks = quantize_kv_rows(_t(k))
        vq, vs = quantize_kv_rows(_t(v))
        caches = [kq, vq, ks, vs]
        jk, jv = j_quantize_kv_rows(jnp.asarray(k)), \
            j_quantize_kv_rows(jnp.asarray(v))
        jkn, jvn = j_quantize_kv_rows(jnp.asarray(kn)), \
            j_quantize_kv_rows(jnp.asarray(vn))
        jq8 = _jax_write(jk.q, jv.q, jkn.q, jvn.q, cols, uniform)
        jsc = _jax_write(jk.scale, jv.scale, jkn.scale, jvn.scale, cols,
                         uniform)
        want_caches = [jq8[0], jq8[1], jsc[0], jsc[1]]
        scales = dict(k_scale=caches[2], v_scale=caches[3])
        jscales = dict(k_scale=want_caches[2], v_scale=want_caches[3])
    else:
        caches = [_t(k).to(dt), _t(v).to(dt)]
        jdt = jnp.bfloat16 if kind == "bf16" else jnp.float32
        want_caches = list(_jax_write(
            jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(kn, jdt),
            jnp.asarray(vn, jdt), cols, uniform))
        scales, jscales = {}, {}
    _lib.reset_counts()
    out = decode_attention(qt, caches[0], caches[1], **port_kw, **scales,
                           k_new=_t(kn).to(dt), v_new=_t(vn).to(dt),
                           write_start=start, uniform=uniform)
    assert _lib.plain_calls["kv_write_int8" if kind == "int8"
                            else "kv_write"] == 1
    # the caches, written in place: bitwise vlm_tpu's
    for got, want in zip(caches, want_caches):
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)))
    # the output: the fp32 attention over the written caches
    jq = jnp.asarray(q)
    ref = np.asarray(_xla_attention(
        jq, jnp.asarray(want_caches[0], jnp.float32),
        jnp.asarray(want_caches[1], jnp.float32), causal=False,
        scale=D ** -0.5, kv_valid=jnp.asarray(live), kv_layout="bshd",
        **{k_: jnp.asarray(x) for k_, x in jscales.items()}))
    rows = live.any(axis=1)
    got = out.float().numpy()
    tol = dict(atol=2.0 ** -7, rtol=0) if kind == "bf16" else TOL
    np.testing.assert_allclose(got[rows], ref[rows], **tol)
    assert (got[~rows] == 0).all()               # no live row: exactly 0
    # and the TPU kernel over the same caches (bf16 probabilities)
    kern = np.asarray(flash_decode_attention(
        jq if kind != "bf16" else jq.astype(jnp.bfloat16), want_caches[0],
        want_caches[1], **jax_kw, **jscales)).astype(np.float32)
    np.testing.assert_allclose(got, kern, atol=2e-2, rtol=0)


def test_fused_arguments_go_together():
    q, k, v, kn, vn = (_t(x) for x in _inputs("fp32", 1))
    with pytest.raises(ValueError, match="go together"):
        decode_attention(q, k, v, k_new=kn, v_new=vn)
    with pytest.raises(ValueError, match="go together"):
        decode_attention(q, k, v, k_new=kn, write_start=torch.zeros(1))


# ------------------------- the ownership rule -------------------------

def _blocks(s_total, h, kvh, b, sm, fp32):
    """The kernel's grid over one launch: (kv head, head group, slot,
    split, the split's first row) and its rows a split."""
    groups = -(-(h // kvh) // 8)
    tile, per_sm = (TILE_ROWS_FP32, 3) if fp32 else (TILE_ROWS, 2)
    splits, rows = split_plan(s_total, kvh * groups * b, sm, tile, per_sm)
    return [(kv, g, slot, z, z * rows) for kv in range(kvh)
            for g in range(groups) for slot in range(b)
            for z in range(splits)], rows, tile


def _fused_row(col, s_begin, rows, s_total):
    """``fused_row`` of decode_attention.cu: the column if this block's
    split holds it, else -1."""
    return col if s_begin <= col < min(s_total, s_begin + rows) else -1


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("s_total,h,kvh,b", [
    (348, 8, 1, 32),       # the serving window
    (348, 32, 2, 3),       # two head groups a kv head
    (2048, 8, 1, 2),       # many splits
    (100, 8, 8, 4),        # MHA, one split
])
def test_one_writer_and_every_holder_substitutes(fp32, s_total, h, kvh, b):
    blocks, rows, tile = _blocks(s_total, h, kvh, b, 132, fp32)
    for col in list(range(-2, s_total + 3)):
        writers, holders = {}, {}
        for kv, g, slot, z, s_begin in blocks:
            wpos = _fused_row(col, s_begin, rows, s_total)
            if wpos >= 0:
                holders.setdefault((slot, kv), set()).add((g, z))
                if g == 0:
                    writers[(slot, kv)] = writers.get((slot, kv), 0) + 1
            # the block's tiles leave out exactly the row it substitutes
            # (whole tiles cover its split; the tile that holds the row
            # is the only one that skips a copy)
            left_out = [r for t in range(-(-rows // tile))
                        for r in range(s_begin + t * tile,
                                       s_begin + (t + 1) * tile)
                        if r == wpos]
            assert left_out == ([wpos] if wpos >= 0 else [])
        if 0 <= col < s_total:
            assert writers == {(s, kv): 1 for s in range(b)
                               for kv in range(kvh)}
            groups = -(-(h // kvh) // 8)
            z = col // rows
            assert all(v == {(g, z) for g in range(groups)}
                       for v in holders.values())
            assert len(holders) == b * kvh
        else:
            assert not writers and not holders


def test_split_s_over_substituted_tiles_is_write_then_attend():
    """Every split reads its rows from the cache as it was before the
    launch, with the new row substituted where the split holds it; the
    merged result is the plain write followed by the plain attention."""
    rng = np.random.default_rng(9)
    b, h, s_total, d = 3, 8, 200, 32
    q = _t(rng.normal(size=(b, h, 1, d)).astype(np.float32))
    k = _t(rng.normal(size=(b, s_total, 1, d)).astype(np.float32))
    v = _t(rng.normal(size=(b, s_total, 1, d)).astype(np.float32))
    kn = _t(rng.normal(size=(b, 1, 1, d)).astype(np.float32))
    vn = _t(rng.normal(size=(b, 1, 1, d)).astype(np.float32))
    cols = torch.tensor([0, 64, 199], dtype=torch.int32)
    kv_len = cols + 1
    splits, rows = split_plan(s_total, b, 132)
    assert splits > 1
    live = live_rows(b, s_total, "cpu", kv_len=kv_len)
    parts = []
    for z in range(splits):
        lo, hi = z * rows, min(s_total, (z + 1) * rows)
        kt, vt = k[:, lo:hi].clone(), v[:, lo:hi].clone()
        for slot in range(b):
            wpos = _fused_row(int(cols[slot]), lo, rows, s_total)
            if wpos >= 0:
                kt[slot, wpos - lo] = kn[slot, 0]
                vt[slot, wpos - lo] = vn[slot, 0]
        s = torch.einsum("bhd,bsd->bhs", q[:, :, 0], kt[:, :, 0]) * d ** -0.5
        s = torch.where(live[:, None, lo:hi], s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(live[:, None, lo:hi], torch.exp(s - m), 0.0)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("bhs,bsd->bhd", p, vt[:, :, 0])))
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    wts = [torch.where(l > 0, torch.exp(m - mx), 0.0) for m, l, _ in parts]
    out = sum(w * a for w, (_, _, a) in zip(wts, parts)) / torch.clamp(
        sum(w * l for w, (_, l, _) in zip(wts, parts)), min=1e-30)
    kc, vc = k.clone(), v.clone()
    want = decode_attention(q, kc, vc, kv_len=kv_len, k_new=kn, v_new=vn,
                            write_start=cols, uniform=False)
    np.testing.assert_allclose(out.numpy(), want[:, :, 0].numpy(), **TOL)
    ref = decode_attention_plain(q, kc, vc, kv_len=kv_len)
    assert torch.equal(want, ref)


# ------------------------- greedy tokens -------------------------

def _pair(dtype, bits):
    jcfg = jax_config("test")
    jmod, params = init_vlm(jcfg, jax.random.key(0),
                            dtype=jnp.bfloat16 if dtype == torch.bfloat16
                            else jnp.float32,
                            quant_bits=bits, vision_quant_bits=bits)
    cfg = paligemma_config("test")
    tmod = VLMModule(cfg, dtype=dtype, quant_bits=bits,
                     vision_quant_bits=bits)
    load_flax_params(tmod, jax.tree.map(np.asarray, meta.unbox(params)))
    return jcfg, jmod, params, cfg, tmod


# (compute dtype, weight bits, cache). bf16 rounds at other places in the
# two frameworks, so a long run can flip a near tie; the 3-slot run below
# has none (a 4-slot, 11-image run flips one image, the same before the
# fused write: the CPU path is the plain write and attention either way)
MODES = {"bf16": (torch.bfloat16, 0, None),
         "8bit_int8kv": (torch.float32, 8, "int8"),
         "4bit": (torch.float32, 4, None)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_tokens_identical_to_vlm_tpu(mode):
    """The decode steps write through the fused call (one plain write a
    plain attention), the pixels enter the port as patch vectors, and
    every image's greedy tokens match vlm_tpu's."""
    dtype, bits, cache = MODES[mode]
    jcfg, jmod, params, cfg, tmod = _pair(dtype, bits)
    slots, admit, caps = 3, 2, [5, 1, 3, 1, 2, 5, 1, 4, 2]
    n, max_new = len(caps), max(caps)
    s = cfg.vision.image_size
    px = np.random.default_rng(n).normal(size=(n, s, s, 3)).astype(
        np.float32)
    if dtype == torch.bfloat16:
        px = _bf16(px)
    post = np.asarray([2, 7, 9], np.int32)
    plen = num_image_tokens(cfg) + len(post)
    run_kw = dict(pre_ids_row=np.zeros((0,), np.int32), post_ids_row=post,
                  prompt_len_scalar=plen, n_images=n, max_new_per_image=caps)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = JaxBatcher(jmod, jcfg, batch_size=slots, max_prompt_len=plen,
                     max_new_tokens=max_new,
                     cache_dtype=cache or jdt, admit_block=admit).run(
        params, pixel_fn=lambda idxs: jnp.asarray(px[idxs], jdt), **run_kw)
    _lib.reset_counts()
    got = ContinuousBatcher(tmod, cfg, batch_size=slots, max_prompt_len=plen,
                            max_new_tokens=max_new, admit_block=admit,
                            cache_dtype=cache or dtype).run(
        lambda idxs: unfold_patches(torch.from_numpy(px[idxs]).to(dtype),
                                    cfg.vision.patch_size), **run_kw)
    assert got == ref
    assert _lib.launches == dict.fromkeys(_lib.KERNELS, 0)
    b2 = "decode_attention_int8" if cache else (
        "decode_attention" if dtype == torch.bfloat16
        else "decode_attention_fp32")
    steps = _lib.plain_calls[b2]
    assert steps > 0
    if cache:    # the int8 prefill rows take B3's own int8 form too
        assert _lib.plain_calls["kv_write_int8"] == \
            steps + cfg.decoder.layers * -(-n // admit)
    else:        # the prefill is a slice copy: every write is a decode's
        assert _lib.plain_calls["kv_write"] == steps
