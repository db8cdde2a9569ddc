"""The fp32 forms of B1, B2 and B4 (the card's kernels for models that run
with quantization "fp32") on the CPU: their plain versions against the JAX
ops on fp32 inputs made with numpy from a seed, and a numpy emulation of
each CUDA kernel's order of work against the plain version.

Tolerance: 1e-5 of the largest output (``REL``), the fp32 sums being taken
in another order (XLA's einsum, the kernels' tiles and warps), and XLA's
normalisation maybe fusing its multiply-add.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlm_tpu.ops.attention import _xla_attention
from vlm_tpu.ops.preprocess import RECIPES as J_RECIPES
from vlm_tpu.ops.preprocess import _normalize_jnp, _normalize_pallas
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.ops.attention import (KEYS_FP32, ROWS_FP32,
                                         attention_plain, flash_attention,
                                         flash_plan, fp32_key_split,
                                         fp32_rows)
from vlm_tpu_torch.ops.decode_attention import (HEADS_PER_BLOCK,
                                                TILE_ROWS_FP32,
                                                decode_attention,
                                                decode_attention_plain,
                                                live_rows, split_plan)
from vlm_tpu_torch.ops.preprocess import RECIPES, normalize_images
from vlm_tpu_torch.testing.kernel_checks import row_limits

torch.set_num_threads(2)
REL = 1e-5
NEG_INF = -1e30


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


# (name, causal, sq, sk, kv_len, prefix_len), the masks B1's fp32 form
# takes, a keyless row (kv_len 0) among them
B1_MODES = [
    ("none", False, 40, 40, None, None),
    ("kv_len", False, 40, 40, [33, 0], None),
    ("causal_offset", True, 9, 40, None, None),
    ("causal_dead_rows", True, 40, 24, None, None),
    ("prefix_kv_len", True, 40, 40, [36, 40], [12, 3]),
]
# SigLIP's head dim, Gemma's MQA, and GQA
B1_SHAPES = [(72, 4, 4), (256, 4, 1), (64, 8, 2)]


def _b1_inputs(seed, h, kvh, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, h, sq, d)).astype(np.float32),
            rng.normal(size=(2, kvh, sk, d)).astype(np.float32),
            rng.normal(size=(2, kvh, sk, d)).astype(np.float32))


def _opt(a, fn):
    return None if a is None else fn(np.asarray(a, np.int32))


@pytest.mark.parametrize("shape", B1_SHAPES, ids=["d72", "d256_mqa",
                                                  "d64_gqa"])
@pytest.mark.parametrize("mode", B1_MODES, ids=[m[0] for m in B1_MODES])
def test_b1_fp32_plain_matches_xla(mode, shape):
    _, causal, sq, sk, kv_len, prefix = mode
    d, h, kvh = shape
    q, k, v = _b1_inputs(0, h, kvh, sq, sk, d)
    _lib.reset_counts()
    port = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                           kv_len=_opt(kv_len, _t),
                           prefix_len=_opt(prefix, _t))
    assert port.dtype == torch.float32
    assert _lib.plain_calls["flash_attention_fp32"] == 1
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, scale=d ** -0.5,
                         kv_len=_opt(kv_len, jnp.asarray),
                         prefix_len=_opt(prefix, jnp.asarray))
    _close(port, ref)


def tf32(x):
    """fp32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero: ``cvt.rna.tf32.f32``. Adding half an ulp to the magnitude bits
    and cutting rounds half away (finite values)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split_tf32(x):
    """x = hi + lo, as ``vlm::split_tf32``: hi = tf32(x) and lo = x - hi
    (exact in fp32), of which the tensor core reads the top 10 mantissa
    bits: truncated."""
    x = np.asarray(x, np.float32)
    hi = tf32(x)
    lo = np.ascontiguousarray(x - hi).view(np.uint32)
    return hi, (lo & np.uint32(0xFFFFE000)).view(np.float32)


def mma_tf32(a, b, terms=3, parts=1):
    """a [M, K] b [K, N] as the kernels take it on m16n8k8: steps of 8 along
    K, each step's products exact and summed in fp32, into fp32
    accumulators; ``terms`` 3: lo.hi + hi.lo (small) and hi.hi (big), the
    fp32 forms' three TF32 products; 1: hi.hi alone. ``parts`` 4 keeps
    steps j, j + 4, ... in their own accumulators (B2's scores). Returns the
    accumulators summed: big + small within a part, then the parts."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    m, kdim = a.shape
    acc = np.zeros((parts, 2, m, b.shape[1]), np.float32)
    for j, k0 in enumerate(range(0, kdim, 8)):
        sl = slice(k0, k0 + 8)
        acc[j % parts, 1] += (ah[:, sl] @ bh[sl]).astype(np.float32)
        if terms == 3:
            acc[j % parts, 0] += (al[:, sl] @ bh[sl]).astype(np.float32)
            acc[j % parts, 0] += (ah[:, sl] @ bl[sl]).astype(np.float32)
    return sum(acc[i, 1] + acc[i, 0] for i in range(parts))


def b1_fp32_key_tiles(plan, tile, sq, sk, causal, kv_len, prefix_len):
    """How many 32-key tiles block ``tile`` of B1's fp32 form loads (the
    lines under "the block's key range" in csrc/flash_attention_fp32.cu):
    those holding a live key of one of its rows; every tile where a row has
    no live key, so it averages V over all ``sk`` keys."""
    p0 = tile * plan.positions
    ends = row_limits(np.array([p0, min(p0 + plan.positions, sq) - 1]), sq,
                      sk, causal, kv_len, prefix_len)
    keys = sk if ends[0] <= 0 else int(ends[1])
    return -(-keys // KEYS_FP32)


def _emulate_b1_fp32(q, k, v, causal, kv_len, prefix, terms=3, ks=None,
                     rows=None):
    """``csrc/flash_attention_fp32.cu`` in numpy, block by block: the rows
    ``flash_plan(..., rows)`` packs, the key tiles the block loads (from
    tile (position tile index) mod (their count) on, wrapping around),
    S = Q K^T and O += P V as ``terms`` TF32 products a product, the
    scores scaled to base 2 and masked after the products (-1e30; -inf past
    Sk). ``ks`` (default ``fp32_key_split(D)``) warps share a row group,
    each with its own running max, sum and output over its 32 / ks keys of
    every 32-key tile, merged at the end; ``rows`` (default ``fp32_rows``
    on 132 SMs) rows a block. Returns the output and the tiles loaded over
    the grid."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    ks = fp32_key_split(d) if ks is None else ks
    rows = fp32_rows(b, h, kvh, sq, d, 132) if rows is None else rows
    plan = flash_plan(b, h, kvh, sq, rows)
    hpb, npos = plan.heads_per_block, plan.positions
    out = np.full(q.shape, np.nan, np.float32)
    loaded = 0
    c = np.float32(d ** -0.5 * np.log2(np.e))
    part = KEYS_FP32 // ks
    for bi in range(b):
        kvl = None if kv_len is None else int(kv_len[bi])
        pfx = None if prefix is None else int(prefix[bi])
        for tile in range(plan.grid[0]):
            for hg in range(plan.grid[1]):
                r = np.arange(rows)
                pos = tile * npos + r // hpb
                head = hg * hpb + r % hpb
                kv = head[0] // (h // kvh)
                lim = row_limits(pos, sq, sk, causal, kvl, pfx)
                qb = q[bi, head, np.minimum(pos, sq - 1)] * (pos < sq)[:, None]
                n = b1_fp32_key_tiles(plan, tile, sq, sk, causal, kvl, pfx)
                loaded += n
                warps = []
                for w in range(ks):
                    m = np.full(rows, -np.inf, np.float32)
                    den = np.zeros(rows, np.float32)
                    acc = np.zeros((rows, d), np.float32)
                    for i in range(n):    # from tile (tile index) mod n
                        t = (i + tile) % n
                        kj = t * KEYS_FP32 + w * part + np.arange(part)
                        kt = np.where((kj < sk)[:, None],
                                      k[bi, kv, np.minimum(kj, sk - 1)], 0)
                        vt = np.where((kj < sk)[:, None],
                                      v[bi, kv, np.minimum(kj, sk - 1)], 0)
                        x = mma_tf32(qb, kt.T, terms) * c
                        x = np.where(kj[None] < lim[:, None], x, NEG_INF)
                        x = np.where(kj[None] < sk, x,
                                     -np.inf).astype(np.float32)
                        m_new = np.maximum(m, x.max(axis=1))
                        base = np.where(m_new == -np.inf, 0, m_new)
                        corr = np.exp2(m - base)
                        p = np.exp2(x - base[:, None]).astype(np.float32)
                        den = den * corr + p.sum(axis=1)
                        acc = acc * corr[:, None] + mma_tf32(p, vt, terms)
                        m = m_new
                    warps.append((m, den, acc))
                m, den, acc = warps[0]
                for m2, den2, acc2 in warps[1:]:
                    mm = np.maximum(m, m2)
                    wa, wb = np.exp2(m - mm), np.exp2(m2 - mm)
                    den = den * wa + den2 * wb
                    acc = acc * wa[:, None] + acc2 * wb[:, None]
                live = pos < sq
                out[bi, head[live], pos[live]] = acc[live] / den[live, None]
    assert not np.isnan(out).any()               # every row written once
    return out, loaded


def _b1_emulation_case(mode, h, kvh, d, seed, terms=3, ks=None, rows=None):
    _, causal, sq, sk, kv_len, prefix = mode
    q, k, v = _b1_inputs(seed, h, kvh, sq, sk, d)
    got, _ = _emulate_b1_fp32(q, k, v, causal, kv_len, prefix, terms, ks,
                              rows)
    want = attention_plain(_t(q), _t(k), _t(v), causal=causal,
                           kv_len=_opt(kv_len, _t),
                           prefix_len=_opt(prefix, _t)).numpy()
    return got, want


@pytest.mark.parametrize("mode", B1_MODES, ids=[m[0] for m in B1_MODES])
def test_b1_fp32_kernel_order_matches_plain(mode):
    """GQA (G = 4, D = 64), two heads of a group a block."""
    _close(*_b1_emulation_case(mode, 8, 2, 64, 1))


@pytest.mark.parametrize("shape", [(72, 4, 4), (256, 8, 1)],
                         ids=["d72", "d256_mqa"])
@pytest.mark.parametrize("mode", B1_MODES, ids=[m[0] for m in B1_MODES])
def test_b1_fp32_kernel_order_at_path_dims(mode, shape):
    """SigLIP's D = 72 (one head a block, one warp a row group) and
    Gemma's MQA D = 256 (all 8 heads a block, two warps a row group),
    every mask mode; "kv_len" has a row with no key."""
    d, h, kvh = shape
    assert fp32_key_split(d) == (2 if d == 256 else 1)
    _close(*_b1_emulation_case(mode, h, kvh, d, 2))


# and 12 keys: the second warp of a row group never sees a key
B1_SPLIT_MODES = B1_MODES + [("sk12", False, 20, 12, None, None)]


@pytest.mark.parametrize("mode", B1_SPLIT_MODES,
                         ids=[m[0] for m in B1_SPLIT_MODES])
def test_b1_fp32_key_split_matches_plain(mode):
    """Two warps a row group at D = 72, where the plan takes one: the
    merge of the key halves, with a half tile past Sk (40 keys: keys 48-63
    of the second tile do not exist) and a warp with no key at all."""
    _close(*_b1_emulation_case(mode, 4, 4, 72, 8, ks=2))


@pytest.mark.parametrize("mode", B1_MODES, ids=[m[0] for m in B1_MODES])
def test_b1_fp32_80_rows_match_plain(mode):
    """Gemma's MQA at D = 256 in blocks of 80 rows (10 positions x 8
    heads), the plan where 64-row blocks overrun one round of the SMs."""
    _close(*_b1_emulation_case(mode, 8, 1, 256, 9, rows=80))


@pytest.mark.parametrize("d", [72, 256])
def test_one_tf32_product_is_not_fp32(d):
    """Why three products: hi.hi alone (1xTF32, 11 significant bits an
    operand) misses ``REL`` by more than 10x, while the three products
    meet it on the same inputs."""
    mode = B1_MODES[1]
    got1, want = _b1_emulation_case(mode, 4, 1, d, 3, terms=1)
    got3, _ = _b1_emulation_case(mode, 4, 1, d, 3)
    scale = np.abs(want).max()
    assert np.abs(got1 - want).max() > 10 * REL * scale
    assert np.abs(got3 - want).max() <= REL * scale


def test_b1_fp32_plan_and_key_tiles():
    """The fp32 form's blocks: 64 rows, all 8 Gemma heads of 8 positions;
    SigLIP 64 positions of one head; tiles of 32 keys, skipped past a
    block's last live key but never for a row with none."""
    gemma = flash_plan(4, 8, 1, 316, ROWS_FP32)
    assert (gemma.heads_per_block, gemma.positions) == (8, 8)
    assert gemma.grid == (40, 1, 4)
    assert flash_plan(4, 16, 16, 256, ROWS_FP32).grid == (4, 16, 4)
    # 64-row blocks give Gemma 160 blocks, more than 132 SMs, each filled
    # by one: 80-row blocks give 128; SigLIP keeps 64 (256 blocks, 2-3 an
    # SM), and so does a grid that fits either way
    assert fp32_rows(4, 8, 1, 316, 256, 132) == 80
    assert flash_plan(4, 8, 1, 316, 80).grid == (32, 1, 4)
    assert fp32_rows(4, 16, 16, 256, 72, 132) == ROWS_FP32
    assert fp32_rows(1, 8, 1, 316, 256, 132) == ROWS_FP32
    assert fp32_rows(4, 64, 1, 316, 256, 132) == ROWS_FP32   # 64 heads
    tiles = lambda **kw: [b1_fp32_key_tiles(gemma, t, 316, 316, **kw)  # noqa: E731
                          for t in range(gemma.grid[0])]
    assert tiles(causal=False, kv_len=None, prefix_len=None) == [10] * 40
    assert tiles(causal=False, kv_len=100, prefix_len=None) == [4] * 40
    assert tiles(causal=False, kv_len=0, prefix_len=None) == [10] * 40
    assert tiles(causal=True, kv_len=None, prefix_len=None) == [
        -(-8 * (t + 1) // 32) for t in range(40)]
    _, short = _emulate_b1_fp32(*_b1_inputs(4, 8, 1, 64, 256, 8), False,
                                [70, 10], None)
    assert short == 8 * 3 + 8 * 1


# ------------------------------- B2 -------------------------------

B, S, W, PCOL = 4, 40, 8, 30


def _b2_inputs(d, h, kvh, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, h, 1, d)).astype(np.float32),
            rng.normal(size=(B, S, kvh, d)).astype(np.float32),
            rng.normal(size=(B, S, kvh, d)).astype(np.float32))


def _b2_masks(mode):
    acol = np.asarray([0, 3, 7, 5], np.int32)
    gcnt = np.asarray([1, 8, 0, 4], np.int32)      # slot 2: no live row
    if mode == "window":
        return dict(kv_window=(PCOL, W, _t(acol), _t(gcnt)))
    if mode == "kv_len":
        return dict(kv_len=_t(np.asarray([S, 17, 0, 33], np.int32)))
    valid = np.random.default_rng(3).random((B, S)) < 0.5
    valid[2] = False
    return dict(kv_valid=_t(valid))


@pytest.mark.parametrize("shape", [(256, 8, 1), (64, 8, 2)],
                         ids=["d256_mqa", "d64_gqa"])
@pytest.mark.parametrize("mode", ["window", "kv_len", "kv_valid"])
def test_b2_fp32_plain_matches_xla(mode, shape):
    d, h, kvh = shape
    q, k, v = _b2_inputs(d, h, kvh, 4)
    masks = _b2_masks(mode)
    _lib.reset_counts()
    port = decode_attention(_t(q), _t(k), _t(v), **masks).numpy()
    assert _lib.plain_calls["decode_attention_fp32"] == 1
    valid = live_rows(B, S, "cpu", **masks).numpy()
    live = valid.any(axis=1)
    ref = np.asarray(_xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        scale=d ** -0.5, kv_valid=jnp.asarray(valid), kv_layout="bshd"))
    _close(port[live], ref[live])
    assert (port[~live] == 0).all()      # a slot with no live row: 0


def _emulate_b2_fp32(q, k, v, valid, terms=3, sm=132):
    """B2's fp32 form (``decode_fp32_kernel``) in numpy: ``split_plan`` cuts
    S into splits of 32-row tiles; in a block of a split, warp w takes rows
    16 w .. 16 w + 15 of each tile with its running (max, sum, acc) per
    head: S^T = K Q^T (Q scaled by D^-1/2) in even and odd 8-dim steps,
    O^T = V^T P^T, each as ``terms`` TF32 products; masked rows weigh 0,
    the max starts at -1e30. The block merges its 2 warps, the last block
    the splits in split order (a part with l = 0 weighs 0), the sum clamped
    at 1e-30."""
    b, h, _, d = q.shape
    s_total, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    groups = -(-g // HEADS_PER_BLOCK)
    splits, per = split_plan(s_total, kvh * groups * b, sm, TILE_ROWS_FP32, 3)
    out = np.zeros((b, h, 1, d), np.float32)

    def merge(parts):
        mx = np.max([pt[0] for pt in parts], axis=0)
        w = [np.where(pt[1] > 0, np.exp(pt[0] - mx), 0).astype(np.float32)
             for pt in parts]
        lsum = sum(wt * pt[1] for wt, pt in zip(w, parts))
        return mx, lsum, sum(wt[:, None] * pt[2] for wt, pt in zip(w, parts))

    for bi in range(b):
        for n in range(kvh):
            for h0 in range(0, g, HEADS_PER_BLOCK):
                heads = n * g + np.arange(h0, min(h0 + HEADS_PER_BLOCK, g))
                qs = q[bi, heads, 0] * np.float32(d ** -0.5)
                blocks = []
                for z in range(splits):
                    warps = []
                    for w in range(2):
                        m = np.full(len(heads), NEG_INF, np.float32)
                        l = np.zeros(len(heads), np.float32)
                        acc = np.zeros((len(heads), d), np.float32)
                        for r0 in range(z * per, min((z + 1) * per, s_total),
                                        TILE_ROWS_FP32):
                            rows = r0 + 16 * w + np.arange(16)
                            ok = rows < s_total
                            rows = np.minimum(rows, s_total - 1)
                            lv = ok & valid[bi, rows]
                            kt = k[bi, rows, n] * ok[:, None]
                            vt = v[bi, rows, n] * ok[:, None]
                            s = mma_tf32(kt, qs.T, terms, parts=4).T
                            s = np.where(lv[None], s, NEG_INF)
                            mn = np.maximum(m, s.max(axis=1))
                            c = np.exp(m - mn)
                            p = np.where(lv[None], np.exp(s - mn[:, None]),
                                         0).astype(np.float32)
                            l = l * c + p.sum(axis=1)
                            acc = acc * c[:, None] + mma_tf32(vt.T, p.T,
                                                              terms).T
                            m = mn
                        warps.append((m, l, acc))
                    blocks.append(merge(warps))
                _, lsum, acc = merge(blocks)
                out[bi, heads, 0] = acc / np.maximum(lsum, 1e-30)[:, None]
    return out


B2_MODES = ["window", "kv_len", "kv_valid"]


def _b2_emulation_case(mode, d, h, kvh, seed, terms=3):
    q, k, v = _b2_inputs(d, h, kvh, seed)
    masks = _b2_masks(mode)
    valid = live_rows(B, S, "cpu", **masks).numpy()
    got = _emulate_b2_fp32(q, k, v, valid, terms)
    want = decode_attention_plain(_t(q), _t(k), _t(v), **masks).numpy()
    assert (want[~valid.any(axis=1)] == 0).all()     # no live row: 0
    return got, want


@pytest.mark.parametrize("mode", B2_MODES)
def test_b2_fp32_kernel_order_matches_plain(mode):
    """GQA (G = 4, D = 64): half of the mma's 8 heads idle."""
    _close(*_b2_emulation_case(mode, 64, 8, 2, 5))


@pytest.mark.parametrize("d", [72, 256])
@pytest.mark.parametrize("mode", B2_MODES)
def test_b2_fp32_kernel_order_at_path_dims(mode, d):
    """Gemma's MQA (8 heads a block) at D = 256 and at D = 72, cut into 2
    splits of one 32-row tile (the plan for 3 SMs); a slot with no live row
    returns 0."""
    q, k, v = _b2_inputs(d, 8, 1, 6)
    masks = _b2_masks(mode)
    valid = live_rows(B, S, "cpu", **masks).numpy()
    assert split_plan(S, B, 3, TILE_ROWS_FP32, 3) == (2, 32)
    got = _emulate_b2_fp32(q, k, v, valid, sm=3)
    want = decode_attention_plain(_t(q), _t(k), _t(v), **masks).numpy()
    _close(got, want)
    assert (got[~valid.any(axis=1)] == 0).all()


def test_b2_one_tf32_product_is_not_fp32():
    got, want = _b2_emulation_case("kv_len", 256, 8, 1, 7, terms=1)
    assert np.abs(got - want).max() > 10 * REL * np.abs(want).max()


# ------------------------------- B4 -------------------------------

@pytest.mark.parametrize("name", ["paligemma", "llava", "blip2"])
def test_b4_fp32_plain_matches_jax(name):
    """Within ``REL`` of ``_normalize_pallas`` and ``_normalize_jnp`` (XLA
    on the CPU may fuse the multiply-add into one rounding; the plain
    version and the kernel round twice, and agree bitwise on the card)."""
    u8 = np.random.default_rng(6).integers(0, 256, (2, 32, 32, 3),
                                           dtype=np.uint8)
    _lib.reset_counts()
    port = normalize_images(_t(u8), recipe=RECIPES[name],
                            compute_dtype=torch.float32).numpy()
    assert _lib.plain_calls["normalize_fp32"] == 1
    jr = J_RECIPES[name]
    mean = jnp.asarray(jr.mean, jnp.float32)
    std = jnp.asarray(jr.std, jnp.float32)
    pallas = np.asarray(_normalize_pallas(jnp.asarray(u8),
                                          1.0 / (255.0 * std), -mean / std,
                                          jnp.float32))
    _close(port, pallas)
    _close(port, _normalize_jnp(jnp.asarray(u8), mean, std, jnp.float32))
