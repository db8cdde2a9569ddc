"""B2's split-S plan and merge algebra on the CPU.

The CUDA kernel (``vlm_tpu_torch/csrc/decode_attention.cu``) cuts the S
cache rows into splits of whole 64-row tiles (``split_plan``); inside a
split each of 4 warps keeps a running (max m, sum l, acc) over its 16 rows
of every tile, the block merges its warps, and the last block merges the
splits. Merging partials (m_z, l_z, acc_z): M = max m_z, w_z = exp(m_z - M)
(0 where l_z = 0: no live row), out = sum w_z acc_z / max(sum w_z l_z,
1e-30). These tests rebuild that hierarchy in fp32 and hold it against
``decode_attention_plain``, tolerance atol = rtol = 1e-5, so the algebra
the kernel runs is the plain version's softmax.

With fewer than 8 query heads a KV head the cut is ``few_plan``'s (splits
and ring depth from the blocks an SM holds); the same hierarchy under that
plan, the layout of its fragments (``row_of``, the int8 dims, the chunk
swizzles: mirrors of ``csrc/decode_attention.cu``) and its int8 widening
(``widen4``) are held here too.
"""

import numpy as np
import pytest
import torch

from vlm_tpu_torch.ops.decode_attention import (FEW_MAX_STAGES,
                                                HEADS_PER_BLOCK, MAX_SPLITS,
                                                NEG_INF, TILE_ROWS,
                                                decode_attention_plain,
                                                few_heads, few_plan,
                                                live_rows, split_plan)
from vlm_tpu_torch.ops.quant import quantize_activations

WARPS, WARP_ROWS = 4, 16
TOL = dict(atol=1e-5, rtol=1e-5)


# ------------------------------- the plan -------------------------------

@pytest.mark.parametrize("s_total,blocks,sm", [
    (348, 32, 132),      # the serving window: 32 slots x 348 rows
    (348, 28, 132),
    (2048, 4, 132),      # a long cache for few slots
    (2048, 1, 132),      # one slot: capped at MAX_SPLITS
    (1, 3, 132),
    (64, 32, 132),
    (65, 32, 132),       # a ragged last tile
    (100, 256, 132),     # more blocks than two an SM: no split
    (8192, 2, 132),
    (0, 4, 132),
])
def test_split_plan_covers_s_with_nonempty_splits(s_total, blocks, sm):
    splits, rows = split_plan(s_total, blocks, sm)
    n_tiles = max(1, -(-s_total // TILE_ROWS))
    assert rows % TILE_ROWS == 0 and rows > 0
    assert 1 <= splits <= MAX_SPLITS
    # the splits cover S exactly: the last starts inside S, ends at or past
    assert splits * rows >= s_total
    assert (splits - 1) * rows < max(s_total, 1)
    # enough blocks: every tile its own split when S is short, else about
    # one block an SM at least (fewer only against the split cap)
    want = min(MAX_SPLITS, -(-2 * sm // blocks))
    if want >= n_tiles:
        assert splits == n_tiles
    else:
        assert blocks * splits >= min(sm, blocks * MAX_SPLITS // 2)


def test_split_plan_serving_window():
    assert split_plan(348, 32, 132) == (6, 64)   # 192 blocks for 132 SMs


# ---------------------------- the merge algebra ----------------------------

B, H, KV, S, D = 3, 8, 1, 200, 32
PCOL, W = 150, 32


def _inputs(int8, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, H, 1, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, S, KV, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, S, KV, D)).astype(np.float32))
    if not int8:
        return q, k, v, {}
    kq, ks = quantize_activations(k)
    vq, vs = quantize_activations(v)
    return q, kq, vq, dict(k_scale=ks, v_scale=vs)


def _partial(q, k, v, live, rows, scales):
    """(m, l, acc) of one slot and kv head over ``rows``: scores scaled by
    D^-1/2 (and k_scale), p = exp(s - m) on live rows, acc = sum p v_scale v;
    m = NEG_INF and l = 0 where no row is live."""
    g = q.shape[0]
    rows = [r for r in rows if live[r]]
    if not rows:
        return (torch.full((g,), NEG_INF), torch.zeros(g),
                torch.zeros(g, q.shape[1]))
    kk, vv = k[rows].float(), v[rows].float()
    s = q @ kk.T * q.shape[1] ** -0.5
    if scales:
        s = s * scales["k"][rows]
    m = s.amax(dim=1)
    p = torch.exp(s - m[:, None])
    l = p.sum(dim=1)
    if scales:
        p = p * scales["v"][rows]
    return m, l, p @ vv


def _merge(parts):
    m = torch.stack([pt[0] for pt in parts])            # [n, g]
    l = torch.stack([pt[1] for pt in parts])
    acc = torch.stack([pt[2] for pt in parts])          # [n, g, D]
    mx = m.amax(dim=0)
    w = torch.where(l > 0, torch.exp(m - mx), torch.zeros_like(m))
    return mx, (w * l).sum(dim=0), (w[:, :, None] * acc).sum(dim=0)


def _split_decode(q, k, v, live, scales, sm=132, few=False):
    """The kernel's hierarchy: warps over their 16 rows of each tile, the
    block over its warps, the splits in split order; ``few``: the cut of
    the form for G < 8 (``few_plan``, an SM holding 3 blocks)."""
    b, h, _, d = q.shape
    s_total, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if few:
        splits, rows, _ = few_plan(s_total, kvh * b, sm, lambda st: 3)
    else:
        splits, rows = split_plan(s_total, kvh * -(-g // 8) * b, sm)
    out = torch.zeros(b, h, 1, d)
    for bi in range(b):
        for n in range(kvh):
            qg = q[bi, n * g:(n + 1) * g, 0].float()
            sc = {key: t[bi, :, n, 0].float() for key, t in scales.items()}
            blocks = []
            for z in range(splits):
                end = min(s_total, (z + 1) * rows)
                warps = [_partial(qg, k[bi, :, n], v[bi, :, n], live[bi], [
                    r for r in range(z * rows, end)
                    if (r % TILE_ROWS) // WARP_ROWS == w], sc)
                    for w in range(WARPS)]
                blocks.append(_merge(warps))
            _, lsum, acc = _merge(blocks)
            inv = 1 / lsum.clamp_min(1e-30)
            out[bi, n * g:(n + 1) * g, 0] = acc * inv[:, None]
    return out


def _masks():
    acol = torch.tensor([0, 5, 31], dtype=torch.int32)
    gcnt = torch.tensor([1, 32, 0], dtype=torch.int32)
    kv_len = torch.tensor([S, 70, 0], dtype=torch.int32)     # a masked row
    valid = torch.from_numpy(np.random.default_rng(1).random((B, S)) < 0.4)
    valid[0, 64:192] = False                 # whole splits with no live row
    valid[2] = False                         # a fully masked row
    return {"window": dict(kv_window=(PCOL, W, acol, gcnt)),
            "kv_len": dict(kv_len=kv_len),
            "kv_valid": dict(kv_valid=valid),
            "window_kv_len": dict(kv_window=(PCOL, W, acol, gcnt),
                                  kv_len=kv_len)}


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("mode", ["window", "kv_len", "kv_valid",
                                  "window_kv_len"])
def test_split_merge_matches_plain(mode, int8):
    q, k, v, scales = _inputs(int8)
    kw = _masks()[mode]
    want = decode_attention_plain(q, k, v, **kw, **scales)
    live = live_rows(B, S, q.device, kw.get("kv_len"), kw.get("kv_valid"),
                     kw.get("kv_window"))
    sc = {"k": scales["k_scale"], "v": scales["v_scale"]} if int8 else {}
    got = _split_decode(q, k, v, live, sc)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("sm", [132, 1], ids=["four_splits", "one_split"])
def test_split_merge_all_masked_splits_and_rows(sm):
    """Slot 0 has live rows only in its first and last tiles (the splits
    between have l = 0), slot 1 none at all: it returns exactly 0, and no
    exp(-inf - (-inf)) reaches the output."""
    q, k, v, _ = _inputs(False, seed=3)
    valid = torch.zeros(B, S, dtype=torch.bool)
    valid[0, :3] = True
    valid[0, -2:] = True
    valid[2, ::7] = True
    live = live_rows(B, S, q.device, kv_valid=valid)
    got = _split_decode(q, k, v, live, {}, sm=sm)
    want = decode_attention_plain(q, k, v, kv_valid=valid)
    assert torch.isfinite(got).all()
    assert (got[1] == 0).all() and (want[1] == 0).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_merge_of_empty_partials_is_zero():
    g = 4
    empty = (torch.full((g,), NEG_INF), torch.zeros(g), torch.zeros(g, D))
    mx, lsum, acc = _merge([empty, empty, empty])
    assert (lsum == 0).all() and (acc == 0).all()
    assert torch.isfinite(acc / lsum.clamp_min(1e-30)[:, None]).all()



# ------------------------- the form for G < 8 -------------------------

def _occupancy(d, int8):
    """An SM's blocks by the form's shared memory (its ring of 64-row
    tiles, at most 227 KB) and at most 4 by registers, as the card gave
    them for these head dims (``vlm_decode_few_blocks``)."""
    dp = 64 if d <= 64 and not int8 else 128 if d <= 128 else 256
    stage = 2 * TILE_ROWS * dp * (1 if int8 else 2) + (512 if int8 else 0)
    return lambda st: min(4, 232448 // (st * stage + 1024)) \
        if st * stage <= 232448 else 0


# (slots, rows, KV heads, D, int8): LLaVA's 32 bf16 and 16 int8 slots,
# BLIP-2's 32 and 64, the sweep's 8 slots of Vicuna and OPT, the mesh's
# Gemma rank (4 heads over one), short and long caches
FEW_SHAPES = [(32, 673, 32, 128, False), (16, 673, 32, 128, True),
              (32, 124, 32, 128, False), (64, 124, 32, 128, True),
              (8, 1313, 32, 128, False), (8, 770, 32, 128, False),
              (32, 332, 1, 256, False), (32, 332, 1, 256, True),
              (1, 1, 1, 64, False), (2, 8192, 2, 128, True)]


@pytest.mark.parametrize("slots,s_total,kvh,d,int8", FEW_SHAPES)
def test_few_plan_covers_s_with_nonempty_splits(slots, s_total, kvh, d,
                                                int8):
    occupancy = _occupancy(d, int8)
    splits, rows, stages = few_plan(s_total, kvh * slots, 132, occupancy)
    n_tiles = max(1, -(-s_total // TILE_ROWS))
    assert rows % TILE_ROWS == 0 and 1 <= splits <= MAX_SPLITS
    assert splits * rows >= s_total and (splits - 1) * rows < max(s_total, 1)
    assert 1 <= stages <= min(FEW_MAX_STAGES, rows // TILE_ROWS)
    # a second stage only where it costs no block an SM
    assert occupancy(stages) == occupancy(1)
    assert splits == -(-n_tiles // (rows // TILE_ROWS))
    # the cut is split_plan's: about two blocks an SM where S has the tiles
    assert (splits, rows) == split_plan(s_total, kvh * slots, 132)


@pytest.mark.parametrize("slots,s_total,heads", [
    (32, 673, 32), (16, 673, 32), (64, 124, 32), (8, 1313, 32), (8, 770, 32),
    (32, 348, 8)])
def test_gemma_g8_keeps_split_plan(slots, s_total, heads):
    """G = 8 (Gemma's MQA window, the sweep's Gemma) keeps its cut."""
    splits, rows = split_plan(s_total, slots, 132)
    assert rows % TILE_ROWS == 0 and 1 <= splits <= MAX_SPLITS
    assert splits * rows >= s_total and (splits - 1) * rows < s_total
    assert HEADS_PER_BLOCK == 8


def test_few_heads_pairs_two_heads_only_on_full_int8_grids():
    """Two KV heads a block: the int8 cache at G = 1 (even KV, D <= 128)
    where the pairs fill two rounds of the card's room (BLIP-2's 64 slots x
    32 heads), not LLaVA's 16 x 32 nor any bf16 cache or G > 1."""
    room = 132 * 4
    assert few_heads(1, 32, 128, True, 64 * 32, room) == 2
    assert few_heads(1, 32, 128, True, 16 * 32, room) == 1
    assert few_heads(1, 32, 128, False, 64 * 32, room) == 1
    assert few_heads(4, 1, 256, True, 4096, room) == 1
    assert few_heads(1, 31, 128, True, 64 * 31, room) == 1
    assert few_heads(1, 32, 256, True, 64 * 32, room) == 1


FEW_B, FEW_H, FEW_KV, FEW_S = 3, 4, 4, 700


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("mode", ["window", "kv_len", "kv_valid",
                                  "window_kv_len"])
@pytest.mark.parametrize("heads", [1, 4])
def test_few_split_merge_matches_plain(mode, int8, heads):
    """G = 1 (MHA) and G = 4 over a long cache cut by ``few_plan``."""
    rng = np.random.default_rng(5)
    kvh = FEW_H // heads if heads == 4 else FEW_KV
    h = kvh * heads
    q = torch.from_numpy(rng.normal(size=(FEW_B, h, 1, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(FEW_B, FEW_S, kvh, D)).astype(
        np.float32))
    v = torch.from_numpy(rng.normal(size=(FEW_B, FEW_S, kvh, D)).astype(
        np.float32))
    scales = {}
    if int8:
        (k, ks), (v, vs) = quantize_activations(k), quantize_activations(v)
        scales = dict(k_scale=ks, v_scale=vs)
    acol = torch.tensor([0, 5, 31], dtype=torch.int32)
    gcnt = torch.tensor([1, 32, 0], dtype=torch.int32)
    kv_len = torch.tensor([FEW_S, 300, 0], dtype=torch.int32)
    valid = torch.from_numpy(rng.random((FEW_B, FEW_S)) < 0.4)
    valid[0, 64:448] = False
    valid[2] = False
    kw = {"window": dict(kv_window=(650, 32, acol, gcnt)),
          "kv_len": dict(kv_len=kv_len), "kv_valid": dict(kv_valid=valid),
          "window_kv_len": dict(kv_window=(650, 32, acol, gcnt),
                                kv_len=kv_len)}[mode]
    want = decode_attention_plain(q, k, v, **kw, **scales)
    live = live_rows(FEW_B, FEW_S, q.device, kw.get("kv_len"),
                     kw.get("kv_valid"), kw.get("kv_window"))
    sc = {"k": scales["k_scale"], "v": scales["v_scale"]} if int8 else {}
    got = _split_decode(q, k, v, live, sc, sm=4, few=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# mirrors of csrc/decode_attention.cu's layout functions

def row_of(m):
    return ((m & 7) >> 1) * 4 + (m & 1) + ((m >> 3) << 1)


def swz_bf16(r):
    return (r & 1) | (((r >> 2) & 3) << 1)


def swz_int8(r):
    return ((r & 1) << 2) ^ (((r >> 2) & 3) << 1)


def int8_dim(mt, hi, g):
    return 128 * (mt >> 3) + 16 * g + 2 * (mt & 7) + hi


def test_row_of_gives_lane_t_rows_4t_to_4t_plus_3():
    """P^T's B fragment of lane t holds mma rows 2t, 2t + 1 (b0) and 2t +
    8, 2t + 9 (b1): cache rows 4t .. 4t + 3, so V^T's A fragment is four
    whole rows; row_of is a permutation of the warp's 16 rows."""
    assert sorted(row_of(m) for m in range(16)) == list(range(16))
    for t in range(4):
        assert [row_of(m) for m in (2 * t, 2 * t + 1, 2 * t + 8,
                                    2 * t + 9)] == [4 * t + i
                                                    for i in range(4)]


def _phases(addresses, lanes=8):
    """Conflict-free: in each phase of ``lanes`` lanes of a 16-byte
    access, the 16-byte bank groups (address // 16 mod 8) differ."""
    return all(len({(a // 16) % 8 for a in addresses[i:i + lanes]}) == lanes
               for i in range(0, len(addresses), lanes))


@pytest.mark.parametrize("pitch", [128, 256, 512])
def test_bf16_ldmatrix_rows_are_conflict_free(pitch):
    """ldmatrix reads 8 rows of one 16-byte chunk a matrix: row_of(0..7)
    or row_of(8..15), at every chunk of K (x4) and V (x4.trans)."""
    for chunk in range(pitch // 16):
        for half in (0, 8):
            rows = [row_of(half + i) for i in range(8)]
            addr = [r * pitch + ((chunk ^ swz_bf16(r)) * 16) for r in rows]
            assert _phases(addr)


@pytest.mark.parametrize("dp", [128, 256])
def test_int8_loads_are_conflict_free_and_cover_every_dim(dp):
    """K: lane (g, t) reads 16 bytes of rows row_of(g), row_of(g + 8) at
    dims 64 c + 16 t; V: 16 bytes of row 4 t + rr at dims 128 h + 16 g.
    Each 16-byte access is conflict-free in its quarter-warp phases, and
    the V dims of (slice, hi, g) cover [0, dp) once."""
    lanes = [(lane // 4, lane % 4) for lane in range(32)]
    for c in range(dp // 64):
        for second in (0, 8):
            addr = []
            for g, t in lanes:
                r = row_of(g + second)
                x = 64 * c + 16 * t
                addr.append(r * dp + (((x >> 4) ^ swz_int8(r)) << 4))
            assert _phases(addr)
    for h in range(dp // 128):
        for rr in range(4):
            addr = []
            for g, t in lanes:
                r = 4 * t + rr
                x = 128 * h + 16 * g
                addr.append(r * dp + (((x >> 4) ^ swz_int8(r)) << 4))
            assert _phases(addr)
    dims = [int8_dim(mt, hi, g) for mt in range(dp // 16) for hi in (0, 1)
            for g in range(8)]
    assert sorted(dims) == list(range(dp))
    # the query's dims of K's steps: 64 c + 16 t + 4 j + (0..3) for step
    # kk = 4 c + j cover [0, dp) once, 16 a step
    qd = [64 * (kk >> 2) + 16 * t + 4 * (kk & 3) + e
          for kk in range(dp // 16) for t in range(4) for e in range(4)]
    assert sorted(qd) == list(range(dp))


def widen4(word):
    """csrc/decode_attention.cu's widen4 in numpy: each byte xor 0x80 into
    the low mantissa bits of 2^23 (the float 0x4B0000xx), minus 2^23 +
    128."""
    u = np.uint32(word) ^ np.uint32(0x80808080)
    out = []
    for i in range(4):
        bits = np.uint32(0x4B000000) | ((u >> np.uint32(8 * i))
                                        & np.uint32(0xFF))
        out.append(np.array(bits, np.uint32).view(np.float32)
                   - np.float32(8388736.0))
    return np.array(out, np.float32)


def test_int8_widening_is_exact_for_every_byte():
    """All 256 int8 values: widen4 gives float(x) exactly, and so the same
    bf16 (the cvt of the pair) as the conversion it replaces."""
    xs = np.arange(-128, 128, dtype=np.int8)
    words = xs.view(np.uint8).astype(np.uint32)
    got = np.concatenate([
        widen4(int(words[i] | (words[i + 1] << 8) | (words[i + 2] << 16)
                   | (words[i + 3] << 24)))
        for i in range(0, 256, 4)])
    want = xs.astype(np.float32)
    assert got.dtype == np.float32 and (got == want).all()
    bf_got = torch.from_numpy(got).to(torch.bfloat16)
    bf_want = torch.from_numpy(xs.astype(np.int64)).to(torch.bfloat16)
    assert torch.equal(bf_got.view(torch.int16), bf_want.view(torch.int16))
