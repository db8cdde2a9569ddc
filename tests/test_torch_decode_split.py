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
"""

import numpy as np
import pytest
import torch

from vlm_tpu_torch.ops.decode_attention import (MAX_SPLITS, NEG_INF,
                                                TILE_ROWS,
                                                decode_attention_plain,
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


def _split_decode(q, k, v, live, scales, sm=132):
    """The kernel's hierarchy: warps over their 16 rows of each tile, the
    block over its warps, the splits in split order."""
    b, h, _, d = q.shape
    s_total, kvh = k.shape[1], k.shape[2]
    g = h // kvh
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
