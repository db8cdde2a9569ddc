"""B1's host-side plan against the plain version, on the CPU.

``flash_plan`` packs (position, query head) rows of one KV head's group
into blocks of ``ROWS`` rows and gives the grid the wrapper launches;
``block_key_tiles`` below says how many 64-key tiles each block loads. A
numpy emulation of what each block of ``csrc/flash_attention.cu`` computes
(its rows, those tiles, the per-row key limits, the online softmax in base
2 with the finite -1e30 for masked keys and no weight past the last key)
must reproduce ``attention_plain`` in every mask mode: fp32 throughout,
atol = rtol = 1e-5 (the emulation and the plain version sum in another
order). So the kernel may skip tiles only where skipping changes nothing,
and a row with no live key still gets the mean of V.

At D <= ``SMALL_D`` the bf16 form is ``flash_kernel_small``: its grid puts
the row tiles on the slowest axis (reversed under the causal mask), a
warpgroup with no live row leaves, and a warp scales its scores inside
the exponent on tiles where none of its rows has a masked key (masking,
in base 2, only the others); ``emulate_small`` follows that block by block
and warp by warp.
"""

import numpy as np
import pytest
import torch

from vlm_tpu_torch.ops.attention import (KEYS, ROWS, SMALL_D, attention_plain,
                                         flash_plan)
from vlm_tpu_torch.testing.kernel_checks import row_limits

NEG = np.float32(-1e30)


def block_key_tiles(plan, tile, sq, sk, causal, kv_len=None, prefix_len=None):
    """How many K/V tiles (from the first) block ``tile`` of a batch row
    loads, as ``flash_kernel`` computes it (the lines under "the block's
    key range" in csrc/flash_attention.cu): the tiles holding a live key of
    one of its rows. A block with a row that has no live key loads every
    tile, so that row's uniform weights give the mean of V over all ``sk``
    keys, as the reference does."""
    p0 = tile * plan.positions
    ends = row_limits(np.array([p0, min(p0 + plan.positions, sq) - 1]), sq,
                      sk, causal, kv_len, prefix_len)
    keys = sk if ends[0] <= 0 else int(ends[1])
    return -(-keys // KEYS)


def emulate(q, k, v, causal=False, kv_len=None, prefix_len=None):
    """What the kernel's blocks compute, block by block; also returns the
    number of K/V tiles loaded over the whole grid."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    plan = flash_plan(b, h, kvh, sq)
    hpb, npos = plan.heads_per_block, plan.positions
    out = np.full(q.shape, np.nan, np.float32)
    loaded = 0
    c = np.float32(d ** -0.5 / np.log(2))          # scale in base 2
    for bi in range(b):
        kvl = None if kv_len is None else int(kv_len[bi])
        pfx = None if prefix_len is None else int(prefix_len[bi])
        for tile in range(plan.tiles):
            for hg in range(plan.groups):
                rows = np.arange(ROWS)
                pos = tile * npos + rows // hpb
                head = hg * hpb + rows % hpb
                kv = head[0] // (h // kvh)
                assert (head // (h // kvh) == kv).all()  # one KV head a block
                lim = row_limits(pos, sq, sk, causal, kvl, pfx)
                qb = q[bi, head, np.minimum(pos, sq - 1)] * (pos < sq)[:, None]
                m = np.full(ROWS, -np.inf, np.float32)
                den = np.zeros(ROWS, np.float32)
                acc = np.zeros((ROWS, d), np.float32)
                n = block_key_tiles(plan, tile, sq, sk, causal, kvl, pfx)
                loaded += n
                for t in range(n):
                    kj = t * KEYS + np.arange(KEYS)
                    kt = np.where((kj < sk)[:, None],
                                  k[bi, kv, np.minimum(kj, sk - 1)], 0)
                    vt = np.where((kj < sk)[:, None],
                                  v[bi, kv, np.minimum(kj, sk - 1)], 0)
                    x = (qb @ kt.T) * c
                    x = np.where(kj[None] < lim[:, None], x, NEG)
                    x = np.where(kj[None] < sk, x, -np.inf)
                    m_new = np.maximum(m, x.max(axis=1))
                    corr = np.exp2(m - m_new)
                    p = np.exp2(x - m_new[:, None])
                    den = den * corr + p.sum(axis=1)
                    acc = acc * corr[:, None] + p @ vt
                    m = m_new
                live = pos < sq
                out[bi, head[live], pos[live]] = acc[live] / den[live, None]
    assert not np.isnan(out).any()               # every row written once
    return out, loaded


def emulate_small(q, k, v, causal=False, kv_len=None, prefix_len=None):
    """``flash_kernel_small``'s blocks over its grid (head groups, B, row
    tiles): each block's tile from blockIdx.z (reversed when causal), its
    key tiles, the warpgroups with a live row, and per warp of 16 rows
    the masked or in-exponent softmax of each tile. Returns the output
    and how many times each (batch, head, row) was written."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    plan = flash_plan(b, h, kvh, sq, d=d)
    assert plan.grid == (plan.groups, b, plan.tiles)
    hpb, npos = plan.heads_per_block, plan.positions
    out = np.zeros(q.shape, np.float32)
    writes = np.zeros(q.shape[:3], np.int64)
    c = np.float32(d ** -0.5 / np.log(2))
    for z in range(plan.grid[2]):
        tile = plan.tiles - 1 - z if causal else z
        for bi in range(b):
            kvl = None if kv_len is None else int(kv_len[bi])
            pfx = None if prefix_len is None else int(prefix_len[bi])
            for hg in range(plan.groups):
                rows = np.arange(ROWS)
                pos = tile * npos + rows // hpb
                head = hg * hpb + rows % hpb
                kv = head[0] // (h // kvh)
                consumers = 2 if min(npos, sq - tile * npos) * hpb > 64 \
                    else 1
                n = block_key_tiles(plan, tile, sq, sk, causal, kvl, pfx)
                for warp in range(4 * consumers):
                    wr = rows[16 * warp:16 * warp + 16]
                    wpos, whead = pos[wr], head[wr]
                    lim = row_limits(wpos, sq, sk, causal, kvl, pfx)
                    lim_warp = min(int(lim.min()), sk)
                    qb = q[bi, whead, np.minimum(wpos, sq - 1)]
                    m = np.full(16, -np.inf, np.float32)
                    den = np.zeros(16, np.float32)
                    acc = np.zeros((16, d), np.float32)
                    for t in range(n):
                        kj = t * KEYS + np.arange(KEYS)
                        kt = np.where((kj < sk)[:, None],
                                      k[bi, kv, np.minimum(kj, sk - 1)], 0)
                        vt = np.where((kj < sk)[:, None],
                                      v[bi, kv, np.minimum(kj, sk - 1)], 0)
                        s = qb @ kt.T
                        if t * KEYS + KEYS > lim_warp:    # masked, base 2
                            x = s * c
                            x = np.where(kj[None] < lim[:, None], x, NEG)
                            x = np.where(kj[None] < sk, x, -np.inf)
                            m_new = np.maximum(m, x.max(axis=1))
                            p = np.exp2(x - m_new[:, None])
                        else:                             # in the exponent
                            m_new = np.maximum(m, s.max(axis=1) * c)
                            p = np.exp2(s * c - m_new[:, None])
                        corr = np.exp2(m - m_new)
                        den = den * corr + p.sum(axis=1)
                        acc = acc * corr[:, None] + p @ vt
                        m = m_new
                    live = wpos < sq
                    out[bi, whead[live], wpos[live]] = (acc[live]
                                                        / den[live, None])
                    np.add.at(writes, (bi, whead[live], wpos[live]), 1)
    return out, writes


def _data(b, h, kvh, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, d)).astype(np.float32),
            rng.normal(size=(b, kvh, sk, d)).astype(np.float32),
            rng.normal(size=(b, kvh, sk, d)).astype(np.float32))


# (name, (b, h, kvh, sq, sk), mask keywords)
CASES = [
    ("mqa8_kvlen_0_and_ragged", (3, 8, 1, 70, 150),
     dict(kv_len=[150, 0, 100])),
    ("g1_kvlen_ragged", (2, 2, 2, 150, 150), dict(kv_len=[150, 65])),
    ("g1_no_mask", (1, 2, 2, 130, 130), {}),
    ("causal_offset_sk_gt_sq", (2, 8, 1, 40, 130), dict(causal=True)),
    ("causal_g1_offset", (1, 3, 3, 150, 200), dict(causal=True)),
    ("prefix_lm_kvlen", (2, 8, 1, 60, 60),
     dict(causal=True, prefix_len=[20, 5], kv_len=[60, 50])),
    ("causal_sq_gt_sk_dead_rows", (1, 2, 2, 80, 48), dict(causal=True)),
    ("gqa6_two_heads_a_block", (1, 12, 2, 30, 70), dict(kv_len=[65])),
]


@pytest.mark.parametrize("d", [72, 256])
@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_block_emulation_matches_plain(name, shape, kw, d):
    b, h, kvh, sq, sk = shape
    q, k, v = _data(b, h, kvh, sq, sk, d)
    got, _ = emulate(q, k, v, **kw)
    targ = {key: torch.tensor(val, dtype=torch.int32) if key != "causal"
            else val for key, val in kw.items()}
    want = attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), **targ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_plan_packs_gemma_heads_and_siglip_positions():
    siglip = flash_plan(4, 16, 16, 256)
    assert (siglip.heads_per_block, siglip.positions) == (1, ROWS)
    assert siglip.grid == (2, 16, 4)
    gemma = flash_plan(4, 8, 1, 316)
    assert (gemma.heads_per_block, gemma.positions) == (8, ROWS // 8)
    # all 8 heads of the KV head in one block: 20 blocks a batch row, not
    # 8 heads x 3 position tiles
    assert gemma.grid == (20, 1, 4)
    assert flash_plan(1, 12, 2, 30).heads_per_block == 2     # gcd(6, 64)
    assert flash_plan(1, 128, 1, 30).heads_per_block == 64


def test_plan_skips_dead_tiles_but_not_dead_rows():
    gemma = flash_plan(4, 8, 1, 316)
    tiles = lambda **kw: [block_key_tiles(gemma, t, 316, 316, **kw)  # noqa: E731
                          for t in range(gemma.grid[0])]
    assert tiles(causal=False) == [5] * 20
    assert tiles(causal=False, kv_len=100) == [2] * 20
    # kv_len = 0: every row is dead, so every tile loads (the mean of V)
    assert tiles(causal=False, kv_len=0) == [5] * 20
    # causal: block t sees positions < 16 (t + 1), so ceil(16 (t+1) / 64)
    assert tiles(causal=True) == [-(-16 * (t + 1) // 64) for t in range(20)]
    # a prefix widens the first blocks to the prefix
    assert tiles(causal=True, prefix_len=200)[:3] == [4, 4, 4]


def test_emulation_loads_fewer_tiles_with_kv_len():
    q, k, v = _data(2, 8, 1, 64, 256, 72)
    _, full = emulate(q, k, v)
    _, short = emulate(q, k, v, kv_len=[70, 10])
    assert full == 2 * 4 * 4 and short == 4 * 2 + 4 * 1


# flash_kernel_small's shapes: CLIP-L's 577 positions, SigLIP's 256, EVA's
# 257 (a one-row last tile), the Q-Former's 32 (one warpgroup), cross
# attention over 257 keys; kv_len, causal and prefix masks, a GQA group
SMALL_CASES = [
    ("clip_577", (1, 1, 1, 577, 577), {}),
    ("siglip_256_kvlen", (2, 1, 1, 256, 256), dict(kv_len=[256, 70])),
    ("eva_257", (1, 2, 2, 257, 257), {}),
    ("qformer_32", (2, 2, 2, 32, 32), {}),
    ("qformer_cross_32_257", (1, 2, 2, 32, 257), {}),
    ("causal_257", (1, 1, 1, 257, 257), dict(causal=True)),
    ("causal_kvlen_dead_rows", (2, 2, 2, 150, 100),
     dict(causal=True, kv_len=[100, 0])),
    ("prefix_lm_gqa", (2, 8, 1, 60, 60),
     dict(causal=True, prefix_len=[20, 5], kv_len=[60, 50])),
]


@pytest.mark.parametrize("d", [64, 72, 88])
@pytest.mark.parametrize("name,shape,kw", SMALL_CASES,
                         ids=[c[0] for c in SMALL_CASES])
def test_small_form_emulation_matches_plain(name, shape, kw, d):
    """Every (batch, head, row) is written by exactly one block, and the
    blocks' output is ``attention_plain``'s."""
    b, h, kvh, sq, sk = shape
    q, k, v = _data(b, h, kvh, sq, sk, d, seed=1)
    got, writes = emulate_small(q, k, v, **kw)
    assert (writes == 1).all()
    targ = {key: torch.tensor(val, dtype=torch.int32) if key != "causal"
            else val for key, val in kw.items()}
    want = attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), **targ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_small_form_grid_puts_row_tiles_last():
    clip = flash_plan(4, 16, 16, 577, d=64)
    assert (clip.tiles, clip.groups, clip.grid) == (5, 16, (16, 4, 5))
    eva = flash_plan(8, 16, 16, 257, d=88)
    assert eva.grid == (16, 8, 3)
    # D = 128 and the fp32 form keep (row tiles, head groups, B)
    assert flash_plan(4, 32, 32, 641, d=128).grid == (6, 32, 4)
    assert flash_plan(4, 16, 16, 577).grid == (5, 16, 4)
    assert SMALL_D == 96
