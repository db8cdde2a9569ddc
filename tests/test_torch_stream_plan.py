"""B5's and B7's weight-streaming mainloop (``csrc/weight_stream.cuh``),
emulated on the CPU against the plain versions:

- the host plan (``ops/quant.py: stream_plan``): output tiles that cover
  [M, N] once (64 columns where 128 would leave an SM one block or none),
  K cut into whole 128-byte chunks of the weight rows, split over at most
  8 blocks of one cluster, each split non-empty, every chunk taken once,
  and the splits' fp32 partials summed in rank order, as the cluster
  reduction does: equal to ``int8_matmul_plain`` and
  ``int4_matmul_plain`` within ``GEMM_REL_TOL`` of the largest output, at
  every Gemma-2B and SigLIP shape with m = 1, 32 and 316 rows, with and
  without a table of how many clusters the device runs at once (the plan
  then keeps the tiles' clusters in one wave where it can);
- a sub-chunk's order of k (a chunk is two of 64 bytes a row, each staged
  as [128 rows, 64 bytes]): lane (g, t)'s 16-byte weight word and its x
  pieces, read through the swizzle and fed to mma.sync.m16n8k16 fragments,
  give the sub-chunk's product, and every shared-memory read of x and of
  the weights a quarter warp makes hits 8 distinct 16-byte bank groups;
- the dequantization: the magic-number conversions give the plain
  versions' weights bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

from vlm_tpu_torch.ops.quant import (BLOCK_COLS, CHUNK_BYTES, MAX_SPLITS,
                                     dequantize, int4_matmul_plain,
                                     int8_matmul_plain, stream_plan,
                                     QuantizedWeight)
from vlm_tpu_torch.testing.kernel_checks import GEMM_REL_TOL

torch.set_num_threads(2)
H100_SMS = 132
SUB_BYTES = 64   # bytes of a weight row a sub-chunk: a staged row
# Gemma-2B gate/up, down, q/o, k/v; SigLIP fc1, fc2 (K, N, int4 group)
SHAPES = [(2048, 16384, 128), (16384, 2048, 128), (2048, 2048, 128),
          (2048, 256, 128), (1152, 4304, 128), (4304, 1152, 16)]
# `_lib.max_clusters` of an H100 80GB HBM3 (`profile_quant.py --plans`):
# clusters of s blocks of the mainloop that run at once; and a table that
# never binds
H100_CLUSTERS = (0, 264, 132, 79, 62, 47, 39, 32, 30)
NO_LIMIT = (0,) + (1 << 30,) * 8


@functools.lru_cache(maxsize=4)
def _weights(k, n, fmt, gs):
    rng = np.random.default_rng(k * 7 + n + gs)
    if fmt == "int8":
        q = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
        s = torch.from_numpy(rng.random(n, dtype=np.float32)) / (64 * k ** .5)
        return q, s
    q = torch.from_numpy(rng.integers(-128, 128, (n, k // 2), dtype=np.int8))
    s = torch.from_numpy(0.5 + rng.random((n, k // gs), dtype=np.float32)) \
        / (4 * k ** 0.5)
    return q, s


def _splits(plan):
    return [(z * plan.per, min(plan.chunks, (z + 1) * plan.per))
            for z in range(plan.splits)]


@pytest.mark.parametrize("clusters", [NO_LIMIT, H100_CLUSTERS],
                         ids=["no_limit", "h100_table"])
@pytest.mark.parametrize("m", [1, 32, 316])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"k{k}_n{n}"
                                               for k, n, _ in SHAPES])
def test_plan_covers_k_once_and_matches_plain(shape, fmt, m, clusters):
    _check_plan(shape, fmt, m, clusters)


# the 4bit slices of LLaVA and BLIP-2 (group 128): Vicuna's and OPT's decode
# products at 32 slots (K = 11008: 43 chunks, a prime; K = 16384: 64), and
# EVA's int4 tower at a one-image prefill of 257 rows (K = 1408: 5.5
# chunks, the last half a chunk)
SLICE_SHAPES = [(32, 4096, 4096), (32, 4096, 11008), (32, 11008, 4096),
                (32, 4096, 16384), (32, 16384, 4096), (257, 1408, 1408),
                (257, 1408, 6144), (257, 6144, 1408)]


@pytest.mark.parametrize("m,k,n", SLICE_SHAPES,
                         ids=[f"m{m}_k{k}_n{n}" for m, k, n in SLICE_SHAPES])
def test_plan_at_the_4bit_slices_shapes(m, k, n):
    """The same checks at the shapes B7 takes in the 4bit LLaVA and BLIP-2
    slices, with the H100's cluster table."""
    _check_plan((k, n, 128), "int4", m, H100_CLUSTERS)


def _check_plan(shape, fmt, m, clusters):
    k, n, gs = shape
    row_bytes = k if fmt == "int8" else k // 2
    plan = stream_plan(m, n, row_bytes, H100_SMS, clusters,
                       int4=fmt == "int4")
    # the tile is one the C entry instantiates, its grid covers [M, N]
    assert plan.bm == (16 if m <= 16 else 32 if m <= 32 else 64)
    assert plan.bn in BLOCK_COLS
    assert plan.grid == (-(-n // plan.bn), -(-m // plan.bm), plan.splits)
    assert (plan.grid[0] - 1) * plan.bn < n
    assert (plan.grid[1] - 1) * plan.bm < m
    # 64 columns only where 128-column tiles at their power-of-two split
    # (no empty split) would leave an SM one block or none (B7: half the SMs
    # none), and then with more blocks
    tiles128 = -(-n // 128) * -(-m // plan.bm)
    room = max(1, min(MAX_SPLITS, plan.chunks,
                      (2 if plan.bm <= 32 else 4) * H100_SMS // tiles128))
    per128 = -(-plan.chunks // (1 << (room.bit_length() - 1)))
    blocks128 = tiles128 * -(-plan.chunks // per128)
    if plan.bn == 64:
        assert blocks128 <= (H100_SMS // 2 if fmt == "int4" else H100_SMS)
        assert plan.grid[0] * plan.grid[1] * plan.splits > blocks128
    # K: whole chunks, each split non-empty, every chunk once, in order
    assert plan.chunks == -(-row_bytes // CHUNK_BYTES)
    assert 1 <= plan.splits <= min(MAX_SPLITS, plan.chunks)
    # a split only where the grid stays within 2 (4 for 64-row tiles)
    # blocks an SM
    blocks = plan.grid[0] * plan.grid[1] * plan.splits
    assert plan.splits == 1 or \
        blocks <= (2 if plan.bm <= 32 else 4) * H100_SMS
    # with the table, the clusters fit in one wave, or the plan is the one
    # without it (no smaller split above half the power of two fits)
    tiles = plan.grid[0] * plan.grid[1]
    if clusters[plan.splits] < tiles:
        base = stream_plan(m, n, row_bytes, H100_SMS, NO_LIMIT,
                           int4=fmt == "int4")
        assert (plan.bn, plan.splits) == (base.bn, base.splits)
    ranges = _splits(plan)
    assert all(lo < hi for lo, hi in ranges)
    assert [c for lo, hi in ranges for c in range(lo, hi)] == \
        list(range(plan.chunks))

    # the product: fp32 partials of each split's k range, summed in rank
    # order, then the epilogue, against the plain version
    q, s = _weights(k, n, fmt, gs)
    x = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (m, k), dtype=np.float32)).to(torch.bfloat16)
    if fmt == "int8":
        w = q.float()
        plain = int8_matmul_plain(x, q, s)
    else:
        w = dequantize(QuantizedWeight(q, s, gs), torch.bfloat16).float()
        plain = int4_matmul_plain(x, q, s, gs)
    k_per_chunk = CHUNK_BYTES * k // row_bytes
    acc = torch.zeros(m, n)
    for lo, hi in ranges:
        ks = slice(lo * k_per_chunk, min(k, hi * k_per_chunk))
        acc = acc + x[:, ks].float() @ w[:, ks].T
    got = (acc * s if fmt == "int8" else acc).to(torch.bfloat16)
    err = (got.float() - plain.float()).abs().max()
    assert err <= GEMM_REL_TOL * plain.float().abs().max()


@pytest.mark.parametrize("m,k,n,bn,splits", [
    (32, 16384, 2048, 64, 7),   # down: 32 tiles, 30 clusters of 8 fit
    (1, 16384, 2048, 64, 7),
    (32, 2048, 2048, 64, 6),    # q/o: 16 chunks, 7 splits of 3 is 6
    (32, 1024, 2048, 128, 8),   # q/o int4: 64 columns, 4 splits of 2: no
                                # more blocks than 128 columns at 8
    (32, 2048, 256, 64, 8),     # k/v: 4 tiles fit at 8
    (32, 2048, 16384, 128, 2),  # gate/up: 256 blocks, two an SM
    (256, 4304, 1152, 128, 6),  # SigLIP fc2: 36 tiles; 39 clusters of 6
    (316, 16384, 2048, 128, 4), # 80 tiles: no count above 2 fits, 4 stays
])
def test_plan_tiles_and_cluster_waves(m, k, n, bn, splits):
    plan = stream_plan(m, n, k, H100_SMS, H100_CLUSTERS)
    assert (plan.bn, plan.splits) == (bn, splits)


def _x_piece(r, p):
    """``vlm::ws::x_piece``: where x's 16-byte piece p of row r sits."""
    return p ^ (((p >> 3) & 1) << 1) ^ (r & 1)


@pytest.mark.parametrize("fmt", ["int8", "int4", "int4_swapped"])
def test_chunk_order_of_k_is_the_product(fmt):
    """One warp, one sub-chunk, as the kernel reads it: x staged through
    the swizzle, each lane's 16-byte weight word. int8 and int4: x is the
    A operand (one m16 tile), the weights the B operand (one n8 tile);
    int4 swapped (128-column tiles, at most 32 rows): the weights (rows g
    and g + 8: the warp's two n8 column tiles) the A operand, x (8 rows)
    the B operand, giving W . x^T."""
    kk = 64 if fmt == "int8" else 128        # k a sub-chunk
    steps = kk // 16
    swapped = fmt == "int4_swapped"
    rows_x, rows_w = (8, 16) if swapped else (16, 8)
    rng = np.random.default_rng(0)
    x = rng.integers(-8, 8, (rows_x, kk)).astype(np.float64)
    w = rng.integers(-8, 8, (rows_w, kk)).astype(np.float64)
    # x in shared memory: row r's piece p at _x_piece(r, p)
    pieces = kk // 8
    smem = np.zeros((rows_x, pieces, 8))
    for r in range(rows_x):
        for p in range(pieces):
            smem[r, _x_piece(r, p)] = x[r, 8 * p:8 * p + 8]
    span = kk // 4                            # k a lane owns: 16 or 32

    def x_k(r, k0):                           # x[r][k0 .. k0 + 3]
        row = smem[r, _x_piece(r, k0 // 8)]
        return row[k0 % 8:k0 % 8 + 4]

    acc = np.zeros((rows_w, rows_x) if swapped else (rows_x, rows_w))
    for s in range(steps):
        a = np.zeros((16, 16))                # logical A of the step
        b = np.zeros((16, 8))                 # logical B
        for lane in range(32):
            g, t = lane // 4, lane % 4
            k0 = span * t + 4 * s             # physical k of the step
            if not swapped:
                for hr in range(2):
                    vals = x_k(g + 8 * hr, k0)
                    a[g + 8 * hr, 2 * t:2 * t + 2] = vals[:2]
                    a[g + 8 * hr, 2 * t + 8:2 * t + 10] = vals[2:]
                word = w[g, span * t:span * t + span]
                b[2 * t:2 * t + 2, g] = word[4 * s:4 * s + 2]
                b[2 * t + 8:2 * t + 10, g] = word[4 * s + 2:4 * s + 4]
            else:
                # a0 / a2 from row g's word, a1 / a3 from row g + 8's
                for hr in range(2):
                    word = w[g + 8 * hr, span * t:span * t + span]
                    a[g + 8 * hr, 2 * t:2 * t + 2] = word[4 * s:4 * s + 2]
                    a[g + 8 * hr, 2 * t + 8:2 * t + 10] = \
                        word[4 * s + 2:4 * s + 4]
                # b0 / b1: words 2 s2, 2 s2 + 1 of x row g's piece
                vals = x_k(g, k0)
                b[2 * t:2 * t + 2, g] = vals[:2]
                b[2 * t + 8:2 * t + 10, g] = vals[2:]
        acc += a @ b
    want = w @ x.T if swapped else x @ w.T
    np.testing.assert_array_equal(acc, want)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_shared_memory_reads_are_conflict_free(fmt):
    """Each quarter warp (8 lanes) of a 16-byte read touches 8 distinct
    16-byte bank groups: x through the swizzle, weights as dense rows."""
    row_bytes = 128 if fmt == "int8" else 256    # a staged x row
    for r0 in range(0, 16, 2):
        for h in range(1 if fmt == "int8" else 2):
            for e in range(2):
                for quarter in range(4):
                    groups = set()
                    for lane in range(8 * quarter, 8 * quarter + 8):
                        g, t = lane // 4, lane % 4
                        p = (2 * t if fmt == "int8" else 4 * t + 2 * h) + e
                        r = r0 + g % 2 + 2 * (g // 2)
                        addr = r * row_bytes + _x_piece(r, p) * 16
                        groups.add(addr // 16 % 8)
                    assert len(groups) == 8
    for quarter in range(4):
        groups = {((lane // 4) * SUB_BYTES + 16 * (lane % 4)) // 16 % 8
                  for lane in range(8 * quarter, 8 * quarter + 8)}
        assert len(groups) == 8


def _f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def test_int8_widening_is_exact():
    """``widen_s8x4``: the byte of q + 128 under 0x4B000000, minus
    2^23 + 128, is q."""
    q = np.arange(-128, 128)
    u = (q.astype(np.int64) & 0xFF) ^ 0x80
    got = _f32(0x4B000000 | u) - np.float32(8388736.0)
    np.testing.assert_array_equal(got, q.astype(np.float32))


@pytest.mark.parametrize("scale", [1e-3, 0.0123, 3.7e-5, 0.41])
def test_int4_dequant_is_the_plain_weight(scale):
    """``dequant_s4x4``: 2^23 + (n + 8) minus 2^23 + 8, times the fp32
    scale, rounded once to bf16: ``dequantize``'s weight bit for bit."""
    n = np.arange(-8, 8)
    u = (n & 0xF) ^ 0x8
    f = (_f32(0x4B000000 | u) - np.float32(8388616.0)) * np.float32(scale)
    got = torch.from_numpy(f).to(torch.bfloat16)
    packed = torch.from_numpy(((n[1::2] << 4) | (n[0::2] & 0xF)).astype(
        np.int8))[None]
    want = dequantize(QuantizedWeight(packed, torch.tensor([[scale]],
                                                           dtype=torch.float32),
                                      16), torch.bfloat16)[0]
    assert torch.equal(got, want)
