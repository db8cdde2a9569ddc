"""B6's and B7's redesigned forms, emulated on the CPU:

- B6's host plan (``ops/quant.py: int8xint8_plan``): tiles of 64 x
  consumers rows by 128 or 64 columns that cover [M, N] once, walked once
  each by persistent blocks in one wave (one block an SM for the staged
  form, two for the direct form), at every B6 shape of
  ``testing/kernel_checks.py``; where one block a 128 x 128 tile left SMs
  idle (Gemma's k/v at m = 1,264, a model=2 rank's q and o), the plan
  keeps more SMs busy;
- B7's prefill form (``int4_prefill_plan``): blocks of 128 columns by 64
  rows a consumer warpgroup that cover [M, N] once, stages of 64 k split
  over at most 8 blocks of one cluster, none empty, the fp32 partials of
  the splits against the plain version; the dequantizing warpgroup's
  writes into the 128-byte-swizzled bf16 tile, read back as wgmma reads
  its K-major B operand, are the plain weight;
- B7's narrow decode form: K split over a block's 8 warps by strided
  sub-chunks, the partials summed in warp order, against the plain
  version;
- the nibble conversion of both forms (a nibble taken in place by one
  mask, its scale divided by 2^p): bit for bit the plain version's bf16
  weight, for every byte value and the scales of
  ``test_int4_dequant_is_the_plain_weight``;
- ``int4_narrow_warps``: the narrow form at every product of at most 8
  rows, never past 32 rows or at K % 32 != 0;
- ``dense_int4``'s gate (``int4_dequant_gate``): B7 at every row count
  where K % 32 == 0, 512 included (where ``vlm_tpu`` takes its dequantized
  product), and below 1,536 rows where K % 32 != 0, the dequantized
  product from there; ``vlm_tpu``'s numbers on both sides, against the
  interpret-mode ``_int4_matmul_pallas``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlm_tpu.ops import quant as jq
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.ops.quant import (B6_TILES, DECODE_ROWS, DEQUANT_ROWS,
                                     PREFILL_COLS, PREFILL_MAX_SPLITS,
                                     PREFILL_STEP, QuantizedWeight,
                                     dense_int4, dequantize,
                                     int4_dequant_gate, int4_matmul_plain,
                                     int4_prefill_plan, int8xint8_plan)
from vlm_tpu_torch.testing import kernel_checks as kc

torch.set_num_threads(2)
H100_SMS = 132

# every B6 shape of kernel_checks (m, K, N, fp32 out)
B6_SHAPES = sorted(set(
    [(kc.GROUP * kc.PROMPT, k, n, True) for k, n in kc.GEMMA_KN]
    + [(2 * 256, k, n, False) for k, n in kc.SIGLIP_KN]
    + [(1, 2048, 2048, True), (4, 64, 32, True), (4, 4304, 4304, False),
       (300, 4304, 1152, True)]
    + [(kc.GROUP * kc.LLAVA_PROMPT, k, n, False) for k, n in kc.VICUNA_KN]
    + [(kc.BLIP2_GROUP_8BIT * kc.BLIP2_PROMPT, k, n, False)
       for k, n in kc.OPT_KN]
    + [(kc.BLIP2_GROUP_8BIT * 257, k, n, False) for k, n in kc.EVA_KN]
    + [(kc.SWEEP_GROUP * p, k, n, True)
       for p, kns in ((kc.SWEEP_PROMPTS["paligemma"], kc.GEMMA_KN),
                      (kc.SWEEP_PROMPTS["llava"], kc.VICUNA_KN),
                      (kc.SWEEP_PROMPTS["blip2"], kc.OPT_KN))
       for k, n in kns]
    + [(kc.BEAM_IMAGES * kc.PROMPT, k, n, True) for k, n in kc.GEMMA_KN]
    + [(kc.GROUP * kc.PROMPT, k, n, True) for k, n in kc.GEMMA_TP_KN]
    + [(8 * 256, k, n, f32) for part in kc.SIGLIP_TP_MLP
       for k, n, f32 in ((1152, part, False), (part, 1152, True))]))


@pytest.mark.parametrize("m,k,n,f32", B6_SHAPES,
                         ids=[f"m{m}_k{k}_n{n}" for m, k, n, _ in B6_SHAPES])
def test_b6_plan_covers_the_output_once_in_one_wave(m, k, n, f32):
    plan = int8xint8_plan(m, n, k, H100_SMS, 4 if f32 else 2)
    assert (plan.consumers, plan.bn) in B6_TILES
    bm = 64 * plan.consumers
    tiles_m, tiles_n = -(-m // bm), -(-n // plan.bn)
    assert plan.tiles == tiles_m * tiles_n
    assert (tiles_m - 1) * bm < m <= tiles_m * bm
    assert (tiles_n - 1) * plan.bn < n <= tiles_n * plan.bn
    # persistent blocks walking tile = block, block + grid, ...: each tile
    # once, every block with a tile
    walked = sorted(t for b in range(plan.grid)
                    for t in range(b, plan.tiles, plan.grid))
    assert walked == list(range(plan.tiles))
    # one wave: the staged form one block an SM, the direct form (a block
    # a tile) two
    assert plan.grid <= (1 if plan.staged else 2) * H100_SMS
    assert plan.staged or plan.grid == plan.tiles
    # the staged store needs 16-byte output rows
    assert not plan.staged or (n * (4 if f32 else 2)) % 16 == 0
    # fewer tiles than SMs: every tile has its own block
    if plan.tiles <= H100_SMS:
        assert plan.grid == plan.tiles


# where one block a 128 x 128 tile left SMs idle: Gemma's k/v at an
# admission of 4 and a model=2 rank's q (1,024 columns) and o (K = 1,024),
# and the 8bit beams' k/v at 8 x 316 rows
FEW_TILES = [(1264, 2048, 256), (1264, 2048, 1024), (1264, 1024, 2048),
             (2528, 2048, 256)]


@pytest.mark.parametrize("m,k,n", FEW_TILES,
                         ids=[f"m{m}_k{k}_n{n}" for m, k, n in FEW_TILES])
def test_b6_plan_fills_more_sms_than_one_block_a_tile(m, k, n):
    """More SMs busy than one block a 128 x 128 tile, wherever a tile of
    B6's fits a wave with more blocks (a model=2 rank's q, 80 tiles of
    128 x 128: its 160 of 128 x 64 need a second pass, measured slower
    walked by 132 blocks than the 80 tiles, PERF.md §6); never fewer."""
    plan = int8xint8_plan(m, n, k, H100_SMS)
    before = min(H100_SMS, -(-m // 128) * -(-n // 128))
    busy = min(H100_SMS, plan.grid)
    fits = [t for c, bn in B6_TILES
            if before < (t := -(-m // (64 * c)) * -(-n // bn)) <= H100_SMS]
    assert busy >= before
    assert busy > before or not fits or busy == H100_SMS


# B7's prefill shapes (m, K, N, group): BLIP-2's admission of 4 x 92, the
# int4 towers at one image (SigLIP fc1; EVA), PaliGemma's admission of 4 x
# 316, LLaVA's of 4 x 641, and ragged ones
PREFILL_SHAPES = [(368, 4096, 4096, 128), (368, 4096, 16384, 128),
                  (368, 16384, 4096, 128), (256, 1152, 4304, 128),
                  (257, 1408, 1408, 128), (257, 6144, 1408, 128),
                  (1264, 2048, 2048, 128), (1264, 2048, 256, 128),
                  (1264, 2048, 16384, 128), (1264, 16384, 2048, 128),
                  (2564, 4096, 4096, 128), (2564, 11008, 4096, 128),
                  (65, 96, 130, 32), (200, 160, 48, 16)]


@pytest.mark.parametrize("m,k,n,gs", PREFILL_SHAPES,
                         ids=[f"m{m}_k{k}_n{n}" for m, k, n, _ in
                              PREFILL_SHAPES])
def test_b7_prefill_plan_covers_the_output_and_k_once(m, k, n, gs):
    plan = int4_prefill_plan(m, n, k, H100_SMS)
    rows = 64 * plan.consumers
    cols, row_blocks, splits = plan.grid
    assert plan.consumers in (2, 3)
    assert (cols - 1) * PREFILL_COLS < n <= cols * PREFILL_COLS
    assert (row_blocks - 1) * rows < m <= row_blocks * rows
    assert plan.stages == -(-k // PREFILL_STEP)
    assert 1 <= splits == plan.splits <= min(PREFILL_MAX_SPLITS, plan.stages)
    ranges = [(z * plan.per, min(plan.stages, (z + 1) * plan.per))
              for z in range(splits)]
    assert all(lo < hi for lo, hi in ranges)
    assert [s for lo, hi in ranges for s in range(lo, hi)] == \
        list(range(plan.stages))
    # a split only where the split grid stays within one block an SM
    assert splits == 1 or cols * row_blocks * splits <= H100_SMS
    # the fewest row blocks, then the least padding of m64 row tiles
    tiles = -(-m // 64)
    assert (row_blocks, row_blocks * plan.consumers) == min(
        (-(-tiles // c), -(-tiles // c) * c) for c in (2, 3))


@functools.lru_cache(maxsize=None)
def _int4(n, k, gs, seed=0):
    rng = np.random.default_rng(seed + n + k)
    q = torch.from_numpy(rng.integers(-128, 128, (n, k // 2), dtype=np.int8))
    s = torch.from_numpy(0.5 + rng.random((n, k // gs), dtype=np.float32)) \
        / (4 * k ** 0.5)
    return q, s


@pytest.mark.parametrize("m,k,n,gs", [(368, 1024, 256, 128),
                                      (65, 96, 130, 32), (200, 160, 48, 16)])
def test_b7_prefill_split_partials_match_plain(m, k, n, gs):
    """Each split's stages of 64 k in fp32, the splits summed in rank
    order: the plain version within ``GEMM_REL_TOL`` of the largest
    output."""
    q, s = _int4(n, k, gs)
    x = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (m, k), dtype=np.float32)).to(torch.bfloat16)
    want = int4_matmul_plain(x, q, s, gs)
    w = dequantize(QuantizedWeight(q, s, gs), torch.bfloat16).float()
    plan = int4_prefill_plan(m, n, k, 8)    # a few SMs: splits
    acc = torch.zeros(m, n)
    for z in range(plan.splits):
        ks = slice(z * plan.per * PREFILL_STEP,
                   min(k, (z + 1) * plan.per * PREFILL_STEP))
        acc = acc + x[:, ks].float() @ w[:, ks].T
    err = (acc.to(torch.bfloat16).float() - want.float()).abs().max()
    assert err <= kc.GEMM_REL_TOL * want.float().abs().max()


@pytest.mark.parametrize("warps", [8, 16])
@pytest.mark.parametrize("m,k,n,gs", [(8, 2048, 256, 128), (1, 1024, 48, 32),
                                      (20, 4096, 32, 16), (32, 96, 16, 32)])
def test_b7_narrow_form_warp_split_matches_plain(m, k, n, gs, warps):
    """The narrow form: blocks of 16 weight rows (covering N), warp w of W
    taking sub-chunks w, w + W, ... of 128 k (each once), its fp32 partial
    summed with the other warps' in warp order: the plain version within
    ``GEMM_REL_TOL`` of the largest output."""
    q, s = _int4(n, k, gs)
    x = torch.from_numpy(np.random.default_rng(m + k).standard_normal(
        (m, k), dtype=np.float32)).to(torch.bfloat16)
    want = int4_matmul_plain(x, q, s, gs)
    w = dequantize(QuantizedWeight(q, s, gs), torch.bfloat16).float()
    subs = -(-k // 128)
    assert sorted(sb for w in range(warps) for sb in range(w, subs, warps)) \
        == list(range(subs))
    assert (-(-n // 16) - 1) * 16 < n <= -(-n // 16) * 16
    got = torch.zeros(m, n)
    for warp in range(warps):
        part = torch.zeros(m, n)
        for sub in range(warp, subs, warps):
            ks = slice(128 * sub, min(k, 128 * (sub + 1)))
            part = part + x[:, ks].float() @ w[:, ks].T
        got = got + part
    err = (got.to(torch.bfloat16).float() - want.float()).abs().max()
    assert err <= kc.GEMM_REL_TOL * want.float().abs().max()


@pytest.mark.parametrize("m,n,k", [(1, 16384, 2048), (8, 256, 2048),
                                   (8, 4096, 11008), (16, 2048, 16384),
                                   (32, 2048, 2048), (32, 256, 2048),
                                   (33, 2048, 2048), (8, 1152, 4304),
                                   (64, 1024, 1024)])
def test_b7_narrow_form_where_it_runs(m, n, k):
    """Each product takes one form, narrow, streaming or prefill, by its
    rows, columns and K."""
    from vlm_tpu_torch.ops.quant import int4_narrow_warps, int4_prefill_form
    warps = int4_narrow_warps(m, n, k)
    assert not (warps and int4_prefill_form(m, n, k))
    assert int4_prefill_form(m, n, k) == (m > DECODE_ROWS and k % 32 == 0
                                          and (n > 256 or m > 512))
    assert warps in (0, 8, 16)
    if m > 32 or k % 32:
        assert warps == 0
    elif m <= 8:
        assert warps
    assert not warps or (warps == 16) == (m <= 16 and n <= 2048)


def _f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def _nibbles(v, s):
    """A 32-bit word's 8 nibbles (already XORed with 0x88888888) as the
    kernels convert them: bits 0-15 in place, bits 16-31 from the word
    shifted by 16; each nibble at bit p = 4 j masked into 0x4B000000,
    minus 2^23 + 8 2^p, times scale 2^-p, in fp32."""
    v = np.asarray(v, np.uint64)
    out = []
    for word in (v, v >> 16):
        for j in range(4):
            f = _f32(0x4B000000 | (word & (0xF << (4 * j))))
            magic = np.float32(8388608.0 + (8 << (4 * j)))
            s_p = np.float32(s) * np.float32(2.0 ** (-4 * j))
            out.append((f - magic) * s_p)
    # k order: byte b's low then high nibble
    return np.stack([out[0], out[1], out[2], out[3], out[4], out[5],
                     out[6], out[7]], axis=-1)


@pytest.mark.parametrize("scale", [1e-3, 0.0123, 3.7e-5, 0.41])
def test_nibble_conversion_is_the_plain_weight_for_every_byte(scale):
    """Every byte value at every byte of a word: the bf16 weights the
    kernels form equal ``dequantize``'s bit for bit."""
    rng = np.random.default_rng(7)
    words = []
    for pos in range(4):
        rest = rng.integers(0, 1 << 32, 256, dtype=np.uint64)
        mask = np.uint64(0xFF << (8 * pos))
        words.append((rest & ~mask) | (np.arange(256, dtype=np.uint64)
                                       << np.uint64(8 * pos)))
    words = np.concatenate(words)
    got = torch.from_numpy(_nibbles(words ^ 0x88888888, scale)).to(
        torch.bfloat16)
    packed = torch.from_numpy(words.astype("<u4").view(np.int8).reshape(
        -1, 4))
    want = dequantize(QuantizedWeight(
        packed, torch.full((packed.shape[0], 1), scale, dtype=torch.float32),
        8), torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("gs", [16, 32, 128])
def test_prefill_tile_writes_are_the_k_major_swizzled_weight(gs):
    """The dequantizing warpgroup's writes (thread d: 16-byte word d & 1
    of rows d / 2 and d / 2 + 64; each 32-bit word of it one 16-byte chunk
    4 (d & 1) + j of the row, at chunk ^ (row % 8)), read back as wgmma
    reads the K-major tile under the 128-byte swizzle: the plain weights of
    the stage, each written once."""
    k = 2 * PREFILL_STEP
    q, s = _int4(PREFILL_COLS, k, gs, seed=3)
    want = dequantize(QuantizedWeight(q, s, gs), torch.bfloat16)
    raw = q.numpy().view(np.uint8)
    for stage in range(k // PREFILL_STEP):
        tile = np.zeros((PREFILL_COLS, 64), np.uint16)   # 8 chunks of 8
        written = np.zeros((PREFILL_COLS, 8), np.int64)
        packed = raw[:, stage * 32:(stage + 1) * 32]     # the TMA box
        for d in range(128):
            half, r0 = d & 1, d >> 1
            for r in (r0, r0 + 64):
                vec = packed[r, 16 * half:16 * half + 16].copy().view("<u4")
                k0 = stage * PREFILL_STEP + 32 * half
                for j in range(4):
                    sc = float(s[r, (k0 + 8 * j) // gs])
                    vals = torch.from_numpy(_nibbles(
                        np.uint64(vec[j]) ^ 0x88888888, sc)).to(
                            torch.bfloat16).view(torch.int16).numpy()
                    chunk = (4 * half + j) ^ (r & 7)
                    tile[r, 8 * chunk:8 * chunk + 8] = vals.view(np.uint16)
                    written[r, chunk] += 1
        assert (written == 1).all()
        for kk in range(PREFILL_STEP):
            col = tile[np.arange(PREFILL_COLS),
                       8 * ((kk // 8) ^ (np.arange(PREFILL_COLS) & 7))
                       + kk % 8]
            ref = want[:, stage * PREFILL_STEP + kk].view(torch.int16)
            assert np.array_equal(col.view(np.int16), ref.numpy())


# ------------------ dense_int4's dispatch, against vlm_tpu ------------------

GATE_CASES = [(DECODE_ROWS, 64), (DECODE_ROWS + 1, 64), (511, 64),
              (512, 64), (DEQUANT_ROWS, 64), (DEQUANT_ROWS - 1, 48),
              (DEQUANT_ROWS, 48)]


@pytest.mark.parametrize("m,k", GATE_CASES,
                         ids=[f"m{m}_k{k}" for m, k in GATE_CASES])
def test_dense_int4_dispatch_at_the_gate(m, k):
    """B7 (its plain version here) at the decode form's rows, the prefill
    form's and 512 rows (where ``vlm_tpu`` takes its dequantized product)
    and, where K % 32 != 0 (48 here), below 1,536 rows; the dequantized
    product from 1,536 rows at that K. ``vlm_tpu``'s numbers either way:
    the interpreted Pallas kernel on the same bytes (fp32 sums in another
    order: atol = rtol = 1e-5)."""
    n, gs = 16, 16
    gated = k % 32 != 0 and m >= DEQUANT_ROWS
    assert int4_dequant_gate(m, k) == gated
    rng = np.random.default_rng(m)
    q = rng.integers(-128, 128, (n, k // 2), dtype=np.int8)
    s = (0.5 + rng.random((n, k // gs), dtype=np.float32)) / 16
    x = rng.standard_normal((m, k), dtype=np.float32)
    _lib.reset_counts()
    got = dense_int4(torch.from_numpy(x), QuantizedWeight(
        torch.from_numpy(q), torch.from_numpy(s), gs), torch.float32)
    assert _lib.plain_calls["int4_matmul"] == (0 if gated else 1)
    want = jq._int4_matmul_pallas(jnp.asarray(x), jnp.asarray(q.T),
                                  jnp.asarray(s.T), group_size=gs,
                                  block_m=32, block_n=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
