"""Weight quantization and the quantized matrix products
(``vlm_tpu/ops/quant.py``): int8 per output channel with the B5
(``csrc/int8_matmul.cu``) and B6 (``csrc/int8xint8_matmul.cu``) kernels,
and grouped int4 with the B7 kernel (``csrc/int4_matmul.cu``), each beside
its plain version.

Layouts, all in the ``nn.Linear`` form of the port's ``Dense`` and read by
the kernels as their column-major B operand:

- int8: ``q`` ``[out, in]`` int8 and ``scale`` ``[out]`` fp32,
  ``weight ~= q * scale[:, None]`` (``vlm_tpu`` stores ``q`` ``[in, out]``
  and ``scale`` ``[1, out]``);
- int4: ``q`` ``[out, in/2]`` int8, byte ``j`` of row ``n`` holding input
  row ``2j`` in its low nibble and ``2j+1`` in its high nibble, both
  sign-extended, and ``scale`` ``[out, in/group]`` fp32, one per group of
  ``group_size`` inputs: ``vlm_tpu``'s ``[in/2, out]`` bytes and
  ``[in/group, out]`` scales, transposed.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from . import _lib


class QuantizedWeight(NamedTuple):
    """int8: q [out, in], scale [out], group_size == 0. int4: q [out, in/2]
    (two nibbles a byte), scale [out, in/group_size], group_size > 0."""
    q: torch.Tensor
    scale: torch.Tensor
    group_size: int = 0


# ------------------------------ quantize ------------------------------

def _abs_max_scale(absmax: torch.Tensor, qmax: float = 127.0) -> torch.Tensor:
    """max(absmax, 1e-8) / qmax by true division. PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal, which can differ in the
    last bit, so the divisor is a tensor."""
    return absmax.clamp_min(1e-8) / torch.full_like(absmax, qmax)


def quantize_int8(w: torch.Tensor) -> QuantizedWeight:
    """Per-output-channel symmetric int8 quantization of ``w`` [out, in]."""
    w = w.float()
    scale = _abs_max_scale(w.abs().amax(dim=1))
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return QuantizedWeight(q=q, scale=scale)


def quantize_int4(w: torch.Tensor, group_size: int = 128) -> QuantizedWeight:
    """Group-wise symmetric int4 quantization of ``w`` [out, in]: groups of
    ``group_size`` run along ``in``; abs-max / 7 per group, round half to
    even, clamp to +-7, two nibbles packed a byte."""
    w = w.float()
    n, k = w.shape
    if k % group_size or k % 2:
        raise ValueError(f"in = {k} must divide by group_size = {group_size}"
                         f" and by 2")
    wg = w.reshape(n, k // group_size, group_size)
    scale = _abs_max_scale(wg.abs().amax(dim=2), 7.0)          # [out, g]
    q = torch.clamp(torch.round(wg / scale[:, :, None]), -7, 7).to(
        torch.int32).reshape(n, k)
    packed = (q[:, 1::2] << 4) | (q[:, 0::2] & 0xF)
    return QuantizedWeight(q=packed.to(torch.int8), scale=scale,
                           group_size=group_size)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[out, in/2] packed bytes -> [out, in] int8 nibbles, sign-extended.
    Widened to int32 first, as JAX does: shifts of int8 tensors wrap."""
    a = packed.to(torch.int32)
    lo = (a << 28) >> 28
    hi = a >> 4
    return torch.stack((lo, hi), dim=-1).reshape(packed.shape[0], -1).to(
        torch.int8)


def dequantize(qw: QuantizedWeight, dtype=torch.float32) -> torch.Tensor:
    """[out, in] in ``dtype``: the product formed in fp32, rounded once."""
    if not qw.group_size:
        return (qw.q.float() * qw.scale[:, None]).to(dtype)
    q = unpack_int4(qw.q).float()
    n, k = q.shape
    w = q.reshape(n, k // qw.group_size, qw.group_size) * qw.scale[:, :, None]
    return w.reshape(n, k).to(dtype)


def quantize_activations(x: torch.Tensor, row_max=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization (llm.int8 without outliers):
    x [..., K] -> (q int8 [..., K], scale fp32 [..., 1]). Plain tensor code
    on either device, as JAX computed it in XLA: abs-max / 127 floored at
    1e-8 / 127, IEEE division, round half to even, clamp to +-127.
    ``row_max`` (a row-parallel layer's :class:`ShardComm.row_max`) takes
    each row's abs-max over the ranks that hold the rest of K."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    if row_max is not None:
        absmax = row_max(absmax)
    scale = _abs_max_scale(absmax)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


# ----------------------- B5 and B7: the host plan -----------------------

# the weight-streaming mainloop's geometry (csrc/weight_stream.cuh): bytes
# of each weight row a chunk, columns of a block (64 or 128), blocks of one
# cluster at most
CHUNK_BYTES, BLOCK_COLS, MAX_SPLITS = 128, (64, 128), 8


class StreamPlan(NamedTuple):
    """How B5 and B7 cut ``y [m, n]``: output tiles of ``bm`` rows by
    ``bn`` columns; each tile's K range, ``chunks`` chunks of
    :data:`CHUNK_BYTES` of every weight row, split over ``splits`` blocks
    of one thread block cluster, block z taking chunks ``[z * per,
    min(chunks, (z + 1) * per))``; ``grid`` is (column tiles, row tiles,
    splits)."""
    bm: int
    bn: int
    splits: int
    per: int
    chunks: int
    grid: Tuple[int, int, int]


def stream_plan(m: int, n: int, row_bytes: int, sms: int,
                clusters: Sequence[int], int4: bool = False) -> StreamPlan:
    """The tile and the K split of B5 (``row_bytes`` = K) and B7 (K / 2)
    for ``m`` rows on ``sms`` SMs: 16, 32 or 64 rows a tile, and K split
    over the largest power of two of blocks (at most :data:`MAX_SPLITS`,
    at most one a chunk) that keeps the grid within two blocks an SM for
    tiles of 32 rows or fewer, four for 64-row tiles (whose blocks do four
    times the tensor-core work a byte). ``clusters[s]``
    (``_lib.max_clusters``: how many clusters of s blocks the device runs
    at once) keeps the tiles' clusters in one wave: if they
    overflow it, the largest smaller count above half the power of two
    whose clusters all fit is taken. Tiles are 128 columns, or 64 where
    128 leaves an SM one block or none and 64 gives the grid more blocks
    (a block alone on its SM does not overlap its loads with its
    arithmetic). B7 (``int4``) keeps 128 columns while they give half the
    SMs a block: its swapped operands (``weight_stream.cuh``, at 32 rows or
    fewer) make the wide tile the cheaper one, and at 64 rows its wide
    tile's conversion feeds twice the products. The splits cover K
    exactly, none empty. (Chosen from a sweep of tiles and splits on the
    H100: ``testing/profile_quant.py --plans``, PERF.md §6.)"""
    bm = 16 if m <= 16 else 32 if m <= 32 else 64
    chunks = -(-row_bytes // CHUNK_BYTES)

    def plan_for(bn):
        grid_n, grid_m = -(-n // bn), -(-m // bm)
        tiles = grid_n * grid_m
        room = max(1, min(MAX_SPLITS, chunks,
                          (2 if bm <= 32 else 4) * sms // tiles))
        splits = 1 << (room.bit_length() - 1)
        if clusters[splits] < tiles:
            splits = next((s for s in range(splits - 1, splits // 2, -1)
                           if clusters[s] >= tiles), splits)
        per = -(-chunks // splits)
        splits = -(-chunks // per)
        return StreamPlan(bm, bn, splits, per, chunks,
                          (grid_n, grid_m, splits))

    def blocks(plan):
        return plan.grid[0] * plan.grid[1] * plan.grid[2]

    wide = plan_for(BLOCK_COLS[1])
    if blocks(wide) > (sms // 2 if int4 else sms):
        return wide
    narrow = plan_for(BLOCK_COLS[0])
    return narrow if blocks(narrow) > blocks(wide) else wide


# ------------------------------ B5 ------------------------------

def _check_out(name: str, out_dtype) -> None:
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: the CUDA kernel writes bfloat16 or "
                        f"float32, not {out_dtype}")


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      out_dtype=None) -> torch.Tensor:
    """x [m, K] @ (q [N, K] int8)^T, fp32 accumulate, per-column scale on
    the accumulator, one rounding to ``out_dtype`` (default x's)."""
    _lib.plain_calls["int8_matmul"] += 1
    y = torch.matmul(x.float(), q.float().T) * scale
    return y.to(out_dtype or x.dtype)


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                out_dtype=None) -> torch.Tensor:
    """B5, the weight-only int8 product: x [m, K], q [N, K] int8, scale
    [N] fp32 -> [m, N]. On the card x is bf16 and the output bf16, or fp32
    (a row-parallel rank's partial product)."""
    if _lib.is_cpu(x, "int8_matmul"):
        return int8_matmul_plain(x, q, scale, out_dtype)
    name = "int8_matmul"
    out_dtype = out_dtype or x.dtype
    _lib.check_cuda(name, x, q, scale)
    _lib.check_bf16(name, x)
    _lib.check_dtype(name, torch.int8, q)
    _lib.check_dtype(name, torch.float32, scale)
    _check_out(name, out_dtype)
    m, k = x.shape
    n = q.shape[0]
    if q.shape != (n, k) or scale.shape != (n,) or k % 16 or n % 2:
        raise ValueError(f"{name}: unsupported shapes x={tuple(x.shape)} "
                         f"q={tuple(q.shape)} scale={tuple(scale.shape)} "
                         f"(needs K % 16 == 0, N even)")
    _lib.check_contiguous(name, x, q, scale)
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    plan = stream_plan(m, n, k, _lib.sm_count(x.device),
                       _lib.max_clusters(x.device))
    _lib.launch(name, "vlm_int8_matmul", x.data_ptr(), q.data_ptr(),
                scale.data_ptr(), y.data_ptr(), m, n, k, plan.bm, plan.bn,
                plan.splits, plan.per, int(out_dtype == torch.float32),
                _lib.stream_ptr(x))
    return y


# ------------------------------ B6 ------------------------------

# B6's tiles (csrc/int8xint8_matmul.cu): (consumer warpgroups, columns), a
# tile being 64 x consumers rows; K in steps of 128 bytes; the K (in steps)
# from which the direct form takes tiles between one and two waves
B6_TILES, B6_STEP, B6_LONG_K = ((2, 128), (2, 64), (1, 64)), 128, 17


class B6Plan(NamedTuple):
    """How B6 cuts ``y [m, n]``: ``tiles`` tiles of ``64 consumers`` rows
    by ``bn`` columns (row tiles fastest), walked by ``grid`` persistent
    blocks, ``staged`` (the epilogue through shared memory and a TMA store,
    one block an SM) or not (from registers, two blocks an SM, a block a
    tile); every block runs all of K."""
    consumers: int
    bn: int
    staged: bool
    tiles: int
    grid: int


def int8xint8_plan(m: int, n: int, k: int, sms: int,
                   out_bytes: int = 4) -> B6Plan:
    """B6's tile and schedule for ``[m, K] x [n, K]^T`` on ``sms`` SMs
    (from a sweep of every tile, form and split on the H100:
    ``testing/profile_quant.py --b6-plans``, PERF.md §6). Where 128 x 128
    tiles outnumber the SMs: those, staged, persistent on one block an SM;
    but direct, every tile resident at two an SM, where they are at most
    two waves and K is at least :data:`B6_LONG_K` steps (the second wave of
    one block an SM would run mostly alone). Otherwise the tile whose
    count keeps the most SMs busy in one wave (on a tie, the one that pads
    fewest rows, then the larger), staged. The staged form needs 16-byte
    output rows (``n * out_bytes``); without them the direct form runs the
    same tiles."""
    steps = -(-k // B6_STEP)
    staged = (n * out_bytes) % 16 == 0

    def tiles(c, bn):
        return -(-m // (64 * c)) * -(-n // bn)

    def padded_rows(c):
        return -(-m // (64 * c)) * 64 * c

    big = tiles(2, 128)
    if big > sms:
        direct = not staged or (big <= 2 * sms and steps >= B6_LONG_K)
        return B6Plan(2, 128, not direct, big, big if direct else sms)
    c, bn = max((cb for cb in B6_TILES if tiles(*cb) <= sms),
                key=lambda cb: (tiles(*cb), -padded_rows(cb[0]),
                                cb[0] * cb[1]))
    return B6Plan(c, bn, staged, tiles(c, bn), tiles(c, bn))


def int8xint8_matmul_plain(qx: torch.Tensor, sx: torch.Tensor,
                           qw: torch.Tensor, sw: torch.Tensor,
                           out_dtype=torch.float32) -> torch.Tensor:
    """Exact int32 product, then ``float(acc) * sx * sw`` in that order."""
    _lib.plain_calls["int8xint8_matmul"] += 1
    acc = torch._int_mm(qx, qw.T)
    return (acc.float() * sx.reshape(-1, 1) * sw).to(out_dtype)


def int8xint8_matmul(qx: torch.Tensor, sx: torch.Tensor, qw: torch.Tensor,
                     sw: torch.Tensor,
                     out_dtype=torch.float32) -> torch.Tensor:
    """B6: qx [m, K] int8 with row scales sx [m, 1] fp32, qw [N, K] int8
    with column scales sw [N] fp32 -> [m, N] fp32 or bf16."""
    if _lib.is_cpu(qx, "int8xint8_matmul"):
        return int8xint8_matmul_plain(qx, sx, qw, sw, out_dtype)
    name = "int8xint8_matmul"
    _lib.check_cuda(name, qx, sx, qw, sw)
    _lib.check_dtype(name, torch.int8, qx, qw)
    _lib.check_dtype(name, torch.float32, sx, sw)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: the CUDA kernel writes float32 or "
                        f"bfloat16, not {out_dtype}")
    m, k = qx.shape
    n = qw.shape[0]
    if (qw.shape != (n, k) or sx.numel() != m or sw.shape != (n,) or k % 16
            or n % 2):
        raise ValueError(f"{name}: unsupported shapes qx={tuple(qx.shape)} "
                         f"qw={tuple(qw.shape)} (needs K % 16 == 0, N even)")
    _lib.check_contiguous(name, qx, sx, qw, sw)
    y = torch.empty((m, n), dtype=out_dtype, device=qx.device)
    plan = int8xint8_plan(m, n, k, _lib.sm_count(qx.device),
                          y.element_size())
    _lib.launch(name, "vlm_int8xint8_matmul", qx.data_ptr(), sx.data_ptr(),
                qw.data_ptr(), sw.data_ptr(), y.data_ptr(), m, n, k,
                int(out_dtype == torch.bfloat16), plan.consumers, plan.bn,
                int(plan.staged), plan.grid, _lib.stream_ptr(qx))
    return y


# ------------------------------ B7 ------------------------------

# B7's forms: the weight-streaming decode form (csrc/int4_matmul.cu) up to
# DECODE_ROWS rows, the wgmma prefill form (csrc/int4_prefill.cu) above,
# where K % 32 == 0 (16-byte packed rows for its TMA boxes); its tiles:
# PREFILL_COLS weight rows by 64 rows a consumer warpgroup (2 or 3), K in
# stages of PREFILL_STEP
DECODE_ROWS, PREFILL_COLS, PREFILL_STEP = 64, 128, 64
PREFILL_CONSUMERS, PREFILL_MAX_SPLITS = (3, 2), 8
# from this many rows dense_int4 takes the dequantized product where the
# prefill form cannot run (K % 32 != 0): :func:`int4_dequant_gate`
DEQUANT_ROWS = 1536


def int4_narrow_warps(m: int, n: int, k: int) -> int:
    """The warps a block of B7's narrow decode form (``vlm_int4_matmul_
    narrow``: 16 weight rows a block, K split over its warps, no cluster)
    for ``[m, K] x [n, K]^T``, or 0 for the weight-streaming mainloop. From
    a sweep of both on the H100 (``testing/profile_quant.py --plans``,
    PERF.md §6): the narrow form re-reads all of x for every 16 columns, a
    cost that grows with m, and saves the mainloop's ring fill and cluster
    reduction, which weigh most where the weights are few; it won at every
    product of at most 8 rows, at 16 rows up to 4,096 columns and at 32
    rows from 512 to 2,048 columns. 16 warps (half the K a warp) at 16
    rows or fewer and at most 2,048 columns (128 blocks or fewer)."""
    if k % 32 or not (m <= 8 or (m <= 16 and n <= 4096)
                      or (m <= 32 and 512 <= n <= 2048)):
        return 0
    return 16 if m <= 16 and n <= 2048 else 8


def int4_prefill_form(m: int, n: int, k: int) -> bool:
    """Whether B7 takes its prefill form for ``[m, K] x [n, K]^T``: above
    :data:`DECODE_ROWS` rows where K % 32 == 0 (16-byte packed rows for its
    TMA boxes), except at two column blocks or fewer up to 512 rows, where
    the decode form's 64-row tiles fill more SMs (Gemma's k/v at 316 rows:
    12.8 against 15.0 µs, PERF.md §6)."""
    return (m > DECODE_ROWS and k % 32 == 0
            and (n > 2 * PREFILL_COLS or m > 512))


def int4_dequant_gate(m: int, k: int) -> bool:
    """Whether ``dense_int4`` takes the plain dequantized product for
    ``[m, K]`` rather than B7: from :data:`DEQUANT_ROWS` rows where K %
    32 != 0 (SigLIP's fc2, K = 4,304 at group 16, 2,160 on a model=2
    rank: 8-byte packed rows, which the prefill form's TMA boxes cannot
    take). There the decode form re-reads and re-converts every weight for
    each 64-row tile. Measured on the H100 against the dequantized product
    (``testing/profile_quant.py --gate``, PERF.md §6): 0.80-0.87 of its
    time at 1,024 rows, even at 1,536 (0.93-1.04), 1.33-1.35 at 2,048 and
    1.8-2.8 at 4,096. Where K % 32 == 0 the prefill form beat that product
    at every admission measured, 4.7x at 1,264 rows, 1.6x at 5,188
    (``--prefill-plans``)."""
    return k % 32 != 0 and m >= DEQUANT_ROWS


class PrefillPlan(NamedTuple):
    """How B7's prefill form cuts ``y [m, n]``: blocks of
    :data:`PREFILL_COLS` columns by ``64 consumers`` rows, ``grid``
    (column blocks, row blocks, splits); each block's K range is stages
    ``[z per, min(stages, (z + 1) per))`` of :data:`PREFILL_STEP` k."""
    consumers: int
    splits: int
    per: int
    stages: int
    grid: Tuple[int, int, int]


def int4_prefill_plan(m: int, n: int, k: int, sms: int) -> PrefillPlan:
    """The prefill form's consumers (warpgroups of 64 rows a block: the
    count of 3 or 2 that gives the fewest row blocks, each of which
    dequantizes every weight once, then pads the m64 row tiles least) and
    its split of K: the most blocks of one cluster (at most
    :data:`PREFILL_MAX_SPLITS`, each of at least 4 stages) that keep the
    grid within one block an SM. The splits cover K exactly, none empty.
    (From a sweep of both counts and splits 1-8 on the H100:
    ``testing/profile_quant.py --prefill-plans``, PERF.md §6.)"""
    tiles = -(-m // 64)
    consumers = min(PREFILL_CONSUMERS,
                    key=lambda c: (-(-tiles // c), -(-tiles // c) * c))
    row_blocks = -(-tiles // consumers)
    cols = -(-n // PREFILL_COLS)
    stages = -(-k // PREFILL_STEP)
    blocks = cols * row_blocks
    splits = max(1, min(PREFILL_MAX_SPLITS, sms // blocks, stages // 4))
    per = -(-stages // splits)
    splits = -(-stages // per)
    return PrefillPlan(consumers, splits, per, stages,
                       (cols, row_blocks, splits))


def int4_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      group_size: int, out_dtype=None) -> torch.Tensor:
    """The dequantized product (``quant_matmul(use_pallas=False)``): the
    weight formed as ``nibble * scale`` in fp32 and rounded once, to bf16
    for a bf16 result, else fp32, then ``torch.matmul`` with fp32
    accumulation and one rounding to ``out_dtype`` (default x's)."""
    _lib.plain_calls["int4_matmul"] += 1
    return quant_matmul_dequant(x, QuantizedWeight(q, scale, group_size),
                                out_dtype=out_dtype)


def int4_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                group_size: int, out_dtype=None) -> torch.Tensor:
    """B7, the grouped int4 product: x [m, K], q [N, K/2] packed int4,
    scale [N, K/group_size] fp32 -> [m, N]. On the card x is bf16, the
    output bf16 or fp32 (as B5's), K divides by 16, group_size is 16, 32,
    64 or 128 (every group ``models.layers.int4_group_size`` gives) and N
    is even. The prefill form runs where :func:`int4_prefill_form` says,
    elsewhere the decode form (its narrow variant where
    :func:`int4_narrow_warps` says)."""
    if _lib.is_cpu(x, "int4_matmul"):
        return int4_matmul_plain(x, q, scale, group_size, out_dtype)
    name = "int4_matmul"
    out_dtype = out_dtype or x.dtype
    _lib.check_cuda(name, x, q, scale)
    _lib.check_bf16(name, x)
    _lib.check_dtype(name, torch.int8, q)
    _lib.check_dtype(name, torch.float32, scale)
    _check_out(name, out_dtype)
    m, k = x.shape
    n = q.shape[0]
    if (group_size not in (16, 32, 64, 128) or k % 16 or k % group_size
            or n % 2 or q.shape != (n, k // 2)
            or scale.shape != (n, k // group_size)):
        raise ValueError(f"{name}: unsupported shapes x={tuple(x.shape)} "
                         f"q={tuple(q.shape)} scale={tuple(scale.shape)} "
                         f"group_size={group_size} (needs K % 16 == 0, "
                         f"group_size 16, 32, 64 or 128, N even)")
    _lib.check_contiguous(name, x, q, scale)
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    f32 = int(out_dtype == torch.float32)
    sms = _lib.sm_count(x.device)
    warps = int4_narrow_warps(m, n, k)
    if warps:
        _lib.launch(name, "vlm_int4_matmul_narrow", x.data_ptr(),
                    q.data_ptr(), scale.data_ptr(), y.data_ptr(), m, n, k,
                    group_size, warps, f32, _lib.stream_ptr(x))
        return y
    if int4_prefill_form(m, n, k):
        pre = int4_prefill_plan(m, n, k, sms)
        _lib.launch("int4_matmul_prefill", "vlm_int4_matmul_prefill",
                    x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                    y.data_ptr(), m, n, k, group_size, pre.consumers,
                    pre.splits, pre.per, f32, _lib.stream_ptr(x))
        return y
    plan = stream_plan(m, n, k // 2, sms, _lib.max_clusters(x.device),
                       int4=True)
    _lib.launch(name, "vlm_int4_matmul", x.data_ptr(), q.data_ptr(),
                scale.data_ptr(), y.data_ptr(), m, n, k, group_size, plan.bm,
                plan.bn, plan.splits, plan.per, f32, _lib.stream_ptr(x))
    return y


# ------------------------- the quantized matmul modes -------------------------

def quant_matmul_dynamic(x: torch.Tensor, qw: QuantizedWeight, *,
                         out_dtype=None, row_max=None) -> torch.Tensor:
    """llm.int8 without outliers: per-row int8 activations x int8 weights
    through B6. ``x`` [m, K] -> [m, N]. int8 weights only. ``row_max``:
    as :func:`quantize_activations`'s."""
    assert qw.group_size == 0, "dynamic path requires int8 weights"
    qx, sx = quantize_activations(x, row_max)
    return int8xint8_matmul(qx, sx, qw.q, qw.scale,
                            out_dtype=out_dtype or x.dtype)


def quant_matmul_outlier(x: torch.Tensor, qw: QuantizedWeight, *,
                         n_outliers: int = 32, out_dtype=None,
                         comm=None) -> torch.Tensor:
    """llm.int8 with outlier decomposition: the ``n_outliers`` input
    columns of largest |x| take a bf16 product against their dequantized
    weight columns (plain ``torch.matmul``, as JAX left it to XLA, with the
    reference's bf16 casts kept even in fp32 compute), and the rest goes
    through :func:`quant_matmul_dynamic` with those columns zeroed. int8
    weights only. With ``comm`` (a sharded layer's
    :class:`~vlm_tpu_torch.models.layers.ShardComm`) the columns are chosen
    from the maxima over every rank's rows and all of K, and this rank
    computes the part of both products that its columns of K hold."""
    assert qw.group_size == 0, "outlier decomposition requires int8 weights"
    out_dtype = out_dtype or x.dtype
    k = x.shape[-1]
    col_mag = x.float().abs().amax(dim=0)                        # [K]
    if comm is not None:
        return _outlier_sharded(x, qw, n_outliers, out_dtype, comm,
                                comm.col_max(col_mag))
    idx = torch.topk(col_mag, min(n_outliers, k)).indices
    x_out = x[:, idx].to(torch.bfloat16).float()                 # [m, n_out]
    w_out = (qw.q[:, idx].float() * qw.scale[:, None]).to(
        torch.bfloat16).float()                                  # [N, n_out]
    y_out = torch.matmul(x_out, w_out.T).to(torch.bfloat16)
    y_int8 = quant_matmul_dynamic(x.index_fill(1, idx, 0), qw,
                                  out_dtype=torch.float32)
    return (y_int8 + y_out.float()).to(out_dtype)


def _outlier_sharded(x, qw, n_outliers, out_dtype, comm, col_mag):
    """:func:`quant_matmul_outlier` on a shard: ``col_mag`` holds the
    maxima of all of K; the chosen columns outside this rank's
    ``[k_lo, k_lo + K)`` are zero here (masked, so the shapes stay fixed
    and nothing is read back). A row-parallel rank then sums its model
    group's outlier columns (:meth:`ShardComm.outliers`: each is nonzero on
    one rank, so the sum is exact), so that their bf16 product is rounded
    once, over all of them, as ``vlm_tpu``'s is; one rank of the group
    adds it to its partial product."""
    k = x.shape[-1]
    m = x.shape[0]
    idx = torch.topk(col_mag, min(n_outliers, col_mag.shape[0])).indices
    local = idx - comm.k_lo
    mine = (local >= 0) & (local < k)
    at = torch.where(mine, local, 0)
    x_out = torch.where(mine, x[:, at], 0).to(torch.bfloat16).float()
    w_out = torch.where(mine, qw.q[:, at].float() * qw.scale[:, None],
                        0).to(torch.bfloat16).float()
    if comm.row_parallel:
        both = comm.outliers(torch.cat([x_out, w_out]))
        x_out, w_out = both[:m], both[m:]
    drop = torch.zeros(k + 1, dtype=torch.bool, device=x.device).index_fill_(
        0, torch.where(mine, local, k), True)[:k]
    y_int8 = quant_matmul_dynamic(x.masked_fill(drop, 0), qw,
                                  out_dtype=torch.float32,
                                  row_max=comm.row_max)
    if comm.row_parallel and comm.mesh.model_rank:
        return y_int8.to(out_dtype)
    y_out = torch.matmul(x_out, w_out.T).to(torch.bfloat16)
    return (y_int8 + y_out.float()).to(out_dtype)


def matmul_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [N, K]^T`` with the operands in ``w``'s dtype and
    the fp32 accumulator as the result, unrounded: a row-parallel rank's
    partial product, which the model group sums before its one rounding.
    bf16 operands take ``torch.mm``'s fp32 output on the card; on the CPU
    their exact products are summed in fp32."""
    x = x.to(w.dtype)
    if w.dtype == torch.float32:
        return torch.nn.functional.linear(x, w)
    if x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                     out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0])
    return torch.nn.functional.linear(x.float(), w.float())


def quant_matmul_dequant(x: torch.Tensor, qw: QuantizedWeight, *,
                         out_dtype=None) -> torch.Tensor:
    """One-pass dequantize (int8 or int4), then ``torch.matmul`` with fp32
    accumulation (``quant_matmul(use_pallas=False)``): the weight in bf16
    for bf16 activations, else fp32, and one rounding to ``out_dtype``
    (an fp32 result keeps the accumulator: :func:`matmul_fp32`). JAX
    computed this outside any kernel too."""
    out_dtype = out_dtype or x.dtype
    w = dequantize(qw, torch.bfloat16 if x.dtype == torch.bfloat16
                   else torch.float32)
    if out_dtype == torch.float32:
        return matmul_fp32(x, w)
    return torch.matmul(x.to(w.dtype), w.T).to(out_dtype)


def dense_int8(x2: torch.Tensor, qw: QuantizedWeight, mode: str,
               out_dtype: torch.dtype, comm=None) -> torch.Tensor:
    """The int8 dispatch of ``vlm_tpu``'s ``Dense`` on the row count of the
    flattened input: fewer than 512 rows take the weight-only product (B5,
    the int8 branch of ``quant_matmul``); otherwise ``mode``
    (``VLM_TPU_INT8_PREFILL``) picks outlier decomposition plus B6
    (``dynamic``), B6 alone (``dynamic_noout``) or the plain dequantized
    product (``dequant``). With ``comm`` the rows counted are every data
    rank's (``comm.row_ways`` shares), as ``vlm_tpu`` counts the global
    batch, and the activations' maxima span the shards."""
    rows = x2.shape[0] * (comm.row_ways if comm is not None else 1)
    if rows < 512:
        return int8_matmul(x2, qw.q, qw.scale, out_dtype=out_dtype)
    if mode == "dequant":
        return quant_matmul_dequant(x2, qw, out_dtype=out_dtype)
    if mode == "dynamic_noout":
        return quant_matmul_dynamic(
            x2, qw, out_dtype=out_dtype,
            row_max=comm.row_max if comm is not None else None)
    return quant_matmul_outlier(x2, qw, out_dtype=out_dtype, comm=comm)


def dense_int4(x2: torch.Tensor, qw: QuantizedWeight,
               out_dtype: torch.dtype) -> torch.Tensor:
    """The int4 dispatch of ``vlm_tpu``'s ``Dense``
    (``VLM_TPU_INT4_PREFILL=dequant``), set on the H100: B7, except where
    :func:`int4_dequant_gate` gives the plain dequantized product on the
    flattened input's rows. ``vlm_tpu`` takes that product from 512 rows
    at any K, a figure set on a TPU. On the CPU both are the same numbers
    (B7's plain version is the dequantized product)."""
    if int4_dequant_gate(x2.shape[0], x2.shape[1]):
        return quant_matmul_dequant(x2, qw, out_dtype=out_dtype)
    return int4_matmul(x2, qw.q, qw.scale, qw.group_size,
                       out_dtype=out_dtype)
