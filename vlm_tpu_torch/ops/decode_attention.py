"""Decode-step attention over the KV cache: the plain version and the B2
kernel (``csrc/decode_attention.cu``).

One query token per slot, q ``[B, H, 1, D]``, against the cache in its
native ``[B, S, KV, D]`` layout. Masks: ``kv_len`` ``[B]``; ``kv_valid``
``[B, S]``; or ``kv_window = (pcol, W, acol, gcnt)``, the continuous
batcher's rotating window as scalars (``pcol`` an int or a 0-d tensor,
``W`` an int, ``acol``/``gcnt`` ``[B]``), which replaces ``kv_valid`` and
composes with ``kv_len``. Contract of ``vlm_tpu``'s
``flash_decode_attention``: a fully masked row returns 0, not the mean of V.

An int8 cache comes with ``k_scale``/``v_scale`` ``[B, S, KV, 1]`` fp32
(the int8 form of B2): the scales multiply the scores and the
probabilities, ``q.(k8 s) == (q.k8) s``, and the values enter as int8.

On the card B2 is split-S flash-decoding: :func:`split_plan` cuts the S
rows into splits of whole tiles (64 rows; 32 in the fp32 form), one block
per (kv head, group of 8 query heads, slot, split), and the last block of
each (slot, kv head, group) merges the splits' (max, sum, acc) in the same
launch, through a workspace this wrapper allocates. With fewer than 8
query heads a KV head (MHA decoders; a model=2 rank of Gemma) the bf16 and
int8 caches take the form for few heads (``decode_kernel_few``), one block
per (kv head, slot, split) with a ring of one or two tiles, cut by
:func:`few_plan`. An fp32 query and cache
(models that run with quantization "fp32") take B2's fp32 form, whose
products are each three TF32 products on the tensor cores (fp32
accuracy).

The decode step's KV row write (B3) runs inside the same launch: given
``k_new``/``v_new`` ``[B, 1, KV, D]`` and ``write_start`` (int32 on the
device: ``[1]`` with ``uniform``, else ``[B]``), B2 writes each slot's new
row at its column (quantized, for an int8 cache) and attends over the
caches with the row in place; the result and the caches are bitwise those
of B3's kernel followed by B2's.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from . import _lib
from .kvcache import kv_quantized_write_plain, kv_write_plain

NEG_INF = -1e30
_MODE_LEN, _MODE_VALID, _MODE_WINDOW = 0, 1, 2
# the kernel's geometry: cache rows a step (the fp32 form's), query heads a
# block
TILE_ROWS, TILE_ROWS_FP32, HEADS_PER_BLOCK, MAX_SPLITS = 64, 32, 8, 64


def split_plan(s_total: int, blocks: int, sm_count: int,
               tile: int = TILE_ROWS, per_sm: int = 2) -> Tuple[int, int]:
    """How B2 cuts the S cache rows: ``(splits, rows_per_split)``.
    ``blocks`` is KV x head groups x B, the grid without splits. Each split
    is a whole number of ``tile``-row tiles, holds at least one, and the
    splits cover S exactly; their count brings the grid to about
    ``per_sm`` blocks an SM (2; the fp32 form's smaller blocks 3) where S
    has enough tiles, and stays within the kernel's ``MAX_SPLITS``."""
    n_tiles = max(1, -(-s_total // tile))
    want = min(MAX_SPLITS,
               max(1, -(-per_sm * sm_count // max(1, blocks))))
    per = -(-n_tiles // min(want, n_tiles))
    return -(-n_tiles // per), per * tile


#: the form for few heads: at most this many tiles in a block's ring
FEW_MAX_STAGES = 2


def few_heads(g: int, kvh: int, d: int, int8: bool, pairs: int,
              room: int) -> int:
    """KV heads a block of B2's form for G < 8 over ``pairs`` = KV x B
    (slot, KV head) pairs when the card holds ``room`` blocks of one head
    at once: 2 for an int8 cache of an MHA decoder (G = 1, an even count
    of KV heads, D <= 128) whose pairs fill two rounds of that room (BLIP-2's
    64 slots: a block's set-up and its first tile's wait then serve two
    heads, and it reads 256 contiguous bytes a row; measured faster there,
    slower where the grid then holds less than a round), else 1."""
    return 2 if (int8 and g == 1 and kvh % 2 == 0 and d <= 128
                 and pairs >= 2 * room) else 1


def few_plan(s_total: int, pairs: int, sm_count: int,
             blocks_per_sm: Callable[[int], int]) -> Tuple[int, int, int]:
    """How B2's form for G < 8 cuts the S cache rows: ``(splits,
    rows_per_split, stages)``. ``pairs`` is KV x B, the grid without
    splits; ``blocks_per_sm(stages)`` the blocks an SM holds with a ring of
    that depth. The splits are :func:`split_plan`'s (about two blocks an
    SM where S has the tiles). The ring holds a second tile in flight
    where that keeps the blocks an SM holds: on the card (chip runs of
    the cuts and depths, PERF.md) an SM's blocks, not a block's depth,
    kept its bytes in flight; a deeper ring that cost a block an SM was
    slower, and at the same blocks a third tile was too."""
    splits, rows = split_plan(s_total, pairs, sm_count)
    held = blocks_per_sm(1)
    if held < 1:
        raise ValueError("decode_attention: no block of the form fits an SM")
    stages = 2 if rows > TILE_ROWS and blocks_per_sm(2) >= held else 1
    return splits, rows, stages


def window_mask(s_total: int, kv_window: Tuple, device) -> torch.Tensor:
    """[B, S] liveness of the rotating window, the formula the kernel
    evaluates per row (floor mod, like ``jnp.mod``)."""
    pcol, window, acol, gcnt = kv_window
    pcol = torch.as_tensor(pcol, device=device)
    rows = torch.arange(s_total, device=device)[None, :]
    age = torch.remainder(rows - pcol - acol.to(device)[:, None], window)
    return (rows < torch.clamp(pcol, max=s_total)) | (
        (rows < torch.clamp(pcol + window, max=s_total))
        & (age < gcnt.to(device)[:, None]))


def live_rows(b: int, s_total: int, device, kv_len=None, kv_valid=None,
              kv_window=None) -> torch.Tensor:
    rows = torch.arange(s_total, device=device)[None, :]
    live = torch.ones((b, s_total), dtype=torch.bool, device=device)
    if kv_len is not None:
        live = live & (rows < kv_len.to(device)[:, None])
    if kv_window is not None:
        live = live & window_mask(s_total, kv_window, device)
    elif kv_valid is not None:
        live = live & kv_valid.to(device)
    return live


def _row_scale(scale: torch.Tensor) -> torch.Tensor:
    """[B, S, KV, 1] per-row scales -> [B, KV, 1, S] against the scores."""
    return scale[..., 0].float().permute(0, 2, 1)[:, :, None, :]


def _check_scales(k, k_scale, v_scale):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if (k.dtype == torch.int8) != (k_scale is not None):
        raise ValueError("an int8 cache needs k_scale/v_scale, and only an "
                         "int8 cache takes them")


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, kv_len: Optional[torch.Tensor] = None,
                           kv_valid: Optional[torch.Tensor] = None,
                           kv_window: Optional[Tuple] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Streaming-softmax semantics in one pass: fp32 scores, masked rows
    weigh 0, the denominator is clamped to 1e-30; int8 caches scale the
    scores by ``k_scale`` and the probabilities by ``v_scale``."""
    _check_scales(k, k_scale, v_scale)
    _lib.plain_calls["decode_attention_int8" if k_scale is not None
                     else "decode_attention_fp32" if q.dtype == torch.float32
                     else "decode_attention"] += 1
    b, h, _, d = q.shape
    s_total, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, d).float()
    s = torch.einsum("bngd,bsnd->bngs", qg, k.float()) * (d ** -0.5)
    if k_scale is not None:
        s = s * _row_scale(k_scale)
    live = live_rows(b, s_total, q.device, kv_len, kv_valid,
                     kv_window)[:, None, None, :]
    s = torch.where(live, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if v_scale is not None:
        p = p * _row_scale(v_scale)
    out = torch.einsum("bngs,bsnd->bngd", p, v.float()) / denom
    return out.reshape(b, h, 1, d).to(q.dtype)


def _write_plain(k, v, k_scale, v_scale, k_new, v_new, start, uniform):
    """The fused write's plain version: B3's plain write."""
    if k_scale is not None:
        kv_quantized_write_plain((k, k_scale), (v, v_scale), k_new, v_new,
                                 start, uniform)
    else:
        kv_write_plain(k, v, k_new, v_new, start, uniform)


def _check_rows(k, k_new, v_new, write_start, uniform, int8):
    """The fused write's rows and column on the card, else raise."""
    name = "decode_attention"
    b, _, kvh, d = k.shape
    _lib.check_cuda(name, k_new, v_new, write_start)
    _lib.check_dtype(name, torch.bfloat16 if int8 else k.dtype, k_new, v_new)
    _lib.check_dtype(name, torch.int32, write_start)
    if (k_new.shape != (b, 1, kvh, d) or v_new.shape != k_new.shape
            or not (k_new.is_contiguous() and v_new.is_contiguous())
            or (k_new.data_ptr() | v_new.data_ptr() | k.data_ptr()) % 4):
        raise ValueError(f"decode_attention: the new rows must be "
                         f"contiguous [B, 1, KV, D] = {(b, 1, kvh, d)}, got "
                         f"{tuple(k_new.shape)}")
    if write_start.numel() < (1 if uniform else b) or (
            not write_start.is_contiguous()):
        raise ValueError(f"decode_attention: write_start holds "
                         f"{write_start.numel()} offsets")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: Optional[torch.Tensor] = None,
                     kv_valid: Optional[torch.Tensor] = None,
                     kv_window: Optional[Tuple] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     k_new: Optional[torch.Tensor] = None,
                     v_new: Optional[torch.Tensor] = None,
                     write_start: Optional[torch.Tensor] = None,
                     uniform: bool = False) -> torch.Tensor:
    """B2. Returns ``[B, H, 1, D]`` whose memory is ``[B, 1, H, D]``. A
    bf16 cache, an int8 cache with its fp32 ``k_scale``/``v_scale`` (both
    with a bf16 query), or an fp32 query and cache. With ``k_new``,
    ``v_new`` and ``write_start``, first writes each slot's new row into the
    caches in place (B3 fused into the launch; bf16 rows for an int8
    cache, else rows of the cache's type)."""
    if (k_new is None) != (v_new is None) or (
            (k_new is None) != (write_start is None)):
        raise ValueError("k_new, v_new and write_start go together")
    if _lib.is_cpu(q, "decode_attention"):
        if k_new is not None:
            _write_plain(k, v, k_scale, v_scale, k_new, v_new, write_start,
                         uniform)
        return decode_attention_plain(q, k, v, kv_len=kv_len,
                                      kv_valid=kv_valid, kv_window=kv_window,
                                      k_scale=k_scale, v_scale=v_scale)
    _check_scales(k, k_scale, v_scale)
    int8 = k_scale is not None
    b, h, sq, d = q.shape
    s_total, kvh = k.shape[1], k.shape[2]
    _lib.check_cuda("decode_attention", q, k, v)
    fp32 = q.dtype == torch.float32 and not int8
    _lib.check_dtype("decode_attention", torch.float32 if fp32
                     else torch.bfloat16, q)
    _lib.check_dtype("decode_attention", torch.int8 if int8
                     else q.dtype, k, v)
    if (sq != 1 or k.shape != (b, s_total, kvh, d) or v.shape != k.shape
            or h % kvh or h // kvh > 32 or d > 256 or d % (4 if int8 else 2)):
        raise ValueError(f"decode_attention: unsupported shapes "
                         f"q={tuple(q.shape)} k={tuple(k.shape)}")
    if not (k.is_contiguous() and v.is_contiguous()) or q.stride(3) != 1:
        raise ValueError("decode_attention: needs contiguous caches and a "
                         "contiguous query head dim")
    if not fp32 and (q.stride(0) % 2 or q.stride(1) % 2 or q.data_ptr() % 4):
        q = q.contiguous()      # the bf16 kernel reads q as bf16 pairs
    if int8:
        _lib.check_cuda("decode_attention", k_scale, v_scale)
        _lib.check_dtype("decode_attention", torch.float32, k_scale, v_scale)
        if (k_scale.shape != (b, s_total, kvh, 1)
                or v_scale.shape != k_scale.shape
                or not (k_scale.is_contiguous() and v_scale.is_contiguous())):
            raise ValueError(f"decode_attention: scales must be contiguous "
                             f"[B, S, KV, 1], got {tuple(k_scale.shape)}")
    if k_new is not None:
        _check_rows(k, k_new, v_new, write_start, uniform, int8)
    dev = q.device
    i32 = dict(device=dev, dtype=torch.int32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    kvl = kv_len.to(**i32).contiguous() if kv_len is not None else None
    valid = pcol = acol = gcnt = None
    window = 0
    if kv_window is not None:
        mode = _MODE_WINDOW
        pcol_v, window, acol_v, gcnt_v = kv_window
        window = int(window)
        pcol = torch.as_tensor(pcol_v).to(**i32).reshape(1)
        acol = acol_v.to(**i32).contiguous()
        gcnt = gcnt_v.to(**i32).contiguous()
    elif kv_valid is not None:
        mode = _MODE_VALID
        valid = kv_valid.to(device=dev, dtype=torch.bool).contiguous()
    else:
        mode = _MODE_LEN
    o = torch.empty((b, 1, h, d), dtype=q.dtype, device=dev).transpose(1, 2)
    blocks = kvh * -(-(h // kvh) // HEADS_PER_BLOCK) * b
    stages = heads = 1
    if fp32:
        splits, rows = split_plan(s_total, blocks, _lib.sm_count(dev),
                                  TILE_ROWS_FP32, 3)
    elif h // kvh < HEADS_PER_BLOCK:
        sms = _lib.sm_count(dev)
        heads = few_heads(h // kvh, kvh, d, int8, blocks, sms * _lib.few_blocks(
            dev, int8, d, 1, k_new is not None))
        splits, rows, stages = few_plan(
            s_total, blocks // heads, sms,
            lambda st: _lib.few_blocks(dev, int8, d, st, k_new is not None,
                                       heads))
    else:
        splits, rows = split_plan(s_total, blocks, _lib.sm_count(dev))
    ws = counters = None
    if splits > 1:
        dp = -(-d // 16) * 16
        ws = torch.empty(blocks * splits * HEADS_PER_BLOCK * (2 + dp),
                         dtype=torch.float32, device=dev)
        counters = _lib.tile_counters(dev, blocks)
    rows_new = (ptr(k_new), ptr(v_new), ptr(write_start))
    fused = "" if k_new is None else \
        "kv_write_int8_fused" if int8 else "kv_write_fused"
    if fp32:
        _lib.launch(
            "decode_attention_fp32", "vlm_decode_attention_fp32",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), ptr(kvl),
            ptr(valid), ptr(pcol), ptr(acol), ptr(gcnt), *rows_new, ptr(ws),
            ptr(counters), b, h, kvh, s_total, d, window, mode, rows,
            int(uniform), q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            o.stride(0), o.stride(1), d ** -0.5, _lib.stream_ptr(q),
            also=fused)
        return o
    _lib.launch(
        "decode_attention_int8" if int8 else "decode_attention",
        "vlm_decode_attention",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), ptr(k_scale),
        ptr(v_scale), ptr(kvl), ptr(valid), ptr(pcol), ptr(acol), ptr(gcnt),
        *rows_new, ptr(ws), ptr(counters), b, h, kvh, s_total, d, window,
        mode, rows, int(uniform), stages, heads, q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), o.stride(0), o.stride(1), d ** -0.5,
        _lib.stream_ptr(q), also=fused)
    return o
