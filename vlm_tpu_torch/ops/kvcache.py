"""In-place KV-cache row writes: the plain masked write and the B3 kernel
(``csrc/kv_write.cu``) in its bf16 and int8 forms. The decode step's write
runs inside B2's launch instead (``ops.decode_attention``, the fused
forms); these serve the int8 prefill rows and any write no B2 follows.

Caches are ``[B, L, KV, D]``; new rows ``[B, S, KV, D]``; ``start`` ``[B]``
int on the caches' device, so no write offset ever waits on the host.
An int8 cache layer is a ``(q, scale)`` pair, values ``[B, L, KV, D]``
int8 and scales ``[B, L, KV, 1]`` fp32 (``models.decoder.QuantizedKV``).
Every function updates the caches in place and returns them.
"""

from __future__ import annotations

import torch

from . import _lib
from .quant import quantize_activations


def kv_masked_write(cache: torch.Tensor, new: torch.Tensor,
                    start: torch.Tensor) -> torch.Tensor:
    """Plain version (``vlm_tpu.ops.kvcache.kv_masked_write``): a masked
    select over the length axis, written back in place."""
    b, s = new.shape[:2]
    max_len = cache.shape[1]
    pos = torch.arange(max_len, device=cache.device)[None, :]
    rel = pos - start.to(cache.device).long()[:, None]          # [B, L]
    in_window = (rel >= 0) & (rel < s)
    if s == 1:
        update = new.expand(b, max_len, *new.shape[2:])
    else:
        idx = rel.clamp(0, s - 1)[:, :, None, None].expand(
            b, max_len, *new.shape[2:])
        update = torch.gather(new, 1, idx)
    cache.copy_(torch.where(in_window[:, :, None, None],
                            update.to(cache.dtype), cache))
    return cache


def kv_write_plain(k_cache, v_cache, k_new: torch.Tensor,
                   v_new: torch.Tensor, start: torch.Tensor, uniform: bool):
    """Plain B3 for a bf16 or fp32 cache: the masked write of one row per
    slot into both caches, at ``start[0]`` (``uniform``) or ``start[b]``."""
    _lib.plain_calls["kv_write"] += 1
    pos = start[:1].expand(k_cache.shape[0]) if uniform else start
    kv_masked_write(k_cache, k_new, pos)
    kv_masked_write(v_cache, v_new, pos)
    return k_cache, v_cache


def _write(k_cache, v_cache, k_new, v_new, start, uniform: bool):
    name = "kv_uniform_write" if uniform else "kv_scatter_write"
    if k_new.shape[1] != 1:
        raise ValueError(f"{name} writes one row per slot (got S="
                         f"{k_new.shape[1]})")
    b = k_cache.shape[0]
    if _lib.is_cpu(k_cache, name):
        return kv_write_plain(k_cache, v_cache, k_new, v_new, start, uniform)
    _lib.check_cuda(name, k_cache, v_cache, k_new, v_new, start)
    if not all(t.is_contiguous() for t in (k_cache, v_cache, k_new, v_new)):
        raise ValueError(f"{name}: needs contiguous caches and rows")
    if (v_cache.shape != k_cache.shape or k_new.shape != v_new.shape
            or k_new.shape[0] != b or k_new.shape[2:] != k_cache.shape[2:]
            or k_new.dtype != k_cache.dtype or v_new.dtype != v_cache.dtype
            or v_cache.dtype != k_cache.dtype):
        raise ValueError(f"{name}: rows {tuple(k_new.shape)} {k_new.dtype} "
                         f"do not match caches {tuple(k_cache.shape)} "
                         f"{k_cache.dtype}")
    start = start.to(torch.int32).contiguous()
    if start.numel() < (1 if uniform else b):
        raise ValueError(f"{name}: start holds {start.numel()} offsets")
    row_bytes = k_cache[0, 0].numel() * k_cache.element_size()
    _lib.launch("kv_write", "vlm_kv_write", k_cache.data_ptr(),
                v_cache.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                start.data_ptr(), int(uniform), b, k_cache.shape[1],
                row_bytes, k_cache.stride(0) * k_cache.element_size(),
                k_new.stride(0) * k_new.element_size(),
                _lib.stream_ptr(k_cache))
    return k_cache, v_cache


def kv_uniform_write(k_cache: torch.Tensor, v_cache: torch.Tensor,
                     k_new: torch.Tensor, v_new: torch.Tensor,
                     start: torch.Tensor):
    """B3, uniform mode: every slot's row lands at column ``start[0]``."""
    return _write(k_cache, v_cache, k_new, v_new, start, uniform=True)


def kv_scatter_write(k_cache: torch.Tensor, v_cache: torch.Tensor,
                     k_new: torch.Tensor, v_new: torch.Tensor,
                     start: torch.Tensor):
    """B3, scatter mode: slot ``b``'s row lands at column ``start[b]``."""
    return _write(k_cache, v_cache, k_new, v_new, start, uniform=False)


def kv_quantized_write_plain(k_cache, v_cache, k_new: torch.Tensor,
                             v_new: torch.Tensor, start: torch.Tensor,
                             uniform: bool):
    """Plain int8 form: ``quantize_activations`` per (slot, row, kv head)
    row, then the masked write of values and scales."""
    _lib.plain_calls["kv_write_int8"] += 1
    pos = start[:1].expand(k_cache[0].shape[0]) if uniform else start
    for (cq, cs), new in ((k_cache, k_new), (v_cache, v_new)):
        q, scale = quantize_activations(new)
        kv_masked_write(cq, q, pos)
        kv_masked_write(cs, scale, pos)
    return k_cache, v_cache


def kv_quantized_write(k_cache, v_cache, k_new: torch.Tensor,
                       v_new: torch.Tensor, start: torch.Tensor,
                       uniform: bool):
    """B3, int8 form: quantize the new rows ``[B, S, KV, D]`` and write
    values and scales into the ``(q, scale)`` caches, row ``s`` of slot
    ``b`` at column ``start[0] + s`` (``uniform``) or ``start[b] + s``."""
    name = "kv_quantized_write"
    if _lib.is_cpu(k_new, name):
        return kv_quantized_write_plain(k_cache, v_cache, k_new, v_new,
                                        start, uniform)
    (kq, ks), (vq, vs) = k_cache, v_cache
    _lib.check_cuda(name, kq, ks, vq, vs, k_new, v_new, start)
    _lib.check_dtype(name, torch.int8, kq, vq)
    _lib.check_dtype(name, torch.float32, ks, vs)
    _lib.check_bf16(name, k_new, v_new)
    b, length, kvh, d = kq.shape
    s = k_new.shape[1]
    if (vq.shape != kq.shape or ks.shape != (b, length, kvh, 1)
            or vs.shape != ks.shape or k_new.shape != (b, s, kvh, d)
            or v_new.shape != k_new.shape or d > 256):
        raise ValueError(f"{name}: rows {tuple(k_new.shape)} do not match "
                         f"the int8 cache {tuple(kq.shape)} / scales "
                         f"{tuple(ks.shape)} (D <= 256)")
    if not all(t.is_contiguous() for t in (kq, ks, vq, vs, k_new, v_new)):
        raise ValueError(f"{name}: needs contiguous caches and rows")
    start = start.to(torch.int32).contiguous()
    if start.numel() < (1 if uniform else b):
        raise ValueError(f"{name}: start holds {start.numel()} offsets")
    _lib.launch("kv_write_int8", "vlm_kv_write_int8", kq.data_ptr(),
                ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
                k_new.data_ptr(), v_new.data_ptr(), start.data_ptr(),
                int(uniform), b, s, length, kvh, d, _lib.stream_ptr(kq))
    return k_cache, v_cache
