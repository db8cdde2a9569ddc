"""Prefill / encoder attention: the plain PyTorch version and the B1 kernel.

:func:`attention_plain` mirrors ``vlm_tpu.ops.attention._xla_attention``:
q ``[B, H, Sq, D]``; k/v ``[B, KV, Sk, D]`` (``kv_layout="bhsd"``) or
``[B, Sk, KV, D]`` (``"bshd"``, the cache layout); grouped-query attention
contracts against the shared KV heads without repeating them; masks are
causal with the diagonal at the end of the kv axis, prefix-LM (only with
causal), ``kv_len`` and ``kv_valid``, all with the finite ``-1e30``.

:func:`flash_attention` is the B1 wrapper (``csrc/flash_attention.cu``):
the kernel for CUDA tensors, the plain version for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _lib

NEG_INF = -1e30


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    kv_len: Optional[torch.Tensor] = None,
                    kv_valid: Optional[torch.Tensor] = None,
                    prefix_len: Optional[torch.Tensor] = None,
                    kv_layout: str = "bhsd") -> torch.Tensor:
    """Reference attention; scores and softmax in fp32, probabilities
    rounded to v's dtype before the P.V product (as the JAX reference)."""
    _lib.plain_calls["flash_attention"] += 1
    b, h, sq, d = q.shape
    if kv_layout == "bshd":
        kvh, sk = k.shape[2], k.shape[1]
        k_eq = "bknd"
    else:
        kvh, sk = k.shape[1], k.shape[2]
        k_eq = "bnkd"
    g = h // kvh
    qg = q.reshape(b, kvh, g, sq, d).float()
    s = torch.einsum(f"bngqd,{k_eq}->bngqk", qg, k.float()) * (d ** -0.5)
    dev = q.device
    if causal:
        qi = torch.arange(sq, device=dev)[:, None]
        ki = torch.arange(sk, device=dev)[None, :]
        allowed = (ki <= qi + (sk - sq))[None, None, None]
        if prefix_len is not None:
            in_prefix = ki[None] < prefix_len.to(dev)[:, None, None]
            allowed = allowed | in_prefix[:, None, None]
        s = torch.where(allowed, s, NEG_INF)
    if kv_len is not None:
        mask = torch.arange(sk, device=dev)[None, :] < kv_len.to(dev)[:, None]
        s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    if kv_valid is not None:
        s = torch.where(kv_valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    out = torch.einsum(f"bngqk,{k_eq}->bngqd", p, v.float())
    return out.reshape(b, h, sq, d).to(q.dtype)


def _strides(t: torch.Tensor):
    """(batch, head, seq) element strides of a [B, H, S, D] view whose last
    dimension is contiguous."""
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    kv_len: Optional[torch.Tensor] = None,
                    prefix_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B1. q ``[B, H, Sq, D]``, k/v ``[B, KV, Sk, D]`` (any strides with a
    contiguous last dimension), ``kv_len``/``prefix_len`` ``[B]`` int.
    ``prefix_len`` widens a causal mask only, as in the reference. Returns
    ``[B, H, Sq, D]`` whose memory is ``[B, Sq, H, D]``, so the caller's
    merge of the heads is a free reshape."""
    if _lib.is_cpu(q, "flash_attention"):
        return attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                               prefix_len=prefix_len)
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    _lib.check_cuda("flash_attention", q, k, v)
    _lib.check_bf16("flash_attention", q, k, v)
    if (k.shape != (b, kvh, sk, d) or v.shape != k.shape or h % kvh
            or d > 256 or d % 2 or sk < 1):
        raise ValueError(f"flash_attention: unsupported shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    for t in (q, k, v):
        if t.stride(3) != 1 or any(s % 2 for s in t.stride()[:3]) \
                or t.data_ptr() % 4:
            raise ValueError("flash_attention: needs a contiguous head dim, "
                             "even strides and 4-byte aligned data")
    o = torch.empty((b, sq, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    kvl = pfx = None
    if kv_len is not None:
        kvl = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    if causal and prefix_len is not None:
        pfx = prefix_len.to(device=q.device, dtype=torch.int32).contiguous()
    _lib.launch(
        "flash_attention", "vlm_flash_attention",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        kvl.data_ptr() if kvl is not None else None,
        pfx.data_ptr() if pfx is not None else None,
        b, h, kvh, sq, sk, d, *_strides(q), *_strides(k), *_strides(v),
        *_strides(o), d ** -0.5, int(causal), _lib.stream_ptr(q))
    return o
