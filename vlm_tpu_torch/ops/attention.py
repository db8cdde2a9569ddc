"""Prefill / encoder attention: the plain PyTorch version and the B1 kernel.

:func:`attention_plain` mirrors ``vlm_tpu.ops.attention._xla_attention``:
q ``[B, H, Sq, D]``; k/v ``[B, KV, Sk, D]`` (``kv_layout="bhsd"``) or
``[B, Sk, KV, D]`` (``"bshd"``, the cache layout); grouped-query attention
contracts against the shared KV heads without repeating them; masks are
causal with the diagonal at the end of the kv axis, prefix-LM (only with
causal), ``kv_len`` and ``kv_valid``, all with the finite ``-1e30``.

:func:`flash_attention` is the B1 wrapper: for CUDA tensors the bf16
kernel (``csrc/flash_attention.cu``: ``flash_kernel_small`` at head dims
up to :data:`SMALL_D`, ``flash_kernel`` above) or the fp32 one
(``csrc/flash_attention_fp32.cu``), by the operands' dtype; for CPU
tensors the plain version. Where a gradient is needed (grad mode on and
q, k or v requiring one) it routes to :class:`FlashAttentionFn`, B1's
differentiable form (``vlm_tpu``'s ``_flash_attention_diff``): the kernel
as its forward; as its backward, for fp32 CUDA tensors the kernel of
``csrc/flash_attention_fp32_bwd.cu`` (:func:`flash_attention_fp32_backward`,
from the forward's saved output and log-sum-exp), else a recompute of the
attention through :func:`attention_plain`'s operators, differentiated.
:func:`flash_plan` is its host-side plan (the grid it launches and the
packing of (position, head) rows), held against :func:`attention_plain` on
the CPU by ``tests/test_torch_flash_plan.py`` (bf16 form) and
``tests/test_torch_fp32_forms.py`` (fp32 form).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

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
    _lib.plain_calls["flash_attention_fp32" if q.dtype == torch.float32
                     else "flash_attention"] += 1
    return _attention_math(q, k, v, causal=causal, kv_len=kv_len,
                           kv_valid=kv_valid, prefix_len=prefix_len,
                           kv_layout=kv_layout)


def _attention_math(q, k, v, *, causal=False, kv_len=None, kv_valid=None,
                    prefix_len=None, kv_layout="bhsd") -> torch.Tensor:
    """:func:`attention_plain`'s operators, uncounted: also the recompute
    that :class:`FlashAttentionFn`'s backward differentiates."""
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


# B1's tiling: query rows of a block, keys of a K/V tile; the fp32 form's
ROWS, KEYS = 128, 64
ROWS_FP32, KEYS_FP32 = 64, 32
#: the bf16 form's head dims of ``flash_kernel_small`` (its grid puts the
#: row tiles on the slowest axis)
SMALL_D = 96


def fp32_key_split(d: int) -> int:
    """Warps of B1's fp32 form that share a row group of 16 query rows,
    each taking 32 / that many keys of every tile: 2 from D = 88 on (the
    faster on the card at EVA's 88, 128 and Gemma's 256, where at D > 128
    one block fills an SM and twice the warps hide the products' latency),
    else 1 (the faster at CLIP-L's 64 and SigLIP's 72, where two warps
    split each Q fragment's work in half)."""
    return 2 if d > 80 else 1


def fp32_rows(b: int, h: int, kvh: int, sq: int, d: int,
              sm_count: int) -> int:
    """Query rows a block of B1's fp32 form: 64, or 80 (5 row groups)
    where a block fills its SM (D > 128), the group's heads divide 80, and
    80-row blocks fit the grid in one round of the SMs while 64-row blocks
    do not (Gemma's prefill of 4: 128 blocks instead of 160 on 132 SMs)."""
    hpb = math.gcd(h // kvh, 64)
    if d <= 128 or 80 % hpb:
        return ROWS_FP32
    blocks = {rows: -(-sq // (rows // hpb)) * (h // hpb) * b
              for rows in (ROWS_FP32, 80)}
    return 80 if blocks[80] <= sm_count < blocks[ROWS_FP32] else ROWS_FP32


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """How B1 cuts the work. A block takes ``rows`` query rows (:data:`ROWS`;
    the fp32 form :data:`ROWS_FP32`) of one
    (batch, KV head): ``positions`` positions x ``heads_per_block`` query
    heads of that KV head's group, row ``r`` being position ``p0 + r //
    heads_per_block`` of head ``h0 + r % heads_per_block``. ``tiles``
    position tiles of ``groups`` = H / heads_per_block head groups; ``grid``
    is (tiles, groups, B), or for the bf16 form at D <= :data:`SMALL_D`
    (groups, B, tiles): the row tiles slowest, so the last (the fewest
    rows) launches last, and under the causal mask (the kernel reverses
    them) the ones with the most keys first."""
    heads_per_block: int
    positions: int
    tiles: int
    groups: int
    grid: Tuple[int, int, int]


@functools.lru_cache(maxsize=256)
def flash_plan(b: int, h: int, kvh: int, sq: int,
               rows: int = ROWS, d: int = 0) -> FlashPlan:
    """The grid and row packing of B1 for q ``[b, h, sq, d]`` over ``kvh``
    KV heads, ``rows`` query rows a block: gcd(G, 64) heads of a group
    share a block, so one K/V tile feeds them all (all 8 Gemma heads;
    SigLIP, G = 1, one head). ``d``: the bf16 form's head dim (0: the
    fp32 form's grid)."""
    hpb = math.gcd(h // kvh, 64)
    pos = rows // hpb
    tiles, groups = -(-sq // pos), h // hpb
    grid = (groups, b, tiles) if 0 < d <= SMALL_D else (tiles, groups, b)
    return FlashPlan(hpb, pos, tiles, groups, grid)


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if TMA can read it (16-byte aligned base and strides,
    contiguous head dim), else a copy whose head dim is padded to 8."""
    if t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
            st % 8 == 0 for st in t.stride()[:3]):
        return t
    b, h, s, d = t.shape
    buf = t.new_zeros((b, s, h, -(-d // 8) * 8))
    buf[..., :d] = t.transpose(1, 2)
    return buf.transpose(1, 2)[..., :d]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    kv_len: Optional[torch.Tensor] = None,
                    prefix_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B1. q ``[B, H, Sq, D]``, k/v ``[B, KV, Sk, D]`` (any strides with a
    contiguous last dimension), ``kv_len``/``prefix_len`` ``[B]`` int.
    ``prefix_len`` widens a causal mask only, as in the reference. Returns
    ``[B, H, Sq, D]`` whose memory is ``[B, Sq, H, D]``, so the caller's
    merge of the heads is a free reshape.

    Where a gradient is needed, :class:`FlashAttentionFn` (``causal`` only,
    as ``vlm_tpu``'s differentiable form: on the card a call with
    ``kv_len`` or ``prefix_len`` raises; on the CPU autograd differentiates
    the plain version). Otherwise the kernel's output, which carries no
    gradient."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if kv_len is None and prefix_len is None:
            return FlashAttentionFn.apply(q, k, v, causal)
        if not _lib.is_cpu(q, "flash_attention"):
            raise ValueError("flash_attention: the differentiable form takes "
                             "no kv_len or prefix_len mask")
        return attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                               prefix_len=prefix_len)
    return _flash_forward(q, k, v, causal=causal, kv_len=kv_len,
                          prefix_len=prefix_len)


class FlashAttentionFn(torch.autograd.Function):
    """B1's differentiable form (``vlm_tpu/ops/attention.py``
    ``_flash_attention_diff``): the forward is B1 (bf16 or fp32 form; the
    plain version on the CPU) and counts a launch under
    ``flash_attention_diff`` / ``flash_attention_diff_fp32`` too.

    fp32 CUDA tensors: the forward also writes each row's log-sum-exp and
    saves q, k, v, the output and it; the backward is the kernel
    (:func:`flash_attention_fp32_backward`, counted under
    ``flash_attention_diff_fp32_bwd``), and a failed launch raises. CPU
    tensors (and bf16 on the card): only q, k and v are saved, and the
    backward recomputes softmax(q kᵀ d^-½) v with :func:`attention_plain`'s
    operators (fp32 scores, p rounded to v's dtype) under grad mode and
    differentiates them, as ``_flash_diff_bwd`` differentiates
    ``_xla_attention``; it counts in ``_lib.recomputes``, not as a plain
    version's call."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        fp32 = q.dtype == torch.float32
        form = "flash_attention_diff_fp32" if fp32 else "flash_attention_diff"
        ctx.form, ctx.causal = form, causal
        ctx.kernel = fp32 and not _lib.is_cpu(q, "flash_attention")
        if ctx.kernel:
            o, lse = _flash_forward(q, k, v, causal=causal, also=form,
                                    with_lse=True)
            ctx.save_for_backward(q, k, v, o, lse)
            return o
        ctx.save_for_backward(q, k, v)
        return _flash_forward(q, k, v, causal=causal, also=form)

    @staticmethod
    def backward(ctx, g):
        if ctx.kernel:
            grads = flash_attention_fp32_backward(*ctx.saved_tensors, g,
                                                  causal=ctx.causal)
            return (*(gr if need else None for gr, need in
                      zip(grads, ctx.needs_input_grad)), None)
        _lib.recomputes[ctx.form] += 1
        saved = ctx.saved_tensors
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(need)
                       for t, need in zip(saved, ctx.needs_input_grad))
            o = _attention_math(q, k, v, causal=ctx.causal)
            wanted = [t for t in (q, k, v) if t.requires_grad]
            grads = iter(torch.autograd.grad(o, wanted, g))
        return (*(next(grads) if t.requires_grad else None
                  for t in (q, k, v)), None)


#: the head dims the backward kernel is built for (CLIP-L, SigLIP, EVA; 128)
BWD_HEAD_DIMS = (64, 72, 88, 128)


def flash_attention_fp32_backward(q, k, v, o, lse, do, *, causal=False):
    """The fp32 backward kernel of B1's differentiable form
    (``csrc/flash_attention_fp32_bwd.cu``): dq, dk, dv (fp32, laid out as
    q, k and v) of ``o = attention(q, k, v, causal=causal)`` for the output
    gradient ``do``, from the forward's ``o`` and ``lse`` [B, H, Sq]. CUDA
    tensors only (the CPU's backward is the recompute); q ``[B, H, Sq,
    D]``, k/v ``[B, KV, Sk, D]`` with any strides and a contiguous head
    dim, D in :data:`BWD_HEAD_DIMS`. Its workspace holds dS, one fp32
    [B, H, Sq, Sk] matrix. One count under
    ``flash_attention_diff_fp32_bwd`` a call (its three launches)."""
    name = "flash_attention_fp32_backward"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: takes cuda tensors (the CPU's backward "
                         "is the recompute)")
    _lib.check_cuda(name, q, k, v, o, lse, do)
    _lib.check_dtype(name, torch.float32, q, k, v, o, lse, do)
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if (d not in BWD_HEAD_DIMS or k.shape != (b, kvh, sk, d)
            or v.shape != k.shape or h % kvh or o.shape != q.shape
            or do.shape != q.shape or lse.shape != (b, h, sq)):
        raise ValueError(f"{name}: unsupported shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)} (head dims "
                         f"{BWD_HEAD_DIMS})")
    if any(t.stride(3) != 1 for t in (q, k, v, o)) or \
            not lse.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous head dim")
    if do.stride(3) != 1:
        do = do.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    # dS for the kernel's dQ pass: [B, H, Sq, Sk rounded up to 4], fp32
    ld = -(-sk // 4) * 4
    ds = torch.empty((b, h, sq, ld), dtype=torch.float32, device=q.device)
    _lib.launch(
        "flash_attention_diff_fp32_bwd", "vlm_flash_attention_fp32_bwd",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), ds.data_ptr(), ld, b, h, kvh, sq,
        sk, d,
        *(st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()[:3]),
        d ** -0.5, int(causal), _lib.stream_ptr(q))
    return dq, dk, dv


def _flash_forward(q, k, v, *, causal=False, kv_len=None, prefix_len=None,
                   also: str = "", with_lse: bool = False):
    """B1's launch (the plain version for CPU tensors); ``also``: the
    differentiable form whose forward it is, counted beside the kernel's;
    ``with_lse`` (fp32 CUDA tensors only): also each row's log-sum-exp
    [B, H, Sq], returned as ``(o, lse)``."""
    if _lib.is_cpu(q, "flash_attention"):
        return attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                               prefix_len=prefix_len)
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    _lib.check_cuda("flash_attention", q, k, v)
    fp32 = q.dtype == torch.float32
    _lib.check_dtype("flash_attention", torch.float32 if fp32
                     else torch.bfloat16, q, k, v)
    if (k.shape != (b, kvh, sk, d) or v.shape != k.shape or h % kvh
            or d > 256 or d % 2 or sk < 1 or sq < 1):
        raise ValueError(f"flash_attention: unsupported shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: needs a contiguous head dim")
    kvl = pfx = None
    if kv_len is not None:
        kvl = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    if causal and prefix_len is not None:
        pfx = prefix_len.to(device=q.device, dtype=torch.int32).contiguous()
    if fp32:
        return _flash_fp32(q, k, v, kvl, pfx, causal, also, with_lse)
    q, k, v = _tma_ready(q), _tma_ready(k), _tma_ready(v)
    plan = flash_plan(b, h, kvh, sq, d=d)
    # [B, Sq, H, D] memory (the head dim padded to 8 for TMA's 16-byte rows)
    o = torch.empty((b, sq, h, -(-d // 8) * 8), dtype=q.dtype, device=q.device)
    o = (o if d % 8 == 0 else o[..., :d]).transpose(1, 2)
    _lib.launch(
        "flash_attention", "vlm_flash_attention",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        kvl.data_ptr() if kvl is not None else None,
        pfx.data_ptr() if pfx is not None else None,
        b, h, kvh, sq, sk, d, plan.heads_per_block, *plan.grid,
        *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], d ** -0.5,
        int(causal), _lib.stream_ptr(q), also=also)
    return o


def _flash_fp32(q, k, v, kvl, pfx, causal, also="", with_lse=False):
    """B1's fp32 form: fp32 accuracy from three TF32 products on the tensor
    cores, :func:`fp32_rows` rows a block as :func:`flash_plan` packs them,
    :func:`fp32_key_split` warps a row group, any strides with a contiguous
    head dim; the output's memory is [B, Sq, H, D]. ``with_lse``: returns
    ``(o, lse)``, lse [B, H, Sq] (natural log; -1e30 for a row with no live
    key)."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    rows = fp32_rows(b, h, kvh, sq, d, _lib.sm_count(q.device))
    plan = flash_plan(b, h, kvh, sq, rows)
    o = torch.empty((b, sq, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32,
                      device=q.device) if with_lse else None
    _lib.launch(
        "flash_attention_fp32", "vlm_flash_attention_fp32",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if with_lse else None,
        kvl.data_ptr() if kvl is not None else None,
        pfx.data_ptr() if pfx is not None else None,
        b, h, kvh, sq, sk, d, plan.heads_per_block, *plan.grid,
        fp32_key_split(d), rows, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *o.stride()[:3], d ** -0.5, int(causal),
        _lib.stream_ptr(q), also=also)
    return (o, lse) if with_lse else o
