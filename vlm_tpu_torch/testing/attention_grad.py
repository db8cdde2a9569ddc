"""The formulation of B1-diff's fp32 backward kernel
(``csrc/flash_attention_fp32_bwd.cu``) in plain tensor operations, for the
CPU tests and the card's checks; the main path never calls it (its CPU
backward is :class:`~vlm_tpu_torch.ops.attention.FlashAttentionFn`'s
recompute).

:func:`attention_lse` is the forward's log-sum-exp (what
``flash_attention_fp32.cu`` writes beside o); :func:`attention_backward`
takes it and o as the kernel does: P = exp(S - lse), delta = rowsum(dO o
O), dS = P o (dP - delta), dq = dS K d^-1/2, dk = dS^T Q d^-1/2, dv = P^T
dO, grouped heads summed into their KV head; a row with no live key
(causal, Sq > Sk) takes P = 1 / Sk and dS = 0, as the finite -1e30 mask
makes it in the plain version. q ``[B, H, Sq, D]``, k/v ``[B, KV, Sk, D]``;
fp32 results. The backward's arithmetic is float64 by default: in fp32,
dP - delta cancels to rounding noise where the exact value is 0 (a causal
row with one live key: dq ~1e-6 instead of 0 at D = 88), which is the
kernel's arithmetic and not its formulation.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.attention import NEG_INF


def _scores(q, k, causal):
    """The scaled, masked scores [B, KV, G, Sq, Sk] (in q's dtype), the
    mask of live (row, key) pairs and the dead rows [Sq] (no live key)."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, sq, d)
    s = torch.einsum("bngqd,bnkd->bngqk", qg, k) * (d ** -0.5)
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(sk, device=q.device)[None, :]
    live = (ki <= qi + (sk - sq)) if causal else torch.ones(
        sq, sk, dtype=torch.bool, device=q.device)
    return torch.where(live, s, NEG_INF), live, ~live.any(dim=1)


def attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False) -> torch.Tensor:
    """Each row's natural-log sum of exp of its scaled, masked scores
    ``[B, H, Sq]`` (-1e30 for a row with no live key)."""
    b, h, sq, _ = q.shape
    s, _, _ = _scores(q.float(), k.float(), causal)
    return torch.logsumexp(s, dim=-1).reshape(b, h, sq)


def attention_backward(q, k, v, o, lse, do, *, causal: bool = False,
                       dtype: torch.dtype = torch.float64
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv (fp32) as the backward kernel forms them, in ``dtype``'s
    arithmetic."""
    q, k, v, o, lse, do = (t.to(dtype) for t in (q, k, v, o, lse, do))
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    s, live, dead = _scores(q, k, causal)
    grp = (b, kvh, g, sq)
    p = torch.exp(s - lse.reshape(*grp, 1))
    p = torch.where(live, p, 0.0)
    p = torch.where(dead[:, None], 1.0 / sk, p)
    dog = do.reshape(*grp, d)
    delta = (dog * o.reshape(*grp, d)).sum(-1, keepdim=True)
    dp = torch.einsum("bngqd,bnkd->bngqk", dog, v)
    ds = torch.where(live & ~dead[:, None], p * (dp - delta), 0.0)
    scale = d ** -0.5
    dq = torch.einsum("bngqk,bnkd->bngqd", ds, k) * scale
    dk = torch.einsum("bngqk,bngqd->bnkd", ds, q.reshape(*grp, d)) * scale
    dv = torch.einsum("bngqk,bngqd->bnkd", p, dog)
    return tuple(t.float() for t in (dq.reshape(b, h, sq, d), dk, dv))
