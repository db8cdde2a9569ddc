"""Multi-task probe training in plain PyTorch, in float32: EVA ViT-g's
pooled features, one head per task (batch-statistics BatchNorm, dropout,
linear), the masked cross-entropy summed over the tasks, and AdamW with
decoupled weight decay (Loshchilov and Hutter, arXiv:1711.05101), as
``torch.optim.AdamW`` defines its step. Nothing here imports the program.

The tower's gradient is formed in blocks of rows: the features of the whole
batch first, without autograd; then the heads and the loss on them, which
give the gradient at the features; then each block's tower forward again
under autograd, back-propagated from its rows of that gradient. BatchNorm's
statistics are the whole batch's, as in one pass."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .blip2 import eva
from .precision import Precision

MISSING = -1


def dropout_masks(seed: int, steps: int, tasks: Sequence[str], rows: int,
                  dim: int, keep: float,
                  device) -> List[Dict[str, torch.Tensor]]:
    """Each step's keep masks, one a task in order, from a generator on
    ``device`` seeded with ``seed``: the stream a probe's dropout draws
    when its generator is seeded the same."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return [{t: torch.rand((rows, dim), generator=g, device=device) < keep
             for t in tasks} for _ in range(steps)]


def head_logits(P: Precision, H: Dict[str, torch.Tensor], task: str,
                feats: torch.Tensor, mask: torch.Tensor, keep: float,
                eps: float = 1e-5):
    pre = f"heads.{task}."
    mean = feats.mean(0)
    var = ((feats * feats).mean(0) - mean * mean).clamp_min(0.0)
    x = (feats - mean) * torch.rsqrt(var + eps) * H[pre + "bn.weight"] \
        + H[pre + "bn.bias"]
    x = torch.where(mask, x / keep, torch.zeros_like(x))
    return P.linear(x, H[pre + "fc.weight"], H[pre + "fc.bias"])


def masked_ce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the labels that are not missing; 0 when
    every label is."""
    valid = y != MISSING
    if not bool(valid.any()):
        return logits.sum() * 0.0
    return F.cross_entropy(logits[valid], y[valid])


class AdamW:
    """``torch.optim.AdamW``'s update, one leaf at a time."""

    def __init__(self, lrs: Dict[str, float], wd: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.lrs, self.wd, self.betas, self.eps = lrs, wd, betas, eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        for n, p in params.items():
            g = grads[n]
            m = self.m.setdefault(n, torch.zeros_like(p))
            v = self.v.setdefault(n, torch.zeros_like(p))
            lr = self.lrs[n]
            p.mul_(1 - lr * self.wd)
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
            denom = (v.sqrt() / bc2 ** 0.5).add_(self.eps)
            p.addcdiv_(m, denom, value=-lr / bc1)


def train(P: Precision, tower: Dict[str, torch.Tensor],
          heads: Dict[str, torch.Tensor], trained: Sequence[str],
          lrs: Dict[str, float], wd: float, widths: dict, mean, std,
          batches: Sequence[tuple], masks: Sequence[Dict[str, torch.Tensor]],
          tasks: Sequence[str], keep: float, rows_per_block: int,
          pre: str = "vision.") -> dict:
    """``len(batches)`` AdamW steps from ``tower`` and ``heads`` (fp32
    copies, updated in place); ``trained``: the tower leaves that train.
    Each batch is (uint8 images [B, H, W, 3], {task: labels [B]}). Returns
    each step's loss, the first step's gradients and the trained leaves'
    values after the last step."""
    vis = widths["vision"]
    W = dict(tower)
    params = {n: tower[n] for n in trained}
    params.update(heads)
    for p in params.values():
        p.requires_grad_(True)
    opt = AdamW(lrs, wd)
    losses, first = [], None
    for (images, ys), mask in zip(batches, masks):
        with torch.no_grad():
            feats = torch.cat([eva(P, W, vis, images[i:i + rows_per_block],
                                   mean, std, pre)[1]
                               for i in range(0, len(images),
                                              rows_per_block)])
        feats.requires_grad_(True)
        loss = sum(masked_ce(head_logits(P, heads, t, feats, mask[t], keep),
                             ys[t]) for t in tasks)
        *hg, dfeats = torch.autograd.grad(loss, list(heads.values()) +
                                          [feats])
        grads = dict(zip(heads, hg))
        # the tower's gradient block by block, from dfeats
        tg = {n: torch.zeros_like(tower[n]) for n in trained}
        for i in range(0, len(images), rows_per_block):
            f = eva(P, W, vis, images[i:i + rows_per_block], mean, std,
                    pre)[1]
            part = torch.autograd.grad(f, [tower[n] for n in trained],
                                       dfeats[i:i + rows_per_block],
                                       allow_unused=True)
            for n, g in zip(trained, part):
                if g is not None:
                    tg[n] += g
        grads.update(tg)
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        losses.append(float(loss.detach()))
        opt.step(params, grads)
    return {"losses": losses, "first_grads": first,
            "final": {n: p.detach() for n, p in params.items()}}
