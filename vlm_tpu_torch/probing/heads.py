"""Probe heads over ``[B, D]`` features (``vlm_tpu/probing/heads.py``):

- :class:`LinearHead`: BatchNorm -> Dropout -> Linear;
- :class:`DeeperHead`: BatchNorm -> Dropout -> Linear -> GELU (exact) ->
  Dropout -> Linear.

The BatchNorm is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``, not
``nn.BatchNorm1d``'s defaults: training normalises with the batch mean and
the *biased* batch variance (E[x²] - E[x]², clipped at 0) and moves the
running statistics by ``0.9 * running + 0.1 * batch`` (torch's momentum
0.1), the variance biased too. Dropout draws its mask from the
``torch.Generator`` passed to ``forward``. ``train()`` / ``eval()`` switch
both, as flax's ``train`` flag. Parameters and statistics are fp32.

With ``mesh`` (a batch split over the data axis: this rank's rows) the
heads compute what one device computes on the whole batch: BatchNorm's
statistics are the global batch's (the sums of ``x`` and ``x²`` and the
row count summed over ``data`` by :meth:`Mesh.sum`, so the running
statistics move alike on every rank), and dropout draws the whole batch's
mask from the shared generator and keeps this rank's rows.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.mesh import DATA_AXIS


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis of ``[B, D]``: ``weight``
    (flax ``scale``), ``bias``, ``running_mean`` and ``running_var``
    (flax ``batch_stats`` ``mean`` and ``var``)."""

    def __init__(self, dim: int, momentum: float = 0.9, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("running_mean", torch.zeros(dim, device=device))
        self.register_buffer("running_var", torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        x = x.float()
        if self.training and mesh is not None and mesh.data > 1:
            count = torch.full((1,), float(x.shape[0]), device=x.device)
            sums = mesh.sum(torch.cat([x.sum(0), (x * x).sum(0), count]),
                            DATA_AXIS)
            d = x.shape[1]
            mean = sums[:d] / sums[-1]
            var = (sums[d:2 * d] / sums[-1] - mean * mean).clamp_min(0.0)
        elif self.training:
            mean = x.mean(dim=0)
            var = ((x * x).mean(dim=0) - mean * mean).clamp_min(0.0)
        if self.training:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator], mesh=None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - p and scale by
    1 / (1 - p), the mask drawn from ``generator`` (under ``mesh``: the
    whole batch's mask, this rank's rows of it)."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - p
    split = mesh is not None and mesh.data > 1
    shape = (x.shape[0] * mesh.data, *x.shape[1:]) if split else x.shape
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if split:
        mask = mask[mesh.rows(shape[0])]
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _linear(in_dim: int, out_dim: int, gen: torch.Generator,
            device) -> nn.Linear:
    """flax ``nn.Dense``'s init: lecun-normal (truncated at two standard
    deviations) kernel, zero bias."""
    fc = nn.Linear(in_dim, out_dim, device=device)
    std = math.sqrt(1.0 / in_dim) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(fc.weight, std=std, a=-2 * std, b=2 * std,
                              generator=gen)
        fc.bias.zero_()
    return fc


class LinearHead(nn.Module):
    """BN -> Dropout -> Linear (reference ``make_head``)."""

    def __init__(self, in_dim: int, n_classes: int, dropout_p: float = 0.3,
                 *, gen: torch.Generator, device=None):
        super().__init__()
        self.dropout_p = dropout_p
        self.bn = BatchNorm(in_dim, device=device)
        self.fc = _linear(in_dim, n_classes, gen, device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                mesh=None) -> torch.Tensor:
        x = dropout(self.bn(x, mesh), self.dropout_p, self.training,
                    generator, mesh)
        return self.fc(x)


class DeeperHead(nn.Module):
    """BN -> Dropout -> Linear -> GELU -> Dropout -> Linear (reference
    ``make_head_deeper``)."""

    def __init__(self, in_dim: int, n_classes: int, hidden_dim: int = 512,
                 dropout_p: float = 0.3, *, gen: torch.Generator,
                 device=None):
        super().__init__()
        self.dropout_p = dropout_p
        self.bn = BatchNorm(in_dim, device=device)
        self.fc1 = _linear(in_dim, hidden_dim, gen, device)
        self.fc2 = _linear(hidden_dim, n_classes, gen, device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                mesh=None) -> torch.Tensor:
        x = dropout(self.bn(x, mesh), self.dropout_p, self.training,
                    generator, mesh)
        x = F.gelu(self.fc1(x), approximate="none")
        x = dropout(x, self.dropout_p, self.training, generator, mesh)
        return self.fc2(x)


def make_head(in_dim: int, n_classes: int, dropout_p: float = 0.3,
              deeper: bool = False, hidden_dim: int = 512, *, seed: int = 0,
              device=None) -> nn.Module:
    """A head with its weights drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device or "cpu")
    gen.manual_seed(seed)
    if deeper:
        return DeeperHead(in_dim, n_classes, hidden_dim, dropout_p, gen=gen,
                          device=device)
    return LinearHead(in_dim, n_classes, dropout_p, gen=gen, device=device)
