"""Building blocks: activations, norms and the dense layer
(``vlm_tpu/models/layers.py``).

Parameters live in the compute dtype (fp32, or bf16 for the bf16 policy,
as ``vlm_tpu`` stores them); norms compute in fp32 and cast back; a dense
layer feeds its operands in the compute dtype with fp32 accumulation.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    if name == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "silu":
        return F.silu
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name!r}")


class RMSNorm(nn.Module):
    """RMSNorm; ``gemma_style=True`` computes ``x * (1 + w)`` like Gemma."""

    def __init__(self, dim: int, eps: float = 1e-6, gemma_style: bool = False,
                 *, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.gemma_style = gemma_style
        self.weight = nn.Parameter(torch.empty(dim, dtype=dtype, device=device),
                                   requires_grad=False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.weight.fill_(0.0 if self.gemma_style else 1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        w = self.weight.float()
        out = xf * (1.0 + w) if self.gemma_style else xf * w
        return out.to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, dtype=dtype, device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty(dim, dtype=dtype, device=device),
                                 requires_grad=False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        xf = (xf - mean) * torch.rsqrt(var + self.eps)
        return (xf * self.weight.float() + self.bias.float()).to(x.dtype)


class Dense(nn.Module):
    """Unquantized dense layer, ``weight`` ``[out, in]`` (``nn.Linear``'s
    layout; ``vlm_tpu`` stores ``[in, out]``). ``torch.matmul`` does the
    product, as XLA did for JAX."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True, *,
                 dtype=torch.float32, device=None, quant_bits: int = 0):
        super().__init__()
        if quant_bits == 8:
            raise NotImplementedError(
                "8bit weights are not ported yet (ROADMAP A10: kernels B5/B6)")
        if quant_bits == 4:
            raise NotImplementedError(
                "4bit weights are not ported yet (ROADMAP A11: kernel B7)")
        if quant_bits:
            raise ValueError(f"quant_bits must be 0, 4 or 8, got {quant_bits}")
        self.in_dim = in_dim
        self.weight = nn.Parameter(
            torch.empty(out_dim, in_dim, dtype=dtype, device=device),
            requires_grad=False)
        self.bias = nn.Parameter(
            torch.empty(out_dim, dtype=dtype, device=device),
            requires_grad=False) if use_bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        # lecun-normal scale, the JAX default kernel init
        self.weight.normal_(0.0, 1.0 / math.sqrt(self.in_dim), generator=gen)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # bf16 operands, fp32 accumulate; the bias joins the fp32 sum before
        # the one rounding to the compute dtype.
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


def init_random_(module: nn.Module, seed: int) -> nn.Module:
    """Random weights, drawn in place on the module's own device from one
    seeded generator (a full-size model never passes through host memory).
    Every submodule with ``reset_parameters(gen)`` initialises itself."""
    device = next(module.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
    return module
