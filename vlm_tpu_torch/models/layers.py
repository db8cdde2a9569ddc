"""Building blocks: activations, norms and the dense layer
(``vlm_tpu/models/layers.py``).

Parameters live in the compute dtype (fp32, or bf16 for the bf16 and 8bit
policies, as ``vlm_tpu`` stores them); norms compute in fp32 and cast back;
a dense layer feeds its operands in the compute dtype with fp32
accumulation. An 8bit dense layer keeps int8 weights with fp32 scales.
"""

from __future__ import annotations

import math
import os
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import QuantizedWeight, dense_int8


def int8_prefill_mode() -> str:
    """``VLM_TPU_INT8_PREFILL``: the int8 product for 512 rows or more
    (``dynamic``, the default: llm.int8 with outlier decomposition;
    ``dynamic_noout``; ``dequant``), validated as ``vlm_tpu`` does."""
    mode = os.environ.get("VLM_TPU_INT8_PREFILL", "dynamic").lower()
    if mode not in ("dequant", "dynamic", "dynamic_noout"):
        raise ValueError(f"VLM_TPU_INT8_PREFILL={mode!r}: expected "
                         f"dequant|dynamic|dynamic_noout")
    return mode


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
    """Dense layer in ``nn.Linear``'s ``[out, in]`` layout (``vlm_tpu``
    stores ``[in, out]``).

    Unquantized: ``weight`` in the compute dtype, the product by
    ``torch.matmul``, as XLA did for JAX. ``quant_bits=8``: ``q``
    ``[out, in]`` int8 and ``scale`` ``[out]`` fp32 (inference only), and
    the product dispatches on the flattened row count like ``vlm_tpu``'s:
    B5 below 512 rows, else the ``VLM_TPU_INT8_PREFILL`` mode, read and
    validated when the layer is built."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True, *,
                 dtype=torch.float32, device=None, quant_bits: int = 0):
        super().__init__()
        if quant_bits == 4:
            raise NotImplementedError(
                "4bit weights are not ported yet (ROADMAP A11: kernel B7)")
        if quant_bits not in (0, 8):
            raise ValueError(f"quant_bits must be 0, 4 or 8, got {quant_bits}")
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.dtype = dtype
        self.quant_bits = quant_bits
        if quant_bits:
            self.int8_mode = int8_prefill_mode()
            self.q = nn.Parameter(
                torch.empty(out_dim, in_dim, dtype=torch.int8, device=device),
                requires_grad=False)
            self.scale = nn.Parameter(
                torch.empty(out_dim, dtype=torch.float32, device=device),
                requires_grad=False)
        else:
            self.weight = nn.Parameter(
                torch.empty(out_dim, in_dim, dtype=dtype, device=device),
                requires_grad=False)
        self.bias = nn.Parameter(
            torch.empty(out_dim, dtype=dtype, device=device),
            requires_grad=False) if use_bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        if self.quant_bits:
            # vlm_tpu's q_init / s_init: int8 in [-112, 112) and a scale
            # that gives the dequantized weights a lecun-normal magnitude
            self.q.random_(-112, 112, generator=gen)
            self.scale.fill_((1.0 / self.in_dim) ** 0.5 / 64.0)
        else:
            # lecun-normal scale, the JAX default kernel init
            self.weight.normal_(0.0, 1.0 / math.sqrt(self.in_dim),
                                generator=gen)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.quant_bits:
            # bf16 operands, fp32 accumulate; the bias joins the fp32 sum
            # before the one rounding to the compute dtype.
            return F.linear(x.to(self.weight.dtype), self.weight, self.bias)
        x2 = x.reshape(-1, self.in_dim).to(self.dtype).contiguous()
        y = dense_int8(x2, QuantizedWeight(self.q, self.scale),
                       self.int8_mode, self.dtype)
        y = y.reshape(*x.shape[:-1], self.out_dim)
        if self.bias is not None:
            # as vlm_tpu: the product rounds to the compute dtype first
            y = y.float() + self.bias.float()
        return y.to(self.dtype)


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
