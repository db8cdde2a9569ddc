"""Building blocks: activations, norms and the dense layer
(``vlm_tpu/models/layers.py``).

Parameters live in the compute dtype (fp32, or bf16 for the bf16 and 8bit
policies, as ``vlm_tpu`` stores them); norms compute in fp32 and cast back;
a dense layer feeds its operands in the compute dtype with fp32
accumulation. An 8bit dense layer keeps int8 weights with fp32 scales, a
4bit one packed int4 weights with fp32 group scales.
"""

from __future__ import annotations

import math
import os
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import QuantizedWeight, dense_int4, dense_int8


def int8_prefill_mode() -> str:
    """``VLM_TPU_INT8_PREFILL``: the int8 product for 512 rows or more
    (``dynamic``, the default: llm.int8 with outlier decomposition;
    ``dynamic_noout``; ``dequant``), validated as ``vlm_tpu`` does."""
    mode = os.environ.get("VLM_TPU_INT8_PREFILL", "dynamic").lower()
    if mode not in ("dequant", "dynamic", "dynamic_noout"):
        raise ValueError(f"VLM_TPU_INT8_PREFILL={mode!r}: expected "
                         f"dequant|dynamic|dynamic_noout")
    return mode


def int4_prefill_mode() -> str:
    """``VLM_TPU_INT4_PREFILL``, validated as ``vlm_tpu`` does: ``dequant``
    (the default and the port's only mode: 512 rows or more take the plain
    dequantized product); ``fused`` (B7 at every row count) is on ROADMAP's
    do-not-port list."""
    mode = os.environ.get("VLM_TPU_INT4_PREFILL", "dequant").lower()
    if mode not in ("dequant", "fused"):
        raise ValueError(f"VLM_TPU_INT4_PREFILL={mode!r}: expected "
                         f"dequant|fused")
    if mode == "fused":
        raise NotImplementedError(
            "VLM_TPU_INT4_PREFILL=fused is on ROADMAP's do-not-port list "
            "(TPU A/B knobs); the port runs dequant")
    return mode


def int4_group_size(in_dim: int) -> int:
    """``vlm_tpu``'s group fallback: the largest halving of
    ``min(128, in_dim)`` that divides ``in_dim`` (SigLIP's mlp_dim
    4304 = 16 * 269 gets 16; 1152 and every Gemma dim 128)."""
    gs = min(128, in_dim)
    while gs > 1 and in_dim % gs:
        gs //= 2
    if in_dim % 2 or gs < 2:
        raise ValueError(f"no int4 group for in_dim={in_dim}")
    return gs


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
    validated when the layer is built. ``quant_bits=4``: ``q``
    ``[out, in/2]`` packed int4 and ``scale`` ``[out, in/group_size]`` fp32
    (:func:`int4_group_size`); B7 below 512 rows, else the plain dequantized
    product (``VLM_TPU_INT4_PREFILL=dequant``, validated when built)."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True, *,
                 dtype=torch.float32, device=None, quant_bits: int = 0):
        super().__init__()
        if quant_bits not in (0, 4, 8):
            raise ValueError(f"quant_bits must be 0, 4 or 8, got {quant_bits}")
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.dtype = dtype
        self.quant_bits = quant_bits
        self.group_size = 0
        if quant_bits == 8:
            self.int8_mode = int8_prefill_mode()
            q_shape, s_shape = (out_dim, in_dim), (out_dim,)
        elif quant_bits == 4:
            int4_prefill_mode()
            self.group_size = int4_group_size(in_dim)
            q_shape = (out_dim, in_dim // 2)
            s_shape = (out_dim, in_dim // self.group_size)
        if quant_bits:
            self.q = nn.Parameter(
                torch.empty(q_shape, dtype=torch.int8, device=device),
                requires_grad=False)
            self.scale = nn.Parameter(
                torch.empty(s_shape, dtype=torch.float32, device=device),
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
            # vlm_tpu's q_init / s_init: bytes in [-112, 112) (int8 values,
            # or two nibbles) and a scale that gives the dequantized weights
            # a lecun-normal magnitude
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
        qw = QuantizedWeight(self.q, self.scale, self.group_size)
        y = dense_int4(x2, qw, self.dtype) if self.quant_bits == 4 else \
            dense_int8(x2, qw, self.int8_mode, self.dtype)
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
