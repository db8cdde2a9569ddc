"""Building blocks: activations, norms and the dense layer
(``vlm_tpu/models/layers.py``).

Parameters live in the compute dtype (fp32, or bf16 for the bf16 and 8bit
policies, as ``vlm_tpu`` stores them); norms compute in fp32 and cast back;
a dense layer feeds its operands in the compute dtype with fp32
accumulation. An 8bit dense layer keeps int8 weights with fp32 scales, a
4bit one packed int4 weights with fp32 group scales.

Under a mesh a dense layer holds its shard of ``vlm_tpu``'s Megatron
layout (its ``shard`` annotation): column-parallel layers
(``shard=(None, "model")``) a slice of the output features, row-parallel
ones (``("model", None)``) a slice of the input features and one
all-reduce of the output over the model group, the bias added once after
it. A quantized layer whose even split would leave a rank an input count
B5, B6 or B7 cannot take is split unevenly at a group boundary
(:func:`split_bounds`), and its column-parallel partner the same way.
With autograd on (a tower that trains) the model group's collectives are
Megatron's differentiable pair (:meth:`Mesh.copy_to`,
:meth:`Mesh.reduce_from`); without it they run in place as in serving.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from ..ops.quant import (QuantizedWeight, dense_int4, dense_int8,
                         matmul_fp32)


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
    """``VLM_TPU_INT4_PREFILL``, validated as ``vlm_tpu`` validates it:
    ``dequant``, the default, is accepted and selects nothing (the port's
    int4 dispatch is ``ops.quant.dense_int4``'s, set on the H100);
    ``fused`` (the TPU's A/B knob, on ROADMAP's do-not-port list) is
    refused."""
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


class ShardComm:
    """What a sharded quantized product needs of the mesh: the global row
    count of its forwards (``row_ways`` data ranks share their rows: the
    mesh's ``data``, or 1 for rows that are the same on every data rank),
    the row abs-max over all of K (a row-parallel layer holds
    ``[k_lo, k_lo + K/model)``), the column maxima over every row and
    all of K (llm.int8's outlier choice) and the model group's outlier
    columns."""

    def __init__(self, mesh: Mesh, row_parallel: bool, k_lo: int,
                 row_ways: int, k_sizes=None):
        self.mesh = mesh
        self.row_parallel = row_parallel
        self.k_lo = k_lo
        self.row_ways = row_ways
        #: each model rank's inputs (a row-parallel layer's, uneven where
        #: :func:`split_bounds` split it so)
        self.k_sizes = k_sizes

    def row_max(self, absmax: torch.Tensor) -> torch.Tensor:
        if self.row_parallel:
            self.mesh.all_reduce(absmax, MODEL_AXIS, "max")
        return absmax

    def col_max(self, col: torch.Tensor) -> torch.Tensor:
        if self.row_ways > 1:
            self.mesh.all_reduce(col, DATA_AXIS, "max")
        if self.row_parallel:
            col = self.mesh.all_gather(col, MODEL_AXIS, 0, self.k_sizes)
        return col

    def outliers(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(t, MODEL_AXIS)


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
    (:func:`int4_group_size`); B7, or from 1,536 rows at K % 32 != 0 the
    dequantized product (``ops.quant.dense_int4``;
    ``VLM_TPU_INT4_PREFILL=dequant``, validated when built).

    ``shard`` names ``vlm_tpu``'s (in, out) mesh axes. With a ``mesh`` of
    ``model > 1`` a column-parallel layer holds ``out / model`` rows of
    each tensor (``gather=True``: its output is all-gathered over the
    model group) and a row-parallel one ``in / model`` columns (a
    quantized layer's part at :func:`split_bounds`, uneven where the even
    one is not a K its kernel takes), its int8
    ``scale`` whole, its int4 scales as groups of ``gcd(group, in /
    model)`` (the same weights when a group straddles two ranks); its
    partial products come out of their fp32 accumulators unrounded (B5
    and B7 write fp32) and are summed by one all-reduce in fp32, so the
    output is rounded once, as on one device. ``in_dim`` and ``out_dim``
    are the shard's; ``full_in``/``full_out`` the layer's.
    :meth:`shard_full` cuts a full tensor to this rank's. With
    ``model == 1`` no collective runs and the layer is what it is
    without a mesh, except that under any mesh the quantized dispatch
    counts the rows of every data rank, as ``vlm_tpu`` counts the global
    batch, unless ``forward(x, replicated=True)`` says that every data
    rank has the same rows."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True, *,
                 dtype=torch.float32, device=None, quant_bits: int = 0,
                 shard: Tuple[Optional[str], Optional[str]] = (None, None),
                 mesh: Optional[Mesh] = None, gather: bool = False):
        super().__init__()
        if quant_bits not in (0, 4, 8):
            raise ValueError(f"quant_bits must be 0, 4 or 8, got {quant_bits}")
        self.full_in, self.full_out = in_dim, out_dim
        self.mesh = mesh
        ways = mesh.model if mesh is not None else 1
        self.split = None
        #: the split dimension's boundaries, rank ``r`` holding
        #: ``[bounds[r], bounds[r + 1])`` (None: no split)
        self.bounds = None
        if ways > 1 and shard[1] == MODEL_AXIS:
            self.split = "col"
            self.bounds = split_bounds(out_dim, ways, quant_bits)
        elif ways > 1 and shard[0] == MODEL_AXIS:
            self.split = "row"
            self.bounds = split_bounds(in_dim, ways, quant_bits)
        if self.bounds is not None:
            lo, hi = self.bounds[mesh.model_rank:mesh.model_rank + 2]
            if self.split == "col":
                out_dim = hi - lo
            else:
                in_dim = hi - lo
        self.gather = gather and self.split == "col"
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
            self.full_group = int4_group_size(self.full_in)
            self.group_size = math.gcd(self.full_group, in_dim)
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
        # the quantized products' view of the mesh: rows split over the
        # data ranks, or (``forward(replicated=True)``) the same on each
        self.comm = self.comm_replicated = None
        if mesh is not None:
            row = self.split == "row"
            k_lo = self.bounds[mesh.model_rank] if row else 0
            sizes = [b - a for a, b in zip(self.bounds, self.bounds[1:])] \
                if row else None
            self.comm = ShardComm(mesh, row, k_lo, mesh.data, sizes)
            self.comm_replicated = ShardComm(mesh, row, k_lo, 1, sizes)

    def split_dim(self, leaf: str) -> Optional[int]:
        """The axis of tensor ``leaf`` that the mesh splits (None: whole on
        every rank)."""
        if self.split == "col":
            return 0
        if self.split == "row" and leaf in ("weight", "q") or \
                self.split == "row" and leaf == "scale" and \
                self.quant_bits == 4:
            return 1
        return None

    def shard_full(self, leaf: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``leaf``'s full tensor (a view where it is a
        slice)."""
        dim = self.split_dim(leaf)
        if dim is None:
            return full
        if leaf == "scale" and self.split == "row":
            # int4 group scales: local group j covers inputs lo + j * g,
            # which lie in full group (lo + j * g) // full_group
            g, lo = self.group_size, self.comm.k_lo
            idx = (lo + torch.arange(self.in_dim // g) * g) // \
                self.full_group
            return full.index_select(1, idx.to(full.device))
        lo, hi = self.bounds[self.mesh.model_rank:self.mesh.model_rank + 2]
        if leaf == "q" and self.quant_bits == 4 and dim == 1:
            lo, hi = lo // 2, hi // 2         # two inputs a byte
        return full.narrow(dim, lo, hi - lo)

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

    def _finish(self, y: torch.Tensor) -> torch.Tensor:
        """A row-parallel layer's fp32 partial products summed over the
        model group, then the bias as on one device: a float product takes
        it in fp32 before its one rounding, a quantized one after its
        rounding to the compute dtype."""
        y = self.mesh.all_reduce(y, MODEL_AXIS)
        if self.bias is None:
            return y.to(self.dtype)
        if self.quant_bits:
            y = y.to(self.dtype)
        return (y.float() + self.bias.float()).to(self.dtype)

    def forward(self, x: torch.Tensor,
                replicated: bool = False) -> torch.Tensor:
        row = self.split == "row"
        if not self.quant_bits:
            if row:
                return self._finish(matmul_fp32(x, self.weight))
            grad = self.split == "col" and torch.is_grad_enabled()
            if grad:
                x = self.mesh.copy_to(x, MODEL_AXIS)
            # bf16 operands, fp32 accumulate; the bias joins the fp32 sum
            # before the one rounding to the compute dtype.
            y = F.linear(x.to(self.weight.dtype), self.weight, self.bias)
            if not self.gather:
                return y
            return self.mesh.gather(y, MODEL_AXIS, -1) if grad else \
                self.mesh.all_gather(y, MODEL_AXIS, -1)
        x2 = x.reshape(-1, self.in_dim).to(self.dtype).contiguous()
        qw = QuantizedWeight(self.q, self.scale, self.group_size)
        out = torch.float32 if row else self.dtype
        comm = self.comm_replicated if replicated else self.comm
        y = dense_int4(x2, qw, out) if self.quant_bits == 4 \
            else dense_int8(x2, qw, self.int8_mode, out, comm)
        y = y.reshape(*x.shape[:-1], self.out_dim)
        if row:
            return self._finish(y)
        if self.bias is not None:
            # as vlm_tpu: the product rounds to the compute dtype first
            y = y.float() + self.bias.float()
        y = y.to(self.dtype)
        return self.mesh.all_gather(y, MODEL_AXIS, -1) if self.gather else y


def split_bounds(n: int, ways: int, quant_bits: int = 0) -> list:
    """Where ``n`` features split ``ways`` ways: ``ways + 1`` boundaries.
    Even, unless a quantized layer's even part is one that B5 and B6 (a
    multiple of 16) or B7 (int4 groups of at least 16, whole or cut into
    whole smaller ones) cannot take: then each boundary is rounded down
    to a multiple of 16 (int8) or of ``max(16, group)`` (int4, so the
    groups stay whole), the last rank taking the rest (SigLIP's MLP width
    4304 over two ranks: 2144 and 2160). A row-parallel layer and its
    column-parallel partner (fc2 and fc1) split their shared width alike,
    both calling this with it. Raises for a float layer that does not
    split evenly."""
    if quant_bits == 0:
        per = shard_size(n, ways, "features")
        return [r * per for r in range(ways + 1)]
    per = n // ways
    if quant_bits == 8:
        even = n % ways == 0 and per % 16 == 0
        align = 16
    else:
        group = int4_group_size(n)
        even = n % ways == 0 and per % 2 == 0 and \
            math.gcd(group, per) >= min(group, 16)
        align = max(16, group)
    if even:
        return [r * per for r in range(ways + 1)]
    bounds = [(r * n // ways) // align * align for r in range(ways)] + [n]
    if any(b <= a for a, b in zip(bounds, bounds[1:])):
        raise ValueError(f"{n} quantized features do not split {ways} ways "
                         f"at multiples of {align}")
    return bounds


def shard_size(n: int, ways: int, what: str) -> int:
    """``n`` split ``ways`` ways; raises unless it splits evenly."""
    if n % ways:
        raise ValueError(f"{n} {what} do not split {ways} ways")
    return n // ways


def init_random_(module: nn.Module, seed: int,
                 full: Optional[nn.Module] = None) -> nn.Module:
    """Random weights, drawn in place on the module's own device from one
    seeded generator (a full-size model never passes through host memory).
    Every submodule with ``reset_parameters(gen)`` initialises itself.

    With ``full``, the same model unsharded on ``meta``, a module sharded
    over a mesh draws each submodule's full tensors in turn on its device
    and keeps its shard (:meth:`Dense.shard_full`): the weights of the
    unsharded model drawn from the same seed, one submodule's tensors at a
    time on the device beside the shards."""
    device = next(module.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.no_grad():
        if full is None:
            for m in module.modules():
                if hasattr(m, "reset_parameters"):
                    m.reset_parameters(gen)
            return module
        fulls = dict(full.named_modules())
        for name, m in module.named_modules():
            if not hasattr(m, "reset_parameters"):
                continue
            f = fulls[name].to_empty(device=device, recurse=False)
            f.reset_parameters(gen)
            for leaf, p in m.named_parameters(recurse=False):
                src = getattr(f, leaf)
                p.copy_(m.shard_full(leaf, src) if hasattr(m, "shard_full")
                        else src)
            f.to_empty(device="meta", recurse=False)
    return module
