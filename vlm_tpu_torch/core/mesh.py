"""The ``(data, model)`` mesh (``vlm_tpu/core/mesh.py``) over
``torch.distributed``.

One process a rank, launched by ``torchrun``; rank ``r`` sits at
``(data_rank, model_rank) = divmod(r, model)``, as ``vlm_tpu`` lays its
devices out (``reshape(data, model)``). The ``model`` axis is Megatron
tensor parallelism: the ranks of one model group hold slices of the same
weights and meet in an all-reduce after each row-parallel product. The
``data`` axis splits the rows (decode slots, a wave's images) over the
data groups.

Under autograd (training a probe's tower) the collectives are
differentiable (:meth:`Mesh.sum`, :meth:`Mesh.copy_to`,
:meth:`Mesh.reduce_from`, :meth:`Mesh.gather`); without it the in-place
:meth:`Mesh.all_reduce` and :meth:`Mesh.all_gather` serve.

:func:`mesh_from_config` reads the config surface's ``mesh: {data,
model}`` block. It refuses what ``vlm_tpu``'s refuses, with the devices
counted as the process group's ranks (``torch.cuda.device_count()``
without one), gives ``None`` for a 1 x 1 mesh (the single-device path, no
collective), and otherwise a :class:`Mesh`. Unlike ``vlm_tpu``, whose mesh
may cover some of the devices, the port needs a process group of exactly
``data x model`` ranks, and names the ``torchrun`` line otherwise.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Optional

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


def device_count() -> int:
    """The devices a mesh can span without a process group: the CUDA
    devices, or the CPU as one."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def world_size() -> Optional[int]:
    """The process group's ranks, or None without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return None


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class Mesh:
    """A ``data x model`` mesh: this rank's place on it, its two process
    groups and its device.

    Without groups (``groups=False``) it is a layout only: the shapes of
    rank ``(data_rank, model_rank)``'s shards, for building a module on
    ``meta`` or slicing a state; its collectives must not be called.
    ``counts`` records each collective's launches and bytes by kind and
    axis.
    """

    def __init__(self, data: int, model: int, *, data_rank: int = 0,
                 model_rank: int = 0, device=None, backend: str = "",
                 groups: bool = True):
        self.data, self.model = int(data), int(model)
        self.data_rank, self.model_rank = int(data_rank), int(model_rank)
        self.device = torch.device(device) if device is not None else \
            torch.device("cpu")
        self.backend = backend
        self.counts: Counter = Counter()
        self._groups = {}
        self._host = None
        if groups:
            import torch.distributed as dist
            rank = dist.get_rank()
            self.data_rank, self.model_rank = divmod(rank, self.model)
            # every rank creates every group, in the same order
            for d in range(self.data):
                ranks = [d * self.model + m for m in range(self.model)]
                g = dist.new_group(ranks)
                if d == self.data_rank:
                    self._groups[MODEL_AXIS] = g
            for m in range(self.model):
                ranks = [d * self.model + m for d in range(self.data)]
                g = dist.new_group(ranks)
                if m == self.model_rank:
                    self._groups[DATA_AXIS] = g
            # host decisions meet over gloo on CPU tensors (the world group
            # where it is gloo already), so their reads never wait for the
            # device's stream
            self._host = None if dist.get_backend() == "gloo" else \
                dist.new_group(backend="gloo")

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def rank(self) -> int:
        return self.data_rank * self.model + self.model_rank

    def ways(self, axis: str) -> int:
        return self.data if axis == DATA_AXIS else self.model

    def rows(self, n: int) -> slice:
        """This data rank's rows of ``n`` (a multiple of ``data``)."""
        if n % self.data:
            raise ValueError(f"{n} rows do not split over data={self.data}")
        per = n // self.data
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def _count(self, kind: str, axis: str, t: torch.Tensor) -> None:
        self.counts[f"{kind}_{axis}"] += 1
        self.counts[f"{kind}_{axis}_bytes"] += t.numel() * t.element_size()

    def all_reduce(self, t: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """``t`` reduced over ``axis``'s group, in place (``op``: sum or
        max); returned for chaining."""
        import torch.distributed as dist
        if self.ways(axis) == 1:
            return t
        self._count("all_reduce", axis, t)
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self._groups[axis])
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0,
                   sizes=None) -> torch.Tensor:
        """The ranks' ``t`` along ``axis``, concatenated on ``dim`` in rank
        order. ``sizes``: each rank's length on ``dim`` where they differ
        (an uneven split): the parts travel padded to the longest."""
        import torch.distributed as dist
        n = self.ways(axis)
        if n == 1:
            return t
        if sizes is not None:
            pad = max(sizes) - t.shape[dim]
            if pad:
                shape = list(t.shape)
                shape[dim] = pad
                t = torch.cat([t, t.new_zeros(shape)], dim)
        t = t.contiguous()
        self._count("all_gather", axis, t)
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=self._groups[axis])
        if sizes is not None:
            parts = [p.narrow(dim, 0, k) for p, k in zip(parts, sizes)]
        return torch.cat(parts, dim=dim)

    # ---- differentiable collectives (autograd), one node each ----
    def sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t`` summed over ``axis`` (a new tensor); its backward sums
        the gradient over the same axis: the data axis's batch statistics
        and loss sums, each rank's gradient standing for its own rows."""
        return t if self.ways(axis) == 1 else _Sum.apply(t, self, axis)

    def copy_to(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Megatron's copy into a column-parallel layer: the identity, its
        backward an all-reduce over ``axis`` (each rank's input gradient
        covers only its columns)."""
        return t if self.ways(axis) == 1 else _CopyTo.apply(t, self, axis)

    def reduce_from(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Megatron's reduction after a row-parallel layer: an all-reduce
        (a new tensor), its backward the identity."""
        return t if self.ways(axis) == 1 else \
            _ReduceFrom.apply(t, self, axis)

    def gather(self, t: torch.Tensor, axis: str,
               dim: int = 0) -> torch.Tensor:
        """:meth:`all_gather` whose backward takes this rank's slice of the
        gradient."""
        return t if self.ways(axis) == 1 else \
            _Gather.apply(t, self, axis, dim)

    def axis_rank(self, axis: str) -> int:
        return self.data_rank if axis == DATA_AXIS else self.model_rank

    def barrier(self) -> None:
        """Every rank of the mesh meets here (over gloo, on the host)."""
        import torch.distributed as dist
        self.counts["barrier"] += 1
        dist.barrier(group=self._host)

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank, for host decisions every
        rank must share: one all-reduce of a CPU tensor over gloo and its
        read, which waits for the peers but not for the device."""
        import torch.distributed as dist
        t = torch.tensor([1 if flag else 0], dtype=torch.int32)
        self.counts["all_reduce_host"] += 1
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._host)
        return bool(t.item())

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, rank "
                f"({self.data_rank}, {self.model_rank}), {self.device}, "
                f"{self.backend or 'no groups'})")


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce(t.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.axis), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        return mesh.all_reduce(t.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.rank, ctx.size, ctx.dim = mesh.axis_rank(axis), t.shape[dim], dim
        return mesh.all_gather(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None, \
            None


#: the module each entry point runs as under ``torchrun``
SCRIPTS = {"prompt_inference": "vlm_tpu_torch.scripts.prompt_inference",
           "train_probe": "vlm_tpu_torch.scripts.train_probe",
           "test_probe": "vlm_tpu_torch.scripts.test_probe"}


def torchrun_line(n: int, script: str = "prompt_inference") -> str:
    return (f"torchrun --nproc_per_node {n} -m {SCRIPTS[script]} "
            f"--config <yaml>")


_MESHES: dict = {}


def make_mesh(data: int, model: int, device=None) -> Mesh:
    """The mesh over the process group, which must hold ``data x model``
    ranks (:func:`~vlm_tpu_torch.parallel.distributed.initialize_distributed`
    forms it and picks this rank's device). A process forms each shape's
    groups once: asking again returns the same :class:`Mesh`."""
    from ..parallel.distributed import initialize_distributed
    info = initialize_distributed(device=device)
    n = world_size()
    if info is None or n != data * model:
        raise ValueError(
            f"a {data}x{model} mesh needs a process group of {data * model}"
            f" ranks (have {n or 'none'}): launch one process a rank with "
            f"`{torchrun_line(data * model)}`")
    backend, dev = info
    if (data, model) not in _MESHES:
        _MESHES[(data, model)] = Mesh(data, model, device=dev,
                                      backend=backend)
    return _MESHES[(data, model)]


def _resolve(spec):
    """``(data, model)`` of a config block, refused as ``vlm_tpu``
    refuses it, over the process group's ranks (or the devices without
    one); None for no block."""
    if spec is None:
        return None
    if not isinstance(spec, dict):
        raise TypeError(f"mesh config must be a dict, got {spec!r}")
    unknown = set(spec) - {"data", "model"}
    if unknown:
        raise ValueError(f"unknown mesh config key(s) {sorted(unknown)}; "
                         "expected only 'data' and 'model'")
    data = int(spec["data"]) if spec.get("data") is not None else -1
    model = int(spec["model"]) if spec.get("model") is not None else 1
    ws = world_size()
    n = ws if ws is not None else device_count()
    if model < 1:
        raise ValueError(f"mesh.model must be >= 1, got {model}")
    if data == -1:
        data = max(1, n // model)
    if data < 1:
        raise ValueError(f"mesh.data must be >= 1 (or -1 for all remaining "
                         f"devices), got {data}")
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, "
                         f"have {n}")
    return data, model


def mesh_from_config(spec, device=None,
                     script: str = "prompt_inference") -> Optional[Mesh]:
    """``None`` for no block or one that resolves to 1 x 1; else the
    :class:`Mesh` over the process group.

    Accepts ``None``, a :class:`Mesh` (passed through; ``None`` if it is
    1 x 1) or a dict with ``data`` (``-1``, the default: all remaining
    devices) and ``model`` (tensor-parallel ways, default 1). Raises
    ``TypeError`` for anything else and ``ValueError`` for an unknown key,
    ``model < 1``, ``data < 1`` other than -1, ``data x model`` beyond the
    devices, or a mesh of more than one device without a process group of
    exactly ``data x model`` ranks (the message gives the ``torchrun``
    line of ``script``, a key of :data:`SCRIPTS`). Under ``torchrun``
    (``WORLD_SIZE`` set) the process group is formed here if no one has
    formed it, on ``device`` when given."""
    if isinstance(spec, Mesh):
        return spec if spec.size > 1 else None
    if spec is not None and world_size() is None and \
            int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from ..parallel.distributed import initialize_distributed
        initialize_distributed(device=device)
    shape = _resolve(spec)
    if shape is None or shape[0] * shape[1] == 1:
        return None
    data, model = shape
    ws = world_size()
    if ws != data * model:
        raise ValueError(
            f"a {data}x{model} mesh needs a process group of exactly "
            f"{data * model} ranks (have {ws or 'none'}; the port does not "
            f"run a mesh over some of the ranks): launch one process a rank "
            f"with `{torchrun_line(data * model, script)}`")
    return make_mesh(data, model, device=device)
