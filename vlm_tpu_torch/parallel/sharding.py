"""Parameter and batch placement over the ``(data, model)`` mesh
(``vlm_tpu/parallel/sharding.py``).

``vlm_tpu`` annotates each kernel with logical axes and lets GSPMD place
it. The port builds each rank's module at its shard's shapes
(:class:`~vlm_tpu_torch.models.layers.Dense`'s ``shard``, the
vocabulary-parallel ``Embed``) and fills it from a full state a tensor at a
time: every sharded module cuts a full tensor to its rank's part
(``shard_full``), so a rank never holds the whole model on its device.

A batch is split over the data axis by :func:`shard_batch` (this data
rank's rows of every leaf) or :func:`shard_batch_if_divisible` (a leaf
whose rows do not split stays whole, as ``vlm_tpu`` leaves a ragged tail
replicated). A tree is tuples and dicts of leaves; a leaf is a tensor, an
array or a list (a batch of rows, e.g. PIL images).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from ..core.mesh import Mesh


def _tree_map(fn, tree):
    if isinstance(tree, tuple):
        return type(tree)(*(_tree_map(fn, t) for t in tree)) \
            if hasattr(tree, "_fields") else \
            tuple(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _rows(x) -> Optional[int]:
    if isinstance(x, list):
        return len(x)
    shape = getattr(x, "shape", None)
    return int(shape[0]) if shape is not None and len(shape) else None


def shard_batch(tree: Any, mesh: Mesh) -> Any:
    """This data rank's rows of every leaf (a leaf without rows as it is);
    raises where a leaf's rows do not split over ``data``."""
    def place(x):
        n = _rows(x)
        return x if n is None else x[mesh.rows(n)]
    return _tree_map(place, tree)


def shard_batch_if_divisible(tree: Any, mesh: Optional[Mesh]) -> Any:
    """:func:`shard_batch` leaf by leaf: a leaf whose rows do not split
    over ``data`` (a ragged tail) stays whole; ``mesh=None`` is a
    no-op."""
    if mesh is None:
        return tree

    def place(x):
        n = _rows(x)
        return x if n is None or n % mesh.data else x[mesh.rows(n)]
    return _tree_map(place, tree)


def _owner(module: nn.Module, name: str):
    mod, _, leaf = name.rpartition(".")
    return (module.get_submodule(mod) if mod else module), leaf


def param_specs(module: nn.Module) -> Dict[str, Optional[int]]:
    """Each parameter's split axis in the port's layout (``[out, in]``
    Dense tensors, ``[vocab, hidden]`` tables), or None where every rank
    holds it whole."""
    out = {}
    for name, _ in module.named_parameters():
        owner, leaf = _owner(module, name)
        split = getattr(owner, "split_dim", None)
        out[name] = split(leaf) if split is not None else None
    return out


def shard_tensor(module: nn.Module, name: str,
                 full: torch.Tensor) -> torch.Tensor:
    """Parameter ``name``'s part of its full tensor on this rank (the
    tensor itself where it is whole)."""
    owner, leaf = _owner(module, name)
    cut = getattr(owner, "shard_full", None)
    return cut(leaf, full) if cut is not None else full


def shard_state_dict(full_sd: Mapping[str, torch.Tensor],
                     module: nn.Module) -> Dict[str, torch.Tensor]:
    """The rank's slice of a full state dict for ``module`` (built at the
    rank's shard): float kernels and biases, int8 ``q`` with its per-output
    ``scale``, packed int4 ``q`` with its group scales. Raises if a name is
    missing or a part's shape is not the module's."""
    own = module.state_dict()
    missing = sorted(set(own) - set(full_sd))
    if missing:
        raise KeyError(f"the full state lacks {missing[:10]}")
    out = {}
    for name, t in own.items():
        part = shard_tensor(module, name, full_sd[name])
        if tuple(part.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shard {tuple(part.shape)}, module "
                             f"{tuple(t.shape)}")
        out[name] = part
    return out


def assert_params_sharded(module: nn.Module, mesh: Mesh) -> None:
    """Guard against a mesh knob that did nothing: every parameter on the
    mesh's device, and with ``model > 1`` at least one parameter split."""
    specs = param_specs(module)
    for name, p in module.named_parameters():
        if p.device != mesh.device:
            raise AssertionError(f"{name} on {p.device}, the mesh's rank "
                                 f"on {mesh.device}")
    if mesh.model > 1 and not any(d is not None for d in specs.values()):
        raise AssertionError("the mesh has a model axis > 1 but no "
                             "parameter is split")
