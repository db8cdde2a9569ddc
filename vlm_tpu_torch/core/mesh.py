"""The config surface's ``mesh: {data, model}`` block, checked as
``vlm_tpu.core.mesh.mesh_from_config`` checks it.

The port runs on one device: a block that resolves to a 1 x 1 mesh gives
``None`` (the single-device path), a larger one raises
``NotImplementedError`` (data and tensor parallelism are ROADMAP A17), and
a block that ``vlm_tpu`` would refuse raises what it raises, so a typo'd
key or a mesh larger than the host's devices is never run on one device
without a word. Devices are ``torch.cuda.device_count()``, 1 on a host
without CUDA.
"""

from __future__ import annotations

from typing import Optional

import torch


def device_count() -> int:
    """The devices a mesh can span: the CUDA devices, or the CPU as one."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def mesh_from_config(spec) -> Optional[dict]:
    """``None`` for no block or one that resolves to 1 x 1; else raises.

    Accepts ``None`` or a dict with ``data`` (``-1``, the default: all
    remaining devices) and ``model`` (tensor-parallel ways, default 1).
    Raises ``TypeError`` for anything else, ``ValueError`` for an unknown
    key, ``model < 1``, ``data < 1`` other than -1, or ``data x model``
    beyond the devices, and ``NotImplementedError`` for a mesh of more
    than one device."""
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
    n = device_count()
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
    if data * model == 1:
        return None
    raise NotImplementedError(
        f"a {data}x{model} mesh: data and tensor parallelism are not ported "
        f"yet (ROADMAP A17); the port runs on one device")
