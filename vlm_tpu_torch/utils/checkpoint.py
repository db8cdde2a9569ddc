"""The port's own model checkpoint (the counterpart of
``vlm_tpu/utils/checkpoint.py``, which writes flax msgpack, a format the
port does not read).

A checkpoint is a directory holding ``params.safetensors``, the module's
``state_dict`` as it is (int8 ``q`` and fp32 ``scale`` of quantized layers
included), written by :mod:`.safetensors_io`, and ``config.yaml`` with
``vlm_tpu``'s metadata keys (``family``, ``quantization``,
``vision_layers``, ``decoder_layers``) and ``format: vlm_tpu_torch``,
which marks the port's format.
``VLMModel(model_id=<dir>)`` loads it back (``models/base_model.py``),
a module built at a rank's shard of a mesh taking its part of each tensor
(sliced on the host, then moved).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping

import torch

from .safetensors_io import open_file, save_file

FORMAT = "vlm_tpu_torch"
WEIGHTS = "params.safetensors"


def save_vlm_checkpoint(path, module: torch.nn.Module,
                        meta: Mapping[str, Any]) -> None:
    """Write ``module``'s state and ``meta`` into directory ``path``."""
    import yaml
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    save_file(module.state_dict(), path / WEIGHTS)
    (path / "config.yaml").write_text(
        yaml.safe_dump({**meta, "format": FORMAT}, sort_keys=False),
        encoding="utf-8")


def checkpoint_meta(path) -> Dict[str, Any]:
    """The directory's ``config.yaml`` (empty without one)."""
    p = Path(path) / "config.yaml"
    if not p.exists():
        return {}
    import yaml
    return yaml.safe_load(p.read_text(encoding="utf-8")) or {}


def is_vlm_checkpoint(path) -> bool:
    """Whether directory ``path`` holds a checkpoint in the port's format."""
    return (Path(path) / WEIGHTS).exists() and \
        checkpoint_meta(path).get("format") == FORMAT


def load_vlm_checkpoint(path, module: torch.nn.Module,
                        meta: Mapping[str, Any]) -> torch.nn.Module:
    """Fill ``module`` in place from the checkpoint in ``path``, a tensor
    at a time on the module's device. Raises if the checkpoint's metadata
    differs from ``meta`` (the model's), naming both sides, or if a tensor
    is missing, extra, or of another shape or dtype."""
    path = Path(path)
    have = checkpoint_meta(path)
    diff = [f"{k}: checkpoint {have.get(k)!r}, model {v!r}"
            for k, v in meta.items() if have.get(k) != v]
    if diff:
        raise ValueError(f"checkpoint {path} does not match the model: "
                         f"{'; '.join(diff)}")
    refs = open_file(path / WEIGHTS)
    own = module.state_dict()
    missing, extra = sorted(set(own) - set(refs)), sorted(set(refs) - set(own))
    if missing or extra:
        raise ValueError(f"checkpoint {path}: missing {missing[:10]}, "
                         f"unexpected {extra[:10]}")
    from ..parallel.sharding import shard_tensor
    with torch.no_grad():
        for name, t in own.items():
            src = shard_tensor(module, name, refs[name].load())
            if src.shape != t.shape or src.dtype != t.dtype:
                raise ValueError(f"checkpoint {path}: {name} is "
                                 f"{src.dtype} {tuple(src.shape)}, the model "
                                 f"has {t.dtype} {tuple(t.shape)}")
            t.copy_(src.to(t.device))
    return module
