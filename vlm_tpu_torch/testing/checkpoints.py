"""Synthetic HF checkpoints: the key set, shapes and dtypes of a real one
(a manifest such as ``tests/goldens/manifests/*.json``: name ->
``{"shape": [...], "dtype": "float32"}``) with values drawn from a seed,
written as shards through the port's safetensors writer
(:mod:`..utils.safetensors_io`).

Values are drawn in fp32 on ``device`` and stored in the manifest's dtype.
None sits at an init constant: conv kernels and matrices are lecun-normal,
biases and tables (token, position, class, query) N(0, 0.02), and other
vectors (the norms' weights) 1 + N(0, 0.1).
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Mapping

import torch

from ..utils.safetensors_io import save_file

_LAYER = re.compile(r"\.layers\.(\d+)\.")


def depth_cut(manifest: Mapping[str, dict], layers: int) -> dict:
    """The manifest without the tower's and decoder's layers from
    ``layers`` on (names with ``.layers.<i>.``; BLIP-2's Q-Former, under
    ``.layer.<i>.``, stays whole)."""
    return {k: v for k, v in manifest.items()
            if not (m := _LAYER.search(k)) or int(m.group(1)) < layers}


def synthetic_value(name: str, shape, gen: torch.Generator,
                    device) -> torch.Tensor:
    """One fp32 tensor for checkpoint key ``name`` (rules above)."""
    x = torch.randn(tuple(shape), generator=gen, device=device)
    if len(shape) == 4:                                # a conv kernel
        return x.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
    if name.endswith(".bias") or "embed" in name or "query_tokens" in name:
        return x.mul_(0.02)
    if len(shape) == 1:                                # a norm's weight
        return x.mul_(0.1).add_(1.0)
    return x.mul_(1.0 / math.sqrt(shape[-1]))


def write_synthetic_checkpoint(manifest: Mapping[str, dict], path, *,
                               shards: int = 3, seed: int = 0,
                               device="cpu") -> int:
    """Write ``manifest``'s tensors, drawn in name order from ``seed`` on
    ``device``, into ``shards`` files of about equal size
    (``model-0000<i>-of-0000<n>.safetensors``); returns the bytes of
    tensor data written. One shard's tensors are on the device at a
    time."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    names = sorted(manifest)
    sizes = [math.prod(manifest[k]["shape"]) *
             getattr(torch, manifest[k]["dtype"]).itemsize for k in names]
    total = sum(sizes)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    groups, acc = [[] for _ in range(shards)], 0
    for name, size in zip(names, sizes):
        groups[min(shards - 1, acc * shards // max(total, 1))].append(name)
        acc += size
    for i, group in enumerate(groups):
        tensors = {k: synthetic_value(k, manifest[k]["shape"], gen, device).to(
            getattr(torch, manifest[k]["dtype"])) for k in group}
        save_file(tensors, path / f"model-{i + 1:05d}-of-{shards:05d}"
                                  f".safetensors")
        del tensors
    return total
