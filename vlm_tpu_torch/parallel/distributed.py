"""The process group (``vlm_tpu/parallel/distributed.py``).

``vlm_tpu`` runs one controller over every chip; the port runs one process
a rank, launched by ``torchrun`` (``python -m torch.distributed.run``),
which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``. :func:`initialize_distributed` forms
the group from them:

- NCCL when every rank of the host has a CUDA device of its own;
- gloo on the CPU (``VLM_TPU_PLATFORM=cpu`` or ``device="cpu"``), and when
  ranks share a GPU (rank ``i`` takes device ``i mod count``): NCCL refuses
  two ranks on one device, gloo takes CUDA tensors for its collectives.
  Its collectives copy through host memory and block the host, so a gloo
  run checks the sharded model, not its speed.

The choice and the device are printed on a ``[mesh]`` line. A rank that
finds no GPU raises unless it was asked for the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch

#: seconds a collective may wait for its peers before the rank raises
#: (a deadlocked mesh fails instead of hanging)
TIMEOUT_S = float(os.environ.get("VLM_TPU_DIST_TIMEOUT", "600"))

_STATE: dict = {}


def _choose(device, local_rank: int, local_world: int
            ) -> Tuple[str, torch.device]:
    if device is not None:
        device = torch.device(device)
    elif os.environ.get("VLM_TPU_PLATFORM", "").lower() == "cpu":
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device on this rank: pass device='cpu' or set "
            "VLM_TPU_PLATFORM=cpu to run the mesh on the CPU")
    else:
        device = torch.device("cuda")
    if device.type != "cuda":
        return "gloo", torch.device("cpu")
    count = torch.cuda.device_count()
    dev = torch.device("cuda", local_rank % count)
    return ("nccl" if local_world <= count else "gloo"), dev


def initialize_distributed(device=None
                           ) -> Optional[Tuple[str, torch.device]]:
    """Form the process group once from ``torchrun``'s environment, with
    :data:`TIMEOUT_S` on every collective; returns ``(backend, device)``
    of this rank, or None for a single process (no group)."""
    import torch.distributed as dist
    env = os.environ
    if dist.is_initialized():
        if "info" not in _STATE:      # formed by the caller
            dev = _choose(device, int(env.get("LOCAL_RANK", dist.get_rank())),
                          int(env.get("LOCAL_WORLD_SIZE",
                                      dist.get_world_size())))[1]
            _STATE["info"] = (dist.get_backend(), dev)
        return _STATE["info"]
    n = int(env.get("WORLD_SIZE", "1"))
    if n <= 1:
        return None
    rank = int(env["RANK"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", n))
    backend, dev = _choose(device, local_rank, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if dev.type == "cuda":
        share = (f", {local_world} ranks on {torch.cuda.device_count()} "
                 f"GPU(s): gloo (NCCL refuses two ranks on one GPU)"
                 if backend == "gloo" else ", one GPU a rank")
    else:
        share = ", the CPU"
    print(f"[mesh] rank {rank}/{n}: backend {backend}, device {dev}{share}",
          flush=True)
    _STATE["info"] = (backend, dev)
    return _STATE["info"]

