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

Without ``torchrun`` (several hosts, another launcher) the caller names
the group as ``vlm_tpu``'s ``initialize_multihost`` does:
``coordinator_address`` (``host:port`` of rank 0), ``num_processes`` and
``process_id``, mapped to the variables ``torchrun`` would set. A
multi-process request that cannot form its group raises; it never falls
back to one process. :func:`process_local_slice` gives a rank its rows of
a batch, so that each decodes only its own.
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


def _explicit_env(coordinator_address: Optional[str],
                  num_processes: Optional[int],
                  process_id: Optional[int]) -> None:
    """``initialize_multihost``'s arguments as ``torchrun``'s variables
    (the ones given win over the environment)."""
    env = os.environ
    if coordinator_address is not None:
        host, _, port = str(coordinator_address).rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"coordinator_address {coordinator_address!r}:"
                             f" expected host:port")
        env["MASTER_ADDR"], env["MASTER_PORT"] = host, port
    if num_processes is not None:
        env["WORLD_SIZE"] = str(int(num_processes))
        env.setdefault("LOCAL_WORLD_SIZE", str(int(num_processes)))
    if process_id is not None:
        env["RANK"] = str(int(process_id))
        env.setdefault("LOCAL_RANK", str(int(process_id)))
    if int(env.get("WORLD_SIZE", "1")) > 1:
        missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT")
                   if k not in env]
        if missing:
            raise ValueError(
                f"a group of {env['WORLD_SIZE']} processes needs "
                f"{' and '.join(missing)}: give coordinator_address and "
                f"process_id, or launch under torchrun")


def initialize_distributed(device=None,
                           coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None
                           ) -> Optional[Tuple[str, torch.device]]:
    """Form the process group once from ``torchrun``'s environment, or
    from the explicit ``coordinator_address`` / ``num_processes`` /
    ``process_id``, with :data:`TIMEOUT_S` on every collective; returns
    ``(backend, device)`` of this rank, or None for a single process (no
    group). A group of more than one process that cannot form (a peer
    missing past the timeout) raises."""
    import torch.distributed as dist
    if not dist.is_initialized():
        _explicit_env(coordinator_address, num_processes, process_id)
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



def process_local_slice(global_batch: int, mesh=None) -> Tuple[int, int]:
    """``(start, size)`` of this rank's rows of a batch split over the data
    axis: the data rank's (the ranks of one model group share their rows)
    with a mesh, the process's own in a group without one, else the whole
    batch. Raises unless the batch splits evenly."""
    import torch.distributed as dist
    if mesh is not None:
        n, i = mesh.data, mesh.data_rank
    elif dist.is_available() and dist.is_initialized():
        n, i = dist.get_world_size(), dist.get_rank()
    else:
        n, i = 1, 0
    if global_batch % n:
        raise ValueError(f"a batch of {global_batch} does not split over "
                         f"{n} ranks")
    per = global_batch // n
    return i * per, per
