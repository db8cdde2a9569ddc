"""Ranks that stay up across mesh runs: one ``torchrun`` launch, one
process group, then the runs one after another.

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m vlm_tpu_torch.testing.mesh_pool QUEUE_DIR DEVICE

The ranks form their group on ``DEVICE`` (``cuda`` or ``cpu``) and
import the workers as soon as they start, so a caller that starts them
early pays for that while it does other work. The caller writes
``QUEUE_DIR/run<i>.json`` for i = 0, 1, ... in turn, each ``{"worker":
"mesh_serve" | "mesh_probe", "spec": {...}, "out": OUT_DIR}``. Every
rank runs that worker's ``run(spec, OUT_DIR)`` (each rank writes
``OUT_DIR/rank<r>.json``), waits for its peers, and rank 0 then writes
``QUEUE_DIR/done<i>``. ``QUEUE_DIR/stop`` ends the ranks once the runs
before it are done. Between runs each rank frees what the run built and
restores its environment variables, so a run sees what a fresh launch
would, less the process start, the imports and the group's set-up, which
a launch pays once.

:class:`MeshPool` is the caller's side: it starts the launch, hands it
runs, and kills every process of it when a run fails, hangs or passes its
time limit. Imports nothing of ``vlm_tpu`` or JAX.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

POLL_S = 0.05
#: the modules whose ``run(spec, out)`` the ranks take
WORKERS = ("mesh_serve", "mesh_probe")


def _write(path: Path, text: str) -> None:
    """``text`` into ``path`` at once: a reader never sees part of it."""
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def main(argv=None) -> int:
    import torch
    import torch.distributed as dist

    from vlm_tpu_torch.parallel.distributed import initialize_distributed
    argv = sys.argv[1:] if argv is None else argv
    queue = Path(argv[0])
    initialize_distributed(device=argv[1])
    workers = {name: importlib.import_module(f"vlm_tpu_torch.testing.{name}")
               for name in WORKERS}
    importlib.import_module("vlm_tpu_torch.models.factory")
    i = 0
    while True:
        job = queue / f"run{i}.json"
        while not job.exists() and not (queue / "stop").exists():
            time.sleep(POLL_S)
        if not job.exists():
            break
        run = json.loads(job.read_text())
        env = dict(os.environ)
        workers[run["worker"]].run(run["spec"], Path(run["out"]))
        os.environ.clear()
        os.environ.update(env)
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
        if dist.get_rank() == 0:
            _write(queue / f"done{i}", "")
        i += 1
    dist.barrier()
    dist.destroy_process_group()
    return 0


class MeshPool:
    """``n`` (two or more) ranks under one ``torchrun`` launch, started here,
    that run what :meth:`run` hands them, their group formed on
    ``device`` at their start. A run that fails on any rank, or passes
    ``timeout`` seconds, kills every process of the launch and raises
    ``RuntimeError`` with the end of its log; so does a pool that ends
    before it is closed."""

    def __init__(self, n: int, queue: Path, timeout: float, device: str,
                 env: Optional[dict] = None):
        self.n, self.queue, self.timeout = n, Path(queue), timeout
        self.queue.mkdir(parents=True, exist_ok=True)
        self.log_path = self.queue / "log.txt"
        self._log = open(self.log_path, "w")
        self._next = 0
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(n), "-m",
             "vlm_tpu_torch.testing.mesh_pool", str(self.queue), device],
            cwd=str(Path(__file__).resolve().parents[2]),
            stdout=self._log, stderr=subprocess.STDOUT,
            start_new_session=True, env=env)

    def log(self) -> str:
        if not self._log.closed:
            self._log.flush()
        return self.log_path.read_text(errors="replace")

    def _fail(self, why: str):
        self.kill()
        log = self.log()
        first = log.find("Traceback")
        raise RuntimeError(f"{why}:\n"
                           + (log[first:first + 6000] if first >= 0 else "")
                           + log[-4000:])

    def run(self, worker: str, spec: dict, out: Path) -> List[dict]:
        """``spec`` through ``vlm_tpu_torch.testing.<worker>`` on every
        rank; their records, by rank."""
        i, self._next = self._next, self._next + 1
        out = Path(out)
        _write(self.queue / f"run{i}.json", json.dumps(
            {"worker": worker, "spec": spec, "out": str(out)}))
        end = time.monotonic() + self.timeout
        while not (self.queue / f"done{i}").exists():
            if self.proc.poll() is not None:
                self._fail(f"the mesh ranks ended ({self.proc.returncode}) "
                           f"in run {i} ({worker})")
            if time.monotonic() > end:
                self._fail(f"mesh run {i} ({worker}) passed "
                           f"{self.timeout:.0f} s")
            time.sleep(POLL_S)
        return [json.loads((out / f"rank{r}.json").read_text())
                for r in range(self.n)]

    def close(self, timeout: float = 60.0) -> None:
        """Let the ranks end after the runs handed to them; kill them if
        they do not within ``timeout`` seconds."""
        if self.proc.poll() is None:
            _write(self.queue / "stop", "")
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                pass
        self.kill()

    def kill(self) -> None:
        """Kill every process of the launch that is still running."""
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()
        self._log.close()


if __name__ == "__main__":
    sys.exit(main())
