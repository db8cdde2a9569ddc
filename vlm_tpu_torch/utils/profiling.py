"""Throughput meter and ``torch.profiler`` traces for the CLI (the port's
copy of ``vlm_tpu/utils/profiling.py``): a wall-clock images/s meter whose
first update is left out of the steady rate (on the card that update holds
the kernels' build and first launches), a trace context that writes a
Chrome trace of the host and the device, and named ranges in it."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Optional


class ThroughputMeter:
    """Wall-clock items/s with the first update excluded from the steady
    rate."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._count = 0
        self._t0: Optional[float] = None
        self._first_done = False
        self._total_count = 0
        self._wall_t0 = time.perf_counter()

    def update(self, n: int):
        now = time.perf_counter()
        self._total_count += n
        if not self._first_done:
            # the first batch holds the build and first launches
            self._first_done = True
            self._t0 = now
            return
        self._count += n

    @property
    def items_per_sec(self) -> float:
        if self._t0 is None or self._count == 0:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self._count / dt if dt > 0 else 0.0

    @property
    def wall_items_per_sec(self) -> float:
        dt = time.perf_counter() - self._wall_t0
        return self._total_count / dt if dt > 0 else 0.0

    def report(self, name: str = ""):
        print(f"[THROUGHPUT] {name}: {self.items_per_sec:.2f} items/s "
              f"steady ({self.wall_items_per_sec:.2f} incl. compile), "
              f"{self._total_count} items total")


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir):
    """``torch.profiler`` over the block (CPU, and CUDA where the card is
    there), its Chrome trace written to ``log_dir/trace.json`` when the
    block ends, also when it raises (view it in Perfetto or
    ``chrome://tracing``). Yields the trace's path; a ``log_dir`` of None
    profiles nothing and yields None."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(log_dir) / TRACE_FILE
    path.parent.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield path
    finally:
        prof.export_chrome_trace(str(path))


@contextlib.contextmanager
def annotate(name: str):
    """A named range in profiler traces."""
    from torch.profiler import record_function
    with record_function(name):
        yield
