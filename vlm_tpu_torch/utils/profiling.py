"""Throughput meter and ``torch.profiler`` traces for the CLI (the port's
copy of ``vlm_tpu/utils/profiling.py``): a wall-clock images/s meter whose
first update is left out of the steady rate (on the card that update holds
the kernels' build and first launches), a trace context that writes a
Chrome trace of the host and the device, and the program's named ranges
in it (:func:`annotate`, :data:`SPANS`)."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

#: every span the program opens, outermost first within each path: the
#: continuous batcher's admission and the model's part of it, then the
#: decode loop. Each opens on the thread that enqueues the card's work,
#: never on the prefetch thread
SPANS = (
    "batcher.admit",        # ContinuousBatcher._admit: one admission
    "vlm.prefill",          # VLMModule.prefill
    "vlm.vision",           # VLMModule.encode_images: the tower
    "vlm.projector",        # VLMModule.encode_images: the projector
    "vlm.encode_graph",     # encode_images: the two above as a graph replay
    "vlm.decoder",          # VLMModule.prefill: the prompt rows, the head
    "batcher.cache_copy",   # _admit: the group's rows into the slot cache
    "batcher.admit_state",  # _admit: the first token and the slot state
    "batcher.chunk",        # _chunk: one chunk's dispatch
    "batcher.step",         # _decode_step: one dispatched step
    "vlm.decode_step",      # VLMModule.decode_step: its forward
    "batcher.flag_wait",    # StepFlags.wait, drain: a blocking wait
    "batcher.pack",         # _chunk: the packed result and its Pull
    "batcher.read",         # run: Pull.get, a cycle's planned read
    "batcher.block_wait",   # run: the wait for the next pixel block
)

#: what :func:`annotate` returns while no profiler runs
_OFF = contextlib.nullcontext()


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


def annotate(name: str):
    """A named range in profiler traces (``name``: one of :data:`SPANS`).
    While no profiler runs on this thread it returns one shared no-op
    context and builds nothing: its cost is the profiler check.

    The range is a host range (``RecordScope.FUNCTION``), as an operator's
    is, and not a user range (``record_function``'s): the profiler ties
    each kernel on the device to the innermost user range open at its
    launch only, so a user range here would take the kernels of the
    program's work from every user range a caller opened around it (a
    benchmark's, an operator's)."""
    if not _profiler_enabled():
        return _OFF
    return _RecordFunctionFast(name)
