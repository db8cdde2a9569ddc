"""The device trace of a stretch of a run: ``torch.profiler`` over the
card, the kernels' own intervals, the benchmark's spans, busy time and the
idle gaps.

A span is a ``record_function`` range the benchmark puts around a call of
the program. The profiler gives each range an interval on the device's
timeline too (from the first kernel launched inside it to the end of the
last): kernels launched through ``ctypes``, as the port's are, have no
host operation of their own to be linked to, so a span's device time is
the time of the kernels that run inside its device interval."""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Tuple

Interval = Tuple[float, float]


def record(torch, name: str, fn):
    """``fn`` wrapped in a span called ``name``."""
    from torch.profiler import record_function

    def call(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return call


def merged(iv: List[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class DeviceTrace:
    """Start, stop and read one profiled stretch. Times in seconds."""

    def __init__(self, torch, spans):
        self.torch = torch
        self.spans = tuple(spans)
        self.prof = None
        #: off the card (the CPU tests) only the host is traced
        self.cuda = torch.cuda.is_available()

    def _sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        acts = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.stop()

    def read(self) -> dict:
        """Kernels (name, start, end), each span's calls and device
        kernel seconds, busy seconds, the stretch's wall and its idle gaps
        labelled by the innermost span the host was in."""
        kernels, dev_ann, cpu = [], {}, {}
        for e in self.prof.events():
            cuda = str(e.device_type).endswith("CUDA")
            iv = (e.time_range.start * 1e-6, e.time_range.end * 1e-6)
            if e.name in self.spans:
                (dev_ann if cuda else cpu).setdefault(e.name, []).append(iv)
            elif cuda and not getattr(e, "is_user_annotation", False):
                kernels.append((e.name, iv[0], iv[1]))
        kernels.sort(key=lambda k: k[1])
        starts = [k[1] for k in kernels]
        busy_iv = merged([(k[1], k[2]) for k in kernels])
        spans = {}
        for name in self.spans:
            secs = 0.0
            for s, e in dev_ann.get(name, []):
                i = bisect.bisect_left(starts, s)
                while i < len(kernels) and kernels[i][1] < e:
                    secs += max(0.0, min(e, kernels[i][2]) - kernels[i][1])
                    i += 1
            spans[name] = {"calls": len(cpu.get(name, [])),
                           "device_s": secs}
        gaps = []
        host = [(s, e, n) for n, ivs in cpu.items() for s, e in ivs]
        for (_, a), (b, _) in zip(busy_iv, busy_iv[1:]):
            inside = [h for h in host if h[0] <= a < h[1]]
            label = min(inside, key=lambda h: h[1] - h[0])[2] if inside \
                else "host, outside the spans"
            gaps.append((label, b - a))
        return {"kernels": kernels, "spans": spans,
                "busy_s": sum(e - s for s, e in busy_iv),
                "wall_s": self.wall_s, "gaps": gaps}


def breakdown(tr: dict) -> dict:
    """The contract's ``breakdown``: the ten device operations that took
    most time, and idle time by what the host was doing, ten at most."""
    by_op: Dict[str, float] = {}
    for name, s, e in tr["kernels"]:
        by_op[name] = by_op.get(name, 0.0) + (e - s)
    by_gap: Dict[str, float] = {}
    for label, d in tr["gaps"]:
        by_gap[label] = by_gap.get(label, 0.0) + d
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in idle]}

