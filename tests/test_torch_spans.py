"""The port's own spans and counters on the CPU, at the "test" size:

- ``annotate`` with no profiler returns its one shared no-op and builds
  no range; only ``utils/profiling.py`` opens profiler ranges;
- under ``torch.profiler`` a BLIP-2 ``ContinuousBatcher.run`` opens every
  name in ``SPANS``, nested as the table in ``utils/profiling.py`` says,
  all on the thread that enqueues the work;
- the counters: ``step_enqueue_s + flag_wait_s`` is a chunk's dispatch
  time (under a clock that moves only where the test says),
  ``prefill_s <= admit_s``, ``pixels_s`` on the prefetch thread.
"""

import contextlib
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from vlm_tpu_torch.generate import batcher as batcher_mod
from vlm_tpu_torch.generate import readback
from vlm_tpu_torch.generate.batcher import ContinuousBatcher
from vlm_tpu_torch.generate.readback import StepFlags
from vlm_tpu_torch.models.configs import VLM_CONFIGS
from vlm_tpu_torch.models.vlm import VLMModule, num_image_tokens
from vlm_tpu_torch.utils import profiling

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
POST = np.asarray([2, 7, 9], np.int32)


# ------------------------------- annotate --------------------------------

def test_annotate_without_a_profiler_builds_nothing(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a range was built with no profiler running")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    assert not torch.autograd._profiler_enabled()
    for name in profiling.SPANS:
        ctx = profiling.annotate(name)
        assert ctx is profiling._OFF
        with ctx:
            torch.ones(2) + 1
    with pytest.raises(AssertionError, match="with no profiler"):
        with profile(activities=[ProfilerActivity.CPU]):
            profiling.annotate("batcher.admit")


def test_only_the_profiling_module_opens_ranges():
    pkg = REPO / "vlm_tpu_torch"
    found = sorted(
        str(p.relative_to(pkg)) for p in pkg.rglob("*.py")
        if p.parts[len(pkg.parts)] != "testing" and
        re.search(r"record_function|_RecordFunctionFast", p.read_text()))
    assert found == ["utils/profiling.py"]


def test_spans_are_named_once():
    assert len(set(profiling.SPANS)) == len(profiling.SPANS) == 15


# ---------------------------- shared helpers -----------------------------

@pytest.fixture(scope="module")
def blip2():
    torch.manual_seed(0)
    cfg = VLM_CONFIGS["blip2"]("test")
    module = VLMModule(cfg, dtype=torch.float32, device="cpu").eval()
    with torch.no_grad():
        for p in module.parameters():
            p.normal_(0.0, 0.05)
    return cfg, module


#: the batcher's host loops: pipelined (one chunk in flight, or two) and
#: synchronous (a blocking read every chunk of at most four steps)
LOOPS = {"pipelined": {}, "pipelined2": {"pipeline_depth": 2},
         "sync4": {"sync_every": 4}}


def _serve(cfg, module, n=6, slots=3, admit=2, new=4, pixel_fn=None,
           loop="pipelined"):
    s = cfg.vision.image_size
    px = np.random.default_rng(n).normal(size=(n, s, s, 3)) \
        .astype(np.float32)
    plen = num_image_tokens(cfg) + len(POST)
    # an EOS outside the vocabulary: every image runs to its cap
    b = ContinuousBatcher(module, cfg, batch_size=slots, max_prompt_len=plen,
                          max_new_tokens=new, admit_block=admit, eos_id=-5,
                          **LOOPS[loop])
    out = b.run(pixel_fn or (lambda idxs: torch.from_numpy(px[idxs])),
                pre_ids_row=np.zeros(0, np.int32), post_ids_row=POST,
                prompt_len_scalar=plen, n_images=n)
    assert all(len(o) == new for o in out)
    return b


def _flags_never_ready(monkeypatch):
    """As on the card when the host runs ahead: no flag can be read without
    waiting, so the chunk blocks on one (``StepFlags.wait``)."""
    monkeypatch.setattr(StepFlags, "_ready", lambda self: self.read)


def _ranges(prof):
    """{span name: [(thread, start_us, end_us)]} of the program's spans."""
    out = {}
    for e in prof.events():
        if e.name in profiling.SPANS:
            out.setdefault(e.name, []).append(
                (e.thread, e.time_range.start, e.time_range.end))
    return out


def _inside(inner, outer, ranges) -> bool:
    """Every ``inner`` range lies in an ``outer`` range of its thread."""
    return all(any(t == u and a >= c and b <= d
                   for u, c, d in ranges[outer])
               for t, a, b in ranges[inner])


# --------------------------- the spans, traced ---------------------------

@pytest.mark.parametrize("loop", ["pipelined", "sync4"])
def test_every_span_opens_nested_on_the_enqueueing_thread(
        blip2, monkeypatch, loop):
    cfg, module = blip2
    _flags_never_ready(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.main_thread"):
            b = _serve(cfg, module, loop=loop)
    main = {e.thread for e in prof.events() if e.name == "test.main_thread"}
    r = _ranges(prof)
    # CPU pixels take no CUDA graph of the encoding
    assert set(r) == set(profiling.SPANS) - {"vlm.encode_graph"}
    assert {t for v in r.values() for t, _, _ in v} == main
    assert len(r["batcher.admit"]) == b.last_stats["admits"] == 3
    assert len(r["batcher.chunk"]) == b.last_stats["chunks"]
    assert len(r["batcher.step"]) == len(r["vlm.decode_step"]) == \
        b.last_stats["steps"] + b.last_stats["guarded_steps"]
    assert len(r["batcher.flag_wait"]) == \
        b.last_stats["blocking_reads"] - b.last_stats["chunks"] > 0
    for inner, outer in (
            ("vlm.prefill", "batcher.admit"), ("vlm.vision", "vlm.prefill"),
            ("vlm.projector", "vlm.prefill"), ("vlm.decoder", "vlm.prefill"),
            ("batcher.cache_copy", "batcher.admit"),
            ("batcher.admit_state", "batcher.admit"),
            ("batcher.step", "batcher.chunk"),
            ("vlm.decode_step", "batcher.step"),
            ("batcher.flag_wait", "batcher.chunk"),
            ("batcher.pack", "batcher.chunk")):
        assert _inside(inner, outer, r), (inner, outer)
    # siblings, not nested: the parts of an admission and of a step
    for a, b_ in (("vlm.vision", "vlm.decoder"),
                  ("vlm.prefill", "batcher.cache_copy"),
                  ("batcher.read", "batcher.chunk")):
        assert not _inside(a, b_, r) and not _inside(b_, a, r), (a, b_)


# ------------------------------ the counters -----------------------------

class _Clock:
    """A ``time`` whose ``perf_counter`` moves only by :meth:`tick`."""

    def __init__(self):
        self.now = 100.0

    def perf_counter(self):
        return self.now

    def tick(self, dt):
        self.now += dt


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_chunk_dispatch_splits_into_enqueue_and_flag_waits(
        blip2, monkeypatch, loop):
    """Each dispatched step's enqueue takes 1 s, each blocking flag wait
    0.25 s and each prefill 2 s of the patched clock, nothing else takes
    any: the counters read exactly those, and ``step_enqueue_s +
    flag_wait_s`` is the chunks' dispatch time."""
    cfg, module = blip2
    _flags_never_ready(monkeypatch)
    clock = _Clock()
    monkeypatch.setattr(batcher_mod, "time", clock)
    monkeypatch.setattr(readback, "time", clock)
    step = ContinuousBatcher._decode_step

    def timed_step(self, *a):
        clock.tick(1.0)
        return step(self, *a)
    monkeypatch.setattr(ContinuousBatcher, "_decode_step", timed_step)

    @contextlib.contextmanager
    def waiting(name):                    # StepFlags' one span: its wait
        yield
        clock.tick(0.25)
    monkeypatch.setattr(readback, "annotate", waiting)
    prefill = module.prefill

    def timed_prefill(*a, **k):
        clock.tick(2.0)
        return prefill(*a, **k)
    monkeypatch.setattr(module, "prefill", timed_prefill)
    b = _serve(cfg, module, n=7, slots=3, admit=2, new=5, loop=loop)
    st = b.last_stats
    dispatched = st["steps"] + st["guarded_steps"]
    waits = st["blocking_reads"] - st["chunks"]
    assert dispatched > 0 and waits > 0
    assert st["step_enqueue_s"] == pytest.approx(1.0 * dispatched, abs=1e-9)
    assert st["flag_wait_s"] == pytest.approx(0.25 * waits, abs=1e-9)
    assert st["prefill_s"] == pytest.approx(2.0 * st["admits"], abs=1e-9)
    assert st["admit_s"] == pytest.approx(st["prefill_s"], abs=1e-9)
    assert "chunk_dispatch_s" not in st


def test_prefill_within_admission_and_pixels_on_the_prefetch_thread(blip2):
    cfg, module = blip2
    s = cfg.vision.image_size
    px = np.random.default_rng(1).normal(size=(5, s, s, 3)) \
        .astype(np.float32)
    writers = set()

    def pixel_fn(idxs):
        writers.add(threading.get_ident())
        time.sleep(0.01)
        return torch.from_numpy(px[idxs])
    b = _serve(cfg, module, n=5, slots=2, admit=1, new=3, pixel_fn=pixel_fn)
    st = b.last_stats
    assert 0 < st["prefill_s"] <= st["admit_s"]
    assert st["pixels_s"] >= 0.01 * st["admits"]
    assert writers and threading.get_ident() not in writers
