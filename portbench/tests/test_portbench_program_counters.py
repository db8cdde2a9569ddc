"""The per-layer metrics that read the program's own batcher counters:
None on a record whose program keeps no such counter (an older tree's),
the expected number on a synthetic record, and a number in a traced run
of a serving cell at the "test" size."""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run as R  # noqa: E402

NEW = ("batcher.prefill_host_ms", "batcher.step_enqueue_ms",
       "batcher.flag_wait_share")
OLDER = {"admit_s": 0.8, "admits": 10, "chunk_dispatch_s": 0.5,
         "chunks": 5, "sync_s": 0.1, "block_wait_s": 0.0, "steps": 30,
         "guarded_steps": 10, "blocking_reads": 9}


def _record(stats, seconds=2.0):
    return {"kind": "serve", "window": {"stats": stats, "seconds": seconds},
            "trace": None}


@pytest.mark.parametrize("name", NEW)
def test_none_where_the_program_keeps_no_counter(name):
    assert R.read_metric(name, _record(dict(OLDER))) is None
    assert R.read_metric(name, {"kind": "probe", "mode": "multi"}) is None


def test_the_numbers_of_a_synthetic_record():
    stats = {k: v for k, v in OLDER.items() if k != "chunk_dispatch_s"}
    stats.update(prefill_s=0.6, step_enqueue_s=0.4, flag_wait_s=0.1,
                 pixels_s=0.2)
    rec = _record(stats, seconds=4.0)
    got = {n: R.read_metric(n, rec) for n in NEW}
    assert got == pytest.approx({"batcher.prefill_host_ms": 60.0,
                                 "batcher.step_enqueue_ms": 10.0,
                                 "batcher.flag_wait_share": 0.025})
    stats.update(admits=0, steps=0, guarded_steps=0)
    assert R.read_metric("batcher.prefill_host_ms", rec) is None
    assert R.read_metric("batcher.step_enqueue_ms", rec) is None


def test_a_traced_serving_run_reads_them():
    torch.set_num_threads(2)
    run = R.Run("blip2_bf16_verbose", 20240611, 1.0, True, torch, "cpu",
                size="test", t0=time.perf_counter())
    out = R.execute(run)
    assert out["correct"]
    s = out["record"]["window"]["stats"]
    assert 0 < s["prefill_s"] <= s["admit_s"]
    for name in NEW:
        assert out["metrics"][name]["value"] >= 0, name
