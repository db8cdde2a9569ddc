"""``model.encode_graph_share``: None on a record whose program keeps no
``encode_graph_replays`` counter (an older tree's) or on a probing record,
the share on a synthetic record, and 0 in a traced serving run at the
"test" size on the CPU, where no encoding takes a CUDA graph."""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run as R  # noqa: E402

NAME = "model.encode_graph_share"
OLDER = {"admit_s": 0.8, "admits": 10, "prefill_s": 0.6,
         "step_enqueue_s": 0.4, "flag_wait_s": 0.1, "chunks": 5,
         "sync_s": 0.1, "block_wait_s": 0.0, "pixels_s": 0.2, "steps": 30,
         "guarded_steps": 10, "blocking_reads": 9}


def _record(stats):
    return {"kind": "serve", "window": {"stats": stats, "seconds": 2.0},
            "trace": None}


def test_none_where_the_program_keeps_no_counter():
    assert R.read_metric(NAME, _record(dict(OLDER))) is None
    assert R.read_metric(NAME, {"kind": "probe", "mode": "multi"}) is None


def test_the_share_of_a_synthetic_record():
    stats = dict(OLDER, encode_graph_replays=8)
    assert R.read_metric(NAME, _record(stats)) == pytest.approx(0.8)
    stats.update(admits=0, encode_graph_replays=0)
    assert R.read_metric(NAME, _record(stats)) is None


def test_a_traced_cpu_serving_run_reads_zero():
    torch.set_num_threads(2)
    run = R.Run("blip2_bf16_face", 20240611, 1.0, True, torch, "cpu",
                size="test", t0=time.perf_counter())
    out = R.execute(run)
    assert out["correct"]
    assert out["record"]["window"]["stats"]["encode_graph_replays"] == 0
    assert out["metrics"][NAME]["value"] == 0.0
