"""Whole runs at the "test" size on the CPU, through the port's plain
paths: each cell's last line has the contract's shape and reads correct;
with the timed path broken underneath, ``correct`` comes out false; and
the run loads no module of JAX or of the JAX package."""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run as R  # noqa: E402
from portbench.harness import env  # noqa: E402

CELLS = [w["name"] for w in env.benchmark()["workloads"]]


def _run(cell, seed=20240607, trace=False):
    torch.set_num_threads(2)
    run = R.Run(cell, seed, 1.0, trace, torch, "cpu", size="test",
                t0=time.perf_counter())
    return R.execute(run)


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_prints_the_contracts_line(cell):
    out = _run(cell)
    line = env.result_line(correct=out["correct"],
                           attempted=out["attempted"], failed=out["failed"],
                           metrics=out["metrics"],
                           device={"platform": "gpu", "kind": "test",
                                   "count": 1, "memory_peak_bytes": 0},
                           checks=out["checks"])
    got = json.loads(line)
    assert list(got)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(got)[-1] == "checks"
    assert got["correct"] is True and got["failed"] == 0
    assert got["attempted"] > 0
    names = {m["name"] for m in R.metrics_for(env.benchmark(), cell, False)}
    assert set(got["metrics"]) == names
    assert all(v["value"] > 0 for v in got["metrics"].values())


def test_traced_run_reads_the_counters():
    out = _run("blip2_bf16_face", trace=True)
    # on the CPU no kernel runs: the device metrics find nothing to read
    assert set(out["metrics"]) == {"batcher.admit_host_ms",
                                   "batcher.guarded_share", "mfu.serve"}
    assert out["correct"]


def _alter_tokens(monkeypatch):
    """A token altered where it is produced: the decode step's sample is
    the least likely token."""
    import vlm_tpu_torch.generate.batcher as batcher

    def worst(logits, *a, **k):
        return torch.argmin(logits, dim=-1).to(torch.int32)
    monkeypatch.setattr(batcher, "sample_rows", worst)


def _unchanged_state(monkeypatch):
    """A step that returns its state unchanged: the optimizer never
    steps."""
    from vlm_tpu_torch.probing.train.base_trainer import BaseTrainer
    monkeypatch.setattr(BaseTrainer, "apply_gradients",
                        lambda self, loss, mesh=None: self.backward(loss,
                                                                    mesh))


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from vlm_tpu_torch.probing.train.data import Batch
    from vlm_tpu_torch.probing.train.multitask_trainer import \
        MultiTaskTrainer
    real = MultiTaskTrainer.losses

    def losses(self, batch, train):
        n = len(batch.targets) // 2
        return real(self, Batch(batch.inputs[:n], batch.targets[:n]), train)
    monkeypatch.setattr(MultiTaskTrainer, "losses", losses)


def _extra_leaf(monkeypatch):
    """A leaf the profile keeps frozen trains: the tower's first frozen
    tensor joins the optimizer's first group."""
    from vlm_tpu_torch.probing.train.base_trainer import BaseTrainer
    real = BaseTrainer.make_adamw

    def make_adamw(self, groups):
        groups = [(dict(named), lr) for named, lr in groups]
        have = {id(p) for named, _ in groups for p in named.values()}
        name, p = next((n, p) for n, p in
                       self.probe.backbone.module.named_parameters()
                       if id(p) not in have)
        p.requires_grad_(True)
        groups[0][0]["backbone." + name] = p
        real(self, groups)
    monkeypatch.setattr(BaseTrainer, "make_adamw", make_adamw)


def _dropped_leaf(monkeypatch):
    """A leaf the profile trains stays frozen: the first tower tensor of
    the optimizer's groups leaves them."""
    from vlm_tpu_torch.probing.train.base_trainer import BaseTrainer
    real = BaseTrainer.make_adamw

    def make_adamw(self, groups):
        groups = [(dict(named), lr) for named, lr in groups]
        for named, _ in groups:
            name = next((n for n in named if n.startswith("backbone.")),
                        None)
            if name is not None:
                named.pop(name).requires_grad_(False)
                break
        real(self, groups)
    monkeypatch.setattr(BaseTrainer, "make_adamw", make_adamw)


def _altered_pixels(monkeypatch):
    """An input altered where it is produced: one pixel of each batch's
    first image, as the loader hands it on."""
    from PIL import Image

    from vlm_tpu_torch.probing.train.data import ImageBatchLoader
    real = ImageBatchLoader._load

    def load(self, idxs):
        batch = real(self, idxs)
        a = np.array(batch.inputs[0].convert("RGB"))
        a[0, 0] ^= 0x40
        batch.inputs[0] = Image.fromarray(a)
        return batch
    monkeypatch.setattr(ImageBatchLoader, "_load", load)


def _half_features(monkeypatch):
    """Half of an extraction batch left out: its features are zero."""
    from vlm_tpu_torch.models.backbone import VisionBackbone
    real = VisionBackbone.features

    def features(self, pixels, *a, **k):
        f = real(self, pixels, *a, **k)
        return torch.cat([f[:len(f) // 2], torch.zeros_like(f[len(f) // 2:])])
    monkeypatch.setattr(VisionBackbone, "features", features)


def _altered_features(monkeypatch):
    """An answer altered where it is produced: the features 1 % off."""
    from vlm_tpu_torch.models.backbone import VisionBackbone
    real = VisionBackbone.features
    monkeypatch.setattr(VisionBackbone, "features",
                        lambda self, *a, **k: real(self, *a, **k) * 1.01)


FAULTS = [("blip2_bf16_face", _alter_tokens),
          ("blip2_bf16_verbose", _alter_tokens),
          ("eva_probe_multi", _unchanged_state),
          ("eva_probe_multi", _half_batch),
          ("eva_probe_multi", _extra_leaf),
          ("eva_probe_multi", _dropped_leaf),
          ("eva_probe_multi", _altered_pixels),
          ("eva_probe_frozen", _half_features),
          ("eva_probe_frozen", _altered_features)]


@pytest.mark.parametrize("cell,fault", [f for f in FAULTS if f[0] in CELLS],
                         ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(cell)
    assert out["correct"] is False, out["checks"]


def test_drivers_are_found_by_the_traffics_kind():
    kinds = {env.load_json(p)["kind"] for p in
             (env.BENCH_DIR / "traffic").glob("*.json")}
    for kind in kinds:
        mod = R.driver(kind)
        assert callable(mod.run) and mod.CONTROLS
    for bad in ("no_such_kind", "../run", "Serve"):
        with pytest.raises(SystemExit):
            R.driver(bad)


@pytest.mark.parametrize("quant,dtype", [("8bit", "bfloat16"),
                                         ("4bit", "bfloat16"),
                                         ("bf16", "float32")])
def test_the_serving_driver_refuses_what_it_does_not_build(quant, dtype):
    from portbench.harness import serve
    run = R.Run("blip2_bf16_face", 3, 1.0, False, torch, "cpu",
                size="test", t0=time.perf_counter())
    run.config["port"]["quantization"] = quant
    run.config["dtype"] = dtype
    with pytest.raises(SystemExit, match="driver of its own"):
        serve.build(run)


@pytest.mark.parametrize("mix", [None, [[16, 23], [100, 2]]])
def test_every_block_of_the_stream_holds_the_same_caps(mix):
    from portbench.harness import serve
    run = R.Run("blip2_bf16_face", 2**31 + 9, 1.0, False, torch, "cpu",
                size="test", t0=time.perf_counter())
    if mix:
        run.traffic.update(cap_mix=mix, max_new_tokens=100)
    caps = np.asarray(serve.build(run)["caps"])
    want = np.sort(np.concatenate([np.full(k, c) for c, k in mix])) if mix \
        else np.repeat(np.arange(run.traffic["cap_min"],
                                 run.traffic["cap_max"] + 1),
                       run.traffic["cap_block"] //
                       (run.traffic["cap_max"] - run.traffic["cap_min"] + 1))
    blocks = caps[:len(caps) // len(want) * len(want)].reshape(-1, len(want))
    assert all((np.sort(b) == want).all() for b in blocks)
    assert len({tuple(b) for b in blocks[:4]}) > 1      # orders differ


def test_the_run_loads_no_jax():
    code = ("import sys, time, torch; sys.path.insert(0, %r); "
            "from portbench import run as R; from portbench.harness import "
            "env; torch.set_num_threads(2); "
            "r = R.Run('eva_probe_frozen', 5, 0.5, False, torch, 'cpu', "
            "size='test', t0=time.perf_counter()); out = R.execute(r); "
            "print('LOADED', env.forbidden_loaded(), out['correct'])"
            % str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert "LOADED [] True" in res.stdout, res.stderr[-2000:]


def test_forbidden_names_are_compared_whole():
    assert env.forbidden_loaded(["vlm_tpu_torch.models", "numpy"]) == []
    assert env.forbidden_loaded(["vlm_tpu.models", "jaxlib.xla"]) == \
        ["jaxlib", "vlm_tpu"]


def test_a_run_without_a_card_prints_no_result():
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={"CUDA_VISIBLE_DEVICES": "",
                                        "PATH": "/usr/bin:/bin"})
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_same_seed_same_inputs():
    from portbench.harness.weights import draw
    a = draw([("x.weight", (4, 8)), ("x.bias", (4,))], torch.float32, "cpu",
             2**31 + 5, torch)
    b = draw([("x.weight", (4, 8)), ("x.bias", (4,))], torch.float32, "cpu",
             2**31 + 5, torch)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert np.isclose(float(a["x.weight"].std()), 8 ** -0.5, rtol=0.6)
