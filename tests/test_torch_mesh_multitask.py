"""Multi-task probing, LoRA and the testers under a mesh: the port's ranks
(spawned under torchrun on gloo, ``vlm_tpu_torch/testing/mesh_probe.py``)
against ``vlm_tpu`` on one device, at the "test" size in fp32, on the same
tower, heads, adapters and log-variances (bridged from the flax trees),
dropout 0:

- ``MultiTaskTrainer`` with the 0.33 balancing, the weighted sampler, the
  augmentation and uncertainty weighting at ``data=2`` and ``2 x 2``, and
  with LoRA on the last block's attention at ``model=2``: step-1
  gradients, epoch losses, the epoch-2 task weights (1e-6), the EMA and
  the parameters after the run to the tolerances of
  ``tests/test_torch_multitask.py``; the heads, log-variances and adapters
  the same on every rank; ``history.csv`` equal to the port's one-device
  run's;
- the multi-task tester under each mesh on one checkpoint: preds, gts and
  metrics identical to the one-device run's.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_mesh_probing import run_root
from tests.test_torch_multitask import (GRAD_ATOL, GRAD_RTOL, TASKS, _cfg,
                                        _jax_grads, _np, _port_named, _rows)
from tests.torch_mesh_common import MESHES, assert_history_equal, launch
from vlm_tpu.data.dataset_factory import DatasetFactory as JFactory
from vlm_tpu.probing.train.multitask_trainer import \
    MultiTaskTrainer as JTrainer
from vlm_tpu.testing.synthetic import make_face_dataset
from vlm_tpu_torch.data.dataset_factory import DatasetFactory as TFactory
from vlm_tpu_torch.probing.train.utils import load_tensors, save_tensors
from vlm_tpu_torch.testing.bridge import (flax_to_state_dict,
                                          head_state_to_state_dict, lora_name)

RUNS = dict(MESHES, single={"data": 1, "model": 1})
#: the mode each launch trains: uncertainty weighting over the data
#: axis, LoRA over the model axis
MODE = {"single": "uw", "data2": "uw", "2x2": "uw", "model2": "lora"}
TEST_RUN = "llava_fp32_age-gender-emotion_linear"


def _start(jtr):
    """The port's names of ``vlm_tpu``'s starting heads (with their
    statistics), log-variances and adapters."""
    blob = {f"heads.{t}.{k}": v for t in TASKS for k, v in
            head_state_to_state_dict(_np(jtr.probe.head_state[t])).items()}
    for t, v in (jtr._log_vars or {}).items() if jtr.use_uw else ():
        blob[f"log_vars.{t}"] = torch.tensor(np.asarray(v))
    for n, ab in (_np(jtr.lora_params).items() if jtr.lora_spec else ()):
        for k in "AB":
            blob[f"lora.{lora_name(n)}.{k}"] = torch.tensor(np.asarray(ab[k]))
    return blob


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_multi")
    root = tmp / "root"
    base = root / "datasets"
    for split, n, every in (("train", 24, 5), ("val", 16, 1),
                            ("test", 12, 1)):
        make_face_dataset(base, "TestDataset", split, _rows(n, every))
    (root / "configs").mkdir(parents=True)
    (root / "configs" / "task_datasets.yaml").write_text(yaml.safe_dump({
        s: {t: ["TestDataset"] for t in TASKS}
        for s in ("train", "val", "test")}))
    old = {k: os.environ.get(k) for k in ("VLM_TPU_ROOT", "VLM_TPU_PLATFORM")}
    os.environ.update(VLM_TPU_ROOT=str(root), VLM_TPU_PLATFORM="cpu")
    for factory in (JFactory, TFactory):
        factory.load_task_map(force=True)
    try:
        train, _ = TFactory.create_multi_task_dataset(
            TASKS, split="train", base_path=str(base))
        counts = {}
        for t in TASKS:
            y = train.get_all_labels(t)
            cls, k = np.unique(y[y >= 0], return_counts=True)
            counts[t] = {str(c): int(m) for c, m in zip(cls, k)}
        (base / "TestDataset" / "train" / "class_counts.json").write_text(
            json.dumps(counts))
        out = {"tmp": tmp, "root": root, "modes": {}}
        for mode in ("uw", "lora"):
            cfg = _cfg(base, mode)
            jtr = JTrainer(copy.deepcopy(cfg), "run", tmp / f"jax_{mode}")
            if mode == "uw":
                torch.save(flax_to_state_dict(_np(
                    jtr.probe.backbone.params)), tmp / "tower.pt")
            start = _start(jtr)
            save_tensors(tmp / f"start_{mode}.safetensors", start)
            jds = jtr.train_loader.dataset
            images, targets = zip(*(jds[i] for i in range(8)))
            grads = _port_named(_jax_grads(jtr, list(images), list(targets)))
            jtr.fit()
            stats = {t: head_state_to_state_dict(_np(jtr.probe.head_state[t]))
                     for t in TASKS}
            out["modes"][mode] = dict(
                cfg=cfg, start=start, grads=grads, history=jtr.history,
                final=_port_named(jtr._params()), stats=stats,
                weights=dict(jtr.current_task_weights),
                ema={t: list(jtr.rm.history[t]) for t in TASKS})
            if mode == "uw":
                # the testers' checkpoint: vlm_tpu's trained heads
                ckpt = tmp / TEST_RUN
                ckpt.mkdir()
                save_tensors(ckpt / "model.safetensors", {
                    f"heads.{t}.{k}": v for t in TASKS
                    for k, v in stats[t].items()})
                (ckpt / "head_config.yaml").write_text(yaml.safe_dump(cfg))
        test_cfg = {"data": {"base_path": str(base), "batch_size": 5},
                    "eval": {"ckpt_from": str(tmp / TEST_RUN),
                             "dataset_name": "auto"}}
        out["tasks"] = {mode: [
            ["train", dict(id=mode, profile="multi", cfg=m["cfg"], run=mode,
                           start=str(tmp / f"start_{mode}.safetensors"),
                           grad_samples=8)],
            ["test", dict(id="test", profile="multi", cfg=test_cfg)]]
            for mode, m in out["modes"].items()}
        yield out
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        JFactory._task_datasets = TFactory._task_datasets = None


_RUNS = {}


def records(ref, mesh):
    if mesh not in _RUNS:
        tmp = ref["tmp"]
        mine = run_root(tmp, mesh, ref["root"])
        spec = dict(root=str(mine), device="cpu", tower=str(tmp / "tower.pt"),
                    tasks=ref["tasks"][MODE[mesh]], threads=1)
        recs = launch(spec, tmp, RUNS[mesh], mesh, worker="mesh_probe")
        _RUNS[mesh] = (recs, tmp / mesh / "out", mine)
    return _RUNS[mesh]


def task(rec, tid):
    return next(t for t in rec["tasks"] if t["id"] == tid)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_trainer_matches_vlm_tpu(ref, mesh):
    recs, out, _ = records(ref, mesh)
    mode = MODE[mesh]
    want = ref["modes"][mode]
    got = load_tensors(out / f"{mode}_grads.safetensors")
    assert set(got) <= set(want["grads"])
    assert {n for n in got if n.startswith(("lora.", "log_vars."))} == \
        {n for n in want["grads"] if n.startswith(("lora.", "log_vars."))}
    noise = set()
    for name, g in got.items():
        r = want["grads"][name].numpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
        if max(float(g.abs().max()), float(np.abs(r).max())) < GRAD_ATOL:
            noise.add(name)
    if mode == "lora":
        # B starts at zero: A's first gradient is zero, B's is not
        assert all(not got[n].any() for n in got if n.endswith(".A"))
        assert all(got[n].abs().max() > 1e-4 for n in got
                   if n.endswith(".B"))
    t = task(recs[0], mode)
    for key in ("train", "val"):
        np.testing.assert_allclose(t["history"][key], want["history"][key],
                                   rtol=1e-4, err_msg=key)
    for tk in TASKS:
        assert abs(t["task_weights"][tk] - want["weights"][tk]) < 1e-6
        np.testing.assert_allclose(t["running_means"][tk], want["ema"][tk],
                                   rtol=1e-4)
    steps = t["last_stats"]["train_steps"]
    assert steps == 2 * 4
    cfg = want["cfg"]["train"]
    final = load_tensors(out / f"{mode}_final.safetensors")
    for name, p in final.items():
        if "running" in name:
            continue
        lr = cfg["lr"]
        r = want["final"][name].numpy()
        if name in noise and not name.endswith(".A"):
            p0 = want["start"][name].numpy()
            assert float(np.abs(p.numpy() - p0).max()) <= lr * steps * 1.01
            continue
        np.testing.assert_allclose(p.numpy(), r, rtol=0, atol=0.1 * lr,
                                   err_msg=name)
    for tk in TASKS:
        for name in ("bn.running_mean", "bn.running_var"):
            np.testing.assert_allclose(
                final[f"heads.{tk}.{name}"].numpy(),
                want["stats"][tk][name].numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_agree_and_history_equals_one_device(ref, mesh):
    """Every rank holds the same heads, log-variances and adapters (LoRA's
    gradients summed over the model axis: without that sum each model rank
    would step its own adapter); every data rank the same tower shard; the
    EMA and the task weights are the same everywhere; ``history.csv`` of a
    data-parallel run equals the one-device run's."""
    recs, _, _ = records(ref, mesh)
    mode = MODE[mesh]
    first = task(recs[0], mode)
    for rec in recs:
        t = task(rec, mode)
        assert t["digest_heads"] == first["digest_heads"]
        assert t["task_weights"] == first["task_weights"]
        assert t["running_means"] == first["running_means"]
        same = {task(r, mode)["digest_own"] for r in recs
                if r["model_rank"] == rec["model_rank"]}
        assert len(same) == 1
    if mode == "uw":
        single, _, _ = records(ref, "single")
        assert_history_equal(first["history_csv"],
                             task(single[0], "uw")["history_csv"])
    else:
        coll = first["collectives"]
        assert coll.get("all_reduce_model", 0) > 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tester_files_equal_one_device(ref, mesh):
    """The multi-task tester on one checkpoint: preds, gts and metrics
    under the mesh identical to the one-device run's, written by rank 0."""
    _, _, mine = records(ref, mesh)
    _, _, one = records(ref, "single")
    rel = os.path.join("probing", "multitask_probing", "eval", TEST_RUN)
    for t in TASKS:
        for name in ("preds.json", "gts.json", "metrics.json"):
            a = (mine / rel / t / "TestDataset" / name).read_text()
            b = (one / rel / t / "TestDataset" / name).read_text()
            assert json.loads(a) == json.loads(b), (t, name)
