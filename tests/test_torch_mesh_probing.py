"""Single-task probing under a mesh: the port's ranks (spawned under
torchrun on gloo, ``vlm_tpu_torch/testing/mesh_probe.py``) at
``model=2``, ``data=2`` and ``2 x 2`` against ``vlm_tpu`` on one device,
at the "test" size in fp32, on the same tower and heads (bridged from the
flax trees), dropout 0:

- the backbone's features of 5 images (an odd batch: padded over
  ``data``) and of a dataset's files within 1e-4 (``vlm_tpu``'s own bound
  for its meshed backbone);
- a feature-cache run (extracted under the mesh) and an end-to-end run
  with the last block's attention and the embeddings trained: step-1
  gradients within rtol 1e-4 and atol 1e-6 (under ``model=2`` plus
  1e-5 x the tensor's largest gradient: the model axis sums a
  column-parallel input's gradient over the ranks' halves of the heads,
  another fp32 order, which leaves the embeddings' gradients up to
  ~4e-6 of their scale from one device's, where one device's own are up
  to ~2e-6), epoch losses within 1e-4
  relative, parameters after the run within 0.1 x lr (a parameter whose
  gradient is rounding noise to |p - p0| <= lr x steps, as
  ``tests/test_torch_probing.py`` holds it), BatchNorm's running
  statistics as one device's;
- ``history.csv`` equal to the port's one-device run's to its 6
  decimals (each value within one unit of the last); every data rank
  holding the same trained tensors, every rank the same heads;
- 13 samples a split: a batch of 8 split over ``data=2`` and a ragged
  tail of 5, computed whole on every rank;
- dropout 0.3 (on the cached features): the one-device run's losses and
  head, the mask drawn for the whole batch and cut to each rank's rows;
- a rank that reaches ``fit`` late (rank 0 has trained an epoch and saved
  a checkpoint by then) still trains every epoch: it does not resume from
  this run's own checkpoint, so the ranks meet at the same barriers.
"""

import copy
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_probing import (GRAD_ATOL, GRAD_RTOL, _cfg, _jax_grads,
                                      _np, _port_named)
from tests.torch_mesh_common import MESHES, assert_history_equal, launch
from vlm_tpu.data.dataset_factory import DatasetFactory as JFactory
from vlm_tpu.probing.train.singletask_trainer import \
    SingleTaskTrainer as JTrainer
from vlm_tpu.testing.synthetic import make_face_dataset
from vlm_tpu_torch.data.dataset_factory import DatasetFactory as TFactory
from vlm_tpu_torch.probing.train.utils import load_tensors, save_tensors
from vlm_tpu_torch.testing.bridge import (flax_to_state_dict,
                                          head_state_to_state_dict)

RUNS = dict(MESHES, single={"data": 1, "model": 1})
N_ROWS = 13
MODES = ("cache", "e2e")
#: the model axis's fp32 reordering of a gradient, relative to its scale
TP_SCALE = 1e-5


def face_root(tmp, n=N_ROWS, tasks=("gender", "age")):
    """A project root mapping ``tasks`` to a face dataset of ``n`` rows a
    split (one gender label missing)."""
    root = tmp / "root"
    base = root / "datasets"
    rows = [{"gender": i % 2, "age": 5 + 7 * i, "ethnicity": i % 4,
             "emotion": i % 7} for i in range(n)]
    rows[3]["gender"] = ""
    for split in ("train", "val", "test"):
        make_face_dataset(base, "TestDataset", split, rows)
    (root / "configs").mkdir(parents=True)
    (root / "configs" / "task_datasets.yaml").write_text(yaml.safe_dump({
        s: {t: ["TestDataset"] for t in tasks}
        for s in ("train", "val", "test")}))
    return root, base


def run_root(tmp, name, root):
    """A fresh project root for one launch (its own caches and
    checkpoints), with ``root``'s task map."""
    mine = tmp / f"root_{name}"
    (mine / "configs").mkdir(parents=True)
    shutil.copy(root / "configs" / "task_datasets.yaml", mine / "configs")
    return mine


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_probe")
    root, base = face_root(tmp)
    old = {k: os.environ.get(k) for k in ("VLM_TPU_ROOT", "VLM_TPU_PLATFORM")}
    os.environ.update(VLM_TPU_ROOT=str(root), VLM_TPU_PLATFORM="cpu")
    JFactory.load_task_map(force=True)
    try:
        out = {"tmp": tmp, "root": root, "base": base, "modes": {}}
        rng = np.random.default_rng(0)
        images = rng.integers(0, 256, (5, 56, 56, 3), dtype=np.uint8)
        np.save(tmp / "images.npy", images)
        TFactory.load_task_map(force=True)
        ds, _ = TFactory.create_multi_task_dataset(
            ["gender"], split="train", base_path=str(base))
        for mode in MODES:
            cfg = _cfg(base, e2e=mode == "e2e", parts="attn")
            jtr = JTrainer(copy.deepcopy(cfg), "run", tmp / f"jax_{mode}")
            if mode == "cache":
                tower = flax_to_state_dict(_np(jtr.probe.backbone.params))
                torch.save(tower, tmp / "tower.pt")
                out["features"] = np.asarray(jtr.probe.backbone.forward(
                    images))
                out["dataset"] = np.asarray(jtr.train_loader.x)
            start = {f"head.{k}": v for k, v in head_state_to_state_dict(
                _np(jtr.probe.head_state)).items()}
            save_tensors(tmp / f"start_{mode}.safetensors", start)
            if mode == "cache":
                x, y = jtr.train_loader.x[:8], jtr.train_loader.y[:8]
                batch = (x, y)
            else:
                batch = tuple(map(list, zip(*(ds[i] for i in range(8)))))
            grads = _jax_grads(jtr, batch)
            want = _port_named(grads["head"], "head")
            if "backbone" in grads:
                want.update(_port_named(grads["backbone"], "backbone"))
            p0 = {**start, **{f"backbone.{k}": v for k, v in tower.items()}}
            jtr.fit()
            final = _port_named(jtr.probe.head_state["params"], "head")
            final.update(_port_named(jtr.probe.backbone.params, "backbone"))
            stats = head_state_to_state_dict(_np(jtr.probe.head_state))
            out["modes"][mode] = dict(cfg=cfg, grads=want, p0=p0,
                                      history=jtr.history, final=final,
                                      stats=stats)
        paths = [str(p) for p in ds.image_paths()]
        tasks = [["features", dict(id="feat", family="llava", size="test",
                                   images=str(tmp / "images.npy"),
                                   chunks=[5], paths=paths, batch_size=4)]]
        for mode in MODES:
            cfg = out["modes"][mode]["cfg"]
            tasks.append(["train", dict(
                id=mode, profile="single", cfg=cfg, run=mode,
                start=str(tmp / f"start_{mode}.safetensors"),
                grad_samples=8)])
        # dropout 0.3 on the cached features: the port's one-device
        # trajectory under the mesh (the whole batch's mask, a rank's rows)
        drop = _cfg(base)
        drop["model"]["dropout_p"] = 0.3
        tasks.append(["train", dict(id="dropout", profile="single",
                                    cfg=drop, run="dropout")])
        tasks.append(["roundtrip", dict(id="rt", profile="single",
                                        cfg=out["modes"]["e2e"]["cfg"],
                                        ckpt_dir="checkpoints/e2e")])
        out["paths"] = paths
        out["tasks"] = tasks
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
        spec = dict(root=str(run_root(tmp, mesh, ref["root"])), device="cpu",
                    tower=str(tmp / "tower.pt"), tasks=ref["tasks"],
                    threads=1)
        recs = launch(spec, tmp, RUNS[mesh], mesh, worker="mesh_probe")
        _RUNS[mesh] = (recs, tmp / mesh / "out")
    return _RUNS[mesh]


def task(rec, tid):
    return next(t for t in rec["tasks"] if t["id"] == tid)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_backbone_features_match_vlm_tpu(ref, mesh):
    recs, out = records(ref, mesh)
    feats = np.load(out / "feat_features_5.npy")
    assert feats.shape == ref["features"].shape
    np.testing.assert_allclose(feats, ref["features"], atol=1e-4, rtol=0)
    # the dataset's files, in batches of 4 over data (each rank decoding
    # its rows), the tail padded
    ds = np.load(out / "feat_dataset.npy")
    np.testing.assert_allclose(ds, ref["dataset"], atol=1e-4, rtol=0)
    for rec in recs:
        coll = task(rec, "feat")["chunk5"]["collectives"]
        assert (coll.get("all_gather_data", 0) > 0) == \
            (RUNS[mesh]["data"] > 1)
        assert (coll.get("all_reduce_model", 0) > 0) == \
            (RUNS[mesh]["model"] > 1)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_trainer_matches_vlm_tpu(ref, mesh, mode):
    recs, out = records(ref, mesh)
    want = ref["modes"][mode]
    got = load_tensors(out / f"{mode}_grads.safetensors")
    assert set(got) <= set(want["grads"])
    assert any(n.startswith("backbone.") for n in got) == (mode == "e2e")
    noise = set()
    tp = RUNS[mesh]["model"] > 1
    for name, g in got.items():
        r = want["grads"][name].numpy()
        atol = GRAD_ATOL + (TP_SCALE * float(np.abs(r).max()) if tp else 0)
        np.testing.assert_allclose(g.numpy(), r, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=name)
        if max(float(g.abs().max()), float(np.abs(r).max())) < GRAD_ATOL:
            noise.add(name)
    assert noise <= {"backbone.blocks.1.attn.k_proj.bias",
                     "backbone.post_ln.weight", "backbone.post_ln.bias"}
    t = task(recs[0], mode)
    for key in ("train", "val"):
        np.testing.assert_allclose(t["history"][key], want["history"][key],
                                   rtol=1e-4, err_msg=key)
    cfg = want["cfg"]["train"]
    steps = t["last_stats"]["train_steps"]
    assert steps == 2 * 2
    final = load_tensors(out / f"{mode}_final.safetensors")
    for name, p in final.items():
        if "running" in name:
            continue
        lr = cfg["backbone_lr"] if name.startswith("backbone.") \
            else cfg["lr"]
        r = want["final"][name].numpy()
        if name in noise:
            p0 = want["p0"][name].numpy()
            bound = lr * steps * 1.01
            assert float(np.abs(p.numpy() - p0).max()) <= bound
            continue
        np.testing.assert_allclose(p.numpy(), r, rtol=0, atol=0.1 * lr,
                                   err_msg=name)
    for name in ("bn.running_mean", "bn.running_var"):
        np.testing.assert_allclose(final[f"head.{name}"].numpy(),
                                   want["stats"][name].numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_history_and_ranks_equal_one_device(ref, mesh):
    """``history.csv`` of every mode equal to the port's one-device run's
    (6 decimals); every data rank holds the same trained tensors, every
    rank the same heads and statistics; only rank 0 wrote the files; a
    split batch all-reduced its gradients over ``data``, the ragged tail
    did not."""
    recs, out = records(ref, mesh)
    single, sout = records(ref, "single")
    m = RUNS[mesh]
    for mode in MODES:
        t = task(recs[0], mode)
        assert_history_equal(t["history_csv"],
                             task(single[0], mode)["history_csv"])
        for rec in recs:
            mine = task(rec, mode)
            assert mine["digest_heads"] == t["digest_heads"]
            same = [task(r, mode)["digest_own"] for r in recs
                    if r["model_rank"] == rec["model_rank"]]
            assert len(set(same)) == 1
            coll = mine["collectives"]
            # the model group's tower collectives; the data axis's
            # gradient sums: one a split step (2 a epoch), none for the
            # tail, plus the heads' BatchNorm and loss sums
            assert (coll.get("all_reduce_data", 0) > 0) == (m["data"] > 1)
            assert coll.get("barrier", 0) >= 1
            assert (coll.get("all_reduce_model", 0) > 0) == \
                (m["model"] > 1 and mode == "e2e")
    files = {p.name for p in (out.parent.parent / f"root_{mesh}").rglob("*")
             if p.is_file()}
    assert {"history.csv", "loss_curve.png", "model.safetensors",
            "train_features.npz"} <= files


def test_checkpoints_round_trip_between_a_mesh_and_one_device(ref):
    """A checkpoint written under a mesh has the one-device run's layout
    (the names and full shapes); loaded under the mesh (each rank its
    shard) and gathered back, its model and optimizer tensors come back
    bitwise; and the ``model=2`` run's loads into a one-device trainer and
    comes back bitwise too."""
    from vlm_tpu_torch.probing.train.singletask_trainer import \
        SingleTaskTrainer as TTrainer
    single, _ = records(ref, "single")
    one = load_tensors(os.path.join(task(single[0], "e2e")["ckpt_dir"],
                                    "model.safetensors"))
    for mesh in MESHES:
        recs, _ = records(ref, mesh)
        mine = load_tensors(os.path.join(task(recs[0], "e2e")["ckpt_dir"],
                                         "model.safetensors"))
        assert {k: tuple(v.shape) for k, v in mine.items()} == \
            {k: tuple(v.shape) for k, v in one.items()}
        for rec in recs:
            rt = task(rec, "rt")
            assert rt["model_equal"] and rt["opt_equal"], rt
            assert rt["model_tensors"] == len(one)
    recs, _ = records(ref, "model2")
    ckpt = task(recs[0], "e2e")["ckpt_dir"]
    os.environ["VLM_TPU_ROOT"] = str(ref["root"])
    tr = TTrainer(copy.deepcopy(ref["modes"]["e2e"]["cfg"]), "rt",
                  ref["tmp"] / "rt_one")
    blob = load_tensors(os.path.join(ckpt, "model.safetensors"))
    tr.load_model_state(blob)
    got = tr.model_state()
    assert set(got) == set(blob)
    assert all(torch.equal(got[k], blob[k]) for k in blob)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dropout_keeps_the_one_device_trajectory(ref, mesh):
    """Dropout 0.3 in the head, on the cached features: each rank draws
    the whole batch's mask from the shared generator and keeps its rows,
    so the losses and the head after the run are the one-device run's."""
    recs, out = records(ref, mesh)
    single, sout = records(ref, "single")
    t = task(recs[0], "dropout")
    one = task(single[0], "dropout")
    assert_history_equal(t["history_csv"], one["history_csv"])
    np.testing.assert_allclose(t["history"]["train"],
                               one["history"]["train"], rtol=1e-6)
    got = load_tensors(out / "dropout_final.safetensors")
    want = load_tensors(sout / "dropout_final.safetensors")
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    # and dropout did act: the run differs from the one without it
    assert t["history"]["train"] != task(recs[0], "cache")["history"]["train"]


def test_a_late_rank_trains_every_epoch(ref):
    """Rank 1 sleeps 8 s before ``fit`` while rank 0 trains its first
    epoch on the cached features (no collective in it) and saves. Every
    rank reads the checkpoint directory before rank 0's first save: both
    train both epochs, to the same history, and the launch ends (a rank
    that resumed from the fresh checkpoint skipped that save's barrier and
    left rank 0 waiting at its last one)."""
    tmp = ref["tmp"]
    spec = dict(root=str(run_root(tmp, "late", ref["root"])), device="cpu",
                tower=str(tmp / "tower.pt"), threads=1, tasks=[[
                    "train", dict(id="late", profile="single",
                                  cfg=ref["modes"]["cache"]["cfg"],
                                  run="late", delay_rank=1, delay_s=8.0)]])
    recs = launch(spec, tmp, RUNS["model2"], "late", worker="mesh_probe")
    hist = [task(rec, "late")["history"] for rec in recs]
    assert [len(h["train"]) for h in hist] == [2, 2]
    assert hist[0] == hist[1]
    assert task(recs[0], "late")["history_csv"] is not None
