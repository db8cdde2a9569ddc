"""One rank of a probing run under a mesh, launched under ``torchrun``:

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m vlm_tpu_torch.testing.mesh_probe SPEC.json OUT_DIR

A run of one process (``--nproc_per_node 1``, or ``mesh`` 1 x 1) is the
one-device run of the same tasks. ``SPEC.json`` holds:

- ``mesh`` (``{data, model}``), ``device`` (``cpu`` or ``cuda``), ``root``
  (the project root, ``VLM_TPU_ROOT``: its ``configs/task_datasets.yaml``
  and where the runs write);
- ``tower`` (optional): a ``torch.save`` file of a vision tower's full
  state (e.g. ``vlm_tpu``'s, bridged by ``testing.bridge``), loaded into
  every model the tasks build, each rank its shard, before anything runs
  through it (else the models' random weights from their seed);
- ``tasks``, run in order, each ``[name, {arguments}]``:

  - ``features`` (``family``, ``size``, ``quantization``,
    ``quantize_vision``, ``model_id``, ``images``: a ``.npy`` of uint8
    NHWC images, ``chunks``: the batch sizes to run them at, ``paths``:
    image files, ``batch_size``): the backbone's ``forward`` of the images
    and ``extract_features_dataset`` of the files, written by rank 0 as
    ``<id>_features_<chunk>.npy`` / ``<id>_dataset.npy``;
  - ``train`` (``profile`` single | multi, ``cfg``: the trainer's config,
    ``run``, ``start``: a safetensors file of the trainer's starting
    tensors under their checkpoint names (heads, adapters,
    ``log_vars.<task>``), ``grad_samples``: the step-1 gradients on the
    first n training samples, ``fit``, ``delay_rank`` and ``delay_s``: that
    rank sleeps so long before ``fit``, as a rank starved of the CPU
    arrives late): the trainer under the mesh; rank 0
    writes ``<id>_grads.safetensors`` and ``<id>_final.safetensors`` (every
    trained tensor and the heads' statistics, at full shapes); each rank
    records the history, each step's losses and a digest of what it
    holds;
  - ``roundtrip`` (``profile``, ``cfg``, ``ckpt_dir`` under the root): a
    checkpoint's model and optimizer tensors loaded under the mesh and
    gathered back, compared bitwise;
  - ``test`` (``profile``, ``cfg``): the tester (rank 0 writes its files).

``<id>`` is the task's ``id`` (default its index). Each rank writes
``OUT_DIR/rank<r>.json``: its place on the mesh, backend and device, each
task's results, seconds, kernel launches and plain calls, the
collectives' counts and bytes, and its peak device memory. Imports nothing
of ``vlm_tpu`` or JAX.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch


def _counts():
    from vlm_tpu_torch.ops import _lib
    return {"launches": {k: v for k, v in _lib.launches.items() if v},
            "plain_calls": {k: v for k, v in _lib.plain_calls.items() if v},
            "recomputes": {k: v for k, v in _lib.recomputes.items() if v}}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def hook_tower(path):
    """Every model the tasks, trainers and testers build loads the tower
    of ``path`` (full state; each rank cuts its shard) before its backbone
    is taken; returns the function that undoes the hook."""
    from vlm_tpu_torch.models import factory
    from vlm_tpu_torch.parallel.sharding import shard_state_dict
    from vlm_tpu_torch.probing.test import multitask_tester, singletask_tester
    from vlm_tpu_torch.probing.train import (multitask_trainer,
                                             singletask_trainer)
    full = torch.load(path, map_location="cpu")
    real = factory.create_model

    def create(*a, **kw):
        vlm = real(*a, **kw)
        own = vlm.module.vision.state_dict()
        with torch.no_grad():
            for name, t in shard_state_dict(full, vlm.module.vision).items():
                own[name].copy_(t)
        return vlm

    mods = (factory, singletask_trainer, multitask_trainer,
            singletask_tester, multitask_tester)
    for m in mods:
        m.create_model = create

    def undo():
        for m in mods:
            m.create_model = real
    return undo


def digest(tensors) -> str:
    h = hashlib.sha256()
    for name in sorted(tensors):
        h.update(name.encode())
        h.update(tensors[name].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def task_features(mesh, spec, out, tid, family, size=None,
                  quantization="fp32", quantize_vision=None, images=None,
                  chunks=(8,), paths=None, batch_size=8, model_id=None):
    """The backbone under the mesh: ``forward`` of a uint8 batch in
    chunks of each size of ``chunks`` (one pass each, timed after a
    warm-up chunk) and ``extract_features_dataset`` of files."""
    from vlm_tpu_torch.models.factory import create_model
    vlm = create_model(family, size=size, quantization=quantization,
                       mesh=spec["mesh"], device=spec.get("device"),
                       model_id=model_id, quantize_vision=quantize_vision,
                       batch_size=batch_size)
    bb = vlm.get_vision_backbone()
    res = {"held_bytes": sum(t.numel() * t.element_size()
                             for t in bb.module.parameters())}
    dev = bb.device
    rank0 = mesh is None or mesh.rank == 0
    if images is not None:
        u8 = np.load(images)
        with torch.inference_mode():
            bb.forward(u8[:chunks[0]])
            for c in chunks:
                _reset(mesh)
                _sync(dev)
                t0 = time.perf_counter()
                feats = torch.cat([bb.forward(u8[i:i + c]) for i in
                                   range(0, len(u8), c)]).float()
                _sync(dev)
                dt = time.perf_counter() - t0
                res[f"chunk{c}"] = dict(seconds=dt, img_per_s=len(u8) / dt,
                                        **_counts(), collectives=_coll(mesh))
                if rank0:
                    np.save(out / f"{tid}_features_{c}.npy",
                            feats.cpu().numpy())
    if paths:
        _reset(mesh)
        t0 = time.perf_counter()
        feats = bb.extract_features_dataset(paths, progress=False)
        dt = time.perf_counter() - t0
        res["dataset"] = dict(seconds=dt, img_per_s=len(paths) / dt,
                              **_counts(), collectives=_coll(mesh))
        if rank0:
            np.save(out / f"{tid}_dataset.npy", feats)
    return res


def _reset(mesh):
    from vlm_tpu_torch.ops import _lib
    _lib.reset_counts()
    if mesh is not None:
        mesh.counts.clear()


def _coll(mesh):
    return dict(mesh.counts) if mesh is not None else {}


def _grad_batch(trainer, n):
    from vlm_tpu_torch.probing.train.data import Batch
    if getattr(trainer, "use_feature_cache", False):
        x, y = trainer.train_loader.x, trainer.train_loader.y
        return Batch(x[:n], y[:n], kind="array")
    ds = trainer.train_loader.dataset
    images, targets = zip(*(ds[i] for i in range(n)))
    return Batch(list(images), list(targets))


def step_grads(trainer, batch, multi: bool):
    """The step-1 gradients the trainer's step takes on ``batch`` (reduced
    over the mesh), at full shapes; the heads' state restored after."""
    from vlm_tpu_torch.probing.probes import full_tensor
    heads = trainer.probe.classifiers if multi else \
        {"": trainer.probe.classifier}
    saved = {t: copy.deepcopy(c.state_dict()) for t, c in heads.items()}
    if multi:
        trainer.current_task_weights = trainer._compute_task_weights()
        loss = trainer.total_loss(trainer.losses(batch, train=True))
    else:
        loss = trainer.loss(batch, train=True)
    trainer.backward(loss, trainer.data_mesh(len(list(batch)[1])))
    grads = {n: full_tensor(trainer.mesh, trainer.split_dims.get(n),
                            p.grad).clone()
             for n, p in trainer.params.items()}
    trainer.optimizer.zero_grad(set_to_none=True)
    for t, c in heads.items():
        c.load_state_dict(saved[t])
    return grads


def trained_tensors(trainer, full: bool):
    """Every trained tensor and the heads' statistics: full shapes
    (``full``, a collective) or this rank's own."""
    from vlm_tpu_torch.probing.probes import full_tensor
    out = {n: (full_tensor(trainer.mesh, trainer.split_dims.get(n), p)
               if full else p).detach()
           for n, p in trainer.params.items()}
    probe = trainer.probe
    heads = {f"heads.{t}.": c for t, c in probe.classifiers.items()} \
        if hasattr(probe, "classifiers") else {"head.": probe.classifier}
    for pre, c in heads.items():
        for k in ("bn.running_mean", "bn.running_var"):
            out[pre + k] = c.state_dict()[k]
    return out


def task_train(mesh, spec, out, tid, profile, cfg, run="run", start=None,
               grad_samples=0, fit=True, ckpt_root=None, delay_rank=None,
               delay_s=0.0):
    from vlm_tpu_torch.probing.train.multitask_trainer import \
        MultiTaskTrainer
    from vlm_tpu_torch.probing.train.singletask_trainer import \
        SingleTaskTrainer
    from vlm_tpu_torch.probing.train.utils import load_tensors, save_tensors
    multi = profile == "multi"
    cfg = dict(cfg, mesh=spec["mesh"])
    root = Path(ckpt_root or Path(spec["root"]) / "checkpoints")
    t0 = time.perf_counter()
    trainer = (MultiTaskTrainer if multi else SingleTaskTrainer)(
        cfg, run, root)
    build_s = time.perf_counter() - t0
    if start:
        blob = load_tensors(start)
        trainer.load_model_state(blob)
        with torch.no_grad():
            for t, v in getattr(trainer, "log_vars", {}).items():
                v.copy_(blob[f"log_vars.{t}"])
    rank0 = trainer.writer
    res = {"build_s": build_s,
           "extract": dict(getattr(trainer, "extract_stats", {}))}
    if grad_samples:
        grads = step_grads(trainer, _grad_batch(trainer, grad_samples), multi)
        if rank0:
            save_tensors(out / f"{tid}_grads.safetensors", grads)
    if fit:
        steps = []
        real = trainer.train_batch

        def train_batch(batch):
            _sync(trainer.device)
            t1 = time.perf_counter()
            losses = real(batch)
            steps.append({"losses": losses,
                          "ms": 1e3 * (time.perf_counter() - t1)})
            return losses
        trainer.train_batch = train_batch
        _reset(trainer.mesh)
        if mesh is not None and mesh.rank == delay_rank:
            time.sleep(delay_s)
        t1 = time.perf_counter()
        trainer.fit()
        _sync(trainer.device)
        res.update(fit_s=time.perf_counter() - t1, steps=steps,
                   history=trainer.history, last_stats=trainer.last_stats,
                   **_counts(), collectives=_coll(trainer.mesh))
        if multi:
            res["task_weights"] = trainer.current_task_weights
            res["running_means"] = trainer.rm.history if trainer.rm else {}
        csv = trainer.ckpt_dir / "history.csv"
        res["history_csv"] = csv.read_text() if csv.exists() else None
    full = trained_tensors(trainer, full=True)
    if rank0:
        save_tensors(out / f"{tid}_final.safetensors", full)
    res["digest_own"] = digest(trained_tensors(trainer, full=False))
    res["digest_heads"] = digest({k: v for k, v in full.items()
                                  if not k.startswith("backbone.")})
    res["ckpt_dir"] = str(trainer.ckpt_dir)
    return res


def task_roundtrip(mesh, spec, out, tid, profile, cfg, ckpt_dir):
    """A checkpoint (model and optimizer files, full shapes) loaded into a
    new trainer under the mesh, each rank its shard, and gathered back:
    whether every tensor comes back bitwise."""
    from vlm_tpu_torch.probing.train.multitask_trainer import \
        MultiTaskTrainer
    from vlm_tpu_torch.probing.train.singletask_trainer import \
        SingleTaskTrainer
    from vlm_tpu_torch.probing.train.utils import (GENERATOR_KEY, MODEL_FILE,
                                                   STATE_FILE, load_tensors)
    cfg = dict(cfg, mesh=spec["mesh"])
    trainer = (MultiTaskTrainer if profile == "multi" else
               SingleTaskTrainer)(cfg, f"roundtrip_{tid}",
                                  Path(spec["root"]) / "roundtrip")
    out = {}
    for what, fname, load, state in (
            ("model", MODEL_FILE, trainer.load_model_state,
             trainer.model_state),
            ("opt", STATE_FILE, trainer.load_opt_state, trainer.opt_state)):
        blob = load_tensors(Path(spec["root"]) / ckpt_dir / fname)
        load(blob)
        got = state()
        blob.pop(GENERATOR_KEY, None)
        got.pop(GENERATOR_KEY, None)
        out[f"{what}_tensors"] = len(blob)
        out[f"{what}_equal"] = set(got) == set(blob) and all(
            torch.equal(got[k].cpu(), blob[k]) for k in blob)
    return out


def task_test(mesh, spec, out, tid, profile, cfg):
    from vlm_tpu_torch.probing.test.multitask_tester import MultiTaskTester
    from vlm_tpu_torch.probing.test.singletask_tester import \
        SingleTaskTester
    cfg = dict(cfg, mesh=spec["mesh"])
    _reset(mesh)
    t0 = time.perf_counter()
    tester = (MultiTaskTester if profile == "multi" else
              SingleTaskTester)(cfg)
    tester.run()
    return {"seconds": time.perf_counter() - t0, **_counts(),
            "collectives": _coll(mesh)}


def run(spec: dict, out: Path) -> dict:
    """The spec's tasks on this rank; writes and returns its record. The
    process group stays formed (see ``mesh_pool``), and ``tower``'s hook
    is undone at the end."""
    out.mkdir(parents=True, exist_ok=True)
    torch.set_num_threads(int(spec.get("threads", 2)))
    os.environ["VLM_TPU_ROOT"] = spec["root"]
    if spec.get("device") == "cpu":
        os.environ["VLM_TPU_PLATFORM"] = "cpu"
    from vlm_tpu_torch.core.mesh import mesh_from_config
    from vlm_tpu_torch.data.dataset_factory import DatasetFactory
    DatasetFactory.load_task_map(force=True)
    mesh = mesh_from_config(spec["mesh"], spec.get("device"))
    undo = hook_tower(spec["tower"]) if spec.get("tower") else None
    try:
        return _run_tasks(mesh, spec, out)
    finally:
        if undo is not None:
            undo()


def _run_tasks(mesh, spec: dict, out: Path) -> dict:
    dev = mesh.device if mesh is not None else torch.device(
        spec.get("device") or "cuda")
    record = {"rank": mesh.rank if mesh else 0,
              "data_rank": mesh.data_rank if mesh else 0,
              "model_rank": mesh.model_rank if mesh else 0,
              "backend": mesh.backend if mesh else "", "device": str(dev),
              "tasks": []}
    fns = {"features": task_features, "train": task_train,
           "roundtrip": task_roundtrip, "test": task_test}
    for i, (name, kw) in enumerate(spec["tasks"]):
        kw = dict(kw)
        tid = kw.pop("id", str(i))
        _reset(mesh)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = fns[name](mesh, spec, out, tid, **kw)
        _sync(dev)
        res.update(name=name, id=tid, seconds=time.perf_counter() - t0)
        res.setdefault("collectives", _coll(mesh))
        for k, v in _counts().items():
            res.setdefault(k, v)
        if dev.type == "cuda":
            res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        record["tasks"].append(res)
    (out / f"rank{record['rank']}.json").write_text(json.dumps(record))
    return record


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(json.loads(Path(argv[0]).read_text()), Path(argv[1]))
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
