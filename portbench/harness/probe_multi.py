"""The multi-task probing cell: the port's ``MultiTaskTrainer`` as the
profile builds it, over synthetic face datasets in the readers' layouts.
Set-up drives it from the seed through its first steps, which the
reference follows, and hands the same trainer to the window, which runs
``train_batch`` on its own loader's batches.

The reference takes the benchmark's weights and files, not the program's
images: it decodes each row's file itself and replays the augmentation's
draws from the profile's seed (``portbench/reference/augment.py``). It
learns which file each row holds by watching the loader's reads, since
the weighted sampler's draw is the program's."""

from __future__ import annotations

import copy
import os

import numpy as np

from . import faces
from . import trace as tr
from .probe import SPANS, window
from .weights import draw, seed_of

#: the stand-ins ``controls.py`` puts in the program's place
CONTROLS = ("tf32", "half_batch")


def _labels(targets, tasks):
    return {t: [-1 if d.get(t) is None else int(d.get(t)) for d in targets]
            for t in tasks}


def _u8(images) -> np.ndarray:
    """The loader's PIL images as one uint8 [B, H, W, 3] array."""
    return np.stack([np.asarray(im.convert("RGB"), np.uint8)
                     for im in images])


class _Feed:
    """The trainer's loader, epoch after epoch."""

    def __init__(self, loader):
        self.loader = loader
        self.it = iter(loader)

    def next(self):
        try:
            return next(self.it)
        except StopIteration:
            self.it = iter(self.loader)
            return next(self.it)

    def close(self):
        close = getattr(self.it, "close", None)
        if close is not None:
            close()


def trained_names(widths: dict, prof: dict) -> list:
    """The tower leaves the profile trains, by the reference's own rule:
    every leaf of the last ``unfreeze_last_k`` blocks, and with
    ``include_embeddings`` the patch embedding, the CLS token, the
    position table and the final LN."""
    bb = prof["model"]["backbone"]
    k, layers = int(bb["unfreeze_last_k"]), widths["vision"]["layers"]
    keys = ("ln1.weight", "ln1.bias", "attn.q_proj.weight",
            "attn.q_proj.bias", "attn.k_proj.weight", "attn.v_proj.weight",
            "attn.v_proj.bias", "attn.out_proj.weight", "attn.out_proj.bias",
            "ln2.weight", "ln2.bias", "fc1.weight", "fc1.bias", "fc2.weight",
            "fc2.bias")
    out = [f"vision.blocks.{i}.{key}"
           for i in range(max(0, layers - k), layers) for key in keys]
    if bb.get("include_embeddings", True):
        out += ["vision.patch_embed.weight", "vision.patch_embed.bias",
                "vision.cls_token", "vision.pos_embed",
                "vision.post_ln.weight", "vision.post_ln.bias"]
    return out


def run(ctx) -> dict:
    torch = ctx.torch
    t, dev = ctx.traffic, ctx.device
    vis = ctx.widths["vision"]
    work = ctx.workdir()
    written = faces.write(work, t, ctx.seed, vis["image_size"])
    os.environ["VLM_TPU_ROOT"] = str(work)
    from vlm_tpu_torch.data.dataset_factory import DatasetFactory
    from vlm_tpu_torch.probing.train.multitask_trainer import \
        MultiTaskTrainer
    DatasetFactory.load_task_map(force=True)

    prof = copy.deepcopy(t["trainer"])
    port = ctx.config["port"]
    prof["model"].update(name=port["family"],
                         quantization=port["quantization"],
                         size=ctx.size_name(port["size"]))
    prof["data"]["base_path"] = str(work / "data")
    prof["train"]["seed"] = seed_of(ctx.seed, 12) % 2 ** 31
    trainer = MultiTaskTrainer(prof, "portbench", work / "ckpt")
    ctx.check_widths(trainer.probe.backbone.cfg)
    files = _Files(trainer.train_loader, written)

    tasks = list(trainer.tasks)
    module = trainer.probe.backbone.module
    heads = {f"heads.{task}.{n}": p
             for task, clf in trainer.probe.classifiers.items()
             for n, p in clf.named_parameters()}
    prog = {f"vision.{n}": p for n, p in module.named_parameters()}
    prog.update(heads)
    W = draw([(n, tuple(p.shape)) for n, p in prog.items()], torch.float32,
             dev, ctx.seed, torch)
    with torch.no_grad():
        for n, p in prog.items():
            p.copy_(W[n])
    dseed = seed_of(ctx.seed, 13)
    trainer.generator.manual_seed(dseed)
    # the program's names of the trained leaves, in the reference's terms
    by_ref = {("vision." + n[len("backbone."):]) if
              n.startswith("backbone.") else n: p
              for n, p in trainer.params.items()}

    feed = _Feed(trainer.train_loader)
    labels, loaded, losses, g1 = [], [], [], None
    b1 = 0.9
    for s in range(t["check_steps"]):
        batch = feed.next()
        labels.append(_labels(batch.targets, tasks))
        loaded.append(_u8(batch.inputs))
        out = trainer.train_batch(batch)
        trainer.after_train_batch(out, batch)
        losses.append(sum(trainer.current_task_weights[k] * v
                          for k, v in out.items()))
        if s == 0:
            # AdamW's first moment after one step is (1 - b1) g; a leaf
            # the step left without state reads a zero gradient
            state = trainer.optimizer.state
            g1 = {n: state[p]["exp_avg"] / (1 - b1) if "exp_avg" in
                  state.get(p, {}) else torch.zeros_like(p)
                  for n, p in by_ref.items()}
    after = {n: p.detach().clone() for n, p in by_ref.items()}
    with torch.no_grad():
        # tower leaves outside the program's trained set that moved
        moved = sorted(n for n, p in prog.items()
                       if n not in by_ref and not torch.equal(p, W[n]))
    rows = [files.rows(k) for k in range(t["check_steps"])]
    ctx.synchronize()

    steps, failed = window(ctx, lambda: feed.next(),
                           lambda b: _train(trainer, b))
    setup_s = steps["setup_s"]
    dtr = None
    if ctx.trace:
        dtr = tr.DeviceTrace(torch, SPANS)
        dtr.start()
        for _ in range(t["trace_steps"]):
            batch = tr.record(torch, SPANS[0], feed.next)()
            tr.record(torch, SPANS[1], _train)(trainer, batch)
        dtr.stop()
    memory_peak = ctx.memory_peak()
    feed.close()
    trained_prog = sorted(by_ref)
    del trainer, feed, module, prog, heads, by_ref
    ctx.free()

    checks = check(ctx, W, rows, labels, loaded, dseed, tasks, losses, g1, after,
                   trained_prog, moved, t)
    rec = {"kind": "probe", "mode": "multi", "window": steps,
           "batch": t["trainer"]["data"]["batch_size"], "widths": ctx.widths,
           "trace": dtr.read() if dtr is not None else None,
           "trace_steps": t["trace_steps"],
           "trained_blocks": int(t["trainer"]["model"]["backbone"]
                                 ["unfreeze_last_k"]),
           "patch_trained": bool(t["trainer"]["model"]["backbone"]
                                 .get("include_embeddings", True))}
    return {"setup_s": setup_s,
            "e2e": {"probe_images_per_s": steps["images"] /
                    steps["seconds"]},
            "record": rec, "attempted": steps["steps"], "failed": failed,
            "checks": checks, "memory_peak": memory_peak}


class _Files:
    """The file behind each row of each batch, in the order the loader
    reads them: its reads are watched (the weighted sampler's draw is the
    program's), and every file has to be one the benchmark wrote."""

    def __init__(self, loader, written: dict):
        self.paths = [str(p) for p in loader.dataset.image_paths()]
        ours = {str(p) for ps in written.values() for p in ps}
        strange = [p for p in self.paths if p not in ours]
        if strange:
            raise RuntimeError(f"the loader reads files the benchmark did "
                               f"not write: {strange[:3]}")
        self.reads = []
        load = loader._load

        def watched(idxs):
            self.reads.append(list(idxs))
            return load(idxs)
        loader._load = watched

    def rows(self, k: int) -> list:
        """The files of the ``k``-th batch loaded."""
        return [self.paths[i] for i in self.reads[k]]


def _train(trainer, batch) -> bool:
    """One step; whether every task's loss was finite."""
    out = trainer.train_batch(batch)
    trainer.after_train_batch(out, batch)
    return all(np.isfinite(v) for v in out.values())


def check(ctx, W, rows, labels, loaded, dseed, tasks, losses, g1, after,
          trained_prog, moved, t) -> list:
    """The reference follows the checked steps from the same weights,
    files, augmentation draws and dropout stream: each step's loss (the
    worst step's relative gap), the first gradient by the worst leaf and
    the change after the last step by the worst leaf, each a gap of norms
    over the larger of the leaf's reference norm and the median leaf's. A
    leaf whose reference gradient is under a thousandth of the median
    leaf's is left out: round-off alone moves it. ``trained_leaves``
    counts the leaves the program trains that the profile does not, or
    the other way round, and the tower leaves outside its trained set that
    moved. ``loader_rows`` counts the rows of the checked batches whose
    pixels, as the program's loader gave them, differ from the reference's
    own decode and augmentation: the data stage, held by itself. With
    ``ctx.controls``, the reference in a lower precision
    (``"tf32"``) or with half of each batch left out (``"half_batch"``,
    the mean over the rest) stands in for the program, and its numbers go
    to ``ctx.readings``."""
    torch = ctx.torch
    from PIL import Image

    from portbench.reference import probe as ref
    from portbench.reference.augment import Augment
    from portbench.reference.precision import Precision, strict_fp32

    strict_fp32()
    prof, w = t["trainer"], ctx.widths
    trained = trained_names(w, prof)
    head_names = sorted(n for n in W if n.startswith("heads."))
    names = sorted(set(trained) | set(head_names))
    lr, blr = float(prof["train"]["lr"]), float(prof["train"]["backbone_lr"])
    lrs = {n: lr for n in head_names}
    lrs.update({n: blr for n in trained})
    keep = 1.0 - float(prof["model"]["dropout_p"])
    bs = len(rows[0])
    masks = ref.dropout_masks(dseed, len(rows), tasks, bs,
                              w["vision"]["hidden"], keep, ctx.device)
    aug = Augment(seed_of(ctx.seed, 12) % 2 ** 31) if \
        prof["data"].get("use_augmentation", True) else None

    def image(path):
        img = Image.open(path).convert("RGB")
        return np.asarray(aug(img) if aug else img, np.uint8)

    ours = [np.stack([image(p) for p in files]) for files in rows]
    differ = sum(int(not np.array_equal(a, b)) for o, got in
                 zip(ours, loaded) for a, b in zip(o, got))
    dev_batches = [(torch.from_numpy(u8).to(ctx.device),
                    {k: torch.tensor(v, device=ctx.device)
                     for k, v in ys.items()})
                   for u8, ys in zip(ours, labels)]

    def follow(mode="fp32", rows=bs):
        tower = {n: (W[n].clone() if n in trained else W[n])
                 for n in W if n.startswith("vision.")}
        heads = {n: W[n].clone() for n in head_names}
        bt = [(u8[:rows], {k: v[:rows] for k, v in ys.items()})
              for u8, ys in dev_batches]
        mk = [{k: v[:rows] for k, v in m.items()} for m in masks]
        return ref.train(Precision(mode), tower, heads, trained, lrs,
                         float(prof["train"]["weight_decay"]), w,
                         w["image_mean"], w["image_std"], bt, mk, tasks,
                         keep, t["check_rows_per_block"])

    out = follow()
    odd = sorted(set(names) ^ set(trained_prog)) + moved
    g_ref = {n: float(out["first_grads"][n].norm()) for n in names}
    gmed = float(np.median(list(g_ref.values())))
    counted = [n for n in names if g_ref[n] >= 1e-3 * gmed]

    def gap(prog, refd):
        """(the worst leaf's gap, that leaf)"""
        norms = {n: float(refd[n].norm()) for n in counted}
        med = float(np.median(list(norms.values())))
        return max((abs((float(prog[n].norm()) if n in prog else 0.0) -
                        norms[n]) / max(norms[n], med), n) for n in counted)

    def numbers(p_losses, p_g1, p_after):
        """{number: (value, where)}"""
        steps = [(abs(a - b) / abs(b), f"step {i + 1}") for i, (a, b) in
                 enumerate(zip(p_losses, out["losses"]))]
        return {"loss_gap": max(steps),
                "grad_gap": gap(p_g1, out["first_grads"]),
                "update_gap": gap({n: p_after[n] - W[n] for n in counted
                                   if n in p_after},
                                  {n: out["final"][n] - W[n]
                                   for n in counted})}

    for c in ctx.controls:
        o = follow(c) if c != "half_batch" else follow(rows=bs // 2)
        ctx.readings[c] = {k: v for k, (v, _) in numbers(
            o["losses"], o["first_grads"], o["final"]).items()}
    lim = ctx.limits
    checks = [{"name": k, "value": v, "limit": lim[k],
               "ok": bool(v <= lim[k]), "at": at}
              for k, (v, at) in numbers(losses, g1, after).items()]
    checks.append({"name": "trained_leaves", "value": len(odd),
                   "limit": lim["trained_leaves"],
                   "ok": len(odd) <= lim["trained_leaves"],
                   "at": ", ".join(odd[:4]) or None})
    checks.append({"name": "loader_rows", "value": differ,
                   "limit": lim["loader_rows"],
                   "ok": differ <= lim["loader_rows"]})
    return checks
