"""Probe-training loop (``vlm_tpu/probing/train/base_trainer.py``):
best-only checkpoints, early stopping, resume, the history artifacts.

- ReduceLROnPlateau on the host (mode min, patience = early-stop patience
  // 2, relative threshold): ``lr_scale`` multiplies every param group's
  base LR in place, so AdamW keeps its moments; it survives resume;
- checkpoints in the port's format (:mod:`.utils`), a
  ``head_config.yaml`` snapshot for the testers, ``history.csv`` and
  ``loss_curve.png`` (drawn with Pillow);
- a resumed run draws the shuffles (or the sampler's draws) of the epochs
  it skips, so it sees the batches a straight run would;
- the hooks ``on_train_epoch_start``, ``after_train_batch``,
  ``extra_state_dicts`` and ``load_extra_state_dicts`` (the multi-task
  trainer's task weights and loss EMAs); the extra state is saved as
  ``extra_state.json`` beside the model file and restored with it.

``last_stats`` counts the training steps, their images and seconds (host
wall clock, each step ending in the loss's copy to the host).

Under a mesh (the backbone's) every rank runs this loop on the same
global batches; a subclass's step takes this data rank's rows of a batch
whose rows split over ``data``, and a ragged tail whole on every rank.
:meth:`backward` averages each trained tensor's gradient over ``data``
(after a split batch only) and sums a tensor fed by each model rank's
shard (LoRA's adapters) over ``model``, so every rank takes the
one-device step. The losses are the global batch's on every rank, so the epoch's
means, the scheduler and the saving decisions agree. The checkpoint (at
full shapes), the history and the plots are written by global rank 0
alone; the others wait at a barrier.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from ...core.mesh import DATA_AXIS, MODEL_AXIS
from ...parallel.sharding import param_specs, shard_tensor
from ..probes import full_tensor
from .utils import (EXTRA_FILE, GENERATOR_KEY, MODEL_FILE,
                    load_optimizer_tensors, load_tensors, optimizer_tensors,
                    refuse_msgpack, save_tensors, save_training_state,
                    set_seed, try_resume_training)


class BaseTrainer:
    """Subclasses implement ``build_probe`` (setting ``self.generator``, the
    dropout masks'), ``build_data``, ``build_optimizer`` (through
    :meth:`make_adamw`), ``train_batch(batch) -> {task: loss}``,
    ``eval_batch(batch) -> {task: loss}``, ``model_state`` and
    ``load_model_state``, and may take the optional hooks."""

    def __init__(self, cfg: dict, run_name: str, ckpt_root: Path):
        import yaml
        self.cfg = cfg
        self.run_name = run_name
        self.ckpt_dir = Path(ckpt_root) / run_name
        refuse_msgpack(self.ckpt_dir)
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)

        tcfg = cfg["train"]
        self.seed = int(tcfg.get("seed", 42))
        set_seed(self.seed)

        scfg = tcfg.get("scheduler", {}) or {}
        self.sched_factor = float(scfg.get("factor", 0.1))
        self.sched_threshold = float(scfg.get("threshold", 1e-4))
        es_patience = int(tcfg.get("patience", 5))
        self.sched_patience = max(1, es_patience // 2)
        self.lr_scale = 1.0
        self._sched_best = float("inf")
        self._sched_bad_epochs = 0
        self.last_stats = {"train_steps": 0, "train_images": 0,
                           "train_s": 0.0}
        self.rm = None    # a subclass may attach a RunningMeans
        self.mesh = None  # build_probe sets the backbone's

        self.build_probe()
        self.build_data()
        self.build_optimizer()

        self.model_file = self.ckpt_dir / MODEL_FILE
        if self.writer:
            (self.ckpt_dir / "head_config.yaml").write_text(
                yaml.safe_dump(self.cfg, sort_keys=False, allow_unicode=True),
                encoding="utf-8")
        self.sync()
        self.history: Dict[str, List[float]] = {"train": [], "val": []}

    # ----- subclass API -----
    def build_probe(self):
        raise NotImplementedError

    def build_data(self):
        raise NotImplementedError

    def build_optimizer(self):
        raise NotImplementedError

    def train_batch(self, batch) -> Dict[str, float]:
        raise NotImplementedError

    def eval_batch(self, batch) -> Dict[str, float]:
        raise NotImplementedError

    def model_state(self) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def load_model_state(self, blob: Dict[str, torch.Tensor]):
        raise NotImplementedError

    # ----- the mesh -----
    @property
    def writer(self) -> bool:
        """Whether this process writes the run's files: global rank 0, or
        the only process."""
        return self.mesh is None or self.mesh.rank == 0

    def sync(self) -> None:
        """Every rank waits here (after rank 0's writes)."""
        if self.mesh is not None:
            self.mesh.barrier()

    def data_mesh(self, rows: int):
        """The mesh when a batch of ``rows`` splits over its data axis
        (each rank then computes its rows), else None (one device, or a
        ragged tail computed whole on every rank)."""
        m = self.mesh
        return m if m is not None and m.data > 1 and rows % m.data == 0 \
            else None

    def model_partial(self, name: str) -> bool:
        """A trained tensor held whole on every model rank whose gradient
        each rank forms from its shard only (LoRA's adapters)."""
        return name.startswith("lora.")

    # ----- AdamW -----
    def make_adamw(self, groups) -> None:
        """``self.params`` (every trained tensor by its checkpoint name) and
        ``self.optimizer``: AdamW with ``optax.adamw``'s settings (b1 0.9,
        b2 0.999, eps 1e-8, decoupled ``self.weight_decay`` on every
        group), a param group for each non-empty ``(named tensors, base
        LR)`` of ``groups``."""
        self.params = {}
        param_groups = []
        for named, base_lr in groups:
            if named:
                self.params.update(named)
                param_groups.append({"params": list(named.values()),
                                     "base_lr": base_lr,
                                     "lr": base_lr * self.lr_scale})
        self.optimizer = torch.optim.AdamW(
            param_groups, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=self.weight_decay)
        #: the tensors split over the model axis, by name: their split dim
        self.split_dims = {}
        if self.mesh is not None and self.mesh.model > 1:
            specs = param_specs(self.probe.backbone.module)
            self.split_dims = {f"backbone.{n}": d for n, d in specs.items()
                               if d is not None and f"backbone.{n}" in
                               self.params}

    def apply_gradients(self, loss: torch.Tensor, mesh=None) -> None:
        """One AdamW step on ``loss``'s gradients (:meth:`backward`)."""
        self.backward(loss, mesh)
        self.optimizer.step()

    def backward(self, loss: torch.Tensor, mesh=None) -> None:
        """``loss``'s gradients as the step takes them; a trained tensor
        that receives none gets a zero one, so its moments and its decay
        move as optax moves every leaf. ``mesh`` (:meth:`data_mesh`): the
        batch was split over the data axis; every rank's loss is the
        global one, so each rank's gradients are ``data`` times its rows'
        share, and their mean over ``data`` is the one-device gradient."""
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in self.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.mesh is not None and self.mesh.model > 1:
            _reduce_grads([p for n, p in self.params.items()
                           if self.model_partial(n)], self.mesh, MODEL_AXIS)
        if mesh is not None:
            _reduce_grads(list(self.params.values()), mesh, DATA_AXIS,
                          mean=True)

    def on_lr_change(self):
        """Called after ``lr_scale`` changes: every group's LR in place
        (AdamW's moments do not depend on it)."""
        for g in self.optimizer.param_groups:
            g["lr"] = g["base_lr"] * self.lr_scale

    def opt_state(self) -> Dict[str, torch.Tensor]:
        """AdamW's state by parameter name (full shapes: a collective under
        a model axis), and the dropout generator's."""
        names = {p: n for n, p in self.params.items()}
        state = optimizer_tensors(self.optimizer, names)
        for key, t in state.items():
            name, _, leaf = key.rpartition(".")
            if leaf != "step":
                state[key] = full_tensor(self.mesh,
                                         self.split_dims.get(name), t)
        return {**state, GENERATOR_KEY: self.generator.get_state()}

    def load_opt_state(self, blob: Dict[str, torch.Tensor]):
        blob = dict(blob)
        for key, t in blob.items():
            name, _, leaf = key.rpartition(".")
            if leaf != "step" and name in self.split_dims:
                blob[key] = shard_tensor(self.probe.backbone.module,
                                         name[len("backbone."):], t)
        load_optimizer_tensors(self.optimizer, self.params, blob)
        if GENERATOR_KEY in blob:
            self.generator.set_state(blob[GENERATOR_KEY])

    # ----- optional hooks (reference base_trainer.py:86-93) -----
    def extra_state_dicts(self) -> dict:
        """JSON-able state saved beside the model file."""
        return {}

    def load_extra_state_dicts(self, blob: dict):
        pass

    def on_train_epoch_start(self, epoch: int, epochs: int):
        pass

    def after_train_batch(self, loss_dict: Dict[str, float], batch):
        pass

    @staticmethod
    def batch_valid_counts(loss_dict, batch) -> Dict[str, int]:
        """Per-task valid (label != -1) samples in the batch: the weights of
        the epoch's mean."""
        from .data import Batch
        if isinstance(batch, Batch):
            return batch.valid_counts(list(loss_dict))
        return {k: 1 for k in loss_dict}

    # ----- fit loop -----
    def fit(self):
        tcfg = self.cfg["train"]
        epochs = int(tcfg.get("epochs", 50))
        patience = int(tcfg.get("patience", 5))
        eval_every = int(tcfg.get("eval_every", 2))

        blob = load_tensors(self.model_file)
        if blob is not None:
            self.load_model_state(blob)
            extra = self.ckpt_dir / EXTRA_FILE
            if extra.exists():
                self.load_extra_state_dicts(
                    json.loads(extra.read_text(encoding="utf-8")))
            print(f"[RESUME] model weights loaded from {self.model_file}")
        opt_blob, start_epoch, best_val, lr_scale, plateau = \
            try_resume_training(self.ckpt_dir)
        if opt_blob is not None:
            self.load_opt_state(opt_blob)
        if lr_scale != self.lr_scale:
            self.lr_scale = lr_scale
            self.on_lr_change()
        self._sched_best = float(plateau.get("best", float("inf")))
        self._sched_bad_epochs = int(plateau.get("bad_epochs", 0))
        self.train_loader.skip_epochs(start_epoch)
        # every rank has read the checkpoint before rank 0's first save can
        # write one: a rank that reached this point late would otherwise
        # resume from this run's own epoch and skip that epoch's barrier
        self.sync()

        patience_left = patience
        for epoch in range(start_epoch, epochs):
            self.on_train_epoch_start(epoch, epochs)
            self.history["train"].append(
                self._run_epoch(epoch, epochs, train=True))
            if (epoch + 1) % eval_every:
                self.history["val"].append(
                    self.history["val"][-1] if self.history["val"]
                    else float("nan"))
                continue
            val_monitor = self._run_epoch(epoch, epochs, train=False)
            self.history["val"].append(val_monitor)
            self._scheduler_step(val_monitor)
            if val_monitor < best_val - 1e-8:
                best_val = val_monitor
                patience_left = patience
                self._save(epoch, best_val)
                print(f"[SAVE] improvement → {self.model_file} "
                      f"(monitor={val_monitor:.6f})")
            else:
                patience_left -= 1
                if patience_left <= 0:
                    print(f"[EARLY STOP] epoch {epoch + 1} (patience = "
                          f"{patience}). Best monitor: {best_val:.6f}")
                    break
        if self.writer:
            self._save_history_csv()
            self._save_history_plot()
        self.sync()

    def _save(self, epoch: int, best_val: float) -> None:
        """The best-so-far checkpoint: gathered on every rank, written by
        rank 0."""
        model, opt = self.model_state(), self.opt_state()
        extra = self.extra_state_dicts()
        if self.writer:
            save_tensors(self.model_file, model)
            (self.ckpt_dir / EXTRA_FILE).write_text(json.dumps(extra),
                                                    encoding="utf-8")
            save_training_state(
                self.ckpt_dir, opt, next_epoch=epoch + 1, best_val=best_val,
                meta=self.run_meta(),
                cfg_path=self.cfg.get("_cfg_path", "unknown"),
                lr_scale=self.lr_scale,
                plateau={"best": self._sched_best,
                         "bad_epochs": self._sched_bad_epochs})
        self.sync()

    def _run_epoch(self, epoch: int, epochs: int, train: bool) -> float:
        split = "train" if train else "val"
        running_sum: Dict[str, float] = {}
        running_n: Dict[str, int] = {}
        t0 = time.perf_counter()
        for batch in self.train_loader if train else self.val_loader:
            loss_dict = self.train_batch(batch) if train \
                else self.eval_batch(batch)
            if train:
                self.after_train_batch(loss_dict, batch)
                self.last_stats["train_steps"] += 1
                self.last_stats["train_images"] += len(batch.targets)
            counts = self.batch_valid_counts(loss_dict, batch)
            for k, v in loss_dict.items():
                n = counts.get(k, 1)
                if n <= 0 or not math.isfinite(float(v)):
                    continue
                running_sum[k] = running_sum.get(k, 0.0) + float(v) * n
                running_n[k] = running_n.get(k, 0) + n
        if train:
            self.last_stats["train_s"] += time.perf_counter() - t0
        return self._epoch_log(split, epoch, epochs, running_sum, running_n)

    @staticmethod
    def _epoch_log(split, epoch, epochs, running_sum, running_n) -> float:
        keys = sorted(running_sum)
        if not keys:
            print(f"[{split}] no aggregated losses")
            return float("inf")
        vals = [running_sum[k] / max(1, running_n[k]) for k in keys]
        logs = " | ".join(f"{k}: {v:.4f}" for k, v in zip(keys, vals))
        print(f"[{split.upper()} {epoch + 1}/{epochs}] {logs} | "
              f"monitor(mean)={float(np.mean(vals)):.6f}")
        return float(np.mean(vals))

    # ----- ReduceLROnPlateau -----
    def _scheduler_step(self, val_monitor: float):
        if val_monitor < self._sched_best * (1 - self.sched_threshold):
            self._sched_best = val_monitor
            self._sched_bad_epochs = 0
            return
        self._sched_bad_epochs += 1
        if self._sched_bad_epochs > self.sched_patience:
            self.lr_scale *= self.sched_factor
            self._sched_bad_epochs = 0
            print(f"[SCHED] plateau → lr_scale={self.lr_scale:.2e}")
            self.on_lr_change()

    # ----- artifacts -----
    def _save_history_csv(self):
        csv_path = self.ckpt_dir / "history.csv"
        with open(csv_path, "w", encoding="utf-8") as f:
            f.write("epoch,train_loss,val_loss\n")
            for i, (tr, va) in enumerate(zip(self.history["train"],
                                             self.history["val"]), start=1):
                tr_str = f"{tr:.6f}" if math.isfinite(tr) else ""
                va_str = f"{va:.6f}" if math.isfinite(va) else ""
                f.write(f"{i},{tr_str},{va_str}\n")
        print(f"[HISTORY] CSV saved: {csv_path}")
        if self.rm is not None:
            self.rm.save_history(self.ckpt_dir / "EMA_history.json")

    def _save_history_plot(self):
        out = self.ckpt_dir / "loss_curve.png"
        draw_loss_curve(self.history, self.run_name, out)
        print(f"[HISTORY] plot saved: {out}")

    def run_meta(self) -> dict:
        mcfg = self.cfg["model"]
        return {"model_name": mcfg["name"],
                "quantization": mcfg.get("quantization")}


def _reduce_grads(params, mesh, axis: str, mean: bool = False) -> None:
    """The gradients of ``params`` summed (``mean``: averaged) over
    ``axis``, in one all-reduce of their concatenation."""
    if not params or mesh.ways(axis) == 1:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    mesh.all_reduce(flat, axis)
    if mean:
        flat.div_(mesh.ways(axis))
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p.grad))


#: matplotlib's default colour cycle (tab10), which ``vlm_tpu``'s plots use
COLORS = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
          (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127))


def draw_loss_curve(history: Dict[str, List[float]], title: str,
                    path) -> None:
    """A 750 x 450 PNG of the train and val losses per epoch (``vlm_tpu``
    draws the same figure with matplotlib)."""
    draw_curves({"train": history["train"], "val": history["val"]}, path,
                title=title, xlabel="epoch", ylabel="loss", size=(750, 450),
                first_x=1)


def draw_curves(series: Dict[str, List[float]], path, *, title: str,
                xlabel: str, ylabel: str, size=(750, 450),
                first_x: int = 0) -> None:
    """A line plot drawn with Pillow: axes with ticks (x from ``first_x``),
    a light grid, one curve per series (non-finite points left out) in
    matplotlib's colours, and a legend."""
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.load_default()
    width, height = size
    img = Image.new("RGB", size, "white")
    draw = ImageDraw.Draw(img)
    left, top, right, bottom = 70, 40, width - 30, height - 60
    pts = [v for vals in series.values() for v in vals if math.isfinite(v)]
    n = max((len(v) for v in series.values()), default=1) or 1
    lo, hi = (min(pts), max(pts)) if pts else (0.0, 1.0)
    if hi - lo < 1e-12:
        lo, hi = lo - 0.5, hi + 0.5

    def xy(i, v):
        x = left + (right - left) * (i / max(n - 1, 1))
        return x, bottom - (bottom - top) * (v - lo) / (hi - lo)

    for frac in np.linspace(0.0, 1.0, 5):
        y = bottom - (bottom - top) * frac
        draw.line((left, y, right, y), fill=(225, 225, 225))
        draw.text((left - 6, y), f"{lo + (hi - lo) * frac:.4g}", anchor="rm",
                  font=font, fill="black")
    step = max(1, -(-n // 20))
    for i in range(0, n, step):
        x, _ = xy(i, lo)
        draw.line((x, bottom, x, bottom + 4), fill="black")
        draw.text((x, bottom + 6), str(i + first_x), anchor="mt", font=font,
                  fill="black")
    draw.rectangle((left, top, right, bottom), outline="black")
    for k, (name, vals) in enumerate(series.items()):
        color = COLORS[k % len(COLORS)]
        line = [xy(i, v) for i, v in enumerate(vals) if math.isfinite(v)]
        if len(line) > 1:
            draw.line(line, fill=color, width=2)
        for x, y in line:
            draw.ellipse((x - 2, y - 2, x + 2, y + 2), fill=color)
        ly = top + 12 + 16 * k
        draw.line((right - 110, ly, right - 90, ly), fill=color, width=2)
        draw.text((right - 84, ly), name, anchor="lm", font=font,
                  fill="black")
    draw.text(((left + right) / 2, 20), title, anchor="mm", font=font,
              fill="black")
    draw.text(((left + right) / 2, height - 20), xlabel, anchor="mm",
              font=font, fill="black")
    draw.text((10, (top + bottom) / 2), ylabel, anchor="lm", font=font,
              fill="black")
    img.save(path, format="PNG")
