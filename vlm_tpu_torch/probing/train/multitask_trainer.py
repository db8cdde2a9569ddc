"""Multi-task probe trainer (``vlm_tpu/probing/train/multitask_trainer.py``).

- the training set is balanced by duplication: the reference hard-codes
  ``desired_fractions={"emotion": 0.33}`` (multitask_trainer.py:117-124);
  class weights come from the base (pre-duplication) counts;
- per-task masked cross-entropy, 0.0 with its gradient on a batch without
  the task's labels; unweighted with the per-sample weighted sampler
  (``data.use_sampler``), else class-weighted;
- the step's total is ``sum_t w_t * L_t`` with the epoch's task weights:
  the inverse loss EMA normalised to mean 1, the static
  ``train.task_weights`` while a task's EMA is unset; or, with
  ``train.uncertainty_weighting.enabled``, Kendall's weighting with
  learnable log-variances; the EMA moves per batch, only for tasks with a
  valid label and a finite loss;
- one tower pass a step feeds every head; a fully frozen tower (without
  LoRA) runs without autograd; there is no feature cache (``vlm_tpu``'s
  multi-task trainer has none);
- AdamW (``optax.adamw``'s settings, every group decays) in groups: the
  heads and the log-variances at ``lr``, the unfrozen tower at
  ``backbone_lr``, LoRA's adapters at ``lora.lr`` (else ``lr``);
- the checkpoint holds the heads (``heads.<task>.``), the tower's trainable
  parameters when it is not fully frozen, the adapters when LoRA is on;
  ``extra_state.json`` the EMA, the log-variances and the augmentation's
  generator, so a resumed run equals a straight one;
- under a mesh (:mod:`.base_trainer`) every rank draws the same global
  batch (the balanced dataset, the sampler and the augmentation from the
  shared seed) and keeps its data rank's rows of one that splits; each
  task's loss is the global batch's, so the EMA and the task weights are
  the same on every rank; the log-variances stay whole on every rank.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ...data.augment import train_augmentation
from ...data.dataset_factory import DatasetFactory
from ...models.base_model import resolve_quantize_vision
from ...models.factory import create_model
from ..lora import (load_lora_tensors, lora_features, lora_lr, lora_named,
                    resolve_lora)
from ..probes import MultiTaskProbe
from ...parallel.sharding import shard_batch_if_divisible
from .base_trainer import BaseTrainer
from .data import Batch, ImageBatchLoader
from .losses import RunningMeans, UncertaintyWeighter
from .utils import (build_weighted_sampler, counts_to_weights,
                    get_num_classes_for_task, masked_cross_entropy,
                    targets_to_arrays)

#: the reference's fixed balancing of the training set
DESIRED_FRACTIONS = {"emotion": 0.33}


class MultiTaskTrainer(BaseTrainer):
    def __init__(self, cfg: dict, run_name: str, ckpt_root: Path):
        self.tasks = [t.lower() for t in cfg["tasks"]]
        tcfg = cfg["train"]
        rm_cfg = tcfg.get("running_means") or {}
        self.use_running_means = bool(rm_cfg.get("enabled", True))
        self.rm_alpha = float(rm_cfg.get("alpha", 0.95))
        tw_cfg = tcfg.get("task_weights") or {}
        self.static_task_weights = {t: float(tw_cfg.get(t, 1.0))
                                    for t in self.tasks}
        self.current_task_weights = {t: 1.0 for t in self.tasks}
        uw_cfg = tcfg.get("uncertainty_weighting") or {}
        self.use_uw = bool(uw_cfg.get("enabled", False))
        self.uw_init_log_var = float(uw_cfg.get("init_log_var", 0.0))
        self.augment = None
        super().__init__(cfg, run_name, ckpt_root)
        if self.use_running_means:
            self.rm = RunningMeans(self.tasks, alpha=self.rm_alpha)

    # ------------ probe ------------
    def build_probe(self):
        mcfg = self.cfg["model"]
        bb_cfg = mcfg.get("backbone") or {}
        freeze_flag = bool(bb_cfg.get("freeze", True))
        unfreeze_k = int(bb_cfg.get("unfreeze_last_k", 0))
        mcfg["quantize_vision"] = resolve_quantize_vision(
            mcfg.get("quantize_vision"))
        vlm = create_model(
            mcfg["name"], model_id=mcfg.get("model_id"),
            quantization=mcfg.get("quantization") or "fp32",
            size=mcfg.get("size"), mesh=self.cfg.get("mesh"),
            quantize_vision=mcfg["quantize_vision"])
        backbone = vlm.get_vision_backbone()
        del vlm
        self.device = backbone.device
        self.mesh = backbone.mesh
        self.probe = MultiTaskProbe(
            backbone=backbone,
            tasks={t: get_num_classes_for_task(t) for t in self.tasks},
            freeze_backbone=freeze_flag,
            dropout_p=float(mcfg.get("dropout_p", 0.3)),
            deeper_heads=bool(mcfg.get("deeper_head", False)),
            hidden_dim=int(mcfg.get("hidden_dim", 512)), seed=self.seed)
        if freeze_flag and unfreeze_k > 0:
            self.probe.unfreeze_last_backbone_k_layers(
                k=unfreeze_k,
                parts=str(bb_cfg.get("unfreeze_parts", "all")),
                include_embeddings=bool(bb_cfg.get("include_embeddings",
                                                   True)))
        self.lora_spec, self.lora = resolve_lora(mcfg, backbone, self.seed)
        self.features = lora_features(backbone, self.lora_spec, self.lora)
        self.log_vars = UncertaintyWeighter(
            self.tasks, self.uw_init_log_var).init_params(self.device) \
            if self.use_uw else {}
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)

    # ------------ data ------------
    def build_data(self):
        dcfg = self.cfg["data"]
        base_path = dcfg.get("base_path", None)
        batch_size = int(dcfg.get("batch_size", 64))
        self.use_sampler = bool(dcfg.get("use_sampler", True))
        n_classes = {t: get_num_classes_for_task(t) for t in self.tasks}
        if bool(dcfg.get("use_augmentation", True)):
            self.augment = train_augmentation(self.seed)
        train_ds, agg_counts = \
            DatasetFactory.create_balanced_multi_task_dataset(
                tasks=self.tasks, split="train", base_path=base_path,
                transform=self.augment, num_classes=n_classes,
                desired_fractions=DESIRED_FRACTIONS, random_seed=self.seed)
        val_ds, _ = DatasetFactory.create_multi_task_dataset(
            tasks=self.tasks, split="val", base_path=base_path,
            transform=None, num_classes=n_classes)

        self.class_weights = {}
        for t in self.tasks:
            counts = agg_counts.get(t)
            w = np.ones(n_classes[t]) if counts is None else \
                counts_to_weights(np.asarray(counts, dtype=np.float64))
            self.class_weights[t] = torch.tensor(w, dtype=torch.float32,
                                                 device=self.device)
        print("Class weights:", {t: w.cpu().numpy()
                                 for t, w in self.class_weights.items()})

        sampler = None
        if self.use_sampler:
            # the sampler balances; the cross-entropy goes unweighted
            self.ce_weights = {t: None for t in self.tasks}
            sampler, _ = build_weighted_sampler(
                train_ds, {t: w.cpu().numpy()
                           for t, w in self.class_weights.items()},
                combine="mean", min_weight=1e-4, normalize=True,
                replacement=True, seed=self.seed)
        else:
            self.ce_weights = dict(self.class_weights)
        self.train_loader = ImageBatchLoader(
            train_ds, batch_size, shuffle=sampler is None, sampler=sampler,
            seed=self.seed)
        self.val_loader = ImageBatchLoader(val_ds, batch_size)

    # ------------ optimizer ------------
    def build_optimizer(self):
        tcfg = self.cfg["train"]
        self.head_lr = float(tcfg.get("lr", 1e-4))
        self.backbone_lr = float(tcfg.get("backbone_lr", self.head_lr))
        self.weight_decay = float(tcfg.get("weight_decay", 1e-4))
        heads = {f"heads.{t}.{n}": p
                 for t, clf in self.probe.classifiers.items()
                 for n, p in clf.named_parameters()}
        heads.update({f"log_vars.{t}": v for t, v in self.log_vars.items()})
        self.make_adamw([
            (heads, self.head_lr),
            ({f"backbone.{n}": p for n, p in
              self.probe.backbone.module.named_parameters()
              if p.requires_grad}, self.backbone_lr),
            (lora_named(self.lora) if self.lora_spec else {},
             lora_lr(self.lora_spec, self.head_lr))])

    # ------------ task weights ------------
    def _compute_task_weights(self) -> Dict[str, float]:
        """Inverse EMA, normalised to mean 1; a task whose EMA is unset
        (epoch 1) takes its static weight as it is (reference
        multitask_trainer.py:209-225)."""
        if not self.use_running_means or self.rm is None:
            return dict(self.static_task_weights)
        raw = []
        for idx, t in enumerate(self.tasks):
            m = self.rm.get_by_index(idx)
            raw.append(self.static_task_weights.get(t, 1.0) if m is None
                       else 1.0 / max(float(m), 1e-8))
        avg = sum(raw) / max(1, len(raw))
        return {t: raw[i] / avg for i, t in enumerate(self.tasks)}

    def on_train_epoch_start(self, epoch: int, epochs: int):
        self.current_task_weights = self._compute_task_weights()
        print(f"[Weights][Epoch {epoch + 1}] " + " | ".join(
            f"{k}={v:.3f}" for k, v in self.current_task_weights.items()))

    def after_train_batch(self, loss_dict: Dict[str, float], batch):
        """The EMA moves for tasks with a valid label in the batch and a
        finite loss (reference multitask_trainer.py:248-263)."""
        if not (self.use_running_means and self.rm is not None):
            return
        counts = batch.valid_counts(self.tasks) \
            if isinstance(batch, Batch) else {}
        for idx, t in enumerate(self.tasks):
            if counts.get(t, 0) > 0 and np.isfinite(loss_dict[t]):
                self.rm.update_by_idx(float(loss_dict[t]), idx)

    # ------------ per batch ------------
    def losses(self, batch, train: bool) -> Dict[str, torch.Tensor]:
        """Each task's masked cross-entropy (:func:`multitask_losses`)
        with the trainer's weights, adapters and dropout generator."""
        images, targets = batch
        mesh = self.data_mesh(len(targets))
        images, ys = shard_batch_if_divisible(
            (images, targets_to_arrays(targets, self.tasks)), mesh)
        return multitask_losses(
            self.probe, images, ys, self.ce_weights, train=train,
            generator=self.generator if train else None,
            features=self.features, tower_grad=not (
                self.probe.fully_frozen and not self.lora_spec), mesh=mesh)

    def total_loss(self, losses: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.use_uw:
            return UncertaintyWeighter.combine(self.log_vars, losses)
        total = 0.0
        for t in self.tasks:
            total = total + self.current_task_weights[t] * losses[t]
        return total

    def train_batch(self, batch) -> Dict[str, float]:
        losses = self.losses(batch, train=True)
        self.apply_gradients(self.total_loss(losses),
                             self.data_mesh(len(list(batch)[1])))
        return {t: float(v.detach()) for t, v in losses.items()}

    def eval_batch(self, batch) -> Dict[str, float]:
        with torch.no_grad():
            return {t: float(v) for t, v in
                    self.losses(batch, train=False).items()}

    # ------------ state ------------
    def model_state(self) -> Dict[str, torch.Tensor]:
        # the tower only when it trains: frozen (LoRA too), it is the
        # model's own weights
        state = self.probe.state_tensors(not self.probe.fully_frozen)
        if self.lora_spec:
            state.update({k: v.detach() for k, v in
                          lora_named(self.lora).items()})
        return state

    def load_model_state(self, blob: Dict[str, torch.Tensor]):
        self.probe.load_state_tensors(blob)
        if self.lora_spec:
            load_lora_tensors(self.lora, blob)

    def extra_state_dicts(self) -> dict:
        blob = {}
        if self.rm is not None:
            blob["running_means"] = {"alpha": self.rm.alpha,
                                     "values": self.rm.values,
                                     "history": self.rm.history,
                                     "tasks": self.tasks}
        if self.use_uw:
            blob["uw_log_vars"] = {t: float(v.detach())
                                   for t, v in self.log_vars.items()}
        if self.augment is not None:
            blob["augmentation_rng"] = self.augment.transforms[0] \
                .rng.getstate()
        return blob

    def load_extra_state_dicts(self, blob: dict):
        rm_blob = blob.get("running_means")
        if self.rm is not None and rm_blob:
            self.rm.alpha = float(rm_blob.get("alpha", self.rm.alpha))
            self.rm.values = dict(rm_blob.get("values", self.rm.values))
            self.rm.history = dict(rm_blob.get("history", self.rm.history))
        uw_blob = blob.get("uw_log_vars")
        if self.use_uw and uw_blob:
            with torch.no_grad():
                for t, v in uw_blob.items():
                    self.log_vars[t].fill_(float(v))
        rng_state = blob.get("augmentation_rng")
        if self.augment is not None and rng_state:
            version, state, gauss = rng_state
            self.augment.transforms[0].rng.setstate(
                (version, tuple(state), gauss))

    def run_meta(self) -> dict:
        meta = super().run_meta()
        mcfg = self.cfg["model"]
        bb_cfg = mcfg.get("backbone") or {}
        meta.update({
            "trainer": "multi_task",
            "tasks": self.tasks,
            "running_means": self.rm is not None,
            "backbone": {
                "freeze": bool(bb_cfg.get("freeze",
                                          mcfg.get("freeze_backbone", True))),
                "unfreeze_last_k": int(bb_cfg.get("unfreeze_last_k", 0)),
                "unfreeze_parts": str(bb_cfg.get("unfreeze_parts", "all")),
                "include_embeddings": bool(bb_cfg.get("include_embeddings",
                                                      True)),
            },
        })
        return meta


def multitask_losses(probe: MultiTaskProbe, images, ys: Dict[str, np.ndarray],
                     ce_weights: Dict[str, Optional[torch.Tensor]], *,
                     train: bool, generator: Optional[torch.Generator] = None,
                     features: Optional[Callable] = None,
                     tower_grad: bool = True,
                     mesh=None) -> Dict[str, torch.Tensor]:
    """Each task's masked cross-entropy on one tower pass (B4, then the
    tower: ``features``, LoRA's merged tower, in place of
    ``probe.features_fn``; without autograd unless ``tower_grad``) feeding
    every head. ``train`` puts the heads in training mode: BatchNorm
    statistics move, dropout draws from ``generator``. ``mesh``: ``images``
    and ``ys`` are this data rank's rows; the heads and the losses see the
    whole batch."""
    pixels = probe.backbone.to_pixels(images)
    with torch.set_grad_enabled(tower_grad and torch.is_grad_enabled()):
        feats = (features or probe.features_fn)(pixels)
    probe.train_heads(train)
    logits = probe.apply_heads(feats, generator=generator, mesh=mesh)
    device = probe.backbone.device
    return {t: masked_cross_entropy(
        logits[t], torch.as_tensor(np.asarray(ys[t]), dtype=torch.int64,
                                   device=device), ce_weights.get(t), mesh)
        for t in probe.classifiers}
