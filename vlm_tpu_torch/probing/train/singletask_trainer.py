"""Single-task probe trainer (``vlm_tpu/probing/train/singletask_trainer.py``).

- Class-weighted cross-entropy with ignore -1 (:func:`masked_cross_entropy`);
- **feature cache** while the backbone is fully frozen: the dataset goes
  once through the tower (B4 and B1 under ``inference_mode``) into
  ``probing/linear_probing/features/<model>_<quant>_<task>[_<size>][_vq]/
  <split>_features.npz`` under the project root, and only the head trains
  on the cached features; an npz written by ``vlm_tpu`` (keys x | features
  | feats and y | labels) loads as it is;
- **end to end** when layers are unfrozen: each step runs the tower with
  autograd (B1's differentiable form) and AdamW takes two param groups,
  the head at ``lr`` and the unfrozen backbone at ``backbone_lr``, frozen
  parameters left out (optax's ``set_to_zero``). AdamW is ``optax.adamw``'s:
  b1 0.9, b2 0.999, eps 1e-8, decoupled ``weight_decay``; a trainable
  parameter that receives no gradient gets a zero one, so its moments and
  its decay move as optax moves every leaf;
- **LoRA** (``model.lora.enabled``, :mod:`..lora`): adapters on the last
  blocks' Denses of the frozen tower, merged functionally each step; the
  feature cache is off (the features change as the adapters train), the
  adapters take a third group at ``lora.lr`` (else ``lr``), and the
  checkpoint holds them under ``lora.``;
- under a mesh (``mesh:``, :mod:`.base_trainer`): the cache is extracted
  on every rank (each its rows, the features all-gathered), written by
  rank 0 and read back by every rank after a barrier; a step takes this
  data rank's rows of a batch that splits over ``data`` and the global
  loss, a ragged tail whole.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ...core.config import project_root
from ...data.augment import train_augmentation
from ...data.dataset_factory import DatasetFactory
from ...models.base_model import resolve_quantize_vision
from ...models.factory import create_model
from ..lora import (load_lora_tensors, lora_features, lora_lr, lora_named,
                    resolve_lora)
from ..probes import LinearProbe
from ...parallel.sharding import shard_batch_if_divisible
from .base_trainer import BaseTrainer
from .data import ArrayBatchLoader, ImageBatchLoader
from .utils import (counts_to_weights, get_num_classes_for_task,
                    masked_cross_entropy, targets_to_arrays)


class SingleTaskTrainer(BaseTrainer):
    def __init__(self, cfg: dict, run_name: str, ckpt_root: Path):
        self.task = str(cfg["task"]).lower()
        self.use_feature_cache = False
        self.features_dir: Optional[Path] = None
        self.extract_stats = {"images": 0, "seconds": 0.0}
        super().__init__(cfg, run_name, ckpt_root)

    # ------------ probe ------------
    def build_probe(self):
        mcfg = self.cfg["model"]
        bb_cfg = mcfg.get("backbone") or {}
        freeze_flag = bool(bb_cfg.get("freeze", True))
        unfreeze_k = int(bb_cfg.get("unfreeze_last_k", 0))
        # resolved here and written back, so head_config.yaml records the
        # tower the features and the head were trained with
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
        self.probe = LinearProbe(
            backbone=backbone,
            n_out_classes=get_num_classes_for_task(self.task),
            freeze_backbone=freeze_flag,
            dropout_p=float(mcfg.get("dropout_p", 0.3)),
            deeper_head=bool(mcfg.get("deeper_head", False)),
            hidden_dim=int(mcfg.get("hidden_dim", 512)), seed=self.seed)
        if freeze_flag and unfreeze_k > 0:
            self.probe.unfreeze_last_backbone_k_layers(
                k=unfreeze_k,
                parts=str(bb_cfg.get("unfreeze_parts", "all")),
                include_embeddings=bool(bb_cfg.get("include_embeddings",
                                                   True)))
        self.lora_spec, self.lora = resolve_lora(mcfg, backbone, self.seed)
        self.features = lora_features(backbone, self.lora_spec, self.lora)
        # the dropout masks' generator, on the probe's device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)

    # ------------ data ------------
    def build_data(self):
        dcfg = self.cfg["data"]
        base_path = dcfg.get("base_path", None)
        batch_size = int(dcfg.get("batch_size", 64))
        n_classes = get_num_classes_for_task(self.task)
        transform = train_augmentation(self.seed) \
            if bool(dcfg.get("use_augmentation", False)) else None
        train_ds, agg_counts = DatasetFactory.create_multi_task_dataset(
            tasks=[self.task], split="train", base_path=base_path,
            transform=transform, num_classes={self.task: n_classes})
        val_ds, _ = DatasetFactory.create_multi_task_dataset(
            tasks=[self.task], split="val", base_path=base_path,
            transform=None, num_classes={self.task: n_classes})

        counts = agg_counts.get(self.task)
        w = np.ones(n_classes) if counts is None else \
            counts_to_weights(np.asarray(counts, dtype=np.float64))
        self.class_weights = torch.tensor(w, dtype=torch.float32,
                                          device=self.device)
        print(f"Class weights: {np.asarray(w)}")

        # LoRA changes the features as it trains: no cache, though the
        # base weights are all frozen
        self.use_feature_cache = self.probe.fully_frozen and \
            not self.lora_spec
        print(f"[Trainer] Feature cache for probing: "
              f"{'ENABLED' if self.use_feature_cache else 'DISABLED'} "
              f"(backbone fully frozen: {self.probe.fully_frozen})")
        if self.use_feature_cache:
            mcfg = self.cfg["model"]
            # another size, or a quantized tower, never shares a cache
            size_tag = f"_{mcfg['size']}" if mcfg.get("size") else ""
            vq_tag = "_vq" if mcfg.get("quantize_vision") else ""
            self.features_dir = (
                project_root() / "probing" / "linear_probing" / "features" /
                f"{mcfg['name']}_{mcfg.get('quantization')}_{self.task}"
                f"{size_tag}{vq_tag}")
            self.features_dir.mkdir(parents=True, exist_ok=True)
            xtr, ytr = self._ensure_features(train_ds, "train")
            xva, yva = self._ensure_features(val_ds, "val")
            self.train_loader = ArrayBatchLoader(
                xtr, ytr, batch_size, shuffle=True, seed=self.seed)
            self.val_loader = ArrayBatchLoader(xva, yva, batch_size)
        else:
            self.train_loader = ImageBatchLoader(
                train_ds, batch_size, shuffle=True, seed=self.seed)
            self.val_loader = ImageBatchLoader(val_ds, batch_size)

    def _ensure_features(self, img_ds, split: str):
        """Load the split's cached features, or extract and save them."""
        fpath = self.features_dir / f"{split}_features.npz"
        backbone = self.probe.backbone
        exists = fpath.exists() if self.mesh is None else \
            self.mesh.any(fpath.exists())
        if exists:
            blob = np.load(fpath)
            x_key = next((k for k in ("x", "features", "feats")
                          if k in blob), None)
            y_key = next((k for k in ("y", "labels") if k in blob), None)
            if x_key is None or y_key is None:
                raise KeyError(
                    f"Unrecognized feature cache keys: {list(blob.keys())}")
            feats = blob[x_key]
            if feats.shape[-1] != backbone.output_dim:
                raise ValueError(
                    f"stale feature cache {fpath}: dim {feats.shape[-1]} != "
                    f"backbone dim {backbone.output_dim}; delete it to "
                    f"re-extract")
            return feats, blob[y_key].astype(np.int64)
        t0 = time.perf_counter()
        if any(getattr(d, "transform", None) is not None
               for d in getattr(img_ds, "datasets", [img_ds])):
            # an augmented dataset extracts through __getitem__, so its
            # one-shot transform is baked into the cached features
            bs = backbone.batch_size
            parts = []
            with torch.inference_mode():
                for start in range(0, len(img_ds), bs):
                    images = [img_ds[i][0] for i in
                              range(start, min(start + bs, len(img_ds)))]
                    n = len(images)
                    images += [images[-1]] * (bs - n)
                    parts.append(backbone.forward(images)[:n])
            feats = torch.cat(parts).float().cpu().numpy()
        else:
            feats = backbone.extract_features_dataset(img_ds.image_paths())
        self.extract_stats["images"] += len(feats)
        self.extract_stats["seconds"] += time.perf_counter() - t0
        ys = targets_to_arrays(img_ds.labels_list(), [self.task])[self.task]
        if self.writer:
            np.savez(fpath, x=feats, y=ys)
        if self.mesh is None:
            return feats, ys
        self.sync()
        blob = np.load(fpath)
        return blob["x"], blob["y"]

    # ------------ optimizer ------------
    def build_optimizer(self):
        tcfg = self.cfg.get("train", {})
        self.head_lr = float(tcfg.get("lr", 1e-4))
        self.backbone_lr = float(tcfg.get("backbone_lr", self.head_lr))
        self.weight_decay = float(tcfg.get("weight_decay", 1e-4))
        bb = {} if self.use_feature_cache else {
            f"backbone.{n}": p for n, p in
            self.probe.backbone.module.named_parameters() if p.requires_grad}
        self.make_adamw([
            ({f"head.{n}": p for n, p in
              self.probe.classifier.named_parameters()}, self.head_lr),
            (bb, self.backbone_lr),
            (lora_named(self.lora) if self.lora_spec else {},
             lora_lr(self.lora_spec, self.head_lr))])

    # ------------ per batch ------------
    def loss(self, batch, train: bool) -> torch.Tensor:
        """The batch's loss (:func:`probe_loss`) with the trainer's class
        weights and dropout generator; under a mesh this data rank's rows
        of a batch that splits (the global batch's loss)."""
        inputs, targets = batch
        y = np.asarray(targets) if self.use_feature_cache else \
            targets_to_arrays(targets, [self.task])[self.task]
        mesh = self.data_mesh(len(y))
        inputs, y = shard_batch_if_divisible((inputs, y), mesh)
        return probe_loss(self.probe, inputs, y, self.class_weights,
                          train=train, generator=self.generator,
                          cached=self.use_feature_cache,
                          features=self.features, mesh=mesh)

    def train_batch(self, batch) -> Dict[str, float]:
        loss = self.loss(batch, train=True)
        self.apply_gradients(loss, self.data_mesh(len(list(batch)[1])))
        return {self.task: float(loss.detach())}

    def eval_batch(self, batch) -> Dict[str, float]:
        with torch.no_grad():
            return {self.task: float(self.loss(batch, train=False))}

    # ------------ state ------------
    def _saves_backbone(self) -> bool:
        return not self.use_feature_cache and not self.probe.fully_frozen

    def model_state(self) -> Dict[str, torch.Tensor]:
        state = self.probe.state_tensors(self._saves_backbone())
        if self.lora_spec:
            state.update({k: v.detach() for k, v in
                          lora_named(self.lora).items()})
        return state

    def load_model_state(self, blob: Dict[str, torch.Tensor]):
        self.probe.load_state_tensors(blob, not self.use_feature_cache)
        if self.lora_spec:
            load_lora_tensors(self.lora, blob)

    def run_meta(self) -> dict:
        meta = super().run_meta()
        mcfg = self.cfg["model"]
        bb_cfg = mcfg.get("backbone") or {}
        meta.update({
            "trainer": "single_task",
            "task": self.task,
            "feature_cache": bool(self.use_feature_cache),
            "sampler": "none",
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


def probe_loss(probe: LinearProbe, inputs, y, class_weights: torch.Tensor,
               *, train: bool, generator: Optional[torch.Generator] = None,
               cached: bool = False, features: Optional[Callable] = None,
               mesh=None) -> torch.Tensor:
    """The masked, class-weighted cross-entropy of ``probe`` on ``inputs``:
    cached features (``cached``), or images through the backbone (B4, then
    the tower: with autograd where it trains; ``features``, LoRA's merged
    tower, in place of ``probe.features_fn``). ``train`` puts the head in
    training mode: its BatchNorm moves its statistics and dropout draws
    from ``generator``. ``mesh``: ``inputs`` and ``y`` are this data rank's
    rows, and the heads and the loss see the whole batch (:mod:`..heads`,
    :func:`.utils.masked_cross_entropy`)."""
    clf = probe.classifier
    clf.train(train)
    device = probe.backbone.device
    if cached:
        feats = torch.as_tensor(np.asarray(inputs)).to(device, torch.float32)
    else:
        feats = (features or probe.features_fn)(
            probe.backbone.to_pixels(inputs))
    logits = clf(feats, generator=generator, mesh=mesh)
    return masked_cross_entropy(
        logits, torch.as_tensor(np.asarray(y), dtype=torch.int64,
                                device=device), class_weights, mesh)
