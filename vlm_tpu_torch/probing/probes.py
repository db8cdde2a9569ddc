"""Probes (``vlm_tpu/probing/probes.py``): a frozen or partly unfrozen
vision backbone and classification heads.

- :class:`LinearProbe`: one head, ``forward(images) -> logits [B, C]``;
- :class:`MultiTaskProbe`: one head per task over the shared ``[B, D]``
  features, ``forward(images) -> {"logits": {task: [B, C]}}``;
- ``predict`` = argmax; ``extract_features`` runs the backbone without
  autograd while it is fully frozen (the reference's eval + no_grad
  switch).

Checkpoint tensors: ``head.<k>`` (one head) or ``heads.<task>.<k>``, and
the backbone's trainable parameters under ``backbone.``, at their full
shapes: under a mesh a tower split over the model axis gathers its
trained tensors to write them and takes its shard of them to load, so a
checkpoint is the one a single device writes and loads under either.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from ..core.mesh import MODEL_AXIS
from ..models.backbone import VisionBackbone
from ..parallel.sharding import param_specs, shard_tensor
from .heads import make_head


class BaseProbe:
    def __init__(self, backbone: VisionBackbone, freeze_backbone: bool = True):
        self.backbone = backbone
        self.backbone.set_freeze(freeze_backbone)

    @property
    def fully_frozen(self) -> bool:
        return self.backbone.fully_frozen

    def unfreeze_last_backbone_k_layers(self, k: int, parts: str = "all",
                                        include_embeddings: bool = True):
        self.backbone.unfreeze_last_k_layers(
            k=k, parts=parts, include_embeddings=include_embeddings)

    def set_freeze_backbone(self, freeze: bool):
        self.backbone.set_freeze(freeze)

    def extract_features(self, images) -> torch.Tensor:
        if self.fully_frozen:
            with torch.no_grad():
                return self.backbone.forward(images)
        return self.backbone.forward(images)

    def features_fn(self, pixels: torch.Tensor) -> torch.Tensor:
        """The differentiable path the end-to-end steps take."""
        return self.backbone.features(pixels)

    def backbone_tensors(self) -> Dict[str, torch.Tensor]:
        """The backbone's trainable parameters under ``backbone.`` (the
        frozen rest is the model's own weights), at their full shapes (a
        collective under a model axis: every rank calls it)."""
        module = self.backbone.module
        return {f"backbone.{n}": full_tensor(self.backbone.mesh,
                                             param_specs(module)[n],
                                             p.detach())
                for n, p in module.named_parameters() if p.requires_grad}

    def load_backbone_tensors(self, blob: Mapping[str, torch.Tensor]) -> None:
        """Copy the ``backbone.`` tensors of ``blob`` (full shapes) into the
        tower, each rank its shard."""
        module = self.backbone.module
        params = dict(module.named_parameters())
        with torch.no_grad():
            for k, v in blob.items():
                if not k.startswith("backbone."):
                    continue
                name = k[len("backbone."):]
                part = shard_tensor(module, name, v) if name in params \
                    else None
                if part is None or params[name].shape != part.shape:
                    raise KeyError(f"checkpoint tensor {k} "
                                   f"{tuple(v.shape)} fits no backbone "
                                   f"parameter")
                params[name].copy_(part)


class LinearProbe(BaseProbe):
    """Single-task probe (reference ``linear_probe.py``); the head's
    weights are drawn from ``seed`` on the backbone's device."""

    def __init__(self, backbone: VisionBackbone, n_out_classes: int,
                 freeze_backbone: bool = True, dropout_p: float = 0.3,
                 deeper_head: bool = False, hidden_dim: int = 512,
                 seed: int = 0):
        super().__init__(backbone, freeze_backbone)
        self.n_out_classes = n_out_classes
        self.classifier = make_head(backbone.output_dim, n_out_classes,
                                    dropout_p=dropout_p, deeper=deeper_head,
                                    hidden_dim=hidden_dim, seed=seed,
                                    device=backbone.device)

    def forward(self, images) -> torch.Tensor:
        self.classifier.eval()
        with torch.no_grad():
            return self.classifier(self.extract_features(images))

    __call__ = forward

    def predict(self, images) -> torch.Tensor:
        return self.forward(images).argmax(dim=-1)

    def state_tensors(self, with_backbone: bool) -> Dict[str, torch.Tensor]:
        """The checkpoint's tensors: the head's state under ``head.``, and
        with ``with_backbone`` the backbone's trainable parameters under
        ``backbone.`` (the frozen rest is the model's own weights)."""
        out = {f"head.{k}": v for k, v in
               self.classifier.state_dict().items()}
        if with_backbone:
            out.update(self.backbone_tensors())
        return out

    def load_state_tensors(self, blob: Mapping[str, torch.Tensor],
                           with_backbone: bool = True) -> None:
        """Fill the head (every tensor required) and, with
        ``with_backbone``, the backbone parameters the blob holds."""
        head = {k[len("head."):]: v for k, v in blob.items()
                if k.startswith("head.")}
        self.classifier.load_state_dict(head)
        if with_backbone:
            self.load_backbone_tensors(blob)


class MultiTaskProbe(BaseProbe):
    """Shared backbone, one head per task (reference multitask_probe.py);
    task ``i``'s head is drawn from ``seed + i``."""

    def __init__(self, backbone: VisionBackbone, tasks: Dict[str, int],
                 freeze_backbone: bool = True, dropout_p: float = 0.3,
                 deeper_heads: bool = False, hidden_dim: int = 512,
                 seed: int = 0):
        super().__init__(backbone, freeze_backbone)
        self.tasks = dict(tasks)
        self.classifiers = {
            t: make_head(backbone.output_dim, n, dropout_p=dropout_p,
                         deeper=deeper_heads, hidden_dim=hidden_dim,
                         seed=seed + i, device=backbone.device)
            for i, (t, n) in enumerate(self.tasks.items())}

    def train_heads(self, mode: bool) -> None:
        for clf in self.classifiers.values():
            clf.train(mode)

    def apply_heads(self, feats: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    mesh=None) -> Dict[str, torch.Tensor]:
        """Every head's logits on ``feats``, in the heads' current mode;
        dropout draws from ``generator`` head by head (``mesh``: ``feats``
        are this data rank's rows, :mod:`.heads`)."""
        return {t: clf(feats, generator=generator, mesh=mesh)
                for t, clf in self.classifiers.items()}

    def forward(self, images) -> Dict[str, Dict[str, torch.Tensor]]:
        self.train_heads(False)
        with torch.no_grad():
            return {"logits": self.apply_heads(self.extract_features(images))}

    __call__ = forward

    def predict(self, images) -> Dict[str, torch.Tensor]:
        return {t: v.argmax(dim=-1)
                for t, v in self.forward(images)["logits"].items()}

    def state_tensors(self, with_backbone: bool) -> Dict[str, torch.Tensor]:
        """``heads.<task>.<k>`` for every head's state, and with
        ``with_backbone`` the backbone's trainable parameters."""
        out = {f"heads.{t}.{k}": v for t, clf in self.classifiers.items()
               for k, v in clf.state_dict().items()}
        if with_backbone:
            out.update(self.backbone_tensors())
        return out

    def load_state_tensors(self, blob: Mapping[str, torch.Tensor],
                           with_backbone: bool = True) -> None:
        """Fill every head (each tensor required) and, with
        ``with_backbone``, the backbone parameters the blob holds."""
        for t, clf in self.classifiers.items():
            pre = f"heads.{t}."
            clf.load_state_dict({k[len(pre):]: v for k, v in blob.items()
                                 if k.startswith(pre)})
        if with_backbone:
            self.load_backbone_tensors(blob)


def full_tensor(mesh, dim, t: torch.Tensor) -> torch.Tensor:
    """``t``, a rank's part split on ``dim`` over the model axis (None:
    whole), gathered to its full shape."""
    if mesh is None or dim is None or mesh.model == 1:
        return t
    return mesh.all_gather(t, MODEL_AXIS, dim)
