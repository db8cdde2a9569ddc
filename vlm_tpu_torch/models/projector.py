"""Vision-to-language projector (``vlm_tpu/models/projector.py``):
PaliGemma's single linear projection. LLaVA's MLP and BLIP-2's Q-Former
come with their slices (ROADMAP A12, A13)."""

from __future__ import annotations

import torch
from torch import nn

from .configs import VLMConfig
from .layers import Dense


class LinearProjector(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.proj = Dense(in_dim, out_dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


def build_projector(cfg: VLMConfig, *, dtype, device) -> nn.Module:
    if cfg.projector == "linear":
        return LinearProjector(cfg.vision.hidden, cfg.decoder.hidden,
                               dtype=dtype, device=device)
    if cfg.projector == "mlp":
        raise NotImplementedError("the MLP projector (LLaVA) is not ported "
                                  "yet (ROADMAP A12)")
    if cfg.projector == "qformer":
        raise NotImplementedError("the Q-Former (BLIP-2) is not ported yet "
                                  "(ROADMAP A13)")
    raise ValueError(f"unknown projector {cfg.projector!r}")
