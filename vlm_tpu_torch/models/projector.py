"""Vision-to-language projectors (``vlm_tpu/models/projector.py``):
PaliGemma's single linear projection and LLaVA's two-layer GELU MLP.
BLIP-2's Q-Former comes with its slice (ROADMAP A13). Neither is
quantized in any mode, as in ``vlm_tpu``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
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


class MLPProjector(nn.Module):
    """LLaVA's projector: ``fc1`` (vision width -> decoder width), exact
    GELU, ``fc2`` (decoder width -> decoder width)."""

    def __init__(self, in_dim: int, out_dim: int, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.fc1 = Dense(in_dim, out_dim, dtype=dtype, device=device)
        self.fc2 = Dense(out_dim, out_dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


def build_projector(cfg: VLMConfig, *, dtype, device) -> nn.Module:
    if cfg.projector in ("linear", "mlp"):
        cls = LinearProjector if cfg.projector == "linear" else MLPProjector
        return cls(cfg.vision.hidden, cfg.decoder.hidden, dtype=dtype,
                   device=device)
    if cfg.projector == "qformer":
        raise NotImplementedError("the Q-Former (BLIP-2) is not ported yet "
                                  "(ROADMAP A13)")
    raise ValueError(f"unknown projector {cfg.projector!r}")
