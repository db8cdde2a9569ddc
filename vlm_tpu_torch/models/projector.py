"""Vision-to-language projectors (``vlm_tpu/models/projector.py``):
PaliGemma's single linear projection, LLaVA's two-layer GELU MLP and
BLIP-2's Q-Former. None is quantized in any mode, as in ``vlm_tpu``.

Under a mesh of ``model > 1`` ways they take ``vlm_tpu``'s shards: the
linear projection and the Q-Former's ``language_projection`` are
column-parallel and all-gather their output (the decoder's hidden state is
whole on every rank); the MLP's ``fc1`` is column- and ``fc2``
row-parallel. The Q-Former's layers are whole on every rank."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.mesh import MODEL_AXIS
from ..ops.attention import flash_attention
from .configs import QFormerConfig, VLMConfig
from .layers import Dense, LayerNorm, activation

COL, ROW = (None, MODEL_AXIS), (MODEL_AXIS, None)


class LinearProjector(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, *, dtype=torch.float32,
                 device=None, mesh=None):
        super().__init__()
        self.proj = Dense(in_dim, out_dim, dtype=dtype, device=device,
                          shard=COL, mesh=mesh, gather=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class MLPProjector(nn.Module):
    """LLaVA's projector: ``fc1`` (vision width -> decoder width), exact
    GELU, ``fc2`` (decoder width -> decoder width)."""

    def __init__(self, in_dim: int, out_dim: int, *, dtype=torch.float32,
                 device=None, mesh=None):
        super().__init__()
        self.fc1 = Dense(in_dim, out_dim, dtype=dtype, device=device,
                         shard=COL, mesh=mesh)
        self.fc2 = Dense(out_dim, out_dim, dtype=dtype, device=device,
                         shard=ROW, mesh=mesh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class BertAttention(nn.Module):
    """Post-LN BERT attention, self (``kv`` is ``x``) or cross (``kv`` the
    image tokens): ``LN(x + out(attn(q(x), k(kv), v(kv))))``, through B1
    without a mask."""

    def __init__(self, hidden: int, kv_dim: int, heads: int, eps: float,
                 dd: dict):
        super().__init__()
        self.heads = heads
        self.q = Dense(hidden, hidden, **dd)
        self.k = Dense(kv_dim, hidden, **dd)
        self.v = Dense(kv_dim, hidden, **dd)
        self.out = Dense(hidden, hidden, **dd)
        self.ln = LayerNorm(hidden, eps, **dd)

    def forward(self, x: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        b, s, hidden = x.shape
        hd = hidden // self.heads

        def heads(t):       # [B, S, hidden] -> [B, H, S, Dh] view
            return t.view(b, t.shape[1], self.heads, hd).transpose(1, 2)

        o = flash_attention(heads(self.q(x)), heads(self.k(kv)),
                            heads(self.v(kv)), causal=False)
        o = self.out(o.transpose(1, 2).reshape(b, s, hidden))
        return self.ln(x + o)


class QFormerLayer(nn.Module):
    """Self-attention among the queries, cross-attention into the image
    tokens (on every ``cross_attention_frequency``-th layer), then the
    exact-GELU FFN with its post LN."""

    def __init__(self, cfg: QFormerConfig, cross: bool, dd: dict):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.self_attn = BertAttention(cfg.hidden, cfg.hidden, cfg.heads,
                                       eps, dd)
        self.cross_attn = BertAttention(cfg.hidden, cfg.encoder_hidden,
                                        cfg.heads, eps, dd) if cross else None
        self.ffn_up = Dense(cfg.hidden, cfg.mlp_dim, **dd)
        self.ffn_down = Dense(cfg.mlp_dim, cfg.hidden, **dd)
        self.ffn_ln = LayerNorm(cfg.hidden, eps, **dd)
        self.act = activation("gelu")

    def forward(self, x: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        x = self.self_attn(x, x)
        if self.cross_attn is not None:
            x = self.cross_attn(x, img)
        return self.ffn_ln(x + self.ffn_down(self.act(self.ffn_up(x))))


class QFormer(nn.Module):
    """BLIP-2's bridge: ``query_tokens`` [1, Q, hidden] broadcast over the
    batch, ``input_ln``, the layers over the image tokens [B, S, D_img],
    then ``language_projection`` -> [B, Q, out_dim]."""

    def __init__(self, cfg: QFormerConfig, out_dim: int, *,
                 dtype=torch.float32, device=None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        dd = dict(dtype=dtype, device=device)
        self.query_tokens = nn.Parameter(
            torch.empty(1, cfg.num_query_tokens, cfg.hidden, **dd),
            requires_grad=False)
        self.input_ln = LayerNorm(cfg.hidden, cfg.layer_norm_eps, **dd)
        self.layers = nn.ModuleList(
            QFormerLayer(cfg, i % cfg.cross_attention_frequency == 0, dd)
            for i in range(cfg.layers))
        self.language_projection = Dense(cfg.hidden, out_dim, shard=COL,
                                         mesh=mesh, gather=True, **dd)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.query_tokens.normal_(0.0, 0.02, generator=gen)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        b = image_embeds.shape[0]
        x = self.input_ln(self.query_tokens.expand(b, -1, -1))
        img = image_embeds.to(self.dtype)
        for layer in self.layers:
            x = layer(x, img)
        return self.language_projection(x)


def build_projector(cfg: VLMConfig, *, dtype, device,
                    mesh=None) -> nn.Module:
    if cfg.projector in ("linear", "mlp"):
        cls = LinearProjector if cfg.projector == "linear" else MLPProjector
        return cls(cfg.vision.hidden, cfg.decoder.hidden, dtype=dtype,
                   device=device, mesh=mesh)
    if cfg.projector == "qformer":
        return QFormer(cfg.qformer, cfg.decoder.hidden, dtype=dtype,
                       device=device, mesh=mesh)
    raise ValueError(f"unknown projector {cfg.projector!r}")
