"""ViT vision encoder (``vlm_tpu/models/vit.py``): SigLIP, CLIP and EVA
variants by :class:`ViTConfig`.

Pixels come in NHWC, as in JAX, or already as patch vectors
``[B, N, P*P*3]`` in the conv's HWIO order (what B4 writes with
``patch_size``). The patch embedding is an unfold of NHWC pixels plus one
matmul (the weight holds the HWIO conv kernel flattened to
``[hidden, P*P*3]``); attention runs through B1. ``quant_bits`` 8 or 4
makes the block Dense layers (q/k/v/out, fc1/fc2) int8 or grouped int4, as
``vlm_tpu``'s ``quantize_vision``; the patch embedding and the norms stay
in the compute dtype. Under a mesh of ``model > 1`` ways each rank holds
``heads / model`` heads of q/k/v (column-parallel) and the matching rows
of ``out_proj`` (row-parallel), and a slice of the MLP's width.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..ops.attention import flash_attention
from ..core.mesh import MODEL_AXIS
from ..ops.preprocess import unfold_patches
from .configs import ViTConfig
from .layers import Dense, LayerNorm, activation, shard_size

COL, ROW = (None, MODEL_AXIS), (MODEL_AXIS, None)


class ViTAttention(nn.Module):
    def __init__(self, cfg: ViTConfig, dd: dict):
        super().__init__()
        self.cfg = cfg
        mesh = dd.get("mesh")
        self.heads = shard_size(
            cfg.heads, mesh.model if mesh is not None else 1, "heads")
        self.q_proj = Dense(cfg.hidden, cfg.hidden, shard=COL, **dd)
        self.k_proj = Dense(cfg.hidden, cfg.hidden, use_bias=cfg.k_bias,
                            shard=COL, **dd)
        self.v_proj = Dense(cfg.hidden, cfg.hidden, shard=COL, **dd)
        self.out_proj = Dense(cfg.hidden, cfg.hidden, shard=ROW, **dd)

    def forward(self, x: torch.Tensor,
                replicated: bool = False) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape

        def heads(t):       # [B, S, hidden] -> [B, H, S, Dh] view
            return t.view(b, s, self.heads, cfg.head_dim).transpose(1, 2)

        q, k, v = (proj(x, replicated) for proj in
                   (self.q_proj, self.k_proj, self.v_proj))
        o = flash_attention(heads(q), heads(k), heads(v), causal=False)
        return self.out_proj(o.transpose(1, 2).reshape(
            b, s, self.heads * cfg.head_dim), replicated)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, dd: dict):
        super().__init__()
        norm = dict(eps=cfg.layer_norm_eps, dtype=dd["dtype"],
                    device=dd["device"])
        self.ln1 = LayerNorm(cfg.hidden, **norm)
        self.attn = ViTAttention(cfg, dd)
        self.ln2 = LayerNorm(cfg.hidden, **norm)
        self.fc1 = Dense(cfg.hidden, cfg.mlp_dim, shard=COL, **dd)
        self.fc2 = Dense(cfg.mlp_dim, cfg.hidden, shard=ROW, **dd)
        self.act = activation(cfg.act)

    def forward(self, x: torch.Tensor,
                replicated: bool = False) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), replicated)
        return x + self.fc2(self.act(self.fc1(self.ln2(x), replicated)),
                            replicated)


class ViTEncoder(nn.Module):
    """``forward(pixels [B,H,W,3] or patches [B,N,P*P*3])`` returns a dict
    with
    ``last_hidden_state`` [B,S,D] (per-config post-norm semantics),
    ``hidden_states`` (embeddings first, or None) and ``pooled`` [B,D]
    (CLS after the final LN; None without a CLS token)."""

    def __init__(self, cfg: ViTConfig, *, dtype=torch.float32, device=None,
                 quant_bits: int = 0, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        dd = dict(dtype=dtype, device=device)
        p = cfg.patch_size
        self.patch_embed = Dense(p * p * 3, cfg.hidden,
                                 use_bias=cfg.patch_bias, **dd)
        self.cls_token = nn.Parameter(
            torch.empty(1, 1, cfg.hidden, **dd),
            requires_grad=False) if cfg.use_cls_token else None
        self.pos_embed = nn.Parameter(
            torch.empty(1, cfg.seq_len, cfg.hidden, **dd), requires_grad=False)
        norm = dict(eps=cfg.layer_norm_eps, **dd)
        self.pre_ln = LayerNorm(cfg.hidden, **norm) if cfg.pre_layernorm \
            else None
        block_dd = dict(dd, quant_bits=quant_bits, mesh=mesh)
        self.blocks = nn.ModuleList(ViTBlock(cfg, block_dd)
                                    for _ in range(cfg.layers))
        self.post_ln = LayerNorm(cfg.hidden, **norm)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.pos_embed.normal_(0.0, 0.02, generator=gen)
        if self.cls_token is not None:
            self.cls_token.zero_()

    def forward(self, pixels: torch.Tensor, keep_hidden_states: bool = True,
                replicated: bool = False) -> Dict[str, Any]:
        """``replicated``: under a mesh, ``pixels`` are the same on every
        data rank (:meth:`Dense.forward`)."""
        cfg = self.cfg
        b = pixels.shape[0]
        p = cfg.patch_size
        if pixels.dim() == 3:
            if pixels.shape[-1] != p * p * 3:
                raise ValueError(f"patch vectors of {p * p * 3} values "
                                 f"expected, got {tuple(pixels.shape)}")
            patches = pixels.to(self.dtype)
        else:
            patches = unfold_patches(pixels.to(self.dtype), p)
        x = self.patch_embed(patches)
        if self.cls_token is not None:
            x = torch.cat([self.cls_token.expand(b, 1, cfg.hidden), x], dim=1)
        x = x + self.pos_embed
        if self.pre_ln is not None:
            x = self.pre_ln(x)
        hidden_states = [x] if keep_hidden_states else None
        for block in self.blocks:
            x = block(x, replicated)
            if keep_hidden_states:
                hidden_states.append(x)
        if cfg.post_layernorm == "all":
            last = self.post_ln(x)
            # BLIP-2 applies the post LN a second time to the pooled CLS
            pooled = self.post_ln(last[:, 0:1])[:, 0] \
                if cfg.use_cls_token else None
        else:   # "pooled_only" (CLIP): last_hidden_state is not post-normed
            last = x
            pooled = self.post_ln(x[:, 0:1])[:, 0] \
                if cfg.use_cls_token else None
        return {
            "last_hidden_state": last,
            "hidden_states": tuple(hidden_states) if keep_hidden_states
            else None,
            "pooled": pooled,
        }
