"""Architecture configurations for the supported model families: the
port's own copy of ``vlm_tpu/models/configs.py`` (the same dataclasses and
values, held equal to it by ``tests/test_torch_shared_layers.py``).

All constants are public model-card / config.json values for:

- LLaVA-1.5-7B  = CLIP ViT-L/14-336 tower + MLP projector + Vicuna-7B (LLaMA)
- PaliGemma-3B-mix-224 = SigLIP So400m/14 tower + linear projector + Gemma-2B
- BLIP-2 OPT-6.7B = EVA ViT-g tower + Q-Former bridge + OPT-6.7B

Every family also has a ``"test"`` size: a few-layer, narrow variant with the
same structural quirks, used by the test suite.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Generic ViT encoder config covering CLIP / SigLIP / EVA variants."""
    image_size: int
    patch_size: int
    hidden: int
    layers: int
    heads: int
    mlp_dim: int
    act: str = "gelu"                   # gelu | gelu_tanh | quick_gelu
    use_cls_token: bool = True
    pre_layernorm: bool = False         # LN on embeddings before the encoder (CLIP)
    # Where the final LN applies: "all" tokens (SigLIP/EVA) or only the pooled
    # CLS ("pooled_only", CLIP — its last_hidden_state is NOT post-normed).
    post_layernorm: str = "all"
    k_bias: bool = True                 # EVA ViT-g has no bias on K
    patch_bias: bool = True             # CLIP's patch conv is bias-free
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.use_cls_token else 0)

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Generic decoder-only LM config covering LLaMA / OPT / Gemma variants."""
    vocab_size: int
    hidden: int
    layers: int
    heads: int
    kv_heads: int
    mlp_dim: int
    head_dim: int
    max_position: int
    act: str = "silu"                   # silu | relu | gelu_tanh
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    gemma_norm: bool = False            # RMSNorm computes x * (1 + w)
    pos: str = "rope"                   # rope | learned  (OPT: learned, offset 2)
    gated_mlp: bool = True              # LLaMA/Gemma gated MLP vs OPT plain FFN
    tie_embeddings: bool = False
    embed_scale: bool = False           # Gemma scales embeddings by sqrt(hidden)
    final_norm: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    attn_bias: bool = False             # OPT uses biased projections
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 0


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    """BLIP-2 Q-Former bridge (BERT-style with periodic cross-attention)."""
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    num_query_tokens: int = 32
    cross_attention_frequency: int = 2
    encoder_hidden: int = 1408          # EVA ViT-g width
    layer_norm_eps: float = 1e-12


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """A full VLM: vision tower + projector + decoder."""
    name: str
    vision: ViTConfig
    decoder: DecoderConfig
    projector: str                      # "mlp" | "linear" | "qformer"
    qformer: Optional[QFormerConfig] = None
    # Which encoder layer's hidden states feed the projector (-1 = final
    # post-norm output; LLaVA uses the penultimate layer, pre-post-norm).
    vision_feature_layer: int = -1
    drop_cls_for_llm: bool = False      # LLaVA drops CLS before projecting
    # PaliGemma is a prefix-LM: image+prompt prefix tokens attend
    # bidirectionally; only generated tokens are causal.
    prefix_lm: bool = False
    backbone_dim: int = 0               # probing feature dim (reference parity)
    backbone_pooling: str = "mean"      # "mean" | "cls" | "pooler"


# ----------------------------- vision towers -----------------------------

CLIP_L_336 = ViTConfig(
    image_size=336, patch_size=14, hidden=1024, layers=24, heads=16,
    mlp_dim=4096, act="quick_gelu", use_cls_token=True, pre_layernorm=True,
    post_layernorm="pooled_only", patch_bias=False, layer_norm_eps=1e-5)

SIGLIP_SO400M_224 = ViTConfig(
    image_size=224, patch_size=14, hidden=1152, layers=27, heads=16,
    mlp_dim=4304, act="gelu_tanh", use_cls_token=False, pre_layernorm=False,
    post_layernorm="all", layer_norm_eps=1e-6)

EVA_VIT_G = ViTConfig(
    image_size=224, patch_size=14, hidden=1408, layers=39, heads=16,
    mlp_dim=6144, act="gelu", use_cls_token=True, pre_layernorm=False,
    post_layernorm="all", k_bias=False, layer_norm_eps=1e-6)


def _tiny_vit(base: ViTConfig) -> ViTConfig:
    return dataclasses.replace(
        base, image_size=base.patch_size * 4, hidden=64, layers=2, heads=2,
        mlp_dim=128)


# ----------------------------- decoders -----------------------------

VICUNA_7B = DecoderConfig(
    vocab_size=32064, hidden=4096, layers=32, heads=32, kv_heads=32,
    mlp_dim=11008, head_dim=128, max_position=4096, act="silu",
    norm="rmsnorm", pos="rope", gated_mlp=True, tie_embeddings=False,
    norm_eps=1e-5, bos_token_id=1, eos_token_id=2, pad_token_id=32001)

OPT_6_7B = DecoderConfig(
    vocab_size=50272, hidden=4096, layers=32, heads=32, kv_heads=32,
    mlp_dim=16384, head_dim=128, max_position=2048, act="relu",
    norm="layernorm", pos="learned", gated_mlp=False, tie_embeddings=True,
    attn_bias=True, norm_eps=1e-5, bos_token_id=2, eos_token_id=2,
    pad_token_id=1)

GEMMA_2B_PALI = DecoderConfig(
    vocab_size=257216, hidden=2048, layers=18, heads=8, kv_heads=1,
    mlp_dim=16384, head_dim=256, max_position=8192, act="gelu_tanh",
    norm="rmsnorm", gemma_norm=True, pos="rope", gated_mlp=True,
    tie_embeddings=True, embed_scale=True, norm_eps=1e-6,
    bos_token_id=2, eos_token_id=1, pad_token_id=0)


def _tiny_decoder(base: DecoderConfig) -> DecoderConfig:
    return dataclasses.replace(
        base, vocab_size=512, hidden=64, layers=2, heads=2,
        kv_heads=min(base.kv_heads, 2) if base.kv_heads > 1 else 1,
        mlp_dim=128, head_dim=32, max_position=512)


# ----------------------------- assembled VLMs -----------------------------

def llava_config(size: str = "7b") -> VLMConfig:
    vision = CLIP_L_336 if size != "test" else _tiny_vit(CLIP_L_336)
    decoder = VICUNA_7B if size != "test" else _tiny_decoder(VICUNA_7B)
    return VLMConfig(
        name="llava", vision=vision, decoder=decoder, projector="mlp",
        vision_feature_layer=-2, drop_cls_for_llm=True,
        backbone_dim=vision.hidden, backbone_pooling="mean")


def paligemma_config(size: str = "3b") -> VLMConfig:
    vision = SIGLIP_SO400M_224 if size != "test" else _tiny_vit(SIGLIP_SO400M_224)
    decoder = GEMMA_2B_PALI if size != "test" else _tiny_decoder(GEMMA_2B_PALI)
    return VLMConfig(
        name="paligemma", vision=vision, decoder=decoder, projector="linear",
        vision_feature_layer=-1, backbone_dim=vision.hidden,
        backbone_pooling="mean", prefix_lm=True)


def blip2_config(size: str = "6.7b") -> VLMConfig:
    vision = EVA_VIT_G if size != "test" else _tiny_vit(EVA_VIT_G)
    decoder = OPT_6_7B if size != "test" else _tiny_decoder(OPT_6_7B)
    qf = QFormerConfig(encoder_hidden=vision.hidden) if size != "test" else \
        QFormerConfig(hidden=32, layers=2, heads=2, mlp_dim=64,
                      num_query_tokens=8, encoder_hidden=vision.hidden)
    return VLMConfig(
        name="blip2", vision=vision, decoder=decoder, projector="qformer",
        qformer=qf, vision_feature_layer=-1, backbone_dim=vision.hidden,
        backbone_pooling="pooler")


VLM_CONFIGS = {
    "llava": llava_config,
    "paligemma": paligemma_config,
    "blip2": blip2_config,
}
