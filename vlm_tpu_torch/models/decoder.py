"""Decoder-only LM (``vlm_tpu/models/decoder.py``): Gemma (``(1+w)``
RMSNorm, sqrt(hidden) embedding scale, MQA, the gated ``gelu_tanh`` MLP,
the tied head) and LLaMA/Vicuna (plain RMSNorm, MHA, the gated SiLU MLP,
the untied ``lm_head``), with half-rotation RoPE in fp32; and OPT
(pre-LayerNorm, learned positions read at ``position + 2``, biased
projections, the plain ReLU FFN ``fc1`` -> ``down_proj``, the tied head).

The KV cache is a dict of per-layer tuples of ``[B, max_len, KV, D]``
tensors, or of :class:`QuantizedKV` pairs for the int8 cache, updated in
place (JAX donated the buffers instead). Activations keep the
``[B, S, H, D]`` layout of the projections; attention reads them through
strided views, so no head transpose is ever copied. ``quant_bits`` 8 or 4
makes the block Dense layers int8 or grouped int4; the embedding and the
head (tied or ``lm_head``) stay in the compute dtype, as in ``vlm_tpu``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention
from ..ops.decode_attention import decode_attention
from ..ops.kvcache import (kv_quantized_write, kv_scatter_write,
                           kv_uniform_write)
from ..ops.quant import quantize_activations
from .configs import DecoderConfig
from .layers import Dense, LayerNorm, RMSNorm, activation

# ------------------------- rotary embeddings -------------------------


def rope_table(head_dim: int, max_pos: int, theta: float,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables [max_pos, head_dim//2] in float32."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=device) / head_dim))
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate the halves (x[..., :d/2], x[..., d/2:]) in fp32, the
    LLaMA/Gemma convention. x: [B, S, H, D]; positions: [B, S]."""
    d2 = x.shape[-1] // 2
    positions = positions.long()
    c = cos[positions][:, :, None, :]          # [B, S, 1, d2]
    s = sin[positions][:, :, None, :]
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ------------------------- KV cache -------------------------

class QuantizedKV(NamedTuple):
    """One int8 cache layer: ``q`` [B, max_len, KV, D] int8 and ``scale``
    [B, max_len, KV, 1] fp32, ``value ~= q * scale``."""
    q: torch.Tensor
    scale: torch.Tensor


def quantize_kv_rows(x: torch.Tensor) -> QuantizedKV:
    """abs-max/127 int8 quantization of every (slot, row, kv head) row of
    [B, S, KV, D]: ``quantize_activations``, as in ``vlm_tpu``."""
    return QuantizedKV(*quantize_activations(x))


def dequantize_kv(ckv: QuantizedKV, dtype) -> torch.Tensor:
    """The product formed in fp32, rounded to ``dtype`` once."""
    return (ckv.q.float() * ckv.scale).to(dtype)


def init_kv_cache(cfg: DecoderConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> Dict[str, tuple]:
    """Per-layer tuples of zeroed ``k``/``v`` [B, max_len, KV, D] tensors,
    or :class:`QuantizedKV` layers for ``dtype`` ``"int8"``: a layer's
    write touches only its own buffers."""
    shape = (batch, max_len, cfg.kv_heads, cfg.head_dim)

    def layer():
        if dtype == "int8" or dtype == torch.int8:
            return QuantizedKV(
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                            device=device))
        return torch.zeros(shape, dtype=dtype, device=device)
    return {"k": tuple(layer() for _ in range(cfg.layers)),
            "v": tuple(layer() for _ in range(cfg.layers))}


def write_kv(ck, cv, k: torch.Tensor, v: torch.Tensor,
             start: Union[int, torch.Tensor], uniform: bool = False) -> None:
    """Write ``k``/``v`` [B, S, KV, D] into the caches at ``start``, in place
    (``vlm_tpu``'s ``_write_kv``). One row per slot goes through B3: at the
    shared column ``start[0]`` (``uniform``) or at each slot's ``start[b]``.
    The prefill's rows (``start`` an int, every slot from the same column)
    are a slice copy. An int8 cache (:class:`QuantizedKV`) takes every
    write, the prefill's too, through B3's int8 form, which quantizes the
    rows and writes values and scales. The decode step does not come here:
    its write runs inside B2's launch (:class:`DecoderAttention`)."""
    s = k.shape[1]
    if s > 1 and not (uniform and isinstance(start, int)):
        raise ValueError("a multi-row KV write needs one shared int column")
    if isinstance(ck, QuantizedKV):
        if isinstance(start, int):
            start = torch.full((1,), start, dtype=torch.int32,
                               device=k.device)
        kv_quantized_write(ck, cv, k.contiguous(), v.contiguous(), start,
                           uniform)
    elif s == 1:
        writer = kv_uniform_write if uniform else kv_scatter_write
        writer(ck, cv, k, v, start)
    else:
        ck[:, start:start + s] = k
        cv[:, start:start + s] = v


# ------------------------- modules -------------------------

class DecoderAttention(nn.Module):
    def __init__(self, cfg: DecoderConfig, dd: dict):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.q_proj = Dense(cfg.hidden, cfg.heads * hd, cfg.attn_bias, **dd)
        self.k_proj = Dense(cfg.hidden, cfg.kv_heads * hd, cfg.attn_bias, **dd)
        self.v_proj = Dense(cfg.hidden, cfg.kv_heads * hd, cfg.attn_bias, **dd)
        self.o_proj = Dense(cfg.heads * hd, cfg.hidden, cfg.attn_bias, **dd)

    def forward(self, x, positions, rope, cache_kv=None, write_start=None,
                kv_len=None, causal=True, prefix_len=None,
                uniform_write=False, kv_valid=None, kv_window=None):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        q = self.q_proj(x).view(b, s, cfg.heads, hd)
        k = self.k_proj(x).view(b, s, cfg.kv_heads, hd)
        v = self.v_proj(x).view(b, s, cfg.kv_heads, hd)
        if rope is not None:
            cos, sin = rope
            q = apply_rope(q, positions, cos, sin)
            k = apply_rope(k, positions, cos, sin)
        if cache_kv is not None and s == 1:
            # decode step: one B2 launch writes the new row (B3 fused in)
            # and attends over the cache in its own layout; an int8 cache
            # enters raw, its scales ride the scores
            ck, cv = cache_kv
            scales = {}
            if isinstance(ck, QuantizedKV):
                (ck, ks), (cv, vs) = ck, cv
                scales = dict(k_scale=ks, v_scale=vs)
            o = decode_attention(q.transpose(1, 2), ck, cv, kv_len=kv_len,
                                 kv_valid=kv_valid, kv_window=kv_window,
                                 k_new=k.contiguous(), v_new=v.contiguous(),
                                 write_start=write_start,
                                 uniform=uniform_write, **scales)
        else:
            # prefill or full forward: self-attention over the new tokens
            if cache_kv is not None:
                write_kv(cache_kv[0], cache_kv[1], k, v, write_start,
                         uniform=uniform_write)
            o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                kv_len=kv_len, prefix_len=prefix_len)
        return self.o_proj(o.transpose(1, 2).reshape(b, s, cfg.heads * hd))


class DecoderMLP(nn.Module):
    """The gated MLP (``act(gate_proj) * up_proj``), or OPT's plain FFN
    (``act(fc1)``), then ``down_proj``."""

    def __init__(self, cfg: DecoderConfig, dd: dict):
        super().__init__()
        self.gated = cfg.gated_mlp
        if self.gated:
            self.gate_proj = Dense(cfg.hidden, cfg.mlp_dim, cfg.attn_bias,
                                   **dd)
            self.up_proj = Dense(cfg.hidden, cfg.mlp_dim, cfg.attn_bias, **dd)
        else:
            self.fc1 = Dense(cfg.hidden, cfg.mlp_dim, cfg.attn_bias, **dd)
        self.down_proj = Dense(cfg.mlp_dim, cfg.hidden, cfg.attn_bias, **dd)
        self.act = activation(cfg.act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            h = self.act(self.gate_proj(x)) * self.up_proj(x)
        else:
            h = self.act(self.fc1(x))
        return self.down_proj(h)


def make_norm(cfg: DecoderConfig, dtype, device) -> nn.Module:
    """RMSNorm (LLaMA, Gemma) or LayerNorm (OPT), by ``cfg.norm``."""
    if cfg.norm == "rmsnorm":
        return RMSNorm(cfg.hidden, cfg.norm_eps, gemma_style=cfg.gemma_norm,
                       dtype=dtype, device=device)
    if cfg.norm == "layernorm":
        return LayerNorm(cfg.hidden, cfg.norm_eps, dtype=dtype, device=device)
    raise ValueError(f"unknown norm {cfg.norm!r}")


class DecoderBlock(nn.Module):
    def __init__(self, cfg: DecoderConfig, dd: dict):
        super().__init__()
        self.input_norm = make_norm(cfg, dd["dtype"], dd["device"])
        self.attn = DecoderAttention(cfg, dd)
        self.post_attn_norm = make_norm(cfg, dd["dtype"], dd["device"])
        self.mlp = DecoderMLP(cfg, dd)

    def forward(self, x, positions, rope, *args):
        x = x + self.attn(self.input_norm(x), positions, rope, *args)
        return x + self.mlp(self.post_attn_norm(x))


class Embed(nn.Module):
    """Token table ``weight`` [vocab, hidden]; also the tied head."""

    def __init__(self, vocab: int, hidden: int, *, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(vocab, hidden, dtype=dtype, device=device),
            requires_grad=False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.weight.normal_(0.0, 0.02, generator=gen)


class Decoder(nn.Module):
    """Decoder LM over ``input_ids`` [B,S] or pre-merged ``input_embeds``
    [B,S,H]; returns ``logits``."""

    def __init__(self, cfg: DecoderConfig, *, dtype=torch.float32,
                 device=None, quant_bits: int = 0):
        super().__init__()
        if cfg.pos not in ("rope", "learned"):
            raise ValueError(f"unknown position scheme {cfg.pos!r}")
        self.cfg = cfg
        self.dtype = dtype
        dd = dict(dtype=dtype, device=device)
        self.embed = Embed(cfg.vocab_size, cfg.hidden, **dd)
        # OPT: a learned table of max_position + 2 rows, read at position + 2
        self.pos_embed = Embed(cfg.max_position + 2, cfg.hidden, **dd) \
            if cfg.pos == "learned" else None
        block_dd = dict(dd, quant_bits=quant_bits)
        self.blocks = nn.ModuleList(DecoderBlock(cfg, block_dd)
                                    for _ in range(cfg.layers))
        self.final_norm = make_norm(cfg, dtype, device) if cfg.final_norm \
            else None
        # the untied head: never quantized, no bias
        self.lm_head = None if cfg.tie_embeddings else Dense(
            cfg.hidden, cfg.vocab_size, use_bias=False, **dd)
        if cfg.pos == "rope":
            cos, sin = rope_table(cfg.head_dim, cfg.max_position,
                                  cfg.rope_theta, device=device)
            self.register_buffer("rope_cos", cos, persistent=False)
            self.register_buffer("rope_sin", sin, persistent=False)

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Token embeddings times sqrt(hidden), the scale rounded to the
        compute dtype first (45.25 in bf16, not 45.2548), as JAX does."""
        x = F.embedding(input_ids.long(), self.embed.weight).to(self.dtype)
        if self.cfg.embed_scale:
            # a Python number (the rounded scale, exact in the dtype): a
            # tensor made on the card here would be a blocking upload
            x = x * float(torch.tensor(self.cfg.hidden ** 0.5,
                                       dtype=self.dtype))
        return x

    def forward(self, *, input_ids: Optional[torch.Tensor] = None,
                input_embeds: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, tuple]] = None,
                write_start=None,
                kv_len: Optional[torch.Tensor] = None,
                causal: bool = True,
                prefix_len: Optional[torch.Tensor] = None,
                logits_index: Optional[torch.Tensor] = None,
                uniform_write: bool = False,
                kv_valid: Optional[torch.Tensor] = None,
                kv_window=None,
                logits_dtype=None) -> torch.Tensor:
        """Arguments as in ``vlm_tpu``'s ``Decoder.__call__``. ``cache`` is
        updated in place. ``logits_index`` [B] keeps one position per row
        ([B, 1, V]); logits default to float32 (an exact upcast of the
        compute-dtype head, tied or ``lm_head``)."""
        if input_embeds is None:
            input_embeds = self.embed_tokens(input_ids)
        x = input_embeds.to(self.dtype)
        b, s, _ = x.shape
        if positions is None:
            if s > self.cfg.max_position:
                raise ValueError(f"{s} positions past the decoder's "
                                 f"{self.cfg.max_position}")
            positions = torch.arange(s, device=x.device).expand(b, s)
        rope = None
        if self.pos_embed is not None:
            # a position past the table raises (IndexError on the CPU, a
            # device assert on the card); it is never clamped
            x = x + F.embedding(positions.long() + 2,
                                self.pos_embed.weight).to(self.dtype)
        else:
            rope = (self.rope_cos, self.rope_sin)
        for i, block in enumerate(self.blocks):
            cache_kv = (cache["k"][i], cache["v"][i]) if cache is not None \
                else None
            x = block(x, positions, rope, cache_kv, write_start, kv_len,
                      causal, prefix_len, uniform_write, kv_valid, kv_window)
        if self.final_norm is not None:
            x = self.final_norm(x)
        if logits_index is not None:
            idx = logits_index.long().clamp(0, s - 1)
            x = x[torch.arange(b, device=x.device), idx][:, None]
        head = self.embed.weight if self.lm_head is None else \
            self.lm_head.weight
        logits = F.linear(x.to(self.dtype), head)
        return logits.to(logits_dtype or torch.float32)
