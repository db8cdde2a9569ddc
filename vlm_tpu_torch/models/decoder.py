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

Under a mesh of ``model > 1`` ways (``vlm_tpu``'s ``shard`` annotations)
each rank holds ``heads / model`` query heads and ``kv_heads / model`` KV
heads (its cache too); with fewer KV heads than ways (Gemma's MQA: one) the
KV projections and the cache head are whole on every rank, where
``vlm_tpu`` splits their columns and lets GSPMD put them back together.
The MLP splits its width. The token table splits the vocabulary (a masked
lookup and an all-reduce), and the head gives the rank's vocabulary slice,
all-gathered over the model group, so every rank sees the whole logits.
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
from ..core.mesh import MODEL_AXIS
from ..ops.quant import quantize_activations
from .configs import DecoderConfig
from .layers import (Dense, LayerNorm, RMSNorm, activation,
                     shard_size)

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
                  dtype=torch.bfloat16, device=None,
                  kv_heads: Optional[int] = None) -> Dict[str, tuple]:
    """Per-layer tuples of zeroed ``k``/``v`` [B, max_len, KV, D] tensors,
    or :class:`QuantizedKV` layers for ``dtype`` ``"int8"``: a layer's
    write touches only its own buffers. ``kv_heads``: a rank's
    (``Decoder.kv_heads``), default the config's."""
    shape = (batch, max_len, kv_heads or cfg.kv_heads, cfg.head_dim)

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

def local_heads(cfg: DecoderConfig, mesh) -> Tuple[int, int, bool]:
    """(query heads, KV heads, whether the KV heads split) of a rank:
    ``heads / model``, and ``kv_heads / model`` or, for one KV head, the
    head whole on every rank."""
    ways = mesh.model if mesh is not None else 1
    heads = shard_size(cfg.heads, ways, "query heads")
    if cfg.kv_heads % ways == 0:
        return heads, cfg.kv_heads // ways, ways > 1
    if cfg.kv_heads == 1:
        return heads, 1, False
    raise ValueError(f"{cfg.kv_heads} KV heads over model={ways}: only a "
                     f"split into whole heads or one replicated head")


class DecoderAttention(nn.Module):
    def __init__(self, cfg: DecoderConfig, dd: dict):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.heads, self.kv_heads, kv_split = local_heads(cfg, dd.get("mesh"))
        col, row = (None, MODEL_AXIS), (MODEL_AXIS, None)
        kv = col if kv_split else (None, None)
        self.q_proj = Dense(cfg.hidden, cfg.heads * hd, cfg.attn_bias,
                            shard=col, **dd)
        self.k_proj = Dense(cfg.hidden, cfg.kv_heads * hd, cfg.attn_bias,
                            shard=kv, **dd)
        self.v_proj = Dense(cfg.hidden, cfg.kv_heads * hd, cfg.attn_bias,
                            shard=kv, **dd)
        self.o_proj = Dense(cfg.heads * hd, cfg.hidden, cfg.attn_bias,
                            shard=row, **dd)

    def forward(self, x, positions, rope, cache_kv=None, write_start=None,
                kv_len=None, causal=True, prefix_len=None,
                uniform_write=False, kv_valid=None, kv_window=None,
                replicated=False):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        q = self.q_proj(x, replicated).view(b, s, self.heads, hd)
        k = self.k_proj(x, replicated).view(b, s, self.kv_heads, hd)
        v = self.v_proj(x, replicated).view(b, s, self.kv_heads, hd)
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
        return self.o_proj(o.transpose(1, 2).reshape(b, s, self.heads * hd),
                           replicated)


class DecoderMLP(nn.Module):
    """The gated MLP (``act(gate_proj) * up_proj``), or OPT's plain FFN
    (``act(fc1)``), then ``down_proj``."""

    def __init__(self, cfg: DecoderConfig, dd: dict):
        super().__init__()
        self.gated = cfg.gated_mlp
        col, row = (None, MODEL_AXIS), (MODEL_AXIS, None)
        if self.gated:
            self.gate_proj = Dense(cfg.hidden, cfg.mlp_dim, cfg.attn_bias,
                                   shard=col, **dd)
            self.up_proj = Dense(cfg.hidden, cfg.mlp_dim, cfg.attn_bias,
                                 shard=col, **dd)
        else:
            self.fc1 = Dense(cfg.hidden, cfg.mlp_dim, cfg.attn_bias,
                             shard=col, **dd)
        self.down_proj = Dense(cfg.mlp_dim, cfg.hidden, cfg.attn_bias,
                               shard=row, **dd)
        self.act = activation(cfg.act)

    def forward(self, x: torch.Tensor,
                replicated: bool = False) -> torch.Tensor:
        if self.gated:
            h = self.act(self.gate_proj(x, replicated)) * \
                self.up_proj(x, replicated)
        else:
            h = self.act(self.fc1(x, replicated))
        return self.down_proj(h, replicated)


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

    def forward(self, x, positions, rope, *args, replicated=False):
        x = x + self.attn(self.input_norm(x), positions, rope, *args,
                          replicated=replicated)
        return x + self.mlp(self.post_attn_norm(x), replicated)


class Embed(nn.Module):
    """Token table ``weight`` [vocab, hidden]; also the tied head. With a
    ``mesh`` of ``model > 1`` ways, vocabulary-parallel: the rank holds
    rows ``[model_rank * V / model, ...)``."""

    def __init__(self, vocab: int, hidden: int, *, dtype, device,
                 mesh=None):
        super().__init__()
        self.mesh = mesh if mesh is not None and mesh.model > 1 else None
        if self.mesh is not None:
            vocab = shard_size(vocab, mesh.model, "vocabulary rows")
        self.weight = nn.Parameter(
            torch.empty(vocab, hidden, dtype=dtype, device=device),
            requires_grad=False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.weight.normal_(0.0, 0.02, generator=gen)

    def split_dim(self, leaf: str) -> Optional[int]:
        return 0 if self.mesh is not None else None

    def shard_full(self, leaf: str, full: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return full
        n = full.shape[0] // self.mesh.model
        return full.narrow(0, self.mesh.model_rank * n, n)

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """The rows of ``ids``; vocabulary-parallel, the rank's rows where
        it holds them, zeros elsewhere, summed over the model group (one
        row and zeros: exact)."""
        if self.mesh is None:
            return F.embedding(ids.long(), self.weight)
        n = self.weight.shape[0]
        local = ids.long() - self.mesh.model_rank * n
        mine = (local >= 0) & (local < n)
        x = F.embedding(torch.where(mine, local, 0), self.weight)
        x = torch.where(mine[..., None], x.float(), 0.0)
        return self.mesh.all_reduce(x, MODEL_AXIS).to(self.weight.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The tied head: ``x @ weight.T``, all-gathered over the model
        group when the vocabulary is split."""
        y = F.linear(x, self.weight)
        return y if self.mesh is None else \
            self.mesh.all_gather(y, MODEL_AXIS, -1)


class Decoder(nn.Module):
    """Decoder LM over ``input_ids`` [B,S] or pre-merged ``input_embeds``
    [B,S,H]; returns ``logits``."""

    def __init__(self, cfg: DecoderConfig, *, dtype=torch.float32,
                 device=None, quant_bits: int = 0, mesh=None):
        super().__init__()
        if cfg.pos not in ("rope", "learned"):
            raise ValueError(f"unknown position scheme {cfg.pos!r}")
        self.cfg = cfg
        self.dtype = dtype
        #: the rank's KV heads (its cache's)
        self.kv_heads = local_heads(cfg, mesh)[1]
        dd = dict(dtype=dtype, device=device)
        self.embed = Embed(cfg.vocab_size, cfg.hidden, mesh=mesh, **dd)
        # OPT: a learned table of max_position + 2 rows, read at position + 2
        self.pos_embed = Embed(cfg.max_position + 2, cfg.hidden, **dd) \
            if cfg.pos == "learned" else None
        block_dd = dict(dd, quant_bits=quant_bits, mesh=mesh)
        self.blocks = nn.ModuleList(DecoderBlock(cfg, block_dd)
                                    for _ in range(cfg.layers))
        self.final_norm = make_norm(cfg, dtype, device) if cfg.final_norm \
            else None
        # the untied head: never quantized, no bias
        self.lm_head = None if cfg.tie_embeddings else Dense(
            cfg.hidden, cfg.vocab_size, use_bias=False,
            shard=(None, MODEL_AXIS), mesh=mesh, gather=True, **dd)
        if cfg.pos == "rope":
            cos, sin = rope_table(cfg.head_dim, cfg.max_position,
                                  cfg.rope_theta, device=device)
            self.register_buffer("rope_cos", cos, persistent=False)
            self.register_buffer("rope_sin", sin, persistent=False)

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Token embeddings times sqrt(hidden), the scale rounded to the
        compute dtype first (45.25 in bf16, not 45.2548), as JAX does."""
        x = self.embed.lookup(input_ids).to(self.dtype)
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
                logits_dtype=None,
                replicated: bool = False) -> torch.Tensor:
        """Arguments as in ``vlm_tpu``'s ``Decoder.__call__``. ``cache`` is
        updated in place. ``logits_index`` [B] keeps one position per row
        ([B, 1, V]); logits default to float32 (an exact upcast of the
        compute-dtype head, tied or ``lm_head``). ``replicated``: under a
        mesh, the rows are the same on every data rank
        (:meth:`Dense.forward`)."""
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
                      causal, prefix_len, uniform_write, kv_valid, kv_window,
                      replicated=replicated)
        if self.final_norm is not None:
            x = self.final_norm(x)
        if logits_index is not None:
            idx = logits_index.long().clamp(0, s - 1)
            x = x[torch.arange(b, device=x.device), idx][:, None]
        x = x.to(self.dtype)
        logits = self.embed.logits(x) if self.lm_head is None else \
            self.lm_head(x)
        return logits.to(logits_dtype or torch.float32)
