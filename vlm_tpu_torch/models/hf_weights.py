"""HF safetensors checkpoints -> the port's parameters (the counterpart of
``vlm_tpu/models/hf_weights.py``).

The port stores a Dense as ``[out, in]``, HF's own layout, so each map goes
from an HF name straight to a ``state_dict`` name with no transpose; the
patch embedding's OIHW conv becomes the ``[hidden, P*P*3]`` matrix in
(h, w, c) order, EVA's fused ``qkv`` is split in three (its K bias
dropped), and the tower's class and position tables are reshaped.

Each tensor is read from the files alone (:mod:`..utils.safetensors_io`),
moved to the module's device, then copied into its parameter (cast there
to the parameter's dtype) or, for an int8 or int4 Dense, quantized there
from its fp32 values with the port's ``quantize_int8`` / ``quantize_int4``
at the layer's own group size. So a 7B checkpoint never sits whole in host
or device memory: the device holds the model plus the tensor being
written. A module built at a rank's shard of a mesh takes its part of each
tensor: a float tensor is sliced on the host, then moved; a quantized one
is moved whole, quantized there (int8's per-output scale spans all of K)
and then sliced.

:func:`load_vlm_weights` fills a module in place and raises if any
parameter is left unfilled (``vlm_tpu`` keeps a random LLaVA head when the
checkpoint lacks ``lm_head``; the port refuses).
:func:`validate_vlm_conversion` runs the same maps at full size on
``device="meta"`` over a manifest of names, shapes and dtypes, allocating
nothing.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Callable, Dict, List, Mapping

import torch

from ..ops.quant import quantize_int4, quantize_int8
from ..parallel.sharding import shard_tensor
from ..utils.safetensors_io import open_dir
from .layers import Dense
from .vlm import VLMModule

#: transformers >= 4.52 re-rooted composite VLMs: ``language_model.model.*``
#: became ``model.language_model.*`` with a top-level ``lm_head``. Hub
#: checkpoints keep the legacy names; new-style keys are rewritten to them.
_NEW_STYLE_RENAMES = (
    ("model.vision_tower.", "vision_tower."),
    ("model.multi_modal_projector.", "multi_modal_projector."),
    ("model.language_model.", "language_model.model."),
)


def _normalize_hf_keys(tensors: Mapping) -> Dict:
    """New-style names -> the legacy names the maps address."""
    if not any(k.startswith("model.") for k in tensors):
        return dict(tensors)
    out = {}
    for k, v in tensors.items():
        if k == "lm_head.weight":
            out["language_model.lm_head.weight"] = v
            continue
        for new, old in _NEW_STYLE_RENAMES:
            if k.startswith(new):
                k = old + k[len(new):]
                break
        out[k] = v
    return out


#: checkpoint keys no map reads: non-persistent buffers some transformers
#: versions saved, rope frequency tables (recomputed), and tied heads
#: (PaliGemma and OPT read the embedding)
_IGNORABLE_UNCONSUMED = (
    ".position_ids",
    ".rotary_emb.inv_freq",
    "language_model.lm_head.weight",
)


class _Writer:
    """Reads checkpoint tensors (name -> zero-argument loader) and writes
    them into ``module``'s parameters; records the names read and the
    parameters written."""

    def __init__(self, module: torch.nn.Module,
                 source: Mapping[str, Callable[[], torch.Tensor]]):
        self.source = source
        self.module = module
        self.params = dict(module.named_parameters())
        self.quantized = {name: m for name, m in module.named_modules()
                          if isinstance(m, Dense) and m.quant_bits}
        self.consumed: set = set()
        self.filled: set = set()

    def __contains__(self, key: str) -> bool:
        return key in self.source

    def has(self, name: str) -> bool:
        """Whether the module has parameter ``name``."""
        return name in self.params

    def get(self, key: str) -> torch.Tensor:
        self.consumed.add(key)
        return self.source[key]()

    def take(self, name: str, key: str) -> None:
        """Parameter ``name`` <- checkpoint tensor ``key``, as it is."""
        self.set(name, self.get(key))

    def set(self, name: str, value: torch.Tensor) -> None:
        mod, _, leaf = name.rpartition(".")
        dense = self.quantized.get(mod)
        if dense is not None and leaf == "weight":
            self._set_quantized(mod, dense, value)
            return
        param = self.params[name]
        value = shard_tensor(self.module, name, value)
        if tuple(param.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {name}: ours "
                             f"{tuple(param.shape)} vs checkpoint "
                             f"{tuple(value.shape)}")
        with torch.no_grad():
            param.copy_(value.to(param.device))
        self.filled.add(name)

    def _set_quantized(self, mod: str, dense: Dense,
                       value: torch.Tensor) -> None:
        """An fp ``[out, in]`` weight into an int8 Dense's (q, scale) or an
        int4 Dense's (packed q, group scales), quantized on the device from
        fp32 values. The int4 group is the layer's own ``group_size``,
        which is ``in / groups`` of its scale, the group ``vlm_tpu``
        derives (a shard's smaller group is cut from it)."""
        full = (dense.full_out, dense.full_in)
        if tuple(value.shape) != full:
            raise ValueError(f"shape mismatch at {mod}.weight: ours "
                             f"{full} vs checkpoint {tuple(value.shape)}")
        w = value.to(dense.q.device).float()
        qw = quantize_int4(w, dense.full_group) if dense.quant_bits == 4 \
            else quantize_int8(w)
        with torch.no_grad():
            for leaf, src in (("q", qw.q), ("scale", qw.scale)):
                src = dense.shard_full(leaf, src)
                param = getattr(dense, leaf)
                if tuple(param.shape) != tuple(src.shape):
                    raise ValueError(f"quantized shape mismatch at "
                                     f"{mod}.{leaf}: ours "
                                     f"{tuple(param.shape)} vs "
                                     f"{tuple(src.shape)}")
                param.copy_(src)
                self.filled.add(f"{mod}.{leaf}")

    def unfilled(self) -> List[str]:
        return sorted(set(self.params) - self.filled)


def _conv(x: torch.Tensor) -> torch.Tensor:
    """OIHW conv kernel -> [O, H*W*I], the (h, w, c) order of the port's
    patch vectors."""
    if x.dim() != 4:
        raise ValueError(f"patch embedding: a 4-D conv kernel expected, got "
                         f"{tuple(x.shape)}")
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _weight_bias(w: _Writer, ours: str, theirs: str) -> None:
    """``<ours>.weight`` and ``.bias`` <- ``<theirs>.weight`` and ``.bias``
    (a Dense or a LayerNorm)."""
    w.take(f"{ours}.weight", f"{theirs}.weight")
    w.take(f"{ours}.bias", f"{theirs}.bias")


def convert_clip_vision(w: _Writer, layers: int,
                        prefix: str = "vision_tower.vision_model",
                        root: str = "vision") -> None:
    """CLIP / SigLIP tower (HF ``CLIPVisionModel`` / ``SiglipVisionModel``
    names, CLIP's ``pre_layrnorm`` typo included)."""
    p, r = prefix, root
    w.set(f"{r}.patch_embed.weight",
          _conv(w.get(f"{p}.embeddings.patch_embedding.weight")))
    if f"{p}.embeddings.patch_embedding.bias" in w:
        w.take(f"{r}.patch_embed.bias", f"{p}.embeddings.patch_embedding.bias")
    if f"{p}.embeddings.class_embedding" in w:
        w.set(f"{r}.cls_token",
              w.get(f"{p}.embeddings.class_embedding").reshape(1, 1, -1))
    w.set(f"{r}.pos_embed",
          w.get(f"{p}.embeddings.position_embedding.weight")[None])
    if f"{p}.pre_layrnorm.weight" in w:
        _weight_bias(w, f"{r}.pre_ln", f"{p}.pre_layrnorm")
    for i in range(layers):
        lp, bt = f"{p}.encoder.layers.{i}", f"{r}.blocks.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            w.take(f"{bt}.attn.{proj}.weight", f"{lp}.self_attn.{proj}.weight")
            if f"{lp}.self_attn.{proj}.bias" in w:
                w.take(f"{bt}.attn.{proj}.bias", f"{lp}.self_attn.{proj}.bias")
        for ours, theirs in (("ln1", "layer_norm1"), ("ln2", "layer_norm2"),
                             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            _weight_bias(w, f"{bt}.{ours}", f"{lp}.{theirs}")
    _weight_bias(w, f"{r}.post_ln", f"{p}.post_layernorm")


def convert_blip2_vision(w: _Writer, layers: int,
                         prefix: str = "vision_model",
                         root: str = "vision") -> None:
    """BLIP-2's EVA ViT-g: the fused ``qkv`` [3H, H] split in three; only
    q and v have a bias (the fused bias's K slice is dropped)."""
    p, r = prefix, root
    w.set(f"{r}.patch_embed.weight",
          _conv(w.get(f"{p}.embeddings.patch_embedding.weight")))
    if f"{p}.embeddings.patch_embedding.bias" in w:
        w.take(f"{r}.patch_embed.bias", f"{p}.embeddings.patch_embedding.bias")
    w.set(f"{r}.cls_token",
          w.get(f"{p}.embeddings.class_embedding").reshape(1, 1, -1))
    pos = w.get(f"{p}.embeddings.position_embedding")
    w.set(f"{r}.pos_embed", pos.reshape(1, -1, pos.shape[-1]))
    for i in range(layers):
        lp, bt = f"{p}.encoder.layers.{i}", f"{r}.blocks.{i}"
        qw, kw, vw = w.get(f"{lp}.self_attn.qkv.weight").chunk(3)
        w.set(f"{bt}.attn.q_proj.weight", qw)
        w.set(f"{bt}.attn.k_proj.weight", kw)
        w.set(f"{bt}.attn.v_proj.weight", vw)
        if f"{lp}.self_attn.qkv.bias" in w:
            qb, _, vb = w.get(f"{lp}.self_attn.qkv.bias").chunk(3)
            w.set(f"{bt}.attn.q_proj.bias", qb)
            w.set(f"{bt}.attn.v_proj.bias", vb)
        _weight_bias(w, f"{bt}.attn.out_proj", f"{lp}.self_attn.projection")
        for ours, theirs in (("ln1", "layer_norm1"), ("ln2", "layer_norm2"),
                             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            _weight_bias(w, f"{bt}.{ours}", f"{lp}.{theirs}")
    _weight_bias(w, f"{r}.post_ln", f"{p}.post_layernorm")


def convert_llama_decoder(w: _Writer, layers: int,
                          prefix: str = "language_model.model",
                          root: str = "decoder") -> None:
    """Gemma and Vicuna (LLaMA names); LLaVA's untied ``lm_head`` is read
    when the module has one."""
    p, r = prefix, root
    w.take(f"{r}.embed.weight", f"{p}.embed_tokens.weight")
    for i in range(layers):
        lp, bt = f"{p}.layers.{i}", f"{r}.blocks.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            w.take(f"{bt}.attn.{proj}.weight", f"{lp}.self_attn.{proj}.weight")
        w.take(f"{bt}.input_norm.weight", f"{lp}.input_layernorm.weight")
        w.take(f"{bt}.post_attn_norm.weight",
               f"{lp}.post_attention_layernorm.weight")
        for proj in ("gate_proj", "up_proj", "down_proj"):
            w.take(f"{bt}.mlp.{proj}.weight", f"{lp}.mlp.{proj}.weight")
    w.take(f"{r}.final_norm.weight", f"{p}.norm.weight")
    lm_key = prefix.replace(".model", "") + ".lm_head.weight"
    if w.has(f"{r}.lm_head.weight") and lm_key in w:
        w.take(f"{r}.lm_head.weight", lm_key)


def convert_opt_decoder(w: _Writer, layers: int,
                        prefix: str = "language_model.model.decoder",
                        root: str = "decoder") -> None:
    """OPT: biased projections, ``self_attn_layer_norm`` /
    ``final_layer_norm`` a layer, the plain ``fc1`` / ``fc2`` FFN, and the
    learned position table copied whole (read at position + 2)."""
    p, r = prefix, root
    w.take(f"{r}.embed.weight", f"{p}.embed_tokens.weight")
    w.take(f"{r}.pos_embed.weight", f"{p}.embed_positions.weight")
    for i in range(layers):
        lp, bt = f"{p}.layers.{i}", f"{r}.blocks.{i}"
        for ours, theirs in (("q_proj", "q_proj"), ("k_proj", "k_proj"),
                             ("v_proj", "v_proj"), ("o_proj", "out_proj")):
            _weight_bias(w, f"{bt}.attn.{ours}", f"{lp}.self_attn.{theirs}")
        _weight_bias(w, f"{bt}.input_norm", f"{lp}.self_attn_layer_norm")
        _weight_bias(w, f"{bt}.post_attn_norm", f"{lp}.final_layer_norm")
        _weight_bias(w, f"{bt}.mlp.fc1", f"{lp}.fc1")
        _weight_bias(w, f"{bt}.mlp.down_proj", f"{lp}.fc2")
    _weight_bias(w, f"{r}.final_norm", f"{p}.final_layer_norm")


def convert_qformer(w: _Writer, layers: int, cross_freq: int,
                    prefix: str = "qformer", root: str = "projector") -> None:
    """BLIP-2's Q-Former: the query tokens, BERT self- and (every
    ``cross_freq``-th layer) cross-attention, the query FFN, and the
    language projection."""
    p, r = prefix, root
    w.take(f"{r}.query_tokens", "query_tokens")
    _weight_bias(w, f"{r}.input_ln", f"{p}.layernorm")
    for i in range(layers):
        lp, lt = f"{p}.encoder.layer.{i}", f"{r}.layers.{i}"

        def attn(ours, theirs):
            for part, hf in (("q", "query"), ("k", "key"), ("v", "value")):
                _weight_bias(w, f"{ours}.{part}", f"{theirs}.attention.{hf}")
            _weight_bias(w, f"{ours}.out", f"{theirs}.output.dense")
            _weight_bias(w, f"{ours}.ln", f"{theirs}.output.LayerNorm")

        attn(f"{lt}.self_attn", f"{lp}.attention")
        if i % cross_freq == 0:
            attn(f"{lt}.cross_attn", f"{lp}.crossattention")
        _weight_bias(w, f"{lt}.ffn_up", f"{lp}.intermediate_query.dense")
        _weight_bias(w, f"{lt}.ffn_down", f"{lp}.output_query.dense")
        _weight_bias(w, f"{lt}.ffn_ln", f"{lp}.output_query.LayerNorm")
    _weight_bias(w, f"{r}.language_projection", "language_projection")


def _convert_family(family: str, cfg, w: _Writer) -> None:
    """Run the family's maps; shared by :func:`load_vlm_weights` and
    :func:`validate_vlm_conversion`."""
    v = cfg.vision
    if family == "llava":
        convert_clip_vision(w, v.layers)
        _weight_bias(w, "projector.fc1", "multi_modal_projector.linear_1")
        _weight_bias(w, "projector.fc2", "multi_modal_projector.linear_2")
        convert_llama_decoder(w, cfg.decoder.layers)
    elif family == "paligemma":
        convert_clip_vision(w, v.layers)
        _weight_bias(w, "projector.proj", "multi_modal_projector.linear")
        convert_llama_decoder(w, cfg.decoder.layers)
    elif family == "blip2":
        convert_blip2_vision(w, v.layers)
        convert_qformer(w, cfg.qformer.layers,
                        cfg.qformer.cross_attention_frequency)
        convert_opt_decoder(w, cfg.decoder.layers)
    else:
        raise ValueError(f"unknown family {family}")


def load_vlm_weights(family: str, cfg, path,
                     module: torch.nn.Module) -> torch.nn.Module:
    """Fill ``module`` (a :class:`VLMModule` of ``cfg``, on any device) in
    place from the HF safetensors files in directory ``path``, tensor by
    tensor. Raises if a parameter of the module is left unfilled, naming
    it. A depth-cut ``cfg`` reads only its own layers."""
    refs = open_dir(Path(path))
    w = _Writer(module, _normalize_hf_keys(
        {k: ref.load for k, ref in refs.items()}))
    _convert_family(family, cfg, w)
    missing = w.unfilled()
    if missing:
        raise ValueError(f"{path}: {len(missing)} parameters of the model "
                         f"are not in the checkpoint: {missing[:10]}")
    return module


def validate_vlm_conversion(family: str, cfg, manifest: Mapping[str, dict],
                            quant_bits: int = 0, vision_quant_bits: int = 0
                            ) -> Dict[str, List[str]]:
    """The maps at full size with no weights: ``manifest`` maps checkpoint
    names to ``{"shape": [...], "dtype": "float16"}`` (the vendored hub
    manifests); the module is built on ``device="meta"`` and the sources
    are meta tensors, so nothing is allocated. Returns ``{"unconsumed":
    [...], "unfilled": [...]}``, both empty for a complete map (the
    ignorable keys aside). A shape mismatch raises."""
    src = {k: functools.partial(torch.empty, tuple(m["shape"]),
                                dtype=getattr(torch, str(m["dtype"])),
                                device="meta")
           for k, m in manifest.items()}
    module = VLMModule(cfg, device="meta", quant_bits=quant_bits,
                       vision_quant_bits=vision_quant_bits)
    w = _Writer(module, _normalize_hf_keys(src))
    _convert_family(family, cfg, w)
    unconsumed = sorted(
        k for k in w.source if k not in w.consumed
        and not any(k.endswith(s) or k == s for s in _IGNORABLE_UNCONSUMED))
    return {"unconsumed": unconsumed, "unfilled": w.unfilled()}
