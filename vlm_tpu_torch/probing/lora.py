"""LoRA for probe backbones (``vlm_tpu/probing/lora.py``).

An adapter on a Dense layer is ``A`` ``[in, r]`` and ``B`` ``[r, out]``;
the layer's effective weight is ``W + (alpha/r) * (A @ B)ᵀ`` (the port's
``Dense`` holds ``W`` as ``[out, in]``, ``vlm_tpu`` as ``[in, out]``). The
merge is functional: :func:`lora_features` runs the tower through
``torch.func.functional_call`` with the merged weights, so the frozen base
weights never change in place and gradients reach only ``A`` and ``B``.
The blocks before the adapted ones then run without autograd (B1's
no-grad form), the adapted ones through B1's differentiable form. At test
time the adapters are merged once, in place (:func:`merge_lora_`), and
inference runs at the base model's speed.

Adapters are keyed by the layer names
``VisionBackbone.get_lora_target_names`` returns
(``blocks.23.attn.q_proj``)::

    targets = backbone.get_lora_target_names({"last_k": 2, "attn_only": True})
    lora = init_lora(dict(backbone.module.named_parameters()), targets,
                     rank=8, generator=torch.Generator().manual_seed(0))
    merged = merge_lora(dict(backbone.module.named_parameters()), lora, 16.0)

Under a mesh's model axis ``A`` and ``B`` stay whole on every rank (the
full layer's shapes) and each rank adds its part of the full delta to its
shard (``shard``: :meth:`~vlm_tpu_torch.models.layers.Dense.shard_full`,
rows of a column-parallel q or v, columns of a row-parallel target); each
rank's adapter gradient then covers its part only, and the trainers sum
it over ``model`` (:meth:`..train.base_trainer.BaseTrainer.model_partial`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

LoraTree = Dict[str, Dict[str, torch.Tensor]]
#: the seed offset of the adapters' generator (``vlm_tpu`` folds 7 into
#: its key)
SEED_OFFSET = 7


def weight_shapes(params: Mapping[str, torch.Tensor]
                  ) -> Dict[str, Tuple[int, int]]:
    """Layer name -> (in_dim, out_dim) for every 2-D floating ``weight``."""
    return {n[:-len(".weight")]: (int(p.shape[1]), int(p.shape[0]))
            for n, p in params.items()
            if n.endswith(".weight") and p.dim() == 2
            and p.is_floating_point()}


def full_shapes(module: torch.nn.Module) -> Dict[str, Tuple[int, int]]:
    """Layer name -> the full layer's (in_dim, out_dim) for every float
    Dense of ``module``, whatever shard of it a rank holds."""
    return {n: (m.full_in, m.full_out) for n, m in module.named_modules()
            if hasattr(m, "full_in") and hasattr(m, "weight")}


def init_lora(params: Mapping[str, torch.Tensor], target_names: Sequence[str],
              rank: int, generator: torch.Generator,
              shapes: Optional[Mapping[str, Tuple[int, int]]] = None
              ) -> LoraTree:
    """Zero-effect adapters for ``target_names``: ``A`` He-uniform
    ``[in, r]`` (bound sqrt(6 / in), PEFT's kaiming init), drawn on the
    CPU from ``generator`` in sorted name order, ``B`` zeros ``[r, out]``;
    fp32 leaf tensors on the weight's device that require a gradient.
    ``shapes`` (:func:`full_shapes`) give the full layers' dims where a
    rank holds shards; by default the weights' own."""
    if rank < 1:
        raise ValueError(f"lora rank must be >= 1, got {rank}")
    shapes = dict(shapes) if shapes is not None else weight_shapes(params)
    lora: LoraTree = {}
    for name in sorted(set(target_names)):
        if name not in shapes:
            raise KeyError(
                f"LoRA target {name!r} has no 2-D float weight in the "
                f"tower (quantized towers hold q and scale and do not "
                f"support LoRA); available: {sorted(shapes)[:8]}...")
        d_in, d_out = shapes[name]
        device = params[f"{name}.weight"].device
        bound = math.sqrt(6.0 / d_in)
        a = torch.empty(d_in, rank).uniform_(-bound, bound,
                                             generator=generator)
        lora[name] = {
            "A": a.to(device).requires_grad_(),
            "B": torch.zeros(rank, d_out, device=device).requires_grad_(),
        }
    return lora


def merge_lora(params: Mapping[str, torch.Tensor], lora: LoraTree,
               alpha: float, shard: Optional[Callable] = None
               ) -> Dict[str, torch.Tensor]:
    """``params`` (names -> tensors) with ``weight + delta`` at every adapter
    site, cast to the weight's dtype; pure and differentiable in ``A`` and
    ``B``. ``shard(name, delta)`` cuts the full ``[out, in]`` delta to the
    rank's part of layer ``name``. An adapter without a matching layer
    raises ``KeyError``."""
    out = dict(params)
    missing = sorted(n for n in lora if f"{n}.weight" not in params)
    if missing:
        raise KeyError(f"LoRA adapters without a matching weight in the "
                       f"tower: {missing}")
    for name, ab in lora.items():
        w = params[f"{name}.weight"]
        delta = (alpha / ab["A"].shape[1]) * torch.matmul(ab["A"], ab["B"])
        delta = delta.t()
        if shard is not None:
            delta = shard(name, delta)
        out[f"{name}.weight"] = w + delta.to(w.dtype)
    return out


def module_shard(module: torch.nn.Module) -> Callable:
    """:func:`merge_lora`'s ``shard`` for ``module``'s Denses."""
    return lambda name, full: module.get_submodule(name).shard_full(
        "weight", full)


def merge_lora_(module: torch.nn.Module, lora: LoraTree,
                alpha: float) -> None:
    """Merge the adapters into ``module``'s weights once, in place (each
    rank its shard's part)."""
    params = dict(module.named_parameters())
    merged = merge_lora(params, lora, alpha, module_shard(module))
    with torch.no_grad():
        for name in lora:
            params[f"{name}.weight"].copy_(merged[f"{name}.weight"])


def lora_spec(cfg: dict) -> dict:
    """A config's ``lora:`` block: {} when disabled, else rank, alpha,
    last_k, attn_only and lr (None when missing: the head's LR)."""
    cfg = cfg or {}
    if not cfg.get("enabled"):
        return {}
    return {
        "rank": int(cfg.get("rank", 8)),
        "alpha": float(cfg.get("alpha", 16.0)),
        "last_k": int(cfg.get("last_k", 2)),
        "attn_only": bool(cfg.get("attn_only", True)),
        "lr": cfg.get("lr"),
    }


def lora_lr(spec: dict, head_lr: float) -> float:
    """The adapters' LR: an explicit ``lora.lr`` (0.0 too: a frozen-adapter
    ablation), else the head's."""
    return float(spec["lr"]) if spec.get("lr") is not None else head_lr


def resolve_lora(mcfg: dict, backbone, seed: int):
    """``(spec, adapters)`` from ``mcfg['lora']`` against ``backbone``;
    ``({}, None)`` when disabled. Shared by both trainers and the testers
    (their template: the checkpoint's values replace the draw)."""
    spec = lora_spec(mcfg.get("lora"))
    if not spec:
        return {}, None
    # a quantized tower raises inside get_lora_target_names; an empty
    # result means the selection matched nothing (e.g. last_k: 0)
    targets = backbone.get_lora_target_names(
        {"last_k": spec["last_k"], "attn_only": spec["attn_only"]})
    if not targets:
        raise ValueError(
            f"lora.enabled but the target selection matched no layers: "
            f"check lora.last_k (={spec['last_k']}) and lora.attn_only "
            f"(={spec['attn_only']}) against the tower's layer count")
    gen = torch.Generator().manual_seed(int(seed) + SEED_OFFSET)
    lora = init_lora(dict(backbone.module.named_parameters()), targets,
                     spec["rank"], gen, full_shapes(backbone.module))
    print(f"[LoRA] enabled: rank {spec['rank']}, alpha {spec['alpha']}, "
          f"{len(targets)} target layers")
    return spec, lora


def lora_named(lora: LoraTree) -> Dict[str, torch.Tensor]:
    """The adapters by checkpoint name: ``lora.<layer>.A`` / ``.B``."""
    return {f"lora.{n}.{k}": t for n, ab in lora.items()
            for k, t in ab.items()}


def load_lora_tensors(lora: LoraTree, blob: Mapping[str, torch.Tensor]
                      ) -> None:
    """Fill ``lora`` in place from :func:`lora_named`'s names (every
    adapter required)."""
    with torch.no_grad():
        for name, t in lora_named(lora).items():
            if name not in blob:
                raise KeyError(f"the checkpoint has no {name}")
            if tuple(blob[name].shape) != tuple(t.shape):
                raise ValueError(f"{name}: checkpoint "
                                 f"{tuple(blob[name].shape)} vs "
                                 f"{tuple(t.shape)}")
            t.copy_(blob[name])


def lora_features(backbone, spec: dict, lora: LoraTree
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``features(pixels) -> [B, D]``: the tower with the adapters merged
    into its weights (differentiable through the merge), or the plain
    tower when LoRA is off."""
    if not spec:
        return backbone.features
    alpha = spec["alpha"]
    module = backbone.module

    def feats(pixels: torch.Tensor) -> torch.Tensor:
        base = {f"{n}.weight": module.get_parameter(f"{n}.weight")
                for n in lora}
        return backbone.features(pixels, params=merge_lora(
            base, lora, alpha, module_shard(module)))

    return feats
