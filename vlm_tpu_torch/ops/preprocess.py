"""Image preprocessing: per-model recipes, host resize, and the B4
normalisation kernel (``csrc/normalize.cu``).

The host side copies ``vlm_tpu.ops.preprocess`` (PIL resize with the HF
processors' filters and sizes, bit-exact with it); PIL is imported only
when an image is resized. The device side turns a uint8 ``[B, H, W, 3]``
batch into ``x * 1/(255 std) - mean/std`` per channel in the compute dtype,
NHWC, as the patch embedding consumes it.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from . import _lib

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)
BICUBIC = 3    # PIL.Image.Resampling.BICUBIC


@dataclasses.dataclass(frozen=True)
class PreprocessRecipe:
    """One model family's image preprocessing recipe."""
    image_size: int
    mean: tuple
    std: tuple
    # "shortest_edge_crop": resize shortest edge then center crop (CLIP);
    # "warp": resize directly to (size, size) (SigLIP, BLIP-2).
    mode: str = "warp"
    resample: int = BICUBIC


RECIPES = {
    "llava": PreprocessRecipe(336, CLIP_MEAN, CLIP_STD, mode="shortest_edge_crop"),
    "clip_l_336": PreprocessRecipe(336, CLIP_MEAN, CLIP_STD, mode="shortest_edge_crop"),
    "paligemma": PreprocessRecipe(224, SIGLIP_MEAN, SIGLIP_STD, mode="warp"),
    "siglip_224": PreprocessRecipe(224, SIGLIP_MEAN, SIGLIP_STD, mode="warp"),
    "blip2": PreprocessRecipe(224, CLIP_MEAN, CLIP_STD, mode="warp"),
    "eva_vit_g": PreprocessRecipe(224, CLIP_MEAN, CLIP_STD, mode="warp"),
}


def recipe_for(name: str) -> PreprocessRecipe:
    key = name.lower()
    if key not in RECIPES:
        raise ValueError(f"no preprocess recipe for {name!r}; "
                         f"known: {sorted(RECIPES)}")
    return RECIPES[key]


# ------------------------- host side -------------------------

def host_resize(image, recipe: PreprocessRecipe) -> np.ndarray:
    """PIL resize exactly like the HF processor; returns uint8 HWC."""
    img = image.convert("RGB") if image.mode != "RGB" else image
    s = recipe.image_size
    if recipe.mode == "warp":
        img = img.resize((s, s), resample=recipe.resample)
    elif recipe.mode == "shortest_edge_crop":
        # HF semantics: the short edge is pinned to ``s`` and the long edge
        # is truncated to int(s * long / short), then center-cropped.
        w, h = img.size
        if w <= h:
            nw, nh = s, int(s * h / w)
        else:
            nw, nh = int(s * w / h), s
        img = img.resize((nw, nh), resample=recipe.resample)
        left = (nw - s) // 2
        top = (nh - s) // 2
        img = img.crop((left, top, left + s, top + s))
    else:
        raise ValueError(f"unknown preprocess mode {recipe.mode!r}")
    return np.asarray(img, dtype=np.uint8)


def host_batch(images: Iterable, recipe: PreprocessRecipe) -> np.ndarray:
    """Stack host-resized images into a uint8 [B, S, S, 3] batch."""
    return np.stack([host_resize(im, recipe) for im in images], axis=0)


def load_batch(paths: Sequence, recipe: PreprocessRecipe) -> np.ndarray:
    """Decode and recipe-resize image files into uint8 [N, S, S, 3]."""
    from PIL import Image
    out = []
    for p in paths:
        with Image.open(p) as im:
            out.append(host_resize(im.convert("RGB"), recipe))
    return np.stack(out, axis=0)


# ------------------------- device side -------------------------

def _constants(recipe: PreprocessRecipe):
    """Per-channel (scale, bias) in fp32, as ``_normalize_pallas`` folds
    them: scale = 1/(255 std), bias = -mean/std."""
    mean = np.asarray(recipe.mean, np.float32)
    std = np.asarray(recipe.std, np.float32)
    return (np.float32(1.0) / (np.float32(255.0) * std)).astype(np.float32), \
        (-mean / std).astype(np.float32)


def normalize_plain(batch_u8: torch.Tensor, recipe: PreprocessRecipe,
                    compute_dtype=torch.bfloat16) -> torch.Tensor:
    _lib.plain_calls["normalize_fp32" if compute_dtype == torch.float32
                     else "normalize"] += 1
    scale, bias = _constants(recipe)
    x = batch_u8.float() * torch.from_numpy(scale).to(batch_u8.device)
    x = x + torch.from_numpy(bias).to(batch_u8.device)
    return x.to(compute_dtype)


def normalize_images(batch_u8: torch.Tensor, *, recipe: PreprocessRecipe,
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """B4. uint8 ``[B, S, S, 3]`` -> normalized ``[B, S, S, 3]`` in
    ``compute_dtype``: bf16 or fp32 on the card (one kernel templated on
    the output type, with its own launch counter for fp32)."""
    if _lib.is_cpu(batch_u8, "normalize_images"):
        return normalize_plain(batch_u8, recipe, compute_dtype)
    _lib.check_cuda("normalize_images", batch_u8)
    if batch_u8.dtype != torch.uint8 or batch_u8.shape[-1] != 3:
        raise ValueError(f"normalize_images: expected uint8 [..., 3], got "
                         f"{batch_u8.dtype} {tuple(batch_u8.shape)}")
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"normalize_images: the CUDA kernel writes bfloat16 "
                        f"or float32, not {compute_dtype}")
    x = batch_u8.contiguous()
    if x.data_ptr() % 4:
        raise ValueError("normalize_images: input must be 4-byte aligned")
    out = torch.empty(x.shape, dtype=compute_dtype, device=x.device)
    scale, bias = _constants(recipe)
    fp32 = compute_dtype == torch.float32
    _lib.launch("normalize_fp32" if fp32 else "normalize", "vlm_normalize",
                x.data_ptr(), out.data_ptr(), x.numel(), scale.ctypes.data,
                bias.ctypes.data, int(fp32), _lib.stream_ptr(x))
    return out
