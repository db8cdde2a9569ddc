"""Image preprocessing: per-model recipes, host resize, and the B4
normalisation kernel (``csrc/normalize.cu``).

The host side copies ``vlm_tpu.ops.preprocess`` (PIL resize with the HF
processors' filters and sizes, bit-exact with it); PIL is imported only
when an image is resized. The device side turns a uint8 ``[B, H, W, 3]``
batch into ``x * 1/(255 std) - mean/std`` per channel in the compute dtype,
NHWC, or with ``patch_size`` straight into the patch embedding's layout:
``[B, (H/p)(W/p), p*p*3]``, the conv's HWIO order within a patch.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

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


# ------------------------- device side -------------------------

def _constants(recipe: PreprocessRecipe):
    """Per-channel (scale, bias) in fp32, as ``_normalize_pallas`` folds
    them: scale = 1/(255 std), bias = -mean/std."""
    mean = np.asarray(recipe.mean, np.float32)
    std = np.asarray(recipe.std, np.float32)
    return (np.float32(1.0) / (np.float32(255.0) * std)).astype(np.float32), \
        (-mean / std).astype(np.float32)


def _check_patches(shape, p: int) -> None:
    if len(shape) != 4 or shape[-1] != 3 or shape[1] % p or shape[2] % p:
        raise ValueError(f"patch size {p} needs [B, H, W, 3] images with H "
                         f"and W divisible by it, got {tuple(shape)}")


def unfold_patches(pixels: torch.Tensor, p: int) -> torch.Tensor:
    """NHWC ``[B, H, W, C]`` -> ``[B, (H/p)(W/p), p*p*C]`` patch vectors in
    the conv's HWIO order (row in patch, column in patch, channel): the
    ViT's unfold, a copy."""
    b, hh, ww, c = pixels.shape
    _check_patches((b, hh, ww, 3), p)
    return pixels.reshape(b, hh // p, p, ww // p, p, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b, (hh // p) * (ww // p), p * p * c)


def normalize_plain(batch_u8: torch.Tensor, recipe: PreprocessRecipe,
                    compute_dtype=torch.bfloat16,
                    patch_size: Optional[int] = None) -> torch.Tensor:
    """B4's plain version: NHWC, or with ``patch_size`` the same values
    unfolded into patch vectors. Each value is fma(x, scale, bias) rounded
    once to fp32, as the kernel and the reference's interpreted kernel
    compute it: an 8-bit integer times an fp32 scale plus an fp32 bias is
    exact in float64, so one rounding of that sum is the FMA's."""
    if patch_size is not None:
        _check_patches(tuple(batch_u8.shape), patch_size)
    _lib.plain_calls["normalize_fp32" if compute_dtype == torch.float32
                     else "normalize"] += 1
    scale, bias = (torch.from_numpy(c).to(batch_u8.device, torch.float64)
                   for c in _constants(recipe))
    x = (batch_u8.double() * scale + bias).float().to(compute_dtype)
    return x if patch_size is None else unfold_patches(x, patch_size)


def normalize_images(batch_u8: torch.Tensor, *, recipe: PreprocessRecipe,
                     compute_dtype=torch.bfloat16,
                     patch_size: Optional[int] = None) -> torch.Tensor:
    """B4. uint8 ``[B, H, W, 3]`` -> normalized ``[B, H, W, 3]`` in
    ``compute_dtype`` or, with ``patch_size`` p, ``[B, (H/p)(W/p), p*p*3]``
    patch vectors (H and W divisible by p, else ValueError): bf16 or fp32
    on the card (one kernel templated on the output type, with its own
    launch counter for fp32)."""
    if _lib.is_cpu(batch_u8, "normalize_images"):
        return normalize_plain(batch_u8, recipe, compute_dtype, patch_size)
    _lib.check_cuda("normalize_images", batch_u8)
    if batch_u8.dtype != torch.uint8 or batch_u8.shape[-1] != 3:
        raise ValueError(f"normalize_images: expected uint8 [..., 3], got "
                         f"{batch_u8.dtype} {tuple(batch_u8.shape)}")
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"normalize_images: the CUDA kernel writes bfloat16 "
                        f"or float32, not {compute_dtype}")
    x = batch_u8.contiguous()
    if patch_size is None:
        # NHWC is one patch of all the rows: leading dims fold into rows
        w = x.shape[-2] if x.dim() >= 2 else 1
        b, hh = 1, max(1, x.numel() // (3 * w))
        ph, pw, out_shape = hh, w, x.shape
    else:
        _check_patches(tuple(x.shape), patch_size)
        b, hh, w = x.shape[:3]
        ph = pw = patch_size
        out_shape = (b, (hh // ph) * (w // pw), ph * pw * 3)
    out = torch.empty(out_shape, dtype=compute_dtype, device=x.device)
    if x.numel() == 0:
        return out
    scale, bias = _constants(recipe)
    fp32 = compute_dtype == torch.float32
    _lib.launch("normalize_fp32" if fp32 else "normalize", "vlm_normalize",
                x.data_ptr(), out.data_ptr(), b, hh, w, ph, pw,
                scale.ctypes.data, bias.ctypes.data, int(fp32),
                _lib.stream_ptr(x))
    return out
