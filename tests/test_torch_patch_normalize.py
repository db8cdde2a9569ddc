"""B4 written straight into the patch embedding's layout, on the CPU.

``normalize_images(u8, ..., patch_size=p)`` returns ``[B, (H/p)(W/p),
p*p*3]`` patch vectors in the conv's HWIO order (row in patch, column in
patch, channel): the values of the NHWC normalisation followed by the
ViT's unfold. The card writes them in one pass (``csrc/normalize.cu``);
its index map is emulated here. Everything is held bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlm_tpu.ops.preprocess import RECIPES as J_RECIPES
from vlm_tpu.ops.preprocess import _normalize_pallas
from vlm_tpu_torch.models.configs import paligemma_config
from vlm_tpu_torch.models.layers import init_random_
from vlm_tpu_torch.models.vit import ViTEncoder
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.ops.preprocess import (RECIPES, normalize_images,
                                          normalize_plain, unfold_patches)

torch.set_num_threads(2)

# (recipe, image size, patch size): SigLIP So400m/14-224 (PaliGemma),
# CLIP-L/14-336 (LLaVA), EVA ViT-g/14-224 (BLIP-2)
TOWERS = {"siglip": ("siglip_224", 224, 14), "clip_l": ("clip_l_336", 336, 14),
          "eva": ("eva_vit_g", 224, 14)}
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "fp32": (torch.float32, jnp.float32)}


def _u8(b, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3),
                                                dtype=np.uint8)


def _unfold_np(x, p):
    b, h, w, c = x.shape
    return x.reshape(b, h // p, p, w // p, p, c).transpose(
        0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p), p * p * c)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_patch_plain_is_pallas_then_unfold_bitwise(tower, dtype):
    name, size, p = TOWERS[tower]
    tdt, jdt = DTYPES[dtype]
    u8 = _u8(2, size, size, seed=size)
    jr = J_RECIPES[name]
    mean = jnp.asarray(jr.mean, jnp.float32)
    std = jnp.asarray(jr.std, jnp.float32)
    pallas = _normalize_pallas(jnp.asarray(u8), 1.0 / (255.0 * std),
                               -mean / std, jdt)
    want = _unfold_np(np.asarray(pallas.astype(jnp.float32)), p)
    _lib.reset_counts()
    got = normalize_plain(torch.from_numpy(u8), RECIPES[name], tdt,
                          patch_size=p)
    assert got.dtype == tdt
    assert got.shape == (2, (size // p) ** 2, p * p * 3)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the wrapper on the CPU: the same, counted as a plain call
    again = normalize_images(torch.from_numpy(u8), recipe=RECIPES[name],
                             compute_dtype=tdt, patch_size=p)
    assert torch.equal(again, got)
    form = "normalize_fp32" if dtype == "fp32" else "normalize"
    assert _lib.plain_calls[form] == 2


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_vit_on_patches_equals_vit_on_pixels_bitwise(dtype):
    tdt = DTYPES[dtype][0]
    cfg = paligemma_config("test").vision
    vit = init_random_(ViTEncoder(cfg, dtype=tdt), seed=3)
    u8 = torch.from_numpy(_u8(3, cfg.image_size, cfg.image_size, seed=5))
    recipe = RECIPES["paligemma"]
    with torch.inference_mode():
        nhwc = vit(normalize_images(u8, recipe=recipe, compute_dtype=tdt))
        patches = vit(normalize_images(u8, recipe=recipe, compute_dtype=tdt,
                                       patch_size=cfg.patch_size))
    assert torch.equal(nhwc["last_hidden_state"],
                       patches["last_hidden_state"])
    for a, b in zip(nhwc["hidden_states"], patches["hidden_states"]):
        assert torch.equal(a, b)


def test_sizes_not_divisible_by_the_patch_raise():
    recipe = RECIPES["paligemma"]
    for shape in ((1, 30, 28, 3), (1, 28, 30, 3), (28, 28, 3)):
        u8 = torch.zeros(shape, dtype=torch.uint8)
        with pytest.raises(ValueError, match="divisible"):
            normalize_plain(u8, recipe, patch_size=14)
        with pytest.raises(ValueError, match="divisible"):
            normalize_images(u8, recipe=recipe, patch_size=14)
    with pytest.raises(ValueError, match="divisible"):
        unfold_patches(torch.zeros(1, 30, 28, 3), 14)
    cfg = paligemma_config("test").vision
    vit = ViTEncoder(cfg)
    with pytest.raises(ValueError, match="patch vectors"):
        vit(torch.zeros(1, 4, cfg.patch_size ** 2 * 3 + 1))
    # NHWC (no patch size) takes any size, as before
    out = normalize_plain(torch.zeros(1, 30, 28, 3, dtype=torch.uint8),
                          recipe)
    assert out.shape == (1, 30, 28, 3)


# ---------------------- the kernel's index map ----------------------

def _kernel_map(b, h, w, ph, pw):
    """Where ``normalize_kernel`` stores each input value: the output
    index of input element (row over the batch, e) as its loop computes
    it, 4 values a thread: one vector, two pairs, or one by one."""
    row_elems, run = w * 3, pw * 3
    patch = ph * run
    dst = np.full(b * h * row_elems, -1, np.int64)
    for row in range(b * h):
        img, yy = divmod(row, h)
        row_base = ((img * (h // ph) + yy // ph) * (w // pw)) * patch + \
            (yy % ph) * run
        for e0 in range(0, row_elems, 4):
            n = min(4, row_elems - e0)
            src = row * row_elems + e0
            within = e0 % run
            o = row_base + (e0 // run) * patch + within
            if n == 4 and within + 4 <= run and o % 4 == 0:
                dst[src:src + 4] = np.arange(o, o + 4)
            elif n == 4 and run % 2 == 0:
                dst[src:src + 2] = (o, o + 1)
                assert within + 1 < run        # a pair never leaves its run
                within += 2
                o += patch - run + 2 if within == run else 2
                dst[src + 2:src + 4] = (o, o + 1)
            else:
                for k in range(n):
                    dst[src + k] = o
                    within += 1
                    if within == run:
                        within, o = 0, o + patch - run + 1
                    else:
                        o += 1
    return dst


@pytest.mark.parametrize("b,h,w,ph,pw", [
    (2, 28, 28, 14, 14),     # runs of 42: vectors and pairs
    (1, 224, 224, 14, 14),   # SigLIP: 16 runs of 42 a 672-value row
    (2, 21, 14, 7, 7),       # runs of 21: one by one
    (2, 5, 7, 5, 7),         # NHWC, 21-value rows: a ragged last piece
    (1, 16, 48, 16, 48),     # NHWC: one patch an image, all vectors
])
def test_kernel_index_map_is_the_unfold(b, h, w, ph, pw):
    dst = _kernel_map(b, h, w, ph, pw)
    src = np.arange(b * h * w * 3).reshape(b, h, w, 3)
    if (ph, pw) == (h, w):
        want = src.reshape(-1)                 # NHWC: the identity
    else:
        want = _unfold_np(src, ph).reshape(-1)
    # output index j holds input element want[j]
    got = np.empty_like(dst)
    got[dst] = np.arange(dst.size)
    np.testing.assert_array_equal(got, want)
