"""The port's vision backbone for probing (``vlm_tpu_torch/models/
backbone.py``) against ``vlm_tpu``'s on the CPU at the "test" size in fp32:
pooled features from the same weights and images, the unfreeze
selections as parameter names against ``vlm_tpu``'s trainable mask, the
refusals on a quantized tower, and ``get_vision_backbone``'s release of the
decoder."""

import gc
import weakref

import jax
import numpy as np
import pytest
import torch
from flax.core import meta

from vlm_tpu.models.factory import VLMModelFactory
from vlm_tpu_torch.models.factory import create_model
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.testing.bridge import flax_to_state_dict, load_flax_params

FAMILIES = {"llava": "mean", "paligemma": "mean", "blip2": "pooler"}


def _pair(family, quantization="fp32", quantize_vision=False):
    jm = VLMModelFactory.create_model(family, size="test",
                                      quantization=quantization,
                                      quantize_vision=quantize_vision)
    jb = jm.get_vision_backbone()
    tb = create_model(family, size="test", device="cpu",
                      quantization=quantization,
                      quantize_vision=quantize_vision).get_vision_backbone()
    return jb, tb


@pytest.fixture(scope="module")
def backbones():
    out = {}
    for family in FAMILIES:
        jb, tb = _pair(family)
        load_flax_params(tb.module, jax.tree.map(np.asarray,
                                                 meta.unbox(jb.params)))
        out[family] = (jb, tb)
    return out


def _images(family, backbone, n=3, seed=0):
    s = backbone.cfg.vision.image_size
    return np.random.default_rng(seed).integers(0, 256, (n, s, s, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_matches_vlm_tpu(backbones, family):
    jb, tb = backbones[family]
    assert tb.cfg.backbone_pooling == FAMILIES[family]
    u8 = _images(family, tb)
    want = np.asarray(jb.forward(u8))
    _lib.reset_counts()
    got = tb.forward(u8)
    assert got.shape == (3, tb.output_dim) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # B4 into the patch layout, then B1 per block (their plain versions)
    assert _lib.plain_calls["normalize_fp32"] == 1
    assert _lib.plain_calls["flash_attention_fp32"] == tb.vit_cfg.layers


@pytest.mark.parametrize("family", ["llava", "blip2"])
def test_strategy_and_pil_inputs(backbones, family):
    """``strategy`` overrides the pooling; PIL images take the recipe's
    host resize, as ``vlm_tpu``'s."""
    from PIL import Image
    jb, tb = backbones[family]
    u8 = _images(family, tb, seed=1)
    np.testing.assert_allclose(tb.forward(u8, strategy="cls").numpy(),
                               np.asarray(jb.forward(u8, strategy="cls")),
                               atol=1e-5, rtol=0)
    pil = [Image.fromarray(a).resize((70, 90)) for a in u8]
    np.testing.assert_allclose(tb.forward(pil).numpy(),
                               np.asarray(jb.forward(pil)), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="pooling"):
        tb.forward(u8, strategy="max")


def test_extract_features_dataset_pads_the_tail(backbones, tmp_path):
    """The dataset loop through files (``load_batch`` and B4) gives the
    features of ``forward``, with a ragged last batch."""
    from PIL import Image
    jb, tb = backbones["llava"]
    u8 = _images("llava", tb, n=5, seed=2)
    paths = []
    for i, a in enumerate(u8):
        paths.append(tmp_path / f"{i}.png")
        Image.fromarray(a).save(paths[-1])
    got = tb.extract_features_dataset(paths, batch_size=2, progress=False)
    assert got.dtype == np.float32 and got.shape == (5, tb.output_dim)
    np.testing.assert_allclose(
        got, jb.extract_features_dataset(paths, batch_size=2,
                                         progress=False),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, tb.forward(u8).numpy(), atol=1e-6,
                               rtol=0)


def _jax_trainable(jb):
    mask = flax_to_state_dict(jax.tree.map(
        np.asarray, meta.unbox(jb.trainable_mask)))
    return sorted(k for k, v in mask.items() if bool(v))


@pytest.mark.parametrize("include_embeddings", [True, False])
@pytest.mark.parametrize("parts", ["all", "attn", "mlp"])
@pytest.mark.parametrize("k", [0, 1, 2])
def test_unfreeze_selects_vlm_tpu_names(backbones, k, parts,
                                        include_embeddings):
    jb, tb = backbones["llava"]
    for b in (jb, tb):
        b.set_freeze(True)
        b.unfreeze_last_k_layers(k, parts=parts,
                                 include_embeddings=include_embeddings)
    want = _jax_trainable(jb)
    assert tb.trainable_names() == want
    assert tb.fully_frozen == (not want)
    grads = {n for n, p in tb.module.named_parameters() if p.requires_grad}
    assert grads == set(want)
    tb.set_freeze(True)
    assert tb.fully_frozen and not tb.trainable_names()


def test_set_freeze_false_trains_every_parameter(backbones):
    jb, tb = backbones["blip2"]
    jb.set_freeze(False)
    tb.set_freeze(False)
    assert tb.trainable_names() == _jax_trainable(jb) == sorted(
        n for n, _ in tb.module.named_parameters())
    tb.set_freeze(True)
    jb.set_freeze(True)


@pytest.mark.parametrize("quantization", ["8bit", "4bit"])
def test_quantized_tower_refuses_to_unfreeze(quantization):
    jb, tb = _pair("paligemma", quantization, quantize_vision=True)
    assert tb.quant_bits == jb.quant_bits > 0
    for b in (jb, tb):
        with pytest.raises(ValueError, match="quantized vision tower"):
            b.set_freeze(False)
        with pytest.raises(ValueError, match="quantized vision tower"):
            b.unfreeze_last_k_layers(1)
        b.unfreeze_last_k_layers(0, include_embeddings=False)
        assert b.fully_frozen
    # features still come out of the int8/int4 tower
    assert tb.forward(_images("paligemma", tb)).shape == (3, tb.output_dim)


def test_get_vision_backbone_releases_the_decoder():
    model = create_model("llava", size="test", device="cpu")
    decoder = weakref.ref(model.module.decoder)
    tower = model.module.vision
    bb = model.get_vision_backbone()
    gc.collect()
    assert model.module is None and decoder() is None
    assert bb.module is tower and bb.fully_frozen
    kept = create_model("llava", size="test", device="cpu")
    kept.get_vision_backbone(cleanup=False)
    assert kept.module is not None


def test_serving_model_stays_frozen_after_a_backbone_unfreezes():
    """Unfreezing works on the tower a backbone holds; a model that serves
    keeps every parameter without a gradient."""
    serving = create_model("llava", size="test", device="cpu")
    bb = create_model("llava", size="test", device="cpu") \
        .get_vision_backbone()
    bb.unfreeze_last_k_layers(1)
    assert bb.trainable_names()
    assert not any(p.requires_grad for p in serving.module.parameters())
    assert torch.is_grad_enabled()
