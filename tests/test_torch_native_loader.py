"""The port's image loader (``vlm_tpu_torch/data/native_loader.py`` over its
own copy of the C++ loader) against ``vlm_tpu.data.native_loader``, with
both shared objects built here (g++, libjpeg and libpng):

- bitwise the same uint8 batches over JPEGs in both resize modes, grey,
  palette, interlaced and tall PNGs, a BMP inside a batch (the per-file PIL
  retry) and a mixed batch;
- a corrupt JPEG raises in both; ``use_native=False`` is vlm_tpu's PIL
  path, bitwise;
- ``generate_dataset`` over JPEG files gives vlm_tpu's texts, and
  ``VisionBackbone.extract_features_dataset`` and ``generate_dataset``
  decode through the loader;
- the build lands in ``vlm_tpu_torch/_build`` under the source's hash, and
  a failed build prints the compiler's error and falls back to PIL.
"""

import jax
import numpy as np
import pytest
from flax.core import meta
from PIL import Image

from vlm_tpu.data import native_loader as jax_loader
from vlm_tpu.ops.preprocess import recipe_for as jax_recipe
from vlm_tpu_torch.data import native_loader
from vlm_tpu_torch.native import build
from vlm_tpu_torch.ops.preprocess import recipe_for


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    out = {}

    def save(name, img, **kw):
        out[name] = d / name
        img.save(out[name], **kw)

    for i, (h, w) in enumerate([(240, 180), (180, 240), (336, 336),
                                (500, 120), (64, 90), (600, 800)]):
        save(f"j{i}.jpg", Image.fromarray(
            rng.integers(0, 255, (h, w, 3), dtype=np.uint8)), quality=90)
    save("grey.png", Image.fromarray(
        rng.integers(0, 255, (70, 90), dtype=np.uint8), mode="L"))
    save("palette.png", Image.fromarray(
        rng.integers(0, 255, (80, 60, 3), dtype=np.uint8)).convert("P"))
    save("interlaced.png", Image.fromarray(
        rng.integers(0, 255, (77, 93, 3), dtype=np.uint8)), interlace=1)
    save("tall.png", Image.fromarray(
        rng.integers(0, 255, (400, 50, 3), dtype=np.uint8)))
    save("rgba.png", Image.fromarray(
        rng.integers(0, 255, (45, 66, 4), dtype=np.uint8), mode="RGBA"))
    save("x.bmp", Image.fromarray(
        rng.integers(0, 255, (50, 70, 3), dtype=np.uint8)))
    (d / "bad.jpg").write_bytes(b"\xff\xd8\xff\xe0 this is not a jpeg")
    out["bad.jpg"] = d / "bad.jpg"
    return out


def test_both_loaders_build():
    assert native_loader.native_available()
    assert jax_loader.native_available()
    lib = build.library_path()
    assert lib.parent.name == "_build" and lib.exists()
    assert lib.parent.parent.name == "vlm_tpu_torch"


BATCHES = {
    "jpegs": ["j0.jpg", "j1.jpg", "j2.jpg", "j3.jpg", "j4.jpg", "j5.jpg"],
    "pngs": ["grey.png", "palette.png", "interlaced.png", "tall.png",
             "rgba.png"],
    "bmp_inside": ["j0.jpg", "x.bmp", "j1.jpg"],
    "mixed": ["tall.png", "j3.jpg", "x.bmp", "grey.png", "j5.jpg"],
}


@pytest.mark.parametrize("family", ["paligemma", "llava", "blip2"])
@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_native_batches_bitwise_vlm_tpus(files, batch, family):
    paths = [files[n] for n in BATCHES[batch]]
    got = native_loader.load_batch(paths, recipe_for(family), threads=2)
    want = jax_loader.load_batch(paths, jax_recipe(family), threads=2)
    size = recipe_for(family).image_size
    assert got.dtype == np.uint8 and got.shape == (len(paths), size, size, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family", ["paligemma", "llava"])
def test_pil_path_bitwise_vlm_tpus(files, family):
    paths = [files[n] for n in BATCHES["mixed"]]
    got = native_loader.load_batch(paths, recipe_for(family),
                                   use_native=False)
    np.testing.assert_array_equal(
        got, jax_loader.load_batch(paths, jax_recipe(family),
                                   use_native=False))
    # and the native decode differs from PIL's (another resampler)
    assert not np.array_equal(
        got, native_loader.load_batch(paths, recipe_for(family)))


@pytest.mark.parametrize("use_native", [None, False])
def test_corrupt_jpeg_raises_in_both(files, use_native):
    paths = [files["j0.jpg"], files["bad.jpg"]]
    for load, recipe in ((native_loader.load_batch, recipe_for),
                         (jax_loader.load_batch, jax_recipe)):
        with pytest.raises(Exception):
            load(paths, recipe("paligemma"), use_native=use_native)


def test_failed_build_prints_and_falls_back(files, monkeypatch, capsys,
                                            tmp_path):
    """A compiler error is printed once; the batches then come from PIL."""
    bad = tmp_path / "imgloader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "SRC", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_lib_checked", False)
    paths = [files["j0.jpg"], files["grey.png"]]
    r = recipe_for("paligemma")
    got = native_loader.load_batch(paths, r)
    out = capsys.readouterr().out
    assert "[native] imgloader build failed:" in out and "error" in out
    assert not native_loader.native_available()
    assert capsys.readouterr().out == ""
    np.testing.assert_array_equal(
        got, native_loader.load_batch(paths, r, use_native=False))
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.fixture(scope="module")
def models():
    from vlm_tpu.models.factory import VLMModelFactory
    from vlm_tpu_torch.models.factory import create_model
    from vlm_tpu_torch.testing.bridge import load_flax_params
    jm = VLMModelFactory.create_model("paligemma", size="test",
                                      quantization="fp32")
    pm = create_model("paligemma", size="test", device="cpu")
    load_flax_params(pm.module, jax.tree.map(np.asarray,
                                             meta.unbox(jm.params)))
    return jm, pm


def test_generate_dataset_over_jpegs_gives_vlm_tpus_texts(models, files,
                                                          monkeypatch):
    """Continuous batching over JPEG files: the port's texts are vlm_tpu's,
    and every batch was decoded by the native loader."""
    from vlm_tpu_torch.models import base_model
    jm, pm = models
    paths = [files[n] for n in BATCHES["jpegs"] + ["j2.jpg", "j4.jpg"]]
    calls = []
    real = base_model.load_batch

    def spy(p, recipe, **kw):
        calls.append(len(p))
        return real(p, recipe, **kw)
    monkeypatch.setattr(base_model, "load_batch", spy)
    got = pm.generate_dataset(paths, "colour?", max_tokens=4, batch_size=3)
    assert got == jm.generate_dataset(paths, "colour?", max_tokens=4,
                                      batch_size=3)
    assert sum(calls) == len(paths)
    assert native_loader.native_available()


def test_backbone_extract_decodes_through_the_loader(models, files,
                                                     monkeypatch):
    from vlm_tpu_torch.models import backbone
    _, pm = models
    tb = pm.get_vision_backbone(cleanup=False)
    paths = [files[n] for n in BATCHES["mixed"]]
    calls = []
    real = backbone.load_batch

    def spy(p, recipe, **kw):
        calls.append(len(p))
        return real(p, recipe, **kw)
    monkeypatch.setattr(backbone, "load_batch", spy)
    got = tb.extract_features_dataset(paths, batch_size=2, progress=False)
    assert calls == [2, 2, 1]
    u8 = native_loader.load_batch(paths, tb.recipe)
    np.testing.assert_allclose(got, tb.forward(u8).numpy(), atol=1e-6,
                               rtol=0)
