"""The port's checkpoint readers on the CPU, against the ``safetensors``
package and ``vlm_tpu`` (both imported by this test only):

- the safetensors reader and writer (``vlm_tpu_torch/utils/safetensors_io``):
  every dtype it knows, read from files the package wrote and written for
  the package to read, bitwise; shards with and without an index against
  ``vlm_tpu``'s ``_load_safetensors``; truncated, overlapping and unknown
  files refused;
- the HF name maps at full size on ``device="meta"``
  (``validate_vlm_conversion``) over the vendored manifests of the three
  real checkpoints, in both layouts, and quantized;
- the errors of ``create_model(model_id=...)``: a missing path, a
  directory without weights, a ``vlm_tpu`` checkpoint, a mismatched
  checkpoint of the port, and a LLaVA checkpoint without ``lm_head``,
  which ``vlm_tpu`` accepts and the port refuses.

Every comparison of tensors is exact.
"""

import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

safetensors_torch = pytest.importorskip("safetensors.torch")

from vlm_tpu.models.hf_weights import _load_safetensors  # noqa: E402
from vlm_tpu_torch.models.configs import (blip2_config,  # noqa: E402
                                          llava_config, paligemma_config)
from vlm_tpu_torch.models.factory import create_model  # noqa: E402
from vlm_tpu_torch.models.hf_weights import (  # noqa: E402
    load_vlm_weights, validate_vlm_conversion)
from vlm_tpu_torch.models.vlm import VLMModule  # noqa: E402
from vlm_tpu_torch.utils import safetensors_io as st  # noqa: E402

MANIFEST_DIR = Path(__file__).parent / "goldens" / "manifests"
CASES = {
    "llava": (llava_config("7b"), "llava-1.5-7b-hf.json"),
    "paligemma": (paligemma_config("3b"), "paligemma-3b-mix-224.json"),
    "blip2": (blip2_config("6.7b"), "blip2-opt-6.7b.json"),
}
DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32, "I8": torch.int8,
          "U8": torch.uint8, "BOOL": torch.bool}


def _tensors(dtype, seed=0):
    """A few shapes of ``dtype``: a matrix, a scalar, an empty tensor."""
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        draw = lambda *s: torch.randn(s, generator=g).to(dtype)  # noqa
    elif dtype == torch.bool:
        draw = lambda *s: torch.randint(0, 2, s, generator=g).bool()  # noqa
    else:
        lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
        draw = lambda *s: torch.randint(lo, hi, s, generator=g).to(  # noqa
            dtype)
    return {"m": draw(5, 7), "s": draw(), "e": draw(0, 3), "v": draw(3)}


def _load(path):
    return {name: ref.load() for name, ref in st.open_file(path).items()}


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


# ------------------------------ the format ------------------------------

@pytest.mark.parametrize("name", sorted(DTYPES))
def test_reader_reads_what_the_package_wrote(name, tmp_path):
    want = _tensors(DTYPES[name])
    safetensors_torch.save_file(want, str(tmp_path / "a.safetensors"),
                                metadata={"format": "pt"})
    _assert_same(_load(tmp_path / "a.safetensors"), want)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_package_reads_what_the_port_wrote(name, tmp_path):
    want = _tensors(DTYPES[name], seed=1)
    # mixed with a wider dtype: every tensor stays aligned to its item size
    want["wide"] = torch.arange(3.0)
    st.save_file(want, tmp_path / "b.safetensors")
    _assert_same(safetensors_torch.load_file(str(tmp_path / "b.safetensors")),
                 want)


def test_loaded_tensors_are_writable_and_the_file_stays(tmp_path):
    """Copy-on-write maps: a loaded tensor may be written in place (no
    read-only warning), and the file does not change."""
    path = tmp_path / "c.safetensors"
    st.save_file({"w": torch.ones(4, 4)}, path)
    before = path.read_bytes()
    t = _load(path)["w"]
    t.mul_(3.0)
    assert path.read_bytes() == before
    assert torch.equal(_load(path)["w"], torch.ones(4, 4))


@pytest.mark.parametrize("index", [False, True], ids=["no_index", "index"])
def test_shards_read_as_vlm_tpu_reads_them(index, tmp_path):
    """Three shards written by the package (with or without a
    ``model.safetensors.index.json``): the port's :func:`open_dir` gives
    ``vlm_tpu``'s ``_load_safetensors`` tensors (BF16 aside: numpy has no
    bfloat16; it is held against the package)."""
    parts = [{"a.weight": torch.randn(3, 4), "a.bias": torch.randn(4)},
             {"b.weight": torch.randn(2, 2).half(),
              "b.idx": torch.arange(5)},
             {"c.mask": torch.tensor([True, False]),
              "c.q": torch.tensor([-7, 7], dtype=torch.int8)}]
    names = [f"model-0000{i + 1}-of-00003.safetensors" for i in range(3)]
    for part, name in zip(parts, names):
        safetensors_torch.save_file(part, str(tmp_path / name))
    if index:
        (tmp_path / "model.safetensors.index.json").write_text(json.dumps({
            "metadata": {}, "weight_map": {k: n for p, n in zip(parts, names)
                                           for k in p}}))
    refs = st.open_dir(tmp_path)
    ref = _load_safetensors(tmp_path)
    assert set(refs) == set(ref)
    for k, r in refs.items():
        got = r.load()
        assert np.array_equal(got.numpy(), ref[k]) and \
            got.numpy().dtype == ref[k].dtype, k
    assert refs["b.weight"].path.name == names[1]


@pytest.mark.parametrize("fault", ["short_header", "cut_header", "cut_data",
                                   "overlap", "unknown_dtype", "bad_size"])
def test_reader_refuses_a_broken_file(fault, tmp_path):
    path = tmp_path / "bad.safetensors"
    st.save_file({"a": torch.ones(4), "b": torch.zeros(4)}, path)
    raw = path.read_bytes()
    n = struct.unpack("<Q", raw[:8])[0]
    header = json.loads(raw[8:8 + n])
    if fault == "short_header":
        raw = raw[:5]
    elif fault == "cut_header":
        raw = raw[:8 + n // 2]
    elif fault == "cut_data":
        raw = raw[:-3]
    else:
        if fault == "overlap":
            header["b"]["data_offsets"] = [8, 24]
        elif fault == "unknown_dtype":
            header["a"]["dtype"] = "F8_E4M3"
        else:
            header["a"]["shape"] = [5]
        blob = json.dumps(header).encode()
        blob += b" " * (-len(blob) % 8)
        raw = struct.pack("<Q", len(blob)) + blob + raw[8 + n:]
    path.write_bytes(raw)
    with pytest.raises(ValueError, match="bad.safetensors"):
        st.open_file(path)


def test_a_name_in_two_shards_is_refused(tmp_path):
    for name in ("x-1.safetensors", "x-2.safetensors"):
        st.save_file({"w": torch.ones(2)}, tmp_path / name)
    with pytest.raises(ValueError, match="in both"):
        st.open_dir(tmp_path)


# ------------------------- the name maps, full size -------------------------

def _manifest(fname):
    return json.loads((MANIFEST_DIR / fname).read_text())


@pytest.mark.parametrize("family", sorted(CASES))
@pytest.mark.parametrize("layout", ["hub", "new_style"])
def test_production_conversion_complete(family, layout):
    """Every key of the real checkpoint consumed, every parameter of the
    full-size module filled, on ``meta``: ``vlm_tpu``'s
    ``tests/test_weight_manifests.py`` for the port."""
    cfg, fname = CASES[family]
    report = validate_vlm_conversion(family, cfg, _manifest(fname)[layout])
    assert report == {"unconsumed": [], "unfilled": []}


@pytest.mark.parametrize("family,bits", [("paligemma", 8), ("paligemma", 4),
                                         ("blip2", 8), ("llava", 8),
                                         ("llava", 4), ("blip2", 4)])
def test_production_conversion_quantized(family, bits):
    """Quantized on load at full size, the tower too (``quantize_vision``):
    int8 (q, scale) and int4 (packed q, group scales; SigLIP's fc2 at
    group 16; Vicuna's down at K = 11008, EVA's at K = 6144 and OPT's at
    16384, all group 128) from the fp checkpoint weights."""
    cfg, fname = CASES[family]
    report = validate_vlm_conversion(family, cfg, _manifest(fname)["hub"],
                                     quant_bits=bits, vision_quant_bits=bits)
    assert report == {"unconsumed": [], "unfilled": []}


def test_validation_catches_missing_extra_and_misshapen_keys():
    cfg, fname = CASES["paligemma"]
    man = dict(_manifest(fname)["hub"])
    victim = next(k for k in man if k.endswith("q_proj.weight"))
    with pytest.raises(KeyError, match="q_proj"):
        validate_vlm_conversion("paligemma", cfg,
                                {k: v for k, v in man.items() if k != victim})
    extra = dict(man)
    extra["language_model.model.layers.99.bogus.weight"] = {
        "shape": [4, 4], "dtype": "float32"}
    assert validate_vlm_conversion("paligemma", cfg, extra)["unconsumed"] == [
        "language_model.model.layers.99.bogus.weight"]
    benign = dict(man)
    benign["vision_tower.vision_model.embeddings.position_ids"] = {
        "shape": [1, 256], "dtype": "int64"}
    benign["language_model.model.layers.0.self_attn.rotary_emb.inv_freq"] = {
        "shape": [128], "dtype": "float32"}
    assert validate_vlm_conversion("paligemma", cfg, benign) == {
        "unconsumed": [], "unfilled": []}
    lcfg, lname = CASES["llava"]
    bad = dict(_manifest(lname)["hub"])
    bad["multi_modal_projector.linear_1.weight"] = {"shape": [8, 8],
                                                    "dtype": "float16"}
    with pytest.raises(ValueError, match="shape mismatch"):
        validate_vlm_conversion("llava", lcfg, bad)


def test_patch_embedding_keeps_the_hwc_order(tmp_path):
    """The OIHW conv becomes [hidden, P*P*3] in (h, w, c) order: the patch
    embedding of an unfolded NHWC image equals the conv (the order is
    invisible to every shape check). In float64, from a seed of its own:
    in fp32 the 588-term sums of the two orders differ by up to ~1e-5 on
    some draws of the shared global generator."""
    cfg = paligemma_config("test")
    module = VLMModule(cfg, dtype=torch.float32)
    p, hidden = cfg.vision.patch_size, cfg.vision.hidden
    gen = torch.Generator().manual_seed(0)
    conv = torch.randn(hidden, 3, p, p, generator=gen, dtype=torch.float64)
    from vlm_tpu_torch.models.hf_weights import _conv
    w = _conv(conv)
    img = torch.randn(1, 3, p, p, generator=gen, dtype=torch.float64)
    want = torch.nn.functional.conv2d(img, conv).reshape(hidden)
    from vlm_tpu_torch.ops.preprocess import unfold_patches
    got = unfold_patches(img.permute(0, 2, 3, 1), p)[0, 0] @ w.T
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert module.vision.patch_embed.weight.shape == w.shape


# ------------------------------- the errors -------------------------------

def test_missing_path_raises_like_vlm_tpu():
    with pytest.raises(FileNotFoundError, match="hub ids are not supported"):
        create_model("paligemma", size="test", device="cpu",
                     model_id="/nonexistent/checkpoint")


def test_directory_without_weights_raises(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="neither"):
        create_model("paligemma", size="test", device="cpu",
                     model_id=str(tmp_path))


def test_vlm_tpu_checkpoint_is_not_readable(tmp_path):
    (tmp_path / "params.msgpack").write_bytes(b"\x80")
    (tmp_path / "config.yaml").write_text("family: paligemma\n")
    with pytest.raises(ValueError, match="not readable by the port"):
        create_model("paligemma", size="test", device="cpu",
                     model_id=str(tmp_path))


@pytest.mark.parametrize("change", ["family", "quantization", "layers"])
def test_mismatched_native_checkpoint_raises(change, tmp_path):
    """A checkpoint of the port loads only into the model it describes;
    the error names both sides."""
    src = create_model("paligemma", size="test", device="cpu")
    src.save_checkpoint(tmp_path)
    kw = dict(size="test", device="cpu", model_id=str(tmp_path))
    if change == "family":
        with pytest.raises(ValueError, match="family: checkpoint 'paligemma'"
                                             ", model 'llava'"):
            create_model("llava", **kw)
    elif change == "quantization":
        with pytest.raises(ValueError, match="quantization: checkpoint "
                                             "'fp32', model '8bit'"):
            create_model("paligemma", quantization="8bit", **kw)
    else:
        import yaml
        meta = yaml.safe_load((tmp_path / "config.yaml").read_text())
        meta["decoder_layers"] = 3
        (tmp_path / "config.yaml").write_text(yaml.safe_dump(meta))
        with pytest.raises(ValueError, match="decoder_layers: checkpoint 3, "
                                             "model 2"):
            create_model("paligemma", **kw)


@pytest.fixture(scope="module")
def llava_without_head(tmp_path_factory):
    """The tiny HF LLaVA (``vlm_tpu/testing/hf_tiny.py``, seed 7) with its
    ``lm_head`` removed from the file."""
    pytest.importorskip("transformers")
    from vlm_tpu.testing import HF_BUILDERS
    d = tmp_path_factory.mktemp("llava_nohead")
    HF_BUILDERS["llava"](d, seed=7)
    files = sorted(d.glob("*.safetensors"))
    for f in files:
        tensors = safetensors_torch.load_file(str(f))
        heads = [k for k in tensors if k.endswith("lm_head.weight")]
        for k in heads:
            del tensors[k]
        safetensors_torch.save_file(tensors, str(f))
    return d


def test_llava_without_lm_head_refused_where_vlm_tpu_keeps_it(
        llava_without_head):
    """``vlm_tpu`` loads the checkpoint and keeps its untied head as it
    was (random weights); the port refuses, naming the parameter."""
    import jax
    import jax.numpy as jnp
    from flax.core import meta

    from vlm_tpu.models.configs import llava_config as jax_config
    from vlm_tpu.models.hf_weights import load_vlm_weights as jax_load
    from vlm_tpu.models.vlm import init_vlm
    jcfg = jax_config("test")
    _, params = init_vlm(jcfg, jax.random.key(0), dtype=jnp.float32)

    def head(tree):
        return np.asarray(meta.unbox(tree)["params"]["decoder"]["lm_head"][
            "kernel"])

    assert np.array_equal(
        head(jax_load("llava", jcfg, llava_without_head, params)),
        head(params))
    with pytest.raises(ValueError, match=r"decoder\.lm_head\.weight"):
        create_model("llava", size="test", device="cpu",
                     model_id=str(llava_without_head))
    module = VLMModule(llava_config("test"))
    with pytest.raises(ValueError, match="1 parameters"):
        load_vlm_weights("llava", llava_config("test"), llava_without_head,
                         module)


def test_load_reads_each_tensor_once_and_no_more(tmp_path, monkeypatch):
    """Tensor by tensor: a depth-cut load maps only the tensors of its own
    layers, each once."""
    pytest.importorskip("transformers")
    from vlm_tpu.testing import HF_BUILDERS
    HF_BUILDERS["paligemma"](tmp_path, seed=7)
    loads = []
    real = st.TensorRef.load

    def counted(self):
        loads.append((self.path, self.offset))
        return real(self)

    monkeypatch.setattr(st.TensorRef, "load", counted)
    import dataclasses
    full = paligemma_config("test")
    cut = dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, layers=1),
        decoder=dataclasses.replace(full.decoder, layers=1))
    load_vlm_weights("paligemma", cut, tmp_path, VLMModule(cut))
    n_cut = len(loads)
    loads.clear()
    load_vlm_weights("paligemma", full, tmp_path, VLMModule(full))
    assert len(set(loads)) == len(loads)
    assert 0 < n_cut < len(loads) <= len(st.open_dir(tmp_path))
