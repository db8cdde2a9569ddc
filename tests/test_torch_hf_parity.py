"""The port served from a local HF checkpoint, on the CPU: the three tiny
HF models of ``vlm_tpu/testing/hf_tiny.py`` (built from config with seed
7, saved as safetensors) loaded through ``create_model(...,
model_id=<dir>)``.

- The loaded ``state_dict`` is bitwise equal to ``flax_to_state_dict`` of
  ``vlm_tpu``'s ``load_vlm_weights`` on the same directory, in fp32, bf16,
  8bit and 4bit (quantized on load), and with ``quantize_vision``.
- Prefill logits match HF's within ``rtol=2e-3, atol=5e-4``, the tolerance
  of ``tests/test_hf_parity.py``; greedy tokens through the port's
  ``ContinuousBatcher`` are identical to HF ``generate``'s over 16 steps.
- The port's own checkpoint round-trips bitwise and gives identical tokens.
- The tokenizer comes from ``model_id``; the CLI passes ``model_id`` on.
"""

import json
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

pytest.importorskip("transformers")

from vlm_tpu.models.configs import VLM_CONFIGS as JAX_CONFIGS  # noqa: E402
from vlm_tpu.models.hf_weights import \
    load_vlm_weights as jax_load_vlm_weights  # noqa: E402
from vlm_tpu.models.vlm import VLMModule as JaxVLMModule  # noqa: E402
from vlm_tpu.testing import (HF_BUILDERS, IMAGE_TOKEN,  # noqa: E402
                             hf_text_ids, rand_pixels)
from vlm_tpu_torch.generate.batcher import ContinuousBatcher  # noqa: E402
from vlm_tpu_torch.models.factory import create_model  # noqa: E402
from vlm_tpu_torch.models.vlm import num_image_tokens  # noqa: E402
from vlm_tpu_torch.testing.bridge import flax_to_state_dict  # noqa: E402

torch.set_num_threads(2)
FAMILIES = ("llava", "paligemma", "blip2")
BATCH, MAX_NEW = 2, 16
PROMPT = "Describe the clothing of the person"
# tests/test_hf_parity.py's tolerance for full-forward logits
LOGIT_TOL = dict(rtol=2e-3, atol=5e-4)
# (quantization, quantize_vision)
MODES = [("fp32", False), ("bf16", False), ("8bit", False), ("4bit", False),
         ("8bit", True)]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """family -> (checkpoint directory, the HF model saved there)."""
    out = {}
    for family in FAMILIES:
        d = tmp_path_factory.mktemp(f"hf_{family}")
        out[family] = (d, HF_BUILDERS[family](d, seed=7))
    return out


def _jax_state(family, path, quantization, quantize_vision):
    """``flax_to_state_dict`` of ``vlm_tpu``'s ``load_vlm_weights`` on
    ``path``, over the param tree ``VLMModel`` builds for the mode (its
    shapes from ``jax.eval_shape``: every leaf is overwritten)."""
    cfg = JAX_CONFIGS[family]("test")
    bits = {"8bit": 8, "4bit": 4}.get(quantization, 0)
    dtype = jnp.float32 if quantization == "fp32" else jnp.bfloat16
    module = JaxVLMModule(cfg, dtype=dtype, param_dtype=dtype,
                          quant_bits=bits,
                          vision_quant_bits=bits if quantize_vision else 0)
    s = cfg.vision.image_size
    shapes = jax.eval_shape(
        module.init, jax.random.key(0), jax.ShapeDtypeStruct(
            (1, s, s, 3), dtype),
        jax.ShapeDtypeStruct((1, 2), jnp.int32),
        jax.ShapeDtypeStruct((1, 2), jnp.int32))
    params = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes)
    params = jax_load_vlm_weights(family, cfg, path, params)
    # bf16 widens exactly to fp32 (numpy's bf16 does not reach torch)
    tree = jax.tree.map(
        lambda x: np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                             else x), meta.unbox(params))
    return flax_to_state_dict(tree)


def _assert_bitwise(got, ref):
    assert set(got) == set(ref)
    for name, t in got.items():
        r = ref[name]
        if name.endswith(".scale") and t.dim() == 2 and r.dim() == 1:
            r = r[:, None]            # an int4 Dense with one group
        t = t.float() if t.dtype == torch.bfloat16 else t
        assert t.shape == r.shape and t.dtype == r.dtype, name
        assert torch.equal(t, r), name


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("quantization,quantize_vision", MODES,
                         ids=[f"{q}{'_qv' if v else ''}" for q, v in MODES])
def test_state_dict_bitwise_equal_to_vlm_tpu(ckpts, family, quantization,
                                             quantize_vision):
    path, _ = ckpts[family]
    model = create_model(family, model_id=str(path), size="test",
                         device="cpu", quantization=quantization,
                         quantize_vision=quantize_vision)
    _assert_bitwise(model.module.state_dict(),
                    _jax_state(family, path, quantization, quantize_vision))


def _hf_ids(model, batch):
    pre, post = hf_text_ids(model, PROMPT)
    ids = list(pre) + [IMAGE_TOKEN] * num_image_tokens(model.cfg) + list(post)
    return pre, post, torch.tensor([ids] * batch, dtype=torch.long)


@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_logits_match_hf(ckpts, family):
    path, hf = ckpts[family]
    model = create_model(family, model_id=str(path), size="test",
                         device="cpu")
    px = rand_pixels(BATCH, model.cfg.vision.image_size, seed=5)
    pre, post, input_ids = _hf_ids(model, BATCH)
    with torch.no_grad():
        ref = hf(input_ids=input_ids, pixel_values=torch.from_numpy(px),
                 attention_mask=torch.ones_like(input_ids)).logits
        got = model.module(
            torch.from_numpy(px.transpose(0, 2, 3, 1).copy()),
            torch.tensor([pre] * BATCH, dtype=torch.int32).reshape(BATCH, -1),
            torch.tensor([post] * BATCH, dtype=torch.int32))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **LOGIT_TOL)


def _serve(model, px):
    pre, post = hf_text_ids(model, PROMPT)
    plen = len(pre) + num_image_tokens(model.cfg) + len(post)
    return ContinuousBatcher(
        model.module, model.cfg, batch_size=BATCH, max_prompt_len=plen,
        max_new_tokens=MAX_NEW, eos_id=model.tokenizer.eos_id,
        pad_id=0).run(
        lambda idxs: torch.from_numpy(px[idxs].transpose(0, 2, 3, 1).copy()),
        pre_ids_row=np.asarray(pre, np.int32),
        post_ids_row=np.asarray(post, np.int32), prompt_len_scalar=plen,
        n_images=len(px))


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_tokens_match_hf_generate(ckpts, family):
    path, hf = ckpts[family]
    model = create_model(family, model_id=str(path), size="test",
                         device="cpu")
    px = rand_pixels(BATCH, model.cfg.vision.image_size, seed=11)
    _, _, input_ids = _hf_ids(model, BATCH)
    eos = model.tokenizer.eos_id
    with torch.no_grad():
        out = hf.generate(
            input_ids=input_ids, pixel_values=torch.from_numpy(px),
            attention_mask=torch.ones_like(input_ids), do_sample=False,
            num_beams=1, max_new_tokens=MAX_NEW, pad_token_id=0,
            use_cache=True).numpy()
    n = input_ids.shape[1]
    if out.shape[1] >= n and np.array_equal(out[:, :n], input_ids.numpy()):
        out = out[:, n:]
    got = _serve(model, px)
    for i in range(BATCH):
        ref = [int(t) for t in out[i]]
        if eos in ref:                 # the port's results drop the EOS
            ref = ref[:ref.index(eos)]
        assert got[i] == ref, (family, i)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("quantization", ["fp32", "8bit"])
def test_native_checkpoint_round_trips(ckpts, family, quantization,
                                       tmp_path):
    """``save_checkpoint`` then ``model_id``: the same state, bit for bit
    (int8 ``q`` and fp32 ``scale`` as they are), and the same tokens."""
    path, _ = ckpts[family]
    kw = dict(size="test", device="cpu", quantization=quantization,
              quantize_vision=quantization == "8bit")
    model = create_model(family, model_id=str(path), **kw)
    model.save_checkpoint(tmp_path / "native")
    assert sorted(p.name for p in (tmp_path / "native").iterdir()) == [
        "config.yaml", "params.safetensors"]
    back = create_model(family, model_id=str(tmp_path / "native"), **kw)
    own = model.module.state_dict()
    for name, t in back.module.state_dict().items():
        assert t.dtype == own[name].dtype and torch.equal(t, own[name]), name
    px = rand_pixels(3, model.cfg.vision.image_size, seed=2)
    assert _serve(back, px) == _serve(model, px)


def _write_bpe(path):
    """A byte-level BPE vocabulary: the specials, the 256 byte symbols and
    one merge ("h" "e")."""
    from vlm_tpu_torch.data.bpe import bytes_to_unicode
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2}
    for sym in bytes_to_unicode().values():
        vocab[sym] = len(vocab)
    vocab["he"] = len(vocab)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\nh e\n")
    return vocab


def test_tokenizer_comes_from_model_id(ckpts, tmp_path, monkeypatch):
    """With ``vocab.json`` + ``merges.txt`` beside the weights, the model's
    tokenizer is the byte-level BPE reader (transformers blocked: the
    port reads the files itself); without them, the byte fallback."""
    from vlm_tpu_torch.data.bpe import ByteLevelBPE
    from vlm_tpu_torch.data.tokenizer import ByteTokenizer
    monkeypatch.setitem(sys.modules, "transformers", None)
    src, _ = ckpts["blip2"]
    model = create_model("blip2", model_id=str(src), size="test",
                         device="cpu")
    assert isinstance(model.tokenizer, ByteTokenizer)
    d = tmp_path / "blip2"
    shutil.copytree(src, d)
    vocab = _write_bpe(d)
    model = create_model("blip2", model_id=str(d), size="test", device="cpu")
    tok = model.tokenizer
    assert isinstance(tok, ByteLevelBPE)
    assert tok.encode("hex", add_bos=True) == [0, vocab["he"], vocab["x"]]
    assert (tok.bos_id, tok.eos_id, tok.pad_id) == (0, 2, 1)


def test_cli_serves_a_local_checkpoint(ckpts, mivia_base, tmp_path,
                                       monkeypatch):
    """The port's CLI with ``model_id:`` on the tiny LLaVA checkpoint over
    a synthetic MiviaPar split on the CPU: the model it builds holds the
    checkpoint's weights."""
    import yaml

    from vlm_tpu_torch.models import factory
    from vlm_tpu_torch.scripts.prompt_inference import main
    path, hf = ckpts["llava"]
    cfg = {"model_name": "llava", "model_size": "test", "model_id": str(path),
           "quantization": "fp32", "dataset_name": "MiviaPar",
           "max_tokens": 2, "batch_size": 2,
           "dataset": {"base_path": str(mivia_base)},
           "prompts": {"MiviaPar": "colors?"}}
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    monkeypatch.setenv("VLM_TPU_ROOT", str(tmp_path))
    monkeypatch.setenv("VLM_TPU_PLATFORM", "cpu")
    built = []
    real = factory.create_model

    def spy(*args, **kwargs):
        built.append(real(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(factory, "create_model", spy)
    summary = main(["--config", str(tmp_path / "cfg.yaml"), "--limit", "3"])
    assert summary["images_completed"] == 3
    assert len(built) == 1 and built[0].model_id == str(path)
    head = hf.state_dict()["lm_head.weight"]
    assert torch.equal(built[0].module.decoder.lm_head.weight, head)


@pytest.mark.parametrize("family", FAMILIES)
def test_synthetic_checkpoint_loads_as_in_vlm_tpu(ckpts, family, tmp_path):
    """``testing/checkpoints.py``, which ``chip_smoke.py`` uses at full
    size: the tiny checkpoint's key set rewritten with drawn values in
    three shards (LLaVA's in fp16, as its hub files), then loaded by both
    packages, 8bit on load: bitwise equal; no norm or bias at its init
    constant."""
    from vlm_tpu_torch.testing.checkpoints import write_synthetic_checkpoint
    from vlm_tpu_torch.utils.safetensors_io import open_dir
    dtype = "float16" if family == "llava" else "float32"
    manifest = {k: {"shape": list(r.shape), "dtype": dtype}
                for k, r in open_dir(ckpts[family][0]).items()}
    write_synthetic_checkpoint(manifest, tmp_path, shards=3, seed=3)
    assert len(list(tmp_path.glob("*.safetensors"))) == 3
    model = create_model(family, model_id=str(tmp_path), size="test",
                         device="cpu", quantization="8bit")
    state = model.module.state_dict()
    _assert_bitwise(state, _jax_state(family, tmp_path, "8bit", False))
    for name, t in state.items():
        if name.endswith(("norm.weight", "ln1.weight", ".bias")):
            assert not torch.all(t == t.flatten()[0]), name
