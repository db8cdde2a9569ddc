"""The port's wave engine (``GenerationEngine``) and the model's
``generate_batch`` / ``generate_text`` / ``generate_dataset(num_beams=2)``
against vlm_tpu's, on the CPU at the "test" size in fp32 (and 8bit + int8
KV, 4bit), with vlm_tpu's weights copied through the bridge and inputs
from a numpy seed. Greedy tokens and lengths must be identical; the
decoded strings equal.

LLaVA's "test" pad id (32001) lies past its vocabulary: vlm_tpu feeds it
to its done rows (NaN rows of their own), the port feeds 0 and keeps 32001
in its results; so vlm_tpu runs LLaVA with ``pad_id=0`` and the padding
after each row's length is compared as each engine's own pad id.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta
from PIL import Image

from tests.test_torch_blip2 import _affine_from_seed
from vlm_tpu.generate.decode import GenerationEngine as JaxEngine
from vlm_tpu.models.configs import VLM_CONFIGS as JAX_CONFIGS
from vlm_tpu.models.vlm import init_vlm
from vlm_tpu_torch.generate import decode as port_decode
from vlm_tpu_torch.generate.batcher import ContinuousBatcher
from vlm_tpu_torch.generate.decode import GenerationEngine
from vlm_tpu_torch.models import decoder as port_decoder
from vlm_tpu_torch.models.configs import VLM_CONFIGS
from vlm_tpu_torch.models.factory import create_model
from vlm_tpu_torch.models.vlm import VLMModule, num_image_tokens
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.testing.bridge import load_flax_params

torch.set_num_threads(2)
_PAIRS = {}


def pair(family="paligemma", bits=0):
    """vlm_tpu's VLM and the port's on the same weights (fp32 compute;
    ``bits`` 8 or 4: int8 or int4 decoder and vision blocks); BLIP-2's
    biases and norms drawn from a seed, as in its own tests."""
    if (family, bits) not in _PAIRS:
        jcfg = JAX_CONFIGS[family]("test")
        jmod, params = init_vlm(jcfg, jax.random.key(0), dtype=jnp.float32,
                                quant_bits=bits, vision_quant_bits=bits)
        tree = jax.tree.map(np.asarray, meta.unbox(params))
        if family == "blip2":
            tree = _affine_from_seed(tree)
            params = jax.tree.map(jnp.asarray, tree)
        cfg = VLM_CONFIGS[family]("test")
        tmod = VLMModule(cfg, dtype=torch.float32, quant_bits=bits,
                         vision_quant_bits=bits)
        load_flax_params(tmod, tree)
        _PAIRS[family, bits] = (jcfg, jmod, params, cfg, tmod)
    return _PAIRS[family, bits]


def _inputs(cfg, b, n_pre, post_lens, seed):
    """Pixels, left-aligned pre/post ids (post padded with 0) and the true
    merged lengths; LLaVA's pre ids start with BOS."""
    s = cfg.vision.image_size
    rng = np.random.default_rng(seed)
    px = rng.normal(size=(b, s, s, 3)).astype(np.float32)
    pre = rng.integers(3, 500, (b, n_pre)).astype(np.int32)
    if n_pre:
        pre[:, 0] = cfg.decoder.bos_token_id
    post = np.zeros((b, max(post_lens)), np.int32)
    for i, n in enumerate(post_lens):
        post[i, :n] = rng.integers(3, 500, n)
    plen = np.asarray([n_pre + num_image_tokens(cfg) + n for n in post_lens],
                      np.int32)
    return px, pre, post, plen


def _spy_writes(monkeypatch):
    """Record each decode-step attention's write form: (uniform, number of
    write offsets)."""
    seen = []
    real = port_decoder.decode_attention

    def spy(*args, **kw):
        seen.append((kw["uniform"], kw["write_start"].numel()))
        return real(*args, **kw)
    monkeypatch.setattr(port_decoder, "decode_attention", spy)
    return seen


def _run_both(family, bits, b, post_lens, max_new, caps=None, eos=None,
              n_pre=0, seed=0, cache="fp32"):
    jcfg, jmod, params, cfg, tmod = pair(family, bits)
    px, pre, post, plen = _inputs(cfg, b, n_pre, post_lens, seed)
    width = n_pre + num_image_tokens(cfg) + post.shape[1]
    jpad = 0 if family == "llava" else None
    jcache = "int8" if cache == "int8" else jnp.float32
    ref = JaxEngine(jmod, jcfg, batch_size=b, max_prompt_len=width,
                    max_new_tokens=max_new, cache_dtype=jcache, eos_id=eos,
                    pad_id=jpad).generate(
        params, jnp.asarray(px), jnp.asarray(pre), jnp.asarray(post),
        jnp.asarray(plen), max_new_per_seq=None if caps is None else
        jnp.asarray(caps, jnp.int32))
    eng = GenerationEngine(tmod, cfg, batch_size=b, max_prompt_len=width,
                           max_new_tokens=max_new,
                           cache_dtype="int8" if cache == "int8" else None,
                           eos_id=eos)
    got = eng.generate(torch.from_numpy(px), torch.from_numpy(pre),
                       torch.from_numpy(post), torch.from_numpy(plen),
                       max_new_per_seq=None if caps is None else
                       torch.tensor(caps))
    toks, lens = got.tokens.numpy(), got.lengths.numpy()
    rtoks, rlens = np.asarray(ref.tokens), np.asarray(ref.lengths)
    np.testing.assert_array_equal(lens, rlens)
    for i in range(b):
        np.testing.assert_array_equal(toks[i, :lens[i]], rtoks[i, :lens[i]])
        assert (toks[i, lens[i]:] == eng.pad_id).all()
    return eng, toks, lens


@pytest.mark.parametrize("family", ["paligemma", "llava", "blip2"])
def test_greedy_tokens_and_lengths_identical_to_jax(family, monkeypatch):
    """Per-row caps and an EOS id the model emits (the first greedy run's
    first token of row 0 after its first that begins no row): rows stop
    at their caps or their EOS and pad after it; every decode step writes
    at one shared column."""
    n_pre = 4 if family == "llava" else 0
    seen = _spy_writes(monkeypatch)
    eng, toks, _ = _run_both(family, 0, 3, [3, 3, 3], 7, n_pre=n_pre,
                             seed=1)
    assert all(u and n == 1 for u, n in seen) and seen
    eos = int(next(t for t in toks[0, 1:] if t not in toks[:, 0]))
    _lib.reset_counts()
    eng, toks, lens = _run_both(family, 0, 3, [3, 3, 3], 7,
                                caps=[6, 1, 7], eos=eos, n_pre=n_pre, seed=1)
    assert lens[1] == 1 and lens[0] < 7 and toks[0, lens[0] - 1] == eos
    assert _lib.launches == dict.fromkeys(_lib.KERNELS, 0)
    assert _lib.plain_calls["decode_attention_fp32"] > 0
    assert eng.last_stats["steps"] == lens.max() - 1


def test_all_caps_one_and_single_row():
    _, _, lens = _run_both("paligemma", 0, 3, [2, 2, 2], 5, caps=[1, 1, 1],
                           seed=2)
    assert (lens == 1).all()
    _run_both("paligemma", 0, 1, [4], 6, seed=3)


def test_non_uniform_prompts_take_the_scatter_form(monkeypatch):
    """Mixed prompt lengths: every decode step writes each row at its own
    column (a shared one would overwrite the longer prompts' rows)."""
    seen = _spy_writes(monkeypatch)
    _run_both("paligemma", 0, 2, [2, 5], 5, seed=9)
    assert seen and all(not u and n == 2 for u, n in seen)


@pytest.mark.parametrize("bits,cache", [(8, "int8"), (4, "fp32")],
                         ids=["8bit_int8kv", "4bit"])
def test_quantized_modes_identical_to_jax(bits, cache):
    _lib.reset_counts()
    _run_both("paligemma", bits, 3, [3, 3, 3], 6, caps=[6, 2, 4],
              seed=4, cache=cache)
    form = "int8_matmul" if bits == 8 else "int4_matmul"
    assert _lib.plain_calls[form] > 0
    if cache == "int8":
        assert _lib.plain_calls["decode_attention_int8"] > 0


def test_continuous_batcher_equals_the_wave_engine():
    """Greedy decoding is deterministic: the batcher (3 slots over 7
    images) gives each image the wave engine's tokens."""
    _, _, _, cfg, tmod = pair()
    n, max_new = 7, 6
    px, pre, post, plen = _inputs(cfg, n, 0, [3] * n, seed=2)
    post = np.ascontiguousarray(np.broadcast_to(post[:1], post.shape))
    wave = GenerationEngine(tmod, cfg, batch_size=n,
                            max_prompt_len=int(plen[0]),
                            max_new_tokens=max_new).generate(
        torch.from_numpy(px), torch.from_numpy(pre), torch.from_numpy(post),
        torch.from_numpy(plen))
    want = [[int(t) for t in wave.tokens[i, :wave.lengths[i]]
             if int(t) != cfg.decoder.eos_token_id] for i in range(n)]
    got = ContinuousBatcher(tmod, cfg, batch_size=3,
                            max_prompt_len=int(plen[0]),
                            max_new_tokens=max_new).run(
        lambda idxs: torch.from_numpy(px[idxs]), pre_ids_row=pre[0],
        post_ids_row=post[0], prompt_len_scalar=int(plen[0]), n_images=n)
    assert got == want


# --------------------------- the model's entry points ---------------------

@pytest.fixture(scope="module")
def models():
    """vlm_tpu's ``PaLIGemmaModel`` and the port's, the port's weights
    copied from vlm_tpu's; both with the byte-level tokenizer."""
    from vlm_tpu.models.factory import VLMModelFactory
    jm = VLMModelFactory.create_model("paligemma", size="test",
                                      quantization="fp32")
    pm = create_model("paligemma", size="test", device="cpu")
    load_flax_params(pm.module, jax.tree.map(np.asarray,
                                             meta.unbox(jm.params)))
    return jm, pm


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 256, (40 + 7 * i, 60, 3),
                                         dtype=np.uint8)) for i in range(n)]


@pytest.mark.parametrize("num_beams", [1, 2])
def test_generate_batch_and_text_give_vlm_tpu_strings(models, num_beams):
    jm, pm = models
    images = _images(3, seed=5)
    kw = dict(max_tokens=5, num_beams=num_beams)
    assert pm.generate_batch(images, "colour?", **kw) == \
        jm.generate_batch(images, "colour?", **kw)
    assert pm.generate_text(images[1], "hat?", max_tokens=4) == \
        jm.generate_text(images[1], "hat?", max_tokens=4)


def test_generate_dataset_beams_in_padded_waves(models, tmp_path):
    """5 files in waves of 2: the last wave is padded with its last image
    and one beam engine serves all three waves."""
    jm, pm = models
    paths = []
    for i, im in enumerate(_images(5, seed=6)):
        paths.append(tmp_path / f"{i}.jpg")
        im.save(paths[-1])
    seen = []
    pm._engines.clear()
    got = pm.generate_dataset(paths, "bag?", max_tokens=4, batch_size=2,
                              num_beams=2, progress=seen.append)
    assert got == jm.generate_dataset(paths, "bag?", max_tokens=4,
                                      batch_size=2, num_beams=2)
    assert seen == [2, 2, 1]
    assert [k[:2] for k in pm._engines] == [("beam", 2)]


def test_generate_dataset_beams_return_partial_on_interrupt(models,
                                                            tmp_path,
                                                            monkeypatch):
    _, pm = models
    paths = []
    for i, im in enumerate(_images(4, seed=7)):
        paths.append(tmp_path / f"{i}.png")
        im.save(paths[-1])
    real, calls = pm.generate_batch, []

    def second_wave_interrupts(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return real(*args, **kw)
    monkeypatch.setattr(pm, "generate_batch", second_wave_interrupts)
    out = pm.generate_dataset(paths, "hat?", max_tokens=3, batch_size=2,
                              num_beams=2)
    assert all(isinstance(t, str) for t in out[:2]) and out[2:] == [None] * 2


def test_sampling_in_the_wave_engine(models):
    """``top_k=1`` samples the argmax; one seed, one stream; beams refuse
    a temperature."""
    _, pm = models
    images = _images(2, seed=8)
    greedy = pm.generate_batch(images, "p", max_tokens=5)
    assert pm.generate_batch(images, "p", max_tokens=5, temperature=0.7,
                             top_k=1, seed=3) == greedy
    a = pm.generate_batch(images, "p", max_tokens=5, temperature=1.5,
                          top_p=0.9, seed=11)
    assert a == pm.generate_batch(images, "p", max_tokens=5,
                                  temperature=1.5, top_p=0.9, seed=11)
    with pytest.raises(ValueError, match="temperature>0 with num_beams>1"):
        pm.generate_batch(images, "p", max_tokens=5, num_beams=2,
                          temperature=0.5)


def test_engines_are_cached_by_vlm_tpus_key(models, monkeypatch):
    _, pm = models
    pm._engines.clear()
    images = _images(2, seed=9)
    pm.generate_batch(images, "p", max_tokens=3)
    pm.generate_batch(images, "q", max_tokens=3)     # same prompt length
    assert len(pm._engines) == 1
    monkeypatch.setenv("VLM_TPU_KV_CACHE", "int8")
    pm.generate_batch(images, "p", max_tokens=3)
    keys = sorted(pm._engines, key=str)
    assert len(keys) == 2 and {k[3] for k in keys} == {
        "int8", str(torch.float32)}


def test_feed_token():
    assert port_decode.feed_token(0, 512) == 0
    assert port_decode.feed_token(32001, 512) == 0
    assert port_decode.feed_token(1, 512) == 1
