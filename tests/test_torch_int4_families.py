"""LLaVA and BLIP-2 in 4bit against vlm_tpu on the CPU at the "test" size:
grouped int4 decoder weights (BLIP-2's tower too, as ``quantize_vision``
gives it; LLaVA's tower unquantized, as its recipe), fp32 compute, the
weights copied through the bridge.

- Prefill and rotating-window decode logits within atol = rtol = 1e-4,
  the logit tolerance of ``tests/test_torch_int4.py`` (both sides form
  the same fp32 weights from the same nibbles and scales and differ only
  in the order of the sums).
- Greedy tokens identical through the continuous batcher (slots reused,
  the window wrapping), the wave engine and beam search (``num_beams=2``,
  scores within ``tests/test_torch_beam.py``'s rtol 1e-5).

LLaVA's "test" pad id lies past its vocabulary, so vlm_tpu runs LLaVA with
``pad_id=0`` (``tests/test_torch_generate.py`` says why).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tests.test_torch_beam import _check
from tests.test_torch_blip2 import _affine_from_seed
from tests.test_torch_generate import _inputs
from vlm_tpu.generate.batcher import ContinuousBatcher as JaxBatcher
from vlm_tpu.generate.beam import BeamSearchEngine as JaxBeam
from vlm_tpu.generate.decode import GenerationEngine as JaxEngine
from vlm_tpu.models.configs import VLM_CONFIGS as JAX_CONFIGS
from vlm_tpu.models.vlm import init_kv_cache as jax_init_cache
from vlm_tpu.models.vlm import init_vlm
from vlm_tpu_torch.generate.batcher import ContinuousBatcher
from vlm_tpu_torch.generate.beam import BeamSearchEngine
from vlm_tpu_torch.generate.decode import GenerationEngine
from vlm_tpu_torch.models.configs import VLM_CONFIGS
from vlm_tpu_torch.models.decoder import init_kv_cache
from vlm_tpu_torch.models.vlm import VLMModule, num_image_tokens
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.testing.bridge import load_flax_params

torch.set_num_threads(2)
# tests/test_torch_int4.py's logit tolerance
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
FAMILIES = ["llava", "blip2"]
# the ids before the image tokens: LLaVA's BOS + "USER: " stand-in
N_PRE = {"llava": 4, "blip2": 0}
# vlm_tpu's pad id for LLaVA (its own lies past the "test" vocabulary)
JAX_PAD = {"llava": 0, "blip2": None}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def pair4(family):
    """vlm_tpu's 4bit VLM and the port's on the same weights; BLIP-2's
    tower quantized and its biases and norms drawn from a seed."""
    vbits = 4 if family == "blip2" else 0
    jcfg = JAX_CONFIGS[family]("test")
    jmod, params = init_vlm(jcfg, jax.random.key(0), dtype=jnp.float32,
                            quant_bits=4, vision_quant_bits=vbits)
    tree = jax.tree.map(np.asarray, meta.unbox(params))
    if family == "blip2":
        tree = _affine_from_seed(tree)
        params = jax.tree.map(jnp.asarray, tree)
    cfg = VLM_CONFIGS[family]("test")
    tmod = VLMModule(cfg, dtype=torch.float32, quant_bits=4,
                     vision_quant_bits=vbits)
    load_flax_params(tmod, tree)
    return jcfg, jmod, params, cfg, tmod


def _prompt(family, cfg, b, n_post, seed):
    px, pre, post, plen = _inputs(cfg, b, N_PRE[family], [n_post] * b, seed)
    if family == "blip2":
        post[:, 0] = cfg.decoder.bos_token_id
    return px, pre, post, plen


@pytest.mark.parametrize("family", FAMILIES)
def test_4bit_prefill_and_window_decode_logits_match_jax(family):
    """Prefill, then decode steps in the batcher's form (``write_col`` and
    ``kv_window`` against vlm_tpu's ``kv_valid``) through a window wrap:
    logits within ``LOGIT_TOL``; B7's plain version at every decoder
    product (and BLIP-2's tower)."""
    _, jmod, params, cfg, tmod = pair4(family)
    b, w = 2, 4
    px, pre, post, plen = _prompt(family, cfg, b, 5, seed=5)
    p = int(plen[0])
    jcache = jax_init_cache(cfg.decoder, b, p + w, jnp.float32)
    jlast, jcache = jmod.apply(params, jnp.asarray(px), jnp.asarray(pre),
                               jnp.asarray(post), jcache, jnp.asarray(plen),
                               method="prefill")
    cache = init_kv_cache(cfg.decoder, b, p + w, torch.float32)
    _lib.reset_counts()
    with torch.inference_mode():
        last = tmod.prefill(_t(px), _t(pre), _t(post), cache, _t(plen))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **LOGIT_TOL)
    dense = 7 if cfg.decoder.gated_mlp else 6
    tower = 6 * cfg.vision.layers if family == "blip2" else 0
    assert _lib.plain_calls["int4_matmul"] == tower + dense * \
        cfg.decoder.layers
    acol = np.zeros((b,), np.int32)
    tok = np.asarray(jnp.argmax(jlast, -1))[:, None].astype(np.int32)
    for step in range(w + 2):
        gcnt = np.full((b,), min(step + 1, w), np.int32)
        cols = np.arange(p + w)[None]
        age = np.mod(cols - p - acol[:, None], w)
        valid = (cols < p) | ((cols < p + w) & (age < gcnt[:, None]))
        col = np.int32(p + step % w)
        jlog, jcache = jmod.apply(
            params, jnp.asarray(tok), jnp.asarray(plen + step), jcache,
            method="decode_step", write_col=jnp.asarray(col),
            kv_valid=jnp.asarray(valid))
        with torch.inference_mode():
            log = tmod.decode_step(_t(tok), _t(plen + step), cache,
                                   write_col=torch.tensor(col),
                                   kv_window=(p, w, _t(acol), _t(gcnt)))
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   **LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
    assert _lib.launches == dict.fromkeys(_lib.KERNELS, 0)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("slots,admit,caps", [
    (2, 2, [2, 6, 3, 6, 4]),
    (3, 2, [5, 1, 3, 1, 2, 5, 1, 4, 2]),
], ids=["2slots_admit2", "3slots_admit2"])
def test_4bit_greedy_tokens_identical_to_jax_batcher(family, slots, admit,
                                                     caps):
    """More images than slots, varied caps: identical tokens per image,
    B7's plain version at the decode products."""
    jcfg, jmod, params, cfg, tmod = pair4(family)
    n, max_new = len(caps), max(caps)
    s = cfg.vision.image_size
    px = np.random.default_rng(n).normal(size=(n, s, s, 3)).astype(
        np.float32)
    pre = np.asarray([cfg.decoder.bos_token_id, 9, 23, 5][:N_PRE[family]],
                     np.int32)
    post = np.asarray([7, 9, 11] if family == "llava" else
                      [cfg.decoder.bos_token_id, 9, 23, 5, 7], np.int32)
    plen = len(pre) + num_image_tokens(cfg) + len(post)
    run_kw = dict(pre_ids_row=pre, post_ids_row=post, prompt_len_scalar=plen,
                  n_images=n, max_new_per_image=caps)
    ref = JaxBatcher(jmod, jcfg, batch_size=slots, max_prompt_len=plen,
                     max_new_tokens=max_new, cache_dtype=jnp.float32,
                     admit_block=admit, pad_id=JAX_PAD[family]).run(
        params, pixel_fn=lambda idxs: jnp.asarray(px[idxs]), **run_kw)
    _lib.reset_counts()
    got = ContinuousBatcher(tmod, cfg, batch_size=slots, max_prompt_len=plen,
                            max_new_tokens=max_new, admit_block=admit).run(
        lambda idxs: torch.from_numpy(px[idxs]), **run_kw)
    assert got == ref
    assert all(len(o) <= c for o, c in zip(got, caps))
    assert _lib.launches == dict.fromkeys(_lib.KERNELS, 0)
    assert _lib.plain_calls["int4_matmul"] > 0
    assert _lib.plain_calls["int8_matmul"] == 0


@pytest.mark.parametrize("family", FAMILIES)
def test_4bit_wave_engine_identical_to_jax(family):
    """The wave engine with per-row caps: tokens and lengths identical,
    the padding after each row the engine's own pad id."""
    jcfg, jmod, params, cfg, tmod = pair4(family)
    b, new, caps = 3, 6, [6, 2, 4]
    px, pre, post, plen = _prompt(family, cfg, b, 3, seed=4)
    width = int(plen[0])
    ref = JaxEngine(jmod, jcfg, batch_size=b, max_prompt_len=width,
                    max_new_tokens=new, cache_dtype=jnp.float32,
                    pad_id=JAX_PAD[family]).generate(
        params, jnp.asarray(px), jnp.asarray(pre), jnp.asarray(post),
        jnp.asarray(plen), max_new_per_seq=jnp.asarray(caps, jnp.int32))
    _lib.reset_counts()
    eng = GenerationEngine(tmod, cfg, batch_size=b, max_prompt_len=width,
                           max_new_tokens=new)
    got = eng.generate(_t(px), _t(pre), _t(post), _t(plen),
                       max_new_per_seq=torch.tensor(caps))
    toks, lens = got.tokens.numpy(), got.lengths.numpy()
    rtoks = np.asarray(ref.tokens)
    np.testing.assert_array_equal(lens, np.asarray(ref.lengths))
    for i in range(b):
        np.testing.assert_array_equal(toks[i, :lens[i]], rtoks[i, :lens[i]])
        assert (toks[i, lens[i]:] == eng.pad_id).all()
    assert _lib.plain_calls["int4_matmul"] > 0


@pytest.mark.parametrize("family", FAMILIES)
def test_4bit_beams_identical_to_jax(family):
    """Beam search with 2 beams: best tokens and lengths identical, scores
    within rtol 1e-5."""
    jcfg, jmod, params, cfg, tmod = pair4(family)
    b = 2
    px, pre, post, plen = _prompt(family, cfg, b, 4, seed=2)
    kw = dict(batch_size=b, max_prompt_len=int(plen[0]), num_beams=2,
              max_new_tokens=6, length_penalty=1.0, eos_id=None)
    ref = JaxBeam(jmod, jcfg, cache_dtype=jnp.float32,
                  pad_id=JAX_PAD[family], **kw).generate(
        params, jnp.asarray(px), jnp.asarray(pre), jnp.asarray(post),
        jnp.asarray(plen))
    _lib.reset_counts()
    eng = BeamSearchEngine(tmod, cfg, **kw)
    res = eng.generate(_t(px), _t(pre), _t(post), _t(plen))
    _check(res, ref, eng.pad_id)
    assert _lib.plain_calls["int4_matmul"] > 0
