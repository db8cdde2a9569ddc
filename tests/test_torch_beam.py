"""The port's beam search (``BeamSearchEngine``) against vlm_tpu's, on the
CPU: best-hypothesis tokens and lengths identical, scores within rtol
1e-5.

- The three families at the "test" size in fp32 (weights through the
  bridge; LLaVA's vlm_tpu run with ``pad_id=0``, see
  ``tests/test_torch_generate.py``), K in {2, 4}, length_penalty in {1.0,
  0.7}, an EOS id the model emits, and 8bit weights with the int8 cache.
- The tie order: a stand-in model whose bf16 logits are rows of -30 and
  -31 with 1, 2 or 4 maxima at 0 (``log_softmax`` gives both packages the
  same values bitwise) makes exact ties at every step, within rows and
  across beams; ``jax.lax.top_k`` takes the lower index first, and so must
  the port.
- The cache gather over the columns decode has written is bitwise the
  gather of whole rows, step by step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_generate import _inputs, pair
from vlm_tpu.generate.beam import BeamSearchEngine as JaxBeam
from vlm_tpu_torch.generate import beam
from vlm_tpu_torch.generate.beam import BeamSearchEngine, top_candidates
from vlm_tpu_torch.models.decoder import QuantizedKV
from vlm_tpu_torch.models.vlm import num_image_tokens
from vlm_tpu_torch.ops import _lib

torch.set_num_threads(2)
SCORE_RTOL = 1e-5


@pytest.mark.parametrize("seed", range(4))
def test_top_candidates_order_ties_as_jax_top_k(seed):
    """Values from a few levels (ties everywhere, -0.0 and 0.0 among
    them): the same values and indices as ``jax.lax.top_k``."""
    rng = np.random.default_rng(seed)
    levels = np.asarray([-0.0, 0.0, -1e9, -3.5, 2.25, -24.0, 7.0],
                        np.float32)
    flat = levels[rng.integers(0, len(levels), (5, 300))]
    n = int(rng.integers(1, 40))
    want_v, want_i = jax.lax.top_k(jnp.asarray(flat), n)
    got_v, got_i = top_candidates(torch.from_numpy(flat), n)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  np.asarray(want_v).view(np.int32))


def _check(res, ref, pad):
    toks, lens = res.tokens.numpy(), res.lengths.numpy()
    np.testing.assert_array_equal(lens, np.asarray(ref.lengths))
    rtoks = np.asarray(ref.tokens)
    for i in range(len(lens)):
        np.testing.assert_array_equal(toks[i, :lens[i]], rtoks[i, :lens[i]])
        assert (toks[i, lens[i]:] == pad).all()
    np.testing.assert_allclose(res.scores.numpy(), np.asarray(ref.scores),
                               rtol=SCORE_RTOL, atol=0)


# ------------------------------ the tie order ------------------------------

P, V = 4, 16


class _JaxMarkov:
    """vlm_tpu's side of the stand-in: ``first[image]`` at the prefill
    (the image's index rides in its pixels), ``table[step, token]`` after
    it."""

    def __init__(self, first, table):
        self.first, self.table = jnp.asarray(first), jnp.asarray(table)

    def apply(self, params, *args, method, **kw):
        if method == "prefill":
            pixels, _, _, cache, _ = args
            return self.first[pixels[:, 0, 0, 0].astype(jnp.int32)], cache
        tok, pos, cache = args
        return self.table[pos - P, tok[:, 0]], cache


class _Markov:
    """The port's side of the stand-in."""
    device, dtype = torch.device("cpu"), torch.bfloat16

    def __init__(self, first, table):
        self.first = torch.from_numpy(first).bfloat16()
        self.table = torch.from_numpy(table).bfloat16()

    def prefill(self, pixels, pre_ids, post_ids, cache, prompt_len):
        return self.first[pixels[:, 0, 0, 0].long()]

    def decode_step(self, tok, seq_len, cache, uniform_write=False):
        return self.table[(seq_len - P).long(), tok[:, 0].long()]


def _tied_logits(rng, shape):
    """Rows of -30 and -31 with 1, 2 or 4 maxima at 0: exact ties at the
    top of a row and, through the sums, across beams. ``log_softmax``
    gives both packages the same values bitwise (0, -log 2, -log 4, and
    those minus 30 or 31)."""
    x = -rng.integers(30, 32, shape).astype(np.float32).reshape(-1, V)
    for row in x:
        row[rng.choice(V, rng.choice([1, 2, 4]), replace=False)] = 0.0
    return x.reshape(shape)


@pytest.mark.parametrize("k,lp", [(2, 1.0), (4, 1.0), (4, 0.7)])
@pytest.mark.parametrize("seed", range(3))
def test_exact_ties_resolve_as_in_vlm_tpu(k, lp, seed):
    jcfg, _, _, cfg, _ = pair()
    rng = np.random.default_rng(seed)
    b, new, eos = 3, 7, 5
    first, table = _tied_logits(rng, (b, V)), _tied_logits(rng, (new, V, V))
    table[:, :, eos] = np.where(rng.random((new, V)) < 0.3, 0.0, -30.0)
    px = np.arange(b, dtype=np.float32).reshape(b, 1, 1, 1)
    ids = np.zeros((b, 0), np.int32)
    plen = np.full((b,), P, np.int32)
    kw = dict(batch_size=b, max_prompt_len=P, num_beams=k,
              max_new_tokens=new, length_penalty=lp, eos_id=eos, pad_id=0)
    ref = JaxBeam(_JaxMarkov(first, table), jcfg, **kw).generate(
        {}, jnp.asarray(px), jnp.asarray(ids), jnp.asarray(ids),
        jnp.asarray(plen))
    res = BeamSearchEngine(_Markov(first, table), cfg, **kw).generate(
        torch.from_numpy(px), torch.from_numpy(ids), torch.from_numpy(ids),
        torch.from_numpy(plen))
    _check(res, ref, 0)


# ---------------------------- the real models ----------------------------

def _beam_both(family, bits, b, post_lens, k, lp, new, eos=None, n_pre=0,
               seed=0, cache=None):
    jcfg, jmod, params, cfg, tmod = pair(family, bits)
    px, pre, post, plen = _inputs(cfg, b, n_pre, post_lens, seed)
    width = n_pre + num_image_tokens(cfg) + post.shape[1]
    kw = dict(batch_size=b, max_prompt_len=width, num_beams=k,
              max_new_tokens=new, length_penalty=lp, eos_id=eos)
    ref = JaxBeam(jmod, jcfg, cache_dtype=cache or jnp.float32,
                  pad_id=0 if family == "llava" else None, **kw).generate(
        params, jnp.asarray(px), jnp.asarray(pre), jnp.asarray(post),
        jnp.asarray(plen))
    eng = BeamSearchEngine(tmod, cfg, cache_dtype=cache, **kw)
    res = eng.generate(torch.from_numpy(px), torch.from_numpy(pre),
                       torch.from_numpy(post), torch.from_numpy(plen))
    _check(res, ref, eng.pad_id)
    return eng, res


@pytest.mark.parametrize("k,lp", [(2, 1.0), (4, 1.0), (2, 0.7), (4, 0.7)])
def test_paligemma_beams_identical_to_jax(k, lp):
    """An EOS id the model emits (the first run's second token of image
    0): hypotheses end early and the pool decides."""
    _, res = _beam_both("paligemma", 0, 2, [3, 3], k, lp, 6, seed=1)
    eos = int(res.tokens[0, 1])
    eng, res = _beam_both("paligemma", 0, 2, [3, 3], k, lp, 6, eos=eos,
                          seed=1)
    assert eng.last_stats["steps"] >= 1


@pytest.mark.parametrize("family", ["llava", "blip2"])
def test_llava_and_blip2_beams_identical_to_jax(family):
    n_pre = 4 if family == "llava" else 0
    _lib.reset_counts()
    _beam_both(family, 0, 2, [4, 4], 2, 1.0, 6, n_pre=n_pre, seed=2)
    assert _lib.plain_calls["decode_attention_fp32"] > 0


def test_int8_cache_beams_identical_to_jax():
    """8bit weights (fp32 compute) and the int8 cache: the repeat and the
    gather move values and scales."""
    _lib.reset_counts()
    eng, _ = _beam_both("paligemma", 8, 2, [3, 3], 2, 1.0, 6, seed=3,
                        cache="int8")
    assert _lib.plain_calls["decode_attention_int8"] > 0
    assert _lib.plain_calls["int8_matmul"] > 0


def test_non_uniform_prompts_identical_to_jax():
    _beam_both("paligemma", 0, 2, [2, 5], 2, 1.0, 5, seed=4)


# ------------------------------ the gather ------------------------------

def _snapshot(cache):
    return [t.clone() for layer in cache["k"] + cache["v"]
            for t in (layer if isinstance(layer, QuantizedKV) else (layer,))]


@pytest.mark.parametrize("post_lens,cache", [
    ([3, 3], None), ([2, 5], None), ([3, 3], "int8")],
    ids=["uniform", "mixed_lengths", "int8"])
def test_column_gather_is_bitwise_the_row_gather(post_lens, cache,
                                                 monkeypatch):
    """Step by step, the cache after the gather over the written columns
    equals the cache after vlm_tpu's gather of whole rows; the beams do
    move (a source that is not the identity)."""
    _, _, _, cfg, tmod = pair("paligemma", 8 if cache else 0)
    px, pre, post, plen = _inputs(cfg, 2, 0, post_lens, seed=5)
    args = [torch.from_numpy(a) for a in (px, pre, post, plen)]
    real, moved = beam.gather_cache, []

    def run(whole):
        def gather(c, src, cols=None):
            moved.append(src.clone())
            real(c, src, None if whole else cols)
        monkeypatch.setattr(beam, "gather_cache", gather)
        eng = BeamSearchEngine(tmod, cfg, batch_size=2,
                               max_prompt_len=post.shape[1]
                               + num_image_tokens(cfg),
                               num_beams=4, max_new_tokens=6,
                               cache_dtype=cache)
        with torch.inference_mode():
            s = eng.start(*args)
            snaps = [_snapshot(s.cache)]
            while eng.running(s):
                eng.step(s)
                snaps.append(_snapshot(s.cache))
        return snaps, eng.finish(s)

    cols, res = run(False)
    rows, ref = run(True)
    assert len(cols) == len(rows) > 2
    for a, b in zip(cols, rows):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(res.tokens, ref.tokens)
    assert any(not torch.equal(m, torch.arange(8)) for m in moved)
