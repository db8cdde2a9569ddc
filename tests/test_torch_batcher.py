"""The port's continuous batcher and sampling against vlm_tpu's, on the CPU
at the "test" PaliGemma size in fp32. Greedy tokens must be identical per
image; same weights through the bridge, same pixels from a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from vlm_tpu.generate.batcher import ContinuousBatcher as JaxBatcher
from vlm_tpu.models.configs import paligemma_config as jax_config
from vlm_tpu.models.vlm import init_vlm
from vlm_tpu_torch.generate.batcher import ContinuousBatcher
from vlm_tpu_torch.generate.decode import build_prompt_ids, sample
from vlm_tpu_torch.models.configs import paligemma_config
from vlm_tpu_torch.models.vlm import VLMModule, num_image_tokens
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.testing.bridge import load_flax_params

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("test")
    jmod, params = init_vlm(jcfg, jax.random.key(0), dtype=jnp.float32)
    cfg = paligemma_config("test")
    tmod = VLMModule(cfg, dtype=torch.float32)
    load_flax_params(tmod, jax.tree.map(np.asarray, meta.unbox(params)))
    return jcfg, jmod, params, cfg, tmod


def _pixels(cfg, n, seed):
    s = cfg.vision.image_size
    return np.random.default_rng(seed).normal(
        size=(n, s, s, 3)).astype(np.float32)


@pytest.mark.parametrize("slots,admit,caps", [
    (3, 2, [5, 1, 3, 1, 2, 5, 1, 4, 2]),
    (4, 4, [6, 6, 2, 3, 6, 1, 5, 6, 4, 2, 6]),
], ids=["3slots_admit2", "4slots_admit4"])
def test_greedy_tokens_identical_to_jax_batcher(models, slots, admit, caps):
    """More images than slots and varied caps: slots free mid-run, the
    window wraps, and every image's greedy tokens match vlm_tpu's."""
    jcfg, jmod, params, cfg, tmod = models
    n, max_new = len(caps), max(caps)
    px = _pixels(cfg, n, seed=n)
    post = np.asarray([2, 7, 9], np.int32)
    plen = num_image_tokens(cfg) + len(post)
    run_kw = dict(pre_ids_row=np.zeros((0,), np.int32), post_ids_row=post,
                  prompt_len_scalar=plen, n_images=n, max_new_per_image=caps)
    ref = JaxBatcher(jmod, jcfg, batch_size=slots, max_prompt_len=plen,
                     max_new_tokens=max_new, cache_dtype=jnp.float32,
                     admit_block=admit).run(
        params, pixel_fn=lambda idxs: jnp.asarray(px[idxs]), **run_kw)
    seen = []
    _lib.reset_counts()
    b = ContinuousBatcher(tmod, cfg, batch_size=slots, max_prompt_len=plen,
                          max_new_tokens=max_new, admit_block=admit)
    got = b.run(lambda idxs: torch.from_numpy(px[idxs]),
                progress=seen.append, **run_kw)
    assert got == ref
    assert sum(seen) == n
    assert all(len(o) <= c for o, c in zip(got, caps))
    assert all(t is not None and t >= 0 for t in b.last_latency_s)
    assert b.last_stats["admits"] == -(-n // admit)
    # on the CPU every op took its plain version
    assert _lib.launches == dict.fromkeys(_lib.KERNELS, 0)
    assert min(_lib.plain_calls[k] for k in ("flash_attention_fp32",
                                             "decode_attention_fp32",
                                             "kv_write")) > 0


def test_all_caps_one_and_single_slot(models):
    _, _, _, cfg, tmod = models
    px = _pixels(cfg, 5, seed=7)
    plen = num_image_tokens(cfg) + 1
    kw = dict(pre_ids_row=np.zeros((0,), np.int32),
              post_ids_row=np.ones((1,), np.int32), prompt_len_scalar=plen)
    out = ContinuousBatcher(tmod, cfg, batch_size=2, max_prompt_len=plen,
                            max_new_tokens=4, admit_block=2).run(
        lambda idxs: torch.from_numpy(px[idxs]), n_images=5,
        max_new_per_image=[1] * 5, **kw)
    assert all(o is not None and len(o) <= 1 for o in out)
    out = ContinuousBatcher(tmod, cfg, batch_size=1, max_prompt_len=plen,
                            max_new_tokens=3).run(
        lambda idxs: torch.from_numpy(px[idxs]), n_images=2, **kw)
    assert len(out) == 2 and all(len(o) <= 3 for o in out)


@pytest.mark.parametrize("batch,want", [(128, 8), (64, 8), (32, 4), (16, 4),
                                        (8, 4), (4, 4), (2, 2), (1, 1)])
def test_default_admit_block(models, batch, want):
    _, _, _, cfg, tmod = models
    b = ContinuousBatcher(tmod, cfg, batch_size=batch, max_prompt_len=8,
                          max_new_tokens=2)
    assert b.admit_block == want


def test_greedy_is_argmax_first_max():
    logits = torch.tensor([[1.0, 5.0, 2.0, 5.0]])
    assert sample(logits).tolist() == [1]


def test_top_k_and_top_p_restrict_support():
    logits = torch.tensor([[0.0, 10.0, 9.0, -5.0]]).repeat(200, 1)
    gen = torch.Generator().manual_seed(0)
    toks = set(sample(logits, 1.0, gen, top_k=2).tolist())
    assert toks <= {1, 2} and len(toks) == 2
    toks = set(sample(logits, 1.0, gen, top_p=0.5).tolist())
    assert toks == {1}


def test_sampling_is_seeded():
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(1))
    a = sample(logits, 0.8, torch.Generator().manual_seed(3), top_p=0.9)
    b = sample(logits, 0.8, torch.Generator().manual_seed(3), top_p=0.9)
    assert a.tolist() == b.tolist() and a.dtype == torch.int32


def test_build_prompt_ids_matches_jax():
    from vlm_tpu.data.tokenizer import ByteTokenizer
    from vlm_tpu.generate.decode import build_prompt_ids as jax_build
    tok = ByteTokenizer()
    got = build_prompt_ids(tok, "ab", "cde", 16, 3, add_bos_to_post=True)
    want = jax_build(tok, "ab", "cde", 16, 3, add_bos_to_post=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
