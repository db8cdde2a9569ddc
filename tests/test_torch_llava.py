"""The port's LLaVA-1.5 (CLIP-L/336 tower, MLP projector, Vicuna decoder
with its untied head) against vlm_tpu's on the CPU at the "test" size in
fp32, with vlm_tpu's weights copied through the bridge: the projector, the
decoder, the CLIP tower, the assembled VLM, the continuous batcher (fp32,
and 8bit with the int8 KV cache), the model class and the CLI; and the
idle-slot pad fault of the "test" config (pad id 32001 in a vocabulary of
512), which poisons vlm_tpu's batcher and not the port's.

Tolerances: ops and layers atol = rtol = 1e-5; logits atol = rtol = 1e-4,
as ``tests/test_torch_models.py``; greedy tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from vlm_tpu.generate.batcher import ContinuousBatcher as JaxBatcher
from vlm_tpu.models.configs import llava_config as jax_config
from vlm_tpu.models.decoder import Decoder as JDecoder
from vlm_tpu.models.projector import MLPProjector as JMLPProjector
from vlm_tpu.models.vit import ViTEncoder as JViTEncoder
from vlm_tpu.models.vlm import init_kv_cache as jax_init_cache
from vlm_tpu.models.vlm import init_vlm
from vlm_tpu_torch.generate.batcher import ContinuousBatcher
from vlm_tpu_torch.models.configs import llava_config
from vlm_tpu_torch.models.decoder import init_kv_cache
from vlm_tpu_torch.models.factory import create_model
from vlm_tpu_torch.models.projector import MLPProjector
from vlm_tpu_torch.models.vlm import VLMModule, num_image_tokens
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.ops.preprocess import unfold_patches
from vlm_tpu_torch.testing.bridge import flax_to_state_dict, load_flax_params

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(quant_bits=0):
    jcfg = jax_config("test")
    jmod, params = init_vlm(jcfg, jax.random.key(0), dtype=jnp.float32,
                            quant_bits=quant_bits)
    cfg = llava_config("test")
    tmod = VLMModule(cfg, dtype=torch.float32, quant_bits=quant_bits)
    tree = jax.tree.map(np.asarray, meta.unbox(params))
    load_flax_params(tmod, tree)
    return jmod, params, tmod, cfg, tree


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def pair8():
    """int8 decoder blocks (fp32 compute); the tower, the projector and
    the head stay unquantized, as in vlm_tpu."""
    return _pair(8)


def _inputs(cfg, b=2, n_post=4, seed=1):
    s = cfg.vision.image_size
    rng = np.random.default_rng(seed)
    px = rng.normal(size=(b, s, s, 3)).astype(np.float32)
    pre = np.concatenate([np.ones((b, 1), np.int32),      # BOS + "USER: "
                          rng.integers(3, 500, (b, 3)).astype(np.int32)], 1)
    post = rng.integers(3, 500, (b, n_post)).astype(np.int32)
    plen = np.full((b,), 4 + num_image_tokens(cfg) + n_post, np.int32)
    return px, pre, post, plen


# ------------------------------- config -------------------------------

def test_llava_test_config_is_vicuna_and_clip():
    """What the Vicuna decoder asks of the port beside Gemma: plain
    RMSNorm (no ``1 + w``), SiLU, no embedding scale, RoPE theta 1e4, MHA,
    an untied head; the CLIP tower: pre-LN, CLS, a bias-free patch
    embedding, the post LN on the pooled CLS only, the feature tap at -2
    with the CLS dropped."""
    cfg = llava_config("test")
    dec, vis = cfg.decoder, cfg.vision
    assert not dec.gemma_norm and dec.act == "silu" and not dec.embed_scale
    assert dec.rope_theta == 10000.0 and dec.kv_heads == dec.heads
    assert not dec.tie_embeddings and dec.pad_token_id >= dec.vocab_size
    assert vis.pre_layernorm and vis.use_cls_token and not vis.patch_bias
    assert vis.post_layernorm == "pooled_only" and vis.act == "quick_gelu"
    assert cfg.projector == "mlp" and cfg.vision_feature_layer == -2
    assert cfg.drop_cls_for_llm and not cfg.prefix_lm
    assert num_image_tokens(cfg) == vis.num_patches == 16
    full = llava_config("7b")
    assert num_image_tokens(full) == 576 and full.vision.image_size == 336
    assert (full.decoder.heads, full.decoder.kv_heads,
            full.decoder.head_dim) == (32, 32, 128)


# ------------------------------- modules -------------------------------

def test_bridge_covers_every_parameter(pair, pair8):
    """The projector's fc1/fc2 and the decoder's lm_head map by the
    bridge's existing rules; nothing missing or extra, fp32 and 8bit."""
    for _, _, tmod, cfg, tree in (pair, pair8):
        state = flax_to_state_dict(tree)
        assert set(state) == set(tmod.state_dict())
        dec = cfg.decoder
        assert tuple(state["decoder.lm_head.weight"].shape) == (
            dec.vocab_size, dec.hidden)
        assert tuple(state["projector.fc1.weight"].shape) == (
            dec.hidden, cfg.vision.hidden)
        assert tuple(state["projector.fc2.weight"].shape) == (
            dec.hidden, dec.hidden)
        assert "decoder.lm_head.bias" not in state
    assert "decoder.blocks.0.mlp.down_proj.q" in flax_to_state_dict(pair8[4])


def test_mlp_projector_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    jproj = JMLPProjector(out_dim=16, dtype=jnp.float32,
                          param_dtype=jnp.float32)
    params = jproj.init(jax.random.key(1), jnp.asarray(x))
    proj = MLPProjector(24, 16)
    load_flax_params(proj, jax.tree.map(np.asarray, meta.unbox(params)))
    want = jproj.apply(params, jnp.asarray(x))
    np.testing.assert_allclose(proj(_t(x)).numpy(), np.asarray(want), **TOL)


def test_clip_tower_matches_jax(pair):
    """``hidden_states`` (the -2 tap: embeddings after the pre-LN, then
    each block) and ``pooled`` (the CLS through the post LN); the last
    hidden state is not post-normed. Patch vectors in B4's layout give
    the same result as NHWC pixels."""
    _, _, tmod, cfg, tree = pair
    px, _, _, _ = _inputs(cfg, seed=3)
    want = JViTEncoder(cfg.vision, dtype=jnp.float32).apply(
        {"params": tree["params"]["vision"]}, jnp.asarray(px))
    got = tmod.vision(_t(px))
    assert len(got["hidden_states"]) == cfg.vision.layers + 1
    for g, w in zip(got["hidden_states"], want["hidden_states"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(got["pooled"].numpy(),
                               np.asarray(want["pooled"]), **TOL)
    np.testing.assert_allclose(got["last_hidden_state"].numpy(),
                               np.asarray(want["hidden_states"][-1]), **TOL)
    patches = tmod.vision(unfold_patches(_t(px), cfg.vision.patch_size))
    assert patches["hidden_states"][-2].shape[1] == 1 + 16   # CLS first
    for key in ("last_hidden_state", "pooled"):
        assert torch.equal(patches[key], got[key])


def test_vision_tap_and_projector_match(pair):
    jmod, params, tmod, cfg, _ = pair
    px, _, _, _ = _inputs(cfg)
    want = jmod.apply(params, jnp.asarray(px), method="encode_images")
    got = tmod.encode_images(_t(px))
    assert got.shape == (2, 16, cfg.decoder.hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vicuna_decoder_with_lm_head_matches_jax(pair):
    """The decoder alone on token ids: full forward and ``logits_index``."""
    _, _, tmod, cfg, tree = pair
    ids = np.random.default_rng(4).integers(0, 512, (2, 9)).astype(np.int32)
    jdec = JDecoder(cfg.decoder, dtype=jnp.float32)
    dparams = {"params": tree["params"]["decoder"]}
    want, _ = jdec.apply(dparams, input_ids=jnp.asarray(ids))
    got = tmod.decoder(input_ids=_t(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    idx = np.asarray([3, 8], np.int32)
    want, _ = jdec.apply(dparams, input_ids=jnp.asarray(ids),
                         logits_index=jnp.asarray(idx))
    got = tmod.decoder(input_ids=_t(ids), logits_index=_t(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_full_forward_matches(pair):
    """Causal over [BOS + "USER: "] [image] [prompt]: no prefix-LM."""
    jmod, params, tmod, cfg, _ = pair
    px, pre, post, plen = _inputs(cfg)
    want = jmod.apply(params, jnp.asarray(px), jnp.asarray(pre),
                      jnp.asarray(post))
    got = tmod(_t(px), _t(pre), _t(post))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    kv_len = plen - np.asarray([0, 2], np.int32)
    want = jmod.apply(params, jnp.asarray(px), jnp.asarray(pre),
                      jnp.asarray(post), kv_len=jnp.asarray(kv_len))
    got = tmod(_t(px), _t(pre), _t(post), kv_len=_t(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("quant", ["fp32", "8bit"])
def test_prefill_and_rotating_window_decode_match_jax(pair, pair8, quant):
    """Prefill with ``kv_len`` (text before the image), then decode steps
    with ``write_col`` + ``kv_window`` (the batcher's form) against
    vlm_tpu's with ``kv_valid``, through a window wrap; fp32 with an fp32
    cache, 8bit with the int8 cache (fewer than 512 rows: the weight-only
    products, no activation quantized). The 8bit decode logits are held
    within two int8 steps of their max (``_within_two_int8_steps``): the
    cache quantizes each K/V row, and an fp32 value that differs from
    XLA's in its last ulp can round to the next int8 step (measured: one
    value of the prefill's rows, then 1-5 of the decode rows, moving the
    logits by up to 2.5e-3 at a max of 2.5; the prefill logits, which
    attend over the unquantized rows, stay within 1e-4)."""
    jmod, params, tmod, cfg, _ = pair8 if quant == "8bit" else pair
    cache_dtype = ("int8", "int8") if quant == "8bit" else (jnp.float32,
                                                           torch.float32)
    px, pre, post, plen = _inputs(cfg, seed=5)
    p, w = int(plen[0]), 4
    jcache = jax_init_cache(cfg.decoder, 2, p + w, cache_dtype[0])
    jlast, jcache = jmod.apply(params, jnp.asarray(px), jnp.asarray(pre),
                               jnp.asarray(post), jcache, jnp.asarray(plen),
                               method="prefill")
    cache = init_kv_cache(cfg.decoder, 2, p + w, cache_dtype[1])
    _lib.reset_counts()
    last = tmod.prefill(_t(px), _t(pre), _t(post), cache, _t(plen))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **LOGIT_TOL)
    acol = np.asarray([0, 0], np.int32)
    tok = np.asarray(jnp.argmax(jlast, -1))[:, None].astype(np.int32)
    for step in range(w + 2):
        gcnt = np.full((2,), min(step + 1, w), np.int32)
        cols = np.arange(p + w)[None]
        age = np.mod(cols - p - acol[:, None], w)
        valid = (cols < p) | ((cols < p + w) & (age < gcnt[:, None]))
        col = np.int32(p + step % w)
        jlog, jcache = jmod.apply(
            params, jnp.asarray(tok), jnp.asarray(plen + step), jcache,
            method="decode_step", write_col=jnp.asarray(col),
            kv_valid=jnp.asarray(valid))
        log = tmod.decode_step(_t(tok), _t(plen + step), cache,
                               write_col=torch.tensor(col),
                               kv_window=(p, w, _t(acol), _t(gcnt)))
        if quant == "8bit":
            _within_two_int8_steps(log.numpy(), np.asarray(jlog))
        else:
            np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                       **LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
    if quant == "8bit":
        assert min(_lib.plain_calls[k] for k in (
            "int8_matmul", "kv_write_int8", "decode_attention_int8")) > 0
        assert _lib.plain_calls["int8xint8_matmul"] == 0


def _within_two_int8_steps(got, want):
    """|got - want| <= 2/127 of max|want|, as ``tests/test_torch_quant.py``
    holds the 8bit paths where an int8 rounding can flip."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 / 127 * np.abs(want).max())


# ------------------------------- the batcher -------------------------------

def _serve(pair, slots, admit, caps, cache, jax_pad=0, port_pad=None,
           seed=None):
    """Both batchers on the same images: vlm_tpu's with ``jax_pad``, the
    port's with ``port_pad`` (None: the config's own 32001)."""
    jmod, params, tmod, cfg, _ = pair
    n, max_new = len(caps), max(caps)
    s = cfg.vision.image_size
    px = np.random.default_rng(n if seed is None else seed).normal(
        size=(n, s, s, 3)).astype(np.float32)
    pre = np.asarray([1, 9, 23, 5], np.int32)
    post = np.asarray([7, 9, 11], np.int32)
    plen = len(pre) + num_image_tokens(cfg) + len(post)
    run_kw = dict(pre_ids_row=pre, post_ids_row=post, prompt_len_scalar=plen,
                  n_images=n, max_new_per_image=caps)
    ref = JaxBatcher(jmod, jax_config("test"), batch_size=slots,
                     max_prompt_len=plen, max_new_tokens=max_new,
                     cache_dtype=cache[0], admit_block=admit,
                     pad_id=jax_pad).run(
        params, pixel_fn=lambda idxs: jnp.asarray(px[idxs]), **run_kw)
    _lib.reset_counts()
    got = ContinuousBatcher(tmod, cfg, batch_size=slots, max_prompt_len=plen,
                            max_new_tokens=max_new, admit_block=admit,
                            cache_dtype=cache[1], pad_id=port_pad).run(
        lambda idxs: torch.from_numpy(px[idxs]), **run_kw)
    return ref, got


@pytest.mark.parametrize("slots,admit,caps", [
    (2, 2, [2, 6, 3, 6, 4]),
    (3, 2, [5, 1, 3, 1, 2, 5, 1, 4, 2]),
    (4, 4, [6, 6, 2, 3, 6, 1, 5, 6, 4, 2, 6]),
], ids=["2slots_admit2", "3slots_admit2", "4slots_admit4"])
def test_greedy_tokens_identical_to_jax_batcher(pair, slots, admit, caps):
    """More images than slots and varied caps: slots go idle, are reused
    and the window wraps. vlm_tpu runs with an in-vocabulary pad (0); the
    port with the config's own (32001) and with 0: identical tokens."""
    ref, got = _serve(pair, slots, admit, caps, (jnp.float32, torch.float32))
    assert got == ref
    assert all(len(o) <= c for o, c in zip(got, caps))
    assert _lib.launches == dict.fromkeys(_lib.KERNELS, 0)
    assert min(_lib.plain_calls[k] for k in ("flash_attention_fp32",
                                             "decode_attention_fp32",
                                             "kv_write")) > 0
    _, got0 = _serve(pair, slots, admit, caps, (jnp.float32, torch.float32),
                     port_pad=0)
    assert got0 == ref


@pytest.mark.parametrize("slots,admit,caps", [
    (2, 2, [2, 6, 3, 6, 4]),
    (3, 2, [5, 1, 3, 1, 2, 5, 1, 4, 2]),
], ids=["2slots_admit2", "3slots_admit2"])
def test_8bit_int8kv_greedy_tokens_identical_to_jax_batcher(pair8, slots,
                                                            admit, caps):
    """8bit decoder weights and the int8 KV cache through both batchers
    (admissions below 512 rows: no activation is quantized)."""
    ref, got = _serve(pair8, slots, admit, caps, ("int8", "int8"))
    assert got == ref
    assert min(_lib.plain_calls[k] for k in (
        "int8_matmul", "kv_write_int8", "decode_attention_int8")) > 0
    assert _lib.plain_calls["kv_write"] == 0


def test_idle_slot_pad_poisons_jax_and_not_the_port(pair):
    """The "test" config keeps Vicuna's pad id 32001 in a vocabulary of
    512. vlm_tpu's batcher feeds it to idle slots; its embedding lookup
    fills that row with NaN, the slot's cache rows become NaN, and the
    slot's next occupant is poisoned (a masked weight of 0 times NaN is
    NaN): its tokens collapse to 0 (the argmax of NaN logits). The port
    feeds idle slots an in-vocabulary token: it neither raises nor is
    poisoned, and gives vlm_tpu's tokens with an in-vocabulary pad."""
    caps = [2, 6, 3, 6, 4]
    cache = (jnp.float32, torch.float32)
    poisoned, got = _serve(pair, 2, 2, caps, cache, jax_pad=32001, seed=5)
    clean, got0 = _serve(pair, 2, 2, caps, cache, jax_pad=0, port_pad=0,
                         seed=5)
    # images 0 and 1 are admitted into fresh slots: no fault
    assert poisoned[:2] == clean[:2]
    # the later occupants of reused slots: poisoned in vlm_tpu
    bad = [i for i in range(2, 5) if poisoned[i] != clean[i]]
    assert bad, (poisoned, clean)
    assert all(poisoned[i][1:] == [0] * (len(poisoned[i]) - 1) for i in bad)
    # the port with the config's own pad, and with 0: vlm_tpu's clean run
    assert got == got0 == clean


# ------------------------------- model class and CLI ------------------------

def test_llava_model_class(monkeypatch):
    m = create_model("llava", size="test", device="cpu")
    assert type(m).__name__ == "LLaVAModel" and m.family == "llava"
    assert m.DEFAULT_SIZE == "7b"
    assert m.format_prompt("hi") == ("USER: ", "\nhi ASSISTANT:", True,
                                     False)
    assert m.recipe.image_size == 56 and m.recipe.mode == "shortest_edge_crop"
    assert m.module.decoder.lm_head is not None
    m8 = create_model("llava", size="test", device="cpu",
                      quantization="8bit", kv_cache="int8")
    dec = m8.module.decoder
    assert dec.blocks[0].attn.q_proj.q.dtype == torch.int8
    assert dec.lm_head.weight.dtype == torch.bfloat16     # never quantized
    assert m8.module.projector.fc1.weight.dtype == torch.bfloat16
    assert m8.cache_dtype == "int8"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("VLM_TPU_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("llava", size="test")
    assert type(create_model("blip2", size="test", device="cpu")
                ).__name__ == "BLIP2OptModel"


def test_generate_dataset_builds_llava_prompt(tmp_path):
    """``generate_dataset`` on image files: BOS + "USER: " before the image
    tokens, the prompt and " ASSISTANT:" after; one text per image."""
    from PIL import Image
    m = create_model("llava", size="test", device="cpu", batch_size=2)
    paths = []
    for i in range(3):
        p = tmp_path / f"{i}.png"
        Image.fromarray(np.random.default_rng(i).integers(
            0, 255, (40, 60, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    out = m.generate_dataset(paths, "colour?", max_tokens=3)
    assert len(out) == 3 and all(isinstance(t, str) for t in out)


def test_cli_runs_llava(mivia_base, tmp_path, monkeypatch):
    import shutil
    from pathlib import Path

    import yaml

    from vlm_tpu.data.dataset_factory import DatasetFactory
    from vlm_tpu_torch.scripts.prompt_inference import main
    cfg = {"model_name": "llava", "model_size": "test",
           "quantization": "fp32", "dataset_name": "MiviaPar",
           "max_tokens": 2, "batch_size": 2,
           "dataset": {"base_path": str(mivia_base)},
           "prompts": {"MiviaPar": "colors?"}}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.setenv("VLM_TPU_ROOT", str(tmp_path))
    monkeypatch.setenv("VLM_TPU_PLATFORM", "cpu")
    (tmp_path / "configs").mkdir()
    shutil.copy(Path(__file__).resolve().parents[1] / "configs" /
                "task_datasets.yaml", tmp_path / "configs")
    DatasetFactory.load_task_map(force=True)
    summary = main(["--config", str(path), "--limit", "3"])
    assert summary["images_completed"] == 3
    assert (tmp_path / "eval" / "prompt_inference" / "llava_fp32" /
            "MiviaPar" / "metrics.json").exists()
