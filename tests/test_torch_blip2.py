"""The port's BLIP-2 OPT (EVA ViT-g tower, the Q-Former, the OPT decoder
with pre-LayerNorm, learned positions read at ``position + 2``, biased
projections, the plain ReLU FFN and the tied head) against vlm_tpu's on
the CPU at the "test" size in fp32, with vlm_tpu's weights copied through
the bridge: the tower, the Q-Former, the decoder, the assembled VLM,
prefill and rotating-window decode (fp32, and 8bit with the int8 KV cache
and the quantized tower), the continuous batcher, the model class and the
CLI.

vlm_tpu initialises every bias to 0 and every LayerNorm to (1, 0); the
fixtures draw them from a numpy seed instead, so that the biases and the
norms' affine terms take part in every comparison.

Tolerances: ops and layers atol = rtol = 1e-5; logits atol = rtol = 1e-4,
as ``tests/test_torch_llava.py``; greedy tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from vlm_tpu.generate.batcher import ContinuousBatcher as JaxBatcher
from vlm_tpu.models.configs import blip2_config as jax_config
from vlm_tpu.models.decoder import Decoder as JDecoder
from vlm_tpu.models.projector import QFormer as JQFormer
from vlm_tpu.models.vit import ViTEncoder as JViTEncoder
from vlm_tpu.models.vlm import init_kv_cache as jax_init_cache
from vlm_tpu.models.vlm import init_vlm
from vlm_tpu_torch.generate.batcher import ContinuousBatcher
from vlm_tpu_torch.models.configs import blip2_config
from vlm_tpu_torch.models.decoder import Decoder, init_kv_cache
from vlm_tpu_torch.models.factory import create_model
from vlm_tpu_torch.models.projector import QFormer
from vlm_tpu_torch.models.vlm import VLMModule, num_image_tokens
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.testing.bridge import flax_to_state_dict, load_flax_params

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
BOS = 2     # OPT: BOS = EOS = 2, pad 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _affine_from_seed(tree, seed=7):
    """The tree with every ``bias`` and every norm ``scale`` drawn from a
    numpy seed (a quantized Dense's ``scale`` stays: it is its weights')."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        quantized = "q_kernel" in node
        for key, val in node.items():
            if isinstance(val, dict):
                out[key] = walk(val)
            elif key == "bias":
                out[key] = rng.normal(0, 0.1, val.shape).astype(val.dtype)
            elif key == "scale" and not quantized:
                out[key] = (1 + rng.normal(0, 0.1, val.shape)).astype(
                    val.dtype)
            else:
                out[key] = val
        return out
    return walk(tree)


def _pair(bits=0):
    jcfg = jax_config("test")
    jmod, params = init_vlm(jcfg, jax.random.key(0), dtype=jnp.float32,
                            quant_bits=bits, vision_quant_bits=bits)
    tree = _affine_from_seed(jax.tree.map(np.asarray, meta.unbox(params)))
    params = jax.tree.map(jnp.asarray, tree)
    cfg = blip2_config("test")
    tmod = VLMModule(cfg, dtype=torch.float32, quant_bits=bits,
                     vision_quant_bits=bits)
    load_flax_params(tmod, tree)
    return jmod, params, tmod, cfg, tree


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def pair8():
    """int8 decoder and tower blocks (``quantize_vision``, fp32 compute);
    the Q-Former, the patch embedding and the tied head stay unquantized,
    as in vlm_tpu."""
    return _pair(8)


def _inputs(cfg, b=2, n_post=6, seed=1):
    """Pixels and BOS + ``n_post - 1`` ids after the query tokens."""
    s = cfg.vision.image_size
    rng = np.random.default_rng(seed)
    px = rng.normal(size=(b, s, s, 3)).astype(np.float32)
    pre = np.zeros((b, 0), np.int32)
    post = np.concatenate([np.full((b, 1), BOS, np.int32),
                           rng.integers(3, 500, (b, n_post - 1)).astype(
                               np.int32)], 1)
    plen = np.full((b,), num_image_tokens(cfg) + n_post, np.int32)
    return px, pre, post, plen


# ------------------------------- config -------------------------------

def test_blip2_config_is_eva_qformer_opt():
    """What OPT asks of the port beside LLaMA and Gemma: LayerNorm, learned
    positions, the plain ReLU FFN, biased projections, the tied head,
    BOS = EOS; EVA: a CLS token, no K bias, the post LN on all tokens,
    exact GELU; the Q-Former's query tokens take the image's place."""
    cfg = blip2_config("test")
    dec, vis, qf = cfg.decoder, cfg.vision, cfg.qformer
    assert dec.norm == "layernorm" and dec.pos == "learned"
    assert not dec.gated_mlp and dec.act == "relu" and dec.attn_bias
    assert dec.tie_embeddings and not dec.embed_scale
    assert dec.bos_token_id == dec.eos_token_id == 2 and dec.pad_token_id == 1
    assert dec.pad_token_id < dec.vocab_size
    assert vis.use_cls_token and not vis.k_bias and vis.act == "gelu"
    assert vis.post_layernorm == "all" and not vis.pre_layernorm
    assert cfg.projector == "qformer" and cfg.vision_feature_layer == -1
    assert not cfg.drop_cls_for_llm and not cfg.prefix_lm
    assert num_image_tokens(cfg) == qf.num_query_tokens == 8
    assert qf.encoder_hidden == vis.hidden
    full = blip2_config("6.7b")
    assert num_image_tokens(full) == 32 and full.vision.seq_len == 257
    assert (full.vision.hidden, full.vision.heads, full.vision.head_dim,
            full.vision.layers) == (1408, 16, 88, 39)
    assert (full.qformer.hidden, full.qformer.heads, full.qformer.layers,
            full.qformer.cross_attention_frequency) == (768, 12, 12, 2)
    assert (full.decoder.heads, full.decoder.kv_heads, full.decoder.head_dim,
            full.decoder.mlp_dim) == (32, 32, 128, 16384)


# ------------------------------- modules -------------------------------

def test_bridge_covers_every_parameter(pair, pair8):
    """The Q-Former's flat per-layer names land in ``layers.<i>``; OPT's
    position table and ``fc1`` by the existing rules; nothing missing or
    extra, in fp32 and in 8bit with the quantized tower."""
    for _, _, tmod, cfg, tree in (pair, pair8):
        state = flax_to_state_dict(tree)
        assert set(state) == set(tmod.state_dict())
        dec, qf = cfg.decoder, cfg.qformer
        assert tuple(state["decoder.pos_embed.weight"].shape) == (
            dec.max_position + 2, dec.hidden)
        assert tuple(state["projector.query_tokens"].shape) == (
            1, qf.num_query_tokens, qf.hidden)
        assert tuple(state["projector.layers.0.cross_attn.k.weight"].shape) \
            == (qf.hidden, qf.encoder_hidden)
        assert "projector.layers.1.cross_attn.q.weight" not in state
        assert tuple(state["projector.language_projection.weight"].shape) == (
            dec.hidden, qf.hidden)
        assert "decoder.blocks.0.input_norm.bias" in state
        assert "decoder.lm_head.weight" not in state
        assert "vision.blocks.0.attn.k_proj.bias" not in state
    state8 = flax_to_state_dict(pair8[4])
    assert "decoder.blocks.0.mlp.fc1.q" in state8
    assert "vision.blocks.0.fc1.q" in state8
    assert state8["projector.layers.0.ffn_up.weight"].dtype == torch.float32


def test_eva_tower_matches_jax(pair):
    """``last_hidden_state`` (the post LN on every token, CLS first) and
    ``pooled`` (the CLS through the post LN a second time)."""
    _, _, tmod, cfg, tree = pair
    px, _, _, _ = _inputs(cfg, seed=3)
    want = JViTEncoder(cfg.vision, dtype=jnp.float32).apply(
        {"params": tree["params"]["vision"]}, jnp.asarray(px))
    got = tmod.vision(_t(px), keep_hidden_states=False)
    assert got["last_hidden_state"].shape == (2, 1 + 16, cfg.vision.hidden)
    for key in ("last_hidden_state", "pooled"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **TOL)


@pytest.mark.parametrize("size", ["test", "two_cross_layers"])
def test_qformer_matches_jax(size):
    """The Q-Former alone on random image tokens: query tokens broadcast
    over the batch, ``input_ln``, self-attention, cross-attention every
    second layer from layer 0, the GELU FFN, ``language_projection``.
    "two_cross_layers": 4 layers of 3 heads over 20 image tokens of 24."""
    import dataclasses
    qcfg = blip2_config("test").qformer
    n_img, out_dim = 17, 48
    if size == "two_cross_layers":
        qcfg = dataclasses.replace(qcfg, layers=4, heads=3, hidden=36,
                                   encoder_hidden=24, num_query_tokens=5)
        n_img = 20
    rng = np.random.default_rng(2)
    img = rng.normal(size=(3, n_img, qcfg.encoder_hidden)).astype(np.float32)
    jq = JQFormer(qcfg, out_dim, jnp.float32, jnp.float32)
    params = jq.init(jax.random.key(4), jnp.asarray(img))
    tree = _affine_from_seed(jax.tree.map(np.asarray, meta.unbox(params)))
    tq = QFormer(qcfg, out_dim)
    load_flax_params(tq, tree)
    assert sum(layer.cross_attn is not None for layer in tq.layers) == \
        -(-qcfg.layers // 2)
    want = jq.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(img))
    got = tq(_t(img))
    assert got.shape == (3, qcfg.num_query_tokens, out_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vision_and_qformer_match(pair):
    jmod, params, tmod, cfg, _ = pair
    px, _, _, _ = _inputs(cfg)
    want = jmod.apply(params, jnp.asarray(px), method="encode_images")
    got = tmod.encode_images(_t(px))
    assert got.shape == (2, 8, cfg.decoder.hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_opt_decoder_matches_jax(pair):
    """The decoder alone on token ids: LayerNorm, the ReLU FFN through
    ``fc1``, biases and the tied head; learned positions from 0, at
    non-zero offsets (each row its own), and with ``logits_index``."""
    _, _, tmod, cfg, tree = pair
    ids = np.random.default_rng(4).integers(0, 512, (2, 9)).astype(np.int32)
    jdec = JDecoder(cfg.decoder, dtype=jnp.float32)
    dparams = {"params": tree["params"]["decoder"]}
    want, _ = jdec.apply(dparams, input_ids=jnp.asarray(ids))
    got = tmod.decoder(input_ids=_t(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    pos = (np.arange(9)[None] + np.asarray([[37], [400]])).astype(np.int32)
    idx = np.asarray([3, 8], np.int32)
    want, _ = jdec.apply(dparams, input_ids=jnp.asarray(ids),
                         positions=jnp.asarray(pos),
                         logits_index=jnp.asarray(idx))
    got = tmod.decoder(input_ids=_t(ids), positions=_t(pos),
                       logits_index=_t(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    # the offsets move the logits: the positions are read, not ignored
    assert not np.allclose(got.numpy(), tmod.decoder(
        input_ids=_t(ids), logits_index=_t(idx)).numpy(), atol=1e-3)


def test_position_past_the_table_raises():
    """OPT's table holds max_position + 2 rows read at position + 2: the
    last position is max_position - 1; one more raises, never clamps. The
    batcher refuses a prompt and a budget past the table."""
    cfg = blip2_config("test")
    dec = Decoder(cfg.decoder)
    top = cfg.decoder.max_position
    ids = torch.zeros((1, 1), dtype=torch.int32)
    dec(input_ids=ids, positions=torch.tensor([[top - 1]]))
    with pytest.raises(IndexError):
        dec(input_ids=ids, positions=torch.tensor([[top]]))
    with pytest.raises(ValueError, match="positions"):
        dec(input_ids=torch.zeros((1, top + 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="exceed"):
        ContinuousBatcher(VLMModule(cfg), cfg, batch_size=2,
                          max_prompt_len=top - 10, max_new_tokens=11)


def test_full_forward_matches(pair):
    """Causal over [query tokens] [BOS + prompt], with and without
    ``kv_len``."""
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
    """Prefill, then decode steps with ``write_col`` + ``kv_window`` (the
    batcher's form) against vlm_tpu's with ``kv_valid``, through a window
    wrap; fp32 with an fp32 cache, 8bit (decoder and tower) with the int8
    cache, whose decode logits are held within two int8 steps of their
    max, as ``tests/test_torch_llava.py`` holds LLaVA's."""
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
            np.testing.assert_allclose(
                log.numpy(), np.asarray(jlog), rtol=0,
                atol=2 / 127 * np.abs(np.asarray(jlog)).max())
        else:
            np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                       **LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
    if quant == "8bit":
        assert min(_lib.plain_calls[k] for k in (
            "int8_matmul", "kv_write_int8", "decode_attention_int8")) > 0
        assert _lib.plain_calls["int8xint8_matmul"] == 0


# ------------------------------- the batcher -------------------------------

def _serve(pair, slots, admit, caps, cache, eos_id=None):
    """Both batchers on the same images with the config's own ids (pad 1
    lies in the vocabulary) and a prompt that begins with BOS (= EOS)."""
    jmod, params, tmod, cfg, _ = pair
    n, max_new = len(caps), max(caps)
    s = cfg.vision.image_size
    px = np.random.default_rng(n).normal(size=(n, s, s, 3)).astype(
        np.float32)
    pre = np.zeros((0,), np.int32)
    post = np.asarray([BOS, 9, 23, 5, 7], np.int32)
    plen = num_image_tokens(cfg) + len(post)
    run_kw = dict(pre_ids_row=pre, post_ids_row=post, prompt_len_scalar=plen,
                  n_images=n, max_new_per_image=caps)
    ref = None
    if eos_id is None:
        ref = JaxBatcher(jmod, jax_config("test"), batch_size=slots,
                         max_prompt_len=plen, max_new_tokens=max_new,
                         cache_dtype=cache[0], admit_block=admit).run(
            params, pixel_fn=lambda idxs: jnp.asarray(px[idxs]), **run_kw)
    _lib.reset_counts()
    got = ContinuousBatcher(tmod, cfg, batch_size=slots, max_prompt_len=plen,
                            max_new_tokens=max_new, admit_block=admit,
                            cache_dtype=cache[1], eos_id=eos_id).run(
        lambda idxs: torch.from_numpy(px[idxs]), **run_kw)
    return ref, got


SERVE = [
    (2, 2, [2, 6, 3, 6, 4]),
    (3, 2, [5, 1, 3, 1, 2, 5, 1, 4, 2]),
    # more slots than images: two slots never admitted
    (6, 2, [5, 3, 6, 2]),
]
SERVE_IDS = ["2slots_admit2", "3slots_admit2", "6slots_4images"]


@pytest.mark.parametrize("slots,admit,caps", SERVE, ids=SERVE_IDS)
def test_greedy_tokens_identical_to_jax_batcher(pair, slots, admit, caps):
    """More images than slots and varied caps (slots go idle, are reused,
    the window wraps), or fewer: identical tokens, each within its cap,
    every B1/B2/B3 call the plain fp32 version on the CPU."""
    ref, got = _serve(pair, slots, admit, caps, (jnp.float32, torch.float32))
    assert got == ref
    assert all(len(o) <= c for o, c in zip(got, caps))
    assert _lib.launches == dict.fromkeys(_lib.KERNELS, 0)
    assert min(_lib.plain_calls[k] for k in ("flash_attention_fp32",
                                             "decode_attention_fp32",
                                             "kv_write")) > 0


@pytest.mark.parametrize("slots,admit,caps", SERVE[:2], ids=SERVE_IDS[:2])
def test_8bit_int8kv_greedy_tokens_identical_to_jax_batcher(pair8, slots,
                                                            admit, caps):
    """8bit decoder and tower weights (``quantize_vision``) and the int8
    KV cache through both batchers (no activation is quantized below 512
    rows)."""
    ref, got = _serve(pair8, slots, admit, caps, ("int8", "int8"))
    assert got == ref
    assert min(_lib.plain_calls[k] for k in (
        "int8_matmul", "kv_write_int8", "decode_attention_int8")) > 0
    assert _lib.plain_calls["kv_write"] == 0


def test_bos_in_the_prompt_never_finishes_a_slot(pair):
    """OPT's BOS is its EOS, and every prompt starts with it: a slot ends
    only on a generated EOS or its cap. Served with no EOS at all, each
    image's tokens cut at its first 2 give the tokens served with EOS 2;
    an image with no generated 2 runs to its cap."""
    caps = [6, 6, 5, 6, 4, 6, 6]
    cache = (jnp.float32, torch.float32)
    ref, got = _serve(pair, 3, 2, caps, cache)
    _, free = _serve(pair, 3, 2, caps, cache, eos_id=-1)
    assert got == ref
    for g, f, cap in zip(got, free, caps):
        assert len(f) == cap
        assert g == (f[:f.index(BOS)] if BOS in f else f)


# ------------------------------- model class and CLI ------------------------

def test_blip2_model_class(monkeypatch):
    """``create_model("blip2")`` builds BLIP2OptModel (default size
    "6.7b"), the 8bit recipe with the quantized tower and the int8 cache;
    the Q-Former and the tied head are never quantized; without CUDA it
    builds only when asked for the CPU."""
    m = create_model("blip2", size="test", device="cpu")
    assert type(m).__name__ == "BLIP2OptModel" and m.family == "blip2"
    assert m.DEFAULT_SIZE == "6.7b"
    assert m.format_prompt("hi") == ("", "Question: hi. Answer:", False,
                                     True)
    assert m.recipe.image_size == 56 and m.recipe.mode == "warp"
    assert m.module.decoder.lm_head is None
    m8 = create_model("blip2", size="test", device="cpu",
                      quantization="8bit", kv_cache="int8",
                      quantize_vision=True)
    assert m8.module.decoder.blocks[0].mlp.fc1.q.dtype == torch.int8
    assert m8.module.vision.blocks[0].attn.q_proj.q.dtype == torch.int8
    qf = m8.module.projector
    assert qf.layers[0].cross_attn.k.weight.dtype == torch.bfloat16
    assert qf.query_tokens.dtype == torch.bfloat16
    assert m8.module.decoder.embed.weight.dtype == torch.bfloat16
    assert m8.cache_dtype == "int8"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("VLM_TPU_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("blip2", size="test")


def test_blip2_prompt_ids_match_jax():
    """The prompt ids ``generate_dataset`` builds: nothing before the
    query tokens, BOS + ``Question: {prompt}. Answer:`` after them, with
    OPT's ids (BOS 2) in the byte fallback, as vlm_tpu's BLIP-2 model
    builds them."""
    from vlm_tpu.data.tokenizer import load_tokenizer as j_load_tokenizer
    from vlm_tpu.generate.decode import build_prompt_ids as j_build
    from vlm_tpu.models.base_model import BLIP2OptModel as JBLIP2
    from vlm_tpu_torch.generate.decode import build_prompt_ids
    m = create_model("blip2", size="test", device="cpu")
    tok = m.tokenizer
    assert (tok.bos_id, tok.eos_id, tok.pad_id) == (2, 2, 1)
    parts = m.format_prompt("what colour?")
    assert parts == JBLIP2.format_prompt(None, "what colour?")
    pre, post, plen = build_prompt_ids(tok, parts[0], parts[1], 8, 2,
                                       add_bos_to_pre=parts[2],
                                       add_bos_to_post=parts[3])
    jtok = j_load_tokenizer(None, bos_id=2, eos_id=2, pad_id=1)
    jpre, jpost, jplen = j_build(jtok, parts[0], parts[1], 8, 2,
                                 add_bos_to_pre=parts[2],
                                 add_bos_to_post=parts[3])
    assert pre.shape == (2, 0) and post[0, 0] == BOS
    np.testing.assert_array_equal(post.numpy(), np.asarray(jpost))
    np.testing.assert_array_equal(plen.numpy(), np.asarray(jplen))
    assert tok.decode(post[0, 1:].tolist()) == "Question: what colour?. Answer:"


def test_generate_dataset_serves_blip2(tmp_path):
    """``generate_dataset`` on image files: one text per image."""
    from PIL import Image
    m = create_model("blip2", size="test", device="cpu", batch_size=2)
    paths = []
    for i in range(3):
        p = tmp_path / f"{i}.png"
        Image.fromarray(np.random.default_rng(i).integers(
            0, 255, (40, 60, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    out = m.generate_dataset(paths, "colour?", max_tokens=3)
    assert len(out) == 3 and all(isinstance(t, str) for t in out)


def test_cli_runs_blip2(mivia_base, tmp_path, monkeypatch):
    import shutil
    from pathlib import Path

    import yaml

    from vlm_tpu.data.dataset_factory import DatasetFactory
    from vlm_tpu_torch.scripts.prompt_inference import main
    cfg = {"model_name": "blip2", "model_size": "test",
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
    assert (tmp_path / "eval" / "prompt_inference" / "blip2_fp32" /
            "MiviaPar" / "metrics.json").exists()
