"""The port's modules against vlm_tpu on the CPU at the "test" PaliGemma
size in fp32, with vlm_tpu's weights copied through the bridge: layers,
ViT, projector, decoder, the assembled VLM's forward/prefill/decode, the
model classes, run_zero_shot and the CLI.

Tolerances: ops and layers atol = rtol = 1e-5; VLM logits atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from vlm_tpu.models.configs import paligemma_config as jax_config
from vlm_tpu.models.decoder import apply_rope as jax_apply_rope
from vlm_tpu.models.decoder import rope_table as jax_rope_table
from vlm_tpu.models.layers import LayerNorm as JLayerNorm
from vlm_tpu.models.layers import RMSNorm as JRMSNorm
from vlm_tpu.models.layers import activation as jax_activation
from vlm_tpu.models.vlm import init_kv_cache as jax_init_cache
from vlm_tpu.models.vlm import init_vlm
from vlm_tpu_torch.models import layers
from vlm_tpu_torch.models.configs import paligemma_config
from vlm_tpu_torch.models.decoder import (apply_rope, init_kv_cache,
                                          rope_table)
from vlm_tpu_torch.models.factory import create_model
from vlm_tpu_torch.models.vlm import VLMModule, num_image_tokens
from vlm_tpu_torch.testing.bridge import flax_to_state_dict, load_flax_params

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_config("test")
    jmod, params = init_vlm(jcfg, jax.random.key(0), dtype=jnp.float32)
    cfg = paligemma_config("test")
    tmod = VLMModule(cfg, dtype=torch.float32)
    tree = jax.tree.map(np.asarray, meta.unbox(params))
    load_flax_params(tmod, tree)
    return jmod, params, tmod, cfg, tree


def _inputs(cfg, b=2, seed=1):
    s = cfg.vision.image_size
    rng = np.random.default_rng(seed)
    px = rng.normal(size=(b, s, s, 3)).astype(np.float32)
    pre = rng.integers(3, 500, (b, 3)).astype(np.int32)
    post = rng.integers(3, 500, (b, 4)).astype(np.int32)
    return px, pre, post


# ------------------------------- layers -------------------------------

@pytest.mark.parametrize("name", ["gelu", "gelu_tanh", "quick_gelu", "silu",
                                  "relu"])
def test_activation(name):
    x = np.random.default_rng(0).normal(size=(64,)).astype(np.float32) * 3
    np.testing.assert_allclose(layers.activation(name)(_t(x)).numpy(),
                               np.asarray(jax_activation(name)(x)), **TOL)


@pytest.mark.parametrize("gemma", [True, False])
def test_rmsnorm(gemma):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    ref = JRMSNorm(eps=1e-6, gemma_style=gemma).apply(
        {"params": {"scale": w}}, x)
    norm = layers.RMSNorm(16, 1e-6, gemma_style=gemma)
    norm.weight.data.copy_(_t(w))
    np.testing.assert_allclose(norm(_t(x)).numpy(), np.asarray(ref), **TOL)


def test_layernorm_and_dense():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 16)).astype(np.float32)
    w, b = rng.normal(size=(2, 16)).astype(np.float32)
    ref = JLayerNorm(eps=1e-5).apply({"params": {"scale": w, "bias": b}}, x)
    norm = layers.LayerNorm(16, 1e-5)
    norm.weight.data.copy_(_t(w))
    norm.bias.data.copy_(_t(b))
    np.testing.assert_allclose(norm(_t(x)).numpy(), np.asarray(ref), **TOL)
    dense = layers.Dense(16, 8)
    kernel = rng.normal(size=(16, 8)).astype(np.float32)
    dense.weight.data.copy_(_t(kernel.T))
    dense.bias.data.copy_(_t(b[:8]))
    np.testing.assert_allclose(dense(_t(x)).numpy(), x @ kernel + b[:8],
                               **TOL)


def test_dense_quantized_modes_point_to_roadmap():
    """Both quantized modes are ported: 8bit (int8 q [out, in], fp32 scale
    [out]) and 4bit (packed int4 q [out, in/2], fp32 group scales
    [out, in/group]); other bit widths are refused."""
    d = layers.Dense(4, 6, quant_bits=8)
    assert d.q.dtype == torch.int8 and tuple(d.q.shape) == (6, 4)
    assert d.scale.dtype == torch.float32 and tuple(d.scale.shape) == (6,)
    d4 = layers.Dense(256, 6, quant_bits=4)
    assert d4.q.dtype == torch.int8 and tuple(d4.q.shape) == (6, 128)
    assert d4.group_size == 128
    assert d4.scale.dtype == torch.float32 and tuple(d4.scale.shape) == (6, 2)
    with pytest.raises(ValueError, match="0, 4 or 8"):
        layers.Dense(4, 4, quant_bits=2)


def test_rope_matches_jax():
    cos, sin = rope_table(32, 64, 10000.0)
    jcos, jsin = jax_rope_table(32, 64, 10000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **TOL)
    x = np.random.default_rng(3).normal(size=(2, 5, 3, 32)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4], [7, 9, 11, 40, 63]], np.int32)
    got = apply_rope(_t(x), _t(pos), cos, sin).numpy()      # [B, S, H, D]
    want = jax_apply_rope(jnp.asarray(x.transpose(0, 2, 1, 3)),
                          jnp.asarray(pos), jcos, jsin)     # [B, H, S, D]
    np.testing.assert_allclose(got, np.asarray(want).transpose(0, 2, 1, 3),
                               **TOL)


def test_embed_scale_rounds_to_compute_dtype():
    cfg = paligemma_config("test")
    dec = VLMModule(cfg, dtype=torch.bfloat16).decoder
    dec.embed.weight.data.fill_(1.0)
    x = dec.embed_tokens(torch.tensor([[3]]))
    assert x.dtype == torch.bfloat16
    assert float(x[0, 0, 0]) == float(torch.tensor(64 ** 0.5,
                                                   dtype=torch.bfloat16))
    full = paligemma_config("3b").decoder.hidden ** 0.5
    assert float(torch.tensor(full, dtype=torch.bfloat16)) == 45.25


# ------------------------------- modules -------------------------------

def test_bridge_covers_every_parameter(pair):
    _, _, tmod, _, tree = pair
    assert set(flax_to_state_dict(tree)) == set(tmod.state_dict())


def test_vision_and_projector_match(pair):
    jmod, params, tmod, cfg, _ = pair
    px, _, _ = _inputs(cfg)
    want = jmod.apply(params, jnp.asarray(px), method="encode_images")
    got = tmod.encode_images(_t(px))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-4)


def test_full_forward_matches(pair):
    jmod, params, tmod, cfg, _ = pair
    px, pre, post = _inputs(cfg)
    plen = np.full((2,), 3 + num_image_tokens(cfg) + 2, np.int32)
    for kw, tkw in (({}, {}), ({"prefix_len": jnp.asarray(plen)},
                               {"prefix_len": _t(plen)})):
        want = jmod.apply(params, jnp.asarray(px), jnp.asarray(pre),
                          jnp.asarray(post), **kw)
        got = tmod(_t(px), _t(pre), _t(post), **tkw)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **LOGIT_TOL)


def test_prefill_and_decode_match_jax_and_full_forward(pair):
    """Mirror of tests/test_models.py::test_prefill_and_decode_match_full_
    forward, with vlm_tpu's own prefill/decode as the reference."""
    jmod, params, tmod, cfg, _ = pair
    px, pre, post = _inputs(cfg)
    plen = np.full((2,), 3 + num_image_tokens(cfg) + 4, np.int32)
    jcache = jax_init_cache(cfg.decoder, 2, 64, jnp.float32)
    jlast, jcache = jmod.apply(params, jnp.asarray(px), jnp.asarray(pre),
                               jnp.asarray(post), jcache, jnp.asarray(plen),
                               method="prefill")
    cache = init_kv_cache(cfg.decoder, 2, 64, torch.float32)
    last = tmod.prefill(_t(px), _t(pre), _t(post), cache, _t(plen))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **LOGIT_TOL)
    np.testing.assert_allclose(cache["k"][1].numpy(),
                               np.asarray(jcache["k"][1]), **LOGIT_TOL)

    nxt = np.asarray(jnp.argmax(jlast, -1))[:, None].astype(np.int32)
    jstep, _ = jmod.apply(params, jnp.asarray(nxt), jnp.asarray(plen),
                          jcache, method="decode_step")
    step = tmod.decode_step(_t(nxt), _t(plen), cache)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), **LOGIT_TOL)
    full = tmod(_t(px), _t(pre), _t(np.concatenate([post, nxt], 1)),
                prefix_len=_t(plen))
    np.testing.assert_allclose(step.numpy(), full[:, -1].numpy(),
                               **LOGIT_TOL)


def test_decode_step_rotating_window_matches_jax(pair):
    """decode_step with write_col + kv_window (the batcher's form) against
    vlm_tpu's with write_col + kv_valid."""
    jmod, params, tmod, cfg, _ = pair
    px, pre, post = _inputs(cfg, seed=5)
    t = num_image_tokens(cfg)
    p = 3 + t + 4
    plen = np.full((2,), p, np.int32)
    w = 4
    jcache = jax_init_cache(cfg.decoder, 2, p + w, jnp.float32)
    jlast, jcache = jmod.apply(params, jnp.asarray(px), jnp.asarray(pre),
                               jnp.asarray(post), jcache, jnp.asarray(plen),
                               method="prefill")
    cache = init_kv_cache(cfg.decoder, 2, p + w, torch.float32)
    tmod.prefill(_t(px), _t(pre), _t(post), cache, _t(plen))
    acol = np.asarray([0, 0], np.int32)
    tok = np.asarray(jnp.argmax(jlast, -1))[:, None].astype(np.int32)
    for step in range(w + 2):                    # wraps the window
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
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   **LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)


def test_padded_prompt_is_masked(pair):
    _, _, tmod, cfg, _ = pair
    px, _, _ = _inputs(cfg, b=1, seed=2)
    pre, post = np.asarray([[5, 6]], np.int32), np.asarray([[7, 8, 9]],
                                                          np.int32)
    plen = np.asarray([2 + num_image_tokens(cfg) + 3], np.int32)
    a = tmod.prefill(_t(px), _t(pre), _t(post),
                     init_kv_cache(cfg.decoder, 1, 64, torch.float32),
                     _t(plen))
    b = tmod.prefill(_t(px), _t(pre), _t(np.asarray([[7, 8, 9, 0, 0]],
                                                     np.int32)),
                     init_kv_cache(cfg.decoder, 1, 64, torch.float32),
                     _t(plen))
    np.testing.assert_allclose(a.numpy(), b.numpy(), **LOGIT_TOL)


# ------------------------------- model classes -------------------------------

def test_model_classes_and_roadmap_errors(tmp_path):
    m = create_model("paligemma", quantization="fp32", size="test",
                     device="cpu")
    assert m.format_prompt("hi") == ("", "hi\n", False, True)
    m2 = create_model("paligemma", quantization="fp32", size="test",
                      device="cpu")
    for a, b in zip(m.module.parameters(), m2.module.parameters()):
        assert torch.equal(a, b)                   # seeded random init
    assert create_model("paligemma", quantization="fp16", size="test",
                        device="cpu").dtype == torch.bfloat16
    # 8bit: bf16 compute with int8 block weights; the int8 KV cache
    m8 = create_model("paligemma", quantization="8bit", size="test",
                      device="cpu")
    assert m8.dtype == torch.bfloat16 and m8.policy.quantized_bits == 8
    assert m8.module.decoder.blocks[0].mlp.down_proj.q.dtype == torch.int8
    assert m8.module.vision.blocks[0].fc1.weight.dtype == torch.bfloat16
    assert m8.cache_dtype == torch.bfloat16
    assert create_model("paligemma", size="test", device="cpu",
                        kv_cache="int8").cache_dtype == "int8"
    # 4bit: bf16 compute with packed int4 block weights and group scales
    m4 = create_model("paligemma", quantization="4bit", size="test",
                      device="cpu")
    assert m4.dtype == torch.bfloat16 and m4.policy.quantized_bits == 4
    down = m4.module.decoder.blocks[0].mlp.down_proj
    assert down.q.dtype == torch.int8 and tuple(down.q.shape) == (64, 64)
    assert tuple(down.scale.shape) == (64, 1) and down.group_size == 128
    assert m4.module.vision.blocks[0].fc1.weight.dtype == torch.bfloat16
    # the mesh block as vlm_tpu checks it: 1 x 2 needs two devices, and the
    # CPU is one (a larger mesh on enough devices: A17,
    # tests/test_torch_mesh.py)
    with pytest.raises(ValueError, match="needs 2 devices"):
        create_model("paligemma", size="test", device="cpu",
                     mesh={"data": 1, "model": 2})
    # vlm_tpu's refusal of a path that does not exist (checkpoint loading:
    # tests/test_torch_hf_weights.py, tests/test_torch_hf_parity.py)
    with pytest.raises(FileNotFoundError, match="hub ids are not supported"):
        create_model("paligemma", size="test", device="cpu",
                     model_id="/nonexistent")
    # LLaVA and BLIP-2 are ported (tests/test_torch_llava.py,
    # tests/test_torch_blip2.py)
    assert type(create_model("blip2", size="test", device="cpu")
                ).__name__ == "BLIP2OptModel"
    # beam search runs in waves (A15; tests/test_torch_beam.py)
    from PIL import Image
    Image.fromarray(np.zeros((30, 40, 3), np.uint8)).save(tmp_path / "a.png")
    out = m.generate_dataset([tmp_path / "a.png"], "p", max_tokens=2,
                             num_beams=2)
    assert len(out) == 1 and isinstance(out[0], str)


@pytest.mark.parametrize("ask", ["nothing", "device", "env"])
def test_create_model_runs_on_the_card_unless_asked(ask, monkeypatch):
    """Without CUDA, a model with no device raises; it runs on the CPU only
    when asked, by ``device="cpu"`` or ``VLM_TPU_PLATFORM=cpu``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("VLM_TPU_PLATFORM", raising=False)
    if ask == "nothing":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model("paligemma", size="test")
        return
    kw = {"device": "cpu"} if ask == "device" else {}
    if ask == "env":
        monkeypatch.setenv("VLM_TPU_PLATFORM", "cpu")
    m = create_model("paligemma", size="test", **kw)
    assert m.device == torch.device("cpu")
    assert next(m.module.parameters()).device == torch.device("cpu")


def test_run_zero_shot_through_port(mivia_base, tmp_path):
    from vlm_tpu.data.mivia_par_dataset import MiviaParDataset
    from vlm_tpu.evaluation import run_zero_shot
    model = create_model("paligemma", quantization="fp32", size="test",
                         device="cpu", batch_size=2)
    ds = MiviaParDataset("MiviaPar", split="test", base_path=mivia_base)
    summary = run_zero_shot(model, ds, "describe", tmp_path / "out",
                            max_tokens=3, batch_size=2)
    assert summary["images_completed"] == len(ds) == 4
    assert (tmp_path / "out" / "metrics.json").exists()


def _run_cli(mivia_base, tmp_path, monkeypatch, **extra):
    import yaml

    from vlm_tpu.data.dataset_factory import DatasetFactory
    from vlm_tpu_torch.scripts.prompt_inference import main
    cfg = {"model_name": "paligemma", "model_size": "test",
           "quantization": "fp32", "dataset_name": "MiviaPar",
           "max_tokens": 2, "batch_size": 2,
           "dataset": {"base_path": str(mivia_base)},
           "prompts": {"MiviaPar": "colors?"}, **extra}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.setenv("VLM_TPU_ROOT", str(tmp_path))
    # the CLI's model runs on the card unless asked for the CPU
    monkeypatch.setenv("VLM_TPU_PLATFORM", "cpu")
    (tmp_path / "configs").mkdir()
    import shutil
    from pathlib import Path
    shutil.copy(Path(__file__).resolve().parents[1] / "configs" /
                "task_datasets.yaml", tmp_path / "configs")
    DatasetFactory.load_task_map(force=True)
    summary = main(["--config", str(path), "--limit", "3"])
    assert summary["images_completed"] == 3
    assert (tmp_path / "eval" / "prompt_inference" /
            f"paligemma_{cfg['quantization']}" / "MiviaPar" /
            "metrics.json").exists()


def test_cli_runs_the_port(mivia_base, tmp_path, monkeypatch):
    _run_cli(mivia_base, tmp_path, monkeypatch)


def test_cli_runs_the_port_8bit_int8_kv(mivia_base, tmp_path, monkeypatch):
    """8bit weights, the int8 KV cache, a quantized tower and the
    ``int8_prefill`` key, which the CLI hands to the int8 layers through
    ``VLM_TPU_INT8_PREFILL`` (restored afterwards by monkeypatch)."""
    from vlm_tpu_torch.ops import _lib
    monkeypatch.setenv("VLM_TPU_INT8_PREFILL", "dynamic")
    _lib.reset_counts()
    _run_cli(mivia_base, tmp_path, monkeypatch, quantization="8bit",
             kv_cache="int8", quantize_vision=True,
             int8_prefill="dynamic_noout")
    import os
    assert os.environ["VLM_TPU_INT8_PREFILL"] == "dynamic_noout"
    assert min(_lib.plain_calls[k] for k in (
        "int8_matmul", "kv_write_int8", "decode_attention_int8")) > 0
    assert _lib.plain_calls["kv_write"] == 0


def test_cli_runs_the_port_4bit(mivia_base, tmp_path, monkeypatch):
    """``quantization: 4bit`` reaches ``create_model`` as it is: packed
    int4 weights, the B7 product (plain on the CPU) at decode."""
    from vlm_tpu_torch.ops import _lib
    _lib.reset_counts()
    _run_cli(mivia_base, tmp_path, monkeypatch, quantization="4bit")
    assert _lib.plain_calls["int4_matmul"] > 0
    assert _lib.plain_calls["int8_matmul"] == 0
