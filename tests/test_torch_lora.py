"""The port's LoRA (``vlm_tpu_torch/probing/lora.py``) against
``vlm_tpu``'s on the CPU, at the "test" size in fp32, from the same
weights and adapters (bridged from the flax trees):

- held exactly: the target names against ``get_lora_target_names``
  (last_k 1 and 2, attn_only true and false), the config block's spec;
- held at 1e-6: ``merge_lora``'s merged weights;
- ``SingleTaskTrainer`` with LoRA (the tower frozen, the adapters on the
  last block's attention): step-1 gradients within rtol 1e-4 and atol
  1e-6, epoch losses within 1e-4 relative, parameters after the run within
  0.1 x lr; the base weights bitwise as built; B1's differentiable form in
  the adapted block only; the tester's preds identical to ``vlm_tpu``'s;
- the CLIs train then test with LoRA; the refusals: a quantized tower,
  rank 0, an unknown target.

Dropout is 0 wherever both frameworks run.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tests.test_torch_probing import (  # noqa: F401
    _cfg, _write_cli_configs, env)
from vlm_tpu.models.factory import VLMModelFactory
from vlm_tpu.probing import lora as j_lora
from vlm_tpu.probing.test.singletask_tester import \
    SingleTaskTester as JTester
from vlm_tpu.probing.train import utils as j_utils
from vlm_tpu.probing.train.singletask_trainer import \
    SingleTaskTrainer as JTrainer
from vlm_tpu_torch.models.factory import create_model
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.probing import lora as t_lora
from vlm_tpu_torch.probing.test.singletask_tester import \
    SingleTaskTester as TTester
from vlm_tpu_torch.probing.train import utils as t_utils
from vlm_tpu_torch.probing.train.data import Batch
from vlm_tpu_torch.probing.train.singletask_trainer import \
    SingleTaskTrainer as TTrainer
from vlm_tpu_torch.scripts import test_probe as t_test_cli
from vlm_tpu_torch.scripts import train_probe as t_train_cli
from vlm_tpu_torch.testing.bridge import (flax_to_state_dict,
                                          head_state_to_state_dict,
                                          load_flax_params, load_head_state,
                                          load_lora, lora_name)

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LORA = {"enabled": True, "rank": 4, "alpha": 8.0, "last_k": 1,
        "attn_only": True}


def _np(tree):
    return jax.tree.map(np.asarray, meta.unbox(tree))


@pytest.fixture(scope="module")
def towers():
    """``vlm_tpu``'s "test" LLaVA tower and the port's with its weights."""
    jbb = VLMModelFactory.create_model("llava", quantization="fp32",
                                       size="test").get_vision_backbone()
    tbb = create_model("llava", size="test",
                       device="cpu").get_vision_backbone()
    load_flax_params(tbb.module, _np(jbb.params))
    return jbb, tbb


# ------------------------------ the adapters ------------------------------

@pytest.mark.parametrize("last_k", [1, 2])
@pytest.mark.parametrize("attn_only", [True, False])
def test_target_names_equal(towers, last_k, attn_only):
    jbb, tbb = towers
    strategy = {"last_k": last_k, "attn_only": attn_only}
    want = jbb.get_lora_target_names(strategy)
    got = tbb.get_lora_target_names(strategy)
    assert got == [lora_name(n) for n in want]
    assert len(got) == last_k * (4 if attn_only else 6)
    assert got == sorted(got)


def test_merge_equals_vlm_tpu(towers):
    """Adapters drawn nonzero from a seed (B too), merged by both: every
    merged weight within 1e-6, the untargeted ones unchanged."""
    jbb, tbb = towers
    targets = jbb.get_lora_target_names({"last_k": 2, "attn_only": False})
    jl = j_lora.init_lora(jbb.params, targets, rank=3,
                          rng=jax.random.key(5))
    rng = np.random.default_rng(6)
    jl = {n: {"A": ab["A"], "B": jnp.asarray(rng.normal(
        0, 0.1, ab["B"].shape).astype(np.float32))} for n, ab in jl.items()}
    want = flax_to_state_dict(_np(j_lora.merge_lora(jbb.params, jl, 6.0)))
    params = dict(tbb.module.named_parameters())
    tl = t_lora.init_lora(params, [lora_name(n) for n in targets], 3,
                          torch.Generator().manual_seed(0))
    load_lora(tl, _np(jl))
    got = t_lora.merge_lora(params, tl, 6.0)
    assert set(got) == set(params)
    changed = set()
    for name, w in got.items():
        np.testing.assert_allclose(w.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
        if not torch.equal(w, params[name]):
            changed.add(name[:-len(".weight")])
    assert changed == set(tl)
    assert all(not p.requires_grad for p in params.values())
    # differentiable in A and B only
    sum(got[f"{n}.weight"].sum() for n in tl).backward()
    assert all(ab["A"].grad is not None and ab["B"].grad is not None
               for ab in tl.values())


def test_init_lora_draw():
    params = {"lin.weight": torch.zeros(6, 10), "ln.weight": torch.ones(6)}
    a = t_lora.init_lora(params, ["lin"], 2, torch.Generator().manual_seed(1))
    b = t_lora.init_lora(params, ["lin"], 2, torch.Generator().manual_seed(1))
    assert a["lin"]["A"].shape == (10, 2) and a["lin"]["B"].shape == (2, 6)
    assert torch.equal(a["lin"]["A"], b["lin"]["A"])
    assert not a["lin"]["B"].any()
    bound = (6.0 / 10) ** 0.5
    assert float(a["lin"]["A"].abs().max()) <= bound
    assert a["lin"]["A"].requires_grad and a["lin"]["A"].is_leaf
    # a zero B leaves the weight as it is
    merged = t_lora.merge_lora(params, a, 4.0)
    assert torch.equal(merged["lin.weight"], params["lin.weight"])


def test_refusals(towers):
    jbb, tbb = towers
    params = dict(tbb.module.named_parameters())
    for rank in (0, -1):
        with pytest.raises(ValueError, match="rank"):
            t_lora.init_lora(params, ["blocks.1.attn.q_proj"], rank,
                             torch.Generator())
        with pytest.raises(ValueError, match="rank"):
            j_lora.init_lora(jbb.params, ["block_1/attn/q_proj"], rank,
                             jax.random.key(0))
    for bad in ("blocks.9.attn.q_proj", "blocks.1.ln1", "nope"):
        with pytest.raises(KeyError, match="no 2-D float weight"):
            t_lora.init_lora(params, [bad], 2, torch.Generator())
    ok = t_lora.init_lora(params, ["blocks.1.attn.q_proj"], 2,
                          torch.Generator())
    with pytest.raises(KeyError, match="without a matching weight"):
        t_lora.merge_lora(params, {"nope": ok["blocks.1.attn.q_proj"]}, 2.0)
    # a quantized tower has no float weight to adapt
    q = create_model("llava", size="test", device="cpu", quantization="8bit",
                     quantize_vision=True).get_vision_backbone()
    with pytest.raises(ValueError, match="quantized vision tower"):
        q.get_lora_target_names({"last_k": 1})
    with pytest.raises(ValueError, match="quantized vision tower"):
        t_lora.resolve_lora({"lora": LORA}, q, seed=0)
    with pytest.raises(ValueError, match="matched no layers"):
        t_lora.resolve_lora({"lora": dict(LORA, last_k=0)}, tbb, seed=0)


def test_spec_equal():
    for cfg in (None, {}, {"enabled": False, "rank": 4}, {"enabled": True},
                {"enabled": True, "rank": 2, "alpha": 4, "last_k": 3,
                 "attn_only": False, "lr": 0.0}):
        assert t_lora.lora_spec(cfg) == j_lora.lora_spec(cfg)
    assert t_lora.lora_spec({"enabled": True}) == {
        "rank": 8, "alpha": 16.0, "last_k": 2, "attn_only": True, "lr": None}
    assert t_lora.lora_lr(t_lora.lora_spec({"enabled": True}), 1e-3) == 1e-3
    # an explicit lr of 0 is honoured (a frozen-adapter ablation)
    assert t_lora.lora_lr(t_lora.lora_spec({"enabled": True, "lr": 0.0}),
                          1e-3) == 0.0


# ------------------------------ the trainer ------------------------------

def _jax_grads(jtr, images, targets):
    """``vlm_tpu``'s step-1 gradients of its LoRA step."""
    probe = jtr.probe
    clf, cw = probe.classifier, jtr.class_weights
    stats = probe.head_state["batch_stats"]
    feats_fn = j_lora.features_with_lora(
        probe.backbone, probe.backbone.cfg.backbone_pooling, jtr.lora_spec)
    y = jnp.asarray(j_utils.targets_to_arrays(targets, ["gender"])["gender"])
    pixels = probe.backbone._to_pixels(images)

    def loss(params):
        logits, _ = clf.apply({"params": params["head"],
                               "batch_stats": stats},
                              feats_fn(params, pixels), train=True,
                              mutable=["batch_stats"],
                              rngs={"dropout": jax.random.key(0)})
        return j_utils.masked_cross_entropy(logits, y, cw)
    return jax.grad(loss)(jtr._e2e_params())


def _port_named(jparams):
    out = {f"head.{k}": v for k, v in
           flax_to_state_dict(_np(jparams["head"])).items()}
    for n, ab in jparams["lora"].items():
        for k in ("A", "B"):
            out[f"lora.{lora_name(n)}.{k}"] = torch.tensor(np.asarray(ab[k]))
    return out


def test_singletask_trainer_matches_vlm_tpu(env, tmp_path):
    root, base = env
    cfg = _cfg(base)
    cfg["model"]["lora"] = dict(LORA)
    jtr = JTrainer(copy.deepcopy(cfg), "run", tmp_path / "jax")
    ttr = TTrainer(copy.deepcopy(cfg), "run", tmp_path / "torch")
    assert not jtr.use_feature_cache and not ttr.use_feature_cache
    load_head_state(ttr.probe.classifier, _np(jtr.probe.head_state))
    module = ttr.probe.backbone.module
    load_flax_params(module, _np(jtr.probe.backbone.params))
    load_lora(ttr.lora, _np(jtr.lora_params))
    assert sorted(ttr.lora) == ["blocks.1.attn.k_proj",
                                "blocks.1.attn.out_proj",
                                "blocks.1.attn.q_proj",
                                "blocks.1.attn.v_proj"]
    assert ttr.probe.fully_frozen
    assert {n for n in ttr.params if not n.startswith("head.")} == \
        set(t_lora.lora_named(ttr.lora))
    base_w = {n: p.detach().clone() for n, p in module.named_parameters()}

    ds = ttr.train_loader.dataset
    images, targets = zip(*(ds[i] for i in range(8)))
    want = _port_named(_jax_grads(jtr, list(images), list(targets)))
    saved = copy.deepcopy(ttr.probe.classifier.state_dict())
    ttr.optimizer.zero_grad(set_to_none=True)
    _lib.reset_counts()
    ttr.loss(Batch(list(images), list(targets)), train=True).backward()
    # B1's differentiable form in the adapted block only, its no-grad form
    # in block 0
    assert _lib.recomputes["flash_attention_diff_fp32"] == 1
    assert _lib.plain_calls["flash_attention_fp32"] == 2
    got = {n: p.grad.clone() for n, p in ttr.params.items()
           if p.grad is not None}
    ttr.optimizer.zero_grad(set_to_none=True)
    ttr.probe.classifier.load_state_dict(saved)
    assert set(got) == set(ttr.params)
    assert all(p.grad is None for p in module.parameters())
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    # B starts at zero: A's first gradient is zero, B's is not
    assert all(not got[n].any() for n in got if n.endswith(".A"))
    assert all(got[n].abs().max() > 1e-4 for n in got if n.endswith(".B"))

    p0 = {n: p.detach().clone() for n, p in ttr.params.items()}
    jtr.fit()
    ttr.fit()
    for key in ("train", "val"):
        np.testing.assert_allclose(ttr.history[key], jtr.history[key],
                                   rtol=1e-4, err_msg=key)
    jfinal = _port_named(jtr._e2e_params())
    lrs = {n: g["lr"] for g in ttr.optimizer.param_groups
           for n, p in ttr.params.items() if any(p is q for q in g["params"])}
    assert lrs["lora.blocks.1.attn.q_proj.A"] == 1e-2    # the head's lr
    for name, p in ttr.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jfinal[name].numpy(),
                                   rtol=0, atol=0.1 * lrs[name],
                                   err_msg=name)
        assert not torch.equal(p.detach(), p0[name]), name
    # the base weights never change; the checkpoint holds the adapters and
    # no tower
    for n, p in module.named_parameters():
        assert torch.equal(p, base_w[n]), n
    saved = t_utils.load_tensors(tmp_path / "torch" / "run" /
                                 "model.safetensors")
    assert not any(k.startswith("backbone.") for k in saved)
    assert {k for k in saved if k.startswith("lora.")} == \
        set(t_lora.lora_named(ttr.lora))


def test_singletask_tester_preds_equal_vlm_tpu(env, tmp_path):
    """``vlm_tpu``'s LoRA run and tester, then the port's tester on a port
    checkpoint of the same head, tower and adapters: identical preds; the
    adapters merged once, in place, at load."""
    root, base = env
    cfg = _cfg(base, epochs=1)
    cfg["model"]["lora"] = dict(LORA)
    ckpt = root / "probing" / "linear_probing" / "checkpoints"
    jtr = JTrainer(copy.deepcopy(cfg), "llava_fp32_gender_linear", ckpt)
    jtr.fit()
    test_cfg = {"data": {"base_path": str(base), "batch_size": 5},
                "eval": {"ckpt_from": str(ckpt / "llava_fp32_gender_linear"),
                         "dataset_name": "auto"}}
    JTester(copy.deepcopy(test_cfg)).run()
    out = root / "probing" / "linear_probing" / "eval" / \
        "llava_fp32_linear" / "gender" / "TestDataset"
    want = json.loads((out / "preds.json").read_text())
    want_metrics = json.loads((out / "metrics.json").read_text())

    port = tmp_path / "port_ckpt"
    port.mkdir()
    (port / "head_config.yaml").write_text(
        (ckpt / "llava_fp32_gender_linear" / "head_config.yaml").read_text())
    blob = {f"head.{k}": v for k, v in head_state_to_state_dict(
        _np(jtr.probe.head_state)).items()}
    blob.update({f"backbone.{k}": v for k, v in flax_to_state_dict(
        _np(jtr.probe.backbone.params)).items()})
    blob.update({f"lora.{lora_name(n)}.{k}": torch.tensor(np.asarray(ab[k]))
                 for n, ab in _np(jtr.lora_params).items() for k in "AB"})
    t_utils.save_tensors(port / "model.safetensors", blob)
    tester = TTester(dict(test_cfg, eval={"ckpt_from": str(port),
                                          "dataset_name": "auto"}))
    _lib.reset_counts()
    tester.run()
    assert json.loads((out / "preds.json").read_text()) == want
    assert json.loads((out / "metrics.json").read_text()) == want_metrics
    assert sum(_lib.recomputes.values()) == 0
    merged = flax_to_state_dict(_np(j_lora.merge_lora(
        jtr.probe.backbone.params, jtr.lora_params, LORA["alpha"])))
    q = tester.model.backbone.module.blocks[1].attn.q_proj.weight
    np.testing.assert_allclose(q.detach().numpy(),
                               merged["blocks.1.attn.q_proj.weight"].numpy(),
                               rtol=0, atol=1e-6)


# --------------------------------- the CLIs ---------------------------------

def test_clis_train_then_test_with_lora(env):
    root, base = env
    train_yaml, test_yaml = _write_cli_configs(
        root, base, lora={"enabled": True, "rank": 2, "last_k": 1})
    trainer = t_train_cli.main(["--config", str(train_yaml)])
    assert trainer.lora_spec["rank"] == 2 and not trainer.use_feature_cache
    assert trainer.run_name == "llava_fp32_age_linear"
    ckpt = root / "probing" / "linear_probing" / "checkpoints" / \
        trainer.run_name
    saved = t_utils.load_tensors(ckpt / "model.safetensors")
    assert len([k for k in saved if k.startswith("lora.")]) == 8
    tester = t_test_cli.main(["--config", str(test_yaml)])
    out = root / "probing" / "linear_probing" / "eval" / \
        "llava_fp32_linear" / "age" / "TestDataset"
    preds = json.loads((out / "preds.json").read_text())
    from vlm_tpu_torch.data.dataset_factory import DatasetFactory
    ds = DatasetFactory.create_dataset("TestDataset", split="test",
                                       base_path=str(base))
    direct = tester.model.predict([ds[i][0] for i in range(len(ds))])
    assert [p["age"] for p in preds] == direct.tolist()


def test_quantized_tower_with_lora_is_refused(env, tmp_path):
    root, base = env
    cfg = _cfg(base)
    cfg["model"].update(quantization="8bit", quantize_vision=True,
                        lora=dict(LORA))
    with pytest.raises(ValueError, match="quantized vision tower"):
        TTrainer(copy.deepcopy(cfg), "run", tmp_path / "t")
    cfg["model"].update(quantization="fp32", quantize_vision=False,
                        lora=dict(LORA, rank=0))
    with pytest.raises(ValueError, match="rank"):
        TTrainer(copy.deepcopy(cfg), "run", tmp_path / "t")
