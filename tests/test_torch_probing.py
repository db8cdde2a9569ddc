"""The port's single-task probing (``vlm_tpu_torch/probing``) against
``vlm_tpu``'s on the CPU, at the "test" size in fp32, from the same inputs
(numpy seeds) and the same weights (bridged from the flax trees):

- B1's differentiable form: dq, dk, dv against ``jax.grad`` of the Pallas
  kernel's custom VJP (interpret mode), within 1e-4 as ``tests/test_ops.py``;
- the heads (flax BatchNorm: momentum 0.9, biased running variance) within
  1e-6, the masked cross-entropy (0.0 on an all-ignored batch);
- the trainer in both modes (feature cache; end to end with the last block
  and the embeddings unfrozen): step-1 gradients within rtol 1e-4 and atol
  1e-6, epoch losses within 1e-4 relative, parameters after the run within
  0.1 x lr; a parameter whose step-1 gradient is rounding noise (below the
  atol on both sides: zero in exact arithmetic, as the key bias, to which
  softmax is invariant) takes AdamW steps of up to its lr in either
  direction, so it is held to that bound, |p - p0| <= lr x steps, on both
  sides instead;
- ``vlm_tpu``'s feature cache loads in the port; a resumed run equals a
  straight one; the tester's preds equal ``vlm_tpu``'s; the CLIs run and
  refuse what is not ported; the copied data and config helpers agree.

Dropout is 0 wherever both frameworks run (their RNGs cannot match).
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml
from flax.core import meta
from PIL import Image

from tests.conftest import make_face_dataset
from vlm_tpu.core import config as j_config
from vlm_tpu.data import augment as j_augment
from vlm_tpu.data.dataset_factory import DatasetFactory as JFactory
from vlm_tpu.ops.attention import attention as j_attention
from vlm_tpu.probing import heads as j_heads
from vlm_tpu.probing.test.singletask_tester import \
    SingleTaskTester as JTester
from vlm_tpu.probing.train import utils as j_utils
from vlm_tpu.probing.train.singletask_trainer import \
    SingleTaskTrainer as JTrainer
from vlm_tpu_torch.core import config as t_config
from vlm_tpu_torch.data import augment as t_augment
from vlm_tpu_torch.data.dataset_factory import DatasetFactory as TFactory
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.ops.attention import attention_plain, flash_attention
from vlm_tpu_torch.probing import heads as t_heads
from vlm_tpu_torch.probing.test.singletask_tester import \
    SingleTaskTester as TTester
from vlm_tpu_torch.probing.train import utils as t_utils
from vlm_tpu_torch.probing.train.data import Batch
from vlm_tpu_torch.probing.train.singletask_trainer import \
    SingleTaskTrainer as TTrainer
from vlm_tpu_torch.scripts import test_probe as t_test_cli
from vlm_tpu_torch.scripts import train_probe as t_train_cli
from vlm_tpu_torch.testing.bridge import (head_state_to_state_dict,
                                          load_flax_params, load_head_state)

REPO = __import__("pathlib").Path(__file__).resolve().parents[1]
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, meta.unbox(tree))


# ------------------------- B1's differentiable form -------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_flash_diff_grads_match_jax(causal):
    rng = np.random.default_rng(3)
    q, k, v, w = (rng.normal(size=(2, 4, 64, 64)).astype(np.float32)
                  for _ in range(4))

    def loss(q, k, v):
        return jnp.sum(j_attention(q, k, v, causal=causal, impl="flash") * w)
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    _lib.reset_counts()
    o = flash_attention(tq, tk, tv, causal=causal)
    assert _lib.plain_calls["flash_attention_fp32"] == 1    # the forward
    (o * torch.from_numpy(w)).sum().backward()
    # the backward recomputes, counted apart from the plain versions
    assert _lib.plain_calls["flash_attention_fp32"] == 1
    assert _lib.recomputes == {"flash_attention_diff": 0,
                               "flash_attention_diff_fp32": 1}
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        assert float(np.abs(got.numpy() - np.asarray(ref)).max()) < 1e-4
    np.testing.assert_allclose(
        o.detach().numpy(),
        np.asarray(j_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                               impl="flash")), atol=1e-5, rtol=0)


def test_flash_attention_without_grad_is_unchanged():
    """No gradient needed: no autograd node, no recompute, the plain
    version's call (the kernel's on the card), as before."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 9, 8)).astype(
        np.float32)) for _ in range(3))
    _lib.reset_counts()
    o = flash_attention(q, k, v)
    assert o.grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert flash_attention(qg, k, v).grad_fn is None
    assert _lib.plain_calls["flash_attention_fp32"] == 2
    assert sum(_lib.recomputes.values()) == 0
    # with a mask a gradient goes through the plain version on the CPU
    o = flash_attention(qg, k, v, kv_len=torch.tensor([5]))
    assert o.grad_fn is not None and "FlashAttention" not in type(
        o.grad_fn).__name__
    torch.testing.assert_close(
        o, attention_plain(q, k, v, kv_len=torch.tensor([5])))


def test_flash_diff_bf16_and_partial_grads():
    """A bf16 call counts under the bf16 form; only the inputs that need a
    gradient get one."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 12, 16)).astype(
        np.float32)).bfloat16() for _ in range(3))
    v.requires_grad_()
    _lib.reset_counts()
    flash_attention(q, k, v, causal=True).float().sum().backward()
    assert _lib.recomputes["flash_attention_diff"] == 1
    vp = v.detach().clone().requires_grad_()
    attention_plain(q, k, vp, causal=True).float().sum().backward()
    assert v.grad.dtype == torch.bfloat16 and q.grad is None
    torch.testing.assert_close(v.grad, vp.grad, atol=0, rtol=0)


# ------------------------------- heads, loss -------------------------------

@pytest.mark.parametrize("deeper", [False, True])
def test_heads_match_flax(deeper):
    rng = np.random.default_rng(6)
    x = rng.normal(2.0, 3.0, size=(12, 16)).astype(np.float32)
    jh = j_heads.make_head(5, dropout_p=0.0, deeper=deeper, hidden_dim=8)
    state = jh.init(jax.random.key(1), jnp.zeros((2, 16)), train=False)
    # move the statistics off their init so eval mode reads real ones
    state = {"params": state["params"], "batch_stats": jax.tree.map(
        lambda a: a + 0.25, state["batch_stats"])}
    th = t_heads.make_head(16, 5, dropout_p=0.0, deeper=deeper,
                           hidden_dim=8)
    load_head_state(th, _np(state))
    th.eval()
    np.testing.assert_allclose(
        th(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jh.apply(state, x, train=False)), atol=1e-6, rtol=0)
    # one training step's forward: batch statistics, moved running ones
    logits, mut = jh.apply(state, x, train=True, mutable=["batch_stats"],
                           rngs={"dropout": jax.random.key(0)})
    th.train()
    got = th(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits),
                               atol=1e-6, rtol=0)
    want = head_state_to_state_dict({"params": state["params"],
                                     "batch_stats": _np(mut["batch_stats"])})
    for name in ("bn.running_mean", "bn.running_var"):
        np.testing.assert_allclose(th.state_dict()[name].numpy(),
                                   want[name].numpy(), atol=1e-6, rtol=0)
    # the running variance is the biased one (nn.BatchNorm1d's would not
    # match)
    var = x.var(axis=0, ddof=0)
    np.testing.assert_allclose(th.bn.running_var.numpy(),
                               0.9 * (np.asarray(state["batch_stats"]["bn"]
                                                 ["var"])) + 0.1 * var,
                               rtol=1e-5)


def test_dropout_only_in_training_and_seeded():
    th = t_heads.make_head(32, 3, dropout_p=0.5, seed=2)
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    th.eval()
    a = th(x)
    assert torch.equal(a, th(x))
    th.train()
    outs = [th(x, generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.allclose(outs[0], th(x, generator=torch.Generator()
                                          .manual_seed(8)))
    kept = t_heads.dropout(torch.ones(4000), 0.5, True,
                           torch.Generator().manual_seed(1))
    assert set(kept.unique().tolist()) == {0.0, 2.0}
    assert 0.45 < float((kept > 0).float().mean()) < 0.55
    assert torch.equal(t_heads.dropout(x, 0.5, False, None), x)


def test_masked_cross_entropy_matches_vlm_tpu():
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(10, 4)).astype(np.float32)
    y = np.array([0, 3, -1, 2, 2, 1, -1, 0, 3, 1])
    w = np.array([0.5, 2.0, 1.0, 0.25], np.float32)
    for cw in (None, w):
        want = float(j_utils.masked_cross_entropy(
            jnp.asarray(logits), jnp.asarray(y),
            None if cw is None else jnp.asarray(cw)))
        got = float(t_utils.masked_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(y),
            None if cw is None else torch.from_numpy(cw)))
        ref = float(F.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(y), ignore_index=-1,
            weight=None if cw is None else torch.from_numpy(cw)))
        assert abs(got - want) < 1e-6 and abs(got - ref) < 1e-6


def test_masked_cross_entropy_all_ignored_is_zero():
    logits = torch.randn(3, 4, requires_grad=True)
    y = torch.full((3,), -1)
    loss = t_utils.masked_cross_entropy(logits, y, torch.ones(4))
    assert float(loss.detach()) == 0.0
    assert float(j_utils.masked_cross_entropy(
        jnp.zeros((3, 4)), jnp.asarray(y.numpy()))) == 0.0
    assert torch.isnan(F.cross_entropy(logits, y, ignore_index=-1))
    loss.backward()
    assert torch.isfinite(logits.grad).all() and not logits.grad.any()


@pytest.mark.parametrize("task", ["gender", "emotion", "ethnicity", "age"])
def test_task_helpers_equal(task):
    assert t_utils.get_num_classes_for_task(task) == \
        j_utils.get_num_classes_for_task(task)
    targets = [{task: 1}, {task: None}, {}, {task: "x"}, {task: 0}]
    np.testing.assert_array_equal(
        t_utils.targets_to_arrays(targets, [task])[task],
        j_utils.targets_to_arrays(targets, [task])[task])
    counts = np.array([3, 0, 7, 1])
    np.testing.assert_array_equal(t_utils.counts_to_weights(counts),
                                  j_utils.counts_to_weights(counts))


# ------------------------------ the trainers ------------------------------

@pytest.fixture
def env(tmp_path, monkeypatch):
    """A project root with its task map and a 24-sample face dataset in
    every split; both frameworks' factories read it; the port on the
    CPU."""
    root = tmp_path / "root"
    (root / "configs").mkdir(parents=True)
    base = root / "datasets"
    rows = [{"gender": i % 2, "age": 5 + 7 * i, "ethnicity": i % 4,
             "emotion": i % 7} for i in range(24)]
    rows[3]["gender"] = ""                  # a missing label
    for split in ("train", "val", "test"):
        make_face_dataset(base, "TestDataset", split, rows)
    (root / "configs" / "task_datasets.yaml").write_text(yaml.safe_dump({
        s: {"gender": ["TestDataset"], "age": ["TestDataset"]}
        for s in ("train", "val", "test")}))
    monkeypatch.setenv("VLM_TPU_ROOT", str(root))
    monkeypatch.setenv("VLM_TPU_PLATFORM", "cpu")
    for factory in (JFactory, TFactory):
        factory.load_task_map(force=True)
    yield root, base
    monkeypatch.undo()
    for factory in (JFactory, TFactory):
        factory._task_datasets = None


def _cfg(base, e2e=False, parts="all", **train):
    cfg = {
        "model": {"name": "llava", "quantization": "fp32", "size": "test",
                  "dropout_p": 0.0, "deeper_head": False, "hidden_dim": 16,
                  "backbone": {"freeze": True,
                               "unfreeze_last_k": 1 if e2e else 0,
                               "unfreeze_parts": parts,
                               "include_embeddings": True}},
        "data": {"base_path": str(base), "batch_size": 8},
        "train": {"seed": 42, "epochs": 2, "lr": 1e-2, "backbone_lr": 1e-3,
                  "weight_decay": 1e-4, "patience": 4, "eval_every": 1,
                  "scheduler": {"factor": 0.1, "threshold": 1e-4}},
        "task": "gender", "_cfg_path": "test.yaml",
    }
    cfg["train"].update(train)
    return cfg


def _bridge(jtr, ttr):
    """Start the port's trainer from ``vlm_tpu``'s weights."""
    load_head_state(ttr.probe.classifier, _np(jtr.probe.head_state))
    load_flax_params(ttr.probe.backbone.module, _np(jtr.probe.backbone.params))


def _jax_grads(jtr, batch):
    """``vlm_tpu``'s step-1 gradients on ``batch``, as its train step takes
    them (head, and the backbone in the end-to-end mode)."""
    probe = jtr.probe
    clf, cw = probe.classifier, jtr.class_weights
    stats = probe.head_state["batch_stats"]

    def head_loss(head_params, feats, y):
        logits, _ = clf.apply({"params": head_params, "batch_stats": stats},
                              feats, train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.key(0)})
        return j_utils.masked_cross_entropy(logits, y, cw)

    if jtr.use_feature_cache:
        x, y = batch
        return {"head": jax.grad(head_loss)(probe.head_state["params"],
                                            jnp.asarray(x), jnp.asarray(y))}
    images, targets = batch
    y = jnp.asarray(j_utils.targets_to_arrays(targets, ["gender"])["gender"])
    pixels = probe.backbone._to_pixels(images)

    def loss(params):
        feats = probe.backbone._features(params["backbone"], pixels,
                                         probe.backbone.cfg.backbone_pooling)
        return head_loss(params["head"], feats, y)
    return jax.grad(loss)({"head": probe.head_state["params"],
                           "backbone": probe.backbone.params})


def _port_grads(ttr, batch):
    """The port's step-1 gradients (its head state restored after)."""
    saved = copy.deepcopy(ttr.probe.classifier.state_dict())
    ttr.optimizer.zero_grad(set_to_none=True)
    ttr.loss(batch, train=True).backward()
    grads = {n: p.grad.clone() for n, p in ttr.params.items()
             if p.grad is not None}
    ttr.optimizer.zero_grad(set_to_none=True)
    ttr.probe.classifier.load_state_dict(saved)
    return grads


def _port_named(jtree, prefix):
    """A flax gradient or parameter tree under the port's names."""
    from vlm_tpu_torch.testing.bridge import flax_to_state_dict
    return {f"{prefix}.{k}": v for k, v in
            flax_to_state_dict(_np(jtree)).items()}


@pytest.mark.parametrize("mode", ["cache", "e2e"])
def test_trainer_matches_vlm_tpu(env, tmp_path, mode):
    """End to end with the last block's attention and the embeddings
    unfrozen. With its MLP unfrozen too, the last fc2 bias has a zero
    gradient in exact arithmetic (a shift of every sample's features, which
    the training-mode BatchNorm removes): AdamW moves it by up to its lr a
    step on rounding noise, differently in each framework, and the
    eval-mode loss (running statistics) follows those shifts. That
    selection trains in ``test_resume_equals_a_straight_run`` and the CLI
    test."""
    root, base = env
    cfg = _cfg(base, e2e=mode == "e2e", parts="attn")
    jtr = JTrainer(copy.deepcopy(cfg), "run", tmp_path / "jax")
    ttr = TTrainer(copy.deepcopy(cfg), "run", tmp_path / "torch")
    assert jtr.use_feature_cache == ttr.use_feature_cache == (mode == "cache")
    _bridge(jtr, ttr)
    np.testing.assert_allclose(ttr.class_weights.numpy(),
                               np.asarray(jtr.class_weights), rtol=1e-7)

    # step-1 gradients on the first 8 training samples
    if mode == "cache":
        np.testing.assert_array_equal(ttr.train_loader.x, jtr.train_loader.x)
        x, y = ttr.train_loader.x[:8], ttr.train_loader.y[:8]
        tb, jb = Batch(x, y, kind="array"), (x, y)
    else:
        ds = ttr.train_loader.dataset
        images, targets = zip(*(ds[i] for i in range(8)))
        tb = Batch(list(images), list(targets))
        jb = (list(images), list(targets))
    want = _jax_grads(jtr, jb)
    want = {**_port_named(want["head"], "head"),
            **(_port_named(want["backbone"], "backbone")
               if "backbone" in want else {})}
    got = _port_grads(ttr, tb)
    assert set(got) <= set(want) and {
        n for n in ttr.params if n.startswith("head.")} <= set(got)
    if mode == "e2e":
        assert any(n.startswith("backbone.blocks.1.attn") for n in got)
        assert not any(n.startswith(("backbone.blocks.0.",
                                     "backbone.blocks.1.fc"))
                       for n in ttr.params)
    noise = set()
    for name, g in got.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
        if max(float(g.abs().max()), float(np.abs(ref).max())) < GRAD_ATOL:
            noise.add(name)
    # zero in exact arithmetic: the key bias (softmax ignores it) and the
    # post LN (mean pooling skips it)
    assert noise <= {"backbone.blocks.1.attn.k_proj.bias",
                     "backbone.post_ln.weight", "backbone.post_ln.bias"}

    p0 = {n: p.detach().clone() for n, p in ttr.params.items()}
    jtr.fit()
    ttr.fit()
    for key in ("train", "val"):
        np.testing.assert_allclose(ttr.history[key], jtr.history[key],
                                   rtol=1e-4, err_msg=key)
    jfinal = _port_named(jtr.probe.head_state["params"], "head")
    if mode == "e2e":
        jfinal.update(_port_named(jtr.probe.backbone.params, "backbone"))
    steps = ttr.last_stats["train_steps"]
    lrs = {n: g["lr"] for g in ttr.optimizer.param_groups
           for n, p in ttr.params.items() if any(p is q for q in g["params"])}
    for name, p in ttr.params.items():
        ref = jfinal[name].numpy()
        if name in noise:
            bound = lrs[name] * steps * 1.01
            assert float((p.detach() - p0[name]).abs().max()) <= bound
            assert float(np.abs(ref - p0[name].numpy()).max()) <= bound
            continue
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0,
                                   atol=0.1 * lrs[name], err_msg=name)
    # the BatchNorm's statistics followed too
    jstats = head_state_to_state_dict(_np(jtr.probe.head_state))
    for name in ("bn.running_mean", "bn.running_var"):
        np.testing.assert_allclose(
            ttr.probe.classifier.state_dict()[name].numpy(),
            jstats[name].numpy(), rtol=1e-4, atol=1e-5)
    files = {p.name for p in (tmp_path / "torch" / "run").iterdir()}
    assert {"model.safetensors", "training_state.safetensors",
            "training_state.yaml", "head_config.yaml", "history.csv",
            "loss_curve.png"} <= files


def test_vlm_tpu_feature_cache_loads(env, tmp_path):
    """The npz ``vlm_tpu`` wrote is read as it is (nothing extracted); the
    reference's other key names load; a cache of another width raises."""
    root, base = env
    cfg = _cfg(base)
    jtr = JTrainer(copy.deepcopy(cfg), "run", tmp_path / "jax")
    ttr = TTrainer(copy.deepcopy(cfg), "run", tmp_path / "torch")
    assert ttr.features_dir == jtr.features_dir
    assert ttr.extract_stats["images"] == 0
    blob = np.load(ttr.features_dir / "train_features.npz")
    np.testing.assert_array_equal(ttr.train_loader.x, blob["x"])
    np.testing.assert_array_equal(ttr.train_loader.y, blob["y"])
    np.testing.assert_array_equal(ttr.val_loader.x, jtr.val_loader.x)
    # the reference's key names
    np.savez(ttr.features_dir / "train_features.npz",
             features=blob["x"][:5], labels=blob["y"][:5])
    again = TTrainer(copy.deepcopy(cfg), "run2", tmp_path / "torch")
    assert len(again.train_loader.x) == 5
    np.savez(ttr.features_dir / "train_features.npz",
             feats=np.zeros((4, 3), np.float32), y=np.zeros(4))
    with pytest.raises(ValueError, match="stale feature cache"):
        TTrainer(copy.deepcopy(cfg), "run3", tmp_path / "torch")


def test_port_extracts_its_own_cache(env, tmp_path):
    """Without a cache the port extracts one (and an augmented dataset
    through ``__getitem__``) and writes the npz ``vlm_tpu`` reads."""
    root, base = env
    cfg = _cfg(base)
    cfg["data"]["use_augmentation"] = True
    ttr = TTrainer(copy.deepcopy(cfg), "run", tmp_path / "torch")
    assert ttr.extract_stats["images"] == 48
    blob = np.load(ttr.features_dir / "train_features.npz")
    assert blob["x"].shape == (24, ttr.probe.backbone.output_dim)
    assert blob["y"].tolist()[:4] == [0, 1, 0, -1]
    assert ttr.probe.fully_frozen


@pytest.mark.parametrize("mode", ["cache", "e2e"])
def test_resume_equals_a_straight_run(env, tmp_path, mode):
    root, base = env
    straight = TTrainer(_cfg(base, e2e=mode == "e2e"), "run",
                        tmp_path / "a")
    straight.fit()
    first = TTrainer(_cfg(base, e2e=mode == "e2e", epochs=1), "run",
                     tmp_path / "b")
    first.fit()
    resumed = TTrainer(_cfg(base, e2e=mode == "e2e"), "run", tmp_path / "b")
    resumed.fit()
    assert resumed.history["train"] == straight.history["train"][1:]
    assert resumed.history["val"] == straight.history["val"][1:]
    for name, p in straight.params.items():
        assert torch.equal(p, resumed.params[name]), name
    for name, t in straight.probe.classifier.state_dict().items():
        assert torch.equal(t, resumed.probe.classifier.state_dict()[name])
    state = yaml.safe_load((tmp_path / "b" / "run" /
                            "training_state.yaml").read_text())
    assert state["epoch"] == 2 and state["meta"]["task"] == "gender"


def test_plateau_rescales_lr_in_place(env, tmp_path):
    root, base = env
    ttr = TTrainer(_cfg(base, e2e=True), "run", tmp_path / "t")
    opt_id = id(ttr.optimizer)
    ttr.lr_scale = 0.1
    ttr.on_lr_change()
    assert id(ttr.optimizer) == opt_id
    assert [g["lr"] for g in ttr.optimizer.param_groups] == pytest.approx(
        [1e-3, 1e-4])
    ttr._sched_best = 1.0
    for _ in range(ttr.sched_patience + 1):
        ttr._scheduler_step(2.0)
    assert ttr.lr_scale == pytest.approx(0.01)


def test_tester_preds_equal_vlm_tpu(env, tmp_path):
    """``vlm_tpu``'s trainer and tester, then the port's tester on a port
    checkpoint of the same head and tower: identical preds."""
    root, base = env
    cfg = _cfg(base, epochs=1)
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
    from vlm_tpu_torch.testing.bridge import flax_to_state_dict
    blob.update({f"backbone.{k}": v for k, v in flax_to_state_dict(
        _np(jtr.probe.backbone.params)).items()})
    t_utils.save_tensors(port / "model.safetensors", blob)
    tester = TTester(dict(test_cfg, eval={"ckpt_from": str(port),
                                          "dataset_name": "auto"}))
    tester.run()
    assert json.loads((out / "preds.json").read_text()) == want
    assert json.loads((out / "metrics.json").read_text()) == want_metrics
    assert tester.model.backbone.fully_frozen

    (port / "model.msgpack").write_bytes(b"")
    with pytest.raises(ValueError, match="msgpack"):
        TTester(dict(test_cfg, eval={"ckpt_from": str(port)}))


# --------------------------------- the CLIs ---------------------------------

def _write_cli_configs(root, base, **model):
    train = yaml.safe_load((REPO / "configs" / "train_probe.yaml")
                           .read_text())
    train["common"]["model"].update(size="test", **model)
    train["common"]["data"].update(base_path=str(base), batch_size=8)
    train["common"]["train"]["epochs"] = 2
    test = yaml.safe_load((REPO / "configs" / "test_probe.yaml").read_text())
    test["common"]["data"]["base_path"] = str(base)
    paths = root / "train.yaml", root / "test.yaml"
    for p, c in zip(paths, (train, test)):
        p.write_text(yaml.safe_dump(c))
    return paths


@pytest.mark.parametrize("e2e", [False, True])
def test_clis_train_then_test(env, e2e):
    root, base = env
    backbone = {"backbone": {"freeze": True, "unfreeze_last_k": 1}} \
        if e2e else {}
    train_yaml, test_yaml = _write_cli_configs(root, base, **backbone)
    trainer = t_train_cli.main(["--config", str(train_yaml)])
    assert trainer.run_name == "llava_fp32_age_linear"
    assert trainer.use_feature_cache == (not e2e)
    ckpt = root / "probing" / "linear_probing" / "checkpoints" / \
        trainer.run_name
    hist = (ckpt / "history.csv").read_text().splitlines()
    assert hist[0] == "epoch,train_loss,val_loss" and len(hist) == 3
    with Image.open(ckpt / "loss_curve.png") as im:
        assert im.size == (750, 450)
    saved = t_utils.load_tensors(ckpt / "model.safetensors")
    assert any(k.startswith("backbone.blocks.1.") for k in saved) == e2e
    tester = t_test_cli.main(["--config", str(test_yaml)])
    out = root / "probing" / "linear_probing" / "eval" / \
        "llava_fp32_linear" / "age" / "TestDataset"
    preds = json.loads((out / "preds.json").read_text())
    assert len(preds) == 24
    assert "average_accuracy" in json.loads((out / "metrics.json")
                                            .read_text())
    # preds are the probe's argmax on the test images
    ds = TFactory.create_dataset("TestDataset", split="test",
                                 base_path=str(base))
    images = [ds[i][0] for i in range(len(ds))]
    direct = tester.model.predict(images).tolist()
    assert [p["age"] for p in preds] == direct


def test_clis_refuse_what_is_not_ported(env):
    """What the port still refuses through the CLIs: a mesh of more than
    one device (ROADMAP A17) in either profile and either CLI, and LoRA on
    a quantized tower (as ``vlm_tpu``: no float weight to adapt). The
    multi-task profile and LoRA run (``tests/test_torch_multitask.py``,
    ``tests/test_torch_lora.py``)."""
    root, base = env
    train_yaml, test_yaml = _write_cli_configs(root, base)
    for path in (train_yaml, test_yaml):
        mesh = yaml.safe_load(path.read_text())
        mesh["common"]["mesh"] = {"data": 2, "model": 1}
        path.write_text(yaml.safe_dump(mesh))
    for profile in ("single", "multi"):
        with pytest.raises(ValueError):
            t_train_cli.main(["--config", str(train_yaml), "--profile",
                              profile])
        with pytest.raises(ValueError):
            t_test_cli.main(["--config", str(test_yaml), "--profile",
                             profile])
    lora_yaml, _ = _write_cli_configs(root, base, quantization="8bit",
                                      quantize_vision=True,
                                      lora={"enabled": True})
    with pytest.raises(ValueError, match="quantized vision tower"):
        t_train_cli.main(["--config", str(lora_yaml)])


# ------------------------- the copied helpers -------------------------

def test_profile_configs_equal():
    raw = yaml.safe_load((REPO / "configs" / "train_probe.yaml").read_text())
    for profile in ("single", "multi"):
        got = t_config.build_cfg_from_profile(copy.deepcopy(raw), profile,
                                              "x.yaml")
        want = j_config.build_cfg_from_profile(copy.deepcopy(raw), profile,
                                               "x.yaml")
        assert got == want
        assert t_config.make_run_name(got, profile) == \
            j_config.make_run_name(want, profile)
    test_raw = yaml.safe_load((REPO / "configs" / "test_probe.yaml")
                              .read_text())
    assert t_config.build_cfg_from_profile(
        copy.deepcopy(test_raw), "single", "t.yaml", require_eval=True) == \
        j_config.build_cfg_from_profile(copy.deepcopy(test_raw), "single",
                                        "t.yaml", require_eval=True)
    for bad in ({}, {"single": {}}):
        with pytest.raises(ValueError):
            t_config.build_cfg_from_profile(bad, "single", "x")
        with pytest.raises(ValueError):
            j_config.build_cfg_from_profile(bad, "single", "x")


def test_augmentation_equal():
    img = Image.fromarray(np.random.default_rng(8).integers(
        0, 256, (40, 30, 3), dtype=np.uint8))
    tj, tt = j_augment.train_augmentation(3), t_augment.train_augmentation(3)
    for _ in range(4):
        assert np.array_equal(np.asarray(tt(img)), np.asarray(tj(img)))


def test_multi_task_dataset_equal(env):
    root, base = env
    got, gc = TFactory.create_multi_task_dataset(
        ["gender", "age"], split="train", base_path=str(base),
        num_classes={"gender": 2, "age": 9})
    want, wc = JFactory.create_multi_task_dataset(
        ["gender", "age"], split="train", base_path=str(base),
        num_classes={"gender": 2, "age": 9})
    assert len(got) == len(want) == 24
    assert got.dataset_names == want.dataset_names
    for task in ("gender", "age"):
        np.testing.assert_array_equal(got.get_all_labels(task),
                                      want.get_all_labels(task))
        np.testing.assert_array_equal(gc[task], wc[task])
    assert got.labels_list() == want.labels_list()
    assert [str(p) for p in got.image_paths()] == \
        [str(p) for p in want.image_paths()]
    with pytest.raises(ValueError, match="Unsupported tasks"):
        TFactory.create_multi_task_dataset(["emotion"], split="train",
                                           base_path=str(base))


def test_synthetic_face_dataset_equal(tmp_path):
    """The port's dataset builder (``chip_smoke.py``'s) writes ``vlm_tpu``'s
    files at the default size."""
    from vlm_tpu.testing.synthetic import make_face_dataset as j_make
    from vlm_tpu_torch.testing.synthetic import make_face_dataset as t_make
    rows = [{"gender": 1, "age": 30, "identity": "a"}, {"emotion": 2}]
    dj = j_make(tmp_path / "j", "TestDataset", "test", rows)
    dt = t_make(tmp_path / "t", "TestDataset", "test", rows)
    assert (dj / "labels.csv").read_text() == (dt / "labels.csv").read_text()
    for name in ("img_0000.jpg", "img_0001.jpg"):
        assert (dj / "images" / name).read_bytes() == \
            (dt / "images" / name).read_bytes()
    big = t_make(tmp_path / "b", "TestDataset", "test", rows, size=(336, 336))
    with Image.open(big / "images" / "img_0000.jpg") as im:
        assert im.size == (336, 336)
