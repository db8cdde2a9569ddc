"""The port's multi-task probing (``vlm_tpu_torch/probing``) against
``vlm_tpu``'s on the CPU, at the "test" size in fp32, from the same inputs
(numpy seeds) and the same weights (heads, tower, LoRA adapters and
log-variances bridged from the flax trees), dropout 0:

- held exactly: the weighted sampler's weights and indices, the balanced
  dataset's extended index and counts, ``RunningMeans``' values, history
  and JSON round trip;
- held at 1e-6: ``UncertaintyWeighter.combine``;
- ``MultiTaskTrainer`` (sampler and augmentation on; frozen, with the
  multi profile's backbone block, with LoRA, with uncertainty weighting):
  step-1 gradients within rtol 1e-4 and atol 1e-6, epoch losses within
  1e-4 relative, the epoch-2 task weights within 1e-6, parameters after
  the run within 0.1 x lr (a parameter whose step-1 gradient is rounding
  noise is held to |p - p0| <= lr x steps on both sides, as in
  ``tests/test_torch_probing.py``). With the profile's block the whole
  "test" tower trains, the last fc2 bias among it: its gradient is zero in
  exact arithmetic (a shift of every feature, which the heads'
  training-mode BatchNorm removes), so it takes AdamW steps on rounding
  noise, differently in each framework. The heads' running means record
  that shift: they are held to 2 x lr x steps, and the eval-mode val loss
  is held at 1e-4 with ``vlm_tpu``'s values of those two;
- the tester's preds identical to ``vlm_tpu``'s; a run stopped after
  epoch 1 and resumed equals a straight one; the CLIs train then test
  with ``--profile multi``.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax.core import meta

from tests.conftest import make_face_dataset
from vlm_tpu.data.dataset_factory import DatasetFactory as JFactory
from vlm_tpu.data.multitask_dataset import \
    BalancedMultiTaskDataset as JBalanced
from vlm_tpu.probing.lora import features_with_lora
from vlm_tpu.probing.test.multitask_tester import \
    MultiTaskTester as JTester
from vlm_tpu.probing.train import losses as j_losses
from vlm_tpu.probing.train import utils as j_utils
from vlm_tpu.probing.train.multitask_trainer import \
    MultiTaskTrainer as JTrainer
from vlm_tpu_torch.data.dataset_factory import DatasetFactory as TFactory
from vlm_tpu_torch.data.multitask_dataset import \
    BalancedMultiTaskDataset as TBalanced
from vlm_tpu_torch.probing.test.multitask_tester import \
    MultiTaskTester as TTester
from vlm_tpu_torch.probing.train import losses as t_losses
from vlm_tpu_torch.probing.train import utils as t_utils
from vlm_tpu_torch.probing.train.data import Batch, ImageBatchLoader
from vlm_tpu_torch.probing.train.multitask_trainer import \
    MultiTaskTrainer as TTrainer
from vlm_tpu_torch.scripts import test_probe as t_test_cli
from vlm_tpu_torch.scripts import train_probe as t_train_cli
from vlm_tpu_torch.testing.bridge import (flax_to_state_dict,
                                          head_state_to_state_dict,
                                          load_flax_params, load_log_vars,
                                          load_lora, load_multitask_heads,
                                          lora_name)

REPO = __import__("pathlib").Path(__file__).resolve().parents[1]
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
TASKS = ["age", "gender", "emotion"]


def _np(tree):
    return jax.tree.map(np.asarray, meta.unbox(tree))


def _rows(n, emotion_every):
    """Face rows with gender and age on every row, emotion on every
    ``emotion_every``-th (1: all)."""
    rows = [{"gender": i % 2, "age": 4 + 11 * (i % 8), "ethnicity": i % 4,
             "emotion": (3 * i) % 7 if i % emotion_every == 0 else ""}
            for i in range(n)]
    rows[3]["gender"] = ""                  # a missing label
    return rows


@pytest.fixture
def env(tmp_path, monkeypatch):
    """A project root mapping age, gender and emotion to a face dataset:
    24 train rows with emotion on 5 (the 0.33 balancing duplicates 4),
    16 val and 12 test rows with every label; the port on the CPU."""
    root = tmp_path / "root"
    (root / "configs").mkdir(parents=True)
    base = root / "datasets"
    for split, n, every in (("train", 24, 5), ("val", 16, 1),
                            ("test", 12, 1)):
        make_face_dataset(base, "TestDataset", split, _rows(n, every))
    (root / "configs" / "task_datasets.yaml").write_text(yaml.safe_dump({
        s: {t: ["TestDataset"] for t in TASKS}
        for s in ("train", "val", "test")}))
    monkeypatch.setenv("VLM_TPU_ROOT", str(root))
    monkeypatch.setenv("VLM_TPU_PLATFORM", "cpu")
    for factory in (JFactory, TFactory):
        factory.load_task_map(force=True)
    # the train split's class counts: the class weights and the sampler's
    train, _ = TFactory.create_multi_task_dataset(TASKS, split="train",
                                                  base_path=str(base))
    counts = {}
    for t in TASKS:
        y = train.get_all_labels(t)
        cls, n = np.unique(y[y >= 0], return_counts=True)
        counts[t] = {str(c): int(k) for c, k in zip(cls, n)}
    (base / "TestDataset" / "train" / "class_counts.json").write_text(
        json.dumps(counts))
    yield root, base
    monkeypatch.undo()
    for factory in (JFactory, TFactory):
        factory._task_datasets = None


PROFILE_BACKBONE = yaml.safe_load((REPO / "configs" / "train_probe.yaml")
                                  .read_text())["multi"]["model"]["backbone"]


def _cfg(base, mode="frozen", **train):
    backbone = {"freeze": True, "unfreeze_last_k": 0}
    if mode == "unfrozen":
        backbone = dict(PROFILE_BACKBONE)
    cfg = {
        "model": {"name": "llava", "quantization": "fp32", "size": "test",
                  "dropout_p": 0.0, "deeper_head": False, "hidden_dim": 16,
                  "backbone": backbone,
                  "lora": {"enabled": mode == "lora", "rank": 4,
                           "alpha": 8.0, "last_k": 1, "attn_only": True}},
        "data": {"base_path": str(base), "batch_size": 8,
                 "use_augmentation": True, "use_sampler": True},
        "train": {"seed": 42, "epochs": 2, "lr": 1e-2, "backbone_lr": 1e-3,
                  "weight_decay": 1e-4, "patience": 4, "eval_every": 1,
                  "scheduler": {"factor": 0.1, "threshold": 1e-4},
                  "running_means": {"enabled": True, "alpha": 0.95},
                  "task_weights": {"age": 1.0, "gender": 1.0,
                                   "emotion": 1.0},
                  "uncertainty_weighting": {"enabled": mode == "uw",
                                            "init_log_var": 0.25}},
        "tasks": list(TASKS), "_cfg_path": "test.yaml",
    }
    cfg["train"].update(train)
    return cfg


def _bridge(jtr, ttr):
    """Start the port's trainer from ``vlm_tpu``'s weights."""
    load_multitask_heads(ttr.probe, _np(jtr.probe.head_state))
    load_flax_params(ttr.probe.backbone.module, _np(jtr.probe.backbone.params))
    if jtr.lora_spec:
        load_lora(ttr.lora, _np(jtr.lora_params))
    if jtr.use_uw:
        load_log_vars(ttr.log_vars, _np(jtr._log_vars))


def _port_named(jparams):
    """``vlm_tpu``'s params (or gradients) tree under the port's names."""
    out = {}
    for t, tree in jparams["heads"].items():
        out.update({f"heads.{t}.{k}": v for k, v in
                    flax_to_state_dict(_np(tree)).items()})
    out.update({f"backbone.{k}": v for k, v in
                flax_to_state_dict(_np(jparams["backbone"])).items()})
    for n, ab in (jparams.get("lora") or {}).items():
        for k in ("A", "B"):
            out[f"lora.{lora_name(n)}.{k}"] = torch.tensor(np.asarray(ab[k]))
    for t, v in (jparams.get("log_vars") or {}).items():
        out[f"log_vars.{t}"] = torch.tensor(np.asarray(v))
    return out


def _jax_grads(jtr, images, targets):
    """``vlm_tpu``'s step-1 gradients, as its train step takes them."""
    probe = jtr.probe
    feats_fn = features_with_lora(probe.backbone,
                                  probe.backbone.cfg.backbone_pooling,
                                  jtr.lora_spec)
    ys = {t: jnp.asarray(v) for t, v in
          j_utils.targets_to_arrays(targets, jtr.tasks).items()}
    pixels = probe.backbone._to_pixels(images)
    stats = {t: s["batch_stats"] for t, s in probe.head_state.items()}
    task_w = jtr._compute_task_weights()

    def total(params):
        feats = feats_fn(params, pixels)
        losses = {}
        for t in jtr.tasks:
            logits, _ = probe.classifiers[t].apply(
                {"params": params["heads"][t], "batch_stats": stats[t]},
                feats, train=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.key(0)})
            losses[t] = j_utils.masked_cross_entropy(logits, ys[t],
                                                     jtr.ce_weights[t])
        if jtr.use_uw:
            return j_losses.UncertaintyWeighter.combine(params["log_vars"],
                                                        losses)
        return sum(task_w[t] * losses[t] for t in jtr.tasks)
    return jax.grad(total)(jtr._params())


def _port_grads(ttr, batch):
    """The port's step-1 gradients (its heads' state restored after)."""
    saved = {t: copy.deepcopy(c.state_dict())
             for t, c in ttr.probe.classifiers.items()}
    ttr.current_task_weights = ttr._compute_task_weights()
    ttr.optimizer.zero_grad(set_to_none=True)
    ttr.total_loss(ttr.losses(batch, train=True)).backward()
    grads = {n: p.grad.clone() for n, p in ttr.params.items()
             if p.grad is not None}
    ttr.optimizer.zero_grad(set_to_none=True)
    for t, c in ttr.probe.classifiers.items():
        c.load_state_dict(saved[t])
    return grads


# --------------------------- data and weights ---------------------------

def test_balanced_dataset_and_sampler_equal(env):
    root, base = env
    n_classes = {t: t_utils.get_num_classes_for_task(t) for t in TASKS}
    kw = dict(tasks=TASKS, split="train", base_path=str(base),
              num_classes=n_classes, desired_fractions={"emotion": 0.33},
              random_seed=42)
    got, gc = TFactory.create_balanced_multi_task_dataset(**kw)
    want, wc = JFactory.create_balanced_multi_task_dataset(**kw)
    # 5 of 24 with emotion: round((0.33 * 24 - 5) / 0.67) = 4 duplicates
    assert len(got) == len(want) == 28
    assert got.extended_index() == want.extended_index()
    assert sum(d for _, d in got.extended_index()) == 4
    for t in TASKS:
        np.testing.assert_array_equal(gc[t], wc[t])       # the base counts
        np.testing.assert_array_equal(got.get_all_labels(t),
                                      want.get_all_labels(t))
    assert got.labels_list() == want.labels_list()
    assert [str(p) for p in got.image_paths()] == \
        [str(p) for p in want.image_paths()]
    cw = {t: t_utils.counts_to_weights(np.asarray(gc[t], np.float64))
          .astype(np.float32) for t in TASKS}
    for combine in ("mean", "max"):
        ts, tw = t_utils.build_weighted_sampler(got, cw, combine=combine,
                                                seed=42)
        js, jw = j_utils.build_weighted_sampler(want, cw, combine=combine,
                                                seed=42)
        np.testing.assert_array_equal(tw, jw)
        for _ in range(3):
            assert list(ts) == list(js)
        assert len(ts) == len(js) == 28
    np.testing.assert_array_equal(
        t_utils.build_per_sample_weights(got, TASKS, gc),
        j_utils.build_per_sample_weights(want, TASKS, wc))
    # a dataset without get_all_labels: each sample's label dict
    samples = [(None, {"emotion": 2}), (None, {}), (None, {"emotion": 6})]
    for t in ("emotion", "age"):
        np.testing.assert_array_equal(t_utils._labels_for(samples, t),
                                      j_utils._labels_for(samples, t))
    # a duplicate transform on the duplicates only, and a bad fraction
    base_ds, _ = TFactory.create_multi_task_dataset(TASKS, split="train",
                                                    base_path=str(base))
    marked = TBalanced(base_ds, tasks=TASKS,
                       desired_fractions={"emotion": 0.33},
                       duplicate_transform=lambda img: "dup", random_seed=42)
    for i, (_, dup) in enumerate(marked.extended_index()):
        assert (marked[i][0] == "dup") == dup
    for bad in (0.0, 1.0):
        for cls in (TBalanced, JBalanced):
            with pytest.raises(ValueError, match="must be in"):
                cls(base_ds, tasks=TASKS, desired_fractions={"emotion": bad})


def test_loader_takes_the_samplers_draws(env):
    root, base = env
    ds, _ = TFactory.create_multi_task_dataset(TASKS, split="val",
                                               base_path=str(base))
    sampler = t_utils.WeightedSampler(np.arange(1, 17), 20, seed=3)
    loader = ImageBatchLoader(ds, 8, sampler=sampler, prefetch=0)
    assert len(loader) == 3
    want = t_utils.WeightedSampler(np.arange(1, 17), 20, seed=3)
    first, second = list(want), list(want)
    labels = ds.labels_list()
    got = [t for b in loader for t in b.targets]
    assert got == [labels[i] for i in first]
    # a resumed loader skips the first epoch's draw
    again = ImageBatchLoader(
        ds, 8, sampler=t_utils.WeightedSampler(np.arange(1, 17), 20, seed=3),
        prefetch=0)
    again.skip_epochs(1)
    assert [t for b in again for t in b.targets] == \
        [labels[i] for i in second]


def test_running_means_equal(tmp_path):
    tr, jr = t_losses.RunningMeans(TASKS, 0.9), j_losses.RunningMeans(TASKS,
                                                                      0.9)
    rng = np.random.default_rng(1)
    for step in range(6):
        vals = rng.uniform(0.5, 3.0, 3).tolist()
        for r in (tr, jr):
            if step % 2:
                r.update(vals)
            else:
                r.update_by_idx(vals[0], 0)
    assert tr.values == jr.values and tr.history == jr.history
    assert tr.get("gender") == jr.get("gender")
    assert tr.get_by_index(2) == jr.get_by_index(2)
    tr.save_history(tmp_path / "t.json")
    jr.save_history(tmp_path / "j.json")
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    back = t_losses.RunningMeans(TASKS, 0.9)
    back.load_history(tmp_path / "j.json")
    assert back.values == tr.values and back.history == tr.history
    tr.plot(tmp_path / "ema.png")
    from PIL import Image
    with Image.open(tmp_path / "ema.png") as im:
        assert im.size == (1000, 600)


def test_uncertainty_weighter_equal():
    rng = np.random.default_rng(2)
    losses = {t: rng.uniform(0.1, 2.0, 5).astype(np.float32) for t in TASKS}
    logv = {t: np.float32(v) for t, v in zip(TASKS, (0.3, -0.2, 1.1))}
    want = float(j_losses.UncertaintyWeighter.combine(
        {t: jnp.asarray(v) for t, v in logv.items()},
        {t: jnp.asarray(v) for t, v in losses.items()}))
    uw = t_losses.UncertaintyWeighter(TASKS, 0.5)
    params = uw.init_params()
    assert all(float(p.detach()) == 0.5 and p.requires_grad
               for p in params.values())
    with torch.no_grad():
        for t, p in params.items():
            p.fill_(float(logv[t]))
    got = t_losses.UncertaintyWeighter.combine(
        params, {t: torch.from_numpy(v) for t, v in losses.items()})
    assert abs(float(got.detach()) - want) < 1e-6
    got.backward()
    assert all(p.grad is not None for p in params.values())
    wj = j_losses.UncertaintyWeighter.current_weights(logv)
    wt = t_losses.UncertaintyWeighter.current_weights(params)
    for t in TASKS:
        assert abs(wj[t] - wt[t]) < 1e-6


# ------------------------------ the trainer ------------------------------

@pytest.mark.parametrize("mode", ["frozen", "unfrozen", "lora", "uw"])
def test_trainer_matches_vlm_tpu(env, tmp_path, mode):
    root, base = env
    cfg = _cfg(base, mode)
    jtr = JTrainer(copy.deepcopy(cfg), "run", tmp_path / "jax")
    ttr = TTrainer(copy.deepcopy(cfg), "run", tmp_path / "torch")
    _bridge(jtr, ttr)
    for t in TASKS:
        np.testing.assert_allclose(ttr.class_weights[t].numpy(),
                                   np.asarray(jtr.class_weights[t]),
                                   rtol=1e-7)
        assert ttr.ce_weights[t] is None and jtr.ce_weights[t] is None
    np.testing.assert_array_equal(ttr.train_loader.sampler.weights,
                                  jtr.train_loader.sampler.weights)
    tds, jds = ttr.train_loader.dataset, jtr.train_loader.dataset
    assert tds.extended_index() == jds.extended_index() and len(tds) == 28

    # step-1 gradients on the first 8 (augmented) training samples; both
    # augmentations draw for the same samples, so fit starts level
    timgs, ttgts = zip(*(tds[i] for i in range(8)))
    jimgs, jtgts = zip(*(jds[i] for i in range(8)))
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(timgs, jimgs))
    want = _port_named(_jax_grads(jtr, list(jimgs), list(jtgts)))
    got = _port_grads(ttr, Batch(list(timgs), list(ttgts)))
    assert set(got) <= set(want)
    assert {n for n in ttr.params
            if n.startswith(("heads.", "log_vars.", "lora."))} <= set(got)
    backbone = {n for n in ttr.params if n.startswith("backbone.")}
    assert bool(backbone) == (mode == "unfrozen")
    noise = set()
    for name, g in got.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
        if max(float(g.abs().max()), float(np.abs(ref).max())) < GRAD_ATOL:
            noise.add(name)
    if mode == "lora":
        # B starts at zero: A's first gradient is zero, B's is not
        assert all(not got[n].any() for n in got if n.endswith(".A"))
        assert all(got[n].abs().max() > 1e-4 for n in got
                   if n.endswith(".B"))
    # zero in exact arithmetic: the key bias (softmax ignores it), the post
    # LN (mean pooling skips it) and the last fc2 bias (a shift the heads'
    # training-mode BatchNorm removes); LoRA's A at step 1
    assert {n for n in noise if not n.endswith(".A")} <= {
        "backbone.blocks.0.attn.k_proj.bias",
        "backbone.blocks.1.attn.k_proj.bias", "backbone.post_ln.weight",
        "backbone.post_ln.bias", "backbone.blocks.1.fc2.bias"}

    p0 = {n: p.detach().clone() for n, p in ttr.params.items()}
    jtr.fit()
    ttr.fit()
    np.testing.assert_allclose(ttr.history["train"], jtr.history["train"],
                               rtol=1e-4)
    if mode != "unfrozen":
        np.testing.assert_allclose(ttr.history["val"], jtr.history["val"],
                                   rtol=1e-4)
    # epoch 2 ran on the EMA's task weights (or the log-variances)
    for t in TASKS:
        assert abs(ttr.current_task_weights[t] -
                   jtr.current_task_weights[t]) < 1e-6
        np.testing.assert_allclose(ttr.rm.history[t], jtr.rm.history[t],
                                   rtol=1e-4)
    if mode != "uw":
        w = ttr.current_task_weights
        assert abs(sum(w.values()) / 3 - 1.0) < 1e-9 and \
            max(w.values()) - min(w.values()) > 1e-3

    jfinal = _port_named(jtr._params())
    steps = ttr.last_stats["train_steps"]
    assert steps == 2 * 4
    lrs = {n: g["lr"] for g in ttr.optimizer.param_groups
           for n, p in ttr.params.items() if any(p is q for q in g["params"])}
    for name, p in ttr.params.items():
        ref = jfinal[name].numpy()
        if name in noise and not name.endswith(".A"):
            bound = lrs[name] * steps * 1.01
            assert float((p.detach() - p0[name]).abs().max()) <= bound
            assert float(np.abs(ref - p0[name].numpy()).max()) <= bound
            continue
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0,
                                   atol=0.1 * lrs[name], err_msg=name)
    # the heads' statistics followed too; with the whole tower trained, the
    # last fc2 bias takes AdamW steps on rounding noise, in each framework
    # its own way (up to its lr a step): it shifts every feature, which the
    # training-mode BatchNorm removes (the train losses above) but the
    # running means record, so they are held to that bound, 2 x lr x steps
    shift = 2 * lrs.get("backbone.blocks.1.fc2.bias", 0.0) * steps
    for t in TASKS:
        jstats = head_state_to_state_dict(_np(jtr.probe.head_state[t]))
        for name, atol in (("bn.running_mean", 1e-5 + shift),
                           ("bn.running_var", 1e-5)):
            np.testing.assert_allclose(
                ttr.probe.classifiers[t].state_dict()[name].numpy(),
                jstats[name].numpy(), rtol=1e-4, atol=atol)
    if mode == "unfrozen":
        # the eval mode reads those running means: the val loss is held
        # with vlm_tpu's values of the noise parameters and running means,
        # both held to their bounds above
        with torch.no_grad():
            for name in noise:
                ttr.params[name].copy_(jfinal[name])
            for t in TASKS:
                ttr.probe.classifiers[t].bn.running_mean.copy_(
                    head_state_to_state_dict(_np(jtr.probe.head_state[t]))
                    ["bn.running_mean"])
        val = ttr._run_epoch(1, 2, train=False)
        assert abs(val - jtr.history["val"][-1]) <= \
            1e-4 * abs(jtr.history["val"][-1])
    saved = t_utils.load_tensors(tmp_path / "torch" / "run" /
                                 "model.safetensors")
    assert any(k.startswith("backbone.") for k in saved) == \
        (mode == "unfrozen")
    assert any(k.startswith("lora.") for k in saved) == (mode == "lora")
    extra = json.loads((tmp_path / "torch" / "run" /
                        "extra_state.json").read_text())
    assert set(extra["running_means"]["values"]) == set(TASKS)
    assert ("uw_log_vars" in extra) == (mode == "uw")
    assert (tmp_path / "torch" / "run" / "EMA_history.json").exists()


@pytest.mark.parametrize("mode", ["unfrozen", "lora", "uw"])
def test_resume_equals_a_straight_run(env, tmp_path, mode):
    root, base = env
    straight = TTrainer(_cfg(base, mode), "run", tmp_path / "a")
    straight.fit()
    first = TTrainer(_cfg(base, mode, epochs=1), "run", tmp_path / "b")
    first.fit()
    resumed = TTrainer(_cfg(base, mode), "run", tmp_path / "b")
    resumed.fit()
    assert resumed.history["train"] == straight.history["train"][1:]
    assert resumed.history["val"] == straight.history["val"][1:]
    assert resumed.current_task_weights == straight.current_task_weights
    assert resumed.rm.history == straight.rm.history
    for name, p in straight.params.items():
        assert torch.equal(p, resumed.params[name]), name
    for t, clf in straight.probe.classifiers.items():
        for name, v in clf.state_dict().items():
            assert torch.equal(
                v, resumed.probe.classifiers[t].state_dict()[name])
    state = yaml.safe_load((tmp_path / "b" / "run" /
                            "training_state.yaml").read_text())
    assert state["epoch"] == 2 and state["meta"]["trainer"] == "multi_task"


def test_plateau_rescales_every_group_in_place(env, tmp_path):
    root, base = env
    ttr = TTrainer(_cfg(base, "unfrozen", uncertainty_weighting={
        "enabled": True}), "run", tmp_path / "t")
    opt_id = id(ttr.optimizer)
    ttr.lr_scale = 0.1
    ttr.on_lr_change()
    assert id(ttr.optimizer) == opt_id
    assert [g["lr"] for g in ttr.optimizer.param_groups] == pytest.approx(
        [1e-3, 1e-4])
    assert all(g["weight_decay"] == 1e-4 for g in ttr.optimizer.param_groups)
    # the log-variances train with the heads
    head = ttr.optimizer.param_groups[0]["params"]
    assert all(any(v is p for p in head) for v in ttr.log_vars.values())


# ------------------------------ the testers ------------------------------

def test_tester_preds_equal_vlm_tpu(env, tmp_path):
    """``vlm_tpu``'s trainer (LoRA on) and tester, then the port's tester on
    a port checkpoint of the same heads, tower and adapters: identical
    preds and metrics for every task."""
    root, base = env
    cfg = _cfg(base, "lora", epochs=1)
    ckpt = root / "probing" / "multitask_probing" / "checkpoints"
    run = "llava_fp32_age-gender-emotion_linear"
    jtr = JTrainer(copy.deepcopy(cfg), run, ckpt)
    jtr.fit()
    test_cfg = {"data": {"base_path": str(base), "batch_size": 5},
                "eval": {"ckpt_from": str(ckpt / run),
                         "dataset_name": "auto"}}
    JTester(copy.deepcopy(test_cfg)).run()
    out = root / "probing" / "multitask_probing" / "eval" / run
    want = {t: (json.loads((out / t / "TestDataset" / "preds.json")
                           .read_text()),
                json.loads((out / t / "TestDataset" / "metrics.json")
                           .read_text())) for t in TASKS}

    port = tmp_path / run
    port.mkdir()
    (port / "head_config.yaml").write_text(
        (ckpt / run / "head_config.yaml").read_text())
    blob = {f"heads.{t}.{k}": v for t in TASKS for k, v in
            head_state_to_state_dict(_np(jtr.probe.head_state[t])).items()}
    blob.update({f"backbone.{k}": v for k, v in flax_to_state_dict(
        _np(jtr.probe.backbone.params)).items()})
    blob.update({f"lora.{lora_name(n)}.{k}": torch.tensor(np.asarray(ab[k]))
                 for n, ab in _np(jtr.lora_params).items() for k in "AB"})
    t_utils.save_tensors(port / "model.safetensors", blob)
    tester = TTester(dict(test_cfg, eval={"ckpt_from": str(port),
                                          "dataset_name": "auto"}))
    tester.run()
    assert tester.tasks == TASKS and tester.run_name == run
    for t in TASKS:
        d = out / t / "TestDataset"
        assert json.loads((d / "preds.json").read_text()) == want[t][0]
        assert json.loads((d / "metrics.json").read_text()) == want[t][1]
    # without its adapters a LoRA checkpoint raises
    t_utils.save_tensors(port / "model.safetensors", {
        k: v for k, v in blob.items() if not k.startswith("lora.")})
    with pytest.raises(KeyError, match="lora"):
        TTester(dict(test_cfg, eval={"ckpt_from": str(port)})).run()


# --------------------------------- the CLIs ---------------------------------

def _write_cli_configs(root, base, lora):
    train = yaml.safe_load((REPO / "configs" / "train_probe.yaml")
                           .read_text())
    train["common"]["model"]["size"] = "test"
    train["common"]["model"]["lora"]["enabled"] = lora
    train["common"]["data"].update(base_path=str(base), batch_size=8)
    train["common"]["train"]["epochs"] = 2
    test = yaml.safe_load((REPO / "configs" / "test_probe.yaml").read_text())
    test["common"]["data"]["base_path"] = str(base)
    paths = root / "train.yaml", root / "test.yaml"
    for p, c in zip(paths, (train, test)):
        p.write_text(yaml.safe_dump(c))
    return paths


@pytest.mark.parametrize("lora", [False, True])
def test_clis_train_then_test_multi(env, lora):
    """``--profile multi`` from the shipped configs (the profile's backbone
    block, augmentation and the sampler), with and without the shipped
    ``lora:`` block."""
    root, base = env
    train_yaml, test_yaml = _write_cli_configs(root, base, lora)
    trainer = t_train_cli.main(["--config", str(train_yaml), "--profile",
                                "multi"])
    assert isinstance(trainer, TTrainer)
    assert trainer.run_name == "llava_fp32_age-gender-emotion_linear"
    assert trainer.use_sampler and trainer.augment is not None
    assert not trainer.probe.fully_frozen        # the profile's block
    assert bool(trainer.lora_spec) == lora
    ckpt = root / "probing" / "multitask_probing" / "checkpoints" / \
        trainer.run_name
    saved = t_utils.load_tensors(ckpt / "model.safetensors")
    assert any(k.startswith("lora.") for k in saved) == lora
    assert len((ckpt / "history.csv").read_text().splitlines()) == 3
    assert json.loads((ckpt / "EMA_history.json").read_text()).keys() == \
        set(TASKS)
    tester = t_test_cli.main(["--config", str(test_yaml), "--profile",
                              "multi"])
    ds = TFactory.create_dataset("TestDataset", split="test",
                                 base_path=str(base))
    direct = tester.model.predict([ds[i][0] for i in range(len(ds))])
    for t in TASKS:
        out = root / "probing" / "multitask_probing" / "eval" / \
            trainer.run_name / t / "TestDataset"
        preds = json.loads((out / "preds.json").read_text())
        assert [p[t] for p in preds] == direct[t].tolist()
        assert "average_accuracy" in json.loads((out / "metrics.json")
                                                .read_text())
