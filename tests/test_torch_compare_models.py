"""The port's model-comparison sweep
(``vlm_tpu_torch/scripts/compare_models.py``) beside
``scripts/compare_models.py`` on the CPU:

- both sweeps over the three tiny HF checkpoints of
  ``vlm_tpu/testing/hf_tiny.py`` (``model_ids``), ``model_size: test``,
  fp32 and 8bit, one MiviaPar test split of 4 images, 6 new tokens (JAX's
  Pallas in interpret mode): the same ``summary.json`` rows but
  ``images_per_sec``, the same ``summary.csv`` columns, and the same
  preds, gts and metrics files in every run directory; every model the
  port built is garbage once the sweep has moved on (nothing keeps its
  module or engines);
- an unknown model and a dataset that is not there become ``error`` rows
  and the sweep goes on, as in vlm_tpu's;
- an interrupt stops the sweep: a partial run ends it after its row; a
  Ctrl-C while a model builds propagates with the rows so far written;
- the full-size sweep of ``chip_smoke.py`` (the shipped MiviaPar prompt,
  ``batch_size: 8``) gives each model the prompt length, slots and
  admission block of ``kernel_checks``' sweep cases.
"""

import csv
import gc
import importlib.util
import json
import shutil
import sys
import weakref
from pathlib import Path

import pytest
import torch
import yaml

pytest.importorskip("transformers")

from vlm_tpu.testing import HF_BUILDERS  # noqa: E402
from vlm_tpu_torch.scripts import compare_models  # noqa: E402

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
FAMILIES = ("paligemma", "llava", "blip2")


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    out = {}
    for family in FAMILIES:
        d = tmp_path_factory.mktemp(f"hf_{family}")
        HF_BUILDERS[family](d, seed=7)
        out[family] = str(d)
    return out


def _jax_sweep():
    spec = importlib.util.spec_from_file_location(
        "jax_compare_models", REPO / "scripts" / "compare_models.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sweep(name, root, cfg, monkeypatch):
    """One sweep under project root ``root``; its rows and output dir."""
    from vlm_tpu.data.dataset_factory import DatasetFactory
    (root / "configs").mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "configs" / "task_datasets.yaml", root / "configs")
    (root / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    monkeypatch.setenv("VLM_TPU_ROOT", str(root))
    DatasetFactory.load_task_map(force=True)
    argv = ["--config", str(root / "cfg.yaml")]
    if name == "jax":
        monkeypatch.setattr(sys, "argv", ["compare_models.py", *argv])
        _jax_sweep().main()
    else:
        compare_models.main(argv)
    out = root / "eval" / "comparison"
    return json.loads((out / "summary.json").read_text()), out


@pytest.fixture
def cpu_env(monkeypatch):
    monkeypatch.setenv("VLM_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("VLM_TPU_PALLAS_INTERPRET", "1")


def _config(base, **over):
    cfg = yaml.safe_load((REPO / "configs" / "compare_models.yaml")
                         .read_text())
    # a short prompt: the "test" decoders hold 512 positions
    cfg.update(models=list(FAMILIES), quantizations=["fp32", "8bit"],
               datasets=["MiviaPar"], max_tokens=6, batch_size=2,
               model_size="test", dataset={"base_path": str(base)},
               prompts={"MiviaPar": "colors?", "face_dataset": "age?"})
    cfg.update(over)
    return cfg


def _mask(rows):
    return [{k: v for k, v in r.items() if k != "images_per_sec"}
            for r in rows]


def test_sweep_writes_vlm_tpus_rows_and_files(ckpts, mivia_base, tmp_path,
                                              monkeypatch, cpu_env):
    cfg = _config(mivia_base, model_ids=ckpts)
    built = []
    real = compare_models.create_model

    def spy(*args, **kw):
        model = real(*args, **kw)
        built.append(weakref.ref(model.module))
        return model
    monkeypatch.setattr(compare_models, "create_model", spy)
    rows, out = {}, {}
    for name in ("jax", "port"):
        rows[name], out[name] = _sweep(name, tmp_path / name, cfg,
                                       monkeypatch)
    assert _mask(rows["port"]) == _mask(rows["jax"])
    assert len(rows["port"]) == 6
    assert all(r["images"] == 4 and not r["partial"] and "error" not in r
               and r["images_per_sec"] > 0 for r in rows["port"])
    with open(out["port"] / "summary.csv") as f:
        port_cols = csv.DictReader(f).fieldnames
    with open(out["jax"] / "summary.csv") as f:
        assert port_cols == csv.DictReader(f).fieldnames
    for family in FAMILIES:
        for quant in ("fp32", "8bit"):
            run = Path(f"{family}_{quant}") / "MiviaPar"
            for f in ("preds.json", "gts.json", "metrics.json"):
                assert json.loads((out["port"] / run / f).read_text()) == \
                    json.loads((out["jax"] / run / f).read_text()), run / f
    gc.collect()
    assert len(built) == 6 and all(ref() is None for ref in built)


def test_unknown_model_and_missing_dataset_are_error_rows(
        ckpts, mivia_base, tmp_path, monkeypatch, cpu_env):
    cfg = _config(mivia_base, models=["nosuch", "paligemma"],
                  quantizations=["fp32"], datasets=["MiviaPar", "RAF-DB"],
                  model_ids=ckpts, prompts={"MiviaPar": "colors?"})
    rows = {name: _sweep(name, tmp_path / name, cfg, monkeypatch)[0]
            for name in ("jax", "port")}
    assert _mask(rows["port"]) == _mask(rows["jax"])
    errors = [r.get("error", "") for r in rows["port"]]
    assert errors[0].startswith("create_model: Model 'nosuch' not found")
    assert errors[1] == ""
    assert errors[2].startswith("[FaceDataset] split 'test' not found")


def _fake_models(monkeypatch, jax_factory, interrupt_at=None):
    """Both scripts' ``create_model`` return a stand-in (its device the
    CPU) and count the builds; the ``interrupt_at``-th build raises
    KeyboardInterrupt."""
    class Stub:
        device = torch.device("cpu")
        module, _engines = None, {}
    calls = []

    def create(name, *args, **kw):
        calls.append(name)
        if len(calls) == interrupt_at:
            raise KeyboardInterrupt
        return Stub()
    monkeypatch.setattr(jax_factory, "create_model",
                        staticmethod(create))
    monkeypatch.setattr(compare_models, "create_model", create)
    return calls


def test_interrupt_stops_the_sweep(mivia_base, tmp_path, monkeypatch,
                                   cpu_env):
    """A run that returns partial (the batcher's Ctrl-C) ends the sweep
    after its row; a Ctrl-C while the second model builds propagates, the
    first model's rows written."""
    from vlm_tpu import evaluation as jeval
    from vlm_tpu.models.factory import VLMModelFactory
    from vlm_tpu_torch import evaluation as teval

    def partial(*args, **kw):
        return {"metrics": {}, "images_completed": 1, "images_per_sec": 1.0,
                "partial": True}
    cfg = _config(mivia_base, datasets=["MiviaPar", "MiviaPar"])
    rows = {}
    for name, mod in (("jax", jeval), ("port", teval)):
        with monkeypatch.context() as m:
            m.setattr(mod, "run_zero_shot", partial)
            calls = _fake_models(m, VLMModelFactory)
            rows[name] = _sweep(name, tmp_path / name, cfg, m)[0]
            assert calls == ["paligemma"]
    assert rows["port"] == rows["jax"] == [
        {"model": "paligemma", "quantization": "fp32", "dataset": "MiviaPar",
         "images": 1, "images_per_sec": 1.0, "partial": True,
         "average_accuracy": None}]

    def done(*args, **kw):
        return {"metrics": {}, "images_completed": 4, "images_per_sec": 2.0,
                "partial": False}
    for name, mod in (("jax", jeval), ("port", teval)):
        with monkeypatch.context() as m:
            m.setattr(mod, "run_zero_shot", done)
            calls = _fake_models(m, VLMModelFactory, interrupt_at=2)
            with pytest.raises(KeyboardInterrupt):
                _sweep(name, tmp_path / f"{name}_ctrl_c", cfg, m)
            assert calls == ["paligemma", "paligemma"]
        rows[name] = json.loads((tmp_path / f"{name}_ctrl_c" / "eval" /
                                 "comparison" / "summary.json").read_text())
    assert rows["port"] == rows["jax"] and len(rows["port"]) == 2


@pytest.mark.parametrize("family", FAMILIES)
def test_full_size_sweep_prompts_are_the_kernel_checks(family):
    """The prompt ids of the shipped MiviaPar prompt (byte ids: a sweep
    without tokenizer files) after the full-size model's image tokens,
    and the batcher's admission block at 8 slots: the shapes of
    ``kernel_checks``' sweep cases."""
    from vlm_tpu_torch.generate.batcher import ContinuousBatcher
    from vlm_tpu_torch.generate.decode import build_prompt_ids
    from vlm_tpu_torch.models.configs import VLM_CONFIGS
    from vlm_tpu_torch.models.factory import create_model
    from vlm_tpu_torch.models.vlm import num_image_tokens
    from vlm_tpu_torch.testing import kernel_checks
    cfg = yaml.safe_load((REPO / "configs" / "compare_models.yaml")
                         .read_text())
    model = create_model(family, size="test", device="cpu")
    pre_t, post_t, bos_pre, bos_post = model.format_prompt(
        cfg["prompts"]["MiviaPar"])
    _, _, prompt_len = build_prompt_ids(
        model.tokenizer, pre_t, post_t, num_image_tokens(VLM_CONFIGS[family]()),
        1, add_bos_to_pre=bos_pre, add_bos_to_post=bos_post)
    assert int(prompt_len[0]) == kernel_checks.SWEEP_PROMPTS[family]
    batcher = ContinuousBatcher(
        model.module, model.cfg, batch_size=kernel_checks.SWEEP_SLOTS,
        max_prompt_len=8, max_new_tokens=kernel_checks.SWEEP_NEW)
    assert batcher.admit_block == kernel_checks.SWEEP_GROUP
