"""The port's meters and the CLI's report, against vlm_tpu's, on the CPU:

- ``ThroughputMeter`` prints vlm_tpu's lines for the same ``update``
  sequence under the same patched clock;
- ``profile_trace`` writes a Chrome trace with the ``annotate`` ranges,
  also when its block raises;
- the CLI (``vlm_tpu_torch/scripts/prompt_inference.py``) beside
  ``scripts/prompt_inference.py`` on the tiny HF PaliGemma checkpoint of
  ``vlm_tpu/testing/hf_tiny.py``: with ``--profile`` the same preds, gts
  and metrics files, the meter's line for the same image count, and each
  CLI's trace; after an interrupt and with nothing to evaluate, the same
  message lines, on the continuous path and (the port's) wave path.
"""

import importlib.util
import json
import re
import shutil
import sys
from pathlib import Path

import pytest
import torch
import yaml

pytest.importorskip("transformers")

from vlm_tpu.testing import HF_BUILDERS  # noqa: E402
from vlm_tpu.utils import profiling as jprof  # noqa: E402
from vlm_tpu_torch.utils import profiling as tprof  # noqa: E402

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


class _Clock:
    """``time`` with a ``perf_counter`` that steps through ``ticks``."""

    def __init__(self, ticks):
        self._ticks = iter(ticks)

    def perf_counter(self):
        return next(self._ticks)


@pytest.mark.parametrize("updates", [[], [4], [4, 8, 8, 3], [1] * 7, [0],
                                     [0, 5], [32] * 3, [2, 0, 9]])
def test_meter_prints_vlm_tpus_lines(monkeypatch, capsys, updates):
    lines = {}
    for name, mod in (("jax", jprof), ("port", tprof)):
        ticks = [0.25 + 1.5 * i + 0.01 * i * i for i in range(64)]
        monkeypatch.setattr(mod, "time", _Clock(ticks))
        meter = mod.ThroughputMeter()
        for n in updates:
            meter.update(n)
        meter.report("prompt_inference")
        meter.report()
        lines[name] = capsys.readouterr().out
    assert lines["port"] == lines["jax"]
    assert lines["port"].startswith("[THROUGHPUT] prompt_inference: ")


def test_profile_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with tprof.profile_trace(tmp_path / "t") as path:
        with tprof.annotate("my_range"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads(Path(path).read_text())
    assert path == tmp_path / "t" / tprof.TRACE_FILE
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "my_range" in names and "aten::mm" in names
    with pytest.raises(RuntimeError, match="boom"):
        with tprof.profile_trace(tmp_path / "raised"):
            with tprof.annotate("before_the_raise"):
                torch.ones(3) + 1
            raise RuntimeError("boom")
    trace = json.loads((tmp_path / "raised" / tprof.TRACE_FILE).read_text())
    assert "before_the_raise" in {e.get("name") for e in trace["traceEvents"]}
    with tprof.profile_trace(None) as path:
        pass
    assert path is None


# ------------------------------- the CLI -------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("hf_paligemma")
    HF_BUILDERS["paligemma"](d, seed=7)
    return d


def _jax_cli():
    from vlm_tpu.evaluation import Evaluator
    spec = importlib.util.spec_from_file_location(
        "jax_prompt_inference", REPO / "scripts" / "prompt_inference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # its wave path names Evaluator, which only main imports
    mod.Evaluator = Evaluator
    return mod


def _run(name, root, cfg, monkeypatch, extra=()):
    from vlm_tpu.data.dataset_factory import DatasetFactory
    from vlm_tpu_torch.scripts import prompt_inference
    (root / "configs").mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "configs" / "task_datasets.yaml", root / "configs")
    (root / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    monkeypatch.setenv("VLM_TPU_ROOT", str(root))
    DatasetFactory.load_task_map(force=True)
    argv = ["--config", str(root / "cfg.yaml"), *extra]
    if name == "jax":
        monkeypatch.setattr(sys, "argv", ["prompt_inference.py", *argv])
        _jax_cli().main()
    else:
        prompt_inference.main(argv)
    return root / "eval" / "prompt_inference" / \
        f"{cfg['model_name']}_{cfg['quantization']}" / cfg["dataset_name"]


def _config(ckpt, base, **over):
    cfg = {"model_name": "paligemma", "model_size": "test",
           "model_id": str(ckpt), "quantization": "fp32",
           "dataset_name": "MiviaPar", "max_tokens": 6, "batch_size": 2,
           "dataset": {"base_path": str(base)},
           "prompts": {"MiviaPar": "colors?"}}
    cfg.update(over)
    return cfg


def _messages(text):
    """The lines the CLIs share: the meter's (its rates masked), the
    interrupt's and the empty run's."""
    keep = []
    for line in text.splitlines():
        if line.startswith("[THROUGHPUT]"):
            keep.append(re.sub(r"\d+\.\d\d", "<rate>", line))
        elif line.startswith(("Interrupted: evaluated",
                              "Nothing to evaluate.")):
            keep.append(line)
    return keep


@pytest.fixture
def cpu_env(monkeypatch):
    monkeypatch.setenv("VLM_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("VLM_TPU_PALLAS_INTERPRET", "1")


def test_cli_profile_writes_vlm_tpus_files_meter_and_a_trace(
        ckpt, mivia_base, tmp_path, monkeypatch, capsys, cpu_env):
    cfg = _config(ckpt, mivia_base)
    out, text = {}, {}
    for name in ("jax", "port"):
        prof = tmp_path / f"{name}_trace"
        out[name] = _run(name, tmp_path / name, cfg, monkeypatch,
                         ["--profile", str(prof)])
        text[name] = capsys.readouterr().out
        assert f"Profiler trace written to {prof}" in text[name]
        assert any(prof.rglob("*")), name
    for f in ("preds.json", "gts.json", "metrics.json"):
        assert json.loads((out["port"] / f).read_text()) == \
            json.loads((out["jax"] / f).read_text()), f
    assert _messages(text["port"]) == _messages(text["jax"]) == [
        "[THROUGHPUT] prompt_inference: <rate> items/s steady (<rate> incl. "
        "compile), 4 items total"]
    trace = json.loads((tmp_path / "port_trace" / tprof.TRACE_FILE
                        ).read_text())
    assert any(e.get("name", "").startswith("aten::")
               for e in trace["traceEvents"])


def _interrupt_after(monkeypatch, mod, k):
    """The CLI's meter raises KeyboardInterrupt once, at the update that
    brings it to ``k`` images, as a user's Ctrl-C in the middle of the
    run."""
    real = mod.ThroughputMeter.update
    fired = []

    def update(self, n):
        real(self, n)
        if self._total_count >= k and not fired:
            fired.append(k)
            raise KeyboardInterrupt
    monkeypatch.setattr(mod.ThroughputMeter, "update", update)


def _interrupt_loading(monkeypatch):
    """Ctrl-C while both batchers load their first images: nothing has
    been dispatched, so neither has an image to finish."""
    from vlm_tpu.data import native_loader
    from vlm_tpu_torch.models import base_model

    def interrupted(*args, **kw):
        raise KeyboardInterrupt
    monkeypatch.setattr(native_loader, "load_batch", interrupted)
    monkeypatch.setattr(base_model, "load_batch", interrupted)


def test_cli_interrupt_and_empty_messages_match_vlm_tpu(
        ckpt, mivia_base, tmp_path, monkeypatch, capsys, cpu_env):
    """Continuous path, interrupted before the first admission: both CLIs
    print the meter's line and "Interrupted: evaluated 0/4 images.";
    ``--limit 0``: "Nothing to evaluate." in both. Interrupted at the
    second image, both batchers finish the chunks they had dispatched and
    evaluate the same images (here every one, so neither run is partial)."""
    cfg = _config(ckpt, mivia_base)
    text = {}
    for name in ("jax", "port"):
        with monkeypatch.context() as m:
            _interrupt_loading(m)
            _run(name, tmp_path / name, cfg, monkeypatch)
        text[name] = capsys.readouterr().out
    assert _messages(text["port"]) == _messages(text["jax"]) == [
        "[THROUGHPUT] prompt_inference: <rate> items/s steady (<rate> incl. "
        "compile), 0 items total", "Interrupted: evaluated 0/4 images."]
    for name in ("jax", "port"):
        _run(name, tmp_path / f"{name}_empty", cfg, monkeypatch,
             ["--limit", "0"])
        assert _messages(capsys.readouterr().out)[-1] == \
            "Nothing to evaluate.", name
    preds, said = {}, {}
    for name, mod in (("jax", jprof), ("port", tprof)):
        with monkeypatch.context() as m:
            _interrupt_after(m, mod, 2)
            out = _run(name, tmp_path / f"{name}_int", cfg, monkeypatch)
        said[name] = _messages(capsys.readouterr().out)
        preds[name] = json.loads((out / "preds.json").read_text())
    assert said["port"] == said["jax"] == [
        "[THROUGHPUT] prompt_inference: <rate> items/s steady (<rate> incl. "
        "compile), 4 items total"]
    assert len(preds["port"]) == len(preds["jax"]) == 4


def test_wave_path_meter_and_messages(ckpt, mivia_base, tmp_path,
                                      monkeypatch, capsys, cpu_env):
    """``continuous_batching: false``: the meter counts waves as vlm_tpu's
    wave loop does (4 images in waves of 3, the second padded); an
    interrupt after the first wave evaluates its 3 images; ``--limit 0``
    prints "Nothing to evaluate." as vlm_tpu's wave path does."""
    cfg = _config(ckpt, mivia_base, continuous_batching=False, batch_size=3)
    text = {}
    for name in ("jax", "port"):
        _run(name, tmp_path / name, cfg, monkeypatch)
        text[name] = capsys.readouterr().out
    assert _messages(text["port"]) == _messages(text["jax"])
    assert _messages(text["port"])[0].endswith("4 items total")
    with monkeypatch.context() as m:
        _interrupt_after(m, tprof, 3)
        _run("port", tmp_path / "port_int", cfg, monkeypatch)
    assert _messages(capsys.readouterr().out) == [
        "[THROUGHPUT] prompt_inference: <rate> items/s steady (<rate> incl. "
        "compile), 3 items total", "Interrupted: evaluated 3/4 images."]
    for name in ("jax", "port"):
        _run(name, tmp_path / f"{name}_empty", cfg, monkeypatch,
             ["--limit", "0"])
        assert _messages(capsys.readouterr().out)[-1] == \
            "Nothing to evaluate.", name


@pytest.mark.parametrize("flag", ["1", "0"])
def test_batcher_stats_env_prints_the_counters(tmp_path, monkeypatch,
                                               capsys, flag):
    """``VLM_TPU_BATCHER_STATS=1``: ``generate_dataset`` prints ``[batcher
    stats] {last_stats}`` to stderr after the run, as vlm_tpu's does
    (each package its own loop's counters; admissions counted alike);
    otherwise nothing."""
    import ast

    from PIL import Image

    from vlm_tpu.models.factory import VLMModelFactory
    from vlm_tpu_torch.models.factory import create_model
    paths = []
    for i in range(3):
        p = tmp_path / f"{i}.png"
        Image.new("RGB", (20, 30), (40 * i, 90, 200)).save(p)
        paths.append(str(p))
    monkeypatch.setenv("VLM_TPU_BATCHER_STATS", flag)
    monkeypatch.setenv("VLM_TPU_PALLAS_INTERPRET", "1")
    stats = {}
    for name, model in (
            ("jax", VLMModelFactory.create_model("paligemma", size="test")),
            ("port", create_model("paligemma", size="test", device="cpu"))):
        model.generate_dataset(paths, "colors?", max_tokens=3, batch_size=2)
        err = [ln for ln in capsys.readouterr().err.splitlines()
               if ln.startswith("[batcher stats] ")]
        if flag == "1":
            assert len(err) == 1, name
            stats[name] = ast.literal_eval(err[0][len("[batcher stats] "):])
        else:
            assert err == [], name
    if flag == "1":
        assert stats["port"]["admits"] == stats["jax"]["admits"] == 2
        assert {"admit_s", "admits", "chunks", "sync_s"} <= \
            set(stats["port"]) & set(stats["jax"])
