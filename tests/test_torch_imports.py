"""The port stands on its own: a fresh interpreter in which ``vlm_tpu``,
``jax``, ``flax`` and ``optax`` cannot be imported (a ``sys.meta_path``
finder refuses them) imports every module of vlm_tpu_torch and runs four
tiny slices end to end (model, batcher, every op's CPU version: fp32, then
8bit with the int8 KV cache and a prompt long enough for the llm.int8
prefill, then 4bit with an int4 tower, then LLaVA in fp32, then BLIP-2 in
the 8bit recipe with the int8 tower and cache), and others run the port's
CLI ``main()`` on a synthetic dataset with ``VLM_TPU_PLATFORM=cpu``, for
PaliGemma, LLaVA and BLIP-2, the wave and beam entry points with the
CLI's ``continuous_batching: false``, the probing CLIs' ``main()``
(train in both modes, then test; the multi-task profile and LoRA, then
their testers), and the model-comparison sweep, the CLI with
``--profile`` and the face-dataset preparation, and the CLI and the mesh
serving worker under ``torchrun`` over a two-rank mesh on gloo. None
imports triton or builds the kernel library;
importing the port's modules (the native image loader's build and loader
among them) starts no process (no compiler) and builds no loader."""

import json
import subprocess
import sys
from pathlib import Path

import yaml

REPO = Path(__file__).resolve().parents[1]

BLOCKER = r"""
import sys
class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("vlm_tpu", "jax", "flax", "optax"):
            raise ImportError(f"{name} may not be imported by the port")
sys.meta_path.insert(0, _Refuse())
"""

SCRIPT = BLOCKER + r"""
import importlib, json, pkgutil, subprocess
import numpy as np
import torch
torch.set_num_threads(1)
# a compiler (nvcc, g++) run at import would go through Popen
_spawned = []
_popen = subprocess.Popen.__init__
def _counted(self, *a, **kw):
    _spawned.append(a[0] if a else kw.get("args"))
    _popen(self, *a, **kw)
subprocess.Popen.__init__ = _counted
import vlm_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    vlm_tpu_torch.__path__, "vlm_tpu_torch."))
for m in mods:
    importlib.import_module(m)
spawned_at_import = list(_spawned)
from vlm_tpu_torch.data import native_loader
imgloader_checked = native_loader._lib_checked
from vlm_tpu_torch.generate.batcher import ContinuousBatcher
from vlm_tpu_torch.models.factory import create_model
from vlm_tpu_torch.models.vlm import num_image_tokens
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.ops.preprocess import normalize_images
def serve(quantization, post, name="paligemma", pre=(), **kw):
    model = create_model(name, quantization=quantization, size="test",
                         device="cpu", **kw)
    s = model.cfg.vision.image_size
    u8 = np.random.default_rng(0).integers(0, 256, (5, s, s, 3),
                                           dtype=np.uint8)
    plen = len(pre) + num_image_tokens(model.cfg) + len(post)
    return ContinuousBatcher(model.module, model.cfg, batch_size=2,
                             max_prompt_len=plen, max_new_tokens=3,
                             cache_dtype=model.cache_dtype).run(
        lambda idxs: normalize_images(torch.from_numpy(u8[idxs]),
                                      recipe=model.recipe,
                                      compute_dtype=model.dtype),
        pre_ids_row=np.asarray(pre, np.int32),
        post_ids_row=np.asarray(post, np.int32), prompt_len_scalar=plen,
        n_images=5)
out = serve("fp32", [2, 9])
# 2 x (16 + 250) = 532 prefill rows: the llm.int8 product
out8 = serve("8bit", [2] + [9] * 249, kv_cache="int8")
out4 = serve("4bit", [2, 9], quantize_vision=True)
# LLaVA: text before the image, and the config's pad id (past its "test"
# vocabulary) fed to no idle slot
outl = serve("fp32", [9, 11], name="llava", pre=[1, 7])
# BLIP-2: the Q-Former, OPT's learned positions; BOS (= EOS) first
outb = serve("8bit", [2, 9, 11], name="blip2", kv_cache="int8",
             quantize_vision=True)
print(json.dumps({
    "modules": mods, "tokens": out, "tokens8": out8, "tokens4": out4,
    "tokensl": outl, "tokensb": outb,
    "loaded": sorted(m for m in ("jax", "flax", "triton", "vlm_tpu")
                     if m in sys.modules),
    "plain_calls": _lib.plain_calls, "lib_loaded": _lib._lib is not None,
    "spawned_at_import": [str(a) for a in spawned_at_import],
    "imgloader_checked": imgloader_checked}))
"""


def _run(script, tmp_path, **env):
    return subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path), **env},
                          capture_output=True, text=True, timeout=300)


def test_port_imports_and_runs_without_jax(tmp_path):
    proc = _run(SCRIPT, tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert not res["lib_loaded"]
    assert res["spawned_at_import"] == [] and not res["imgloader_checked"]
    assert {"vlm_tpu_torch.models.base_model", "vlm_tpu_torch.ops.kvcache",
            "vlm_tpu_torch.data.bpe",
            "vlm_tpu_torch.scripts.prompt_inference",
            "vlm_tpu_torch.testing.kernel_checks",
            "vlm_tpu_torch.models.backbone", "vlm_tpu_torch.data.augment",
            "vlm_tpu_torch.data.multitask_dataset",
            "vlm_tpu_torch.probing.heads", "vlm_tpu_torch.probing.probes",
            "vlm_tpu_torch.probing.train.singletask_trainer",
            "vlm_tpu_torch.probing.test.singletask_tester",
            "vlm_tpu_torch.probing.lora",
            "vlm_tpu_torch.probing.train.losses",
            "vlm_tpu_torch.probing.train.multitask_trainer",
            "vlm_tpu_torch.probing.test.multitask_tester",
            "vlm_tpu_torch.scripts.train_probe",
            "vlm_tpu_torch.scripts.test_probe",
            "vlm_tpu_torch.scripts.compare_models",
            "vlm_tpu_torch.utils.profiling",
            "vlm_tpu_torch.data.preprocess_face_datasets",
            "vlm_tpu_torch.data.native_loader",
            "vlm_tpu_torch.native.build",
            "vlm_tpu_torch.generate.readback",
            "vlm_tpu_torch.core.mesh", "vlm_tpu_torch.parallel.sharding",
            "vlm_tpu_torch.parallel.distributed",
            "vlm_tpu_torch.testing.mesh_serve",
            "vlm_tpu_torch.testing.mesh_probe",
            "vlm_tpu_torch.testing.mesh_pool"} <= set(
                res["modules"])
    for toks in (res["tokens"], res["tokens8"], res["tokens4"],
                 res["tokensl"], res["tokensb"]):
        assert len(toks) == 5
        assert all(t is not None and len(t) <= 3 for t in toks)
    assert min(res["plain_calls"].values()) > 0


CLI = BLOCKER + r"""
import json, os, sys
import torch
torch.set_num_threads(1)
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.scripts.prompt_inference import main
summary = main(["--config", os.environ["CLI_CONFIG"]])
print(json.dumps({"summary": summary, "lib_loaded": _lib._lib is not None,
                  "loaded": sorted(m for m in ("jax", "flax", "triton",
                                               "vlm_tpu") if m in sys.modules)}))
"""


def test_port_cli_runs_end_to_end_without_jax(tmp_path, mivia_base):
    """The port's CLI on a synthetic MiviaPar split, at size "test" and
    fp32 on the CPU (``VLM_TPU_PLATFORM=cpu``), writes its preds and
    metrics with vlm_tpu, jax and flax unimportable."""
    cfg = {"model_name": "paligemma", "model_size": "test",
           "quantization": "fp32", "dataset_name": "MiviaPar",
           "max_tokens": 3, "batch_size": 2,
           "dataset": {"base_path": str(mivia_base)},
           "prompts": {"MiviaPar": "describe"}}
    path = tmp_path / "cli.yaml"
    path.write_text(yaml.safe_dump(cfg))
    proc = _run(CLI, tmp_path, CLI_CONFIG=str(path),
                VLM_TPU_ROOT=str(tmp_path), VLM_TPU_PLATFORM="cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [] and not res["lib_loaded"]
    summary = res["summary"]
    assert summary["images_requested"] == summary["images_completed"] == 4
    out = tmp_path / "eval" / "prompt_inference" / "paligemma_fp32" / \
        "MiviaPar"
    assert len(json.loads((out / "preds.json").read_text())) == 4
    assert "average_accuracy" in json.loads(
        (out / "metrics.json").read_text())


def test_port_cli_runs_llava_without_jax(tmp_path, mivia_base):
    """The same CLI run with ``model_name: llava`` (size "test", fp32)."""
    cfg = {"model_name": "llava", "model_size": "test",
           "quantization": "fp32", "dataset_name": "MiviaPar",
           "max_tokens": 3, "batch_size": 2,
           "dataset": {"base_path": str(mivia_base)},
           "prompts": {"MiviaPar": "describe"}}
    path = tmp_path / "cli.yaml"
    path.write_text(yaml.safe_dump(cfg))
    proc = _run(CLI, tmp_path, CLI_CONFIG=str(path),
                VLM_TPU_ROOT=str(tmp_path), VLM_TPU_PLATFORM="cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [] and not res["lib_loaded"]
    assert res["summary"]["images_completed"] == 4
    out = tmp_path / "eval" / "prompt_inference" / "llava_fp32" / "MiviaPar"
    assert len(json.loads((out / "preds.json").read_text())) == 4


def test_port_cli_runs_blip2_without_jax(tmp_path, mivia_base):
    """The same CLI run with ``model_name: blip2`` (size "test", fp32)."""
    cfg = {"model_name": "blip2", "model_size": "test",
           "quantization": "fp32", "dataset_name": "MiviaPar",
           "max_tokens": 3, "batch_size": 2,
           "dataset": {"base_path": str(mivia_base)},
           "prompts": {"MiviaPar": "describe"}}
    path = tmp_path / "cli.yaml"
    path.write_text(yaml.safe_dump(cfg))
    proc = _run(CLI, tmp_path, CLI_CONFIG=str(path),
                VLM_TPU_ROOT=str(tmp_path), VLM_TPU_PLATFORM="cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [] and not res["lib_loaded"]
    assert res["summary"]["images_completed"] == 4
    out = tmp_path / "eval" / "prompt_inference" / "blip2_fp32" / "MiviaPar"
    assert len(json.loads((out / "preds.json").read_text())) == 4


LOAD = BLOCKER.replace(
    '("vlm_tpu", "jax", "flax", "optax")',
    '("vlm_tpu", "jax", "flax", "optax", "safetensors", "transformers")') + r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from vlm_tpu_torch.generate.batcher import ContinuousBatcher
from vlm_tpu_torch.models.factory import create_model
from vlm_tpu_torch.models.vlm import num_image_tokens
from vlm_tpu_torch.ops import _lib
kw = dict(size="test", device="cpu", quantization="8bit",
          quantize_vision=True)
model = create_model("paligemma", model_id=os.environ["HF_DIR"], **kw)
model.save_checkpoint(os.environ["OUT_DIR"])
back = create_model("paligemma", model_id=os.environ["OUT_DIR"], **kw)
own = model.module.state_dict()
same = all(torch.equal(t, own[k]) for k, t in back.module.state_dict().items())
s = back.cfg.vision.image_size
px = torch.from_numpy(np.random.default_rng(0).normal(
    size=(3, s, s, 3)).astype(np.float32))
plen = num_image_tokens(back.cfg) + 2
toks = ContinuousBatcher(back.module, back.cfg, batch_size=2,
                         max_prompt_len=plen, max_new_tokens=3).run(
    lambda idxs: px[idxs], pre_ids_row=np.zeros((0,), np.int32),
    post_ids_row=np.asarray([2, 9], np.int32), prompt_len_scalar=plen,
    n_images=3)
print(json.dumps({
    "same": same, "tokens": toks, "tokenizer": type(model.tokenizer).__name__,
    "lib_loaded": _lib._lib is not None,
    "loaded": sorted(m for m in ("jax", "flax", "triton", "vlm_tpu",
                                 "safetensors", "transformers")
                     if m in sys.modules)}))
"""


def test_port_loads_checkpoints_without_jax_or_hf_packages(tmp_path):
    """``create_model(model_id=...)`` on a tiny HF PaliGemma checkpoint
    (8bit, quantized on load, the tower too), ``save_checkpoint`` and the
    port's own format back, then a few tokens, with ``safetensors``,
    ``transformers``, ``vlm_tpu``, ``jax`` and ``flax`` unimportable: the
    port needs none of them."""
    import pytest
    pytest.importorskip("transformers")
    from vlm_tpu.testing import HF_BUILDERS
    HF_BUILDERS["paligemma"](tmp_path / "hf", seed=7)
    proc = _run(LOAD, tmp_path, HF_DIR=str(tmp_path / "hf"),
                OUT_DIR=str(tmp_path / "native"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [] and not res["lib_loaded"]
    assert res["same"] and res["tokenizer"] == "ByteTokenizer"
    assert len(res["tokens"]) == 3 and all(
        t is not None and len(t) <= 3 for t in res["tokens"])


PROBE = BLOCKER + r"""
import json, os, shutil, sys
import torch
torch.set_num_threads(1)
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.scripts import test_probe, train_probe
runs = {}
for mode in ("cache", "e2e"):
    trainer = train_probe.main(["--config", os.environ[f"TRAIN_{mode}"]])
    runs[mode] = [trainer.use_feature_cache, len(trainer.history["train"])]
    if mode == "cache":     # the same run name: the e2e run would resume it
        shutil.rmtree(trainer.ckpt_dir)
tester = test_probe.main(["--config", os.environ["TEST_CONFIG"]])
print(json.dumps({"runs": runs, "task": tester.task,
                  "lib_loaded": _lib._lib is not None,
                  "loaded": sorted(m for m in ("jax", "flax", "optax",
                                               "triton", "vlm_tpu")
                                   if m in sys.modules)}))
"""


def test_port_probing_clis_run_without_jax(tmp_path):
    """The port's ``train_probe`` (feature cache, then end to end with the
    last block unfrozen) and ``test_probe`` on a synthetic face dataset,
    from the shipped configs at size "test" on the CPU, with ``vlm_tpu``,
    ``jax``, ``flax`` and ``optax`` unimportable."""
    from tests.conftest import make_face_dataset
    base = tmp_path / "datasets"
    rows = [{"gender": i % 2, "age": 3 + 9 * i} for i in range(8)]
    for split in ("train", "val", "test"):
        make_face_dataset(base, "TestDataset", split, rows)
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "task_datasets.yaml").write_text(yaml.safe_dump(
        {s: {"age": ["TestDataset"]} for s in ("train", "val", "test")}))
    env = {}
    for mode, k in (("cache", 0), ("e2e", 1)):
        cfg = yaml.safe_load((REPO / "configs" / "train_probe.yaml")
                             .read_text())
        cfg["common"]["model"]["size"] = "test"
        cfg["common"]["model"]["backbone"]["unfreeze_last_k"] = k
        cfg["common"]["data"].update(base_path=str(base), batch_size=4)
        cfg["common"]["train"]["epochs"] = 1
        path = tmp_path / f"train_{mode}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        env[f"TRAIN_{mode}"] = str(path)
    test_cfg = yaml.safe_load((REPO / "configs" / "test_probe.yaml")
                              .read_text())
    test_cfg["common"]["data"]["base_path"] = str(base)
    (tmp_path / "test.yaml").write_text(yaml.safe_dump(test_cfg))
    proc = _run(PROBE, tmp_path, VLM_TPU_ROOT=str(tmp_path),
                VLM_TPU_PLATFORM="cpu",
                TEST_CONFIG=str(tmp_path / "test.yaml"), **env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [] and not res["lib_loaded"]
    assert res["runs"] == {"cache": [True, 1], "e2e": [False, 1]}
    out = tmp_path / "probing" / "linear_probing" / "eval" / \
        "llava_fp32_linear" / "age" / "TestDataset"
    assert len(json.loads((out / "preds.json").read_text())) == 8


MULTI = BLOCKER + r"""
import json, os, sys
import torch
torch.set_num_threads(1)
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.scripts import test_probe, train_probe
runs = {}
for name, profile in (("multi", "multi"), ("lora", "single")):
    os.environ["VLM_TPU_ROOT"] = os.environ[f"ROOT_{name}"]
    trainer = train_probe.main(["--config", os.environ[f"TRAIN_{name}"],
                                "--profile", profile])
    tester = test_probe.main(["--config", os.environ["TEST_CONFIG"],
                              "--profile", profile])
    runs[name] = [type(trainer).__name__, bool(trainer.lora_spec),
                  len(trainer.history["train"]), type(tester).__name__]
print(json.dumps({"runs": runs, "lib_loaded": _lib._lib is not None,
                  "loaded": sorted(m for m in ("jax", "flax", "optax",
                                               "triton", "vlm_tpu")
                                   if m in sys.modules)}))
"""


def test_port_multitask_and_lora_clis_run_without_jax(tmp_path):
    """The port's ``train_probe`` and ``test_probe`` with ``--profile
    multi`` (age, gender and emotion, the profile's backbone block,
    augmentation and the sampler) and the single profile with LoRA, from
    the shipped configs at size "test" on the CPU, each in a project root
    of its own, with ``vlm_tpu``, ``jax``, ``flax`` and ``optax``
    unimportable."""
    from tests.conftest import make_face_dataset
    base = tmp_path / "datasets"
    rows = [{"gender": i % 2, "age": 3 + 9 * i, "emotion": i % 7}
            for i in range(8)]
    for split in ("train", "val", "test"):
        make_face_dataset(base, "TestDataset", split, rows)
    env = {}
    for name in ("multi", "lora"):
        root = tmp_path / name
        (root / "configs").mkdir(parents=True)
        (root / "configs" / "task_datasets.yaml").write_text(yaml.safe_dump(
            {s: {t: ["TestDataset"] for t in ("age", "gender", "emotion")}
             for s in ("train", "val", "test")}))
        cfg = yaml.safe_load((REPO / "configs" / "train_probe.yaml")
                             .read_text())
        cfg["common"]["model"]["size"] = "test"
        cfg["common"]["model"]["lora"]["enabled"] = name == "lora"
        cfg["common"]["data"].update(base_path=str(base), batch_size=4)
        cfg["common"]["train"]["epochs"] = 1
        path = tmp_path / f"train_{name}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        env[f"TRAIN_{name}"] = str(path)
        env[f"ROOT_{name}"] = str(root)
    test_cfg = yaml.safe_load((REPO / "configs" / "test_probe.yaml")
                              .read_text())
    test_cfg["common"]["data"]["base_path"] = str(base)
    (tmp_path / "test.yaml").write_text(yaml.safe_dump(test_cfg))
    proc = _run(MULTI, tmp_path, VLM_TPU_PLATFORM="cpu",
                TEST_CONFIG=str(tmp_path / "test.yaml"), **env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [] and not res["lib_loaded"]
    assert res["runs"] == {
        "multi": ["MultiTaskTrainer", False, 1, "MultiTaskTester"],
        "lora": ["SingleTaskTrainer", True, 1, "SingleTaskTester"]}
    for task in ("age", "gender", "emotion"):
        out = tmp_path / "multi" / "probing" / "multitask_probing" / \
            "eval" / "llava_fp32_age-gender-emotion_linear" / task / \
            "TestDataset"
        assert len(json.loads((out / "preds.json").read_text())) == 8
    out = tmp_path / "lora" / "probing" / "linear_probing" / "eval" / \
        "llava_fp32_linear" / "age" / "TestDataset"
    assert len(json.loads((out / "preds.json").read_text())) == 8


WAVES = BLOCKER + r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from PIL import Image
from vlm_tpu_torch.models.factory import create_model
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.scripts.prompt_inference import main
rng = np.random.default_rng(0)
images = [Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8))
          for _ in range(3)]
paths = []
for i, im in enumerate(images):
    paths.append(os.path.join(os.environ["HOME"], f"{i}.png"))
    im.save(paths[-1])
out = {}
for name, kv in (("paligemma", None), ("llava", None), ("blip2", "int8")):
    model = create_model(name, size="test", device="cpu", kv_cache=kv)
    out[name] = [model.generate_batch(images, "p", max_tokens=3),
                 model.generate_batch(images, "p", max_tokens=3,
                                      num_beams=2),
                 model.generate_text(images[0], "p", max_tokens=2),
                 model.generate_dataset(paths, "p", max_tokens=3,
                                        batch_size=2, num_beams=2)]
summary = main(["--config", os.environ["CLI_CONFIG"]])
print(json.dumps({"out": out, "summary": summary,
                  "lib_loaded": _lib._lib is not None,
                  "loaded": sorted(m for m in ("jax", "flax", "triton",
                                               "vlm_tpu")
                                   if m in sys.modules)}))
"""


def test_port_waves_beams_and_wave_cli_run_without_jax(tmp_path, mivia_base):
    """``generate_batch`` greedy and with beams, ``generate_text`` and
    ``generate_dataset(num_beams=2)`` for the three families (BLIP-2 with
    the int8 cache), then the CLI with ``continuous_batching: false`` and
    ``num_beams: 2``, with vlm_tpu, jax and flax unimportable."""
    cfg = {"model_name": "paligemma", "model_size": "test",
           "quantization": "fp32", "dataset_name": "MiviaPar",
           "continuous_batching": False, "num_beams": 2,
           "max_tokens": 3, "batch_size": 3,
           "dataset": {"base_path": str(mivia_base)},
           "prompts": {"MiviaPar": "describe"}}
    path = tmp_path / "cli.yaml"
    path.write_text(yaml.safe_dump(cfg))
    proc = _run(WAVES, tmp_path, CLI_CONFIG=str(path),
                VLM_TPU_ROOT=str(tmp_path), VLM_TPU_PLATFORM="cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [] and not res["lib_loaded"]
    for greedy, beams, text, dataset in res["out"].values():
        assert len(greedy) == len(beams) == len(dataset) == 3
        assert all(isinstance(t, str) for t in greedy + beams + dataset)
        assert isinstance(text, str)
    assert res["summary"]["images_completed"] == 4
    out = tmp_path / "eval" / "prompt_inference" / "paligemma_fp32" / \
        "MiviaPar"
    assert len(json.loads((out / "preds.json").read_text())) == 4
    assert (out / "metrics.json").exists()


SWEEP = BLOCKER + r"""
import json, os, sys
import torch
torch.set_num_threads(1)
from vlm_tpu_torch.data import preprocess_face_datasets
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.scripts import compare_models, prompt_inference
rows = compare_models.main(["--config", os.environ["SWEEP_CONFIG"]])
summary = prompt_inference.main(["--config", os.environ["CLI_CONFIG"],
                                 "--profile", os.environ["TRACE_DIR"]])
preprocess_face_datasets.main(["--base", os.environ["FACE_BASE"]])
print(json.dumps({"rows": rows, "summary": summary,
                  "lib_loaded": _lib._lib is not None,
                  "loaded": sorted(m for m in ("jax", "flax", "triton",
                                               "vlm_tpu") if m in sys.modules)}))
"""


def test_sweep_profile_and_face_preparation_run_without_jax(tmp_path,
                                                            mivia_base):
    """``compare_models`` over PaliGemma and BLIP-2 at size "test" in fp32
    and 4bit, the CLI with ``--profile`` (its trace written) and
    ``preprocess_face_datasets`` (a val split and the class counts), with
    vlm_tpu, jax and flax unimportable."""
    from tests.conftest import make_face_dataset
    sweep = {"models": ["paligemma", "blip2"],
             "quantizations": ["fp32", "4bit"], "datasets": ["MiviaPar"],
             "max_tokens": 3, "batch_size": 2, "model_size": "test",
             "dataset": {"base_path": str(mivia_base)},
             "prompts": {"MiviaPar": "describe"}}
    cli = {"model_name": "paligemma", "model_size": "test",
           "quantization": "fp32", "dataset_name": "MiviaPar",
           "max_tokens": 3, "batch_size": 2,
           "dataset": {"base_path": str(mivia_base)},
           "prompts": {"MiviaPar": "describe"}}
    for name, cfg in (("sweep", sweep), ("cli", cli)):
        (tmp_path / f"{name}.yaml").write_text(yaml.safe_dump(cfg))
    faces = tmp_path / "faces"
    make_face_dataset(faces, "TestDataset", "train",
                      [{"gender": i % 2, "age": 20 + i} for i in range(10)])
    proc = _run(SWEEP, tmp_path, SWEEP_CONFIG=str(tmp_path / "sweep.yaml"),
                CLI_CONFIG=str(tmp_path / "cli.yaml"),
                TRACE_DIR=str(tmp_path / "trace"), FACE_BASE=str(faces),
                VLM_TPU_ROOT=str(tmp_path), VLM_TPU_PLATFORM="cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [] and not res["lib_loaded"]
    assert [(r["model"], r["quantization"], r["images"])
            for r in res["rows"]] == [("paligemma", "fp32", 4),
                                      ("paligemma", "4bit", 4),
                                      ("blip2", "fp32", 4),
                                      ("blip2", "4bit", 4)]
    assert (tmp_path / "eval" / "comparison" / "summary.csv").exists()
    assert res["summary"]["images_completed"] == 4
    assert "[THROUGHPUT] prompt_inference:" in proc.stdout
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert (faces / "TestDataset" / "val" / "labels.csv").exists()
    assert json.loads((faces / "TestDataset" / "train" /
                       "class_counts.json").read_text())["gender"]


MESH_CLI = BLOCKER + r"""
import json, os, sys
import torch
torch.set_num_threads(1)
from vlm_tpu_torch.scripts.prompt_inference import main
summary = main(["--config", os.environ["CLI_CONFIG"]])
print("RESULT " + json.dumps({
    "rank": int(os.environ.get("RANK", 0)), "summary": summary,
    "loaded": sorted(m for m in ("jax", "flax", "triton", "vlm_tpu")
                     if m in sys.modules)}))
"""

MESH_WORKER = BLOCKER + r"""
import sys
from vlm_tpu_torch.testing.mesh_serve import main
sys.exit(main(sys.argv[1:]))
"""


def _torchrun(script, args, tmp_path, n=2, **env):
    path = tmp_path / "rank.py"
    path.write_text(script)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(n), str(path), *args], cwd=tmp_path,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path), "OMP_NUM_THREADS": "1",
             "VLM_TPU_DIST_TIMEOUT": "60", **env},
        capture_output=True, text=True, timeout=180)


def _results(proc):
    return [json.loads(line.split("RESULT ", 1)[1])
            for line in proc.stdout.splitlines() if "RESULT " in line]


def test_port_cli_serves_under_a_mesh_with_torchrun(tmp_path, mivia_base):
    """``mesh: {data: 1, model: 2}`` under torchrun on the CPU (gloo): both
    ranks serve, rank 0 alone writes the artifacts and prints the meter,
    and the predictions are the single-process run's, with vlm_tpu, jax
    and flax unimportable in every rank."""
    cfg = {"model_name": "paligemma", "model_size": "test",
           "quantization": "fp32", "dataset_name": "MiviaPar",
           "max_tokens": 3, "batch_size": 2,
           "dataset": {"base_path": str(mivia_base)},
           "prompts": {"MiviaPar": "describe"}}
    one, two = tmp_path / "one", tmp_path / "two"
    for root, mesh in ((one, None), (two, {"data": 1, "model": 2})):
        root.mkdir()
        path = root / "cli.yaml"
        path.write_text(yaml.safe_dump(dict(cfg, mesh=mesh)))
        env = dict(CLI_CONFIG=str(path), VLM_TPU_ROOT=str(root),
                   VLM_TPU_PLATFORM="cpu")
        if mesh is None:
            proc = _run(MESH_CLI, root, **env)
        else:
            proc = _torchrun(MESH_CLI, [], root, **env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        res = _results(proc)
        assert len(res) == (1 if mesh is None else 2)
        assert all(r["loaded"] == [] for r in res)
        assert all(r["summary"]["images_completed"] == 4 for r in res)
    assert proc.stdout.count("[THROUGHPUT]") == 1
    assert proc.stdout.count("Output directory:") == 1
    out = "eval/prompt_inference/paligemma_fp32/MiviaPar/preds.json"
    assert json.loads((two / out).read_text()) == \
        json.loads((one / out).read_text())


def test_mesh_worker_runs_without_jax(tmp_path):
    """``testing/mesh_serve.py`` at ``data=2`` with random weights (the
    unsharded model's from the seed), jax unimportable: both ranks write
    the same batcher tokens, and each served its own slots."""
    import numpy as np
    s = 56
    np.save(tmp_path / "u8.npy", np.random.default_rng(0).integers(
        0, 256, (6, s, s, 3), dtype=np.uint8))
    spec = dict(family="llava", size="test", mesh={"data": 2, "model": 1},
                device="cpu", seed=3, images=str(tmp_path / "u8.npy"),
                pre_ids=[1, 7], post_ids=[9, 11], pad_id=0, threads=1,
                tasks=[["batcher", {"n": 6, "slots": 4, "new": 3}]])
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    proc = _torchrun(MESH_WORKER, [str(tmp_path / "spec.json"),
                                   str(tmp_path / "out")], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = [json.loads((tmp_path / "out" / f"rank{r}.json").read_text())
            for r in range(2)]
    a, b = (r["tasks"][0] for r in recs)
    assert a["tokens"] == b["tokens"] and all(a["tokens"])
    assert sorted(a["images_served_here"] + b["images_served_here"]) == \
        list(range(6))


PROBE_WORKER = BLOCKER + r"""
import sys
from vlm_tpu_torch.testing.mesh_probe import main
sys.exit(main(sys.argv[1:]))
"""


def test_probing_mesh_worker_runs_without_jax(tmp_path):
    """``testing/mesh_probe.py`` at ``data=2, model=1`` with random weights,
    jax unimportable: the backbone's features of 3 images (padded to 4
    over the data axis) written by rank 0, gathered on every rank."""
    import numpy as np
    np.save(tmp_path / "u8.npy", np.random.default_rng(0).integers(
        0, 256, (3, 56, 56, 3), dtype=np.uint8))
    root = tmp_path / "root"
    (root / "configs").mkdir(parents=True)
    (root / "configs" / "task_datasets.yaml").write_text("{}")
    spec = dict(mesh={"data": 2, "model": 1}, device="cpu", root=str(root),
                threads=1, tasks=[["features", dict(
                    id="f", family="llava", size="test", chunks=[3],
                    images=str(tmp_path / "u8.npy"), batch_size=2)]])
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    proc = _torchrun(PROBE_WORKER, [str(tmp_path / "spec.json"),
                                    str(tmp_path / "out")], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    feats = np.load(tmp_path / "out" / "f_features_3.npy")
    assert feats.shape == (3, 64) and np.isfinite(feats).all()
    recs = [json.loads((tmp_path / "out" / f"rank{r}.json").read_text())
            for r in range(2)]
    assert {r["data_rank"] for r in recs} == {0, 1}
    assert all(r["tasks"][0]["chunk3"]["collectives"]["all_gather_data"] == 1
               for r in recs)
