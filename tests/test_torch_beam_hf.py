"""Beam search and the wave CLI on the three tiny HF models of
``vlm_tpu/testing/hf_tiny.py`` (built from config with seed 7, saved as
safetensors, loaded by ``create_model(..., model_id=<dir>)``), on the CPU.

- The port's ``BeamSearchEngine`` gives HF ``generate(num_beams=2,
  length_penalty=1.0, early_stopping=False)``'s tokens over 12 steps, as
  ``tests/test_hf_parity.py`` holds vlm_tpu's.
- The port's CLI with ``continuous_batching: false`` and ``num_beams: 2``
  writes the preds, gts and metrics that vlm_tpu's CLI writes for the same
  config and checkpoint, the last wave padded. vlm_tpu's script imports
  ``Evaluator`` inside ``main`` and names it in ``_run_inference``, where
  that path raises ``NameError``; the test puts the name into the loaded
  script's globals, as its continuous path's ``run_zero_shot`` would reach
  it.
"""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

pytest.importorskip("transformers")

from vlm_tpu.testing import (HF_BUILDERS, IMAGE_TOKEN,  # noqa: E402
                             hf_text_ids, rand_pixels)
from vlm_tpu_torch.generate.beam import BeamSearchEngine  # noqa: E402
from vlm_tpu_torch.models.factory import create_model  # noqa: E402
from vlm_tpu_torch.models.vlm import num_image_tokens  # noqa: E402

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
FAMILIES = ("llava", "paligemma", "blip2")
BATCH, K, NEW = 2, 2, 12
PROMPT = "Describe the clothing of the person"


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    out = {}
    for family in FAMILIES:
        d = tmp_path_factory.mktemp(f"hf_{family}")
        out[family] = (d, HF_BUILDERS[family](d, seed=7))
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_beam_tokens_match_hf_generate(ckpts, family):
    path, hf = ckpts[family]
    model = create_model(family, model_id=str(path), size="test",
                         device="cpu")
    px = rand_pixels(BATCH, model.cfg.vision.image_size, seed=13)
    pre, post = hf_text_ids(model, PROMPT)
    ids = list(pre) + [IMAGE_TOKEN] * num_image_tokens(model.cfg) + list(post)
    input_ids = torch.tensor([ids] * BATCH, dtype=torch.long)
    eos = model.cfg.decoder.eos_token_id
    with torch.no_grad():
        out = hf.generate(
            input_ids=input_ids, pixel_values=torch.from_numpy(px),
            attention_mask=torch.ones_like(input_ids), do_sample=False,
            num_beams=K, max_new_tokens=NEW, pad_token_id=0, use_cache=True,
            length_penalty=1.0, early_stopping=False).numpy()
    n = input_ids.shape[1]
    if out.shape[1] >= n and np.array_equal(out[:, :n], input_ids.numpy()):
        out = out[:, n:]
    i32 = dict(dtype=torch.int32)
    res = BeamSearchEngine(
        model.module, model.cfg, batch_size=BATCH, max_prompt_len=len(ids),
        num_beams=K, max_new_tokens=NEW, eos_id=eos, pad_id=0).generate(
        torch.from_numpy(px.transpose(0, 2, 3, 1).copy()),
        torch.tensor([pre] * BATCH, **i32).reshape(BATCH, -1),
        torch.tensor([post] * BATCH, **i32),
        torch.full((BATCH,), len(ids), **i32))
    for i in range(BATCH):
        # HF appends the EOS to the chosen hypothesis and pads with 0
        ref = []
        for t in out[i]:
            if t == eos:
                break
            ref.append(int(t))
        if eos not in out[i]:
            while ref and ref[-1] == 0:
                ref.pop()
        got = [int(t) for t in res.tokens[i, :res.lengths[i]]]
        assert got == ref, (family, i)


def _jax_cli():
    from vlm_tpu.evaluation import Evaluator
    spec = importlib.util.spec_from_file_location(
        "jax_prompt_inference", REPO / "scripts" / "prompt_inference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.Evaluator = Evaluator
    return mod


def test_wave_cli_writes_vlm_tpus_values(ckpts, mivia_base, tmp_path,
                                         monkeypatch):
    """4 images in waves of 3 (the second padded), beams of 2, 6 tokens,
    both CLIs on the tiny PaliGemma checkpoint: the same texts from each
    wave, and the same files (random weights parse to no label)."""
    from vlm_tpu.data.dataset_factory import DatasetFactory
    from vlm_tpu.models.base_model import VLMModel as JaxModel
    from vlm_tpu_torch.models.base_model import VLMModel
    from vlm_tpu_torch.scripts import prompt_inference
    texts = {"jax": [], "port": []}
    for name, cls in (("jax", JaxModel), ("port", VLMModel)):
        def spy(self, *args, real=cls.generate_batch, name=name, **kw):
            texts[name].append(real(self, *args, **kw))
            return texts[name][-1]
        monkeypatch.setattr(cls, "generate_batch", spy)
    cfg = {"model_name": "paligemma", "model_size": "test",
           "model_id": str(ckpts["paligemma"][0]), "quantization": "fp32",
           "dataset_name": "MiviaPar", "continuous_batching": False,
           "num_beams": 2, "max_tokens": 6, "batch_size": 3,
           "dataset": {"base_path": str(mivia_base)},
           "prompts": {"MiviaPar": "colors?"}}
    monkeypatch.setenv("VLM_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("VLM_TPU_PALLAS_INTERPRET", "1")
    out = {}
    for name in ("jax", "port"):
        root = tmp_path / name
        (root / "configs").mkdir(parents=True)
        shutil.copy(REPO / "configs" / "task_datasets.yaml",
                    root / "configs")
        (root / "cfg.yaml").write_text(yaml.safe_dump(cfg))
        monkeypatch.setenv("VLM_TPU_ROOT", str(root))
        DatasetFactory.load_task_map(force=True)
        argv = ["--config", str(root / "cfg.yaml")]
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["prompt_inference.py", *argv])
            _jax_cli().main()
        else:
            summary = prompt_inference.main(argv)
            assert summary["images_completed"] == 4
            assert not summary["partial"]
        out[name] = root / "eval" / "prompt_inference" / "paligemma_fp32" / \
            "MiviaPar"
    assert texts["port"] == texts["jax"] and len(texts["port"]) == 2
    assert [len(t) for t in texts["port"]] == [3, 3]
    for f in ("preds.json", "gts.json", "metrics.json"):
        assert json.loads((out["port"] / f).read_text()) == \
            json.loads((out["jax"] / f).read_text()), f
    assert (out["port"] / "used_config.yaml").exists()
