"""The port stands without JAX: a fresh interpreter imports every module of
vlm_tpu_torch and runs three tiny slices end to end (model, batcher, every
op's CPU version: fp32, then 8bit with the int8 KV cache and a prompt long
enough for the llm.int8 prefill, then 4bit with an int4 tower), and neither jax, flax nor triton is ever
imported, nor is the kernel library built."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, json, pkgutil, sys
import numpy as np
import torch
torch.set_num_threads(1)
import vlm_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    vlm_tpu_torch.__path__, "vlm_tpu_torch."))
for m in mods:
    importlib.import_module(m)
from vlm_tpu_torch.generate.batcher import ContinuousBatcher
from vlm_tpu_torch.models.factory import create_model
from vlm_tpu_torch.models.vlm import num_image_tokens
from vlm_tpu_torch.ops import _lib
from vlm_tpu_torch.ops.preprocess import normalize_images
def serve(quantization, post, **kw):
    model = create_model("paligemma", quantization=quantization, size="test",
                         device="cpu", **kw)
    s = model.cfg.vision.image_size
    u8 = np.random.default_rng(0).integers(0, 256, (5, s, s, 3),
                                           dtype=np.uint8)
    plen = num_image_tokens(model.cfg) + len(post)
    return ContinuousBatcher(model.module, model.cfg, batch_size=2,
                             max_prompt_len=plen, max_new_tokens=3,
                             cache_dtype=model.cache_dtype).run(
        lambda idxs: normalize_images(torch.from_numpy(u8[idxs]),
                                      recipe=model.recipe,
                                      compute_dtype=model.dtype),
        pre_ids_row=np.zeros((0,), np.int32),
        post_ids_row=np.asarray(post, np.int32), prompt_len_scalar=plen,
        n_images=5)
out = serve("fp32", [2, 9])
# 2 x (16 + 250) = 532 prefill rows: the llm.int8 product
out8 = serve("8bit", [2] + [9] * 249, kv_cache="int8")
out4 = serve("4bit", [2, 9], quantize_vision=True)
print(json.dumps({
    "modules": mods, "tokens": out, "tokens8": out8, "tokens4": out4,
    "loaded": sorted(m for m in ("jax", "flax", "triton") if m in sys.modules),
    "plain_calls": _lib.plain_calls, "lib_loaded": _lib._lib is not None}))
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path,
                          env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path)},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert not res["lib_loaded"]
    assert {"vlm_tpu_torch.models.base_model", "vlm_tpu_torch.ops.kvcache",
            "vlm_tpu_torch.scripts.prompt_inference",
            "vlm_tpu_torch.testing.kernel_checks"} <= set(res["modules"])
    for toks in (res["tokens"], res["tokens8"], res["tokens4"]):
        assert len(toks) == 5
        assert all(t is not None and len(t) <= 3 for t in toks)
    assert min(res["plain_calls"].values()) > 0
