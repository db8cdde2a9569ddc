#!/usr/bin/env python3
"""LLaVA-1.5-7B's 8bit depth-cut reference taken apart, on one NVIDIA
GPU: which part of the 8bit recipe carries the card's distance from the
CPU; prints one JSON line.

    python vlm_tpu_torch/testing/reference_parts.py [--model llava]

The depth-cut copy of ``chip_smoke.py``'s references (full widths, 2
vision and 2 decoder layers, random weights from seed 1, 2 images, a
prefill and 3 rotating-window decode steps), bf16 kernels on the card
against fp32 plain versions on the CPU (``chip_smoke._compare``: the worst
max |card - cpu| / max |cpu| over the logits), once for each part of the
recipe alone and once for the recipe whole:

- ``bf16``: no quantization (the floor: bf16 against fp32);
- ``int8_tower``: int8 vision weights only (the prefill's tower rows take
  B6 through ``VLM_TPU_INT8_PREFILL``'s mode);
- ``int8_decoder``: int8 decoder weights only, ``dynamic_noout`` (B6 at
  the prefill's rows, B5 at the decode steps);
- ``int8_decoder_dequant``: the same weights with ``dequant`` (the plain
  dequantized product at the prefill's rows: no activation quantization);
- ``int8_cache``: the int8 KV cache only (B2's and B3's int8 forms);
- ``recipe``: the 8bit reference as ``chip_smoke.py`` runs it (int8
  decoder weights, ``dynamic_noout``, the int8 cache).
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# part: (decoder bits, vision bits, int8 cache, VLM_TPU_INT8_PREFILL)
PARTS = {"bf16": (0, 0, False, None),
         "int8_tower": (0, 8, False, "dynamic_noout"),
         "int8_decoder": (8, 0, False, "dynamic_noout"),
         "int8_decoder_dequant": (8, 0, False, "dequant"),
         "int8_cache": (0, 0, True, None),
         "recipe": (8, 0, True, "dynamic_noout")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="llava")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("reference_parts: needs a CUDA device")
    import chip_smoke
    from vlm_tpu_torch.models.configs import VLM_CONFIGS
    from vlm_tpu_torch.models.layers import init_random_
    from vlm_tpu_torch.models.vlm import VLMModule, num_image_tokens
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.preprocess import RECIPES

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = chip_smoke.MODELS[args.model]
    full = VLM_CONFIGS[args.model](spec["size"])
    cfg = dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, layers=2),
        decoder=dataclasses.replace(full.decoder, layers=2))
    plen = spec["pre_ids"] + num_image_tokens(cfg) + chip_smoke.PROMPT_IDS
    out = {}
    for part, (bits, vbits, int8_cache, mode) in PARTS.items():
        if mode:
            os.environ["VLM_TPU_INT8_PREFILL"] = mode
        try:
            quant = dict(quant_bits=bits, vision_quant_bits=vbits)
            gpu_mod = VLMModule(cfg, dtype=torch.bfloat16, device="cuda",
                                **quant)
            cpu_mod = VLMModule(cfg, dtype=torch.float32, device="cpu",
                                **quant)
        finally:
            os.environ.pop("VLM_TPU_INT8_PREFILL", None)
        init_random_(gpu_mod, seed=1)
        cpu_mod.load_state_dict({
            k: (v.float() if v.is_floating_point() else v).cpu()
            for k, v in gpu_mod.state_dict().items()})
        caches = {"cuda": "int8", "cpu": "int8"} if int8_cache else \
            {"cuda": torch.bfloat16, "cpu": torch.float32}
        rng = np.random.default_rng(1)
        b, steps = 2, 3
        side = spec["image"]
        u8 = torch.from_numpy(rng.integers(0, 256, (b, side, side, 3),
                                           dtype=np.uint8))
        pre, post = (torch.from_numpy(rng.integers(3, 1000, (b, n),
                                                   dtype=np.int32))
                     for n in (spec["pre_ids"], chip_smoke.PROMPT_IDS))
        _lib.reset_counts()
        err = chip_smoke._compare(torch, gpu_mod, cpu_mod, cfg, u8, pre,
                                  post, plen, steps, caches,
                                  RECIPES[args.model], torch.bfloat16)
        out[part] = {"max_rel_err": err,
                     "launches": {k: v for k, v in _lib.launches.items()
                                  if v}}
        del gpu_mod, cpu_mod
        torch.cuda.empty_cache()
    print(json.dumps({"gpu": gpu, "model": spec["label"],
                      "tol": chip_smoke.REF_TOL, "parts": out}))


if __name__ == "__main__":
    main()
