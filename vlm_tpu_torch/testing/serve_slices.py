#!/usr/bin/env python3
"""Serve the four ``chip_smoke.py`` slices (bf16; 8bit with the int8 KV
cache; 4bit; fp32, the default quantization, at its own smaller size) of
one checkout on one NVIDIA GPU, without the kernel checks and the
reference phases; prints each slice's lines and one JSON line.

    python vlm_tpu_torch/testing/serve_slices.py [--root DIR]
        [--model paligemma|llava|blip2]

``--root`` is the checkout whose ``chip_smoke.py`` and ``vlm_tpu_torch``
are run (default: this one), so that one command can serve two trees in
turns, parent and change alternating, with the same traffic. The JSON
line holds, for each slice, the images per second and the per-image
latency p50 and p99 in ms, as the slice printed them. ``--model llava``
serves LLaVA-1.5-7B's two slices instead: bf16 (32 slots) and the 8bit
recipe (16 slots, the int8 KV cache, ``dynamic_noout``); ``--model blip2``
BLIP-2 OPT-6.7B's two: bf16 (32 slots, admissions of 4) and the 8bit
recipe (64 slots, admissions of 8, the int8 KV cache and tower,
``dynamic_noout``).
"""

import argparse
import contextlib
import io
import json
import re
import sys
from pathlib import Path

LATENCY = re.compile(r"latency p50 ([0-9.]+) ms p99 ([0-9.]+) ms")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--model", choices=("paligemma", "llava", "blip2"),
                    default="paligemma")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("serve_slices: needs a CUDA device")
    import chip_smoke

    gpu = chip_smoke.device_phase(torch)
    result = {"root": args.root, "gpu": gpu, "model": args.model}
    modes = ("bf16", "8bit") if args.model != "paligemma" else (
        "bf16", "8bit", "4bit", "fp32")
    for mode in modes:
        size = dict(n_images=chip_smoke.FP32_IMAGES,
                    new=chip_smoke.FP32_NEW) if mode == "fp32" else {}
        if args.model != "paligemma":     # trees before LLaVA's slice
            size["model_name"] = args.model   # serve PaliGemma only
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            _, stats = chip_smoke.slice_phase(torch, np, gpu, mode, **size)
        print(out.getvalue(), end="")
        p50, p99 = LATENCY.search(out.getvalue()).groups()
        result[mode] = {"img_per_s": stats["img_per_s"],
                        "p50_ms": float(p50), "p99_ms": float(p99)}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
