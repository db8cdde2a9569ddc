#!/usr/bin/env python3
"""B1's and B2's kernel checks at their small head dims and few heads, and
the device ms of the decode steps and admissions they serve, on one NVIDIA
GPU; prints one JSON line.

    python vlm_tpu_torch/testing/profile_attention.py [--root DIR]
        [--no-steps] [--steps 3]

``--root`` is the checkout whose ``vlm_tpu_torch`` is measured (default:
this one), so one command can time two trees in turns (parent, change,
change, parent): the public calls and the seeded inputs are the same in
both.

- ``checks``: the measured checkout's kernel checks
  (``testing/kernel_checks.py``, timed as ``chip_smoke.py`` times them: 20
  calls a version) of every B1 case in bf16 at a head dim of 96 or less
  (the towers, the Q-Former, the mesh's SigLIP shard, the shapes off the
  path), every B2 case and every fused write (B3 inside B2) in bf16 or
  int8 with fewer than 8 query heads a KV head (LLaVA's and BLIP-2's
  windows, the sweep's, the mesh's 4 heads over one, the shapes off the
  path), and the controls (``CONTROLS``): B1 at D = 128 and 256 and in
  fp32, B2 at G = 8 and in fp32. Each case: ``ms`` (events), ``us``
  (profiled), ``library_ms`` and ``library_us`` (SDPA where one call
  computes the function), ``bound_us`` and ``share`` (bound over events),
  ``ok`` and ``max_abs_err``;
- ``steps`` (unless ``--no-steps``): device ms under ``torch.profiler``
  (``profile_admission.py``'s readings: the kernels' own time, their
  count, B1's or B2's share) of LLaVA-1.5-7B's bf16 decode step (32
  slots) and admission of 4, its 8bit step (16 slots, int8 cache,
  ``dynamic_noout``), BLIP-2 OPT-6.7B's bf16 (32 slots) and 8bit (64
  slots, int8 tower and cache) steps, and PaliGemma-3B's wave prefill
  (an admission of 32 images, bf16): full width and depth, random weights
  from seed 0, ``--steps`` runs each.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# B1 in bf16 at D <= 96 and B2 / the fused write at G < 8, by case name
# (the same in the parent and the change)
B1_SMALL = ("siglip", "clip_l336", "eva", "qformer", "gqa_g4_contiguous",
            "d42_padded", "tp_siglip")
B2_FEW = ("llava_", "blip2_", "vicuna_", "opt_", "tp_", "mha_g1", "gqa_g4_d64")
# the forms that keep their code: B1 at D = 128 and 256 and in fp32, B2 at
# G = 8 (Gemma's window, the mesh's data=2 rank) and in fp32
CONTROLS = ("B1 gemma_prefill_g4_s316_kvlen",
            "B1 vicuna_prefill_g4_h32_s641_d128_kvlen",
            "B1 fp32_siglip_g4_h16_s256_d72",
            "B1 fp32_clip_l336_g4_h16_s577_d64",
            "B2 window_32slots_cold", "B2 window_32slots_int8_cold",
            "B2 dp_window_16slots_h8_cold", "B2 fp32_window_32slots_cold",
            "B2 fp32_llava_window_16slots_cold")


def selected(kernel: str, case: str) -> bool:
    """A case this tool times: its form changed, or a control."""
    if f"{kernel} {case}" in CONTROLS:
        return True
    if "fp32" in case:
        return False
    if kernel == "B1":
        return case.startswith(B1_SMALL)
    return kernel in ("B2", "B3") and case.startswith(B2_FEW) and (
        kernel == "B2" or "fused" in case)


def checks():
    from vlm_tpu_torch.testing import kernel_checks
    every = kernel_checks.cases
    kernel_checks.cases = lambda device: [
        c for c in every(device) if selected(c.kernel, c.case)]
    try:
        records = kernel_checks.run("cuda", iters=20)
    finally:
        kernel_checks.cases = every

    def us(ms):
        return None if ms is None else ms * 1e3
    return {f"{r['kernel']} {r['case']}": {
        "form": r["form"], "ok": r["ok"], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "us": us(r["device_ms"]),
        "library_ms": r["library_ms"], "library_us": us(
            r["library_device_ms"]),
        "bound_us": r["bound_ms"] * 1e3, "bound_by": r["bound_by"],
        "share": r["bound_ms"] / r["ms"]} for r in records}


def steps(torch, n):
    from vlm_tpu_torch.models.factory import create_model
    from vlm_tpu_torch.testing.profile_admission import (SLICES,
                                                         profile_admission,
                                                         profile_step)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {}
    runs = (("llava", "bf16", True), ("llava", "8bit", False),
            ("blip2", "bf16", False), ("blip2", "8bit", False))
    for model_name, mode, admission in runs:
        spec = SLICES[model_name]
        kw = dict(quantization=mode)
        if mode == "8bit":
            kw.update(kv_cache="int8", quantize_vision=spec["quantize_vision"])
            os.environ["VLM_TPU_INT8_PREFILL"] = "dynamic_noout"
        try:
            model = create_model(model_name, device="cuda", seed=0, **kw)
        finally:
            os.environ.pop("VLM_TPU_INT8_PREFILL", None)
        if admission:
            out[f"{model_name}_{mode}_admission"] = profile_admission(
                torch, model, n, image=spec["image"], pre_ids=spec["pre_ids"],
                group=spec["group"][mode])
        out[f"{model_name}_{mode}_step"] = profile_step(
            torch, model, n, gen, slots=spec["slots"][mode],
            prompt=spec["prompt"])
        del model
        torch.cuda.empty_cache()
    model = create_model("paligemma", size="3b", quantization="bf16",
                         device="cuda", seed=0)
    out["paligemma_bf16_wave_prefill"] = profile_admission(torch, model, n,
                                                           group=32)
    del model
    torch.cuda.empty_cache()
    for row in out.values():
        row.pop("top", None)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--no-steps", action="store_true")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_attention: needs a CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    out = {"root": args.root, "gpu": gpu, "checks": checks()}
    if not args.no_steps:
        out["steps"] = steps(torch, args.steps)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
