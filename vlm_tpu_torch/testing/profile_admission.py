#!/usr/bin/env python3
"""B1's time at its two serving shapes and the device profile of one bf16
PaliGemma-3B admission, on one NVIDIA GPU; prints one JSON line.

    python vlm_tpu_torch/testing/profile_admission.py [--root DIR]
        [--admissions 3]

``--root`` is the checkout whose ``vlm_tpu_torch`` is measured (default:
this one), so one command can time two trees in turns with this script:
the port's public calls (``flash_attention``, ``create_model``,
``normalize_images``, ``VLMModule.prefill``) are the same in both.

- ``b1_ms``: device ms of ``flash_attention`` on the kernel checks' two
  on-path inputs (SigLIP [4, 16, 256, 72]; Gemma prefill [4, 8, 316, 256]
  MQA with kv_len [316, 290, 316, 0]), 20 calls queued behind a sleep
  kernel, timed with CUDA events;
- ``device_us``: µs a call of the kernels' own device time under
  ``torch.profiler`` (no event floor), for B1 and for SDPA
  (``scaled_dot_product_attention`` with the same boolean kv_len mask and
  ``enable_gqa``, the library yardstick) on the same inputs, 20 calls each;
- ``host_us``: the host's µs to enqueue one call, five runs of 200 calls
  behind a sleep kernel (so none waits on the card), sorted: B1's wrapper
  (``wrapper``), its C entry point alone with the wrapper's arguments
  (``c_call``: tensor maps and launch), and SDPA (``sdpa``);
- ``admission``: an admission of 4 images at full width and depth, random
  weights from seed 0: normalisation, tower, projector and Gemma prefill
  of the 316-token prompt into a 4-row cache. Host wall ms (synchronised,
  unprofiled) and, under ``torch.profiler``, the summed device time of the
  kernels (each kernel's own time, kernel rows only), their count, and B1's
  share, averaged over ``--admissions``.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

PROMPT_IDS, GROUP = 60, 4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--admissions", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_admission: needs a CUDA device")
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from vlm_tpu_torch.models.decoder import init_kv_cache
    from vlm_tpu_torch.models.factory import create_model
    from vlm_tpu_torch.models.vlm import num_image_tokens
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.attention import flash_attention
    from vlm_tpu_torch.ops.preprocess import normalize_images
    from vlm_tpu_torch.testing.kernel_checks import _SLEEP_CYCLES, _ms

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def bhsd(b, s, h, d):
        return torch.randn(b, s, h, d, generator=gen, device=dev).to(
            torch.bfloat16).transpose(1, 2)

    sig = [bhsd(GROUP, 256, 16, 72) for _ in range(3)]
    gem = [bhsd(GROUP, 316, 8, 256), bhsd(GROUP, 316, 1, 256),
           bhsd(GROUP, 316, 1, 256)]
    kvl = torch.tensor([316, 290, 316, 0], dtype=torch.int32, device=dev)
    mask = (torch.arange(316, device=dev)[None] < kvl[:, None])[:, None,
                                                                 None]
    calls = {"siglip": lambda: flash_attention(*sig),
             "gemma": lambda: flash_attention(*gem, kv_len=kvl)}
    sdpa = {"siglip": lambda: F.scaled_dot_product_attention(*sig),
            "gemma": lambda: F.scaled_dot_product_attention(
                *gem, attn_mask=mask, enable_gqa=True)}
    b1_ms = {k: _ms(fn, 20) for k, fn in calls.items()}

    def device_us(fn, n=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return sum(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")) / n

    def host_us(fn, n=200):
        fn()
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            torch.cuda._sleep(_SLEEP_CYCLES)
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            runs.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
        return sorted(runs)

    def c_call(fn):
        """The C entry point of ``fn``'s launch, bound to its arguments."""
        seen = []
        launch = _lib.launch
        _lib.launch = lambda *a: seen.append(a) or launch(*a)
        try:
            fn()
        finally:
            _lib.launch = launch
        _, name, *c_args = seen[0]
        entry = getattr(_lib.lib(), name)
        return lambda: entry(*c_args)

    device = {k: {"b1": device_us(calls[k]), "sdpa": device_us(sdpa[k])}
              for k in calls}
    host = {k: {"wrapper": host_us(calls[k]),
                "c_call": host_us(c_call(calls[k])),
                "sdpa": host_us(sdpa[k])} for k in calls}

    model = create_model("paligemma", quantization="bf16", size="3b",
                         device="cuda", seed=0)
    cfg = model.cfg
    rng = np.random.default_rng(0)
    u8 = torch.from_numpy(rng.integers(0, 256, (GROUP, 224, 224, 3),
                                       dtype=np.uint8)).to(dev)
    ids = torch.from_numpy(np.concatenate([[cfg.decoder.bos_token_id],
                                           rng.integers(3, 1000,
                                                        PROMPT_IDS - 1)])
                           ).to(dev, torch.int32)[None].expand(GROUP, -1)
    plen = num_image_tokens(cfg) + PROMPT_IDS

    def admission():
        cache = init_kv_cache(cfg.decoder, GROUP, plen + 32,
                              model.cache_dtype, "cuda")
        px = normalize_images(u8, recipe=model.recipe)
        return model.module.prefill(
            px, ids[:, :0], ids, cache,
            torch.full((GROUP,), plen, dtype=torch.int32, device=dev))

    with torch.inference_mode():
        admission()
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.admissions):
            t0 = time.perf_counter()
            admission()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.admissions):
                admission()
            torch.cuda.synchronize()

    n = args.admissions
    rows = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            rows.append((e.key, us / 1e3 / n, e.count / n))
    rows.sort(key=lambda r: -r[1])
    b1 = [r for r in rows if "flash_kernel" in r[0]]
    print(json.dumps({
        "root": args.root, "gpu": gpu, "b1_ms": b1_ms, "device_us": device,
        "host_us": host,
        "admission": {
            "wall_ms": walls, "device_ms": sum(r[1] for r in rows),
            "kernels": sum(r[2] for r in rows),
            "b1_device_ms": sum(r[1] for r in b1),
            "b1_launches": sum(r[2] for r in b1),
            "top": [(k[:60], round(ms, 4), c) for k, ms, c in rows[:8]]}}))


if __name__ == "__main__":
    main()
