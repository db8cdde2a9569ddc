#!/usr/bin/env python3
"""Serve the four ``chip_smoke.py`` slices (bf16; 8bit with the int8 KV
cache; 4bit; fp32, the default quantization, at its own smaller size) of
one checkout on one NVIDIA GPU, without the kernel checks and the
reference phases; prints each slice's lines and one JSON line.

    python vlm_tpu_torch/testing/serve_slices.py [--root DIR]
        [--model paligemma|llava|blip2] [--modes bf16,8bit,...] [--profile]

``--root`` is the checkout whose ``chip_smoke.py`` and ``vlm_tpu_torch``
are run (default: this one), so that one command can serve two trees in
turns, parent and change alternating, with the same traffic. The JSON
line holds, for each slice, the images per second and the per-image
latency p50 and p99 in ms, as the slice printed them, and the timed run's
loop: its decode steps (and guarded steps, where the tree has them),
chunks and blocking reads an image. A blocking read is a synchronizing
CUDA operation that ``torch.cuda.set_sync_debug_mode`` reports (``.item()``,
``.cpu()``, an upload from pageable memory) or one the batcher counts as
its own (``last_stats["blocking_reads"]``: event waits, which the debug
mode does not see). ``--profile`` runs the timed run under
``torch.profiler`` and adds the device's kernel ms and their mean over
the dispatched steps (admissions included); the profiler's own cost
inflates that run's wall several times (its img/s is not the tree's), so
the host's share is 1 - device ms / the wall of an unprofiled run of the
same tree. ``--model llava`` serves LLaVA-1.5-7B's two
slices instead: bf16 (32 slots) and the 8bit recipe (16 slots, the int8
KV cache, ``dynamic_noout``); ``--model blip2`` BLIP-2 OPT-6.7B's two:
bf16 (32 slots, admissions of 4) and the 8bit recipe (64 slots,
admissions of 8, the int8 KV cache and tower, ``dynamic_noout``);
``--modes`` serves a subset.
"""

import argparse
import contextlib
import io
import json
import re
import sys
import time
import warnings
from pathlib import Path

LATENCY = re.compile(r"latency p50 ([0-9.]+) ms p99 ([0-9.]+) ms")


def instrument(torch, batcher_cls, profile):
    """Wrap ``batcher_cls.run``: each call's blocking reads, loop counters
    and (``profile``) device ms; returns the list of call records."""
    calls = []
    real = batcher_cls.run

    def run(self, *args, **kw):
        rec = {"n_images": kw.get("n_images")}
        prof = None
        if profile and rec["n_images"] != 8:          # not the warm-up
            from torch.profiler import ProfilerActivity
            prof = torch.profiler.profile(
                activities=[ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            with warnings.catch_warnings(record=True) as caught, \
                    (prof or contextlib.nullcontext()):
                warnings.simplefilter("always")
                out = real(self, *args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        st = dict(self.last_stats)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        rec.update(steps=st["steps"], chunks=st["chunks"],
                   guarded_steps=st.get("guarded_steps", 0),
                   sync_ops=syncs,
                   blocking_reads=syncs + st.get("blocking_reads", 0))
        if prof is not None:
            dev = sum(e.self_device_time_total for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA"))
            rec["device_ms"] = dev / 1e3
        calls.append(rec)
        return out

    batcher_cls.run = run
    return calls


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--model", choices=("paligemma", "llava", "blip2"),
                    default="paligemma")
    ap.add_argument("--modes", default=None,
                    help="comma-separated subset of the model's modes")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("serve_slices: needs a CUDA device")
    import chip_smoke
    from vlm_tpu_torch.generate.batcher import ContinuousBatcher

    gpu = chip_smoke.device_phase(torch)
    result = {"root": args.root, "gpu": gpu, "model": args.model,
              "profile": args.profile}
    modes = ("bf16", "8bit") if args.model != "paligemma" else (
        "bf16", "8bit", "4bit", "fp32")
    if args.modes:
        modes = [m for m in modes if m in args.modes.split(",")]
    calls = instrument(torch, ContinuousBatcher, args.profile)
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
        timed = calls[-1]
        n = timed["n_images"]
        dispatched = timed["steps"] + timed["guarded_steps"]
        row = {"img_per_s": stats["img_per_s"], "p50_ms": float(p50),
               "p99_ms": float(p99), "images": n, "steps": timed["steps"],
               "guarded_steps": timed["guarded_steps"],
               "chunks": timed["chunks"],
               "blocking_reads": timed["blocking_reads"],
               "sync_ops": timed["sync_ops"],
               "blocking_reads_per_image": timed["blocking_reads"] / n,
               "guarded_steps_per_image": timed["guarded_steps"] / n}
        if "device_ms" in timed:
            row.update(device_ms=timed["device_ms"],
                       profiled_wall_ms=timed["wall_s"] * 1e3,
                       step_device_ms=timed["device_ms"] / dispatched)
        result[mode] = row
    print(json.dumps(result))


if __name__ == "__main__":
    main()
