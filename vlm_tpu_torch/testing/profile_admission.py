#!/usr/bin/env python3
"""B1's and B2's times at their serving shapes and the device profile of
a bf16 and an fp32 PaliGemma-3B admission and of an fp32 decode step, on
one NVIDIA GPU; prints one JSON line.

    python vlm_tpu_torch/testing/profile_admission.py [--root DIR]
        [--admissions 3] [--model llava|blip2 [--modes 8bit,4bit]]

``--root`` is the checkout whose ``vlm_tpu_torch`` is measured (default:
this one), so one command can time two trees in turns with this script:
the port's public calls (``flash_attention``, ``decode_attention``,
``create_model``, ``normalize_images``, ``VLMModule.prefill`` and
``decode_step``) are the same in both.

- ``b1_ms``: device ms of ``flash_attention`` on the kernel checks' two
  on-path inputs (SigLIP [4, 16, 256, 72]; Gemma prefill [4, 8, 316, 256]
  MQA with kv_len [316, 290, 316, 0]), in bf16 and (``fp32_`` keys) in
  fp32, and in fp32 at the towers of later slices (``fp32_clip``: CLIP-L
  [4, 16, 577, 64]; ``fp32_eva``: EVA [4, 16, 257, 88]), 20 calls queued
  behind a sleep kernel, timed with CUDA events;
- ``device_us``: µs a call of the kernels' own device time under
  ``torch.profiler`` (no event floor), for B1 and for SDPA
  (``scaled_dot_product_attention`` with the same boolean kv_len mask and
  ``enable_gqa``, the library yardstick; fp32 without TF32) on the same
  inputs, 20 calls each; ``fp32_b2``: the same for ``decode_attention`` on
  an fp32 cache of 32 slots x 348 rows with the rotating window, after a
  128 MB flush (``cold``) and without (``warm``);
- ``host_us``: the host's µs to enqueue one bf16 call, five runs of 200
  calls behind a sleep kernel (so none waits on the card), sorted: B1's
  wrapper (``wrapper``), its C entry point alone with the wrapper's
  arguments (``c_call``: tensor maps and launch), and SDPA (``sdpa``);
- ``admission`` (bf16) and ``admission_fp32`` (the default quantization):
  an admission of 4 images at full width and depth, random weights from
  seed 0: normalisation, tower, projector and Gemma prefill of the
  316-token prompt into a 4-row cache. Host wall ms (synchronised,
  unprofiled) and, under ``torch.profiler``, the summed device time of the
  kernels (each kernel's own time, kernel rows only), their count, and
  B1's share, averaged over ``--admissions``;
- ``step_bf16`` and ``step_fp32``: one bf16 and one fp32 decode step over
  32 slots of a 348-row cache in the batcher's rotating-window form, the
  same readings a step (B2's share in place of B1's), over
  ``--admissions`` steps;
- in every admission and step: ``b3_launches`` and ``b4_launches``, the
  standalone B3 (``kv_write``) and B4 (``normalize``) kernels a run, by
  name. The admissions ask B4 for the patch embedding's layout where the
  measured tree's ``normalize_images`` takes ``patch_size``.

``--model llava`` measures LLaVA-1.5-7B's slice instead: B1 at CLIP-L
[4, 16, 577, 64] and at Vicuna's causal prefill [4, 32, 641, 128] (MHA,
kv_len [641, 641, 641, 600]) and B2 over the 32-slot MHA cache
[32, 673, 32, 128] (cold and warm), each beside SDPA (``b1_ms``,
``device_us``); then an admission of 4 images (BOS + 4 ids, 576 image
tokens, 60 ids: 641) and a decode step at full width and depth, random
weights, in bf16 (``admission``, ``step_bf16``: 32 slots) and in the 8bit
recipe (``admission_8bit``, ``step_8bit``: int8 decoder weights with
``VLM_TPU_INT8_PREFILL=dynamic_noout``, the int8 cache, 16 slots).
``--model blip2`` the same for BLIP-2 OPT-6.7B: B1 at EVA [4, 16, 257,
88], at the Q-Former's self-attention [4, 12, 32, 64] and cross-attention
(32 queries over 257 image tokens) and at OPT's causal prefill [4, 32, 92,
128] (kv_len [92, 92, 92, 80]), B2 over the 32-slot cache [32, 124, 32,
128]; the admissions (32 query tokens, BOS + 59 ids: 92) and decode steps
in bf16 (groups of 4, 32 slots) and in the 8bit recipe (int8 decoder and
tower, ``dynamic_noout``, the int8 cache; groups of 8, 64 slots).
Both models' admissions and steps then run in ``4bit`` too (int4
decoder weights, BLIP-2's tower too, the bf16 cache, 32 slots;
``admission_4bit``, ``step_4bit``: each step's ``top`` kernels show B7,
``stream_kernel``, beside B2) and LLaVA's in ``fp32`` (the default
quantization, 16 slots): every mode of the model's ``slots``, or those of
``--modes``.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

PROMPT_IDS, GROUP = 60, 4
# the decode window of the kernel checks: 32 slots, a 316-row prompt and 32
# new tokens
SLOTS, PROMPT, NEW = 32, 316, 32
CACHE = PROMPT + NEW
# the MHA slices: image side, ids before the image tokens, the prompt, the
# slots and admission group of each mode, whether the 8bit recipe
# quantizes the tower, and B1's bf16 inputs of an admission of 4: (Sq, Sk,
# heads, head dim, and for a causal prefill the last row's kv_len)
SLICES = {
    # LLaVA-1.5-7B: 336 px, BOS + 4 ids before the 576 image tokens
    "llava": dict(image=336, pre_ids=5, prompt=641,
                  slots={"bf16": 32, "8bit": 16, "4bit": 32, "fp32": 16},
                  group={"bf16": 4, "8bit": 4, "4bit": 4, "fp32": 4},
                  quantize_vision=False,
                  b1={"clip": (577, 577, 16, 64, None),
                      "vicuna": (641, 641, 32, 128, 600)}),
    # BLIP-2 OPT-6.7B: 224 px, the 32 query tokens, then BOS + 59 ids
    "blip2": dict(image=224, pre_ids=0, prompt=92,
                  slots={"bf16": 32, "8bit": 64, "4bit": 32},
                  group={"bf16": 4, "8bit": 8, "4bit": 4},
                  quantize_vision=True,
                  b1={"eva": (257, 257, 16, 88, None),
                      "qformer_self": (32, 32, 12, 64, None),
                      "qformer_cross": (32, 257, 12, 64, None),
                      "opt": (92, 92, 32, 128, 80)}),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--admissions", type=int, default=3)
    ap.add_argument("--model", choices=("paligemma", "llava", "blip2"),
                    default="paligemma")
    ap.add_argument("--modes", default="",
                    help="comma-separated modes of --model's (default all)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_admission: needs a CUDA device")
    if args.model != "paligemma":
        return main_mha(torch, args)
    import torch.nn.functional as F

    from vlm_tpu_torch.models.factory import create_model
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.attention import flash_attention
    from vlm_tpu_torch.ops.decode_attention import (decode_attention,
                                                    live_rows)
    from vlm_tpu_torch.testing.kernel_checks import (_SLEEP_CYCLES,
                                                     _device_ms, _ms,
                                                     _profiled)

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
        return _device_us(torch, fn, n)

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

    # fp32 (no TF32 anywhere): B1 at the same shapes, B2 over the window
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sig32 = [x.float() for x in sig]
    gem32 = [x.float() for x in gem]
    clip32 = [bhsd(GROUP, 577, 16, 64).float() for _ in range(3)]
    eva32 = [bhsd(GROUP, 257, 16, 88).float() for _ in range(3)]
    calls32 = {"fp32_siglip": lambda: flash_attention(*sig32),
               "fp32_gemma": lambda: flash_attention(*gem32, kv_len=kvl),
               "fp32_clip": lambda: flash_attention(*clip32),
               "fp32_eva": lambda: flash_attention(*eva32)}
    sdpa32 = {"fp32_siglip": lambda: F.scaled_dot_product_attention(*sig32),
              "fp32_gemma": lambda: F.scaled_dot_product_attention(
                  *gem32, attn_mask=mask, enable_gqa=True),
              "fp32_clip": lambda: F.scaled_dot_product_attention(*clip32),
              "fp32_eva": lambda: F.scaled_dot_product_attention(*eva32)}
    b1_ms.update({k: _ms(fn, 20) for k, fn in calls32.items()})
    device.update({k: {"b1": device_us(calls32[k]),
                       "sdpa": device_us(sdpa32[k])} for k in calls32})
    i32 = dict(dtype=torch.int32, device=dev)
    qd = torch.randn(SLOTS, 1, 8, 256, generator=gen, device=dev).transpose(
        1, 2)
    kc = torch.randn(SLOTS, CACHE, 1, 256, generator=gen, device=dev)
    vc = torch.randn(SLOTS, CACHE, 1, 256, generator=gen, device=dev)
    acol = torch.randint(0, NEW, (SLOTS,), generator=gen, device=dev).int()
    gcnt = torch.randint(1, NEW + 1, (SLOTS,), generator=gen,
                         device=dev).int()
    window = (torch.tensor(PROMPT, **i32), NEW, acol, gcnt)
    live = live_rows(SLOTS, CACHE, dev, kv_window=window)[:, None, None]
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    fl_kernels = frozenset(_profiled(flush.zero_))
    b2 = lambda: decode_attention(qd, kc, vc, kv_window=window)  # noqa: E731
    b2_sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qd, kc.transpose(1, 2), vc.transpose(1, 2), attn_mask=live,
        enable_gqa=True)
    device["fp32_b2"] = {
        "cold": {"b2": _device_ms(b2, 20, flush, fl_kernels) * 1e3,
                 "sdpa": _device_ms(b2_sdpa, 20, flush, fl_kernels) * 1e3},
        "warm": {"b2": device_us(b2), "sdpa": device_us(b2_sdpa)}}
    del flush, kc, vc

    out = {"root": args.root, "gpu": gpu, "b1_ms": b1_ms,
           "device_us": device, "host_us": host}
    for quantization in ("bf16", "fp32"):
        kw = dict(quantization="bf16") if quantization == "bf16" else {}
        model = create_model("paligemma", size="3b", device="cuda", seed=0,
                             **kw)
        key = "admission" if quantization == "bf16" else "admission_fp32"
        out[key] = profile_admission(torch, model, args.admissions)
        out[f"step_{quantization}"] = profile_step(torch, model,
                                                   args.admissions, gen)
        del model
        torch.cuda.empty_cache()
    print(json.dumps(out))


def _device_us(torch, fn, n=20):
    """µs a call of ``fn``'s kernels' own device time, ``n`` calls under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
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


def main_mha(torch, args):
    """``--model llava`` or ``blip2``: B1 and B2 at the model's shapes
    beside SDPA, then a bf16 and an 8bit admission and decode step."""
    import torch.nn.functional as F

    from vlm_tpu_torch.models.factory import create_model
    from vlm_tpu_torch.ops.attention import flash_attention
    from vlm_tpu_torch.ops.decode_attention import (decode_attention,
                                                    live_rows)
    from vlm_tpu_torch.testing.kernel_checks import (_device_ms, _ms,
                                                     _profiled)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    i32 = dict(dtype=torch.int32, device=dev)

    def bshd(b, s, h, d):
        return torch.randn(b, s, h, d, generator=gen, device=dev).to(
            torch.bfloat16)

    spec = SLICES[args.model]
    lp = spec["prompt"]
    calls, sdpa = {}, {}
    for name, (sq, sk, h, d, last) in spec["b1"].items():
        qkv = [bshd(GROUP, n, h, d).transpose(1, 2) for n in (sq, sk, sk)]
        if last is None:
            calls[name] = lambda qkv=qkv: flash_attention(*qkv)
            sdpa[name] = lambda qkv=qkv: F.scaled_dot_product_attention(*qkv)
            continue
        kvl = torch.tensor([sk] * (GROUP - 1) + [last], **i32)
        causal = (torch.arange(sk, device=dev)[None, :] <=
                  torch.arange(sq, device=dev)[:, None] + (sk - sq))
        mask = causal[None, None] & (torch.arange(sk, device=dev)[None, :] <
                                     kvl[:, None])[:, None, None]
        calls[name] = lambda qkv=qkv, kvl=kvl: flash_attention(
            *qkv, causal=True, kv_len=kvl)
        sdpa[name] = lambda qkv=qkv, mask=mask: \
            F.scaled_dot_product_attention(*qkv, attn_mask=mask)
    slots, cache_rows = spec["slots"]["bf16"], lp + NEW
    qd = bshd(slots, 1, 32, 128).transpose(1, 2)
    kc, vc = bshd(slots, cache_rows, 32, 128), bshd(slots, cache_rows, 32,
                                                    128)
    acol = torch.randint(0, NEW, (slots,), generator=gen, device=dev).int()
    gcnt = torch.randint(1, NEW + 1, (slots,), generator=gen,
                         device=dev).int()
    window = (torch.tensor(lp, **i32), NEW, acol, gcnt)
    live = live_rows(slots, cache_rows, dev, kv_window=window)[:, None, None]
    calls["b2"] = lambda: decode_attention(qd, kc, vc, kv_window=window)
    sdpa["b2"] = lambda: F.scaled_dot_product_attention(
        qd, kc.transpose(1, 2), vc.transpose(1, 2), attn_mask=live)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    fl_kernels = frozenset(_profiled(flush.zero_))
    b1_ms = {k: _ms(fn, 20) for k, fn in calls.items()}
    device = {k: {"kernel": _device_us(torch, calls[k]),
                  "sdpa": _device_us(torch, sdpa[k])} for k in calls}
    device["b2_cold"] = {
        "kernel": _device_ms(calls["b2"], 20, flush, fl_kernels) * 1e3,
        "sdpa": _device_ms(sdpa["b2"], 20, flush, fl_kernels) * 1e3}
    del flush, kc, vc, calls, sdpa
    out = {"root": args.root, "gpu": gpu, "model": args.model,
           "b1_ms": b1_ms, "device_us": device}
    modes = args.modes.split(",") if args.modes else list(spec["slots"])
    for quantization in modes:
        kw = dict(quantization=quantization)
        if quantization in ("8bit", "4bit"):
            kw.update(quantize_vision=spec["quantize_vision"])
        if quantization == "8bit":
            kw.update(kv_cache="int8")
            os.environ["VLM_TPU_INT8_PREFILL"] = "dynamic_noout"
        try:
            model = create_model(args.model, device="cuda", seed=0, **kw)
        finally:
            os.environ.pop("VLM_TPU_INT8_PREFILL", None)
        key = "admission" if quantization == "bf16" else \
            f"admission_{quantization}"
        out[key] = profile_admission(torch, model, args.admissions,
                                     image=spec["image"],
                                     pre_ids=spec["pre_ids"],
                                     group=spec["group"][quantization])
        out[f"step_{quantization}"] = profile_step(
            torch, model, args.admissions, gen,
            slots=spec["slots"][quantization], prompt=lp)
        del model
        torch.cuda.empty_cache()
    print(json.dumps(out))


def _device_rows(prof, n):
    """(kernel, device ms a run, launches a run), kernel rows only, largest
    first, from a profile of ``n`` runs."""
    rows = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            rows.append((e.key, us / 1e3 / n, e.count / n))
    return sorted(rows, key=lambda r: -r[1])


def _profile_runs(torch, run, n, mark):
    """Host wall ms of ``n`` synchronised runs of ``run``, then the
    summed device ms a run under ``torch.profiler``, the kernel count, and
    the device ms and launches of the kernels whose name holds ``mark``."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(n):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                run()
            torch.cuda.synchronize()
    rows = _device_rows(prof, n)
    mine = [r for r in rows if any(m in r[0] for m in mark)]
    return {"wall_ms": walls, "device_ms": sum(r[1] for r in rows),
            "kernels": sum(r[2] for r in rows),
            "kernel_ms": sum(r[1] for r in mine),
            "kernel_launches": sum(r[2] for r in mine),
            "b3_launches": sum(r[2] for r in rows if "kv_write" in r[0]),
            "b4_launches": sum(r[2] for r in rows
                               if "normalize_kernel" in r[0]),
            "top": [(k[:60], round(ms, 4), c) for k, ms, c in rows[:8]]}


def profile_admission(torch, model, n, image=224, pre_ids=0, group=GROUP):
    """An admission of ``group`` images of side ``image`` into a fresh
    cache, with ``pre_ids`` ids (BOS first) before the image tokens and
    ``PROMPT_IDS`` after them (BOS first where none come before); B1's
    kernels under ``kernel_ms``: the bf16 ``flash_kernel`` or the fp32
    ``flash_fp32_kernel``."""
    import numpy as np

    from vlm_tpu_torch.models.decoder import init_kv_cache
    from vlm_tpu_torch.models.vlm import num_image_tokens
    from vlm_tpu_torch.ops.preprocess import normalize_images
    dev = torch.device("cuda")
    cfg = model.cfg
    rng = np.random.default_rng(0)
    u8 = torch.from_numpy(rng.integers(0, 256, (group, image, image, 3),
                                       dtype=np.uint8)).to(dev)

    def ids(n, bos):
        row = np.concatenate([[cfg.decoder.bos_token_id] if bos else [],
                              rng.integers(3, 1000, n - bos)])
        return torch.from_numpy(row).to(dev, torch.int32)[None].expand(
            group, -1)
    pre = ids(pre_ids, True) if pre_ids else ids(0, False)
    post = ids(PROMPT_IDS, not pre_ids)
    plen = pre_ids + num_image_tokens(cfg) + PROMPT_IDS
    patch = dict(patch_size=cfg.vision.patch_size) if "patch_size" in \
        inspect.signature(normalize_images).parameters else {}

    def admission():
        cache = init_kv_cache(cfg.decoder, group, plen + NEW,
                              model.cache_dtype, "cuda")
        px = normalize_images(u8, recipe=model.recipe,
                              compute_dtype=model.dtype, **patch)
        return model.module.prefill(
            px, pre, post, cache,
            torch.full((group,), plen, dtype=torch.int32, device=dev))

    got = _profile_runs(torch, admission, n, ("flash_kernel",
                                              "flash_fp32_kernel"))
    got["b1_device_ms"] = got.pop("kernel_ms")
    got["b1_launches"] = got.pop("kernel_launches")
    return got


def profile_step(torch, model, n, gen, slots=SLOTS, prompt=PROMPT):
    """One decode step over ``slots`` slots of a cache of ``prompt`` +
    ``NEW`` rows in the rotating-window form (B2's kernels under
    ``kernel_ms``)."""
    from vlm_tpu_torch.models.decoder import init_kv_cache
    dev = torch.device("cuda")
    i32 = dict(dtype=torch.int32, device=dev)
    cache = init_kv_cache(model.cfg.decoder, slots, prompt + NEW,
                          model.cache_dtype, "cuda")
    tok = torch.randint(3, 1000, (slots, 1), generator=gen, device=dev,
                        dtype=torch.int32)
    acol = torch.randint(0, NEW, (slots,), generator=gen, device=dev,
                         dtype=torch.int32)
    gcnt = torch.randint(1, NEW, (slots,), generator=gen, device=dev,
                         dtype=torch.int32)
    pos = torch.full((slots,), prompt + 8, **i32)

    def one():
        return model.module.decode_step(
            tok, pos, cache, write_col=torch.tensor(prompt + 7, **i32),
            kv_window=(torch.tensor(prompt, **i32), NEW, acol, gcnt))

    got = _profile_runs(torch, one, n, ("decode_fp32_kernel",
                                        "decode_kernel"))
    got["b2_device_ms"] = got.pop("kernel_ms")
    got["b2_launches"] = got.pop("kernel_launches")
    return got


if __name__ == "__main__":
    main()
