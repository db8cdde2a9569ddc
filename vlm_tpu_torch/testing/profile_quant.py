#!/usr/bin/env python3
"""B5's and B7's times at the serving paths' shapes and the device profile
of an 8bit and a 4bit PaliGemma-3B decode step, on one NVIDIA GPU; prints
one JSON line.

    python vlm_tpu_torch/testing/profile_quant.py [--root DIR] [--plans]

``--root`` is the checkout whose ``vlm_tpu_torch`` is measured (default:
this one), so one command can time two trees in turns: the public calls
(``int8_matmul``, ``int4_matmul``, ``create_model``, ``decode_step``) are
the same in both, and so are the inputs (seeded).

- ``gemm``: for each product (B5 and B7 at Gemma's gate/up, down, q/o and
  k/v with m = 1, 16, 32 and 316 rows, and the SigLIP MLP at m = 256, B7's
  fc2 at group 16; m = 1 and 16 run the same 16-row tile, the same
  products and shared-memory stores, and differ only in the rows of x read
  from L2), ``ms``: device ms a call by CUDA events (20 calls behind a
  sleep kernel, the L2 cache flushed before each) and ``us``: µs a call of
  the kernels' own device time under ``torch.profiler``, both after a flush
  that writes 128 MB (the L2 left full of dirty lines, which the call then
  writes back), and ``us_clean``: the same after a flush that only reads
  128 MB (the L2 left clean); ``read_us``: for each weight format, the
  profiled µs of one plain PyTorch read of the same weight bytes (the
  maximum over them as int64) after the reading flush, the practical floor
  of a kernel that streams them;
- ``plans`` (with ``--plans``, this checkout only): for each product and
  format, the profiled µs of every tile (the plan's rows by 64 or 128
  columns) and split count (1-8, each whose splits are all non-empty) the
  C entry takes, called directly, beside the one ``stream_plan`` picks;
  each checked against the plain version (``None``: it disagreed, or the
  profiler saw no kernel); and ``clusters``, the device's table of how
  many clusters of 1-8 blocks run at once (``_lib.max_clusters``);
- ``step``: one decode step of the full-width, full-depth model (random
  weights from seed 0) over 32 slots (``8bit``, ``4bit``) and over one
  (``8bit_m1``, ``4bit_m1``) of a 348-row cache in the batcher's
  rotating-window form, 8bit with the int8 KV cache and 4bit: host wall ms
  of each of ``STEPS`` steps (synchronised, unprofiled) and, under
  ``torch.profiler``, the summed device ms of the kernels a step, their
  count, the standalone B3 kernels among them (``b3_launches``) and the
  largest items; then ``in_place``: the µs a step of B5's
  or B7's kernels at each Gemma product (gate and up, down, q and o, k and
  v; 18 layers) where the step runs them, after the product before it and
  with no flush, from a second profiled run whose calls of
  ``ops.quant.int8_matmul`` / ``int4_matmul`` are each wrapped in a
  ``record_function`` range named by the product (the range's span on the
  device's timeline: its one kernel).
"""

import argparse
import json
import subprocess
import sys
import time
import types
from pathlib import Path

SLOTS, PROMPT, NEW = 32, 316, 32
STEPS = 10
GEMMA_KN = {"gate_up": (2048, 16384), "down": (16384, 2048),
            "q_o": (2048, 2048), "k_v": (2048, 256)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_quant: needs a CUDA device")
    from vlm_tpu_torch.models.factory import create_model
    from vlm_tpu_torch.ops.quant import int4_matmul, int8_matmul
    from vlm_tpu_torch.testing.kernel_checks import (_device_ms, _ms,
                                                     _profiled)

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    flush_kernels = frozenset(_profiled(flush.zero_))

    # a flush by reading: its "zero_" reads the buffer's maximum
    read_flush = types.SimpleNamespace(zero_=lambda: flush.max())
    read_kernels = frozenset(_profiled(read_flush.zero_))

    def timed(fn):
        return {"ms": _ms(fn, 20, flush),
                "us": _device_ms(fn, 20, flush, flush_kernels) * 1e3,
                "us_clean": _device_ms(fn, 20, read_flush,
                                       read_kernels) * 1e3}

    products = []
    for name, (k, n) in GEMMA_KN.items():
        for m in (1, 16, SLOTS, PROMPT):
            products.append((f"{name}_m{m}", m, k, n, 128))
    products += [("siglip_fc1_m256", 256, 1152, 4304, 128),
                 ("siglip_fc2_m256", 256, 4304, 1152, 16)]
    gemm = {}
    for case, m, k, n, gs in products:
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        q8 = torch.randint(-127, 128, (n, k), generator=gen,
                           device=dev).to(torch.int8)
        s8 = torch.rand(n, generator=gen, device=dev) / (64 * k ** 0.5)
        q4 = torch.randint(-128, 128, (n, k // 2), generator=gen,
                           device=dev).to(torch.int8)
        s4 = (0.5 + torch.rand(n, k // gs, generator=gen, device=dev)) / (
            4 * k ** 0.5)
        gemm[case] = {
            "b5": timed(lambda: int8_matmul(x, q8, s8)),
            "b7": timed(lambda: int4_matmul(x, q4, s4, gs)),
            "read_us": {f: _device_ms(lambda: w.view(torch.int64).max(), 20,
                                      read_flush, read_kernels) * 1e3
                        for f, w in (("int8", q8), ("int4", q4))}}
        if args.plans:
            gemm[case]["plans"] = plans(torch, m, n, k, gs, x, q8, s8, q4, s4,
                                        lambda fn: _device_ms(
                                            fn, 10, flush, flush_kernels))

    step = {}
    for mode in ("8bit", "4bit"):
        model = create_model("paligemma", quantization=mode, size="3b",
                             device="cuda", seed=0,
                             kv_cache="int8" if mode == "8bit" else None)
        for slots in (SLOTS, 1):
            key = mode if slots == SLOTS else f"{mode}_m{slots}"
            step[key] = profile_step(torch, model, slots, gen)
        del model
        torch.cuda.empty_cache()
    out = {"root": args.root, "gpu": gpu, "gemm": gemm, "step": step}
    if args.plans:
        from vlm_tpu_torch.ops import _lib
        out["clusters"] = _lib.max_clusters(dev)
    print(json.dumps(out))


def profile_step(torch, model, slots, gen):
    """One decode step over ``slots`` slots: host wall ms of each of
    ``STEPS``, the profiled device ms a step, its kernel count, the largest
    items, and B5's or B7's µs a step at each product in place."""
    from torch.profiler import ProfilerActivity, profile

    from vlm_tpu_torch.models.decoder import init_kv_cache
    dev = torch.device("cuda")
    i32 = dict(dtype=torch.int32, device=dev)
    cache = init_kv_cache(model.cfg.decoder, slots, PROMPT + NEW,
                          model.cache_dtype, "cuda")
    tok = torch.randint(3, 1000, (slots, 1), generator=gen, device=dev,
                        dtype=torch.int32)
    acol = torch.randint(0, NEW, (slots,), generator=gen, device=dev,
                         dtype=torch.int32)
    gcnt = torch.randint(1, NEW, (slots,), generator=gen, device=dev,
                         dtype=torch.int32)
    pos = torch.full((slots,), PROMPT + 8, **i32)

    def one():
        return model.module.decode_step(
            tok, pos, cache, write_col=torch.tensor(PROMPT + 7, **i32),
            kv_window=(torch.tensor(PROMPT, **i32), NEW, acol, gcnt))

    with torch.inference_mode():
        one()
        torch.cuda.synchronize()
        walls = []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(STEPS):
                one()
            torch.cuda.synchronize()
        in_place = tagged_step_us(torch, one)
    rows = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            rows.append((e.key, us / 1e3 / STEPS, e.count / STEPS))
    rows.sort(key=lambda r: -r[1])
    return {"wall_ms": walls,
            "device_ms": sum(r[1] for r in rows),
            "kernels": sum(r[2] for r in rows),
            "b3_launches": sum(r[2] for r in rows if "kv_write" in r[0]),
            "top": [(key[:60], round(ms, 4), c) for key, ms, c in rows[:6]],
            "in_place": in_place}


def tagged_step_us(torch, one):
    """µs a step of B5's or B7's kernels at each Gemma product, where
    ``one()`` (a decode step) runs them: every call of the two wrappers is
    wrapped in a ``record_function`` range named by its (K, N), and the
    ranges' spans on the device's timeline are summed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from vlm_tpu_torch.ops import quant
    names = {kn: name for name, kn in GEMMA_KN.items()}
    originals = {f: getattr(quant, f) for f in ("int8_matmul", "int4_matmul")}

    def tagged(fn):
        def call(x, q, *rest, **kw):
            key = (x.shape[-1], q.shape[0])
            with record_function(f"b57:{names.get(key, key)}"):
                return fn(x, q, *rest, **kw)
        return call

    try:
        for f, fn in originals.items():
            setattr(quant, f, tagged(fn))
        one()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(STEPS):
                one()
            torch.cuda.synchronize()
    finally:
        for f, fn in originals.items():
            setattr(quant, f, fn)
    # a range's span on the device's timeline: its one kernel (the
    # profiler links no kernel launched through ctypes to the host range)
    out = {}
    for e in prof.events():
        if e.name.startswith("b57:"):
            row = out.setdefault(e.name[4:], {"us": 0.0, "calls": 0.0})
            if str(e.device_type).endswith("CUDA"):
                row["us"] += e.device_time_total / STEPS
            else:
                row["calls"] += 1
    for row in out.values():
        row["calls"] /= STEPS
    return out


def plans(torch, m, n, k, gs, x, q8, s8, q4, s4, device_ms):
    """Every tile (the plan's rows; 64 or 128 columns) and split count
    of B5 and B7 through the C entries, µs a call; ``None`` where the
    product disagrees with the plain version or the profiler saw no
    kernel."""
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.quant import (BLOCK_COLS, CHUNK_BYTES,
                                         MAX_SPLITS, int4_matmul_plain,
                                         int8_matmul_plain, stream_plan)
    lib = _lib.lib()
    y = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    st = _lib.stream_ptr(x)
    out = {}
    for fmt in ("int8", "int4"):
        rb = k if fmt == "int8" else k // 2
        want = int8_matmul_plain(x, q8, s8) if fmt == "int8" else \
            int4_matmul_plain(x, q4, s4, gs)
        tol = 2.0 ** -7 * float(want.float().abs().max())
        chunks = -(-rb // CHUNK_BYTES)
        plan = stream_plan(m, n, rb, _lib.sm_count(x.device),
                           _lib.max_clusters(x.device))
        bm = plan.bm
        times = {}
        for bn in BLOCK_COLS:
            for splits in range(1, MAX_SPLITS + 1):
                per = -(-chunks // splits)
                if -(-chunks // per) != splits:
                    continue
                if fmt == "int8":
                    args = (lib.vlm_int8_matmul, x.data_ptr(), q8.data_ptr(),
                            s8.data_ptr(), y.data_ptr(), m, n, k)
                else:
                    args = (lib.vlm_int4_matmul, x.data_ptr(), q4.data_ptr(),
                            s4.data_ptr(), y.data_ptr(), m, n, k, gs)

                def fn(args=args, bn=bn, splits=splits, per=per):
                    if args[0](*args[1:], bm, bn, splits, per, st):
                        raise RuntimeError(f"{fmt} {bm}x{bn} splits {splits}")
                y.fill_(float("nan"))
                fn()
                ok = float((y.float() - want.float()).abs().max()) <= tol
                ms = device_ms(fn) if ok else None
                times[f"{bm}x{bn}/{splits}"] = None if ms is None else ms * 1e3
        out[fmt] = {"plan": f"{plan.bm}x{plan.bn}/{plan.splits}",
                    "us": times}
    return out


if __name__ == "__main__":
    main()
