#!/usr/bin/env python3
"""B5's and B7's times at the serving paths' shapes and the device profile
of an 8bit and a 4bit PaliGemma-3B decode step, on one NVIDIA GPU; prints
one JSON line.

    python vlm_tpu_torch/testing/profile_quant.py [--root DIR] [--plans]
        [--b6-plans] [--prefill-plans] [--no-step] [--checks]
    python vlm_tpu_torch/testing/profile_quant.py --gate

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
  C entry takes, called directly, beside the one ``stream_plan`` picks,
  and B7's narrow form at 32 rows or fewer (``narrow/w8``,
  ``narrow/w16``: 8 or 16 warps a block);
  each checked against the plain version (``None``: it disagreed, or the
  profiler saw no kernel); and ``clusters``, the device's table of how
  many clusters of 1-8 blocks run at once (``_lib.max_clusters``); also
  at the sweep's decode steps (m = 8: Gemma's, Vicuna's and OPT's
  products);
- ``checks`` (with ``--checks``): the measured checkout's own kernel
  checks (``testing/kernel_checks.py``) of B5, B6 and B7 at every shape
  it holds, each case's events ms, profiled ms, plain ms, library ms and
  error, as ``chip_smoke.py`` times them (20 calls a version);
- ``b6_plans`` (with ``--b6-plans``, this checkout only): B6 at its
  serving shapes (``B6_SHAPES``), the profiled µs of every tile and form
  (staged or direct, a block a tile or persistent) the C entry takes,
  beside the one ``int8xint8_plan`` picks and ``torch._int_mm``'s; each
  checked against the plain version (bitwise for fp32 outputs; ``None``:
  it disagreed);
- ``prefill_plans`` (with ``--prefill-plans``, this checkout only): B7's
  prefill form at its shapes (``PREFILL_SHAPES``), every consumer count
  and split beside the plan's, the decode form's µs at the same rows
  (``stream_us``) and the plain dequantized product's (``plain_us``:
  ``vlm_tpu``'s path from 512 rows at any K; the port's gate is
  ``--gate``'s), each checked against the plain version;
- ``gate`` (``--gate``, alone: nothing else is measured): B7 at the
  shapes its prefill form cannot take (K % 32 != 0: SigLIP's fc2, K =
  4,304 at group 16, and its 2,160 inputs on a model=2 rank, fp32 out)
  over ``GATE_ROWS`` rows, ``b7``: the decode form (``int4_matmul``) and
  ``plain``: the dequantized product (``quant_matmul_dequant``), profiled
  µs (``us``) and event ms (``ms``) a call after the writing flush, B7
  checked against the plain version (``None``: it disagreed); and
  ``prefill``: a model=2 rank 0's fc2 (2,144 inputs) on the prefill form
  at the same rows;
- ``step`` (unless ``--no-step``): one decode step of the full-width,
  full-depth model (random weights from seed 0) over 32 slots (``8bit``,
  ``4bit``) and over one
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
  device's timeline: its one kernel);
- ``8bit_admission``, ``4bit_admission`` (with the steps): an admission
  of 4 images into a fresh cache at full width and depth
  (``profile_admission.profile_admission``: host wall ms, the profiled
  device ms and kernels, the largest items), ``ADMISSIONS`` runs.
"""

import argparse
import json
import subprocess
import sys
import time
import types
from pathlib import Path

SLOTS, PROMPT, NEW = 32, 316, 32
STEPS, ADMISSIONS = 10, 3
GEMMA_KN = {"gate_up": (2048, 16384), "down": (16384, 2048),
            "q_o": (2048, 2048), "k_v": (2048, 256)}
# the sweep's decode steps (8 slots): Vicuna's and OPT's products (K, N)
SWEEP_KN = {"vicuna_qkvo": (4096, 4096), "vicuna_gate_up": (4096, 11008),
            "vicuna_down": (11008, 4096), "opt_fc1": (4096, 16384),
            "opt_down": (16384, 4096)}
# B6's serving shapes (m, K, N, fp32 out): PaliGemma's admission of 4, a
# model=2 rank's q and o, LLaVA's and BLIP-2's admissions (bf16 out), the
# int8 towers (EVA at 8 images, SigLIP's split fc1 at 8 images)
B6_SHAPES = [(1264, 2048, 256, True), (1264, 2048, 2048, True),
             (1264, 2048, 16384, True), (1264, 16384, 2048, True),
             (1264, 2048, 1024, True), (1264, 1024, 2048, True),
             (2564, 4096, 4096, False), (2564, 4096, 11008, False),
             (2564, 11008, 4096, False), (736, 4096, 4096, False),
             (736, 4096, 16384, False), (736, 16384, 4096, False),
             (2056, 1408, 1408, False), (2056, 1408, 6144, False),
             (2056, 6144, 1408, False), (2048, 1152, 2144, False),
             (2048, 2144, 1152, True), (2528, 2048, 256, True)]
# B7's prefill shapes (m, K, N): BLIP-2's admission of 4 x 92 (OPT),
# SigLIP's fc1 at one image, PaliGemma's admission of 4 x 316 (Gemma),
# LLaVA's of 4 x 641 (Vicuna), the sweep's PaliGemma and LLaVA admissions
# (4 x 960, 4 x 1297)
PREFILL_SHAPES = [(368, 4096, 4096), (368, 4096, 16384), (368, 16384, 4096),
                  (256, 1152, 4304), (1264, 2048, 2048), (1264, 2048, 256),
                  (1264, 2048, 16384), (1264, 16384, 2048),
                  (2564, 4096, 4096), (2564, 4096, 11008),
                  (2564, 11008, 4096), (3840, 2048, 16384),
                  (5188, 4096, 4096), (5188, 4096, 11008)]
# B7 where K % 32 != 0 (K, N, group, fp32 out) and the rows it is timed at
# against the dequantized product: SigLIP's fc2 on one GPU and on a model=2
# rank 1; the admissions run the tower at 256 rows an image
GATE_SHAPES = [(4304, 1152, 16, False), (4304, 1152, 16, True),
               (2160, 1152, 16, True)]
GATE_ROWS = (128, 256, 384, 512, 768, 1024, 1536, 2048, 4096)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--b6-plans", action="store_true")
    ap.add_argument("--prefill-plans", action="store_true")
    ap.add_argument("--no-step", action="store_true")
    ap.add_argument("--checks", action="store_true")
    ap.add_argument("--gate", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_quant: needs a CUDA device")
    from vlm_tpu_torch.models.factory import create_model
    from vlm_tpu_torch.ops.quant import int4_matmul, int8_matmul
    from vlm_tpu_torch.testing.profile_admission import profile_admission
    from vlm_tpu_torch.testing.kernel_checks import (_device_ms, _ms,
                                                     _profiled)

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    # the kernel checks first: their profiler sessions then run as in
    # chip_smoke.py, before any other in the process
    extra = {"checks": quant_checks()} if args.checks else {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    flush_kernels = frozenset(_profiled(flush.zero_))

    # a flush by reading: its "zero_" reads the buffer's maximum
    read_flush = types.SimpleNamespace(zero_=lambda: flush.max())
    read_kernels = frozenset(_profiled(read_flush.zero_))

    def us(ms):  # None: the profiler saw no kernel in three sessions
        return None if ms is None else ms * 1e3

    def timed(fn):
        return {"ms": _ms(fn, 20, flush),
                "us": us(_device_ms(fn, 20, flush, flush_kernels)),
                "us_clean": us(_device_ms(fn, 20, read_flush,
                                          read_kernels))}

    if args.gate:
        print(json.dumps({"root": args.root, "gpu": gpu, "gate": gate(
            torch, gen, lambda fn: {
                "ms": _ms(fn, 20, flush),
                "us": us(_device_ms(fn, 20, flush, flush_kernels))})}))
        return

    products = []
    for name, (k, n) in GEMMA_KN.items():
        for m in (1, 8, 16, SLOTS, PROMPT):
            products.append((f"{name}_m{m}", m, k, n, 128))
    for name, (k, n) in SWEEP_KN.items():
        products.append((f"{name}_m8", 8, k, n, 128))
    products.append(("vicuna_qkvo_m32", 32, 4096, 4096, 128))
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
            "read_us": {f: us(_device_ms(lambda: w.view(torch.int64).max(),
                                         20, read_flush, read_kernels))
                        for f, w in (("int8", q8), ("int4", q4))}}
        if args.plans:
            gemm[case]["plans"] = plans(torch, m, n, k, gs, x, q8, s8, q4, s4,
                                        lambda fn: _device_ms(
                                            fn, 10, flush, flush_kernels))

    device_ms = lambda fn: _device_ms(fn, 10, flush, flush_kernels)  # noqa
    if args.b6_plans:
        extra["b6_plans"] = b6_plans(torch, gen, device_ms)
    if args.prefill_plans:
        extra["prefill_plans"] = prefill_plans(torch, gen, device_ms)
    step = {}
    for mode in () if args.no_step else ("8bit", "4bit"):
        model = create_model("paligemma", quantization=mode, size="3b",
                             device="cuda", seed=0,
                             kv_cache="int8" if mode == "8bit" else None)
        for slots in (SLOTS, 1):
            key = mode if slots == SLOTS else f"{mode}_m{slots}"
            step[key] = profile_step(torch, model, slots, gen)
        step[f"{mode}_admission"] = profile_admission(torch, model,
                                                      ADMISSIONS)
        del model
        torch.cuda.empty_cache()
    out = {"root": args.root, "gpu": gpu, "gemm": gemm, "step": step,
           **extra}
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
                           _lib.max_clusters(x.device), int4=fmt == "int4")
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
                    if args[0](*args[1:], bm, bn, splits, per, 0, st):
                        raise RuntimeError(f"{fmt} {bm}x{bn} splits {splits}")
                y.fill_(float("nan"))
                fn()
                ok = float((y.float() - want.float()).abs().max()) <= tol
                ms = device_ms(fn) if ok else None
                times[f"{bm}x{bn}/{splits}"] = None if ms is None else ms * 1e3
        for warps in ((8, 16) if fmt == "int4" and m <= 32
                      and k % 32 == 0 else ()):
            def narrow(warps=warps):
                if lib.vlm_int4_matmul_narrow(
                        x.data_ptr(), q4.data_ptr(), s4.data_ptr(),
                        y.data_ptr(), m, n, k, gs, warps, 0, st):
                    raise RuntimeError("int4 narrow")
            y.fill_(float("nan"))
            narrow()
            ok = float((y.float() - want.float()).abs().max()) <= tol
            times[f"narrow/w{warps}"] = device_ms(narrow) * 1e3 if ok \
                else None
        out[fmt] = {"plan": f"{plan.bm}x{plan.bn}/{plan.splits}",
                    "us": times}
    return out


def quant_checks():
    """The measured checkout's kernel checks of B5, B6 and B7 (its
    ``cases`` kept to those kernels), by case."""
    from vlm_tpu_torch.testing import kernel_checks
    every = kernel_checks.cases
    kernel_checks.cases = lambda device: [
        c for c in every(device) if c.kernel in ("B5", "B6", "B7")]
    try:
        records = kernel_checks.run("cuda", iters=20)
    finally:
        kernel_checks.cases = every
    return {f"{r['kernel']} {r['case']}": {
        k: r[k] for k in ("form", "ok", "max_abs_err", "ms", "device_ms",
                          "plain_ms", "library_ms", "library_device_ms",
                          "bound_ms", "bound_by")} for r in records}


def b6_plans(torch, gen, device_ms):
    """Every tile and form of B6 through its C entry at
    :data:`B6_SHAPES`, with a block a tile and persistent on one or two
    blocks an SM: µs a call, ``None`` where the output disagreed with the
    plain version (fp32: bitwise; bf16: one ulp)."""
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.quant import (B6_TILES, int8xint8_matmul_plain,
                                         int8xint8_plan)
    lib, dev = _lib.lib(), torch.device("cuda")
    sms = _lib.sm_count(dev)
    out = {}
    for m, k, n, f32 in B6_SHAPES:
        qx = torch.randint(-127, 128, (m, k), generator=gen,
                           device=dev).to(torch.int8)
        qw = torch.randint(-127, 128, (n, k), generator=gen,
                           device=dev).to(torch.int8)
        sx = torch.rand(m, 1, generator=gen, device=dev) * (4 / 127)
        sw = torch.rand(n, generator=gen, device=dev) / (64 * k ** 0.5)
        dt = torch.float32 if f32 else torch.bfloat16
        want = int8xint8_matmul_plain(qx, sx, qw, sw, dt).float()
        tol = 0.0 if f32 else 2.0 ** -8 * float(want.abs().max())
        y = torch.empty(m, n, dtype=dt, device=dev)
        st = _lib.stream_ptr(qx)
        times = {}
        for c, bn in B6_TILES:
            tiles = -(-m // (64 * c)) * -(-n // bn)
            configs = [(False, tiles), (False, min(tiles, 2 * sms)),
                       (True, min(tiles, sms))]
            for staged, grid in dict.fromkeys(configs):

                def fn(c=c, bn=bn, staged=staged, grid=grid):
                    if lib.vlm_int8xint8_matmul(
                            qx.data_ptr(), sx.data_ptr(), qw.data_ptr(),
                            sw.data_ptr(), y.data_ptr(), m, n, k,
                            int(not f32), c, bn, int(staged), grid, st):
                        raise RuntimeError(f"B6 {c} {bn} {staged} {grid}")
                key = (f"{64 * c}x{bn}/{'staged' if staged else 'direct'}"
                       f"/g{grid}")
                try:
                    y.fill_(float("nan"))
                    fn()
                    ok = float((y.float() - want).abs().max()) <= tol
                except RuntimeError:
                    ok = False
                times[key] = device_ms(fn) * 1e3 if ok else None
        plan = int8xint8_plan(m, n, k, sms, 4 if f32 else 2)
        out[f"m{m}_k{k}_n{n}"] = {
            "plan": f"{64 * plan.consumers}x{plan.bn}/"
                    f"{'staged' if plan.staged else 'direct'}/g{plan.grid}",
            "us": times,
            "int_mm_us": device_ms(lambda: torch._int_mm(qx, qw.t())) * 1e3}
    return out


def prefill_plans(torch, gen, device_ms):
    """B7's prefill form at :data:`PREFILL_SHAPES` (group 128, bf16 out):
    every consumer count (2, 3) and split (1, 2, 4, 8), the decode form at
    the same rows and the plain dequantized product, µs a call; ``None``
    where the output is off by more than ``GEMM_REL_TOL`` of its largest
    value."""
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.quant import (PREFILL_STEP, int4_matmul_plain,
                                         int4_prefill_plan, stream_plan)
    from vlm_tpu_torch.testing.kernel_checks import GEMM_REL_TOL
    lib, dev = _lib.lib(), torch.device("cuda")
    sms = _lib.sm_count(dev)
    out = {}
    for m, k, n in PREFILL_SHAPES:
        gs = 128
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        q4 = torch.randint(-128, 128, (n, k // 2), generator=gen,
                           device=dev).to(torch.int8)
        s4 = (0.5 + torch.rand(n, k // gs, generator=gen, device=dev)) / (
            4 * k ** 0.5)
        want = int4_matmul_plain(x, q4, s4, gs).float()
        tol = GEMM_REL_TOL * float(want.abs().max())
        y = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
        st = _lib.stream_ptr(x)
        stages = -(-k // PREFILL_STEP)

        def checked(fn):
            y.fill_(float("nan"))
            fn()
            ok = float((y.float() - want).abs().max()) <= tol
            return device_ms(fn) * 1e3 if ok else None
        times = {}
        for c in (2, 3):
            for splits in (1, 2, 4, 8):
                per = -(-stages // splits)
                if -(-stages // per) != splits:
                    continue

                def fn(c=c, splits=splits, per=per):
                    if lib.vlm_int4_matmul_prefill(
                            x.data_ptr(), q4.data_ptr(), s4.data_ptr(),
                            y.data_ptr(), m, n, k, gs, c, splits, per, 0,
                            st):
                        raise RuntimeError(f"B7 prefill {c} {splits}")
                times[f"{64 * c}/s{splits}"] = checked(fn)
        sp = stream_plan(m, n, k // 2, sms, _lib.max_clusters(dev),
                         int4=True)

        def stream():
            if lib.vlm_int4_matmul(x.data_ptr(), q4.data_ptr(),
                                   s4.data_ptr(), y.data_ptr(), m, n, k, gs,
                                   sp.bm, sp.bn, sp.splits, sp.per, 0, st):
                raise RuntimeError("B7 decode form")
        plan = int4_prefill_plan(m, n, k, sms)
        out[f"m{m}_k{k}_n{n}"] = {
            "plan": f"{64 * plan.consumers}/s{plan.splits}", "us": times,
            "stream_us": checked(stream),
            "plain_us": device_ms(lambda: int4_matmul_plain(x, q4, s4,
                                                            gs)) * 1e3}
    return out


def gate(torch, gen, timed):
    """B7's decode form against the dequantized product at
    :data:`GATE_SHAPES` x :data:`GATE_ROWS`, and the prefill form at a
    model=2 rank 0's fc2; ``None`` where B7 is off by more than
    ``GEMM_REL_TOL`` of the plain version's largest output."""
    from vlm_tpu_torch.ops.quant import (QuantizedWeight, int4_matmul,
                                         int4_matmul_plain,
                                         quant_matmul_dequant)
    from vlm_tpu_torch.testing.kernel_checks import GEMM_REL_TOL
    dev = torch.device("cuda")
    out = {}
    for k, n, gs, f32 in GATE_SHAPES + [(2144, 1152, 16, True)]:
        od = torch.float32 if f32 else torch.bfloat16
        q4 = torch.randint(-128, 128, (n, k // 2), generator=gen,
                           device=dev).to(torch.int8)
        s4 = (0.5 + torch.rand(n, k // gs, generator=gen, device=dev)) / (
            4 * k ** 0.5)
        qw = QuantizedWeight(q4, s4, gs)
        for m in GATE_ROWS:
            x = torch.randn(m, k, generator=gen,
                            device=dev).to(torch.bfloat16)
            want = int4_matmul_plain(x, q4, s4, gs, od).float()
            got = int4_matmul(x, q4, s4, gs, od).float()
            ok = float((got - want).abs().max()) <= (
                GEMM_REL_TOL * float(want.abs().max()))
            case = {"b7": timed(lambda: int4_matmul(x, q4, s4, gs, od))
                    if ok else None}
            if k % 32:
                case["plain"] = timed(
                    lambda: quant_matmul_dequant(x, qw, out_dtype=od))
            out[f"m{m}_k{k}_n{n}_gs{gs}{'_fp32' if f32 else ''}"] = case
    return out


if __name__ == "__main__":
    main()
