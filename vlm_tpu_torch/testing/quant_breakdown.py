#!/usr/bin/env python3
"""Where B6's and B7's time goes on one NVIDIA GPU: the instructions their
kernels issue and the issue bound of the decode form's nibble
conversion; prints one JSON line.

    python vlm_tpu_torch/testing/quant_breakdown.py [--root DIR]
        [--dump FILE]

``--root`` is the checkout whose ``vlm_tpu_torch`` is measured (default:
this one).

- ``sass``: for each kernel of the checkout's library whose name holds
  ``stream_kernel`` (B5 and B7's decode form), ``int8xint8`` (B6) or
  ``int4_prefill`` (B7's prefill form), the instructions of its mainloop
  by opcode, from ``cuobjdump -sass``: the mainloop is the loop (a
  backward branch and its target) that holds the most tensor-core
  instructions (HMMA, HGMMA, IMMA); a static count, each instruction of
  its body once (inner loops once);
- ``issue``: for B7's decode form at the decode shapes (``SHAPES``: the
  4bit steps' m = 32 and the sweep's m = 8, group 128), the issue bound:
  the warp instructions of the mainloop a chunk (its kernel's, 8 warps a
  block) over every tile and chunk of the plan, at four a cycle on each
  SM at the card's maximum SM clock (``nvidia-smi``); beside it the byte
  bound (the packed weights and scales at 3.35 TB/s) and the kernel's
  profiled µs;
- ``--dump FILE``: the mainloops' SASS (each kernel's loop body, as
  counted) written to FILE.
"""

import argparse
import collections
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

# (m, K, N): the 4bit decode steps' Gemma, Vicuna and OPT products at 32
# slots and the sweep's at 8
SHAPES = [(m, k, n) for m in (32, 8) for k, n in (
    (2048, 16384), (16384, 2048), (2048, 2048), (2048, 256), (4096, 4096),
    (4096, 11008), (11008, 4096), (4096, 16384), (16384, 4096))]
TENSOR_OPS = ("HMMA", "HGMMA", "IMMA", "IGMMA")
# the classes of the decode form's conversion and data movement
CLASSES = {"convert": ("LOP3", "SHF", "FADD", "FMUL", "F2FP", "PRMT",
                       "IADD3", "FFMA", "SHL", "SHR", "BMSK", "SGXT"),
           "tensor": TENSOR_OPS,
           "shared": ("LDS", "STS", "LDSM"),
           "sync": ("BAR", "SYNCS", "WARPSYNC", "DEPBAR", "ARRIVES")}


def sass_loops(sass: str):
    """{kernel: {opcode: count}} over each kernel's mainloop."""
    out = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0].strip()
        if not any(t in name for t in ("stream_kernel", "int8xint8",
                                       "int4_prefill")):
            continue
        ins = []
        for line in body.splitlines():
            mm = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if not mm:
                continue
            text = re.sub(r"^@!?U?P[T0-9]+\s+", "", mm.group(2).strip())
            ins.append((int(mm.group(1), 16), text))
        best, best_ops = None, -1
        for addr, text in ins:
            b = re.match(r"BRA(?:\.\S+)?\s+(?:`\()?(0x[0-9a-f]+)", text)
            if not b:
                continue
            target = int(b.group(1), 16)
            if target >= addr:
                continue
            span = [t for a, t in ins if target <= a <= addr]
            ops = sum(t.split()[0].split(".")[0] in TENSOR_OPS for t in span)
            if ops > best_ops:
                best, best_ops = span, ops
        if best is None:
            continue
        hist = collections.Counter(t.split()[0].split(".")[0] for t in best)
        out[name] = {"instructions": len(best), "sass": best,
                     "classes": {c: sum(hist[o] for o in ops)
                                 for c, ops in CLASSES.items()},
                     "opcodes": dict(hist.most_common(24))}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--dump")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("quant_breakdown: needs a CUDA device")
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.quant import stream_plan
    from vlm_tpu_torch.testing.kernel_checks import HBM_BYTES_PER_S, _device_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    gpu = smi.splitlines()[0]
    clock_hz = float(re.findall(r"([0-9.]+) MHz", gpu)[-1]) * 1e6
    lib_path = _lib.build()
    nvcc = Path(_lib._nvcc())
    sass = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass",
                           str(lib_path)], capture_output=True,
                          text=True).stdout
    loops = sass_loops(sass)
    if args.dump:
        Path(args.dump).write_text("".join(
            f"== {k}\n" + "\n".join(v["sass"]) + "\n"
            for k, v in loops.items()))
    for v in loops.values():
        del v["sass"]

    dev = torch.device("cuda")
    sms = _lib.sm_count(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    read = type("F", (), {"zero_": staticmethod(lambda: flush.max())})
    read_kernels = frozenset(_device_kernels(torch, read.zero_))
    lib = _lib.lib()

    # the decode form's int4 kernel of each tile (bm rows, bn columns)
    def loop_for(bm, bn):
        mi, ni = bm // 16, bn // 64
        key = f"ILNS0_3FmtE1ELi{mi}ELi{ni}ELi0E"
        hit = [v for k, v in loops.items() if "stream_kernel" in k
               and key in k]
        return hit[0] if hit else None

    # B7's own plan (a checkout before its swapped operands has none)
    int4 = dict(int4=True) if "int4" in inspect.signature(
        stream_plan).parameters else {}
    issue = {}
    for m, k, n in SHAPES:
        gs = 128
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        q4 = torch.randint(-128, 128, (n, k // 2), generator=gen,
                           device=dev).to(torch.int8)
        s4 = torch.rand(n, k // gs, generator=gen, device=dev) / 64
        y = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
        plan = stream_plan(m, n, k // 2, sms, _lib.max_clusters(dev),
                           **int4)
        st = _lib.stream_ptr(x)

        def fn():
            if lib.vlm_int4_matmul(x.data_ptr(), q4.data_ptr(),
                                   s4.data_ptr(), y.data_ptr(), m, n, k, gs,
                                   plan.bm, plan.bn, plan.splits, plan.per,
                                   0, st):
                raise RuntimeError("vlm_int4_matmul")
        loop = loop_for(plan.bm, plan.bn)
        tiles = plan.grid[0] * plan.grid[1]
        row = {"plan": f"{plan.bm}x{plan.bn}/{plan.splits}",
               "byte_bound_us": (n * k / 2 + 4 * n * k / gs)
               / HBM_BYTES_PER_S * 1e6,
               "us": _device_ms(fn, 20, read, read_kernels) * 1e3,
               "read_us": _device_ms(lambda: q4.view(torch.int64).max(), 20,
                                     read, read_kernels) * 1e3}
        if loop is not None:
            warp_ins = loop["instructions"] * 8 * tiles * plan.chunks
            row["issue_bound_us"] = warp_ins / (sms * 4 * clock_hz) * 1e6
            row["loop_instructions_a_chunk"] = loop["instructions"]
            row["weight_bytes_a_chunk"] = plan.bn * 128
        issue[f"m{m}_k{k}_n{n}"] = row
    print(json.dumps({"root": str(root), "gpu": gpu, "clock_hz": clock_hz,
                      "sass": loops, "issue": issue}))


def _device_kernels(torch, fn):
    from vlm_tpu_torch.testing.kernel_checks import _profiled
    return _profiled(fn)


if __name__ == "__main__":
    main()
