#!/usr/bin/env python3
"""Where B1's and B2's time goes on one NVIDIA GPU: the instructions of
their kernels' main loops by opcode, each kernel's registers and shared
memory, and for each case the issue, exponential and tensor-core bounds
of its loop beside the kernel's profiled time; prints one JSON line.

    python vlm_tpu_torch/testing/attention_breakdown.py [--root DIR]
        [--dump FILE]

``--root`` is the checkout whose ``vlm_tpu_torch`` is measured (default:
this one).

- ``resources``: for each kernel of the checkout's library whose name
  holds ``flash_kernel`` or ``decode_kernel``, its registers, static shared
  memory and local (spilled) bytes a thread (``cuobjdump -res-usage``);
- ``sass``: the same kernels' main loops (the loop, a backward branch and
  its target, that holds the most tensor-core instructions), instructions
  by opcode and by class (``quant_breakdown.sass_loops``);
- ``cases``: B1 at CLIP-L [4, 16, 577, 64] and [8, ...] and SigLIP [32,
  16, 256, 72] (bf16, no mask), B2 over LLaVA's rotating window: the int8
  cache of 16 slots x 673 rows and the bf16 cache of 32 slots x 673 rows
  (32 KV heads of 128, G = 1), after a 128 MB flush. Each: ``us``, the
  kernel's profiled µs a call, and ``sdpa_us`` (bf16) beside it; ``loop``,
  the kernel instance whose loop ran (by the wrapper's plan: each block's
  key tiles or cache tiles) and ``warp_iterations``, the loop bodies run
  by all warps; the bounds in µs: ``issue`` (the loop's warp instructions
  at four a cycle on each SM), ``ex2`` (its ``MUFU.EX2`` at 16 lanes a
  cycle on each SM), ``tensor`` (the case's multiply-adds at 989 TFLOP/s,
  padding included: the products the kernel issues) and ``bytes`` (q, k,
  v, o and scales once at 3.35 TB/s), at the card's maximum SM clock
  (``nvidia-smi``); for B2, ``blocks_per_sm`` (from the registers and the
  launch's shared memory) and ``bytes_in_flight_per_sm`` (the cache bytes
  of the tiles a block has requested and not yet consumed, times the
  blocks an SM holds);
- ``--dump FILE``: the main loops' SASS written to FILE.

The wait of a loop (barriers, copies, dependent loads) is what is left of
the kernel's time beyond the largest of its issue, ``ex2`` and tensor
bounds; a probe build (stamps of ``%globaltimer``) is needed to split it.
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

# B1's cases: name, (B, H, Sq, D); B2's: name, (slots, rows, KV heads, D,
# int8)
B1_CASES = {"clip_l336_g4": (4, 16, 577, 64), "clip_l336_g8": (8, 16, 577, 64),
            "siglip_g32": (32, 16, 256, 72)}
B2_CASES = {"llava_int8_16slots": (16, 673, 32, 128, True),
            "llava_bf16_32slots": (32, 673, 32, 128, False)}
PROMPT, NEW = 641, 32


def resources(cuobjdump: Path, lib_path: Path):
    """{kernel: {"reg", "shared", "local"}} of the attention kernels."""
    text = subprocess.run([str(cuobjdump), "-res-usage", str(lib_path)],
                          capture_output=True, text=True).stdout
    out = {}
    for name, body in re.findall(r"Function ([^:\s]+):\s*\n?\s*(REG:.*)",
                                 text):
        if "flash_kernel" not in name and "decode_kernel" not in name:
            continue
        vals = dict(re.findall(r"(\w+):(\d+)", body))
        out[name] = {"reg": int(vals.get("REG", 0)),
                     "shared": int(vals.get("SHARED", 0)),
                     "local": int(vals.get("LOCAL", 0))}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--dump")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit("attention_breakdown: needs a CUDA device")
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.attention import flash_attention
    from vlm_tpu_torch.ops.decode_attention import decode_attention
    from vlm_tpu_torch.ops.quant import quantize_activations
    from vlm_tpu_torch.testing import kernel_checks as kc
    from vlm_tpu_torch.testing.quant_breakdown import CLASSES, TENSOR_OPS

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    gpu = smi.splitlines()[0]
    clock_hz = float(re.findall(r"([0-9.]+) MHz", gpu)[-1]) * 1e6
    lib_path = _lib.build()
    tools = Path(_lib._nvcc()).parent
    sass = subprocess.run([str(tools / "cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True).stdout
    loops = sass_loops(sass, CLASSES, TENSOR_OPS)
    if args.dump:
        Path(args.dump).write_text("".join(
            f"== {k}\n" + "\n".join(v["sass"]) + "\n"
            for k, v in loops.items()))
    for v in loops.values():
        del v["sass"]
    res = resources(tools / "cuobjdump", lib_path)

    dev = torch.device("cuda")
    sms = _lib.sm_count(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    flush_kernels = frozenset(kc._profiled(flush.zero_))

    def us(fn):
        ms = kc._device_ms(fn, 20, flush, flush_kernels)
        return None if ms is None else ms * 1e3

    def bounds(loop, warp_iters, flops, nbytes):
        out = {"tensor": flops / kc.PEAK_OPS_PER_S["bf16"] * 1e6,
               "bytes": nbytes / kc.HBM_BYTES_PER_S * 1e6}
        if loop is not None:
            ins = loops[loop]
            out["issue"] = ins["instructions"] * warp_iters / (
                sms * 4 * clock_hz) * 1e6
            out["ex2"] = ins["mufu_ex2"] * warp_iters * 32 / (
                sms * 16 * clock_hz) * 1e6
        return out

    cases = {}
    for name, (b, h, s, d) in B1_CASES.items():
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev).to(
            torch.bfloat16).transpose(1, 2) for _ in range(3))
        blocks, tiles, pv_cols, qk_depth, loop = b1_geometry(
            torch, b, h, s, d, loops)
        warps = 8
        # the products the kernel issues: 128 rows by 64 keys a tile
        flops = 2.0 * tiles * 128 * 64 * (qk_depth + pv_cols)
        cases[name] = {
            "us": us(lambda: flash_attention(q, k, v)),
            "sdpa_us": us(lambda: F.scaled_dot_product_attention(q, k, v)),
            "loop": loop, "blocks": blocks, "key_tiles": tiles,
            "warp_iterations": tiles * warps,
            "pv_columns": pv_cols, "qk_depth": qk_depth,
            "bounds": bounds(loop, tiles * warps, flops,
                             2.0 * 4 * b * h * s * d)}
    for name, (slots, rows, kvh, d, int8) in B2_CASES.items():
        q = torch.randn(slots, 1, kvh, d, generator=gen, device=dev).to(
            torch.bfloat16).transpose(1, 2)
        kk, vv = (torch.randn(slots, rows, kvh, d, generator=gen,
                              device=dev).to(torch.bfloat16)
                  for _ in range(2))
        kw = {}
        if int8:
            (kk, ks), (vv, vs) = quantize_activations(kk), \
                quantize_activations(vv)
            kw = dict(k_scale=ks, v_scale=vs)
        acol = torch.randint(0, NEW, (slots,), generator=gen,
                             device=dev).int()
        gcnt = torch.randint(1, NEW + 1, (slots,), generator=gen,
                             device=dev).int()
        win = (torch.tensor(PROMPT, dtype=torch.int32, device=dev), NEW,
               acol, gcnt)
        geo = b2_geometry(torch, slots, rows, kvh, d, int8, loops, res, sms)
        live = slots * kvh * min(rows, PROMPT + NEW)
        nbytes = 2.0 * live * d * (1 if int8 else 2) + (
            8.0 * live if int8 else 0.0) + 4.0 * slots * kvh * d
        cases[name] = {
            "us": us(lambda: decode_attention(q, kk, vv, kv_window=win,
                                              **kw)),
            **({} if int8 else {"sdpa_us": us(
                lambda: F.scaled_dot_product_attention(
                    q, kk.transpose(1, 2), vv.transpose(1, 2)))}),
            **geo,
            "bounds": bounds(geo["loop"], geo["warp_iterations"],
                             2.0 * 2 * geo["warp_iterations"] * 16 * 8 * d,
                             nbytes)}
    print(json.dumps({"root": str(root), "gpu": gpu, "clock_hz": clock_hz,
                      "resources": res, "sass": loops, "cases": cases}))


def sass_loops(sass, classes, tensor_ops):
    """``quant_breakdown.sass_loops`` over the attention kernels."""
    out = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0].strip()
        if "flash_kernel" not in name and "decode_kernel" not in name:
            continue
        ins = []
        for line in body.splitlines():
            mm = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if mm:
                text = re.sub(r"^@!?U?P[T0-9]+\s+", "", mm.group(2).strip())
                ins.append((int(mm.group(1), 16), text))
        best, best_ops = None, -1
        for addr, text in ins:
            b = re.match(r"BRA(?:\.\S+)?\s+(?:`\()?(0x[0-9a-f]+)", text)
            if not b or int(b.group(1), 16) >= addr:
                continue
            target = int(b.group(1), 16)
            span = [t for a, t in ins if target <= a <= addr]
            ops = sum(t.split()[0].split(".")[0] in tensor_ops for t in span)
            if ops > best_ops:
                best, best_ops = span, ops
        if best is None:
            continue
        hist = {}
        for t in best:
            op = t.split()[0].split(".")[0]
            hist[op] = hist.get(op, 0) + 1
        ex2 = sum(1 for t in best if t.startswith("MUFU.EX2"))
        out[name] = {"instructions": len(best), "sass": best,
                     "mufu_ex2": ex2,
                     "ldg": sum(1 for t in best if t.startswith("LDG")),
                     "classes": {c: sum(hist.get(o, 0) for o in ops)
                                 for c, ops in {**classes,
                                                "convert_int": ("I2F",
                                                                "I2FP"),
                                                "global": ("LDG",)}.items()},
                     "opcodes": dict(sorted(hist.items(),
                                            key=lambda kv: -kv[1])[:28])}
    return out


def _pick(loops, *parts):
    hit = [k for k in loops if all(p in k for p in parts)]
    return min(hit, key=len) if hit else None


def b1_geometry(torch, b, h, s, d, loops):
    """(blocks, key tiles over all blocks, P.V columns, Q.K depth, loop)
    of B1's bf16 form at [b, h, s, d] without a mask, by the measured
    checkout's plan: ``flash_kernel_small`` (P.V at D rounded up to 8, at
    least 64) where it has one for D, else ``flash_kernel`` (64-column
    boxes)."""
    from vlm_tpu_torch.ops import attention as att
    plan = att.flash_plan(b, h, h, s)
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    tiles = blocks * -(-s // att.KEYS)
    if d <= getattr(att, "SMALL_D", 0):
        n = next(x for x in (64, 72, 88, 96) if x >= d)
        return blocks, tiles, n, 16 * -(-n // 16), _pick(
            loops, f"flash_kernel_smallILi{n}E")
    nb = -(-d // 64)
    ks = {64: 4, 80: 5, 96: 6, 128: 8, 192: 12, 256: 16}[
        min(x for x in (64, 80, 96, 128, 192, 256) if x >= d)]
    return blocks, tiles, 64 * nb, 16 * ks, _pick(
        loops, f"flash_kernelILi{nb}ELi{ks}E")


def b2_geometry(torch, slots, rows, kvh, d, int8, loops, res, sms):
    """B2's plan at the window over ``rows`` cache rows of G = 1: blocks,
    splits, cache tiles over all blocks, warps a block, the loop's kernel,
    blocks an SM and the cache bytes an SM's blocks have requested and not
    yet consumed (their rings: ``decode_kernel_few``'s stages, or
    ``decode_kernel``'s two buffers)."""
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops import decode_attention as da
    dev = torch.device("cuda")
    pairs = kvh * slots
    elem = 1 if int8 else 2
    ty = "Ia" if int8 else "I13__nv_bfloat16"
    live = min(rows, PROMPT + NEW)
    if hasattr(da, "few_plan"):
        splits, per, stages = da.few_plan(
            rows, pairs, sms, lambda st: _lib.few_blocks(dev, int8, d, st,
                                                         False))
        per_sm = _lib.few_blocks(dev, int8, d, stages, False)
        name = _pick(loops, "decode_kernel_few", ty)
        ring = stages
    else:
        splits, per = da.split_plan(rows, pairs, sms)
        name = _pick(loops, "decode_kernelI" + ty[1:])
        dp = -(-d // 16) * 16
        ring = min(2, per // 64)
        smem = ring * 2 * 64 * (dp * elem + 16) + 8 * (2 * dp + 16)
        reg = res.get(name, {}).get("reg", 0) if name else 0
        by_regs = 65536 // (reg * 128) if reg else 16
        per_sm = min(by_regs, (228 * 1024) // (smem + 1024), 16)
    reg = res.get(name, {}).get("reg") if name else None
    tiles = pairs * sum(max(0, -(-(min(live, (z + 1) * per) - z * per)
                                 // 64)) for z in range(splits))
    return {"loop": name, "blocks": pairs * splits, "splits": splits,
            "rows_per_split": per, "ring": ring, "tiles": tiles,
            "warp_iterations": 4 * tiles, "registers": reg,
            "blocks_per_sm": per_sm,
            "bytes_in_flight_per_sm": per_sm * ring * 2 * 64 * d * elem}


if __name__ == "__main__":
    main()
