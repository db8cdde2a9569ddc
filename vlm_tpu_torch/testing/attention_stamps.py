#!/usr/bin/env python3
"""Clocks inside B1's and B2's kernels on one NVIDIA GPU: a copy of the
measured checkout's package, its kernels stamped, built and run; prints
one JSON line.

    python vlm_tpu_torch/testing/attention_stamps.py [--root DIR]

``--root`` is the checkout whose ``vlm_tpu_torch`` is measured (default:
this one; the parent's kernels and this tree's both have their stamps
here). The copy goes to a temporary directory; the checkout is not
changed. The stamps cost a few instructions each and shift the timings
they read by as much.

- ``b1``: B1 at CLIP-L [4, 16, 577, 64] and SigLIP [32, 16, 256, 72]
  (bf16, no mask): one block's two consumer warpgroups (thread 0 of each),
  ``clock64`` at each phase of each key tile of its first item; per phase
  the median cycles over the tiles. ``flash_kernel``: the full barrier's
  wait, S = Q K^T (issue and wait), the softmax, P V (issue and wait).
  ``flash_kernel_small``: the turn, the K/V wait, S's issue, the previous
  tile's P V issue, the hand-over, the row maxima, the exponentials, the
  wait for both products, O's rescale;
- ``b2``: B2 over LLaVA's int8 cache (16 slots x 673 rows), BLIP-2's (64 x
  124) and LLaVA's bf16 cache (32 x 673), all rows live (kv_len), after a
  128 MB flush: one block's four warps (lane 0), cycles of each phase of
  each cache tile (the copies' wait, the barrier, Q K^T, the softmax,
  P V, the closing barrier), the median over tiles and warps; and every
  block's start and end (``%globaltimer``) and SM: the block's µs (min,
  median, max), the kernel's span, the blocks an SM held at once.
"""

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

B1_SHAPES = {"clip_l336_g4": (4, 16, 577, 64), "siglip_g32": (32, 16, 256, 72)}
B2_SHAPES = {"llava_int8_16slots": (16, 673, 32, True),
             "blip2_int8_64slots": (64, 124, 32, True),
             "llava_bf16_32slots": (32, 673, 32, False)}

DECL = """
__device__ long long vlm_stamps[4][16][12];
__device__ unsigned long long vlm_blocks[8192][3];
__device__ __forceinline__ void vlm_stamp(int w, int i, int k) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && i >= 0 &&
      i < 16)
    vlm_stamps[w][i][k] = clock64();
}
__device__ __forceinline__ unsigned long long vlm_gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ int vlm_block() {
  return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}
__device__ __forceinline__ void vlm_block_start() {
  if (threadIdx.x == 0 && vlm_block() < 8192) {
    unsigned s;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
    vlm_blocks[vlm_block()][0] = vlm_gtimer();
    vlm_blocks[vlm_block()][2] = s;
  }
}
__device__ __forceinline__ void vlm_block_end() {
  if (threadIdx.x == 0 && vlm_block() < 8192)
    vlm_blocks[vlm_block()][1] = vlm_gtimer();
}
"""
EXTERN = """
extern "C" int vlm_read_stamps_{tag}(long long* s, unsigned long long* b) {
  cudaError_t e = cudaMemcpyFromSymbol(s, vlm_stamps, sizeof(long long) * 4 * 16 * 12);
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(b, vlm_blocks, sizeof(unsigned long long) * 8192 * 3);
  return (int)e;
}
extern "C" int vlm_clear_stamps_{tag}() {
  static long long zs[4 * 16 * 12] = {0};
  static unsigned long long zb[8192 * 3] = {0};
  cudaError_t e = cudaMemcpyToSymbol(vlm_stamps, zs, sizeof(zs));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(vlm_blocks, zb, sizeof(zb));
  return (int)e;
}
"""

# (anchor, code, before): code inserted before or after each anchor, which
# must occur exactly once (before None: at the anchor's "|"). B1: the
# consumers' thread 0 of each warpgroup stamps phase k of key tile i; B2:
# lane 0 of each warp.
W1 = "if (threadIdx.x % 128 == 0) vlm_stamp(wg, {i}, {k});"
W2 = "if (threadIdx.x % 32 == 0) vlm_stamp(threadIdx.x / 32, i, {k});"
FLASH_PARENT = [
    ("      vlm::mbar_wait(&full[s], (i / S::kStages) & 1);\n      const uint32_t k_base = smem_u32(kv_s + s * S::kStageBytes);\n      const uint32_t v_base = k_base + S::kTileBytes;",
     W1.format(i="i", k=0), True),
    ("      const uint32_t v_base = k_base + S::kTileBytes;\n", W1.format(i="i", k=1), False),
    ("      vlm::wgmma_wait<0>();\n      fence_acc(sc);\n", W1.format(i="i", k=2), False),
    ("      // O += P V: V's 64-column boxes one wgmma each, 16 key rows = 2048",
     W1.format(i="i", k=3), True),
    ("      if (lane == 0) vlm::mbar_arrive(&empty[s]);\n    }", W1.format(i="i", k=4), True),
]
FLASH_SMALL = [
    ("      my_turn();\n      qk(nxt, min(i + 1, nt - 1));", 0, True),
    ("      qk(nxt, min(i + 1, nt - 1));\n      pv(prev", 1, True),
    ("      const uint32_t k_base = smem_u32(kv_s + s * S::kStageBytes);\n"
     "      fence_acc(sc);", 2, True),
    ("      pv(prev, max(i - 1, 0));", 3, True),
    ("      pv(prev, max(i - 1, 0));\n", 4, False),
    ("      const int k0 = i * kKeys;\n      float corr[2];", 5, True),
    ("#pragma unroll\n      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r]"
     " + row_sum(cur, r);", 6, True),
    ("      vlm::wgmma_wait<0>();\n      fence_acc(nxt);", 7, True),
    ("      vlm::wgmma_wait<0>();\n      fence_acc(nxt);\n", 8, False),
    ("      for (int j = 0; j < kAcc; ++j) acc[j] *= corr[(j >> 1) & 1];\n",
     9, False),
]
FLASH_SMALL = [(a, "if (k == 0) " + W1.format(i="i - 1" if n == 2 else "i",
                                              k=n), before)
               for a, n, before in FLASH_SMALL]
SMALL_PHASES = ["turn", "kv_wait", "s_issue", "pv_issue", "hand_over",
                "max_exponentials", "sums_pack", "wait", "rescale"]
DECODE_PARENT = [
    ("decode_kernel(const Params p) {\n  constexpr bool kInt8 = sizeof(T) == 1;\n",
     "vlm_block_start();", False),
    ("    if (i + 1 < nt) {\n      load((i + 1) & 1, s_begin + (i + 1) * kTile);",
     W2.format(k=0), True),
    ("    __syncthreads();  // tile i landed for every warp\n    const unsigned char* kt",
     W2.format(k=1), True),
    ("    __syncthreads();  // tile i landed for every warp\n", W2.format(k=2), False),
    ("    const int r_lo = s_begin + i * kTile + rw + g;", W2.format(k=3), True),
    ("    // P^T as the B operand [rows, heads]", W2.format(k=4), True),
    ("    __syncthreads();  // every warp is done with this buffer", W2.format(k=5), True),
    ("    __syncthreads();  // every warp is done with this buffer\n", W2.format(k=6), False),
    ("  finish<kWarps, kMaxDT>(smem, m, l, acc, p.D, nh, p.o + b * p.o_sb,",
     "vlm_block_end();", True),
]
DECODE_FEW = [
    ("  constexpr int kWPH = kWarps / HPB;      // warps a KV head\n",
     "vlm_block_start();", False),
    ("    {  // tile i + stages - 1 into the slot tile i - 1 left", W2.format(k=0), True),
    ("    __syncthreads();  // tile i landed for every warp\n\n    // scores", W2.format(k=1), True),
    ("    __syncthreads();  // tile i landed for every warp\n|\n    // scores", W2.format(k=2), None),
    ("    // per-head max and sum over the warp's rows", W2.format(k=3), True),
    ("    m[0] = mn0;\n    m[1] = mn1;\n#pragma unroll\n", W2.format(k=4) + "\n", False),
    ("    __syncthreads();  // every warp is done with this slot", W2.format(k=5), True),
    ("    __syncthreads();  // every warp is done with this slot\n", W2.format(k=6), False),
    ("  finish<kWarps, NDT, __nv_bfloat16, Dims, true>(", "vlm_block_end();", True),
]


def insert(text, edits, where):
    for anchor, code, before in edits:
        head, _, tail = anchor.partition("|")
        n = text.count(head + tail)
        if n != 1:
            raise SystemExit(f"attention_stamps: {where}: anchor found {n} "
                             f"times: {anchor[:60]!r}")
        text = text.replace(head + tail,
                            head + code + "\n" + tail if before is None
                            else (code + "\n" + head) if before
                            else (head + code + "\n"))
    return text


def stamped_copy(root: Path, dest: Path) -> str:
    """The package of ``root`` under ``dest`` with its attention kernels
    stamped; returns which B1 form (``small`` or ``parent``) it has."""
    shutil.copytree(root / "vlm_tpu_torch", dest / "vlm_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = dest / "vlm_tpu_torch" / "csrc"
    fa = (csrc / "flash_attention.cu").read_text()
    small = "flash_kernel_small" in fa
    fa = insert(fa, FLASH_SMALL if small else FLASH_PARENT,
                "flash_attention.cu")
    da = (csrc / "decode_attention.cu").read_text()
    da = insert(da, DECODE_FEW if "decode_kernel_few" in da
                else DECODE_PARENT, "decode_attention.cu")
    for name, tag, text in (("flash_attention.cu", "fa", fa),
                            ("decode_attention.cu", "da", da)):
        text = text.replace("namespace {\n", "namespace {\n" + DECL, 1)
        text = text.replace('extern "C"', EXTERN.replace("{tag}", tag)
                            + '\nextern "C"', 1)
        (csrc / name).write_text(text)
    return "small" if small else "parent"


def phases(stamps, rows, k_first, k_last):
    """Median cycles of each phase (k -> k + 1) over the rows' tiles."""
    out = []
    for k in range(k_first, k_last):
        d = [int(r[i][k + 1] - r[i][k]) for r in rows for i in range(16)
             if r[i][k] and r[i][k + 1]]
        out.append(statistics.median(d) if d else None)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    dest = Path(tempfile.mkdtemp(prefix="attention_stamps_"))
    form = stamped_copy(root, dest)
    sys.path.insert(0, str(dest))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("attention_stamps: needs a CUDA device")
    from vlm_tpu_torch.ops import _lib
    from vlm_tpu_torch.ops.attention import flash_attention
    from vlm_tpu_torch.ops.decode_attention import decode_attention
    from vlm_tpu_torch.ops.quant import quantize_activations
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    lib = _lib.lib()
    stamps = (ctypes.c_longlong * (4 * 16 * 12))()
    blocks = (ctypes.c_ulonglong * (8192 * 3))()

    def read(tag):
        if getattr(lib, f"vlm_read_stamps_{tag}")(stamps, blocks):
            raise RuntimeError("vlm_read_stamps")
        return (np.array(stamps[:], np.int64).reshape(4, 16, 12),
                np.array(blocks[:], np.uint64).reshape(8192, 3).astype(
                    np.int64))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    out = {"root": str(root), "gpu": gpu, "b1_form": form, "b1": {},
           "b2": {}}
    names = SMALL_PHASES if form == "small" else [
        "kv_wait", "s_product", "softmax", "pv_product"]
    for name, (b, h, s, d) in B1_SHAPES.items():
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev).to(
            torch.bfloat16).transpose(1, 2) for _ in range(3))
        for _ in range(3):
            lib.vlm_clear_stamps_fa()
            flush.zero_()
            flash_attention(q, k, v)
        torch.cuda.synchronize()
        st, _ = read("fa")
        k0, k1 = (0, 9) if form == "small" else (0, 4)
        per = phases(st, [st[0], st[1]], k0, k1)
        tile = [int(r[i + 1][k0] - r[i][k0]) for r in (st[0], st[1])
                for i in range(15) if r[i][k0] and r[i + 1][k0]]
        out["b1"][name] = {"phases": dict(zip(names, per)),
                           "tile_cycles": statistics.median(tile)
                           if tile else None}
    for name, (slots, rows, kvh, int8) in B2_SHAPES.items():
        q = torch.randn(slots, 1, kvh, 128, generator=gen, device=dev).to(
            torch.bfloat16).transpose(1, 2)
        kk, vv = (torch.randn(slots, rows, kvh, 128, generator=gen,
                              device=dev).to(torch.bfloat16)
                  for _ in range(2))
        kw = {}
        if int8:
            (kk, ks), (vv, vs) = quantize_activations(kk), \
                quantize_activations(vv)
            kw = dict(k_scale=ks, v_scale=vs)
        kvl = torch.full((slots,), rows, dtype=torch.int32, device=dev)
        for _ in range(3):
            lib.vlm_clear_stamps_da()
            flush.zero_()
            torch.cuda.synchronize()
            decode_attention(q, kk, vv, kv_len=kvl, **kw)
        torch.cuda.synchronize()
        st, bl = read("da")
        per = phases(st, list(st), 0, 6)
        bl = bl[bl[:, 0] > 0]
        t0 = bl[:, 0].min()
        start, end, sm = (bl[:, 0] - t0) / 1e3, (bl[:, 1] - t0) / 1e3, bl[:, 2]
        held = []
        for i in np.unique(sm):
            ev = sorted([(x, 1) for x in start[sm == i]]
                        + [(x, -1) for x in end[sm == i]])
            c = top = 0
            for _, e in ev:
                c += e
                top = max(top, c)
            held.append(top)
        dur = end - start
        out["b2"][name] = {
            "phases": dict(zip(["copies_wait", "barrier", "qk", "softmax",
                                "pv", "closing_barrier"], per)),
            "blocks": int(len(bl)), "span_us": float(end.max()),
            "block_us": [float(dur.min()), float(np.median(dur)),
                         float(dur.max())],
            "blocks_an_sm_at_once": np.bincount(held).tolist()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
