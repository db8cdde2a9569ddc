#!/usr/bin/env python3
"""The rates the fp32 forms of B1 and B2 are built on, on one NVIDIA GPU:
``mma.sync`` TF32 (m16n8k8) and bf16 (m16n8k16) products, and the two ways
of splitting an fp32 value into TF32 hi and lo; prints one JSON line.

    python vlm_tpu_torch/testing/tf32_bench.py

Builds its own small CUDA program (``nvcc``, into ``vlm_tpu_torch/_build``)
and runs it. Each kernel runs 132 blocks of 128 x ``wps`` threads (``wps``
warps on each SM sub-partition) for 4096 iterations, timed by CUDA events
around a second launch:

- ``mma_chain``: cycles a product of one warp when each depends on the last
  (the latency);
- ``mma_tf32`` / ``mma_bf16``: cycles a product of one warp with 8
  independent accumulators, and the card's rate in TFLOP/s;
- ``split_cvt`` / ``split_int``: cycles a split of one warp, with 3 more
  instructions of the loop around each: ``cvt.rna.tf32.f32`` for hi and for
  lo, against hi by integer add and mask and lo = x - hi (``common.cuh``).

Cycles are at the SM clock the device reports (``cudaDevAttrClockRate``).
"""

import json
import subprocess
import sys
from pathlib import Path

SOURCE = r'''
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int NACC, bool TF32>
__global__ void mma_loop(float* out, int iters) {
  float acc[NACC][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  uint32_t b0 = threadIdx.x ^ 5u, b1 = 11u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      if (TF32) mma_tf32(acc[j], a, b0, b1); else mma_bf16(acc[j], a, b0, b1);
    }
  }
  float s = 0;
  for (int j = 0; j < NACC; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__device__ __forceinline__ uint32_t cvt_rna(float x) {
  uint32_t r;
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
template <int MODE>
__global__ void split_loop(float* out, int iters) {
  float x[8];
  for (int j = 0; j < 8; ++j) x[j] = threadIdx.x * 0.37f + j;
  uint32_t acc = 0;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t hi, lo;
      if (MODE == 0) {
        hi = cvt_rna(x[j]);
        lo = cvt_rna(x[j] - __uint_as_float(hi));
      } else {
        hi = (__float_as_uint(x[j]) + 0x1000u) & 0xffffe000u;
        lo = __float_as_uint(x[j] - __uint_as_float(hi));
      }
      acc += hi ^ lo;
      x[j] = __uint_as_float(acc) * 1e-30f + x[j];
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
template <typename K>
float run(K kern, int threads, int iters, float* out) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  kern<<<132, threads>>>(out, iters);
  cudaEventRecord(a);
  kern<<<132, threads>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  return ms;
}
int main() {
  float* out;
  cudaMalloc(&out, 132 * 1024 * 4);
  int khz;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  const double hz = khz * 1e3;
  const int iters = 4096;
  printf("{\"clock_ghz\": %.3f, \"rows\": [", hz / 1e9);
  for (int wps = 1; wps <= 8; wps *= 2) {
    const int threads = 128 * wps;
    const double warps = 132.0 * threads / 32;
    auto cyc = [&](float ms, double n) { return ms * 1e-3 * hz / n; };
    const float c1 = run(mma_loop<1, true>, threads, iters, out);
    const float t8 = run(mma_loop<8, true>, threads, iters, out);
    const float b8 = run(mma_loop<8, false>, threads, iters, out);
    const float s0 = run(split_loop<0>, threads, iters, out);
    const float s1 = run(split_loop<1>, threads, iters, out);
    printf("%s{\"wps\": %d, \"mma_chain\": %.2f, \"mma_tf32\": %.2f, \"tf32_tflops\": %.1f, "
           "\"mma_bf16\": %.2f, \"bf16_tflops\": %.1f, \"split_cvt\": %.2f, \"split_int\": %.2f}",
           wps > 1 ? ", " : "", wps, cyc(c1, iters), cyc(t8, 8.0 * iters),
           warps * 8.0 * iters * 2048 / (t8 * 1e-3) / 1e12, cyc(b8, 8.0 * iters),
           warps * 8.0 * iters * 4096 / (b8 * 1e-3) / 1e12, cyc(s0, 8.0 * iters),
           cyc(s1, 8.0 * iters));
  }
  printf("]}\n");
  return cudaGetLastError() != cudaSuccess;
}
'''


def main():
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root.parent))
    from vlm_tpu_torch.ops import _lib
    build = _lib.BUILD_DIR
    build.mkdir(parents=True, exist_ok=True)
    src, exe = build / "tf32_bench.cu", build / "tf32_bench"
    src.write_text(SOURCE)
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS[:2], "-O3", "-o", str(exe),
                    str(src)], check=True)
    out = json.loads(subprocess.run([str(exe)], capture_output=True,
                                    text=True, check=True).stdout)
    out["gpu"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
