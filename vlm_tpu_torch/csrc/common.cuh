// Shared helpers for the port's hand-written Hopper kernels.
//
// Every entry point is a plain C function: pointers, sizes and the CUDA
// stream come in as arguments, the kernel launches on that stream, and the
// function returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch (too many threads, too much shared memory).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vlm {

// The finite mask value of the JAX reference: a fully masked prefill row
// softmaxes to uniform weights (mean of V) instead of NaN.
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// Copy `rows` rows of `d` bf16 values (d even) from a strided source into a
// shared tile with row pitch `ld`, zero-filling rows at or beyond `limit`.
// Loads are bf16x2 words: the wrapper guarantees even strides and 4-byte
// aligned base pointers.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src,
                                          int64_t row_stride, int row0,
                                          int rows, int limit, int d) {
  const int half = d / 2;
  for (int i = threadIdx.x; i < rows * half; i += blockDim.x) {
    const int r = i / half;
    const int c = (i - r * half) * 2;
    __nv_bfloat162 val = __floats2bfloat162_rn(0.f, 0.f);
    if (row0 + r < limit)
      val = *reinterpret_cast<const __nv_bfloat162*>(
          src + (int64_t)(row0 + r) * row_stride + c);
    *reinterpret_cast<__nv_bfloat162*>(dst + r * ld + c) = val;
  }
}

}  // namespace vlm
