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

// ---- tensor-core and async-copy building blocks (mma.sync, cp.async) ----

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col), bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x32, row) * b (32x8, col), int8 operands, int32 accumulators
__device__ __forceinline__ void mma16832_s8(int* c, const uint32_t* a,
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !pred (the
// source is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(pred ? 16 : 0));
}

// 4- or 8-byte asynchronous copy (through L1: .cg takes 16 bytes only), for
// rows whose pitch is not a multiple of 16 bytes; zero-fills when !pred.
template <int kBytes>
__device__ __forceinline__ void cp_async_small(void* smem, const void* gmem,
                                               bool pred) {
  static_assert(kBytes == 4 || kBytes == 8, "cp.async.ca takes 4 or 8 bytes");
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(gmem), "n"(kBytes), "r"(pred ? kBytes : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- split-K: blocks of one output tile share the K range ----
//
// Block z of gridDim.z takes K tiles [begin, end) of kt_total. After its
// partial sums are stored in the workspace, `split_k_last` returns true in
// exactly one block per output tile: the last to arrive, which then sums
// the partials in split order (so the result does not depend on which
// block finished last) and writes the output. It resets the tile's counter
// for the next launch on the stream. Call from every thread of the block.
// B5 and B7 split K this way; B2 splits its cache rows the same way.
__device__ __forceinline__ void split_k_range(int kt_total, int& begin,
                                              int& end) {
  const int per = (kt_total + gridDim.z - 1) / gridDim.z;
  begin = blockIdx.z * per;
  end = min(kt_total, begin + per);
}

__device__ __forceinline__ bool split_k_last(int* counters) {
  __shared__ int last;
  __threadfence();  // this block's partials are visible device-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    int* c = counters + blockIdx.y * gridDim.x + blockIdx.x;
    last = atomicAdd(c, 1) == (int)gridDim.z - 1;
    if (last) *c = 0;
  }
  __syncthreads();
  if (last) __threadfence();  // then read the other blocks' partials
  return last;
}

}  // namespace vlm
