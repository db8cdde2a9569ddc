// Shared helpers for the port's hand-written Hopper kernels.
//
// Every entry point is a plain C function: pointers, sizes and the CUDA
// stream come in as arguments, the kernel launches on that stream, and the
// function returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch (too many threads, too much shared memory).
#pragma once

#include <cuda.h>  // CUtensorMap and the driver's types only: no -lcuda
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

// B3's int8 row quantization, shared by its kernel and by B2's fused write
// so the two give the same bytes: one warp quantizes a bf16 row of D <= 256
// values (lane holds d = lane + 32 i, loaded by `load_row_warp`) by
// abs-max/127, the arithmetic of `quantize_activations` bit for bit:
// scale = max(absmax, 1e-8) / 127 in fp32, each value x / scale by IEEE
// division (no reciprocal, no fast math), rounded half to even (rintf),
// clamped to +-127. Returns the scale; q[i] is defined for d < D.
constexpr int kQuantMaxD = 256;
constexpr int kQuantPerLane = kQuantMaxD / 32;

__device__ __forceinline__ void load_row_warp(
    const __nv_bfloat16* __restrict__ src, int D, int lane,
    float (&vals)[kQuantPerLane]) {
#pragma unroll
  for (int i = 0; i < kQuantPerLane; ++i) {
    const int d = lane + 32 * i;
    vals[i] = d < D ? __bfloat162float(src[d]) : 0.f;
  }
}

__device__ __forceinline__ float quantize_row_warp(
    const float (&vals)[kQuantPerLane], int8_t (&q)[kQuantPerLane]) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kQuantPerLane; ++i) amax = fmaxf(amax, fabsf(vals[i]));
  amax = warp_max(amax);
  const float scale = fmaxf(amax, 1e-8f) / 127.0f;
#pragma unroll
  for (int i = 0; i < kQuantPerLane; ++i)
    q[i] = static_cast<int8_t>(
        fminf(fmaxf(rintf(__fdiv_rn(vals[i], scale)), -127.f), 127.f));
  return scale;
}

// ---- tensor-core and async-copy building blocks (mma.sync, cp.async) ----

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a & mask) | c in one LOP3: written as C, the compiler spends two (a
// LOP3 takes one immediate, and it makes both constants immediates)
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t mask,
                                           uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(mask),
      "r"(c));
  return d;
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

// ---- fp32 products on tensor cores: three TF32 products (B1, B2 fp32) ----
//
// x = hi + lo with hi = x rounded to TF32 (10 mantissa bits, to nearest,
// ties away: cvt.rna.tf32's rounding) and lo = x - hi, exact in fp32; the
// tensor core reads only lo's top 10 mantissa bits (it truncates), an error
// of at most 2^-21 |x|. a b is then lo_a hi_b + hi_a lo_b + hi_a hi_b (the
// lo_a lo_b term, ~2^-22 a b, is dropped), each product exact in the
// tensor core and summed in fp32: fp32 accuracy at a third of the TF32
// rate. One TF32 product alone keeps 11 significant bits.
//
// hi by integer add and mask: 2 instructions for finite x, where
// cvt.rna.tf32.f32 compiles to 4 (it also guards NaN and infinity, which
// are never split here), so a split costs 3 instructions instead of ~9
// (testing/tf32_bench.py times both).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a (16x8, row) * b (8x8, col), tf32 operands, fp32 accumulators.
// Fragments (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2
// (g, t + 4), a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g); c0, c1
// (g, 2t and 2t + 1), c2, c3 (g + 8, the same). Not volatile: the compiler
// may interleave independent products.
__device__ __forceinline__ void mma1688_tf32(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
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

// Rows [0, n) of an fp32 tile into shared memory at `pitch` floats a row:
// row r from src + r * stride (elements) for r < valid, zero-filled (not
// read) for the rest; the first D floats of each row, in copies of `width`
// bytes (16, 8 or 4: what the row starts' alignment allows). Row `skip`,
// if it is below `valid`, is neither read nor written: its caller fills it
// itself. Each thread walks its copies by increments, without a division
// per copy.
__device__ __forceinline__ void load_rows_f32(float* dst, int pitch,
                                              const float* src,
                                              int64_t stride, int n,
                                              int valid, int D, int width,
                                              int skip = -1) {
  const int per = width / 4;
  const int chunks = D / per;  // copies a row
  const int nt = blockDim.x;
  int r = threadIdx.x / chunks, c = threadIdx.x - r * chunks;
  const int r_step = nt / chunks, c_step = nt - r_step * chunks;
  while (r < n) {
    const bool ok = r < valid;
    const float* s = ok ? src + r * stride + c * per : src;
    float* d = dst + r * pitch + c * per;
    if (ok && r == skip) {
    } else if (width == 16) cp_async16(d, s, ok);
    else if (width == 8) cp_async_small<8>(d, s, ok);
    else cp_async_small<4>(d, s, ok);
    r += r_step;
    c += c_step;
    if (c >= chunks) {
      c -= chunks;
      ++r;
    }
  }
}

// the widest copy (16, 8 or 4 bytes) that a base pointer and row strides
// (in floats) of D-float rows allow
__host__ __device__ inline int copy_width_f32(const void* base, int D,
                                              int64_t s0, int64_t s1,
                                              int64_t s2) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  if (a % 16 == 0 && D % 4 == 0 && s0 % 4 == 0 && s1 % 4 == 0 && s2 % 4 == 0)
    return 16;
  if (a % 8 == 0 && D % 2 == 0 && s0 % 2 == 0 && s1 % 2 == 0 && s2 % 2 == 0)
    return 8;
  return 4;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- split reduction: blocks of one output tile share its work ----
//
// After its partial results are stored in a workspace, `split_k_last`
// returns true in exactly one block per output tile (the blocks of one
// tile differ in blockIdx.z): the last to arrive, which then merges the
// partials in split order (so the result does not depend on which block
// finished last) and writes the output. It resets the tile's counter for
// the next launch on the stream. Call from every thread of the block. B2
// splits its cache rows this way.
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

// ---- Hopper: mbarriers, TMA, wgmma (B1 and B6) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// wait for the completion of the barrier's phase with this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// one box of a 2-, 4- or 5-D tensor map at coordinates c (innermost first)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// one box of shared memory to a 4- or 5-D tensor map at coordinates c;
// the tensor map clips what lies out of bounds
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// the stores issued so far have read shared memory (which may then go)
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this thread's shared-memory writes, visible to the TMA (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a tile under the 128-byte swizzle, 1024-byte aligned
// 8-row groups (SBO 1024 B). K-major (rows of 128 bytes along K): LBO is
// unused. MN-major (rows of 128 bytes along M or N, K down the rows): LBO
// is the distance between 64-element column blocks, unused when the
// product's N fits in one.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ---- host: tensor maps through the driver entry point (no -lcuda) ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of `rank` dimensions (innermost first; strides in bytes of
// dimensions 1..rank-1) with the given swizzle of its boxes and zero fill
// out of bounds; false if the driver refuses it.
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                       const void* ptr, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the same with 128-byte swizzled boxes (the wgmma operands of B1 and B6)
inline bool tensor_map_sw128(CUtensorMap* map, CUtensorMapDataType type,
                             const void* ptr, int rank, const cuuint64_t* dims,
                             const cuuint64_t* strides, const cuuint32_t* box) {
  return tensor_map(map, type, ptr, rank, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace vlm
