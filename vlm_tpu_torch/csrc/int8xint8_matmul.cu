// B6: int8 x int8 GEMM with a scale epilogue, y = float(qx . qw^T) * sx * sw,
// the core of the llm.int8 prefill, on wgmma and TMA.
//
// Replaces vlm_tpu/ops/quant.py `_int8xint8_kernel` (launched by
// `_int8xint8_matmul_pallas`): qx [M, K] int8 activations with per-row
// scales sx [M] fp32 (from `quantize_activations`), qw [N, K] int8 weights
// (the nn.Linear layout; the TPU kernel took [K, N]) with per-column scales
// sw [N] fp32. The products accumulate exactly in int32 (|acc| <= 127^2 K,
// 2.6e8 at K = 16384: no saturation); the epilogue computes
// float(acc) * sx[row] * sw[col] in that order, as the TPU kernel does, so
// the fp32 value equals the plain version's bit for bit before the
// optional cast to bf16.
//
// What bounds it on the H100: integer tensor-core math at prefill sizes
// (M = 4 x 316 = 1264 for a Gemma admission: 2 M K N operations against
// K N weight bytes, ~2,500 operations a byte). Only wgmma reaches the
// card's int8 rate (1,979 dense TOPS); mma.sync with fragments read from
// shared memory a register at a time ran at 14-18 % of it. The design:
// - A 128 x 128 output tile per block: two consumer warpgroups of
//   64 x 128, each issuing wgmma.mma_async.m64n128k32.s32.s8.s8 with both
//   operands read from shared memory through descriptors (K-major, the
//   only layout wgmma takes for 8-bit operands, and the port's layout of
//   both qx and qw).
// - One producer thread feeds a 3-stage ring of 128-byte K steps (16 KB of
//   qx and 16 KB of qw a stage) with TMA (cp.async.bulk.tensor) under the
//   128-byte swizzle that the descriptors name; full and empty mbarriers
//   hand stages between producer and consumers, and each consumer keeps one
//   wgmma group in flight while it releases the stage before.
// - Two blocks an SM (97 KB of shared memory and 288 threads each), so one
//   block's prologue and epilogue (the fp32 output of gate/up alone is
//   83 MB) overlap the other's products.
// - Ragged edges cost nothing: TMA fills out-of-bounds rows (M = 1264 =
//   9 x 128 + 112, M = 4; N = 4304) and K tails (4304 = 33 x 128 + 80;
//   K = 64, less than one step) with zeros, which add nothing to the sums.
//   TMA needs 16-byte row strides: K % 16 == 0.
// - Scheduling: one block per output tile, the grid running M tiles
//   fastest, so the blocks in flight share a few weight column blocks and
//   reread qx from L2. Split-K was measured against it on every prefill
//   shape (split counts 1-8, m = 1 to 1264): the int32 partials' traffic
//   cost more than the idle SMs it filled, at every count above 1 (k/v at
//   m = 1264: 0.0193 ms unsplit, 0.0357 split in 2 on an H100; PERF.md),
//   so B6 does not split. Persistent and stream-K schedules are left for
//   the shapes with few tiles (SigLIP fc2 at m = 512: 36 blocks).
// - The two tensor maps are encoded on the host at every call, through
//   the driver entry point (no -lcuda); a cache of them measured no faster
//   (about 20 us of host time a call either way). Activation quantization
//   stays outside, in PyTorch, as JAX computed it in XLA.
//
// Requirements (checked by the wrapper and here): K % 16 == 0, N even,
// contiguous operands and output, 16-byte aligned bases.
#include "common.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 128;  // bytes = int8 elements: one 128-byte swizzle row
constexpr int kStages = 3;
constexpr int kConsumers = 2;
// two consumer warpgroups (warps 0-7: wgmma needs warpgroup-aligned warps)
// and one producer warp
constexpr int kThreads = 128 * kConsumers + 32;
constexpr int kTileA = kBM * kBK;
constexpr int kTileB = kBN * kBK;
constexpr int kStageBytes = kTileA + kTileB;
constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;
static_assert(kBM == 128 && kBN == 128, "one tensor-map box for both operands");

using vlm::desc_sw128;
using vlm::mbar_arrive;
using vlm::mbar_expect_tx;
using vlm::mbar_init;
using vlm::mbar_wait;
using vlm::smem_u32;
using vlm::wgmma_commit;
using vlm::wgmma_fence;
using vlm::wgmma_wait;

// keep the compiler from moving accumulator accesses across the async span
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 128] += a[64 x 32] . b[128 x 32]^T, s8 in, s32 accumulate
__device__ __forceinline__ void wgmma_m64n128k32(int* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(kThreads, 2)
int8xint8_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_w,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 void* __restrict__ y, int M, int N, int K, int out_bf16) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the stages to it
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int wg = threadIdx.x / 128;

  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == 128 * kConsumers) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        unsigned char* st = smem + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        vlm::tma_load_2d(st, &tm_x, &full[s], i * kBK, m0);
        vlm::tma_load_2d(st + kTileA, &tm_w, &full[s], i * kBK, n0);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of the tile
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int i = 0; i < nk; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    const uint32_t a = smem_u32(smem + s * kStageBytes + wg * 64 * kBK);
    const uint32_t bt = smem_u32(smem + s * kStageBytes + kTileA);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma_m64n128k32(acc, desc_sw128(a + 32 * kk), desc_sw128(bt + 32 * kk));
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done
    fence_acc(acc);
    if (i > 0 && threadIdx.x % 32 == 0) mbar_arrive(&empty[(i - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // accumulator layout: d[4 j + e] is row 16 w + g (+8 for e >= 2), column
  // 8 j + 2 t (+1 for odd e) of the warpgroup's 64 x 128
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = m0 + wg * 64 + warp * 16 + g;
  float xs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) xs[h] = row0 + 8 * h < M ? sx[row0 + 8 * h] : 0.f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;  // N even: col < N => col + 1 < N
    if (col >= N) continue;
    const float w0 = sw[col], w1 = sw[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      // (float(acc) * sx) * sw, two roundings, in the reference's order
      const float v0 = static_cast<float>(acc[4 * j + 2 * h]) * xs[h] * w0;
      const float v1 = static_cast<float>(acc[4 * j + 2 * h + 1]) * xs[h] * w1;
      const int64_t off = static_cast<int64_t>(row) * N + col;
      if (out_bf16)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) + off) =
            __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(y) + off) = make_float2(v0, v1);
    }
  }
}

// [rows, K] int8, K-major, 128-byte boxes of 128 rows; false if the driver
// refuses it
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int k) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {kBK, 128};
  return vlm::tensor_map_sw128(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, ptr, 2,
                               dims, strides, box);
}

}  // namespace

// Returns cudaErrorInvalidValue for shapes it does not take and
// cudaErrorNotSupported if a tensor map cannot be encoded.
extern "C" int vlm_int8xint8_matmul(const void* qx, const void* sx,
                                    const void* qw, const void* sw, void* y,
                                    int M, int N, int K, int out_bf16,
                                    void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 2 != 0 ||
      reinterpret_cast<uintptr_t>(qx) % 16 || reinterpret_cast<uintptr_t>(qw) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_x, tm_w;
  if (!tensor_map(&tm_x, qx, M, K) || !tensor_map(&tm_w, qw, N, K))
    return static_cast<int>(cudaErrorNotSupported);
  const cudaError_t err = cudaFuncSetAttribute(
      int8xint8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  int8xint8_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      tm_x, tm_w, static_cast<const float*>(sx), static_cast<const float*>(sw),
      y, M, N, K, out_bf16);
  return static_cast<int>(cudaGetLastError());
}
