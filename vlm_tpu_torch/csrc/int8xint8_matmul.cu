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
// K N weight bytes, ~2,500 operations a byte) and, where the output tiles
// are few, the SMs they leave idle. Only wgmma reaches the card's int8 rate
// (1,979 dense TOPS). The design:
// - Output tiles of 64 C rows (C = 1 or 2 consumer warpgroups, each
//   issuing wgmma.mma_async.m64nBNk32.s32.s8.s8 with both operands read
//   from shared memory through descriptors: K-major, the only layout
//   wgmma takes for 8-bit operands and the port's layout of qx and qw) by
//   BN = 128 or 64 columns, chosen per shape on the host (ops/quant.py
//   `int8xint8_plan`): 128 x 128 where the tiles cover the SMs, narrower
//   tiles where they do not (Gemma's k/v at m = 1264: 20 tiles of 128 x
//   128 filled 15 % of the card, 80 of 64 x 64 fill 61 %).
// - A producer warp keeps TMA loads (cp.async.bulk.tensor, the 128-byte
//   swizzle the descriptors name) in flight through a ring of 128-byte K
//   steps as deep as shared memory allows (3-8 stages); full and empty
//   mbarriers hand stages between it and the consumers, which keep one
//   wgmma group in flight while they release the stage before.
// - Persistent blocks: each block walks output tiles (M tiles fastest, so
//   the blocks in flight share a few weight column blocks and reread qx
//   from L2), its producer running ahead into the next tile's stages while
//   the consumers finish the last one's epilogue. The staged form (one
//   block an SM) writes each tile through shared memory (the 128-byte
//   swizzle, conflict-free) and a TMA store, which drains while the next
//   tile's products run; the direct form (two blocks an SM, the first
//   design's) stores from registers and overlaps one block's epilogue with
//   the other's products. The plan picks the form per shape: the direct
//   form where the tiles are between one and two waves of SMs and K is long
//   (one block an SM would leave a second, mostly idle wave).
// - No split of K. Two were measured against the tiles above on every
//   serving shape and lost at each: int32 partials in device memory (the
//   first design's trial) and, in this design, in a thread block
//   cluster's distributed shared memory (Gemma's k/v at m = 1264: 9.4 us
//   split in 4 against 6.7 us for 80 tiles of 64 x 64 unsplit; PERF.md
//   §6). Where 128 x 128 tiles are fewer than the SMs, the plan takes the
//   tile that keeps the most SMs busy in one wave instead.
// - Ragged edges cost nothing: TMA fills out-of-bounds rows and K tails
//   with zeros, which add nothing to the sums, and clips the stores. TMA
//   needs 16-byte row strides: K % 16 == 0 (and, for the staged store,
//   N % 4 == 0 for fp32, N % 8 == 0 for bf16).
// - The tensor maps are encoded on the host at every call by
//   cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no
//   -lcuda); a cache of them measured no faster
//   (about 20 us of host time a call either way). Activation quantization
//   stays outside, in PyTorch, as JAX computed it in XLA.
//
// Requirements (checked by the wrapper and here): K % 16 == 0, N even,
// contiguous operands and output, 16-byte aligned bases.
#include "common.cuh"

namespace {

using vlm::desc_sw128;
using vlm::mbar_arrive;
using vlm::mbar_expect_tx;
using vlm::mbar_init;
using vlm::mbar_wait;
using vlm::smem_u32;

constexpr int kBK = 128;  // bytes = int8 elements: one 128-byte swizzle row
constexpr int kMaxStages = 8;
constexpr int kBarBytes = 256;
// one block an SM (the staged form) or two (the direct form)
constexpr int kSmemOne = 227 * 1024;
constexpr int kSmemTwo = 228 * 1024 / 2 - 1024;

template <int C, int BN, bool kStaged>
struct Geo {
  static constexpr int kBM = 64 * C;
  static constexpr int kThreads = 128 * C + 32;
  static constexpr int kTileA = kBM * kBK;
  static constexpr int kTileB = BN * kBK;
  static constexpr int kStageBytes = kTileA + kTileB;
  // a consumer warpgroup's 64 x BN output tile in fp32 (bf16 uses half)
  static constexpr int kStaging = kStaged ? C * 64 * BN * 4 : 0;
  static constexpr int kBudget = kStaged ? kSmemOne : kSmemTwo;
  static constexpr int kFit =
      (kBudget - 1024 - kBarBytes - kStaging) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem =
      1024 + kStaging + kStages * kStageBytes + kBarBytes;
  static_assert(kStages >= 3, "a ring of at least three stages");
};

// wgmma.m64nNk32 s8 x s8 -> s32, both operands K-major in shared memory
#define VLM_I32(i) "+r"(d[i])
template <int N>
struct Wgmma;

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void run(int* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
        "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
        : VLM_I32(0), VLM_I32(1), VLM_I32(2), VLM_I32(3), VLM_I32(4),
          VLM_I32(5), VLM_I32(6), VLM_I32(7), VLM_I32(8), VLM_I32(9),
          VLM_I32(10), VLM_I32(11), VLM_I32(12), VLM_I32(13), VLM_I32(14),
          VLM_I32(15), VLM_I32(16), VLM_I32(17), VLM_I32(18), VLM_I32(19),
          VLM_I32(20), VLM_I32(21), VLM_I32(22), VLM_I32(23), VLM_I32(24),
          VLM_I32(25), VLM_I32(26), VLM_I32(27), VLM_I32(28), VLM_I32(29),
          VLM_I32(30), VLM_I32(31), VLM_I32(32), VLM_I32(33), VLM_I32(34),
          VLM_I32(35), VLM_I32(36), VLM_I32(37), VLM_I32(38), VLM_I32(39),
          VLM_I32(40), VLM_I32(41), VLM_I32(42), VLM_I32(43), VLM_I32(44),
          VLM_I32(45), VLM_I32(46), VLM_I32(47), VLM_I32(48), VLM_I32(49),
          VLM_I32(50), VLM_I32(51), VLM_I32(52), VLM_I32(53), VLM_I32(54),
          VLM_I32(55), VLM_I32(56), VLM_I32(57), VLM_I32(58), VLM_I32(59),
          VLM_I32(60), VLM_I32(61), VLM_I32(62), VLM_I32(63)
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void run(int* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
        "%29, %30, %31}, %32, %33, p;\n}\n"
        : VLM_I32(0), VLM_I32(1), VLM_I32(2), VLM_I32(3), VLM_I32(4),
          VLM_I32(5), VLM_I32(6), VLM_I32(7), VLM_I32(8), VLM_I32(9),
          VLM_I32(10), VLM_I32(11), VLM_I32(12), VLM_I32(13), VLM_I32(14),
          VLM_I32(15), VLM_I32(16), VLM_I32(17), VLM_I32(18), VLM_I32(19),
          VLM_I32(20), VLM_I32(21), VLM_I32(22), VLM_I32(23), VLM_I32(24),
          VLM_I32(25), VLM_I32(26), VLM_I32(27), VLM_I32(28), VLM_I32(29),
          VLM_I32(30), VLM_I32(31)
        : "l"(da), "l"(db), "r"(1));
  }
};
#undef VLM_I32

// keep the compiler from moving accumulator accesses across the async span
template <int R>
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// one box of shared memory to a 2-D tensor map at coordinates c (clipped
// out of bounds)
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

struct Args {
  const float* sx;  // [M]
  const float* sw;  // [N]
  void* y;          // [M, N] fp32, or bf16 where out_bf16
  int M, N, K;
  int out_bf16;
  int tiles_m, tiles;
};

template <int C, int BN, bool kStaged>
__global__ void __launch_bounds__(Geo<C, BN, kStaged>::kThreads,
                                   kStaged ? 1 : 2)
int8xint8_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_y, const Args a) {
  using G = Geo<C, BN, kStaged>;
  constexpr int S = G::kStages;
  constexpr int R = BN / 2;  // int32 accumulators a consumer thread
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align to it
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* staging = smem;
  unsigned char* ring = smem + G::kStaging;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * G::kStageBytes);
  uint64_t* empty = full + kMaxStages;
  const int wg = threadIdx.x / 128;
  const int nk = (a.K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile t is row tile t % tiles_m of column tile t / tiles_m. The staged
  // form's persistent blocks walk t = block, block + grid, ...; the direct
  // form's block takes its one tile, straight-line code
  auto each_tile = [&](auto&& body) {
    if constexpr (kStaged) {
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x)
        body((tile % a.tiles_m) * G::kBM, (tile / a.tiles_m) * BN);
    } else {
      body((blockIdx.x % a.tiles_m) * G::kBM, (blockIdx.x / a.tiles_m) * BN);
    }
  };
  int it = 0;  // the ring's step, across the block's tiles

  if (wg == C) {
    // producer: one thread keeps the ring full across the block's tiles
    if (threadIdx.x == 128 * C)
      each_tile([&](int m0, int n0) {
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(&empty[s], ((it / S) - 1) & 1);
          unsigned char* st = ring + s * G::kStageBytes;
          mbar_expect_tx(&full[s], G::kStageBytes);
          vlm::tma_load_2d(st, &tm_x, &full[s], ks * kBK, m0);
          vlm::tma_load_2d(st + G::kTileA, &tm_w, &full[s], ks * kBK, n0);
        }
      });
    return;
  }

  // accumulator layout: acc[4 j + e] is row 16 warp + g (+8 for e >= 2),
  // column 8 j + 2 t (+1 for odd e) of the warpgroup's 64 x BN
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_lo = 16 * warp + g;  // the thread's rows in the 64: + 8 h
  int acc[R];
  each_tile([&](int m0, int n0) {
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0;
    // the staged form's scales of the tile, loaded before its products
    // (a device-memory load at the epilogue stalled each tile's end)
    float ws[kStaged ? BN / 8 : 1][2], xs[2];
    if constexpr (kStaged) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = min(n0 + 8 * j + 2 * t, a.N - 2);
        ws[j][0] = a.sw[col];
        ws[j][1] = a.sw[col + 1];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        xs[h] = a.sx[min(m0 + 64 * wg + row_lo + 8 * h, a.M - 1)];
    }
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const uint32_t at = smem_u32(ring + s * G::kStageBytes + wg * 64 * kBK);
      const uint32_t bt = smem_u32(ring + s * G::kStageBytes + G::kTileA);
      fence_acc<R>(acc);
      vlm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        Wgmma<BN>::run(acc, desc_sw128(at + 32 * kk), desc_sw128(bt + 32 * kk));
      vlm::wgmma_commit();
      vlm::wgmma_wait<1>();  // the previous step's products are done
      fence_acc<R>(acc);
      if (ks > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % S]);
    }
    vlm::wgmma_wait<0>();
    fence_acc<R>(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % S]);

    if constexpr (kStaged) {
      // through shared memory: boxes of [64 rows, 128 bytes] under the
      // 128-byte swizzle (32 fp32 or 64 bf16 columns), one TMA store each
      unsigned char* mine = staging + wg * 64 * BN * 4;
      if (threadIdx.x % 128 == 0) {
        // the previous tile's stores have read the staging
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      named_sync(1 + wg, 128);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row_lo + 8 * h;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          // (float(acc) * sx) * sw, two roundings, in the reference's order
          const float f0 =
              static_cast<float>(acc[4 * j + 2 * h]) * xs[h] * ws[j][0];
          const float f1 =
              static_cast<float>(acc[4 * j + 2 * h + 1]) * xs[h] * ws[j][1];
          if (a.out_bf16) {
            // box j / 8; byte 16 (j % 8) + 4 t of the row
            unsigned char* p = mine + (j / 8) * 8192 + r * 128 +
                               (((j % 8) ^ (r & 7)) << 4) + 4 * t;
            *reinterpret_cast<__nv_bfloat162*>(p) =
                __floats2bfloat162_rn(f0, f1);
          } else {
            // box j / 4; byte 32 (j % 4) + 8 t of the row
            const int chunk = 2 * (j % 4) + (t >> 1);
            unsigned char* p = mine + (j / 4) * 8192 + r * 128 +
                               ((chunk ^ (r & 7)) << 4) + 8 * (t & 1);
            *reinterpret_cast<float2*>(p) = make_float2(f0, f1);
          }
        }
      }
      vlm::fence_proxy_async();  // visible to the TMA (async proxy)
      named_sync(1 + wg, 128);
      if (threadIdx.x % 128 == 0) {
        const int boxes = a.out_bf16 ? BN / 64 : BN / 32;
        const int cols = a.out_bf16 ? 64 : 32;
        for (int b = 0; b < boxes; ++b)
          tma_store_2d(&tm_y, mine + b * 8192, n0 + b * cols, m0 + 64 * wg);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    } else {
      // from registers: two columns a store
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 64 * wg + row_lo + 8 * h;
        xs[h] = row < a.M ? a.sx[row] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;  // N even: col + 1 < N too
        if (col >= a.N) continue;
        const float w0 = a.sw[col], w1 = a.sw[col + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + 64 * wg + row_lo + 8 * h;
          if (row >= a.M) continue;
          // (float(acc) * sx) * sw, two roundings, in the reference's order
          const float f0 = static_cast<float>(acc[4 * j + 2 * h]) * xs[h] * w0;
          const float f1 =
              static_cast<float>(acc[4 * j + 2 * h + 1]) * xs[h] * w1;
          const int64_t off = static_cast<int64_t>(row) * a.N + col;
          if (a.out_bf16)
            *reinterpret_cast<__nv_bfloat162*>(
                static_cast<__nv_bfloat16*>(a.y) + off) =
                __floats2bfloat162_rn(f0, f1);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(a.y) + off) =
                make_float2(f0, f1);
        }
      }
    }
  });
  if constexpr (kStaged) {
    if (threadIdx.x % 128 == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

using KernelFn = void (*)(const CUtensorMap, const CUtensorMap,
                          const CUtensorMap, const Args);

// [rows, K] int8, K-major, boxes of [box_rows, 128 bytes] under the
// 128-byte swizzle; false if cuTensorMapEncodeTiled refuses it
bool operand_map(CUtensorMap* map, const void* ptr, int rows, int k,
                 int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  return vlm::tensor_map_sw128(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, ptr, 2,
                               dims, strides, box);
}

// the output [M, N], boxes of [64 rows, 128 bytes] under the swizzle
bool output_map(CUtensorMap* map, void* y, int M, int N, bool bf16) {
  const int elem = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem), 64};
  return vlm::tensor_map_sw128(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      y, 2, dims, strides, box);
}

template <int C, int BN, bool kStaged>
int launch(const void* qx, const void* qw, Args a, int grid,
           cudaStream_t stream) {
  using G = Geo<C, BN, kStaged>;
  CUtensorMap tm_x, tm_w, tm_y = {};
  if (!operand_map(&tm_x, qx, a.M, a.K, G::kBM) ||
      !operand_map(&tm_w, qw, a.N, a.K, BN) ||
      (kStaged && !output_map(&tm_y, a.y, a.M, a.N, a.out_bf16 != 0)))
    return static_cast<int>(cudaErrorNotSupported);
  const KernelFn kernel = int8xint8_kernel<C, BN, kStaged>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(tm_x, tm_w, tm_y, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan (ops/quant.py `int8xint8_plan`): consumers C (tiles of 64 C
// rows) and BN columns (128 or 64), staged (the TMA-store epilogue, one
// block an SM) or direct (two blocks an SM), and `grid` persistent blocks
// walking the tiles (at most one a tile). Returns cudaErrorInvalidValue
// for what it does not take and cudaErrorNotSupported if a tensor map
// cannot be encoded.
extern "C" int vlm_int8xint8_matmul(const void* qx, const void* sx,
                                    const void* qw, const void* sw, void* y,
                                    int M, int N, int K, int out_bf16,
                                    int consumers, int bn, int staged,
                                    int grid, void* stream) {
  const int elem = out_bf16 ? 2 : 4;
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 2 != 0 ||
      reinterpret_cast<uintptr_t>(qx) % 16 ||
      reinterpret_cast<uintptr_t>(qw) % 16 || grid < 1 ||
      (staged && ((static_cast<long long>(N) * elem) % 16 ||
                  reinterpret_cast<uintptr_t>(y) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_m = (M + 64 * consumers - 1) / (64 * consumers);
  const Args a{static_cast<const float*>(sx), static_cast<const float*>(sw),
               y, M, N, K, out_bf16, tiles_m,
               tiles_m * ((N + bn - 1) / bn)};
  // the direct form: one block a tile; the staged form: at most one a tile
  if (grid > a.tiles || !staged) grid = a.tiles;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (consumers == 2 && bn == 128)
    return staged ? launch<2, 128, true>(qx, qw, a, grid, st)
                  : launch<2, 128, false>(qx, qw, a, grid, st);
  if (consumers == 2 && bn == 64)
    return staged ? launch<2, 64, true>(qx, qw, a, grid, st)
                  : launch<2, 64, false>(qx, qw, a, grid, st);
  if (consumers == 1 && bn == 64)
    return staged ? launch<1, 64, true>(qx, qw, a, grid, st)
                  : launch<1, 64, false>(qx, qw, a, grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
