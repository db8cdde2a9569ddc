// B7, the prefill form: grouped int4 GEMM y = x . dequant(q, scale)^T for
// products of more than 64 rows (admissions: BLIP-2's 4 x 92 OPT rows, the
// int4 towers, the 4bit admissions of 4 images), on wgmma.
//
// Replaces vlm_tpu/ops/quant.py `_int4_matmul_kernel` (launched by
// `_int4_matmul_pallas`) where x has more than 64 rows; the decode form
// (m <= 64) is the weight-streaming mainloop of int4_matmul.cu. Same
// function, same numbers: q [N, K/2] packed nibbles (k = 2j low, 2j + 1
// high, two's complement; the nn.Linear layout), scale [N, K/gs] fp32, each
// weight bf16(fp32(nibble) * scale) rounded once, x [M, K] bf16, fp32
// accumulation, y bf16 or fp32 (a row-parallel rank's partial).
//
// What bounds it on the H100: tensor-core operations (2 M N K against the
// N K / 2 packed bytes: at M = 368, ~1,500 operations a byte, five times
// the bf16 ridge). The decode form ran these rows as 64-row tiles on
// mma.sync, each tile re-reading and re-dequantizing every weight: 14-17 %
// of the bf16 bound at M = 368. Here:
// - A block owns 128 weight rows (output columns) and 64 C rows of x (C =
//   2 or 3 consumer warpgroups, one m64 tile each; the host picks C so
//   that the row tiles pad least; with 4, ptxas leaves 80 registers a
//   thread, fewer than wgmma.m64n128's 64 accumulators and their
//   addressing need) and walks K in stages of 64: a producer
//   warp keeps a ring of stages in flight by TMA (x's [64 C, 64] bf16 box
//   under the 128-byte swizzle, the packed [128, 32-byte] weight box),
//   as deep as shared memory allows (4-6 stages).
// - One dequantizing warpgroup turns each stage's packed weights into a
//   bf16 [128, 64] K-major tile under the 128-byte swizzle, the B operand
//   of wgmma, in a ring of three such tiles: each weight is dequantized once
//   a block, while the consumers multiply the tile before. A thread takes
//   one 16-byte word of two weight rows (32 nibbles each) and writes each
//   32-bit word's 8 nibbles as one 16-byte chunk of bf16.
// - Each consumer warpgroup runs wgmma.m64n128k16 (both operands from
//   shared memory) for its 64 rows against the shared tile, one commit
//   group a stage, and frees the stage and the tile the step before.
// - The nibble conversion spends one LOP3 a nibble where the old one spent
//   a shift and a mask: nibble n at bit p (0, 4, 8 or 12 of a word or of
//   the word shifted by 16), XORed to n + 8, ORed into 0x4B000000 gives the
//   fp32 2^23 + (n + 8) 2^p; minus 2^23 + 8 2^p it is n 2^p exactly, and
//   times scale 2^-p (exact: a power of two) it is n * scale rounded once
//   to fp32, bit for bit the plain version's, then once to bf16.
// - Where the column and row tiles leave SMs idle, K is split over a thread
//   block cluster of `splits` blocks, reduced through distributed shared
//   memory in rank order (fp32 partials in each block's ring): no
//   workspace, deterministic.
//
// Requirements (checked by the wrapper and here): K % 32 == 0 (16-byte
// packed rows for TMA; SigLIP fc2's 2,152-byte rows take the decode form),
// gs a power of two in [16, 128] dividing K, N even, contiguous tensors
// with 16-byte aligned bases.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

using vlm::desc_sw128;
using vlm::mbar_arrive;
using vlm::mbar_expect_tx;
using vlm::mbar_init;
using vlm::mbar_wait;
using vlm::smem_u32;

constexpr int kBN = 128;                   // weight rows a block
constexpr int kBK = 64;                    // k a stage
constexpr int kPackRow = kBK / 2;          // packed bytes of a row a stage
constexpr int kWTile = kBN * kBK * 2;      // a bf16 weight tile: 16 KB
constexpr int kPackTile = kBN * kPackRow;  // 4 KB
constexpr int kBufs = 3;                   // bf16 weight tiles
constexpr int kMaxStages = 6;
constexpr int kMaxSplits = 8;
constexpr int kSmemMax = 227 * 1024;
constexpr int kBarBytes = 256;

template <int C>
struct Geo {
  static constexpr int kRows = 64 * C;            // rows of x a block
  static constexpr int kXTile = kRows * kBK * 2;  // 1024-byte multiple
  static constexpr int kStage = kXTile + kPackTile;
  static constexpr int kThreads = 128 * (C + 1) + 32;
  static constexpr int kFit =
      (kSmemMax - 1024 - kBufs * kWTile - kBarBytes) / kStage;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem =
      1024 + kBufs * kWTile + kStages * kStage + kBarBytes;
  // a split's fp32 partials: 64 floats a consumer thread, in the ring
  static_assert(kStages * kStage >= 128 * C * 64 * 4, "partials fit");
  static_assert(kStages >= 3, "a ring of at least three stages");
};

#define VLM_ACC64(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),      \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d[64 x 128] += a[64 x 16] . b[128 x 16]^T, bf16 in, fp32 accumulate,
// both operands K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : VLM_ACC64(d)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Eight nibbles of a packed 32-bit word (k 0-7: byte b holds 2b low, 2b + 1
// high), already XORed with 0x88888888 (n + 8), as four bf16 pairs in k
// order. s4 = scale * {1, 2^-4, 2^-8, 2^-12}: the nibble at bit 4 j of the
// word (or of the word shifted by 16) is taken in place.
__device__ __forceinline__ uint4 nibbles_to_bf16(uint32_t v, const float* s4) {
  const uint32_t w = v >> 16;
  float f[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float magic = 8388608.f + static_cast<float>(8 << (4 * j));
    const uint32_t mask = 0xFu << (4 * j);
    f[j] = (__uint_as_float(vlm::and_or(v, mask, 0x4B000000u)) - magic) *
           s4[j];
    f[4 + j] = (__uint_as_float(vlm::and_or(w, mask, 0x4B000000u)) - magic) *
               s4[j];
  }
  return make_uint4(vlm::pack_bf16(f[0], f[1]), vlm::pack_bf16(f[2], f[3]),
                    vlm::pack_bf16(f[4], f[5]), vlm::pack_bf16(f[6], f[7]));
}

struct Args {
  const float* scale;  // [N, G]
  void* y;             // [M, N] bf16, or fp32 where f32
  int M, N, K;
  int G, lg;           // groups a row, log2(group size)
  int per;             // stages a split
  int f32;
};

template <int C>
__global__ void __launch_bounds__(Geo<C>::kThreads, 1)
int4_prefill_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_q, const Args a) {
  using G = Geo<C>;
  constexpr int S = G::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* wbuf = smem;                    // kBufs bf16 tiles
  unsigned char* ring = smem + kBufs * kWTile;   // S stages: x, then packed
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * G::kStage);
  uint64_t* empty = full + kMaxStages;
  uint64_t* ready = empty + kMaxStages;
  uint64_t* freed = ready + kBufs;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * G::kRows;
  const int stages = (a.K + kBK - 1) / kBK;
  const int s0 = blockIdx.z * a.per;
  const int nk = max(0, min(stages, s0 + a.per) - s0);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C);  // one arrival a consumer warpgroup
    }
    for (int b = 0; b < kBufs; ++b) {
      mbar_init(&ready[b], 128);  // every dequantizing thread
      mbar_init(&freed[b], C);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int splits = gridDim.z;
  constexpr int kCT = 128 * C;  // consumer threads
  // a split's fp32 partials: [pair q][consumer thread] in each block's ring
  float2* part = reinterpret_cast<float2*>(ring);

  if (wg > C) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == 128 * (C + 1)) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(&empty[s], ((i / S) - 1) & 1);
        unsigned char* st = ring + s * G::kStage;
        const int k = (s0 + i) * kBK;
        mbar_expect_tx(&full[s], G::kStage);
        vlm::tma_load_2d(st, &tm_x, &full[s], k, m0);
        vlm::tma_load_2d(st + G::kXTile, &tm_q, &full[s], k / 2, n0);
      }
    }
  } else if (wg == C) {
    // dequantization: thread d takes 16-byte word (d & 1) of rows d / 2
    // and d / 2 + 64: k [32 (d & 1), + 32) of the stage
    const int d = threadIdx.x - 128 * C;
    const int half = d & 1;
    const int r0 = d >> 1;
    const bool gs16 = a.lg == 4;  // two groups in a word's 32 k
    for (int i = 0; i < nk; ++i) {
      const int s = i % S, b = i % kBufs;
      const int k0 = (s0 + i) * kBK + 32 * half;
      // each row's group scales of these 32 k (past N or K: a real scale;
      // the nibbles there are zero-filled, so the weight is 0), loaded
      // before the waits
      float sc[2][2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int n = min(n0 + r0 + 64 * rr, a.N - 1);
        const float* row = a.scale + static_cast<int64_t>(n) * a.G;
        sc[rr][0] = __ldg(row + min(k0 >> a.lg, a.G - 1));
        sc[rr][1] = gs16 ? __ldg(row + min((k0 + 16) >> a.lg, a.G - 1))
                         : sc[rr][0];
      }
      if (i >= kBufs) mbar_wait(&freed[b], ((i / kBufs) - 1) & 1);
      mbar_wait(&full[s], (i / S) & 1);
      const unsigned char* pk = ring + s * G::kStage + G::kXTile;
      unsigned char* wt = wbuf + b * kWTile;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = r0 + 64 * rr;
        const uint4 v =
            *reinterpret_cast<const uint4*>(pk + r * kPackRow + 16 * half);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float sj = sc[rr][j >> 1];
          const float s4[4] = {sj, sj * 0x1p-4f, sj * 0x1p-8f, sj * 0x1p-12f};
          const uint32_t u =
              (j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w) ^ 0x88888888u;
          // chunk 4 half + j of row r, under the 128-byte swizzle
          uint4* dst = reinterpret_cast<uint4*>(
              wt + r * 128 + (((4 * half + j) ^ (r & 7)) << 4));
          *dst = nibbles_to_bf16(u, s4);
        }
      }
      vlm::fence_proxy_async();  // the tile is read by wgmma (async proxy)
      mbar_arrive(&ready[b]);
    }
  } else {
    // consumer warpgroup wg: rows [m0 + 64 wg, + 64) against each tile
    // (the accumulators live here alone: the other roles keep their
    // registers)
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    const bool live = m0 + 64 * wg < a.M;
    for (int i = 0; i < nk; ++i) {
      const int s = i % S, b = i % kBufs;
      mbar_wait(&full[s], (i / S) & 1);
      mbar_wait(&ready[b], (i / kBufs) & 1);
      if (live) {
        const uint32_t xa = smem_u32(ring + s * G::kStage + wg * 64 * 128);
        const uint32_t wb = smem_u32(wbuf + b * kWTile);
        fence_acc(acc);
        vlm::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_m64n128k16(acc, desc_sw128(xa + 32 * kk),
                           desc_sw128(wb + 32 * kk));
        vlm::wgmma_commit();
        vlm::wgmma_wait<1>();  // the previous stage's products are done
        fence_acc(acc);
      }
      if (i > 0 && threadIdx.x % 128 == 0) {
        mbar_arrive(&empty[(i - 1) % S]);
        mbar_arrive(&freed[(i - 1) % kBufs]);
      }
    }
    vlm::wgmma_wait<0>();
    fence_acc(acc);

    // accumulator layout: acc[4 j + e] is row 16 warp + g (+8 for e >= 2),
    // column 8 j + 2 t (+1 for odd e) of the warpgroup's 64 x 128
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    auto store = [&](int q, float v0, float v1) {  // pair q = 2 j + h
      const int j = q >> 1, h = q & 1;
      const int row = m0 + 64 * wg + 16 * warp + g + 8 * h;
      const int col = n0 + 8 * j + 2 * t;  // N even: col < N => col + 1 < N
      if (row >= a.M || col >= a.N) return;
      const int64_t at = static_cast<int64_t>(row) * a.N + col;
      if (a.f32)
        *reinterpret_cast<float2*>(static_cast<float*>(a.y) + at) =
            make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.y) +
                                           at) = __floats2bfloat162_rn(v0, v1);
    };
    if (splits == 1) {
#pragma unroll
      for (int q = 0; q < 32; ++q) store(q, acc[2 * q], acc[2 * q + 1]);
      return;
    }
    __syncthreads();  // every warp is past the ring: it takes the partials
#pragma unroll
    for (int q = 0; q < 32; ++q)
      part[q * kCT + threadIdx.x] = make_float2(acc[2 * q], acc[2 * q + 1]);
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int rank = static_cast<int>(cluster.block_rank());
    for (int q = rank; q < 32; q += splits) {
      // every rank's partial loaded before the sum in rank order (the
      // remote loads overlap)
      float2 v[kMaxSplits];
#pragma unroll
      for (int z = 0; z < kMaxSplits; ++z)
        if (z < splits)
          v[z] = cluster.map_shared_rank(part, z)[q * kCT + threadIdx.x];
      float2 sum = make_float2(0.f, 0.f);
#pragma unroll
      for (int z = 0; z < kMaxSplits; ++z)
        if (z < splits) {
          sum.x += v[z].x;
          sum.y += v[z].y;
        }
      store(q, sum.x, sum.y);
    }
    cluster.sync();  // no block leaves while another reads its partials
    return;
  }
  // the producer and the dequantizing warpgroup: the split's barriers
  if (splits > 1) {
    __syncthreads();
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    cluster.sync();
  }
}

using KernelFn = void (*)(const CUtensorMap, const CUtensorMap, const Args);

template <int C>
int launch(const void* x, const void* q, Args a, int splits,
           cudaStream_t stream) {
  using G = Geo<C>;
  CUtensorMap tm_x, tm_q;
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.K),
                                static_cast<cuuint64_t>(a.M)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.K) * 2};
    const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(G::kRows)};
    if (!vlm::tensor_map_sw128(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 2,
                               dims, strides, box))
      return static_cast<int>(cudaErrorNotSupported);
  }
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.K / 2),
                                static_cast<cuuint64_t>(a.N)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.K / 2)};
    const cuuint32_t box[2] = {kPackRow, kBN};
    if (!vlm::tensor_map(&tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, 2, dims,
                         strides, box, CU_TENSOR_MAP_SWIZZLE_NONE))
      return static_cast<int>(cudaErrorNotSupported);
  }
  const KernelFn kernel = int4_prefill_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + kBN - 1) / kBN, (a.M + G::kRows - 1) / G::kRows,
                     splits);
  cfg.blockDim = dim3(G::kThreads);
  cfg.dynamicSmemBytes = G::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tm_x, tm_q, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// consumers: warpgroups of 64 rows a block (2 or 3: ops/quant.py
// `int4_prefill_plan`); splits blocks of one cluster share each output
// tile, `per` stages of 64 k each; y is bf16, or fp32 where f32.
extern "C" int vlm_int4_matmul_prefill(const void* x, const void* q,
                                       const void* scale, void* y, int M,
                                       int N, int K, int group_size,
                                       int consumers, int splits, int per,
                                       int f32, void* stream) {
  int lg = 0;
  while ((1 << lg) < group_size) ++lg;
  const long long stages = (K + kBK - 1) / kBK;
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 || N % 2 != 0 ||
      group_size < 16 || group_size > 128 || (1 << lg) != group_size ||
      K % group_size != 0 || per < 1 || splits < 1 || splits > kMaxSplits ||
      static_cast<long long>(per) * splits < stages ||
      static_cast<long long>(per) * (splits - 1) >= stages ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(q) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(scale), y, M, N, K, K / group_size,
               lg, per, f32 != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (consumers) {
    case 2: return launch<2>(x, q, a, splits, st);
    case 3: return launch<3>(x, q, a, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
