// B7, the decode form: grouped int4 GEMM, y = x . dequant(q, scale)^T,
// for the 4bit products of at most 64 rows (decode steps; the prefill form,
// int4_prefill.cu, takes more rows) and for those whose packed rows are not
// a multiple of 16 bytes, which the prefill form cannot load by TMA, below
// the rows from which ops/quant.py `dense_int4` takes the dequantized
// product instead (`int4_dequant_gate`: 1,536).
//
// Replaces vlm_tpu/ops/quant.py `_int4_matmul_kernel` (launched by
// `_int4_matmul_pallas`): x [M, K] bf16; q [N, K/2] int8, byte j of row n
// holding k = 2j in its low nibble and k = 2j + 1 in its high nibble, both
// two's complement (the nn.Linear layout; the TPU kernel took the same bytes
// as [K/2, N]); scale [N, K/gs] fp32, one per group of gs inputs; y [M, N]
// bf16. Each weight is bf16(nibble * scale) with the product in fp32 and one
// rounding, and the sums accumulate in fp32 on the tensor cores: the numbers
// of the Pallas body and of the plain version.
//
// The TPU kernel split x into even and odd columns and ran two dots, because
// its matrix unit could not re-interleave nibbles. Here a lane's 16-byte
// word of packed weights is 32 neighbouring k of one column, and the
// mainloop reads x through the same order of k, so x stays whole.
//
// What bounds it on the H100: weight bytes (a Gemma decode step at 32
// slots streams 0.99 GB of packed int4 plus 62 MB of fp32 scales, >= 0.31
// ms at 3.35 TB/s) and, as close, the issue rate: each packed byte is two
// nibbles to convert and feed to mma.sync, and the card issues about 8-9
// thread instructions for each byte its memory delivers (132 SMs x 4
// schedulers x 32 lanes at 1.98 GHz against 3.35 TB/s;
// testing/quant_breakdown.py counts the mainloop's instructions: PERF.md).
// The mainloop (weight_stream.cuh, shared with B5) keeps 64-96 KB of
// weights in flight an SM in 128-byte chunks of 256 k, stages each chunk's
// group scales beside it (256 / gs a column), converts whole words in
// registers with one LOP3, one FADD and one FMUL a nibble
// (`dequant_s4x4`: the nibble taken in place, its scale pre-divided by
// 2^p; the old conversion shifted each nibble down first) and splits K
// over a thread block cluster. Packed rows that are
// only 8-byte aligned (SigLIP fc2: K = 4304, 2,152 bytes) take the same
// kernel with 8-byte copies, chosen here from the pitch.
//
// Requirements (checked by the wrapper and here): K % 16 == 0, gs a power
// of two in [16, 128] dividing K, N even, contiguous tensors with 16-byte
// aligned bases.
#include "weight_stream.cuh"

// bm, bn: the plan's tile (16, 32 or 64 rows; 64 or 128 columns;
// ops/quant.py `stream_plan`); splits blocks of one cluster share each
// output tile, `per` 128-byte chunks each; y is bf16, or fp32 where f32.
extern "C" int vlm_int4_matmul(const void* x, const void* q, const void* scale,
                               void* y, int M, int N, int K, int group_size,
                               int bm, int bn, int splits, int per, int f32,
                               void* stream) {
  constexpr int kChunk = vlm::ws::kSubs * vlm::ws::kSub;
  const int row_bytes = K / 2;
  int lg = 0;
  while ((1 << lg) < group_size) ++lg;
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 2 != 0 ||
      group_size < 16 || group_size > 128 || (1 << lg) != group_size ||
      K % group_size != 0 || per < 1 ||
      (long long)per * splits * kChunk < row_bytes ||
      (long long)per * (splits - 1) * kChunk >= row_bytes)
    return (int)cudaErrorInvalidValue;
  const vlm::ws::Args a{static_cast<const __nv_bfloat16*>(x),
                        static_cast<const uint8_t*>(q),
                        static_cast<const float*>(scale),
                        y, M, N, K, row_bytes, K / group_size, lg, per, 0,
                        f32 != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return row_bytes % 16 == 0
             ? vlm::ws::launch<vlm::ws::Fmt::kInt4, 0>(a, bm, bn, splits, st)
             : vlm::ws::launch<vlm::ws::Fmt::kInt4, 8>(a, bm, bn, splits, st);
}

// ---- the narrow form: small products at 32 rows or fewer ----
//
// Where the weights are a few MB, the mainloop's fixed phases outweigh its
// streaming (PERF.md, %globaltimer stamps: of a 5.75 us launch at
// Gemma's q/o and 8 rows, 1.0 us waited for the first chunk and 1.75 us
// went to the cluster's split reduction). Here a block of 8 warps owns 16
// weight rows and each warp a strided eighth of K: every lane loads its
// 16-byte weight words and its x words straight into registers (no ring, no
// barrier, the next sub-chunk's loads in flight during this one's
// products), converts them as the swapped mainloop does (weights the A
// operand of mma.sync, x the B operand) and the 8 warps' fp32 partials are
// summed in warp order through shared memory: no cluster.
namespace {

namespace ws = vlm::ws;

constexpr int kNarrowCols = 16;   // weight rows a block
constexpr int kNarrowK = 128;     // k a sub-chunk: 64 packed bytes a row

// one sub-chunk's registers: rows g and g + 8's 16-byte words, x rows
// 8 j + g's pieces (h, e), and the rows' group scales of halves h
template <int MJ>
struct NarrowTile {
  uint4 w[2];
  uint4 x[MJ][2][2];
  float sc[2][2];
};

template <int MJ>
__device__ __forceinline__ void narrow_load(NarrowTile<MJ>& d,
                                            const ws::Args& a, int n0,
                                            int sub, int g, int t) {
  const int k_lane = sub * kNarrowK + 32 * t;  // the lane's 32 k
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int n = n0 + g + 8 * hr;
    const bool ok = n < a.N && k_lane < a.K;
    d.w[hr] = ok ? __ldg(reinterpret_cast<const uint4*>(
                       a.q + (int64_t)n * a.row_bytes + k_lane / 2))
                 : make_uint4(0u, 0u, 0u, 0u);  // zero weights
    const float* row = a.scale + (int64_t)min(n, a.N - 1) * a.G;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      d.sc[hr][h] = __ldg(row + min((k_lane + 16 * h) >> a.lg, a.G - 1));
  }
#pragma unroll
  for (int j = 0; j < MJ; ++j) {
    const int r = 8 * j + g;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = k_lane + 16 * h + 8 * e;
        d.x[j][h][e] = r < a.M && k < a.K
                           ? __ldg(reinterpret_cast<const uint4*>(
                                 a.x + (int64_t)r * a.K + k))
                           : make_uint4(0u, 0u, 0u, 0u);
      }
  }
}

template <int MJ>
__device__ __forceinline__ void narrow_compute(const NarrowTile<MJ>& d,
                                               float (&acc)[MJ][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s4[2][4];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float sc = d.sc[hr][h];
      s4[hr][0] = sc;
      s4[hr][1] = sc * 0x1p-4f;
      s4[hr][2] = sc * 0x1p-8f;
      s4[hr][3] = sc * 0x1p-12f;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        // step s = 4h + 2e + s2: bytes 2s, 2s + 1 of each row's word
        uint32_t af[4];
        const uint32_t u0 = ws::word(d.w[0], 2 * h + e) ^ 0x88888888u;
        const uint32_t u1 = ws::word(d.w[1], 2 * h + e) ^ 0x88888888u;
        ws::dequant_s4x4(s2 ? u0 >> 16 : u0, s4[0], af[0], af[2]);
        ws::dequant_s4x4(s2 ? u1 >> 16 : u1, s4[1], af[1], af[3]);
#pragma unroll
        for (int j = 0; j < MJ; ++j) {
          const uint4 xv = d.x[j][h][e];
          vlm::mma16816(acc[j], af, s2 ? xv.z : xv.x, s2 ? xv.w : xv.y);
        }
      }
  }
}

// W warps a block (8, or 16 where the blocks are few)
template <int MJ, int W>
__global__ void __launch_bounds__(W * 32)
narrow_kernel(const ws::Args a) {
  constexpr int kNarrowWarps = W;
  __shared__ float red[kNarrowWarps][MJ * 4][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kNarrowCols;
  const int subs = (a.K + kNarrowK - 1) / kNarrowK;
  float acc[MJ][4];
#pragma unroll
  for (int j = 0; j < MJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // warp w takes sub-chunks w, w + W, ...: two in flight, one computed
  NarrowTile<MJ> da, db;
  int s = warp;
  if (s < subs) narrow_load(da, a, n0, s, g, t);
  for (; s < subs; s += 2 * kNarrowWarps) {
    if (s + kNarrowWarps < subs)
      narrow_load(db, a, n0, s + kNarrowWarps, g, t);
    narrow_compute(da, acc);
    if (s + kNarrowWarps >= subs) break;
    if (s + 2 * kNarrowWarps < subs)
      narrow_load(da, a, n0, s + 2 * kNarrowWarps, g, t);
    narrow_compute(db, acc);
  }
#pragma unroll
  for (int j = 0; j < MJ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][4 * j + c][lane] = acc[j][c];
  __syncthreads();
  // element i of every lane: summed over the warps in order by warp i % W;
  // acc[j][c] is y[8 j + 2t + c % 2][n0 + g + 8 (c / 2)] (W . x^T)
  for (int i = warp; i < MJ * 4; i += kNarrowWarps) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kNarrowWarps; ++w) v += red[w][i][lane];
    const int j = i / 4, c = i % 4;
    const int row = 8 * j + 2 * t + (c & 1);
    const int col = n0 + g + 8 * (c >> 1);
    if (row < a.M && col < a.N) {
      const int64_t at = (int64_t)row * a.N + col;
      if (a.f32)
        static_cast<float*>(a.y)[at] = v;
      else
        static_cast<__nv_bfloat16*>(a.y)[at] = __float2bfloat16_rn(v);
    }
  }
}

}  // namespace

// The narrow form (m <= 32, K % 32 == 0: 16-byte packed words): blocks of
// 16 weight rows, K split over the block's `warps` (8 or 16) warps; y bf16,
// or fp32 where f32.
extern "C" int vlm_int4_matmul_narrow(const void* x, const void* q,
                                      const void* scale, void* y, int M,
                                      int N, int K, int group_size,
                                      int warps, int f32, void* stream) {
  int lg = 0;
  while ((1 << lg) < group_size) ++lg;
  if (M <= 0 || M > 32 || N <= 0 || K <= 0 || K % 32 != 0 || N % 2 != 0 ||
      (warps != 8 && warps != 16) ||
      group_size < 16 || group_size > 128 || (1 << lg) != group_size ||
      K % group_size != 0 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return (int)cudaErrorInvalidValue;
  const vlm::ws::Args a{static_cast<const __nv_bfloat16*>(x),
                        static_cast<const uint8_t*>(q),
                        static_cast<const float*>(scale),
                        y, M, N, K, K / 2, K / group_size, lg, 0, 0,
                        f32 != 0};
  const dim3 grid((N + kNarrowCols - 1) / kNarrowCols);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = warps * 32;
  if (warps == 8) {
    if (M <= 8) narrow_kernel<1, 8><<<grid, threads, 0, st>>>(a);
    else if (M <= 16) narrow_kernel<2, 8><<<grid, threads, 0, st>>>(a);
    else narrow_kernel<4, 8><<<grid, threads, 0, st>>>(a);
  } else {
    if (M <= 8) narrow_kernel<1, 16><<<grid, threads, 0, st>>>(a);
    else if (M <= 16) narrow_kernel<2, 16><<<grid, threads, 0, st>>>(a);
    else narrow_kernel<4, 16><<<grid, threads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}
