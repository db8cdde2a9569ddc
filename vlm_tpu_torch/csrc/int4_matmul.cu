// B7: grouped int4 GEMM, y = x . dequant(q, scale)^T, for the 4bit products
// with fewer than 512 rows (decode steps, single-image admissions).
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
// its matrix unit could not re-interleave nibbles. Here one packed byte holds
// two neighbouring k of one column: exactly the pair one 32-bit register of
// the mma.sync.m16n8k16 B fragment holds. So each byte becomes one bf16x2
// register in place and x stays whole.
//
// What bounds it on the H100: weight bytes. A Gemma decode step at 32 slots
// streams 0.99 GB of packed int4 plus 62 MB of fp32 scales, >= 0.31 ms at
// 3.35 TB/s. The skeleton is B5's: a block owns a 64-column strip of the
// output for BM = 32 or 64 rows and walks K in 64-wide steps through a
// 3-stage cp.async ring (x, the packed bytes and the step's group scales),
// zero-filled past the ragged M, N and K edges; narrow products split K over
// up to 16 blocks a strip, and the strip's last block adds the fp32 partials
// in split order (deterministic). The packed rows are K/2 bytes apart, 8-byte
// aligned only (SigLIP fc2: K = 4304, 2152 bytes), so they move in 8-byte
// copies; the scale rows (K/gs floats) in 4-byte copies. A 64-wide K step
// meets at most 4 groups (gs >= 16), so each step stages 4 scale slots a
// column and every k16 step indexes its own by k / gs: group 16 changes the
// scale every step, group 128 every eighth.
//
// Requirements (checked by the wrapper and here): K % 16 == 0, gs % 16 == 0,
// K % gs == 0, N even, contiguous tensors with 16-byte aligned bases.
#include "common.cuh"

namespace {

constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kWarps = 4;
constexpr int kStages = 3;
constexpr int kXPitch = kBK + 8;      // bf16 elements: 144-byte rows, no bank conflicts
constexpr int kQPitch = kBK / 2 + 8;  // bytes: 40-byte rows, 8 columns on 8 banks
constexpr int kSlots = kBK / 16;      // group scales a column can need in one K step

// one packed byte -> the bf16x2 B-fragment register of its two weights (low
// nibble in the low half). b ^ 0x88 maps each nibble n in [-8, 8) to n + 8
// in [0, 16); 2^23 + (n + 8) is exact in fp32, and subtracting 2^23 + 8
// leaves n exactly, with no shift of a negative value and no int->float
// conversion. Then the fp32 product with the group's fp32 scale, rounded
// once to bf16.
__device__ __forceinline__ uint32_t dequant_s4x2(uint32_t byte, float s) {
  const uint32_t u = byte ^ 0x88u;
  const float lo = __uint_as_float(0x4B000000u | (u & 0xFu)) - 8388616.f;
  const float hi = __uint_as_float(0x4B000000u | ((u >> 4) & 0xFu)) - 8388616.f;
  return vlm::pack_bf16(lo * s, hi * s);
}

template <int BM>
__global__ void __launch_bounds__(kWarps * 32)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ q, const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                   int* __restrict__ counters, int M, int N, int K, int GS) {
  constexpr int kWarpsM = BM / 32;            // each warp: 32 rows
  constexpr int kWarpsN = kWarps / kWarpsM;
  constexpr int kWN = kBN / kWarpsN;          // 16 or 32 columns per warp
  constexpr int kNI = kWN / 8;
  constexpr int kXStage = BM * kXPitch;       // bf16 elements
  constexpr int kQStage = kBN * kQPitch;      // bytes
  constexpr int kSStage = kBN * kSlots;       // floats

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* qs = reinterpret_cast<uint8_t*>(xs + kStages * kXStage);
  float* ss = reinterpret_cast<float*>(qs + kStages * kQStage);

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int g = lane / 4;
  const int t = lane % 4;
  const bool active = m0 + wm * 32 < M;       // warp-uniform
  const int K2 = K / 2;                       // bytes per packed row
  const int G = K / GS;                       // scales per row

  auto load = [&](int stage, int k0) {
    __nv_bfloat16* xd = xs + stage * kXStage;
    for (int i = threadIdx.x; i < BM * (kBK / 8); i += blockDim.x) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + c < K;
      vlm::cp_async16(xd + r * kXPitch + c,
                      ok ? x + (int64_t)(m0 + r) * K + k0 + c : x, ok);
    }
    uint8_t* qd = qs + stage * kQStage;
    for (int i = threadIdx.x; i < kBN * (kBK / 16); i += blockDim.x) {
      const int r = i / (kBK / 16), c = (i % (kBK / 16)) * 8;  // 8 bytes = 16 k
      const bool ok = n0 + r < N && k0 / 2 + c < K2;
      vlm::cp_async_small<8>(qd + r * kQPitch + c,
                             ok ? q + (int64_t)(n0 + r) * K2 + k0 / 2 + c : q,
                             ok);
    }
    float* sd = ss + stage * kSStage;
    const int g0 = k0 / GS;
    for (int i = threadIdx.x; i < kBN * kSlots; i += blockDim.x) {
      const int r = i / kSlots, j = i % kSlots;
      const bool ok = n0 + r < N && g0 + j < G && (g0 + j) * GS < k0 + kBK;
      vlm::cp_async_small<4>(sd + i,
                             ok ? scale + (int64_t)(n0 + r) * G + g0 + j : scale,
                             ok);
    }
  };

  float acc[2][kNI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  int kt_begin, kt_end;
  vlm::split_k_range((K + kBK - 1) / kBK, kt_begin, kt_end);
  const int nk = max(0, kt_end - kt_begin);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, (kt_begin + s) * kBK);
    vlm::cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    vlm::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed; tile i - 1 consumed by every warp
    const int next = i + kStages - 1;
    if (next < nk) load(next % kStages, (kt_begin + next) * kBK);
    vlm::cp_async_commit();
    if (!active) continue;

    const int k0 = (kt_begin + i) * kBK;
    const int g0 = k0 / GS;
    const __nv_bfloat16* xt = xs + (i % kStages) * kXStage;
    const uint8_t* qt = qs + (i % kStages) * kQStage;
    const float* st = ss + (i % kStages) * kSStage;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* p = xt + (wm * 32 + mi * 16 + g) * kXPitch + kk * 16 + 2 * t;
        a[mi][0] = vlm::ld32(p);
        a[mi][1] = vlm::ld32(p + 8 * kXPitch);
        a[mi][2] = vlm::ld32(p + 8);
        a[mi][3] = vlm::ld32(p + 8 * kXPitch + 8);
      }
      // a k16 step lies in one group (gs % 16 == 0); past K the bytes and x
      // are zero, so whatever slot it reads adds nothing
      const int slot = (k0 + kk * 16) / GS - g0;
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const int col = wn * kWN + ni * 8 + g;
        // bytes kk*8 + t and + 4: k = 2t, 2t+1 and 2t+8, 2t+9 of the step
        const uint8_t* p = qt + col * kQPitch + kk * 8 + t;
        const float s = st[col * kSlots + slot];
        const uint32_t b0 = dequant_s4x2(p[0], s), b1 = dequant_s4x2(p[4], s);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) vlm::mma16816(acc[mi][ni], a[mi], b0, b1);
      }
    }
  }
  vlm::cp_async_wait<0>();

  if (gridDim.z > 1) {
    // fp32 partials [split, M, N]; the strip's last block sums them
    const int64_t plane = (int64_t)M * N;
    if (active) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + wm * 32 + mi * 16 + g + 8 * h;
            const int col = n0 + wn * kWN + ni * 8 + 2 * t;
            if (row < M && col < N)
              *reinterpret_cast<float2*>(ws + blockIdx.z * plane +
                                         (int64_t)row * N + col) =
                  make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
          }
    }
    if (!vlm::split_k_last(counters) || !active) return;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * 32 + mi * 16 + g + 8 * h;
          const int col = n0 + wn * kWN + ni * 8 + 2 * t;
          if (row >= M || col >= N) continue;
          float2 sum = make_float2(0.f, 0.f);
          for (int z = 0; z < (int)gridDim.z; ++z) {
            const float2 v = __ldcg(reinterpret_cast<const float2*>(
                ws + z * plane + (int64_t)row * N + col));
            sum.x += v.x;
            sum.y += v.y;
          }
          acc[mi][ni][2 * h] = sum.x;
          acc[mi][ni][2 * h + 1] = sum.y;
        }
  } else if (!active) {
    return;
  }

#pragma unroll
  for (int ni = 0; ni < kNI; ++ni) {
    const int col = n0 + wn * kWN + ni * 8 + 2 * t;  // N even: col < N => col + 1 < N
    if (col >= N) continue;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + mi * 16 + g + 8 * h;
        if (row < M)
          *reinterpret_cast<__nv_bfloat162*>(y + (int64_t)row * N + col) =
              __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
  }
}

template <int BM>
int launch(const void* x, const void* q, const float* scale, void* y,
           float* ws, int* counters, int M, int N, int K, int GS, int splits,
           cudaStream_t stream) {
  const int smem = kStages * (BM * kXPitch * (int)sizeof(__nv_bfloat16) +
                              kBN * kQPitch + kBN * kSlots * (int)sizeof(float));
  dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  int4_matmul_kernel<BM><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      scale, static_cast<__nv_bfloat16*>(y), ws, counters, M, N, K, GS);
  return (int)cudaGetLastError();
}

}  // namespace

// splits > 1: ws holds splits * M * N floats; counters one zeroed int per
// output tile (ceil(N / 64) * ceil(M / BM), BM = 32 if M <= 32 else 64),
// left zeroed again by the kernel.
extern "C" int vlm_int4_matmul(const void* x, const void* q, const void* scale,
                               void* y, void* ws, void* counters, int M, int N,
                               int K, int group_size, int splits,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 2 != 0 ||
      group_size <= 0 || group_size % 16 != 0 || K % group_size != 0 ||
      splits < 1 || (splits > 1 && (!ws || !counters)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  return M <= 32 ? launch<32>(x, q, s, y, w, c, M, N, K, group_size, splits, st)
                 : launch<64>(x, q, s, y, w, c, M, N, K, group_size, splits, st);
}
