// B5: weight-only int8 GEMM, y = (x . q^T) * scale, for the products with
// fewer than 512 rows (decode steps, single-image admissions).
//
// Replaces vlm_tpu/ops/quant.py `_int8_matmul_kernel` (launched by
// `_int8_matmul_pallas`): x [M, K] bf16, q [N, K] int8 (the nn.Linear
// layout; the TPU kernel took [K, N]), scale [N] fp32, y [M, N] bf16. The
// int8 weights are widened to bf16 on chip (exact: |q| <= 127), the
// product accumulates in fp32 on the tensor cores, and the per-column scale
// multiplies the fp32 accumulator in the epilogue, as in the TPU kernel.
//
// What bounds it on the H100: weight bytes. A Gemma decode step at 32 slots
// streams 1.98 GB of int8 block weights, >= 0.59 ms at 3.35 TB/s, and does
// only 2 * M FLOPs per weight byte. The design reads each weight byte from
// device memory once: a block owns a 64-column strip of the output for
// BM = 32 or 64 rows and walks K in 64-wide steps through a 3-stage
// cp.async ring (16-byte copies, zero-filled past the ragged M, N and K
// edges), so loads of the next steps overlap the current step's MMAs. The
// int8 tile stays int8 in shared memory and each B fragment is widened in
// registers right before mma.sync.m16n8k16 (bf16 in, fp32 accumulate):
// the q [N, K] layout is exactly the column-major B operand, two
// neighbouring bytes of a row per register half. x is small and re-read
// from L2 by every column strip. The narrow products (N = 256 and 2048
// give 4 and 32 strips for 132 SMs) split K over up to 16 blocks per strip
// (gridDim.z): each stores its fp32 partial sums in a workspace and the
// last block of a strip adds them in split order, so the result is
// deterministic, then applies the scale.
//
// Requirements (checked by the wrapper and here): K % 16 == 0 (16-byte
// rows of q), N even, x and y contiguous, 16-byte aligned bases.
#include "common.cuh"

namespace {

constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kWarps = 4;
constexpr int kStages = 3;
constexpr int kXPitch = kBK + 8;   // bf16 elements: 144-byte rows, no bank conflicts
constexpr int kQPitch = kBK + 16;  // bytes: 80-byte rows, no bank conflicts

// two neighbouring int8 weights -> one bf16x2 B-fragment register (exact)
__device__ __forceinline__ uint32_t widen_s8x2(const int8_t* p) {
  return vlm::pack_bf16(static_cast<float>(p[0]), static_cast<float>(p[1]));
}

template <int BM>
__global__ void __launch_bounds__(kWarps * 32)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ q, const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                   int* __restrict__ counters, int M, int N, int K) {
  constexpr int kWarpsM = BM / 32;            // each warp: 32 rows
  constexpr int kWarpsN = kWarps / kWarpsM;
  constexpr int kWN = kBN / kWarpsN;          // 16 or 32 columns per warp
  constexpr int kNI = kWN / 8;
  constexpr int kXStage = BM * kXPitch;       // bf16 elements
  constexpr int kQStage = kBN * kQPitch;      // bytes

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* qs = reinterpret_cast<int8_t*>(xs + kStages * kXStage);

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int g = lane / 4;
  const int t = lane % 4;
  const bool active = m0 + wm * 32 < M;       // warp-uniform

  auto load = [&](int stage, int k0) {
    __nv_bfloat16* xd = xs + stage * kXStage;
    for (int i = threadIdx.x; i < BM * (kBK / 8); i += blockDim.x) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + c < K;
      vlm::cp_async16(xd + r * kXPitch + c,
                      ok ? x + (int64_t)(m0 + r) * K + k0 + c : x, ok);
    }
    int8_t* qd = qs + stage * kQStage;
    for (int i = threadIdx.x; i < kBN * (kBK / 16); i += blockDim.x) {
      const int r = i / (kBK / 16), c = (i % (kBK / 16)) * 16;
      const bool ok = n0 + r < N && k0 + c < K;
      vlm::cp_async16(qd + r * kQPitch + c,
                      ok ? q + (int64_t)(n0 + r) * K + k0 + c : q, ok);
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

    const __nv_bfloat16* xt = xs + (i % kStages) * kXStage;
    const int8_t* qt = qs + (i % kStages) * kQStage;
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
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const int8_t* p = qt + (wn * kWN + ni * 8 + g) * kQPitch + kk * 16 + 2 * t;
        const uint32_t b0 = widen_s8x2(p), b1 = widen_s8x2(p + 8);
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
    const float s0 = scale[col], s1 = scale[col + 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + mi * 16 + g + 8 * h;
        if (row < M)
          *reinterpret_cast<__nv_bfloat162*>(y + (int64_t)row * N + col) =
              __floats2bfloat162_rn(acc[mi][ni][2 * h] * s0,
                                    acc[mi][ni][2 * h + 1] * s1);
      }
    }
  }
}

template <int BM>
int launch(const void* x, const void* q, const float* scale, void* y,
           float* ws, int* counters, int M, int N, int K, int splits,
           cudaStream_t stream) {
  const int smem = kStages * (BM * kXPitch * (int)sizeof(__nv_bfloat16) +
                              kBN * kQPitch);
  dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  int8_matmul_kernel<BM><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      scale, static_cast<__nv_bfloat16*>(y), ws, counters, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// splits > 1: ws holds splits * M * N floats; counters one zeroed int per
// output tile (ceil(N / 64) * ceil(M / BM), BM = 32 if M <= 32 else 64),
// left zeroed again by the kernel.
extern "C" int vlm_int8_matmul(const void* x, const void* q, const void* scale,
                               void* y, void* ws, void* counters, int M, int N,
                               int K, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 2 != 0 ||
      splits < 1 || (splits > 1 && (!ws || !counters)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  return M <= 32 ? launch<32>(x, q, s, y, w, c, M, N, K, splits, st)
                 : launch<64>(x, q, s, y, w, c, M, N, K, splits, st);
}
