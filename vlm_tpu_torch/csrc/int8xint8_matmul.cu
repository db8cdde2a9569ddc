// B6: int8 x int8 GEMM with a scale epilogue, y = float(qx . qw^T) * sx * sw,
// the core of the llm.int8 prefill.
//
// Replaces vlm_tpu/ops/quant.py `_int8xint8_kernel` (launched by
// `_int8xint8_matmul_pallas`): qx [M, K] int8 activations with per-row
// scales sx [M] fp32 (from `quantize_activations`), qw [N, K] int8 weights
// (the nn.Linear layout; the TPU kernel took [K, N]) with per-column scales
// sw [N] fp32. The products accumulate exactly in int32; the epilogue
// computes float(acc) * sx[row] * sw[col] in that order, as the TPU kernel
// does, so the fp32 value equals the plain version's bit for bit before the
// optional cast to bf16.
//
// What bounds it on the H100: integer tensor-core math at prefill sizes
// (M = 4 x 316 = 1264 for a Gemma admission: 2 * M * K * N operations
// against K * N weight bytes, ~2,500 operations a byte). The design is a
// 128 x 128 output tile per block, 8 warps of 64 x 32, on
// mma.sync.m16n8k32.s8 (int8 in, int32 accumulate), fed from a 3-stage
// cp.async ring of 64-deep K steps. Both operands are row-major in K, which
// is what the instruction's row.col form wants: every A and B fragment
// register is one aligned 32-bit read of four neighbouring bytes of a row,
// from 80-byte shared rows that keep the reads free of bank conflicts. The
// ragged edges (M, N, and a K tail such as SigLIP fc2's K = 4304 = 64 * 67
// + 16) are zero-filled in shared memory by the copies themselves, so no
// row is read past its end. Products with few output tiles for 132 SMs
// (N = 256 and 2048 at M = 1264: 20 and 160 tiles) split K over up to 8
// blocks per tile (gridDim.z); the last block of a tile adds the int32
// partials, exact in any order, and applies the epilogue. Activation
// quantization stays outside, in PyTorch, as JAX computed it in XLA;
// fusing it into a prologue, and wgmma, are later work.
//
// Requirements (checked by the wrapper and here): K % 16 == 0, N even,
// contiguous operands and output, 16-byte aligned bases.
#include "common.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kThreads = kWarpsM * kWarpsN * 32;
constexpr int kWM = kBM / kWarpsM;  // 64
constexpr int kWN = kBN / kWarpsN;  // 32
constexpr int kMI = kWM / 16;
constexpr int kNI = kWN / 8;
constexpr int kStages = 3;
constexpr int kPitch = kBK + 16;    // bytes: 80-byte rows, no bank conflicts
constexpr int kStage = (kBM + kBN) * kPitch;
constexpr int kSmem = kStages * kStage;

__global__ void __launch_bounds__(kThreads)
int8xint8_kernel(const int8_t* __restrict__ qx, const float* __restrict__ sx,
                 const int8_t* __restrict__ qw, const float* __restrict__ sw,
                 void* __restrict__ y, int* __restrict__ ws,
                 int* __restrict__ counters, int M, int N, int K,
                 int out_bf16) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int g = lane / 4;
  const int t = lane % 4;
  const bool active = m0 + wm * kWM < M;  // warp-uniform

  auto load = [&](int stage, int k0) {
    unsigned char* xd = smem + stage * kStage;
    unsigned char* wd = xd + kBM * kPitch;
    for (int i = threadIdx.x; i < (kBM + kBN) * (kBK / 16); i += kThreads) {
      const int r = i / (kBK / 16), c = (i % (kBK / 16)) * 16;
      if (r < kBM) {
        const bool ok = m0 + r < M && k0 + c < K;
        vlm::cp_async16(xd + r * kPitch + c,
                        ok ? qx + (int64_t)(m0 + r) * K + k0 + c : qx, ok);
      } else {
        const int rw = r - kBM;
        const bool ok = n0 + rw < N && k0 + c < K;
        vlm::cp_async16(wd + rw * kPitch + c,
                        ok ? qw + (int64_t)(n0 + rw) * K + k0 + c : qw, ok);
      }
    }
  };

  int acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;

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

    const unsigned char* xt = smem + (i % kStages) * kStage;
    const unsigned char* wt = xt + kBM * kPitch;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      uint32_t a[kMI][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        const unsigned char* p = xt + (wm * kWM + mi * 16 + g) * kPitch + kk * 32 + 4 * t;
        a[mi][0] = vlm::ld32(p);
        a[mi][1] = vlm::ld32(p + 8 * kPitch);
        a[mi][2] = vlm::ld32(p + 16);
        a[mi][3] = vlm::ld32(p + 8 * kPitch + 16);
      }
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const unsigned char* p = wt + (wn * kWN + ni * 8 + g) * kPitch + kk * 32 + 4 * t;
        const uint32_t b0 = vlm::ld32(p), b1 = vlm::ld32(p + 16);
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) vlm::mma16832_s8(acc[mi][ni], a[mi], b0, b1);
      }
    }
  }
  vlm::cp_async_wait<0>();

  if (gridDim.z > 1) {
    // int32 partials [split, M, N]; the tile's last block sums them
    const int64_t plane = (int64_t)M * N;
    if (active) {
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + wm * kWM + mi * 16 + g + 8 * h;
            const int col = n0 + wn * kWN + ni * 8 + 2 * t;
            if (row < M && col < N)
              *reinterpret_cast<int2*>(ws + blockIdx.z * plane +
                                       (int64_t)row * N + col) =
                  make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
          }
    }
    if (!vlm::split_k_last(counters) || !active) return;
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * kWM + mi * 16 + g + 8 * h;
          const int col = n0 + wn * kWN + ni * 8 + 2 * t;
          if (row >= M || col >= N) continue;
          int2 sum = make_int2(0, 0);
          for (int z = 0; z < (int)gridDim.z; ++z) {
            const int2 v = __ldcg(reinterpret_cast<const int2*>(
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
    const float w0 = sw[col], w1 = sw[col + 1];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * kWM + mi * 16 + g + 8 * h;
        if (row >= M) continue;
        const float xs = sx[row];
        // (float(acc) * sx) * sw, two roundings, in the reference's order
        const float v0 = static_cast<float>(acc[mi][ni][2 * h]) * xs * w0;
        const float v1 = static_cast<float>(acc[mi][ni][2 * h + 1]) * xs * w1;
        const int64_t off = (int64_t)row * N + col;
        if (out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) + off) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(y) + off) = make_float2(v0, v1);
      }
    }
  }
}

}  // namespace

// splits > 1: ws holds splits * M * N int32; counters one zeroed int per
// output tile (ceil(N / 128) * ceil(M / 128)), left zeroed by the kernel.
extern "C" int vlm_int8xint8_matmul(const void* qx, const void* sx,
                                    const void* qw, const void* sw, void* y,
                                    void* ws, void* counters, int M, int N,
                                    int K, int splits, int out_bf16,
                                    void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 2 != 0 ||
      splits < 1 || (splits > 1 && (!ws || !counters)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      int8xint8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  int8xint8_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qx), static_cast<const float*>(sx),
      static_cast<const int8_t*>(qw), static_cast<const float*>(sw), y,
      static_cast<int*>(ws), static_cast<int*>(counters), M, N, K, out_bf16);
  return (int)cudaGetLastError();
}
