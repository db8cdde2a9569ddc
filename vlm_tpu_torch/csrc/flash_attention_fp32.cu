// B1, fp32 form: prefill / encoder attention in exact fp32, for models that
// run with quantization "fp32" (vlm_tpu's default compute dtype).
//
// Replaces vlm_tpu/ops/attention.py `_flash_kernel` (launched by
// `_flash_fwd_pallas`) for fp32 operands; the bf16 form is
// flash_attention.cu (wgmma + TMA, bf16 only). Same function as
// `attention_plain`: q [B, H, Sq, D], k/v [B, KV, Sk, D] with any strides
// and a contiguous head dim, grouped-query heads through the index map
// (head h reads kv head h / (H / KV)); masks causal with the diagonal at
// the end of the kv axis, widened by prefix_len, and kv_len, all with the
// finite -1e30, so a row with no live key averages V over every key.
//
// What bounds it on the H100: fp32 operations on the CUDA cores (no TF32,
// no bf16 operands: 67 TFLOP/s against 989 for bf16 on tensor cores). This
// is a correctness mode, so the design is simple: a block of 4 warps takes
// 16 query rows of one (batch, head), 4 a warp, and walks the keys in
// 32-key tiles staged in shared memory; lane j scores key j of the tile
// against each of its warp's rows (fp32 FMAs over the head dim), the warp
// updates each row's running max and sum once a tile (online softmax),
// and every lane accumulates P.V for its own head dims.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows a block
constexpr int kKeys = 32;                     // keys a tile: one a lane
constexpr int kMaxD = 256;
constexpr int kDL = kMaxD / 32;               // head dims a lane

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  const int* kv_len;
  const int* prefix_len;
  int H, KV, Sq, Sk, D, causal;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
      o_ss;
  float scale;
};

__global__ void __launch_bounds__(kThreads) flash_fp32_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  const int kp = p.D + 1;                 // K rows padded: lane j reads row j
  float* ks = sm;                         // [kKeys][D + 1]
  float* vs = ks + kKeys * kp;            // [kKeys][D]
  float* qs = vs + kKeys * p.D;           // [kRows][D]
  const int b = blockIdx.z, h = blockIdx.y;
  const int kvh = h / (p.H / p.KV);
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kvl = p.kv_len ? min(p.kv_len[b], p.Sk) : p.Sk;
  const int pfx = p.prefix_len ? p.prefix_len[b] : 0;

  for (int i = threadIdx.x; i < kRows * p.D; i += kThreads) {
    const int r = i / p.D, d = i % p.D;
    qs[i] = q0 + r < p.Sq
                ? p.q[b * p.q_sb + h * p.q_sh + (int64_t)(q0 + r) * p.q_ss + d]
                : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDL; ++i) acc[r][i] = 0.f;
  }

  const float* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const float* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  for (int k0 = 0; k0 < p.Sk; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int i = threadIdx.x; i < kKeys * p.D; i += kThreads) {
      const int j = i / p.D, d = i % p.D;
      const bool ok = k0 + j < p.Sk;
      ks[j * kp + d] = ok ? kb[(int64_t)(k0 + j) * p.k_ss + d] : 0.f;
      vs[j * p.D + d] = ok ? vb[(int64_t)(k0 + j) * p.v_ss + d] : 0.f;
    }
    __syncthreads();
    const int kj = k0 + lane;  // this lane's key
    const bool exists = kj < p.Sk;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const int qi = q0 + row;
      float s = 0.f;
      const float* qr = qs + row * p.D;
      const float* kr = ks + lane * kp;
      for (int d = 0; d < p.D; ++d) s = fmaf(qr[d], kr[d], s);
      s *= p.scale;
      bool allowed = kj < kvl;
      if (p.causal)
        allowed = allowed && (kj <= qi + (p.Sk - p.Sq) || kj < pfx);
      if (!allowed) s = vlm::kNegInf;
      if (!exists) s = -INFINITY;  // past Sk: no key at all
      const float mn = fmaxf(m[r], vlm::warp_max(s));
      const float c = expf(m[r] - mn);
      const float pj = exists ? expf(s - mn) : 0.f;
      l[r] = l[r] * c + vlm::warp_sum(pj);
      m[r] = mn;
#pragma unroll
      for (int i = 0; i < kDL; ++i) acc[r][i] *= c;
      for (int j = 0; j < kKeys && k0 + j < p.Sk; ++j) {
        const float pb = __shfl_sync(vlm::kFullMask, pj, j);
#pragma unroll
        for (int i = 0; i < kDL; ++i) {
          const int d = lane + 32 * i;
          if (d < p.D) acc[r][i] = fmaf(pb, vs[j * p.D + d], acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    if (qi >= p.Sq) continue;
    float* orow = p.o + b * p.o_sb + h * p.o_sh + (int64_t)qi * p.o_ss;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int i = 0; i < kDL; ++i) {
      const int d = lane + 32 * i;
      if (d < p.D) orow[d] = acc[r][i] * inv;
    }
  }
}

}  // namespace

// Strides in elements (batch, head, position; the head dim is contiguous).
// kv_len and prefix_len: [B] int32 or null; prefix_len widens the causal
// mask only.
extern "C" int vlm_flash_attention_fp32(
    const void* q, const void* k, const void* v, void* o, const int* kv_len,
    const int* prefix_len, int B, int H, int KV, int Sq, int Sk, int D,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
    int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb,
    int64_t o_sh, int64_t o_ss, float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      D <= 0 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<float*>(o), kv_len,
                 causal ? prefix_len : nullptr, H, KV, Sq, Sk, D, causal,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb,
                 o_sh, o_ss, scale};
  const int smem =
      (int)sizeof(float) * (kKeys * (D + 1) + kKeys * D + kRows * D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_fp32_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
