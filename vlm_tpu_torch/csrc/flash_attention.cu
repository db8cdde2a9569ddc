// B1: fused prefill / encoder attention, softmax(q k^T * scale + masks) v.
//
// Replaces vlm_tpu/ops/attention.py `_flash_kernel` (launched by
// `_flash_attention`). The TPU kernel kept one head's whole K/V resident in
// VMEM; one Gemma prefill head at S~1100, D=256 is ~560 KB per tensor, more
// than the 227 KB of shared memory a Hopper block may use. So this kernel
// streams K/V through shared memory in 64-row tiles with an online softmax.
//
// What bounds it on the H100: matrix math (4 * Sq * Sk * D FLOPs per head),
// which only the tensor cores deliver at rate. The design is the
// FlashAttention-2 schedule on mma.sync m16n8k16 (bf16 in, fp32
// accumulate): a block owns 64 query rows of one (batch, head), each of
// its 4 warps 16 rows; S = Q K^T and O += P V are warp-level MMAs whose
// operands come from padded shared-memory tiles (conflict-free 32-bit reads
// for Q and K, ldmatrix.trans for V); the probabilities never leave
// registers (the S accumulator is repacked as the A operand of P V). The
// head dim is padded to a multiple of 16 only inside shared memory (zero
// columns), so SigLIP's D=72 runs as 80 without a padded copy in device
// memory; the scale uses the true D. GQA/MQA maps query head h to kv head
// h / (H / KV) without repeating K/V.
//
// Masks follow `_flash_kernel`: causal with the diagonal at the end of the
// kv axis (offset Sk - Sq), optionally widened by a prefix-LM length, and a
// per-batch kv_len. Masked scores take the finite -1e30, so a fully masked
// row returns the mean of V exactly like the reference.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kBlockQ = 16 * kWarps;
constexpr int kBlockK = 64;

struct Strides {
  int64_t b, h, s;
};

using vlm::ld32;
using vlm::mma16816;
using vlm::pack_bf16;

// Two transposed 8x8 bf16 matrices: lanes 0-15 address the 16 rows.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// Rows [row0, row0 + rows) of a strided [S, d] matrix into a [rows, dp]
// shared tile of pitch ld; zero past `limit` rows and past column d.
__device__ __forceinline__ void load_padded(__nv_bfloat16* dst, int ld,
                                            const __nv_bfloat16* src,
                                            int64_t row_stride, int row0,
                                            int rows, int limit, int d,
                                            int dp) {
  const int half = dp / 2;
  for (int i = threadIdx.x; i < rows * half; i += blockDim.x) {
    const int r = i / half;
    const int c = (i - r * half) * 2;
    uint32_t val = 0;
    if (row0 + r < limit && c < d)
      val = ld32(src + (int64_t)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint32_t*>(dst + r * ld + c) = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
             const int* __restrict__ kv_len, const int* __restrict__ prefix_len,
             int H, int KV, int Sq, int Sk, int D, Strides qs, Strides ks,
             Strides vs, Strides os, float scale, int causal) {
  constexpr int LD = DP + 8;  // row pitch: 16-byte rows, conflict-free reads
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = q_s + kBlockQ * LD;
  __nv_bfloat16* v_s = k_s + kBlockK * LD;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // fragment column pair

  const __nv_bfloat16* kb = k + b * ks.b + kvh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kvh * vs.h;
  const int kvl = kv_len ? kv_len[b] : Sk;
  const int pfx = prefix_len ? prefix_len[b] : 0;
  const int offset = Sk - Sq;
  const int row_lo = q0 + warp * 16 + g;  // rows of c0,c1; +8 for c2,c3

  load_padded(q_s, LD, q + b * qs.b + h * qs.h, qs.s, q0, kBlockQ, Sq, D, DP);
  const __nv_bfloat16* q_w = q_s + warp * 16 * LD;

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kBlockK) {
    __syncthreads();  // previous tiles consumed, q tile stored
    load_padded(k_s, LD, kb, ks.s, k0, kBlockK, Sk, D, DP);
    load_padded(v_s, LD, vb, vs.s, k0, kBlockK, Sk, D, DP);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const __nv_bfloat16* qa = q_w + g * LD + kk * 16 + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LD), ld32(qa + 8),
                             ld32(qa + 8 * LD + 8)};
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
        const __nv_bfloat16* kr = k_s + (j * 8 + g) * LD + kk * 16 + 2 * t;
        mma16816(s[j], a, ld32(kr), ld32(kr + 8));
      }
    }

    // scale, mask, online softmax over the rows row_lo and row_lo + 8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = row_lo + (e >> 1) * 8;
        const int kj = k0 + j * 8 + 2 * t + (e & 1);
        bool allowed = true;
        if (causal) allowed = (kj <= qi + offset) || (kj < pfx);
        if (kj >= kvl) allowed = false;
        float x = allowed ? s[j][e] * scale : vlm::kNegInf;
        if (kj >= Sk) x = -INFINITY;  // past the keys: no weight
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(vlm::kFullMask, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(vlm::kFullMask, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = __expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(vlm::kFullMask, sum[i], 1);
      sum[i] += __shfl_xor_sync(vlm::kFullMask, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V, P repacked from the S accumulators as bf16 A operands
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr = v_s + (kk * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vr + n * 8);
        mma16816(acc[n], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row_lo + i * 8;
    if (qi >= Sq) continue;
    const float inv = 1.f / l[i];
    __nv_bfloat16* orow = o + b * os.b + h * os.h + qi * os.s;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = n * 8 + 2 * t;  // D is even: d < D means d + 1 < D
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* kv_len, const int* prefix_len, int B, int H, int KV,
           int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs,
           Strides os, float scale, int causal, cudaStream_t stream) {
  const int smem = (kBlockQ + 2 * kBlockK) * (DP + 8) * (int)sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_kernel<DP><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      kv_len, prefix_len, H, KV, Sq, Sk, D, qs, ks, vs, os, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vlm_flash_attention(
    const void* q, const void* k, const void* v, void* o, const int* kv_len,
    const int* prefix_len, int B, int H, int KV, int Sq, int Sk, int D,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
    int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb,
    int64_t o_sh, int64_t o_ss, float scale, int causal, void* stream) {
  if (D > 256 || D % 2 != 0 || KV <= 0 || H % KV != 0 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VLM_FLASH(DP)                                                        \
  return launch<DP>(q, k, v, o, kv_len, prefix_len, B, H, KV, Sq, Sk, D, qs, \
                    ks, vs, os, scale, causal, st)
  if (D <= 32) VLM_FLASH(32);
  if (D <= 64) VLM_FLASH(64);
  if (D <= 80) VLM_FLASH(80);
  if (D <= 96) VLM_FLASH(96);
  if (D <= 128) VLM_FLASH(128);
  VLM_FLASH(256);
#undef VLM_FLASH
}

extern "C" const char* vlm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
