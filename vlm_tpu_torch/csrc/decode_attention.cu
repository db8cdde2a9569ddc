// B2: decode-step attention, one query token per slot against the KV cache.
//
// Replaces vlm_tpu/ops/decode_attention.py `_decode_kernel` (launched by
// `_decode_call`, public `flash_decode_attention`), bf16-cache form. The
// cache keeps its write-friendly [B, S, KV, D] layout.
//
// What bounds it on the H100: bytes. Each step streams every live slot's
// K and V rows once (Gemma MQA: S x 256 x 2 B per tensor per slot) and does
// only 2 FMAs per cache element per query head. The design reads each cache
// row from device memory exactly once for all query heads that share it:
// one block per (slot, kv head) holds that kv head's G query heads (8 for
// Gemma MQA), one warp per query head, and stages 32-row K/V tiles in
// shared memory where all G warps reuse them. The TPU kernel's
// block-diagonal query operand existed only to feed the MXU and is not
// carried over. A split over S with a combine pass, for occupancy at small
// batch, is later work.
//
// Masks: kv_len; an arbitrary kv_valid [B, S]; or the continuous batcher's
// rotating window rebuilt from scalars: row r is live iff r < min(pcol, S),
// or r < min(pcol + W, S) and ((r - pcol - acol[b]) mod W) < gcnt[b]; the
// window composes with kv_len. The mod is a floor mod (jnp.mod); C's %
// truncates, hence ((x % W) + W) % W. Masked rows get probability 0, so a
// fully masked row returns 0, the TPU kernel's contract.
#include "common.cuh"

namespace {

constexpr int kTileS = 32;
constexpr int kMaxD = 256;
constexpr int kDimsPerLane = kMaxD / 32;

enum Mode { kLen = 0, kValid = 1, kWindow = 2 };

__global__ void decode_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid,
    const int* __restrict__ pcol, const int* __restrict__ acol,
    const int* __restrict__ gcnt, int H, int KV, int S, int D, int window,
    int mode, int64_t q_sb, int64_t q_sh, int64_t c_sb, int64_t c_ss,
    int64_t o_sb, int64_t o_sh, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV;
  const int ld = D + 2;
  float* q_sm = reinterpret_cast<float*>(smem);  // [G, D] fp32
  __nv_bfloat16* k_tile = reinterpret_cast<__nv_bfloat16*>(q_sm + G * D);
  __nv_bfloat16* v_tile = k_tile + kTileS * ld;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = kvh * G + g;

  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int gg = i / D, d = i - gg * D;
    q_sm[i] = __bfloat162float(q[b * q_sb + (kvh * G + gg) * q_sh + d]);
  }

  const int kvl = kv_len ? kv_len[b] : S;
  int pc = 0, ac = 0, gc = 0;
  if (mode == kWindow) {
    pc = *pcol;
    ac = acol[b];
    gc = gcnt[b];
  }
  const __nv_bfloat16* kb = k + b * c_sb + (int64_t)kvh * D;
  const __nv_bfloat16* vb = v + b * c_sb + (int64_t)kvh * D;

  float m = vlm::kNegInf, l = 0.f;
  float acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) acc[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kTileS) {
    __syncthreads();
    vlm::load_tile(k_tile, ld, kb, c_ss, s0, kTileS, S, D);
    vlm::load_tile(v_tile, ld, vb, c_ss, s0, kTileS, S, D);
    __syncthreads();

    const int r = s0 + lane;
    bool live;
    if (mode == kWindow) {
      const int age = (((r - pc - ac) % window) + window) % window;
      live = (r < min(pc, S)) || (r < min(pc + window, S) && age < gc);
      live = live && r < kvl;
    } else {
      live = r < min(S, kvl);
      if (mode == kValid && live) live = kv_valid[(int64_t)b * S + r] != 0;
    }

    float s = vlm::kNegInf;
    if (live) {
      const float* qrow = q_sm + g * D;
      const __nv_bfloat16* krow = k_tile + lane * ld;
      float dot = 0.f;
      for (int c = 0; c < D; c += 2) {
        const float2 kf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(krow + c));
        dot = fmaf(qrow[c], kf.x, dot);
        dot = fmaf(qrow[c + 1], kf.y, dot);
      }
      s = dot * scale;
    }
    const float m_new = fmaxf(m, vlm::warp_max(s));
    const float corr = expf(m - m_new);
    const float p = live ? expf(s - m_new) : 0.f;
    l = l * corr + vlm::warp_sum(p);
    m = m_new;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[i] *= corr;
    const int smax = min(kTileS, S - s0);
    for (int j = 0; j < smax; ++j) {
      const float pj = __shfl_sync(vlm::kFullMask, p, j);
      if (pj == 0.f) continue;  // masked row (warp-uniform)
      const __nv_bfloat16* vrow = v_tile + j * ld;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(pj, __bfloat162float(vrow[d]), acc[i]);
      }
    }
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
  __nv_bfloat16* orow = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < D) orow[d] = __float2bfloat16(acc[i] * inv);
  }
}

}  // namespace

extern "C" int vlm_decode_attention(
    const void* q, const void* k, const void* v, void* o, const int* kv_len,
    const void* kv_valid, const int* pcol, const int* acol, const int* gcnt,
    int B, int H, int KV, int S, int D, int window, int mode, int64_t q_sb,
    int64_t q_sh, int64_t c_sb, int64_t c_ss, int64_t o_sb, int64_t o_sh,
    float scale, void* stream) {
  if (D > kMaxD || D % 2 != 0 || KV <= 0 || H % KV != 0 || H / KV > 32 ||
      (mode == kWindow && window <= 0))
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const size_t smem = sizeof(float) * G * D +
                      2 * sizeof(__nv_bfloat16) * kTileS * (D + 2);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(KV, B);
  decode_kernel<<<grid, 32 * G, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      kv_len, static_cast<const uint8_t*>(kv_valid), pcol, acol, gcnt, H, KV, S,
      D, window, mode, q_sb, q_sh, c_sb, c_ss, o_sb, o_sh, scale);
  return (int)cudaGetLastError();
}
