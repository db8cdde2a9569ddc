// B2: decode-step attention, one query token per slot against the KV cache.
//
// Replaces vlm_tpu/ops/decode_attention.py `_decode_kernel` (launched by
// `_decode_call`, public `flash_decode_attention`), in its bf16-cache and
// int8-cache forms. The cache keeps its write-friendly [B, S, KV, D] layout.
//
// What bounds it on the H100: bytes. Each step streams every live slot's
// K and V rows once (Gemma MQA: S x 256 x 2 B per tensor per slot) and does
// only 2 FMAs per cache element per query head (the int8 form: half the
// bytes, plus 8 bytes of scales per row). The design reads each cache
// row from device memory exactly once for all query heads that share it:
// one block per (slot, kv head) holds that kv head's G query heads (8 for
// Gemma MQA), one warp per query head, and stages 32-row K/V tiles in
// shared memory where all G warps reuse them. The TPU kernel's
// block-diagonal query operand existed only to feed the MXU and is not
// carried over. A split over S with a combine pass, for occupancy at small
// batch, is later work.
//
// int8 cache (the TPU kernel's has_scales mode): K/V rows arrive as int8
// with per-(slot, row, kv head) fp32 scales [B, S, KV, 1]; the tiles are
// staged as int8, half the bytes of the bf16 form, and widened in
// registers. The scales ride the scores and probabilities instead of the
// values, q.(k8 s) == (q.k8) s and sum p (v8 s) == sum (p s) v8: the score
// is dot(q, k8) * D^-0.5 * ks[row] and each row's probability is multiplied
// by vs[row] before the P.V sum, while the softmax denominator sums the
// unscaled probabilities.
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

// Copy `rows` int8 rows of `d` bytes (d % 4 == 0) from a strided source
// into a shared tile of byte pitch `ld`, zero-filling rows at or past `limit`.
__device__ __forceinline__ void load_tile_s8(int8_t* dst, int ld,
                                             const int8_t* src,
                                             int64_t row_stride, int row0,
                                             int rows, int limit, int d) {
  const int words = d / 4;
  for (int i = threadIdx.x; i < rows * words; i += blockDim.x) {
    const int r = i / words;
    const int c = (i - r * words) * 4;
    uint32_t val = 0;
    if (row0 + r < limit)
      val = vlm::ld32(src + (int64_t)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint32_t*>(dst + r * ld + c) = val;
  }
}

// T: __nv_bfloat16 (bf16 cache) or int8_t (int8 cache with scales)
template <typename T>
__global__ void decode_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, __nv_bfloat16* __restrict__ o,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ kv_len, const uint8_t* __restrict__ kv_valid,
    const int* __restrict__ pcol, const int* __restrict__ acol,
    const int* __restrict__ gcnt, int H, int KV, int S, int D, int window,
    int mode, int64_t q_sb, int64_t q_sh, int64_t c_sb, int64_t c_ss,
    int64_t o_sb, int64_t o_sh, float scale) {
  constexpr bool kInt8 = sizeof(T) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV;
  // tile row pitch in elements: an odd number of 32-bit words, so lanes
  // reading their own rows hit distinct banks
  const int ld = kInt8 ? D + 4 : D + 2;
  float* q_sm = reinterpret_cast<float*>(smem);  // [G, D] fp32
  T* k_tile = reinterpret_cast<T*>(q_sm + G * D);
  T* v_tile = k_tile + kTileS * ld;

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
  const T* kb = k + b * c_sb + (int64_t)kvh * D;
  const T* vb = v + b * c_sb + (int64_t)kvh * D;

  float m = vlm::kNegInf, l = 0.f;
  float acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) acc[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kTileS) {
    __syncthreads();
    if constexpr (kInt8) {
      load_tile_s8(k_tile, ld, kb, c_ss, s0, kTileS, S, D);
      load_tile_s8(v_tile, ld, vb, c_ss, s0, kTileS, S, D);
    } else {
      vlm::load_tile(k_tile, ld, kb, c_ss, s0, kTileS, S, D);
      vlm::load_tile(v_tile, ld, vb, c_ss, s0, kTileS, S, D);
    }
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
      const T* krow = k_tile + lane * ld;
      float dot = 0.f;
      if constexpr (kInt8) {
        for (int c = 0; c < D; c += 4) {
          const char4 kc = *reinterpret_cast<const char4*>(krow + c);
          dot = fmaf(qrow[c], static_cast<float>(kc.x), dot);
          dot = fmaf(qrow[c + 1], static_cast<float>(kc.y), dot);
          dot = fmaf(qrow[c + 2], static_cast<float>(kc.z), dot);
          dot = fmaf(qrow[c + 3], static_cast<float>(kc.w), dot);
        }
        s = dot * scale * k_scale[((int64_t)b * S + r) * KV + kvh];
      } else {
        for (int c = 0; c < D; c += 2) {
          const float2 kf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(krow + c));
          dot = fmaf(qrow[c], kf.x, dot);
          dot = fmaf(qrow[c + 1], kf.y, dot);
        }
        s = dot * scale;
      }
    }
    const float m_new = fmaxf(m, vlm::warp_max(s));
    const float corr = expf(m - m_new);
    const float p = live ? expf(s - m_new) : 0.f;
    l = l * corr + vlm::warp_sum(p);
    m = m_new;
    // the probability this row's V values are weighted with
    float pv = p;
    if constexpr (kInt8) {
      if (live) pv = p * v_scale[((int64_t)b * S + r) * KV + kvh];
    }
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[i] *= corr;
    const int smax = min(kTileS, S - s0);
    for (int j = 0; j < smax; ++j) {
      const float pj = __shfl_sync(vlm::kFullMask, pv, j);
      if (pj == 0.f) continue;  // masked row (warp-uniform)
      const T* vrow = v_tile + j * ld;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          float vf;
          if constexpr (kInt8) vf = static_cast<float>(vrow[d]);
          else vf = __bfloat162float(vrow[d]);
          acc[i] = fmaf(pj, vf, acc[i]);
        }
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

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const float* k_scale, const float* v_scale, const int* kv_len,
           const void* kv_valid, const int* pcol, const int* acol,
           const int* gcnt, int B, int H, int KV, int S, int D, int window,
           int mode, int64_t q_sb, int64_t q_sh, int64_t c_sb, int64_t c_ss,
           int64_t o_sb, int64_t o_sh, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const int ld = sizeof(T) == 1 ? D + 4 : D + 2;
  const size_t smem = sizeof(float) * G * D + 2 * sizeof(T) * kTileS * ld;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(KV, B);
  decode_kernel<T><<<grid, 32 * G, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<__nv_bfloat16*>(o), k_scale,
      v_scale, kv_len, static_cast<const uint8_t*>(kv_valid), pcol, acol, gcnt,
      H, KV, S, D, window, mode, q_sb, q_sh, c_sb, c_ss, o_sb, o_sh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// k_scale == nullptr: bf16 cache; otherwise an int8 cache with fp32 scales
// k_scale / v_scale [B, S, KV, 1]. Cache strides are in elements.
extern "C" int vlm_decode_attention(
    const void* q, const void* k, const void* v, void* o, const void* k_scale,
    const void* v_scale, const int* kv_len, const void* kv_valid,
    const int* pcol, const int* acol, const int* gcnt, int B, int H, int KV,
    int S, int D, int window, int mode, int64_t q_sb, int64_t q_sh,
    int64_t c_sb, int64_t c_ss, int64_t o_sb, int64_t o_sh, float scale,
    void* stream) {
  const bool int8 = k_scale != nullptr;
  if (D > kMaxD || D % (int8 ? 4 : 2) != 0 || KV <= 0 || H % KV != 0 ||
      H / KV > 32 || (mode == kWindow && window <= 0) ||
      int8 != (v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  if (int8)
    return launch<int8_t>(q, k, v, o, ks, vs, kv_len, kv_valid, pcol, acol,
                          gcnt, B, H, KV, S, D, window, mode, q_sb, q_sh, c_sb,
                          c_ss, o_sb, o_sh, scale, st);
  return launch<__nv_bfloat16>(q, k, v, o, ks, vs, kv_len, kv_valid, pcol,
                               acol, gcnt, B, H, KV, S, D, window, mode, q_sb,
                               q_sh, c_sb, c_ss, o_sb, o_sh, scale, st);
}
