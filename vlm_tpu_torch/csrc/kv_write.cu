// B3: in-place KV-cache row write, one new K and V row per slot.
//
// Replaces vlm_tpu/ops/kvcache.py `_write_kernel` (via `_kv_write_call`,
// public `kv_uniform_write` and `kv_scatter_write`). Uniform mode writes
// every slot's row at column start[0] (the continuous batcher's rotating
// decode window); scatter mode writes slot b at its own start[b].
//
// What bounds it on the H100: launch latency. It moves B x 2 rows of
// KV x D elements (16 KB for Gemma at 32 slots), so the design is one launch
// for both caches and both modes, one block per (slot, K|V), 16-byte copies
// when the row allows it, and the write offset read on the device so the
// host never waits for it. It copies bytes, so any cache dtype works.
// Offsets outside [0, L) write nothing, like the reference's masked write.
//
// int8 form (`vlm_kv_write_int8`): replaces the same kernel on an int8
// cache together with the quantize step in front of it
// (vlm_tpu/models/decoder.py `_write_kv` -> `quantize_kv_rows`). Each new
// bf16 (slot, row, kv head) row is quantized by abs-max/127 and its int8
// values and fp32 scale are written in place, fused in one launch. S rows
// per slot land at columns start .. start + S - 1, so the same launch
// serves the decode step (S = 1, uniform or per-slot column) and the
// prefill (S = prompt length at column 0): admission quantizes on the card
// too. One warp per (slot, row, kv head) row, D <= 256 values in registers,
// through `vlm::load_row_warp` and `vlm::quantize_row_warp` (common.cuh),
// whose arithmetic is
// `quantize_activations`' bit for bit.
//
// The decode step's write no longer launches this file's kernels: B2
// (decode_attention.cu) takes the step's new rows and writes them in its
// own launch (the fused forms). These kernels serve the int8 prefill rows
// and any write that no B2 launch follows.
#include "common.cuh"

namespace {

__global__ void kv_write_kernel(char* __restrict__ k_cache,
                                char* __restrict__ v_cache,
                                const char* __restrict__ k_new,
                                const char* __restrict__ v_new,
                                const int* __restrict__ start, int uniform,
                                int L, int64_t row_bytes, int64_t cache_sb,
                                int64_t new_sb) {
  const int b = blockIdx.x;
  const int pos = uniform ? start[0] : start[b];
  if (pos < 0 || pos >= L) return;
  char* dst = (blockIdx.y == 0 ? k_cache : v_cache) + b * cache_sb +
              (int64_t)pos * row_bytes;
  const char* src = (blockIdx.y == 0 ? k_new : v_new) + b * new_sb;
  const bool vec = ((reinterpret_cast<uintptr_t>(dst) |
                     reinterpret_cast<uintptr_t>(src) | row_bytes) & 15) == 0;
  if (vec) {
    const int64_t n = row_bytes / 16;
    for (int64_t i = threadIdx.x; i < n; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else {
    for (int64_t i = threadIdx.x; i < row_bytes; i += blockDim.x) dst[i] = src[i];
  }
}

constexpr int kMaxD = vlm::kQuantMaxD;

// grid (B * S, 2): block (slot b, new row s) of K (y = 0) or V (y = 1)
__global__ void kv_write_int8_kernel(int8_t* __restrict__ k_q,
                                     float* __restrict__ k_s,
                                     int8_t* __restrict__ v_q,
                                     float* __restrict__ v_s,
                                     const __nv_bfloat16* __restrict__ k_new,
                                     const __nv_bfloat16* __restrict__ v_new,
                                     const int* __restrict__ start, int uniform,
                                     int S, int L, int KV, int D) {
  const int b = blockIdx.x / S;
  const int s = blockIdx.x - b * S;
  const int pos = (uniform ? start[0] : start[b]) + s;
  if (pos < 0 || pos >= L) return;
  const bool is_v = blockIdx.y != 0;
  const __nv_bfloat16* src =
      (is_v ? v_new : k_new) + (int64_t)blockIdx.x * KV * D;
  const int64_t cache_row = (int64_t)b * L + pos;
  int8_t* dq = (is_v ? v_q : k_q) + cache_row * KV * D;
  float* ds = (is_v ? v_s : k_s) + cache_row * KV;
  const int lane = threadIdx.x % 32;
  for (int h = threadIdx.x / 32; h < KV; h += blockDim.x / 32) {
    float vals[vlm::kQuantPerLane];
    int8_t q[vlm::kQuantPerLane];
    vlm::load_row_warp(src + h * D, D, lane, vals);
    const float scale = vlm::quantize_row_warp(vals, q);
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const int d = lane + 32 * i;
      if (d < D) dq[h * D + d] = q[i];
    }
    if (lane == 0) ds[h] = scale;
  }
}

}  // namespace

extern "C" int vlm_kv_write(void* k_cache, void* v_cache, const void* k_new,
                            const void* v_new, const int* start, int uniform,
                            int B, int L, int64_t row_bytes, int64_t cache_sb,
                            int64_t new_sb, void* stream) {
  dim3 grid(B, 2);
  kv_write_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(k_cache), static_cast<char*>(v_cache),
      static_cast<const char*>(k_new), static_cast<const char*>(v_new), start,
      uniform, L, row_bytes, cache_sb, new_sb);
  return (int)cudaGetLastError();
}

// Caches: values [B, L, KV, D] int8, scales [B, L, KV, 1] fp32; new rows
// [B, S, KV, D] bf16; all contiguous.
extern "C" int vlm_kv_write_int8(void* k_q, void* k_s, void* v_q, void* v_s,
                                 const void* k_new, const void* v_new,
                                 const int* start, int uniform, int B, int S,
                                 int L, int KV, int D, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || D <= 0 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  dim3 grid(B * S, 2);
  const int threads = 32 * (KV < 8 ? KV : 8);
  kv_write_int8_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(k_q), static_cast<float*>(k_s),
      static_cast<int8_t*>(v_q), static_cast<float*>(v_s),
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), start, uniform, S, L, KV, D);
  return (int)cudaGetLastError();
}
