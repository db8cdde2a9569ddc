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
