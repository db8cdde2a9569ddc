// B4: uint8 image batch -> normalized pixels in bf16 or fp32,
// x * scale[c] + bias[c].
//
// Replaces vlm_tpu/ops/preprocess.py `_normalize_pallas` (its inner
// `kernel`), which folds (x / 255 - mean) / std into one multiply-add per
// channel.
//
// What bounds it on the H100: bytes, 1 read and 2 written per element
// (224 x 224 x 3 per image). The design is a grid-stride elementwise pass
// where each thread loads 4 bytes as one word and stores 4 bf16 as 8 bytes;
// the channel of element i is i mod 3 of the NHWC layout the patch
// embedding consumes. Fusing it into the patch-embedding layout is later
// work. One template over the output type: bf16 (4 values as 8 bytes) and
// fp32 (as 16 bytes, for models that run with quantization "fp32"); in
// both the multiply and the add round separately, never as one FMA, so
// the result is bitwise the plain version's.
#include "common.cuh"

namespace {

__device__ __forceinline__ void store4(__nv_bfloat16* y, const float* v) {
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(y);
  dst[0] = __floats2bfloat162_rn(v[0], v[1]);
  dst[1] = __floats2bfloat162_rn(v[2], v[3]);
}

__device__ __forceinline__ void store4(float* y, const float* v) {
  *reinterpret_cast<float4*>(y) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store1(__nv_bfloat16* y, float v) {
  *y = __float2bfloat16(v);
}

__device__ __forceinline__ void store1(float* y, float v) { *y = v; }

template <typename T>
__global__ void normalize_kernel(const uint8_t* __restrict__ x,
                                 T* __restrict__ y, int64_t n,
                                 float s0, float s1, float s2, float b0,
                                 float b1, float b2) {
  const float sc[3] = {s0, s1, s2};
  const float bi[3] = {b0, b1, b2};
  const int64_t words = (n + 3) / 4;
  for (int64_t w = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; w < words;
       w += (int64_t)gridDim.x * blockDim.x) {
    const int64_t base = w * 4;
    const int c0 = (int)(base % 3);
    if (base + 4 <= n) {
      const uchar4 u = reinterpret_cast<const uchar4*>(x)[w];
      const unsigned char in[4] = {u.x, u.y, u.z, u.w};
      float out[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = (c0 + j) % 3;
        // separate multiply and add, rounded like the plain version's
        out[j] = __fadd_rn(__fmul_rn((float)in[j], sc[c]), bi[c]);
      }
      store4(y + base, out);
    } else {
      for (int64_t i = base; i < n; ++i) {
        const int c = (int)(i % 3);
        store1(y + i, __fadd_rn(__fmul_rn((float)x[i], sc[c]), bi[c]));
      }
    }
  }
}

}  // namespace

// fp32 != 0: y is fp32, else bf16; both 16-byte aligned (the wrapper's
// fresh tensors)
extern "C" int vlm_normalize(const void* x, void* y, int64_t n,
                             const float* scale, const float* bias, int fp32,
                             void* stream) {
  const int threads = 256;
  const int64_t words = (n + 3) / 4;
  const int blocks = (int)((words + threads - 1) / threads < 4096
                               ? (words + threads - 1) / threads
                               : 4096);
  const dim3 grid(blocks > 0 ? blocks : 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(x);
  if (fp32)
    normalize_kernel<float><<<grid, threads, 0, st>>>(
        in, static_cast<float*>(y), n, scale[0], scale[1], scale[2], bias[0],
        bias[1], bias[2]);
  else
    normalize_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        in, static_cast<__nv_bfloat16*>(y), n, scale[0], scale[1], scale[2],
        bias[0], bias[1], bias[2]);
  return (int)cudaGetLastError();
}
