// B4: uint8 image batch -> normalized pixels in bf16 or fp32,
// x * scale[c] + bias[c], written straight into the patch embedding's
// layout.
//
// Replaces vlm_tpu/ops/preprocess.py `_normalize_pallas` (its inner
// `kernel`), which folds (x / 255 - mean) / std into one multiply-add per
// channel, together with the ViT's unfold of the NHWC result into patch
// vectors (vlm_tpu/models/vit.py: the patch embedding's conv).
//
// What bounds it on the H100: bytes, 1 read and 2 (bf16) or 4 (fp32)
// written per element, a few hundred KB to a few MB per admission; its time
// is the launch and one DRAM round trip. A standalone NHWC pass left the
// ViT an unfold (reshape, permute, reshape) that cannot stay a view: a copy
// kernel as large as this one. So the output goes where the patch
// embedding reads it: [B, (H/ph)(W/pw), ph * pw * 3], the conv's HWIO
// order (row in patch, column in patch, channel) within a patch. NHWC is
// the same map with one patch an image (ph = H, pw = W), so one kernel
// template covers both layouts and both output types: bf16 and fp32 (for
// models that run with quantization "fp32").
//
// The design: one block an image row (grid.y, striding over the rows
// past 65,535), each thread 4 values of it
// (one 4-byte load where the rows allow it), so a warp reads 128
// contiguous bytes and writes where neighbouring threads write
// neighbouring values: along a row the pixels of one patch are a run of
// pw * 3 values that lands contiguously at offset (y mod ph) * pw * 3 of
// its patch vector (SigLIP at 224 px: a 672-byte row is 16 runs of 42
// values), and consecutive runs land one patch vector apart. A thread
// stores its 4 values as one vector (8 bytes in bf16, 16 in fp32) where
// they fall in one run at a 4-value boundary, as pairs where the run's
// length is even (a pair that starts at an even value never leaves its
// run), else one by one. (A first version gave each thread 16 values
// with one 16-byte load: its stores then fell 32 or 64 bytes apart across
// a warp, and an H100 took 1.5x (bf16) to 3x (fp32) the time of an NHWC
// pass of 4 values a thread.) Each value is
// one fused multiply-add, fma(x, scale, bias) rounded once, as the
// reference's kernel computes it (interpreted on the CPU, XLA contracts
// its x * scale + bias into one FMA); the plain version forms the same
// exact product-sum in float64 and rounds it once, so the three agree
// bitwise.
#include "common.cuh"

namespace {

__device__ __forceinline__ void store4(__nv_bfloat16* y, const float* v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(y) = u;
}

__device__ __forceinline__ void store4(float* y, const float* v) {
  *reinterpret_cast<float4*>(y) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store2(__nv_bfloat16* y, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* y, float a, float b) {
  *reinterpret_cast<float2*>(y) = make_float2(a, b);
}

__device__ __forceinline__ void store1(__nv_bfloat16* y, float v) {
  *y = __float2bfloat16(v);
}

__device__ __forceinline__ void store1(float* y, float v) { *y = v; }

struct Geometry {
  int rows, H, W, ph, pw;  // rows: B * H
  int vec;  // 4-byte loads: the rows and the base are 4-byte aligned
};

// grid (blocks over a row's 4-value pieces, rows): rows over the batch
template <typename T>
__global__ void normalize_kernel(const uint8_t* __restrict__ x,
                                 T* __restrict__ y, const Geometry g,
                                 float s0, float s1, float s2, float b0,
                                 float b1, float b2) {
  const int row_elems = g.W * 3;
  const int run = g.pw * 3;                   // a patch's values in a row
  const int64_t patch = static_cast<int64_t>(g.ph) * run;  // its vector
  for (int row = blockIdx.y; row < g.rows; row += gridDim.y) {
    const int img = row / g.H, yy = row - img * g.H;
    // where the row's first value lands: patch (img, yy / ph, 0), offset
    // (yy mod ph) * run
    const int64_t row_base =
        (static_cast<int64_t>(img) * (g.H / g.ph) + yy / g.ph) *
            (g.W / g.pw) * patch +
        static_cast<int64_t>(yy % g.ph) * run;
    const uint8_t* src = x + static_cast<int64_t>(row) * row_elems;
    for (int e0 = 4 * (blockIdx.x * blockDim.x + threadIdx.x); e0 < row_elems;
         e0 += 4 * gridDim.x * blockDim.x) {
      const int n = min(4, row_elems - e0);
      unsigned char in[4];
      if (g.vec && n == 4) {
        const uchar4 u = *reinterpret_cast<const uchar4*>(src + e0);
        in[0] = u.x, in[1] = u.y, in[2] = u.z, in[3] = u.w;
      } else {
  #pragma unroll
        for (int k = 0; k < 4; ++k) in[k] = k < n ? src[e0 + k] : 0;
      }
      const int c0 = e0 % 3;  // the channel of value e0
      float out[4];
  #pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = (c0 + k) % 3;
        out[k] = __fmaf_rn(static_cast<float>(in[k]),
                           c == 0 ? s0 : c == 1 ? s1 : s2,
                           c == 0 ? b0 : c == 1 ? b1 : b2);
      }
      int within = e0 % run;
      int64_t o = row_base + (e0 / run) * patch + within;
      if (n == 4 && within + 4 <= run && o % 4 == 0) {
        store4(y + o, out);
      } else if (n == 4 && run % 2 == 0) {
        store2(y + o, out[0], out[1]);
        within += 2;
        o += within == run ? patch - run + 2 : 2;
        store2(y + o, out[2], out[3]);
      } else {
        for (int k = 0; k < n; ++k) {
          store1(y + o, out[k]);
          ++within;
          if (within == run) {
            within = 0;
            o += patch - run + 1;
          } else {
            ++o;
          }
        }
      }
    }
  }
}

}  // namespace

// x: uint8 [B, H, W, 3], contiguous. y: [B, (H/ph)(W/pw), ph * pw * 3] in
// fp32 (fp32 != 0) or bf16, contiguous, 16-byte aligned (the wrapper's
// fresh tensor); ph = H, pw = W is NHWC. H % ph == 0 and W % pw == 0.
extern "C" int vlm_normalize(const void* x, void* y, int B, int H, int W,
                             int ph, int pw, const float* scale,
                             const float* bias, int fp32, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || ph <= 0 || pw <= 0 || H % ph || W % pw ||
      static_cast<int64_t>(B) * H > (1LL << 31) - 1 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return (int)cudaErrorInvalidValue;
  const Geometry g{B * H, H, W, ph, pw,
                   (W * 3) % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0};
  const int pieces = (W * 3 + 3) / 4;  // a row's 4-value pieces
  const int threads = pieces < 256 ? (pieces + 31) / 32 * 32 : 256;
  const dim3 grid((pieces + threads - 1) / threads,
                  B * H < 65535 ? B * H : 65535);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(x);
  if (fp32)
    normalize_kernel<float><<<grid, threads, 0, st>>>(
        in, static_cast<float*>(y), g, scale[0], scale[1], scale[2], bias[0],
        bias[1], bias[2]);
  else
    normalize_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        in, static_cast<__nv_bfloat16*>(y), g, scale[0], scale[1], scale[2],
        bias[0], bias[1], bias[2]);
  return (int)cudaGetLastError();
}
