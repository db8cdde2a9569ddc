// B7: grouped int4 GEMM, y = x . dequant(q, scale)^T, for the 4bit products
// with fewer than 512 rows (decode steps, single-image admissions).
//
// Replaces vlm_tpu/ops/quant.py `_int4_matmul_kernel` (launched by
// `_int4_matmul_pallas`): x [M, K] bf16; q [N, K/2] int8, byte j of row n
// holding k = 2j in its low nibble and k = 2j + 1 in its high nibble, both
// two's complement (the nn.Linear layout; the TPU kernel took the same bytes
// as [K/2, N]); scale [N, K/gs] fp32, one per group of gs inputs; y [M, N]
// bf16. Each weight is bf16(nibble * scale) with the product in fp32 and one
// rounding, and the sums accumulate in fp32 on the tensor cores: the numbers
// of the Pallas body and of the plain version.
//
// The TPU kernel split x into even and odd columns and ran two dots, because
// its matrix unit could not re-interleave nibbles. Here a lane's 16-byte
// word of packed weights is 32 neighbouring k of one column, and the
// mainloop reads x through the same order of k, so x stays whole.
//
// What bounds it on the H100: weight bytes. A Gemma decode step at 32 slots
// streams 0.99 GB of packed int4 plus 62 MB of fp32 scales, >= 0.31 ms at
// 3.35 TB/s. The mainloop (weight_stream.cuh, shared with B5) keeps
// 64-96 KB of weights in flight an SM in 128-byte chunks of 256 k, stages
// each chunk's group scales beside it (256 / gs a column), dequantizes
// whole words in registers and splits K over a thread block cluster. Packed
// rows that are only 8-byte aligned (SigLIP fc2: K = 4304, 2,152 bytes)
// take the same kernel with 8-byte copies, chosen here from the pitch.
//
// Requirements (checked by the wrapper and here): K % 16 == 0, gs a power
// of two in [16, 128] dividing K, N even, contiguous tensors with 16-byte
// aligned bases.
#include "weight_stream.cuh"

// bm, bn: the plan's tile (16, 32 or 64 rows; 64 or 128 columns;
// ops/quant.py `stream_plan`); splits blocks of one cluster share each
// output tile, `per` 128-byte chunks each; y is bf16, or fp32 where f32.
extern "C" int vlm_int4_matmul(const void* x, const void* q, const void* scale,
                               void* y, int M, int N, int K, int group_size,
                               int bm, int bn, int splits, int per, int f32,
                               void* stream) {
  constexpr int kChunk = vlm::ws::kSubs * vlm::ws::kSub;
  const int row_bytes = K / 2;
  int lg = 0;
  while ((1 << lg) < group_size) ++lg;
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 2 != 0 ||
      group_size < 16 || group_size > 128 || (1 << lg) != group_size ||
      K % group_size != 0 || per < 1 ||
      (long long)per * splits * kChunk < row_bytes ||
      (long long)per * (splits - 1) * kChunk >= row_bytes)
    return (int)cudaErrorInvalidValue;
  const vlm::ws::Args a{static_cast<const __nv_bfloat16*>(x),
                        static_cast<const uint8_t*>(q),
                        static_cast<const float*>(scale),
                        y, M, N, K, row_bytes, K / group_size, lg, per, 0,
                        f32 != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return row_bytes % 16 == 0
             ? vlm::ws::launch<vlm::ws::Fmt::kInt4, 0>(a, bm, bn, splits, st)
             : vlm::ws::launch<vlm::ws::Fmt::kInt4, 8>(a, bm, bn, splits, st);
}
