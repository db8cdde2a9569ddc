// B5: weight-only int8 GEMM, y = (x . q^T) * scale, for the products with
// fewer than 512 rows (decode steps, single-image admissions).
//
// Replaces vlm_tpu/ops/quant.py `_int8_matmul_kernel` (launched by
// `_int8_matmul_pallas`): x [M, K] bf16, q [N, K] int8 (the nn.Linear
// layout; the TPU kernel took [K, N]), scale [N] fp32, y [M, N] bf16. The
// int8 weights are widened to bf16 on chip (exact: |q| <= 127), the
// product accumulates in fp32 on the tensor cores, and the per-column scale
// multiplies the fp32 accumulator in the epilogue, as in the TPU kernel.
//
// What bounds it on the H100: weight bytes. A Gemma decode step at 32 slots
// streams 1.98 GB of int8 block weights, >= 0.59 ms at 3.35 TB/s, and does
// only 2 * M FLOPs per weight byte. The mainloop is B7's, in
// weight_stream.cuh: 128- or 64-column blocks walking 128-byte chunks of the
// weight rows through an mbarrier ring fed by TMA, whole 16-byte words of
// weights a lane, split K over a thread block cluster reduced through
// distributed shared memory in rank order (deterministic).
//
// Requirements (checked by the wrapper and here): K % 16 == 0 (16-byte
// rows of q), N even, contiguous tensors with 16-byte aligned bases.
#include "weight_stream.cuh"

// bm, bn: the plan's tile (16, 32 or 64 rows; 64 or 128 columns;
// ops/quant.py `stream_plan`); splits blocks of one cluster share each
// output tile, `per` 128-byte chunks each; y is bf16, or fp32 where f32.
extern "C" int vlm_int8_matmul(const void* x, const void* q, const void* scale,
                               void* y, int M, int N, int K, int bm, int bn,
                               int splits, int per, int f32, void* stream) {
  constexpr int kChunk = vlm::ws::kSubs * vlm::ws::kSub;
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 2 != 0 || per < 1 ||
      (long long)per * splits * kChunk < K ||
      (long long)per * (splits - 1) * kChunk >= K)
    return (int)cudaErrorInvalidValue;
  const vlm::ws::Args a{static_cast<const __nv_bfloat16*>(x),
                        static_cast<const uint8_t*>(q),
                        static_cast<const float*>(scale),
                        y, M, N, K, K, 0, 0, per, 0, f32 != 0};
  return vlm::ws::launch<vlm::ws::Fmt::kInt8, 0>(
      a, bm, bn, splits, static_cast<cudaStream_t>(stream));
}

// How many clusters of `splits` (1-8) blocks of B5's and B7's mainloop the
// current device runs at once, into *count (ops/_lib.py `max_clusters`).
extern "C" int vlm_stream_clusters(int splits, int* count) {
  if (splits < 1 || splits > vlm::ws::kMaxSplits || count == nullptr)
    return (int)cudaErrorInvalidValue;
  return vlm::ws::max_clusters(splits, count);
}
