// B1: fused prefill / encoder attention, softmax(q k^T * scale + masks) v,
// on wgmma and TMA.
//
// Replaces vlm_tpu/ops/attention.py `_flash_kernel` (launched by
// `_flash_attention`). The TPU kernel kept one head's whole K/V resident in
// VMEM; one Gemma prefill head at S~1100, D=256 is ~560 KB per tensor, more
// than the 227 KB of shared memory a Hopper block may use. So this kernel
// streams K/V through shared memory in 64-key tiles with an online softmax.
//
// What bounds it on the H100: at the serving shapes neither the bytes
// (q, k, v, o once: 9.4 MB SigLIP, 11.7 MB Gemma, ~3 us at 3.35 TB/s) nor
// the products (1.2 and 3.2 GFLOP, ~1-3 us at 989 TFLOP/s) but the
// latency of getting tiles into shared memory and through the tensor
// cores: the mma.sync kernel this replaces spent its time in synchronous
// 4-byte tile loads and in shared-memory fragment reads (2 % of the bf16
// rate). The design:
// - Rows. A block takes 128 query rows, 64 to each of two consumer
//   warpgroups, of one (batch, KV head). With grouped-query attention the
//   rows are (position, query head) pairs of hpb = gcd(G, 64) heads of
//   the KV head's group (G = H / KV), so one K/V tile feeds all 8 Gemma
//   heads; SigLIP (G = 1) takes 128 positions of one head. Row r is
//   position p0 + r / hpb of head h0 + r % hpb (shifts: hpb is a power of
//   two).
// - Copies. One producer thread issues TMA loads (cp.async.bulk.tensor)
//   of the Q tile once and of K and V tiles through a 2-3 stage ring with
//   full and empty mbarriers, so the next tile lands while this one is
//   multiplied. TMA, not cp.async: the box arrives in the 128-byte swizzle
//   that the wgmma descriptors name, rows past Sk or Sq and head-dim
//   columns past D are zero-filled by the box (no padded copy, no
//   per-element index arithmetic). A 128-byte swizzle row holds 64 bf16,
//   so each tile is ceil(D / 64) boxes of 64 columns: SigLIP's 144-byte
//   rows take two boxes, the second zero past column 72.
// - Products. S = Q K^T is wgmma m64n64k16 with both operands K-major in
//   shared memory, over ceil(D / 16) steps of 16 (80 deep for D = 72). The
//   probabilities stay in registers: the S accumulator is the register A
//   operand of O += P V (the same fragment layout), and V, row-major
//   [keys, D] in shared memory, is the transposed (MN-major) B operand,
//   one m64n64k16 per 64-column block. Online softmax in fp32 registers in
//   base 2, the row sums kept per thread and reduced once at the end.
// - Skipped tiles. A block loads and multiplies only the key tiles that
//   hold a live key of one of its rows (kv_len, the causal limit widened
//   by the prefix); tests/test_torch_flash_plan.py emulates the range on
//   the CPU. A row with no live key (kv_len = 0, or a
//   causal row before the first key) must return the mean of V over all
//   Sk keys, as `_flash_kernel` does with its finite -1e30: a block with
//   such a row loads every tile, so that row's weights are uniform and no
//   0/0 forms.
// - Epilogue. O / l leaves through shared memory: each warpgroup writes
//   its 64 rows, in bf16 and the 128-byte swizzle, over its own rows of
//   the Q tile (read by no one after its last product), and one thread
//   stores them with TMA, which drops rows past Sq and columns past D.
//   Stores straight from the accumulator layout (4 bytes a thread, 16
//   contiguous bytes a row per warp instruction) were, by per-phase
//   timestamps of a block, the largest single phase at D = 256.
// - Occupancy. One block an SM: 384 threads (two consumer warpgroups and
//   a producer warpgroup) and up to 197 KB of shared memory at D = 256 (Q
//   64 KB, two stages of K and V at 64 KB). A launch of 384 threads gets
//   168 registers a thread, and with one producer warp instead (288
//   threads) an SM's four register partitions still cap it at 168: at
//   D = 256 the 128 fp32 output accumulators then spilled 1.1 KB a thread.
//   So the producer warpgroup gives its registers back (setmaxnreg 40)
//   and the consumers take 232: no spills at any head dim.
//
// Head dims up to 96 (CLIP-L, SigLIP, EVA, the Q-Former) take
// flash_kernel_small below: the same rows, copies and masks, persistent,
// its softmax overlapping its products.
//
// Masks follow `_flash_kernel`: causal with the diagonal at the end of the
// kv axis (offset Sk - Sq), optionally widened by a prefix-LM length, and a
// per-batch kv_len. Allowed keys of a row are kj < lim, with lim =
// min(max(pos + Sk - Sq + 1, prefix), kv_len) when causal, kv_len when not.
// Requirements (the wrapper checks and pads): D even, <= 256; strides of
// q, k, v multiples of 8 elements and 16-byte aligned bases (TMA).
#include "common.cuh"

namespace {

constexpr int kRows = 128;  // query rows of a block
constexpr int kKeys = 64;   // keys of a K/V tile
constexpr int kThreads = 3 * 128;
constexpr int kQBox = kRows * 128;  // one 64-column box of the Q tile
constexpr int kKVBox = kKeys * 128;  // one 64-column box of a K or V tile
constexpr int kSmallD = 96;  // head dims of flash_kernel_small

template <int NB>  // 64-column boxes of the head dim
struct Shape {
  static constexpr int kStages = NB >= 4 ? 2 : 3;
  static constexpr int kQBytes = NB * kQBox;
  static constexpr int kTileBytes = NB * kKVBox;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kSmem =
      kQBytes + kStages * kStageBytes + 1024 + (2 * kStages + 1) * 8;
};

using vlm::desc_sw128;
using vlm::smem_u32;

#define VLM_ACC32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define VLM_REGS32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d[64 x 64] (+)= a[64 x 16] . b[64 x 16]^T: both K-major in shared
// memory; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VLM_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : VLM_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += a[64 x 16] . b[16 x 64]: a from registers, b MN-major
// (row-major [k, n]) in shared memory
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VLM_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : VLM_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 72] += a[64 x 16] . b[16 x 72]: a from registers, b MN-major
__device__ __forceinline__ void wgmma_rs72(float* d, const uint32_t* a,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d[64 x 88] += a[64 x 16] . b[16 x 88]: a from registers, b MN-major
__device__ __forceinline__ void wgmma_rs88(float* d, const uint32_t* a,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %49, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43}, "
      "{%44, %45, %46, %47}, %48, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d[64 x 96] += a[64 x 16] . b[16 x 96]: a from registers, b MN-major
__device__ __forceinline__ void wgmma_rs96(float* d, const uint32_t* a,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// desc_sw128 with its leading byte offset: an MN-major operand wider than
// one 64-column box, the boxes lbo bytes apart
__device__ __forceinline__ uint64_t desc_sw128_lbo(uint32_t addr,
                                                   uint32_t lbo) {
  return (desc_sw128(addr) & ~(static_cast<uint64_t>(0x3FFF) << 16)) |
         (static_cast<uint64_t>(lbo >> 4) << 16);
}

// keep the compiler from moving accumulator accesses across the async span
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// NB: 64-column boxes of the head dim; KS: 16-deep steps of S = Q K^T
// (ceil(D / 16) rounded up to a bucket; the zero-filled columns add 0)
template <int NB, int KS>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_o,
             const int* __restrict__ kv_len,
             const int* __restrict__ prefix_len, int H, int KV, int Sq, int Sk,
             int hpb_log2, float scale_log2, int causal) {
  using S = Shape<NB>;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = smem;
  unsigned char* kv_s = smem + S::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_s + S::kStages * S::kStageBytes);
  uint64_t* empty = full + S::kStages;
  uint64_t* q_bar = empty + S::kStages;

  const int P = kRows >> hpb_log2;  // positions of the block
  const int p0 = blockIdx.x * P;
  const int h0 = blockIdx.y << hpb_log2;
  const int b = blockIdx.z;
  const int kvh = h0 / (H / KV);

  // the block's key range (block_key_tiles in
  // tests/test_torch_flash_plan.py mirrors these lines)
  const int kvl = min(kv_len ? kv_len[b] : Sk, Sk);
  const int pfx = causal && prefix_len ? prefix_len[b] : 0;
  const int off = Sk - Sq;
  int lim_first = kvl, lim_last = kvl;
  if (causal) {
    lim_first = min(max(p0 + off + 1, pfx), kvl);
    lim_last = min(max(min(p0 + P, Sq) + off, pfx), kvl);
  }
  const int keys = lim_first <= 0 ? Sk : lim_last;  // a dead row: every key
  const int n_tiles = (keys + kKeys - 1) / kKeys;

  if (threadIdx.x == 256) {  // the producer's descriptors, fetched early
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tm_q) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tm_k) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tm_v) : "memory");
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      vlm::mbar_init(&full[s], 1);
      vlm::mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    vlm::mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: hands its registers to the consumers; one thread
    // loads Q, then keeps the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      vlm::mbar_expect_tx(q_bar, S::kQBytes);
      for (int c = 0; c < NB; ++c) {
        if (hpb_log2 == 0)
          vlm::tma_load_4d(q_s + c * kQBox, &tm_q, q_bar, 64 * c, p0, h0, b);
        else
          vlm::tma_load_5d(q_s + c * kQBox, &tm_q, q_bar, 64 * c, 0,
                           blockIdx.y, p0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % S::kStages;
        if (i >= S::kStages) vlm::mbar_wait(&empty[s], ((i / S::kStages) - 1) & 1);
        unsigned char* st = kv_s + s * S::kStageBytes;
        vlm::mbar_expect_tx(&full[s], S::kStageBytes);
        for (int c = 0; c < NB; ++c) {
          vlm::tma_load_4d(st + c * kKVBox, &tm_k, &full[s], 64 * c,
                           i * kKeys, kvh, b);
          vlm::tma_load_4d(st + S::kTileBytes + c * kKVBox, &tm_v, &full[s],
                           64 * c, i * kKeys, kvh, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of the block; this
    // thread's rows are r and r + 8 (the wgmma accumulator layout: element
    // 4 j + e is row 16 warp + g + 8 (e >> 1), column 8 j + 2 t + (e & 1))
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    int pos[2], lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wg * 64 + warp * 16 + g + 8 * i;
      pos[i] = p0 + (r >> hpb_log2);
      lim[i] = causal ? min(max(pos[i] + off + 1, pfx), kvl) : kvl;
    }
    const int lim_min = min(min(lim[0], lim[1]), Sk);

    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float acc[NB][32];
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

    vlm::mbar_wait(q_bar, 0);
    const uint32_t q_base = smem_u32(q_s) + wg * 64 * 128;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % S::kStages;
      vlm::mbar_wait(&full[s], (i / S::kStages) & 1);
      const uint32_t k_base = smem_u32(kv_s + s * S::kStageBytes);
      const uint32_t v_base = k_base + S::kTileBytes;

      // S = Q K^T over the head dim in steps of 16 (32 bytes of a 128-byte
      // swizzle row; a new 64-column box every 4 steps)
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.f;
      fence_acc(sc);
      vlm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_ss(sc, desc_sw128(q_base + (kk / 4) * kQBox + (kk % 4) * 32),
                 desc_sw128(k_base + (kk / 4) * kKVBox + (kk % 4) * 32));
      vlm::wgmma_commit();
      vlm::wgmma_wait<0>();
      fence_acc(sc);

      // scale, mask, online softmax (base 2) over rows r and r + 8
      const int k0 = i * kKeys;
      const bool partial = k0 + kKeys > lim_min;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (partial) {
            const int kj = k0 + 8 * j + 2 * t + (e & 1);
            if (kj >= lim[e >> 1]) x = vlm::kNegInf;
            if (kj >= Sk) x = -INFINITY;  // past the keys: no weight
          }
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(vlm::kFullMask, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(vlm::kFullMask, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float p = exp2f(sc[j] - m[(j >> 1) & 1]);
        sc[j] = p;
        l[(j >> 1) & 1] += p;
      }
      // P (bf16) from the S accumulators: the A fragments of 16 keys a step,
      // formed before the products start
      uint32_t pa[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) pa[j] = vlm::pack_bf16(sc[2 * j], sc[2 * j + 1]);
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int j = 0; j < 32; ++j) acc[c][j] *= corr[(j >> 1) & 1];

      // O += P V: V's 64-column boxes one wgmma each, 16 key rows = 2048
      // bytes a step
#pragma unroll
      for (int c = 0; c < NB; ++c) fence_acc(acc[c]);
      vlm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
        for (int c = 0; c < NB; ++c)
          wgmma_rs(acc[c], pa + 4 * kk,
                   desc_sw128(v_base + c * kKVBox + kk * 2048));
      vlm::wgmma_commit();
      vlm::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NB; ++c) fence_acc(acc[c]);
      if (lane == 0) vlm::mbar_arrive(&empty[s]);
    }

    // O / l in bf16 into this warpgroup's own rows of the Q tile (no
    // longer read), in the 128-byte swizzle the O map names (16-byte chunk
    // j of row r at chunk j ^ (r % 8): conflict-free), then one thread
    // stores the 64-row boxes with TMA, which drops rows past Sq and
    // columns past D
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(vlm::kFullMask, l[r], 1);
      l[r] += __shfl_xor_sync(vlm::kFullMask, l[r], 2);
    }
    unsigned char* o_s = q_s + wg * 64 * 128;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / l[r];
      const int row = warp * 16 + g + 8 * r;
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(
              o_s + c * kQBox + row * 128 + ((j ^ (row & 7)) * 16) + 4 * t) =
              __floats2bfloat162_rn(acc[c][4 * j + 2 * r] * inv,
                                    acc[c][4 * j + 2 * r + 1] * inv);
    }
    vlm::fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (threadIdx.x % 128 == 0) {
      for (int c = 0; c < NB; ++c) {
        if (hpb_log2 == 0)
          vlm::tma_store_4d(&tm_o, o_s + c * kQBox, 64 * c, p0 + 64 * wg, h0, b);
        else
          vlm::tma_store_5d(&tm_o, o_s + c * kQBox, 64 * c, 0, blockIdx.y,
                            p0 + wg * (P / 2), b);
      }
      vlm::tma_store_drain();
    }
  }
}

template <int NB, int KS>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const CUtensorMap& to, const int* kv_len, const int* prefix_len,
           dim3 grid, int H, int KV, int Sq, int Sk, int hpb_log2,
           float scale_log2, int causal, cudaStream_t stream) {
  // the shared-memory limit, raised once a device (a host call per launch
  // otherwise)
  static unsigned raised = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !(raised >> dev & 1u)) {
    err = cudaFuncSetAttribute(flash_kernel<NB, KS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Shape<NB>::kSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) raised |= 1u << dev;
  }
  flash_kernel<NB, KS><<<grid, kThreads, Shape<NB>::kSmem, stream>>>(
      tq, tk, tv, to, kv_len, prefix_len, H, KV, Sq, Sk, hpb_log2, scale_log2,
      causal);
  return (int)cudaGetLastError();
}

// ---- the form for head dims <= 96 (CLIP-L 64, SigLIP 72, EVA 88) ----
//
// flash_kernel above loses to SDPA at these head dims by 1.1-1.7x (chip
// runs of testing/attention_breakdown.py, PERF.md): a warpgroup runs S =
// Q K^T, waits, runs the softmax, runs P V, waits, so nothing overlaps the
// exponentials (at D = 64 as long as the products: 256 FLOPs a (row, key)
// against one ex2) with a product; its loop issues 553 instructions a warp
// and tile at D = 64, mostly the mask's selects and the scaling kept on
// every tile; P V ran over 64-column boxes, 128 columns at D = 72 and 88.
// This form keeps the rows, copies and epilogue of flash_kernel and:
// - issues tile i + 1's S = Q K^T (into a second set of accumulators)
//   and tile i - 1's O += P V before tile i's softmax, so the
//   exponentials overlap both products (O is rescaled after them, when
//   nothing is in flight), the two warpgroups taking turns to issue, so
//   one's softmax overlaps the other's products and the two do not
//   contend for the exponential unit at once;
// - runs P V as one wgmma of N = D rounded up to 8 (72, 88, 96) over V's
//   two 64-column boxes (the descriptor's leading offset: a box apart);
// - masks only a tile that holds a masked key of some row of the warp;
//   other tiles scale inside the exponent (one FFMA and one ex2 a score;
//   -1e30 stays out of that FFMA, whose error at 1e30 is not small);
// - is persistent: a block an SM walks the items (row tile, head group,
//   batch row) of the grid, the row tiles slowest (the short last tile
//   last; under the causal mask the longest first), its producer loading
//   the next item's Q (two Q tiles) and K/V (one ring of 8 stages, 5
//   from D = 72, over all its items) while the consumers finish this one:
//   at SigLIP's 4 and
//   EVA's 5 key tiles, a block's own set-up, first loads and epilogue
//   had cost more than its loop; a warpgroup with no live row in an item
//   (Sq - p0 <= 64) only passes its tiles through the ring.

template <int N>  // P.V width: 64, 72, 88 or 96
struct SmallShape {
  static constexpr int kNB = (N + 63) / 64;  // 64-column boxes
  static constexpr int kKS = (N + 15) / 16;  // 16-deep steps of Q K^T
  // as many stages as fit beside the two Q tiles: a stage is free again
  // only after the next tile's products (P V runs a tile behind)
  static constexpr int kStages = kNB == 1 ? 8 : 5;
  static constexpr int kQBytes = kNB * kQBox;
  static constexpr int kTileBytes = kNB * kKVBox;
  static constexpr int kStageBytes = 2 * kTileBytes;
  // two Q tiles, the ring, the alignment slack, 2 kStages + 4 barriers
  static constexpr int kSmem =
      2 * kQBytes + kStages * kStageBytes + 1024 + (2 * kStages + 4) * 8;
};

template <int N>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs(d, a, db);
  else if constexpr (N == 72) wgmma_rs72(d, a, db);
  else if constexpr (N == 88) wgmma_rs88(d, a, db);
  else wgmma_rs96(d, a, db);
}

template <int K>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs16(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the 16 scores of a thread's row r (of its two) in a tree
__device__ __forceinline__ float row_max(const float* x, int r) {
  float a[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) a[q] = fmaxf(x[4 * q + 2 * r], x[4 * q + 2 * r + 1]);
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int q = 0; q < w; ++q) a[q] = fmaxf(a[q], a[q + w]);
  return a[0];
}
__device__ __forceinline__ float row_sum(const float* x, int r) {
  float a[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) a[q] = x[4 * q + 2 * r] + x[4 * q + 2 * r + 1];
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int q = 0; q < w; ++q) a[q] += a[q + w];
  return a[0];
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel_small(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o,
                   const int* __restrict__ kv_len,
                   const int* __restrict__ prefix_len, int H, int KV, int Sq,
                   int Sk, int hpb_log2, float scale_log2, int causal,
                   int groups, int batch, int tiles) {
  using S = SmallShape<N>;
  constexpr int kAcc = N / 2;  // O accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = smem;  // two Q tiles: an item's and the next's
  unsigned char* kv_s = smem + 2 * S::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_s + S::kStages * S::kStageBytes);
  uint64_t* empty = full + S::kStages;
  uint64_t* q_full = empty + S::kStages;
  uint64_t* q_empty = q_full + 2;

  // Persistent: block x takes items x, x + gridDim.x, ... of tiles x
  // groups x batch, the row tiles slowest (the last, the fewest rows,
  // last; causal: reversed, the most keys first). An item's geometry:
  const int P = kRows >> hpb_log2;
  const int items = tiles * groups * batch;
  const int off = Sk - Sq;
  struct Item {
    int p0, h0, hg, b, kvh, kvl, pfx, n_tiles, consumers;
  };
  auto item_at = [&](int it) {
    Item m;
    const int per = groups * batch;
    const int z = it / per, rem = it - z * per;
    m.hg = rem % groups;
    m.b = rem / groups;
    m.p0 = (causal ? tiles - 1 - z : z) * P;
    m.h0 = m.hg << hpb_log2;
    m.kvh = m.h0 / (H / KV);
    // the item's key range (block_key_tiles in
    // tests/test_torch_flash_plan.py mirrors these lines)
    m.kvl = min(kv_len ? kv_len[m.b] : Sk, Sk);
    m.pfx = causal && prefix_len ? prefix_len[m.b] : 0;
    int lim_first = m.kvl, lim_last = m.kvl;
    if (causal) {
      lim_first = min(max(m.p0 + off + 1, m.pfx), m.kvl);
      lim_last = min(max(min(m.p0 + P, Sq) + off, m.pfx), m.kvl);
    }
    const int keys = lim_first <= 0 ? Sk : lim_last;  // a dead row: all
    m.n_tiles = (keys + kKeys - 1) / kKeys;
    // warpgroups with a live row: the second only past 64 rows
    m.consumers = (min(P, Sq - m.p0) << hpb_log2) > 64 ? 2 : 1;
    return m;
  };

  if (threadIdx.x == 256) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tm_q) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tm_k) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tm_v) : "memory");
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      vlm::mbar_init(&full[s], 1);
      vlm::mbar_init(&empty[s], 8);  // every consumer warp, idle or not
    }
    for (int q = 0; q < 2; ++q) {
      vlm::mbar_init(&q_full[q], 1);
      vlm::mbar_init(&q_empty[q], 2);  // each warpgroup, its O stored
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // the producer: each item's Q into the free Q tile, its K/V tiles
    // through the ring (one ring over all the block's items)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int s = 0, phase = 0, loads = 0, k = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x, ++k) {
        const Item m = item_at(it);
        const int qb = k & 1;
        if (k >= 2) vlm::mbar_wait(&q_empty[qb], ((k >> 1) - 1) & 1);
        unsigned char* qt = q_s + qb * S::kQBytes;
        vlm::mbar_expect_tx(&q_full[qb], S::kQBytes);
        for (int c = 0; c < S::kNB; ++c) {
          if (hpb_log2 == 0)
            vlm::tma_load_4d(qt + c * kQBox, &tm_q, &q_full[qb], 64 * c,
                             m.p0, m.h0, m.b);
          else
            vlm::tma_load_5d(qt + c * kQBox, &tm_q, &q_full[qb], 64 * c, 0,
                             m.hg, m.p0, m.b);
        }
        for (int i = 0; i < m.n_tiles; ++i, ++loads) {
          if (loads >= S::kStages) vlm::mbar_wait(&empty[s], phase ^ 1);
          unsigned char* st = kv_s + s * S::kStageBytes;
          vlm::mbar_expect_tx(&full[s], S::kStageBytes);
          for (int c = 0; c < S::kNB; ++c) {
            vlm::tma_load_4d(st + c * kKVBox, &tm_k, &full[s], 64 * c,
                             i * kKeys, m.kvh, m.b);
            vlm::tma_load_4d(st + S::kTileBytes + c * kKVBox, &tm_v, &full[s],
                             64 * c, i * kKeys, m.kvh, m.b);
          }
          if (++s == S::kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of each item; this
  // thread's rows are r and r + 8 (element 4 j + e of an accumulator is
  // row 16 warp + g + 8 (e >> 1), column 8 j + 2 t + (e & 1))
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // the warpgroups take turns to issue a tile's products (named barriers
  // 3 + wg: each waits for its turn, then hands the turn over), so one's
  // softmax runs while the other's products do; warpgroup 1 lets 0 go
  // first
  auto my_turn = [&]() {
    asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
  };
  auto their_turn = [&]() {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
  };
  if (wg == 1) their_turn();
  int g0 = 0;  // the block's K/V tiles before this item's: the ring's place
  for (int it = blockIdx.x, k = 0; it < items; it += gridDim.x, ++k) {
    const Item im = item_at(it);
    const int qb = k & 1;
    const int nt = im.n_tiles;
    vlm::mbar_wait(&q_full[qb], (k >> 1) & 1);
    if (wg >= im.consumers) {
      // no live row: pass the item's tiles through the ring, and the turns
      for (int i = 0; i < nt; ++i) {
        const int G = g0 + i;
        my_turn();
        their_turn();
        vlm::mbar_wait(&full[G % S::kStages], (G / S::kStages) & 1);
        if (lane == 0) vlm::mbar_arrive(&empty[G % S::kStages]);
      }
      if (threadIdx.x % 128 == 0) vlm::mbar_arrive(&q_empty[qb]);
      g0 += nt;
      continue;
    }
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wg * 64 + warp * 16 + g + 8 * i;
      const int pos = im.p0 + (r >> hpb_log2);
      lim[i] = causal ? min(max(pos + off + 1, im.pfx), im.kvl) : im.kvl;
    }
    // the warp's least key limit: tiles wholly below it take no mask
    const int lim_warp = __reduce_min_sync(vlm::kFullMask,
                                           min(min(lim[0], lim[1]), Sk));
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float acc[kAcc];
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

    unsigned char* qt = q_s + qb * S::kQBytes;
    const uint32_t q_base = smem_u32(qt) + wg * 64 * 128;
    // S = Q K^T of tile i into sc (its first step overwrites sc)
    auto qk = [&](float* sc, int i) {
      const int G = g0 + i, s = G % S::kStages;
      vlm::mbar_wait(&full[s], (G / S::kStages) & 1);
      const uint32_t k_base = smem_u32(kv_s + s * S::kStageBytes);
      fence_acc(sc);
      vlm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < S::kKS; ++kk)
        wgmma_ss(sc, desc_sw128(q_base + (kk / 4) * kQBox + (kk % 4) * 32),
                 desc_sw128(k_base + (kk / 4) * kKVBox + (kk % 4) * 32),
                 kk > 0);
      vlm::wgmma_commit();
    };
    // O += P V of tile i: 16 keys (2048 bytes of each V box) a step, one
    // wgmma of N columns over the boxes
    auto pv = [&](uint32_t* pa, int i) {
      const uint32_t v_base = smem_u32(
          kv_s + ((g0 + i) % S::kStages) * S::kStageBytes + S::kTileBytes);
      fence_regs<kAcc>(acc);
      vlm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_pv<N>(acc, pa + 4 * kk,
                    desc_sw128_lbo(v_base + kk * 2048, kKVBox));
      vlm::wgmma_commit();
    };
    // tile i: S_i is in cur, P_{i-1} in prev. Issues tile i + 1's Q K^T
    // (into nxt) and O += P_{i-1} V_{i-1}, then runs tile i's softmax
    // (into pcur) while both products run, waits, and rescales O to tile
    // i's max. Both are issued on every path (at the ends: the last tile's
    // Q K^T again, and tile 0's V under P = 0), so ptxas keeps them
    // asynchronous
    auto step = [&](float* cur, float* nxt, uint32_t* pcur, uint32_t* prev,
                    int i) {
      my_turn();
      qk(nxt, min(i + 1, nt - 1));
      pv(prev, max(i - 1, 0));
      their_turn();
      const int k0 = i * kKeys;
      float corr[2];
      if (k0 + kKeys > lim_warp) {
        // masked keys in the tile: scores into base 2 first, then the mask
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + 8 * j + 2 * t + (e & 1);
            float x = cur[4 * j + e] * scale_log2;
            if (kj >= lim[e >> 1]) x = vlm::kNegInf;
            if (kj >= Sk) x = -INFINITY;  // past the keys: no weight
            cur[4 * j + e] = x;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = row_max(cur, r);
          mx = fmaxf(mx, __shfl_xor_sync(vlm::kFullMask, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(vlm::kFullMask, mx, 2));
          const float m_new = fmaxf(m[r], mx);
          corr[r] = ex2(m[r] - m_new);
          m[r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < 32; ++j) cur[j] = ex2(cur[j] - m[(j >> 1) & 1]);
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = row_max(cur, r);
          mx = fmaxf(mx, __shfl_xor_sync(vlm::kFullMask, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(vlm::kFullMask, mx, 2));
          const float m_new = fmaxf(m[r], mx * scale_log2);
          corr[r] = ex2(m[r] - m_new);
          m[r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < 32; ++j)
          cur[j] = ex2(fmaf(cur[j], scale_log2, -m[(j >> 1) & 1]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + row_sum(cur, r);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        pcur[j] = vlm::pack_bf16(cur[2 * j], cur[2 * j + 1]);
      vlm::wgmma_wait<0>();
      fence_acc(nxt);
      fence_regs<kAcc>(acc);
      fence_regs16(prev);
      if (i > 0 && lane == 0)
        vlm::mbar_arrive(&empty[(g0 + i - 1) % S::kStages]);
      // nothing in flight while O is rescaled
#pragma unroll
      for (int j = 0; j < kAcc; ++j) acc[j] *= corr[(j >> 1) & 1];
    };

    float sa[32], sb[32];
    uint32_t pa[16], pb[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) pb[j] = 0u;  // P_{-1} = 0
    qk(sa, 0);
    vlm::wgmma_wait<0>();
    fence_acc(sa);
    for (int i = 0; i < nt; i += 2) {
      step(sa, sb, pa, pb, i);
      if (i + 1 < nt) step(sb, sa, pb, pa, i + 1);
    }
    // the last tile's P V (its P in pa after an odd count of tiles)
    if (nt & 1) {
      pv(pa, nt - 1);
      vlm::wgmma_wait<0>();
    } else {
      pv(pb, nt - 1);
      vlm::wgmma_wait<0>();
    }
    fence_regs<kAcc>(acc);
    fence_regs16(pa);
    fence_regs16(pb);
    if (lane == 0) vlm::mbar_arrive(&empty[(g0 + nt - 1) % S::kStages]);
    g0 += nt;

    // O / l in bf16 into this warpgroup's own rows of the item's Q tile
    // (no longer read), in the 128-byte swizzle the O map names, then one
    // thread stores its 64-row boxes with TMA (rows past Sq and columns
    // past D dropped) and, once they are read, frees the Q tile
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(vlm::kFullMask, l[r], 1);
      l[r] += __shfl_xor_sync(vlm::kFullMask, l[r], 2);
    }
    unsigned char* o_s = qt + wg * 64 * 128;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / l[r];
      const int row = warp * 16 + g + 8 * r;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(
            o_s + (j >> 3) * kQBox + row * 128 + (((j & 7) ^ (row & 7)) * 16) +
            4 * t) = __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                           acc[4 * j + 2 * r + 1] * inv);
    }
    vlm::fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (threadIdx.x % 128 == 0) {
      for (int c = 0; c < S::kNB; ++c) {
        if (hpb_log2 == 0)
          vlm::tma_store_4d(&tm_o, o_s + c * kQBox, 64 * c, im.p0 + 64 * wg,
                            im.h0, im.b);
        else
          vlm::tma_store_5d(&tm_o, o_s + c * kQBox, 64 * c, 0, im.hg,
                            im.p0 + wg * (P / 2), im.b);
      }
      vlm::tma_store_drain();
      vlm::mbar_arrive(&q_empty[qb]);
    }
  }
}

template <int N>
int launch_small(const CUtensorMap& tq, const CUtensorMap& tk,
                 const CUtensorMap& tv, const CUtensorMap& to,
                 const int* kv_len, const int* prefix_len, dim3 grid, int H,
                 int KV, int Sq, int Sk, int hpb_log2, float scale_log2,
                 int causal, cudaStream_t stream) {
  static unsigned raised = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !(raised >> dev & 1u)) {
    err = cudaFuncSetAttribute(flash_kernel_small<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SmallShape<N>::kSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) raised |= 1u << dev;
  }
  // persistent: one block an SM (at most one an item), the items of the
  // grid (head groups, B, row tiles) walked in its order
  static int sms[32] = {0};
  if (dev < 32 && sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = dev < 32 ? sms[dev] : 132;
  const int64_t items = (int64_t)grid.x * grid.y * grid.z;
  if (items < blocks) blocks = (int)items;
  flash_kernel_small<N><<<blocks, kThreads, SmallShape<N>::kSmem, stream>>>(
      tq, tk, tv, to, kv_len, prefix_len, H, KV, Sq, Sk, hpb_log2,
      scale_log2, causal, grid.x, grid.y, grid.z);
  return (int)cudaGetLastError();
}

cuuint64_t bytes(int64_t elems) { return static_cast<cuuint64_t>(elems) * 2; }

// q or o [B, H, Sq, D] with element strides (batch, head, seq): boxes of
// `rows` rows of 64 columns, rows being positions of one head ([D, Sq, H,
// B]) when hpb = 1, else (position, head) pairs of hpb heads ([D, hpb,
// H / hpb, Sq, B])
bool rows_map(CUtensorMap* map, const void* ptr, int B, int H, int Sq, int D,
              int hpb, int64_t sb, int64_t sh, int64_t ss, int rows) {
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (hpb == 1) {
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Sq, (cuuint64_t)H,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {bytes(ss), bytes(sh), bytes(sb)};
    const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
    return vlm::tensor_map_sw128(map, bf16, ptr, 4, dims, strides, box);
  }
  const cuuint64_t dims[5] = {(cuuint64_t)D, (cuuint64_t)hpb,
                              (cuuint64_t)(H / hpb), (cuuint64_t)Sq,
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {bytes(sh), bytes(sh * hpb), bytes(ss),
                                 bytes(sb)};
  const cuuint32_t box[5] = {64, (cuuint32_t)hpb, 1, (cuuint32_t)(rows / hpb),
                             1};
  return vlm::tensor_map_sw128(map, bf16, ptr, 5, dims, strides, box);
}

}  // namespace

// q [B, H, Sq, D], k/v [B, KV, Sk, D] with element strides (batch, head,
// seq) and a contiguous head dim; o likewise, all TMA-strided. hpb (query
// heads packed into a block's rows) and the grid ((position tiles, H /
// hpb, B); for D <= 96 (H / hpb, B, position tiles)) are flash_plan's in
// ops/attention.py. Returns cudaErrorInvalidValue
// for what it does not take and cudaErrorNotSupported if a tensor map is
// refused.
extern "C" int vlm_flash_attention(
    const void* q, const void* k, const void* v, void* o, const int* kv_len,
    const int* prefix_len, int B, int H, int KV, int Sq, int Sk, int D, int hpb,
    int grid_x, int grid_y, int grid_z, int64_t q_sb, int64_t q_sh,
    int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
    int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    float scale, int causal, void* stream) {
  int hpb_log2 = 0;
  while ((1 << hpb_log2) < hpb) ++hpb_log2;
  // D <= 96: flash_kernel_small, grid (head groups, B, row tiles); else
  // flash_kernel, grid (row tiles, head groups, B)
  const bool small = D <= kSmallD;
  const int tiles = small ? grid_z : grid_x;
  const int groups = small ? grid_x : grid_y;
  const int batch = small ? grid_y : grid_z;
  if (D > 256 || D < 2 || D % 2 != 0 || KV <= 0 || H % KV != 0 || Sk < 1 ||
      Sq < 1 || hpb < 1 || hpb > 64 || (1 << hpb_log2) != hpb ||
      (H / KV) % hpb != 0 || (int64_t)tiles * (kRows / hpb) < Sq ||
      groups * hpb != H || batch != B)
    return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv, to;
  // Q loads a block's 128 rows, O stores each warpgroup's 64
  bool ok = rows_map(&tq, q, B, H, Sq, D, hpb, q_sb, q_sh, q_ss, kRows) &&
            rows_map(&to, o, B, H, Sq, D, hpb, o_sb, o_sh, o_ss, kRows / 2);
  const cuuint64_t kv_dims[4] = {(cuuint64_t)D, (cuuint64_t)Sk, (cuuint64_t)KV,
                                 (cuuint64_t)B};
  const cuuint64_t k_strides[3] = {bytes(k_ss), bytes(k_sh), bytes(k_sb)};
  const cuuint64_t v_strides[3] = {bytes(v_ss), bytes(v_sh), bytes(v_sb)};
  const cuuint32_t kv_box[4] = {64, kKeys, 1, 1};
  ok = ok && vlm::tensor_map_sw128(&tk, bf16, k, 4, kv_dims, k_strides, kv_box);
  ok = ok && vlm::tensor_map_sw128(&tv, bf16, v, 4, kv_dims, v_strides, kv_box);
  if (!ok) return (int)cudaErrorNotSupported;

  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VLM_FLASH(NB, KS)                                                  \
  return launch<NB, KS>(tq, tk, tv, to, kv_len, prefix_len,              \
                        dim3(grid_x, grid_y, grid_z), H, KV, Sq, Sk,         \
                        hpb_log2, scale_log2, causal, st)
#define VLM_SMALL(N)                                                       \
  return launch_small<N>(tq, tk, tv, to, kv_len, prefix_len,                \
                         dim3(grid_x, grid_y, grid_z), H, KV, Sq, Sk,        \
                         hpb_log2, scale_log2, causal, st)
  if (D <= 64) VLM_SMALL(64);
  if (D <= 72) VLM_SMALL(72);
  if (D <= 88) VLM_SMALL(88);
  if (D <= 96) VLM_SMALL(96);
#undef VLM_SMALL
  if (D <= 128) VLM_FLASH(2, 8);
  if (D <= 192) VLM_FLASH(3, 12);
  VLM_FLASH(4, 16);
#undef VLM_FLASH
}

extern "C" const char* vlm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
