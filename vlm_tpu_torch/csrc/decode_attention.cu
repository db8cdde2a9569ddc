// B2: decode-step attention, one query token per slot against the KV cache,
// as split-S flash-decoding on tensor cores.
//
// Replaces vlm_tpu/ops/decode_attention.py `_decode_kernel` (launched by
// `_decode_call`, public `flash_decode_attention`), in its bf16-cache and
// int8-cache forms. The cache keeps its write-friendly [B, S, KV, D] layout.
//
// What bounds it on the H100: bytes, and the latency of reaching them. Each
// step streams every live slot's K and V rows once (Gemma MQA: S x 256 x 2 B
// per tensor per slot; the int8 form half of that plus 8 bytes of scales a
// row) and does 2 MACs per cache element per query head. At the serving
// shape (32 slots x 348 rows) that is 11.4 MB, 3.4 us at 3.35 TB/s; one
// block per (slot, kv head) gave 32 blocks for 132 SMs, each walking its
// rows serially, and ran at ~80 GB/s.
//
// The design:
// - Grid (KV x head groups of 8, B, splits). The wrapper's planner
//   (`ops/decode_attention.py: split_plan`) cuts S into splits of whole
//   64-row tiles so that about two blocks an SM are in flight; each split
//   holds at least one tile and the splits cover S exactly.
// - Both products on tensor cores (mma.sync.m16n8k16, bf16 in, fp32 out),
//   the products the TPU kernel ran on its matrix unit, without its
//   block-diagonal query operand. Each of the 4 warps takes 16 rows of a
//   64-row tile. Scores S^T = K_tile . Q^T: the cache rows are the 16-row
//   operand, the block's 8 query heads N = 8, Q staged once (through shared
//   memory, while the first tile is in flight) into registers as bf16 with
//   D^-1/2 folded in (as the TPU kernel folds it into q^T).
//   P^T is rounded to bf16 (as the TPU kernel rounds P before P.V),
//   transposed in registers with movmatrix, and O^T = V^T . P^T takes V
//   through ldmatrix.trans.
// - int8 cache: tiles are staged as int8 (half the bytes) and widened to
//   bf16 in registers; every int8 value is exact in bf16. k_scale multiplies
//   the scores and v_scale the probabilities (q.(k8 s) == (q.k8) s and
//   sum p (v8 s) == sum (p s) v8), while the softmax denominator sums the
//   unscaled probabilities.
// - A two-stage cp.async ring: tile i + 1 is in flight while tile i is
//   computed. Rows at or past the block's live limit (kv_len, or in the
//   window form min(pcol + W, S)) are never loaded, so dead tiles cost no
//   bytes.
// - Each warp keeps its own running (max, sum, acc) over its rows; the
//   block merges its 4 warps in shared memory. With one split it writes the
//   output; otherwise each split writes (m, l, acc[8, D]) in fp32 to the
//   wrapper's workspace and the last block to arrive for a (slot, kv head,
//   head group) merges the splits in split order (vlm::split_k_last), so
//   the result does not depend on arrival order, in the same launch. A
//   split or warp with no live row has l = 0 and weighs 0 in the merge.
//   Both merges are vectorised over float4 with their weights formed once
//   per head: element-serial merges had cost 25 us of L2 latency.
// - What bounds it now (H100, the serving window, PERF.md): ~15 us of
//   device time, of which ~3.3 us is the cache's bytes; the rest is the
//   latency of the block's dependent phases (mask scalars, tile, the two
//   products, the block merge, the last block's merge). That is also why
//   the int8 form, with half the bytes, is no faster.
//
// Masks: kv_len; an arbitrary kv_valid [B, S]; or the continuous batcher's
// rotating window rebuilt from scalars: row r is live iff r < min(pcol, S),
// or r < min(pcol + W, S) and ((r - pcol - acol[b]) mod W) < gcnt[b]; the
// window composes with kv_len. The mod is a floor mod (jnp.mod); C's %
// truncates, hence ((x % W) + W) % W. Masked rows get probability 0, so a
// fully masked row returns 0, the TPU kernel's contract.
//
// The fp32 form (vlm_decode_attention_fp32, for models that run with
// quantization "fp32") takes an fp32 cache with the same masks, splits and
// merge at fp32 accuracy: each product as three TF32 products on the tensor
// cores (see "fp32 form" below).
//
// The fused row write (B3 inside B2; every form). Replaces, on the decode
// step, vlm_tpu/ops/kvcache.py `_write_kernel` (and, for an int8 cache,
// the quantize step in front of it, vlm_tpu/models/decoder.py `_write_kv`)
// followed by this kernel. Standalone, the write was all launch: a few KB
// against a launch's microseconds, and a host enqueue in a loop whose wall
// is many times its device time. Here the launch gives the step's new row
// of every (slot, kv head), k_new / v_new [B, 1, KV, D], and its column
// wstart[0] (uniform) or wstart[b] (scatter); a column outside [0, S)
// writes nothing and changes nothing, as in B3. Other blocks of the launch
// copy cache tiles while the row is written, so no block takes row wpos
// from the cache in this launch:
// - every block loads the column and the new rows first (the bf16 and int8
//   forms; the fp32 form's 255 registers leave no room, it loads them
//   after its first tile is issued);
// - every block whose split holds wpos stages the new row (an int8 cache:
//   quantized by vlm::quantize_row_warp, B3's arithmetic, values and
//   scale) in shared memory while its first tile is in flight, leaves row
//   wpos out of its tile copies, and puts the staged row into the tile
//   after the tile lands and before the barrier that releases it to the
//   products; the int8 score and probability scales of row wpos come from
//   the staged scale;
// - exactly one block per (slot, kv head) writes the row to the cache (and
//   its scale): head group 0 of the split that holds wpos.
// Masks, split plan and merge do not change, so the output and the caches
// are bitwise those of B3's kernel followed by this kernel.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 64;           // cache rows a step: 16 per warp
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kHeads = 8;           // query heads a block: the mma's N
constexpr int kMaxD = 256;
constexpr int kMaxDT = kMaxD / 16;  // 16-wide slices of the head dim
constexpr int kMaxSplits = 64;

enum Mode { kLen = 0, kValid = 1, kWindow = 2 };

struct Params {
  const __nv_bfloat16* q;
  void* k;  // written only at the fused write's row
  void* v;
  __nv_bfloat16* o;
  float* k_scale;
  float* v_scale;
  const int* kv_len;
  const uint8_t* kv_valid;
  const int* pcol;
  const int* acol;
  const int* gcnt;
  const __nv_bfloat16* k_new;  // the fused write (nullptr: none): [B, 1,
  const __nv_bfloat16* v_new;  // KV, D] bf16 rows, and their column
  const int* wstart;           // wstart[0] (uniform) or wstart[b]
  float* ws;      // splits > 1: [tiles, splits, kHeads * (2 + dp)]
  int* counters;  // splits > 1: one zeroed int per (slot, kv head, group)
  int H, KV, S, D, window, mode, rows_per_split, uniform;
  int64_t q_sb, q_sh, c_sb, c_ss, o_sb, o_sh;
  float scale;
};

// The fused write's column for slot b (-1 without a fused write), and the
// row a block takes from it: the column if the block's split, starting at
// s_begin, holds it, else -1
__device__ __forceinline__ int fused_col(const void* k_new, const int* wstart,
                                         int uniform, int b) {
  return k_new ? (uniform ? wstart[0] : wstart[b]) : -1;
}
__device__ __forceinline__ int fused_row(int col, int s_begin,
                                         int rows_per_split, int S) {
  return col >= s_begin && col < min(S, s_begin + rows_per_split) ? col : -1;
}

// Copy `words` 4-byte words from shared `src` to shared `dst` across the
// block (the staged new row into its tile)
__device__ __forceinline__ void copy_words(unsigned char* dst,
                                           const unsigned char* src,
                                           int words, int nthreads) {
  for (int w = threadIdx.x; w < words; w += nthreads)
    reinterpret_cast<uint32_t*>(dst)[w] = reinterpret_cast<const uint32_t*>(src)[w];
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p,
                                            bool trans) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

// The 8x8 bf16 matrix held as an mma fragment (lane: row lane/4, columns
// 2 (lane%4) and +1), transposed across the warp.
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t widen2(int8_t lo, int8_t hi) {
  return vlm::pack_bf16(static_cast<float>(lo), static_cast<float>(hi));
}

__device__ __forceinline__ void store_out(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16(x);
}
__device__ __forceinline__ void store_out(float* o, float x) { *o = x; }

// The end of every form: the block's kW warps each hold a running max and
// sum (m, l) for heads 2t and 2t + 1 of its 8 and the O^T accumulators acc
// (lane (g, t): dims 16 mt + g and + 8 of heads 2t and 2t + 1). Merge the
// warps in shared memory; with one split write the output (ob: the slot's
// output, hq0: the block's first query head, nh heads); otherwise write
// this split's (m, l, acc) to ws and let the last block of the (slot, kv
// head, group) merge the splits in split order (vlm::split_k_last).
// The head dim of acc[mt][e] is mt * 16 + g + 8 (e >> 1) (`dim_of`: the
// form for few heads permutes it).
struct PlainDims {
  __device__ __forceinline__ int operator()(int mt, int hi, int g) const {
    return mt * 16 + g + 8 * hi;
  }
};

template <int kW, int kDT, typename OutT, typename DimOf = PlainDims,
          bool kBase2 = false>
__device__ __forceinline__ void finish(unsigned char* smem, const float (&m)[2],
                                       const float (&l)[2],
                                       const float (&acc)[kDT][4], int D,
                                       int nh, OutT* ob, int64_t o_sh,
                                       int hq0, float* ws, int* counters,
                                       DimOf dim_of = DimOf()) {
  // the maxima are natural logs, or base 2 (kBase2)
  auto weight = [](float x) { return kBase2 ? exp2f(x) : expf(x); };
  constexpr int kNT = kW * 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int dp = (D + 15) & ~15;
  // merge the kW warps: [warp][head] max and sum, [warp][head][dp] acc
  __syncthreads();
  float* red_m = reinterpret_cast<float*>(smem);  // then each warp's weight
  float* red_l = red_m + kW * kHeads;
  float* red_acc = red_l + kW * kHeads;
  float* blk_m = red_acc + kW * kHeads * dp;  // [8] the block's max
  float* blk_l = blk_m + kHeads;                  // [8] the block's sum
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      red_m[warp * kHeads + 2 * t + j] = m[j];
      red_l[warp * kHeads + 2 * t + j] = l[j];
    }
  }
#pragma unroll
  for (int mt = 0; mt < kDT; ++mt) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int d = dim_of(mt, hi, g);
      if (d >= dp) continue;
      float* base = red_acc + warp * kHeads * dp + d;
      base[(2 * t) * dp] = acc[mt][2 * hi];
      base[(2 * t + 1) * dp] = acc[mt][2 * hi + 1];
    }
  }
  __syncthreads();
  if (threadIdx.x < kHeads) {
    const int h = threadIdx.x;
    float mx = vlm::kNegInf;
#pragma unroll
    for (int w = 0; w < kW; ++w) mx = fmaxf(mx, red_m[w * kHeads + h]);
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const float lw = red_l[w * kHeads + h];
      const float wt = lw > 0.f ? weight(red_m[w * kHeads + h] - mx) : 0.f;
      red_m[w * kHeads + h] = wt;
      lsum += lw * wt;
    }
    blk_m[h] = mx;
    blk_l[h] = lsum;
  }
  __syncthreads();

  const int splits = gridDim.z;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int part = kHeads * (2 + dp);  // m[8], l[8], acc[8, dp]
  const int dq = dp / 4;               // float4 groups a head
  constexpr int kGroups = kHeads * kMaxD / 4 / kNT;
  auto store = [&](int h, int d, float4 a, float scale) {
    const float x[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < D) store_out(ob + (hq0 + h) * o_sh + d + e, x[e] * scale);
  };
  float* pw = ws + (static_cast<int64_t>(tile) * splits + blockIdx.z) * part;
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    const int i = threadIdx.x + q * kNT;
    if (i >= kHeads * dq) break;
    const int h = i / dq, d = (i - h * dq) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const float wt = red_m[w * kHeads + h];
      const float4 v = *reinterpret_cast<const float4*>(red_acc + (w * kHeads + h) * dp + d);
      a.x += wt * v.x;
      a.y += wt * v.y;
      a.z += wt * v.z;
      a.w += wt * v.w;
    }
    if (splits > 1)
      *reinterpret_cast<float4*>(pw + 2 * kHeads + h * dp + d) = a;
    else if (h < nh)
      store(h, d, a, 1.f / fmaxf(blk_l[h], 1e-30f));
  }
  if (splits == 1) return;
  if (threadIdx.x < kHeads) {
    pw[threadIdx.x] = blk_m[threadIdx.x];
    pw[kHeads + threadIdx.x] = blk_l[threadIdx.x];
  }
  if (!vlm::split_k_last(counters)) return;

  // the last block of this (slot, kv head, group): merge in split order.
  // Each split's weight exp(m_z - max) (0 for a split with no live row) is
  // formed once per head in shared memory; then each thread sums its
  // elements' partials, split by split, with its loads all in flight.
  const float* pt = ws + static_cast<int64_t>(tile) * splits * part;
  float* wz = reinterpret_cast<float*>(smem);  // [splits, 8]: m_z, then w_z
  float* lz = wz + splits * kHeads;            // [splits, 8]
  float* inv = lz + splits * kHeads;           // [8]: 1 / sum of l
  for (int i = threadIdx.x; i < splits * kHeads; i += kNT) {
    const int z = i / kHeads, h = i - z * kHeads;
    wz[i] = __ldcg(pt + z * part + h);
    lz[i] = __ldcg(pt + z * part + kHeads + h);
  }
  __syncthreads();
  if (threadIdx.x < kHeads) {
    const int h = threadIdx.x;
    float mx = vlm::kNegInf;
    for (int z = 0; z < splits; ++z) mx = fmaxf(mx, wz[z * kHeads + h]);
    float lsum = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float lw = lz[z * kHeads + h];
      const float wt = lw > 0.f ? weight(wz[z * kHeads + h] - mx) : 0.f;
      wz[z * kHeads + h] = wt;
      lsum += lw * wt;
    }
    inv[h] = 1.f / fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  int hs[kGroups], ds[kGroups];
  float4 a[kGroups];
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    const int i = threadIdx.x + q * kNT;
    hs[q] = i < nh * dq ? i / dq : -1;
    ds[q] = hs[q] < 0 ? 0 : (i - hs[q] * dq) * 4;
    a[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll 2
  for (int z = 0; z < splits; ++z) {
    const float* pz = pt + z * part + 2 * kHeads;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      if (hs[q] < 0) continue;
      const float wt = wz[z * kHeads + hs[q]];
      const float4 v = __ldcg(reinterpret_cast<const float4*>(pz + hs[q] * dp + ds[q]));
      a[q].x += wt * v.x;
      a[q].y += wt * v.y;
      a[q].z += wt * v.z;
      a[q].w += wt * v.w;
    }
  }
#pragma unroll
  for (int q = 0; q < kGroups; ++q)
    if (hs[q] >= 0) store(hs[q], ds[q], a[q], inv[hs[q]]);
}

// T: __nv_bfloat16 (bf16 cache) or int8_t (int8 cache with scales)
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const Params p) {
  constexpr bool kInt8 = sizeof(T) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = p.H / p.KV;
  const int groups = (G + kHeads - 1) / kHeads;
  const int kvh = blockIdx.x / groups;
  const int h0 = (blockIdx.x % groups) * kHeads;  // within the kv head
  const int nh = min(kHeads, G - h0);
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // the fused write's column and new rows, loaded first by every block:
  // what they feed waits on no other load. bf16: thread t holds word t of
  // the K and of the V row; int8: warp 0 the K row, warp 1 the V row, as
  // vlm::quantize_row_warp takes them
  const int wcol = fused_col(p.k_new, p.wstart, p.uniform, b);
  const int64_t new_off = (static_cast<int64_t>(b) * p.KV + kvh) * p.D;
  uint32_t new_words[2] = {0u, 0u};
  float new_vals[vlm::kQuantPerLane];
  if (p.k_new) {
    if constexpr (kInt8) {
      if (warp < 2)
        vlm::load_row_warp((warp ? p.v_new : p.k_new) + new_off, p.D, lane,
                           new_vals);
    } else if (threadIdx.x < p.D / 2) {
      new_words[0] = __ldg(reinterpret_cast<const uint32_t*>(p.k_new + new_off) + threadIdx.x);
      new_words[1] = __ldg(reinterpret_cast<const uint32_t*>(p.v_new + new_off) + threadIdx.x);
    }
  }
  const int dp = (p.D + 15) & ~15;
  const int ndt = dp / 16;
  const int dbytes = p.D * static_cast<int>(sizeof(T));
  const int pbytes = dp * static_cast<int>(sizeof(T));
  // row pitch: 16 B past the padded row, so ldmatrix's 8 row addresses
  // fall in 8 distinct 16-byte bank groups
  const int pitch = pbytes + 16;
  const int tile_bytes = kTile * pitch;
  const int bufs = min(2, p.rows_per_split / kTile);

  const int kvl = p.kv_len ? p.kv_len[b] : p.S;
  int limit = min(p.S, kvl);
  int pc = 0, ac = 0, gc = 0;
  if (p.mode == kWindow) {
    pc = *p.pcol;
    ac = p.acol[b];
    gc = p.gcnt[b];
    limit = min(limit, pc + p.window);
  }
  const int s_begin = blockIdx.z * p.rows_per_split;
  const int s_end = min(limit, s_begin + p.rows_per_split);
  const int nt = s_end > s_begin ? (s_end - s_begin + kTile - 1) / kTile : 0;
  // the fused write's row, if this split holds it (else -1), and whether
  // this block is the one that writes it to the cache
  const int wpos = fused_row(wcol, s_begin, p.rows_per_split, p.S);
  const bool writer = wpos >= 0 && blockIdx.x % groups == 0;

  // zero the pad columns [D, dp) of every staged row once: the copies
  // never write them, and 0 x garbage could be NaN in the products
  const int pad_words = (pbytes - dbytes) / 4;
  for (int i = threadIdx.x; i < bufs * 2 * kTile * pad_words; i += kThreads)
    *reinterpret_cast<uint32_t*>(smem + (i / pad_words) * pitch + dbytes +
                                 (i % pad_words) * 4) = 0;

  const int64_t row_bytes = p.c_ss * static_cast<int64_t>(sizeof(T));
  const unsigned char* kbase = static_cast<const unsigned char*>(p.k) +
      (b * p.c_sb + static_cast<int64_t>(kvh) * p.D) * sizeof(T);
  const unsigned char* vbase = static_cast<const unsigned char*>(p.v) +
      (b * p.c_sb + static_cast<int64_t>(kvh) * p.D) * sizeof(T);
  const bool vec16 = dbytes % 16 == 0 && row_bytes % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(kbase) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(vbase) % 16 == 0;

  // rows [r0, r0 + 64) of K and V into buffer j; rows at or past s_end are
  // zero-filled without being read, and the fused write's row is left out
  // (staged from k_new / v_new instead). Each thread walks its chunks by
  // increments: a division per chunk cost more than the copies.
  const int width = vec16 ? 16 : 4;
  const int chunks = dbytes / width;  // a row's copies
  const int r_first = threadIdx.x / chunks;
  const int c_first = threadIdx.x - r_first * chunks;
  const int r_step = kThreads / chunks, c_step = kThreads - r_step * chunks;
  auto load = [&](int j, int r0) {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const unsigned char* base = which ? vbase : kbase;
      unsigned char* dst = smem + (2 * j + which) * tile_bytes;
      int r = r_first, c = c_first;
      while (r < kTile) {
        const bool ok = r0 + r < s_end;
        const unsigned char* src = ok ? base + (r0 + r) * row_bytes + c * width : base;
        if (ok && r0 + r == wpos) {
        } else if (vec16) vlm::cp_async16(dst + r * pitch + c * 16, src, ok);
        else vlm::cp_async_small<4>(dst + r * pitch + c * 4, src, ok);
        r += r_step;
        c += c_step;
        if (c >= chunks) {
          c -= chunks;
          ++r;
        }
      }
    }
  };

  auto live = [&](int r) {
    if (r >= s_end) return false;
    if (p.mode == kWindow) {
      const int age = (((r - pc - ac) % p.window) + p.window) % p.window;
      return r < pc || age < gc;
    }
    if (p.mode == kValid) return p.kv_valid[static_cast<int64_t>(b) * p.S + r] != 0;
    return true;
  };

  // this warp's running state for heads 2t, 2t + 1; acc is O^T [d, head]
  float m[2] = {vlm::kNegInf, vlm::kNegInf}, l[2] = {0.f, 0.f};
  float acc[kMaxDT][4];
#pragma unroll
  for (int i = 0; i < kMaxDT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  if (nt > 0) {
    load(0, s_begin);
    vlm::cp_async_commit();
  }

  // the block's 8 query heads into shared memory as bf16 pairs, zero past
  // nh heads and past D: one round of independent loads while tile 0 is in
  // flight (the wrapper passes q with even strides and a 4-byte base)
  unsigned char* q_sm = smem + bufs * 2 * tile_bytes;
  const int qpitch = dp * 2 + 16;
  const int qwords = dp / 2;
  const uint32_t* qg = reinterpret_cast<const uint32_t*>(
      p.q + b * p.q_sb + static_cast<int64_t>(kvh * G + h0) * p.q_sh);
#pragma unroll
  for (int k = 0; k < kHeads * kMaxD / 2 / kThreads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < kHeads * qwords) {
      const int h = i / qwords, w = i - h * qwords;
      uint32_t x = 0;
      if (h < nh && 2 * w < p.D) x = __ldg(qg + h * (p.q_sh / 2) + w);
      *reinterpret_cast<uint32_t*>(q_sm + h * qpitch + 4 * w) = x;
    }
  }
  // the fused write: the new K and V rows staged after Q (rbytes each, then
  // the int8 form's two scales), written to the cache by the writer block
  const int rbytes = (dbytes + 15) & ~15;
  unsigned char* new_sm = q_sm + kHeads * qpitch;
  const float* new_scale = reinterpret_cast<const float*>(new_sm + 2 * rbytes);
  if (wpos >= 0) {
    const int64_t off = b * p.c_sb + static_cast<int64_t>(wpos) * p.c_ss +
                        static_cast<int64_t>(kvh) * p.D;
    if constexpr (kInt8) {
      // warp 0 quantizes K, warp 1 V
      if (warp < 2) {
        int8_t qv[vlm::kQuantPerLane];
        const float sc = vlm::quantize_row_warp(new_vals, qv);
        int8_t* cache = static_cast<int8_t*>(warp ? p.v : p.k) + off;
        unsigned char* row = new_sm + warp * rbytes;
#pragma unroll
        for (int i = 0; i < vlm::kQuantPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < p.D) {
            row[d] = static_cast<unsigned char>(qv[i]);
            if (writer) cache[d] = qv[i];
          }
        }
        if (lane == 0) {
          reinterpret_cast<float*>(new_sm + 2 * rbytes)[warp] = sc;
          if (writer)
            (warp ? p.v_scale : p.k_scale)[(static_cast<int64_t>(b) * p.S + wpos) * p.KV + kvh] = sc;
        }
      }
    } else if (threadIdx.x < p.D / 2) {  // bf16 pairs a row
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        reinterpret_cast<uint32_t*>(new_sm + which * rbytes)[threadIdx.x] = new_words[which];
        if (writer)
          reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(which ? p.v : p.k) + off)[threadIdx.x] =
              new_words[which];
      }
    }
  }
  __syncthreads();
  // Q^T as the B operand: lane (g, t) holds head h0 + g, dims 2t, 2t + 1
  // (b0) and 2t + 8, 2t + 9 (b1) of each 16-wide slice, times D^-1/2
  uint32_t qf[kMaxDT][2];
#pragma unroll
  for (int kk = 0; kk < kMaxDT; ++kk)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      qf[kk][hf] = 0;
      if (kk < ndt) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            q_sm + g * qpitch + 2 * (kk * 16 + 2 * t + 8 * hf)));
        qf[kk][hf] = vlm::pack_bf16(x.x * p.scale, x.y * p.scale);
      }
    }

  for (int i = 0; i < nt; ++i) {
    if (i + 1 < nt) {
      load((i + 1) & 1, s_begin + (i + 1) * kTile);
      vlm::cp_async_commit();
      vlm::cp_async_wait<1>();
    } else {
      vlm::cp_async_wait<0>();
    }
    {  // the fused write's row into the tile that holds it
      const int r0 = s_begin + i * kTile;
      if (wpos >= r0 && wpos < min(r0 + kTile, s_end)) {
        const int words = dbytes / 4;
        unsigned char* row = smem + (i & 1) * 2 * tile_bytes + (wpos - r0) * pitch;
        copy_words(row, new_sm, words, kThreads);
        copy_words(row + tile_bytes, new_sm + rbytes, words, kThreads);
      }
    }
    __syncthreads();  // tile i landed for every warp
    const unsigned char* kt = smem + (i & 1) * 2 * tile_bytes;
    const unsigned char* vt = kt + tile_bytes;
    const int rw = warp * 16;

    // scores S^T [16 rows, 8 heads]: lane holds rows g, g + 8 x heads 2t, 2t+1
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kMaxDT; ++kk) {
      if (kk >= ndt) break;
      uint32_t a[4];
      if constexpr (kInt8) {
        const unsigned char* kr = kt + (rw + g) * pitch + kk * 16 + 2 * t;
        const char2 c0 = *reinterpret_cast<const char2*>(kr);
        const char2 c1 = *reinterpret_cast<const char2*>(kr + 8 * pitch);
        const char2 c2 = *reinterpret_cast<const char2*>(kr + 8);
        const char2 c3 = *reinterpret_cast<const char2*>(kr + 8 * pitch + 8);
        a[0] = widen2(c0.x, c0.y);
        a[1] = widen2(c1.x, c1.y);
        a[2] = widen2(c2.x, c2.y);
        a[3] = widen2(c3.x, c3.y);
      } else {
        ldmatrix_x4(a, kt + (rw + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch +
                           (kk * 16 + (lane >> 4) * 8) * 2, false);
      }
      vlm::mma16816(s, a, qf[kk][0], qf[kk][1]);
    }

    const int r_lo = s_begin + i * kTile + rw + g;
    const int r_hi = r_lo + 8;
    const bool lv0 = live(r_lo), lv1 = live(r_hi);
    if constexpr (kInt8) {
      const float k0 = !lv0 ? 0.f : r_lo == wpos ? new_scale[0]
                     : p.k_scale[(static_cast<int64_t>(b) * p.S + r_lo) * p.KV + kvh];
      const float k1 = !lv1 ? 0.f : r_hi == wpos ? new_scale[0]
                     : p.k_scale[(static_cast<int64_t>(b) * p.S + r_hi) * p.KV + kvh];
      s[0] *= k0;
      s[1] *= k0;
      s[2] *= k1;
      s[3] *= k1;
    }
    if (!lv0) s[0] = s[1] = vlm::kNegInf;
    if (!lv1) s[2] = s[3] = vlm::kNegInf;
    // per-head max and sum over the 16 rows: the lanes that share t
    float mx0 = fmaxf(s[0], s[2]), mx1 = fmaxf(s[1], s[3]);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(vlm::kFullMask, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(vlm::kFullMask, mx1, o));
    }
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float c0 = expf(m[0] - mn0), c1 = expf(m[1] - mn1);
    float p0 = lv0 ? expf(s[0] - mn0) : 0.f;
    float p1 = lv0 ? expf(s[1] - mn1) : 0.f;
    float p2 = lv1 ? expf(s[2] - mn0) : 0.f;
    float p3 = lv1 ? expf(s[3] - mn1) : 0.f;
    float sum0 = p0 + p2, sum1 = p1 + p3;
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      sum0 += __shfl_xor_sync(vlm::kFullMask, sum0, o);
      sum1 += __shfl_xor_sync(vlm::kFullMask, sum1, o);
    }
    l[0] = l[0] * c0 + sum0;
    l[1] = l[1] * c1 + sum1;
    m[0] = mn0;
    m[1] = mn1;
    if constexpr (kInt8) {
      const float v0 = !lv0 ? 0.f : r_lo == wpos ? new_scale[1]
                     : p.v_scale[(static_cast<int64_t>(b) * p.S + r_lo) * p.KV + kvh];
      const float v1 = !lv1 ? 0.f : r_hi == wpos ? new_scale[1]
                     : p.v_scale[(static_cast<int64_t>(b) * p.S + r_hi) * p.KV + kvh];
      p0 *= v0;
      p1 *= v0;
      p2 *= v1;
      p3 *= v1;
    }
    // P^T as the B operand [rows, heads]: lane (g, t) needs rows 2t, 2t + 1
    // of head g; it holds rows g, g + 8 of heads 2t, 2t + 1: a transpose
    const uint32_t pb0 = transpose8x8(vlm::pack_bf16(p0, p1));
    const uint32_t pb1 = transpose8x8(vlm::pack_bf16(p2, p3));
#pragma unroll
    for (int mt = 0; mt < kMaxDT; ++mt) {
      if (mt >= ndt) break;
      acc[mt][0] *= c0;
      acc[mt][1] *= c1;
      acc[mt][2] *= c0;
      acc[mt][3] *= c1;
      uint32_t a[4];
      if constexpr (kInt8) {
        const int8_t* vr = reinterpret_cast<const int8_t*>(vt) +
                           (rw + 2 * t) * pitch + mt * 16 + g;
        a[0] = widen2(vr[0], vr[pitch]);
        a[1] = widen2(vr[8], vr[pitch + 8]);
        a[2] = widen2(vr[8 * pitch], vr[9 * pitch]);
        a[3] = widen2(vr[8 * pitch + 8], vr[9 * pitch + 8]);
      } else {
        ldmatrix_x4(a, vt + (rw + (lane & 7) + (lane >> 4) * 8) * pitch +
                           (mt * 16 + ((lane >> 3) & 1) * 8) * 2, true);
      }
      vlm::mma16816(acc[mt], a, pb0, pb1);
    }
    __syncthreads();  // every warp is done with this buffer
  }

  finish<kWarps, kMaxDT>(smem, m, l, acc, p.D, nh, p.o + b * p.o_sb,
                         p.o_sh, kvh * G + h0, p.ws, p.counters);
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  const int G = p.H / p.KV;
  const int groups = (G + kHeads - 1) / kHeads;
  const int dp = (p.D + 15) & ~15;
  const int pitch = dp * static_cast<int>(sizeof(T)) + 16;
  const int bufs = min(2, p.rows_per_split / kTile);
  // the ring, then Q, then the fused write's staged rows and scales
  const size_t rbytes = (p.D * sizeof(T) + 15) & ~static_cast<size_t>(15);
  const size_t tiles = static_cast<size_t>(bufs) * 2 * kTile * pitch +
                       kHeads * (2 * dp + 16) + (p.k_new ? 2 * rbytes + 16 : 0);
  const size_t red = sizeof(float) * (kWarps * kHeads * (2 + dp) + 2 * kHeads);
  // the last block's merge keeps 2 x 8 floats a split (kMaxSplits) and 8
  const size_t merge = sizeof(float) * (2 * kMaxSplits + 1) * kHeads;
  size_t smem = tiles > red ? tiles : red;
  smem = smem > merge ? smem : merge;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int splits = (max(p.S, 1) + p.rows_per_split - 1) / p.rows_per_split;
  dim3 grid(p.KV * groups, B, splits);
  decode_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---- the form for fewer than 8 query heads a KV head (G < 8) ----
//
// MHA decoders (Vicuna, OPT: G = 1) and a model=2 rank of Gemma (4 query
// heads over its KV head) read a (slot, KV head)'s cache for 1-4 heads, so
// a block's time is its bytes and the latency of reaching them, not its
// products. decode_kernel above, built for Gemma's 8 heads, spent it
// elsewhere at G = 1 (chip runs of testing/attention_breakdown.py): one
// 64-row tile in flight a block; the int8 cache widened a byte at a time
// (258 I2F a warp and tile: the conversion pipe alone ~44 us of LLaVA's
// 16-slot window, whose bytes take 27) and its scales loaded from device
// memory inside the loop, after the products; registers for D = 256 at
// every D (156-168: three blocks an SM). This form:
// - one block a (HPB KV heads, slot, split) for all their G heads (the
//   mma's N = 8: column h G + j is query head j of the block's KV head h,
//   zero in the warps of other KV heads); HPB = 1, or 2 for an int8 cache
//   at G = 1 on grids of two rounds (BLIP-2's 64 slots: a block's set-up
//   and first wait serve two heads, 256 contiguous bytes a row; the host's
//   few_heads), the 4 warps then 2 a head, 32 rows of each tile a warp;
//   accumulators and query registers sized by the head dim (NDT 16-wide
//   slices; four blocks an SM up to D = 128);
// - a ring of `stages` (1 or 2) 64-row tiles, each stage holding the
//   tile's K and V rows and, int8, its 64 k- and v-scales (cp.async, the
//   scales 4 bytes a row), so no global load waits inside the loop; the
//   second stage only where it costs no block an SM (few_plan in
//   ops/decode_attention.py, from vlm_decode_few_blocks: an SM's blocks,
//   not a block's depth, kept its bytes in flight on the card; deeper
//   rings were slower);
// - the mma's row index m of a warp's 16 rows is cache row row_of(m): lane
//   t's P^T fragment then holds rows 4t .. 4t + 3, so V^T's A fragment is
//   four whole rows; K and V rows sit in shared memory as 16-byte chunks
//   XOR-swizzled by the row (swz_bf16 / swz_int8: every ldmatrix and
//   16-byte load conflict-free);
// - int8: a lane reads 16 bytes of a row at once. K's are 64 dims of four
//   16-deep steps (the query's registers permuted to match: the products'
//   sums are reordered, not changed); V's are its 16 dims of a row, two of
//   each of 8 output slices (the output's dims permuted back in finish).
//   Each byte becomes fp32 exactly (widen4: byte permute into the mantissa
//   of 2^23, one subtraction), two of them bf16 in one cvt: no I2F.
// The softmax runs in base 2 (the scores times log2 e after the product;
// finish merges base-2 maxima). The TPU kernel's roundings stay: q D^-1/2
// in bf16, P in bf16 before P.V, v_scale folded into the probabilities,
// the denominator over the unscaled ones; masks, the fused write and the
// split merge are decode_kernel's.

constexpr int kFewMaxStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the exponential unit (ex2.approx: 2 ulp; -inf gives 0)
__device__ __forceinline__ float fast_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the cache row (within a warp's 16) of the mma's row index m
__device__ __forceinline__ int row_of(int m) {
  return ((m & 7) >> 1) * 4 + (m & 1) + ((m >> 3) << 1);
}
// 16-byte chunk swizzles of a row r (r & 15 within a warp's rows): for
// ldmatrix (bf16: the 8 rows of an 8x8 matrix are row_of(0..7) or
// row_of(8..15)) and for the int8 form's 16-byte loads
__device__ __forceinline__ int swz_bf16(int r) {
  return (r & 1) | (((r >> 2) & 3) << 1);
}
__device__ __forceinline__ int swz_int8(int r) {
  return ((r & 1) << 2) ^ (((r >> 2) & 3) << 1);
}

// four int8 values (one word) as fp32, exactly: byte x + 128 (the xor)
// into the low mantissa bits of 2^23, minus 2^23 + 128
__device__ __forceinline__ void widen4(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// the padded head dim, 16 NDT: bf16 64, 128 or 256 (rows of whole
// 128-byte lines), int8 128 or 256 (a lane's 16 bytes of a V row cover 8
// slices of 16)
__host__ __device__ inline int few_dp(int D, bool int8) {
  return D <= 64 && !int8 ? 64 : D <= 128 ? 128 : 256;
}

// shared memory of the form with hpb KV heads a block: the ring, then the
// fused write's staged rows and scales; at least the merge's (finish)
__host__ inline size_t few_smem(int D, bool int8, int stages, bool fused,
                                int hpb) {
  const size_t elem = int8 ? 1 : 2;
  const size_t pitch = hpb * few_dp(D, int8) * elem;
  const size_t stage = 2 * kTile * pitch + (int8 ? 2 * kTile * hpb * 4 : 0);
  const size_t rbytes = (D * elem + 15) & ~static_cast<size_t>(15);
  const size_t tiles = stages * stage + (fused ? 2 * hpb * rbytes + 16 : 0);
  const size_t red = sizeof(float) *
      (kWarps * kHeads * (2 + ((D + 15) & ~15)) + 2 * kHeads);
  const size_t merge = sizeof(float) * (2 * kMaxSplits + 1) * kHeads;
  size_t smem = tiles > red ? tiles : red;
  return smem > merge ? smem : merge;
}

// the int8 form's output dims: slice mt, dim g + 8 hi of the O^T
// accumulators is byte 2 (mt % 8) + hi of lane g's 16 of each V row
struct Int8Dims {
  __device__ __forceinline__ int operator()(int mt, int hi, int g) const {
    return 128 * (mt >> 3) + 16 * g + 2 * (mt & 7) + hi;
  }
};

// four blocks an SM up to D = 128 (NDT 8; 128 registers), three above
template <typename T, int NDT, int HPB>
__global__ void __launch_bounds__(kThreads, NDT <= 8 ? 4 : 3)
decode_kernel_few(const Params p, int stages) {
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr int kWPH = kWarps / HPB;      // warps a KV head
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = p.H / p.KV;  // HPB G <= 8: every head in the mma's N
  const int kvh0 = blockIdx.x * HPB;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int hw = warp / kWPH;  // this warp's KV head of the block's HPB
  // the fused write's column and new rows first, as decode_kernel: bf16,
  // thread x holds word x % (D / 2) of head x / (D / 2)'s K and V rows;
  // int8, warp w head w / 2's K (w even) or V row
  const int wcol = fused_col(p.k_new, p.wstart, p.uniform, b);
  const int64_t new_off = (static_cast<int64_t>(b) * p.KV + kvh0) * p.D;
  uint32_t new_words[2] = {0u, 0u};
  float new_vals[vlm::kQuantPerLane];
  if (p.k_new) {
    if constexpr (kInt8) {
      if (warp < 2 * HPB)
        vlm::load_row_warp((warp & 1 ? p.v_new : p.k_new) + new_off +
                               (warp >> 1) * p.D, p.D, lane, new_vals);
    } else if (threadIdx.x < HPB * p.D / 2) {
      new_words[0] = __ldg(reinterpret_cast<const uint32_t*>(p.k_new + new_off) + threadIdx.x);
      new_words[1] = __ldg(reinterpret_cast<const uint32_t*>(p.v_new + new_off) + threadIdx.x);
    }
  }
  const int dp = few_dp(p.D, kInt8);
  const int dbytes = p.D * static_cast<int>(sizeof(T));
  const int hbytes = dp * static_cast<int>(sizeof(T));  // 128-byte lines
  const int pitch = HPB * hbytes;  // a row: the block's HPB heads
  const int tile_bytes = kTile * pitch;
  const int stage_bytes = 2 * tile_bytes + (kInt8 ? 2 * kTile * HPB * 4 : 0);

  const int kvl = p.kv_len ? p.kv_len[b] : p.S;
  int limit = min(p.S, kvl);
  int pc = 0, ac = 0, gc = 0;
  if (p.mode == kWindow) {
    pc = *p.pcol;
    ac = p.acol[b];
    gc = p.gcnt[b];
    limit = min(limit, pc + p.window);
  }
  const int s_begin = blockIdx.z * p.rows_per_split;
  const int s_end = min(limit, s_begin + p.rows_per_split);
  const int nt = s_end > s_begin ? (s_end - s_begin + kTile - 1) / kTile : 0;
  const int wpos = fused_row(wcol, s_begin, p.rows_per_split, p.S);

  const int64_t row_bytes = p.c_ss * static_cast<int64_t>(sizeof(T));
  const unsigned char* kbase = static_cast<const unsigned char*>(p.k) +
      (b * p.c_sb + static_cast<int64_t>(kvh0) * p.D) * sizeof(T);
  const unsigned char* vbase = static_cast<const unsigned char*>(p.v) +
      (b * p.c_sb + static_cast<int64_t>(kvh0) * p.D) * sizeof(T);
  const bool vec16 = dbytes % 16 == 0 && row_bytes % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(kbase) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(vbase) % 16 == 0;
  const int64_t sc_off = static_cast<int64_t>(b) * p.S * p.KV + kvh0;
  auto swz = [](int r) { return kInt8 ? swz_int8(r) : swz_bf16(r); };
  // byte offset in a tile of byte x of head h's part of row r
  auto at = [&](int r, int h, int x) {
    return r * pitch + h * hbytes + ((((x >> 4) ^ swz(r & 15))) << 4) +
           (x & 15);
  };
  // zero the pad chunks [D, dp) of every staged head row once: the copies
  // never write them, and 0 x garbage could be NaN in the products
  const int pad_from = dbytes / 16, pad = hbytes / 16 - pad_from;
  if (pad > 0) {
    for (int i = threadIdx.x; i < stages * 2 * kTile * HPB * pad;
         i += kThreads) {
      const int row = i / pad;  // (stage, K or V, row, head) in order
      const int h = row % HPB, r = (row / HPB) % kTile;
      *reinterpret_cast<uint4*>(
          smem + (row / (2 * kTile * HPB)) * stage_bytes +
          ((row / (kTile * HPB)) & 1) * tile_bytes +
          at(r, h, 16 * (pad_from + i % pad))) = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
  }

  // tile i (rows r0 + [0, 64) of the HPB heads) into stage j: K, V and
  // (int8) the rows' scales; rows at or past s_end are zero-filled
  // without being read, and the fused write's row is left out (staged)
  const int width = vec16 ? 16 : 4;
  const int cph = dbytes / width;  // a head's copies a row
  const int chunks = HPB * cph;
  const int r_first = threadIdx.x / chunks;
  const int c_first = threadIdx.x - r_first * chunks;
  const int r_step = kThreads / chunks, c_step = kThreads - r_step * chunks;
  auto load = [&](int j, int r0) {
    unsigned char* st = smem + j * stage_bytes;
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const unsigned char* base = which ? vbase : kbase;
      unsigned char* dst = st + which * tile_bytes;
      int r = r_first, c = c_first;
      while (r < kTile) {
        const int row = r0 + r;
        const bool ok = row < s_end;
        if (row != wpos) {
          const unsigned char* src = ok ? base + row * row_bytes + c * width
                                        : base;
          const int h = HPB > 1 && c >= cph;  // HPB <= 2
          const int x = (c - h * cph) * width;
          if (vec16) vlm::cp_async16(dst + at(r, h, x), src, ok);
          else vlm::cp_async_small<4>(dst + at(r, h, x), src, ok);
        }
        r += r_step;
        c += c_step;
        if (c >= chunks) {
          c -= chunks;
          ++r;
        }
      }
    }
    if constexpr (kInt8) {  // thread x: row x % 64's k (x < 64) or v scales
      const int r = threadIdx.x % kTile;
      const int row = r0 + r;
      const float* sc = threadIdx.x < kTile ? p.k_scale : p.v_scale;
      unsigned char* dst = st + 2 * tile_bytes +
                           ((threadIdx.x / kTile) * kTile + r) * HPB * 4;
      const float* src = row < s_end ? sc + sc_off +
                                           static_cast<int64_t>(row) * p.KV
                                     : sc;
      if (row != wpos) vlm::cp_async_small<4 * HPB>(dst, src, row < s_end);
    }
  };

  auto live = [&](int r) {
    if (r >= s_end) return false;
    if (p.mode == kWindow) {
      const int age = (((r - pc - ac) % p.window) + p.window) % p.window;
      return r < pc || age < gc;
    }
    if (p.mode == kValid) return p.kv_valid[static_cast<int64_t>(b) * p.S + r] != 0;
    return true;
  };

  // the first stages - 1 tiles in flight (a group each, empty or not)
  for (int j = 0; j < stages - 1; ++j) {
    if (j < nt) load(j, s_begin + j * kTile);
    vlm::cp_async_commit();
  }

  // Q^T as the B operand, times D^-1/2, in bf16: column g is query head j
  // = g % G of the block's KV head g / G, zero unless that is this warp's
  // (and past HPB G); the dims of step kk that lane t's K fragment holds
  // (bf16: 16 kk + 2t, +1, +8, +9; int8: 64 c + 16 t + 4 j + 0..3 for
  // step kk = 4 c + j)
  uint32_t qf[NDT][2];
  {
    const bool mine = g < HPB * G && g / G == hw;
    const __nv_bfloat16* qh = p.q + b * p.q_sb +
                              static_cast<int64_t>(kvh0 * G + g) * p.q_sh;
#pragma unroll
    for (int kk = 0; kk < NDT; ++kk)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int d = kInt8 ? 64 * (kk >> 2) + 16 * t + 4 * (kk & 3) + 2 * hf
                            : 16 * kk + 2 * t + 8 * hf;
        float2 x = make_float2(0.f, 0.f);
        if (mine && d < p.D)
          x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qh + d));
        qf[kk][hf] = vlm::pack_bf16(x.x * p.scale, x.y * p.scale);
      }
  }
  // the fused write: the new K and V rows of the HPB heads staged past the
  // ring ([head][K, V] rows of rbytes, then [head][K, V] scales), written
  // to the cache by this block (the only one of its slot and heads whose
  // split holds the column)
  const int rbytes = (dbytes + 15) & ~15;
  unsigned char* new_sm = smem + stages * stage_bytes;
  const float* new_scale = reinterpret_cast<const float*>(new_sm + 2 * HPB * rbytes);
  if (wpos >= 0) {
    const int64_t off = b * p.c_sb + static_cast<int64_t>(wpos) * p.c_ss +
                        static_cast<int64_t>(kvh0) * p.D;
    if constexpr (kInt8) {
      if (warp < 2 * HPB) {  // warp 2 h + which
        int8_t qv[vlm::kQuantPerLane];
        const float sc = vlm::quantize_row_warp(new_vals, qv);
        const int h = warp >> 1, which = warp & 1;
        int8_t* cache = static_cast<int8_t*>(which ? p.v : p.k) + off + h * p.D;
        unsigned char* row = new_sm + warp * rbytes;
#pragma unroll
        for (int i = 0; i < vlm::kQuantPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < p.D) {
            row[d] = static_cast<unsigned char>(qv[i]);
            cache[d] = qv[i];
          }
        }
        if (lane == 0) {
          reinterpret_cast<float*>(new_sm + 2 * HPB * rbytes)[warp] = sc;
          (which ? p.v_scale : p.k_scale)[(static_cast<int64_t>(b) * p.S + wpos) * p.KV + kvh0 + h] = sc;
        }
      }
    } else if (threadIdx.x < HPB * p.D / 2) {
      const int h = threadIdx.x / (p.D / 2), w = threadIdx.x - h * (p.D / 2);
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        reinterpret_cast<uint32_t*>(new_sm + (2 * h + which) * rbytes)[w] = new_words[which];
        reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(which ? p.v : p.k) + off)[threadIdx.x] =
            new_words[which];
      }
    }
  }
  __syncthreads();

  // this warp's rows of a tile: HPB steps of 16 from rw; in each, m = g,
  // g + 8 of the scores are rows + rlo, + rhi, and P^T's lane t holds
  // rows + 4t .. 4t + 3
  const int rw = (warp % kWPH) * 16 * HPB;
  const int rlo = row_of(g), rhi = row_of(g + 8);
  float m[2] = {vlm::kNegInf, vlm::kNegInf}, l[2] = {0.f, 0.f};
  float acc[NDT][4];
#pragma unroll
  for (int i = 0; i < NDT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int slot = 0;
  for (int i = 0; i < nt; ++i) {
    {  // tile i + stages - 1 into the slot tile i - 1 left
      const int j = i + stages - 1;
      int js = slot + stages - 1;
      if (js >= stages) js -= stages;
      if (j < nt) load(js, s_begin + j * kTile);
      vlm::cp_async_commit();
    }
    if (stages == 1) vlm::cp_async_wait<0>();
    else vlm::cp_async_wait<1>();
    unsigned char* kt = smem + slot * stage_bytes;
    unsigned char* vt = kt + tile_bytes;
    float* ks = reinterpret_cast<float*>(vt + tile_bytes);  // [K, V][row][head]
    const int r0 = s_begin + i * kTile;
    if (wpos >= r0 && wpos < min(r0 + kTile, s_end)) {
      // the fused write's rows (and scales) into their tile
      const int r = wpos - r0;
      for (int w = threadIdx.x; w < HPB * dbytes / 4; w += kThreads) {
        const int h = w / (dbytes / 4), x = 4 * (w - h * (dbytes / 4));
        *reinterpret_cast<uint32_t*>(kt + at(r, h, x)) =
            *reinterpret_cast<const uint32_t*>(new_sm + 2 * h * rbytes + x);
        *reinterpret_cast<uint32_t*>(vt + at(r, h, x)) =
            *reinterpret_cast<const uint32_t*>(new_sm + (2 * h + 1) * rbytes + x);
      }
      if (kInt8 && threadIdx.x < 2 * HPB)  // 2 h + which
        ks[((threadIdx.x & 1) * kTile + r) * HPB + (threadIdx.x >> 1)] =
            new_scale[threadIdx.x];
    }
    __syncthreads();  // tile i landed for every warp

    // scores S^T [16 rows, 8 heads] of each step: lane holds rows rlo,
    // rhi x heads 2t, 2t + 1
    float s[HPB][4];
    bool lv[HPB][2];
#pragma unroll
    for (int st = 0; st < HPB; ++st) {
      const int rb = rw + 16 * st;
      s[st][0] = s[st][1] = s[st][2] = s[st][3] = 0.f;
      if constexpr (kInt8) {
#pragma unroll
        for (int c = 0; c < NDT / 4; ++c) {
          const uint4 lo = *reinterpret_cast<const uint4*>(kt + at(rb + rlo, hw, 64 * c + 16 * t));
          const uint4 hi = *reinterpret_cast<const uint4*>(kt + at(rb + rhi, hw, 64 * c + 16 * t));
          const uint32_t wl[4] = {lo.x, lo.y, lo.z, lo.w};
          const uint32_t wh[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float fl[4], fh[4];
            widen4(wl[j], fl);
            widen4(wh[j], fh);
            const uint32_t a[4] = {vlm::pack_bf16(fl[0], fl[1]),
                                   vlm::pack_bf16(fh[0], fh[1]),
                                   vlm::pack_bf16(fl[2], fl[3]),
                                   vlm::pack_bf16(fh[2], fh[3])};
            vlm::mma16816(s[st], a, qf[4 * c + j][0], qf[4 * c + j][1]);
          }
        }
      } else {
        const int r = rb + row_of((lane & 7) + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int kk = 0; kk < NDT; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(a, kt + at(r, hw, (2 * kk + (lane >> 4)) * 16), false);
          vlm::mma16816(s[st], a, qf[kk][0], qf[kk][1]);
        }
      }
      // the scores in base 2 (the query keeps its bf16 rounding)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[st][e] *= kLog2e;
      lv[st][0] = live(r0 + rb + rlo);
      lv[st][1] = live(r0 + rb + rhi);
      if constexpr (kInt8) {
        const float k0 = lv[st][0] ? ks[(rb + rlo) * HPB + hw] : 0.f;
        const float k1 = lv[st][1] ? ks[(rb + rhi) * HPB + hw] : 0.f;
        s[st][0] *= k0;
        s[st][1] *= k0;
        s[st][2] *= k1;
        s[st][3] *= k1;
      }
      if (!lv[st][0]) s[st][0] = s[st][1] = vlm::kNegInf;
      if (!lv[st][1]) s[st][2] = s[st][3] = vlm::kNegInf;
    }
    // per-head max and sum over the warp's rows: its steps, then the
    // lanes that share t
    float mx0 = vlm::kNegInf, mx1 = vlm::kNegInf;
#pragma unroll
    for (int st = 0; st < HPB; ++st) {
      mx0 = fmaxf(mx0, fmaxf(s[st][0], s[st][2]));
      mx1 = fmaxf(mx1, fmaxf(s[st][1], s[st][3]));
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(vlm::kFullMask, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(vlm::kFullMask, mx1, o));
    }
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float c0 = fast_ex2(m[0] - mn0), c1 = fast_ex2(m[1] - mn1);
    float pr[HPB][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int st = 0; st < HPB; ++st) {
      pr[st][0] = lv[st][0] ? fast_ex2(s[st][0] - mn0) : 0.f;
      pr[st][1] = lv[st][0] ? fast_ex2(s[st][1] - mn1) : 0.f;
      pr[st][2] = lv[st][1] ? fast_ex2(s[st][2] - mn0) : 0.f;
      pr[st][3] = lv[st][1] ? fast_ex2(s[st][3] - mn1) : 0.f;
      sum0 += pr[st][0] + pr[st][2];
      sum1 += pr[st][1] + pr[st][3];
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      sum0 += __shfl_xor_sync(vlm::kFullMask, sum0, o);
      sum1 += __shfl_xor_sync(vlm::kFullMask, sum1, o);
    }
    l[0] = l[0] * c0 + sum0;
    l[1] = l[1] * c1 + sum1;
    m[0] = mn0;
    m[1] = mn1;
#pragma unroll
    for (int mt = 0; mt < NDT; ++mt) {
      acc[mt][0] *= c0;
      acc[mt][1] *= c1;
      acc[mt][2] *= c0;
      acc[mt][3] *= c1;
    }
#pragma unroll
    for (int st = 0; st < HPB; ++st) {
      const int rb = rw + 16 * st;
      if constexpr (kInt8) {
        const float v0 = lv[st][0] ? ks[(kTile + rb + rlo) * HPB + hw] : 0.f;
        const float v1 = lv[st][1] ? ks[(kTile + rb + rhi) * HPB + hw] : 0.f;
        pr[st][0] *= v0;
        pr[st][1] *= v0;
        pr[st][2] *= v1;
        pr[st][3] *= v1;
      }
      // P^T as the B operand: lane (g, t) gets head g at m = 2t, 2t + 1
      // (b0) and 2t + 8, 2t + 9 (b1): rows rb + 4t .. 4t + 3
      const uint32_t pb0 = transpose8x8(vlm::pack_bf16(pr[st][0], pr[st][1]));
      const uint32_t pb1 = transpose8x8(vlm::pack_bf16(pr[st][2], pr[st][3]));
      if constexpr (kInt8) {
        // a lane's 16 bytes of rows rb + 4t + 0..3 at dims 128 h + 16 g ..
        // + 15: byte 2 j + e of a row is slice 8 h + j, dim g + 8 e
#pragma unroll
        for (int h = 0; h < NDT / 8; ++h) {
          uint4 w[4];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
            w[rr] = *reinterpret_cast<const uint4*>(vt + at(rb + 4 * t + rr, hw, 128 * h + 16 * g));
#pragma unroll
          for (int q = 0; q < 4; ++q) {  // word q: slices 8 h + 2 q, + 1
            float f[4][4];
#pragma unroll
            for (int rr = 0; rr < 4; ++rr) {
              const uint32_t x = q == 0 ? w[rr].x : q == 1 ? w[rr].y
                               : q == 2 ? w[rr].z : w[rr].w;
              widen4(x, f[rr]);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const uint32_t a[4] = {vlm::pack_bf16(f[0][2 * j], f[1][2 * j]),
                                     vlm::pack_bf16(f[0][2 * j + 1], f[1][2 * j + 1]),
                                     vlm::pack_bf16(f[2][2 * j], f[3][2 * j]),
                                     vlm::pack_bf16(f[2][2 * j + 1], f[3][2 * j + 1])};
              vlm::mma16816(acc[8 * h + 2 * q + j], a, pb0, pb1);
            }
          }
        }
      } else {
        const int r = rb + row_of((lane & 7) + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < NDT; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, vt + at(r, hw, (2 * mt + ((lane >> 3) & 1)) * 16), true);
          vlm::mma16816(acc[mt], a, pb0, pb1);
        }
      }
    }
    __syncthreads();  // every warp is done with this slot
    if (++slot == stages) slot = 0;
  }
  vlm::cp_async_wait<0>();
  // a column of another KV head than this warp's weighs 0 in the merge
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if ((2 * t + j) / G != hw) l[j] = 0.f;

  using Dims = typename std::conditional<kInt8, Int8Dims, PlainDims>::type;
  finish<kWarps, NDT, __nv_bfloat16, Dims, true>(
      smem, m, l, acc, p.D, HPB * G, p.o + b * p.o_sb, p.o_sh, kvh0 * G,
      p.ws, p.counters, Dims());
}

template <typename T, int NDT, int HPB>
int launch_few_ndt(const Params& p, int B, int splits, int stages,
                   cudaStream_t stream) {
  const size_t smem = few_smem(p.D, sizeof(T) == 1, stages, p.k_new != nullptr,
                               HPB);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel_few<T, NDT, HPB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_kernel_few<T, NDT, HPB>
      <<<dim3(p.KV / HPB, B, splits), kThreads, smem, stream>>>(p, stages);
  return static_cast<int>(cudaGetLastError());
}

// the instance of a form: NDT = few_dp / 16 (bf16 4, 8, 16; int8 8, 16),
// hpb KV heads a block (2: the int8 form at G = 1, D <= 128)
#define VLM_FEW_INSTANCES(X)                                                 \
  X(__nv_bfloat16, 4, 1, 4) X(__nv_bfloat16, 8, 1, 8)                        \
  X(__nv_bfloat16, 16, 1, 16) X(int8_t, 8, 1, 108) X(int8_t, 8, 2, 1108)     \
  X(int8_t, 16, 1, 116)
__host__ inline int few_instance(int D, bool int8, int hpb) {
  return few_dp(D, int8) / 16 + (int8 ? 100 : 0) + (hpb == 2 ? 1000 : 0);
}

int launch_few(const Params& p, bool int8, int B, int stages, int hpb,
               cudaStream_t stream) {
  const int splits = (max(p.S, 1) + p.rows_per_split - 1) / p.rows_per_split;
  switch (few_instance(p.D, int8, hpb)) {
#define VLM_FEW_LAUNCH(T, NDT, HPB, KEY) \
    case KEY: return launch_few_ndt<T, NDT, HPB>(p, B, splits, stages, stream);
    VLM_FEW_INSTANCES(VLM_FEW_LAUNCH)
#undef VLM_FEW_LAUNCH
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}



// ---- fp32 form ----
//
// Split-S like the forms above, with the products at fp32 accuracy: three
// TF32 products each (common.cuh: split_tf32). A block of 2 warps takes
// 32-row tiles (16 rows a warp, the mma's M) of one split for the 8 query
// heads of its group (N = 8), so each cache row is read once for them.
// S^T = K Q^T: k position t of an 8-dim step is dim 2t and t + 4 is
// 2t + 1, so a lane loads its K and Q elements as float2; Q, scaled by
// D^-1/2, stays in registers (64 floats at D = 256). O^T = V^T P^T takes
// P^T as the B operand: lane (g, t) needs head g at rows t and t + 4 of an
// 8-row step and holds rows g, g + 8 of heads 2t, 2t + 1, so four shuffles
// a step move them. K and V rows are padded to a pitch = 8 (mod 16)
// floats: the 4 rows a half warp reads as float2 (K) and the rows t of a
// V fragment fall in distinct bank octets. K and V have one shared-memory
// slot each (67 KB at D = 256: three blocks an SM, so `split_plan` aims at
// three blocks an SM: the serving window's 348 rows become 11 splits of
// one tile): V of a tile lands while its scores are formed, K of the next
// one while V is multiplied. The head dim is padded to 16 NDT (NDT = 4, 8,
// 16) with zero columns, so no loop checks a bound; the three products are
// issued term by term over 4 independent accumulators (4 k-steps of S, 4
// output tiles of P V), so dependent products sit apart.

constexpr int kTile32 = 32;  // cache rows a tile: 16 a warp
constexpr int kWarps32 = 2;
constexpr int kThreads32 = 32 * kWarps32;

__host__ __device__ inline int pitch32(int dp) { return dp + 8; }

struct Params32 {
  const float* q;
  float* k;  // written only at the fused write's row
  float* v;
  float* o;
  const int* kv_len;
  const uint8_t* kv_valid;
  const int* pcol;
  const int* acol;
  const int* gcnt;
  const float* k_new;  // the fused write, as in Params
  const float* v_new;
  const int* wstart;
  float* ws;
  int* counters;
  int H, KV, S, D, window, mode, rows_per_split, uniform;
  int64_t q_sb, q_sh, c_sb, c_ss, o_sb, o_sh;
  float scale;
};

// NDT: 16-dim tiles of the head dim, padded with zero columns to 16 NDT
// (no bound checked inside the loops, so consecutive products overlap)
template <int NDT>
__global__ void __launch_bounds__(kThreads32)
decode_fp32_kernel(const Params32 p) {
  constexpr int dp = 16 * NDT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = p.H / p.KV;
  const int groups = (G + kHeads - 1) / kHeads;
  const int kvh = blockIdx.x / groups;
  const int h0 = (blockIdx.x % groups) * kHeads;  // within the kv head
  const int nh = min(kHeads, G - h0);
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int pitch = pitch32(dp);
  float* ks = reinterpret_cast<float*>(smem);  // [kTile32][pitch]
  float* vs = ks + kTile32 * pitch;

  const int kvl = p.kv_len ? p.kv_len[b] : p.S;
  int limit = min(p.S, kvl);
  int pc = 0, ac = 0, gc = 0;
  if (p.mode == kWindow) {
    pc = *p.pcol;
    ac = p.acol[b];
    gc = p.gcnt[b];
    limit = min(limit, pc + p.window);
  }
  const int s_begin = blockIdx.z * p.rows_per_split;
  const int s_end = min(limit, s_begin + p.rows_per_split);
  const int nt = s_end > s_begin ? (s_end - s_begin + kTile32 - 1) / kTile32 : 0;
  // the fused write's row (else -1). The loop reads it back from shared
  // memory: at D = 256 the kernel sits at 255 registers, and one more live
  // across the loop spills
  const int wpos = fused_row(fused_col(p.k_new, p.wstart, p.uniform, b),
                             s_begin, p.rows_per_split, p.S);
  __shared__ int wpos_sm;
  wpos_sm = wpos;  // every thread stores the same value
  float* new_sm = vs + kTile32 * pitch;  // [2][dp]: the staged K and V rows

  // zero the pad columns [D, dp) of both slots once
  const int pad = dp - p.D;
  for (int i = threadIdx.x; i < 2 * kTile32 * pad; i += kThreads32)
    ks[(i / pad) * pitch + p.D + i % pad] = 0.f;

  const float* kbase = p.k + b * p.c_sb + static_cast<int64_t>(kvh) * p.D;
  const float* vbase = p.v + b * p.c_sb + static_cast<int64_t>(kvh) * p.D;
  const int width = min(vlm::copy_width_f32(p.k, p.D, p.c_sb, p.c_ss, p.D),
                        vlm::copy_width_f32(p.v, p.D, p.c_sb, p.c_ss, p.D));
  // a tile's rows, the fused write's row left out (staged instead)
  auto load = [&](float* dst, const float* base, int i) {
    const int r0 = s_begin + i * kTile32;
    const int w = wpos_sm;
    vlm::load_rows_f32(dst, pitch, base + static_cast<int64_t>(r0) * p.c_ss,
                       p.c_ss, kTile32, s_end - r0, p.D, width,
                       w >= 0 ? w - r0 : -1);
  };
  if (nt > 0) {
    load(ks, kbase, 0);
    vlm::cp_async_commit();
    load(vs, vbase, 0);
    vlm::cp_async_commit();
  }
  // the fused write: stage the new K and V rows, and write them to the
  // cache in the writer block, while tile 0 is in flight
  if (wpos >= 0) {
    const bool writer = blockIdx.x % groups == 0;
    const int64_t off = b * p.c_sb + static_cast<int64_t>(wpos) * p.c_ss +
                        static_cast<int64_t>(kvh) * p.D;
    const int64_t src_off = (static_cast<int64_t>(b) * p.KV + kvh) * p.D;
    for (int i = threadIdx.x; i < 2 * p.D; i += kThreads32) {
      const int which = i >= p.D;
      const int d = i - which * p.D;
      const float x = __ldg((which ? p.v_new : p.k_new) + src_off + d);
      new_sm[which * dp + d] = x;
      if (writer) (which ? p.v : p.k)[off + d] = x;
    }
    __syncthreads();  // staged for every thread (wpos is the block's own)
  }
  // the staged row into the tile that holds it (K: which 0, V: 1), after
  // the tile landed for this thread and before the barrier that releases it
  auto put_row = [&](float* dst, int which, int i) {
    const int r0 = s_begin + i * kTile32;
    const int w = wpos_sm;
    if (w >= r0 && w < min(r0 + kTile32, s_end))
      for (int d = threadIdx.x; d < p.D; d += kThreads32)
        dst[(w - r0) * pitch + d] = vs[kTile32 * pitch + which * dp + d];
  };

  auto live = [&](int r) {
    if (r >= s_end) return false;
    if (p.mode == kWindow) {
      const int age = (((r - pc - ac) % p.window) + p.window) % p.window;
      return r < pc || age < gc;
    }
    if (p.mode == kValid) return p.kv_valid[static_cast<int64_t>(b) * p.S + r] != 0;
    return true;
  };

  // Q^T's B fragment of step kk: head h0 + g, dims 8 kk + 2t and + 1, times
  // D^-1/2 (zero past nh heads and past D), read once while tile 0 lands
  float qf[2 * NDT][2];
  {
    const float* qh = p.q + b * p.q_sb + static_cast<int64_t>(kvh * G + h0 + g) * p.q_sh;
#pragma unroll
    for (int kk = 0; kk < 2 * NDT; ++kk)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * kk + 2 * t + e;
        qf[kk][e] = g < nh && d < p.D ? __ldg(qh + d) * p.scale : 0.f;
      }
  }

  // this warp's running state for heads 2t, 2t + 1; acc is O^T [d, head]
  float m[2] = {vlm::kNegInf, vlm::kNegInf}, l[2] = {0.f, 0.f};
  float acc[NDT][4];
#pragma unroll
  for (int i = 0; i < NDT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int rw = warp * 16;

  for (int i = 0; i < nt; ++i) {
    vlm::cp_async_wait<1>();  // K of tile i (V may still be in flight)
    put_row(ks, 0, i);
    __syncthreads();

    // scores S^T [16 rows, 8 heads]: lane holds rows g, g + 8 x heads 2t,
    // 2t + 1. Four steps at a time, term by term, each step j of the four
    // into its own small-terms and hi.hi accumulators, so a product's
    // accumulator was last written 4 products before (the mma's latency)
    float sl[4][4], sh[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sl[j][e] = sh[j][e] = 0.f;
    const float* kr = ks + (rw + g) * pitch + 2 * t;
#pragma unroll
    for (int k0 = 0; k0 < 2 * NDT; k0 += 4) {
      uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k0 + j;
        const float2 x0 = *reinterpret_cast<const float2*>(kr + 8 * kk);
        const float2 x1 = *reinterpret_cast<const float2*>(kr + 8 * pitch + 8 * kk);
        vlm::split_tf32(x0.x, ah[j][0], al[j][0]);
        vlm::split_tf32(x1.x, ah[j][1], al[j][1]);
        vlm::split_tf32(x0.y, ah[j][2], al[j][2]);
        vlm::split_tf32(x1.y, ah[j][3], al[j][3]);
        vlm::split_tf32(qf[kk][0], bh[j][0], bl[j][0]);
        vlm::split_tf32(qf[kk][1], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) vlm::mma1688_tf32(sl[j], al[j], bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) vlm::mma1688_tf32(sl[j], ah[j], bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) vlm::mma1688_tf32(sh[j], ah[j], bh[j][0], bh[j][1]);
    }
    __syncthreads();  // every warp is done with K: the next tile's K may land
    if (i + 1 < nt) load(ks, kbase, i + 1);
    vlm::cp_async_commit();

    float s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[e] = ((sh[0][e] + sl[0][e]) + (sh[1][e] + sl[1][e])) +
             ((sh[2][e] + sl[2][e]) + (sh[3][e] + sl[3][e]));
    const int r_lo = s_begin + i * kTile32 + rw + g;
    const int r_hi = r_lo + 8;
    const bool lv0 = live(r_lo), lv1 = live(r_hi);
    if (!lv0) s[0] = s[1] = vlm::kNegInf;
    if (!lv1) s[2] = s[3] = vlm::kNegInf;
    // per-head max and sum over the 16 rows: the lanes that share t
    float mx0 = fmaxf(s[0], s[2]), mx1 = fmaxf(s[1], s[3]);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(vlm::kFullMask, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(vlm::kFullMask, mx1, o));
    }
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float c0 = expf(m[0] - mn0), c1 = expf(m[1] - mn1);
    float pr[4];
    pr[0] = lv0 ? expf(s[0] - mn0) : 0.f;
    pr[1] = lv0 ? expf(s[1] - mn1) : 0.f;
    pr[2] = lv1 ? expf(s[2] - mn0) : 0.f;
    pr[3] = lv1 ? expf(s[3] - mn1) : 0.f;
    float sum0 = pr[0] + pr[2], sum1 = pr[1] + pr[3];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      sum0 += __shfl_xor_sync(vlm::kFullMask, sum0, o);
      sum1 += __shfl_xor_sync(vlm::kFullMask, sum1, o);
    }
    l[0] = l[0] * c0 + sum0;
    l[1] = l[1] * c1 + sum1;
    m[0] = mn0;
    m[1] = mn1;

    // P^T's B fragment of row step j (rows 8j .. 8j + 7 of the warp's 16):
    // head g at rows 8j + t and 8j + t + 4, from the lanes that hold them
    uint32_t pbh[2][2], pbl[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int src = (t + 4 * e) * 4 + g / 2;
        const float u0 = __shfl_sync(vlm::kFullMask, pr[2 * j], src);
        const float u1 = __shfl_sync(vlm::kFullMask, pr[2 * j + 1], src);
        vlm::split_tf32(g & 1 ? u1 : u0, pbh[j][e], pbl[j][e]);
      }

    vlm::cp_async_wait<1>();  // V of tile i
    put_row(vs, 1, i);
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < NDT; ++mt) {
      acc[mt][0] *= c0;
      acc[mt][1] *= c1;
      acc[mt][2] *= c0;
      acc[mt][3] *= c1;
    }
    // 4 output tiles at a time, term by term (as in S)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int m0 = 0; m0 < NDT; m0 += 4) {
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // V^T's A fragment: dims 16 mt + g (+ 8) at rows 8j + t (+ 4)
          const float* vr = vs + (rw + 8 * j + t) * pitch + 16 * (m0 + i) + g;
          vlm::split_tf32(vr[0], ah[i][0], al[i][0]);
          vlm::split_tf32(vr[8], ah[i][1], al[i][1]);
          vlm::split_tf32(vr[4 * pitch], ah[i][2], al[i][2]);
          vlm::split_tf32(vr[4 * pitch + 8], ah[i][3], al[i][3]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          vlm::mma1688_tf32(acc[m0 + i], al[i], pbh[j][0], pbh[j][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          vlm::mma1688_tf32(acc[m0 + i], ah[i], pbl[j][0], pbl[j][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          vlm::mma1688_tf32(acc[m0 + i], ah[i], pbh[j][0], pbh[j][1]);
      }
    }
    __syncthreads();  // every warp is done with V: the next tile's V may land
    if (i + 1 < nt) load(vs, vbase, i + 1);
    vlm::cp_async_commit();
  }
  vlm::cp_async_wait<0>();

  finish<kWarps32, NDT>(smem, m, l, acc, p.D, nh, p.o + b * p.o_sb,
                         p.o_sh, kvh * G + h0, p.ws, p.counters);
}

template <int NDT>
int launch32(const Params32& p, dim3 grid, cudaStream_t stream) {
  const size_t dp = 16 * NDT;
  // the K and V slots, then the fused write's staged rows
  const size_t tiles = sizeof(float) * (2 * kTile32 * pitch32(dp) +
                                        (p.k_new ? 2 * dp : 0));
  // the block merge's arrays, at the workspace's dp (D rounded to 16)
  const size_t red = sizeof(float) *
      (kWarps32 * kHeads * (2 + ((p.D + 15) & ~15)) + 2 * kHeads);
  const size_t merge = sizeof(float) * (2 * kMaxSplits + 1) * kHeads;
  size_t smem = tiles > red ? tiles : red;
  smem = smem > merge ? smem : merge;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_fp32_kernel<NDT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_fp32_kernel<NDT><<<grid, kThreads32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k_scale == nullptr: bf16 cache; otherwise an int8 cache with fp32 scales
// k_scale / v_scale [B, S, KV, 1]. Cache strides are in elements. The S
// rows are cut into splits of rows_per_split (a multiple of 64); with more
// than one split, ws holds KV * ceil(G / 8) * B * splits * 8 * (2 + dp)
// floats (dp: D rounded up to 16) and counters one zeroed int per
// (slot, kv head, group of 8 heads), left zeroed by the kernel. G < 8
// takes decode_kernel_few with a ring of `stages` tiles (1-2; ignored for
// G >= 8).
// k_new != nullptr: the fused write of k_new / v_new [B, 1, KV, D] bf16
// (contiguous, 4-byte aligned) at column wstart[0] (uniform) or wstart[b]
// into the caches (values and scales for an int8 cache) before attending.
extern "C" int vlm_decode_attention(
    const void* q, void* k, void* v, void* o, void* k_scale, void* v_scale,
    const int* kv_len, const void* kv_valid, const int* pcol, const int* acol,
    const int* gcnt, const void* k_new, const void* v_new, const int* wstart,
    void* ws, void* counters, int B, int H, int KV, int S, int D, int window,
    int mode, int rows_per_split, int uniform, int stages,
    int heads_per_block, int64_t q_sb, int64_t q_sh, int64_t c_sb,
    int64_t c_ss, int64_t o_sb, int64_t o_sh, float scale, void* stream) {
  const bool int8 = k_scale != nullptr;
  if (D <= 0 || D > kMaxD || D % (int8 ? 4 : 2) != 0 || KV <= 0 ||
      H % KV != 0 || H / KV > 32 || (mode == kWindow && window <= 0) ||
      int8 != (v_scale != nullptr) || rows_per_split <= 0 ||
      rows_per_split % kTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k_new && (!v_new || !wstart ||
                (reinterpret_cast<uintptr_t>(k_new) |
                 reinterpret_cast<uintptr_t>(v_new) |
                 reinterpret_cast<uintptr_t>(k) |
                 reinterpret_cast<uintptr_t>(v)) % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(q) % 4 || q_sb % 2 || q_sh % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows_per_split < S &&
      (!ws || !counters || (S + rows_per_split - 1) / rows_per_split > kMaxSplits))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const __nv_bfloat16*>(q), k, v,
           static_cast<__nv_bfloat16*>(o), static_cast<float*>(k_scale),
           static_cast<float*>(v_scale), kv_len,
           static_cast<const uint8_t*>(kv_valid), pcol, acol, gcnt,
           static_cast<const __nv_bfloat16*>(k_new),
           static_cast<const __nv_bfloat16*>(v_new), wstart,
           static_cast<float*>(ws), static_cast<int*>(counters), H, KV, S, D,
           window, mode, rows_per_split, uniform, q_sb, q_sh, c_sb, c_ss,
           o_sb, o_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H / KV < kHeads) {
    const int hpb = heads_per_block;
    if (stages < 1 || stages > kFewMaxStages || hpb < 1 || hpb > 2 ||
        (hpb == 2 && (!int8 || H != KV || KV % 2 != 0 || D > 128)))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_few(p, int8, B, stages, hpb, st);
  }
  return int8 ? launch<int8_t>(p, B, st) : launch<__nv_bfloat16>(p, B, st);
}

// How many blocks of the G < 8 form with hpb KV heads a block an SM
// holds with a ring of `stages` tiles
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor: its registers and shared
// memory), for ops/decode_attention.py's few_plan.
extern "C" int vlm_decode_few_blocks(int int8, int D, int stages, int fused,
                                     int hpb, int* blocks) {
  if (D <= 0 || D > kMaxD || stages < 1 || stages > kFewMaxStages ||
      hpb < 1 || hpb > 2 || (hpb == 2 && (!int8 || D > 128)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = few_smem(D, int8, stages, fused, hpb);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) {  // the ring does not fit
    *blocks = 0;
    return 0;
  }
  auto query = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, kThreads, smem));
  };
  switch (few_instance(D, int8, hpb)) {
#define VLM_FEW_QUERY(T, NDT, HPB, KEY) \
    case KEY: return query(decode_kernel_few<T, NDT, HPB>);
    VLM_FEW_INSTANCES(VLM_FEW_QUERY)
#undef VLM_FEW_QUERY
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The fp32 form: q [B, H, 1, D] and the cache [B, S, KV, D] in fp32, the
// masks, splits, workspace and counters of vlm_decode_attention, but the
// splits are whole 32-row tiles (rows_per_split a multiple of 32); strides
// in elements. The fused write as in vlm_decode_attention, with fp32 rows.
extern "C" int vlm_decode_attention_fp32(
    const void* q, void* k, void* v, void* o, const int* kv_len,
    const void* kv_valid, const int* pcol, const int* acol, const int* gcnt,
    const void* k_new, const void* v_new, const int* wstart, void* ws,
    void* counters, int B, int H, int KV, int S, int D, int window, int mode,
    int rows_per_split, int uniform, int64_t q_sb, int64_t q_sh, int64_t c_sb,
    int64_t c_ss, int64_t o_sb, int64_t o_sh, float scale, void* stream) {
  if (B <= 0 || D <= 0 || D > kMaxD || D % 2 || KV <= 0 || H % KV != 0 ||
      H / KV > 32 || (mode == kWindow && window <= 0) || rows_per_split <= 0 ||
      rows_per_split % kTile32 != 0 || (k_new && (!v_new || !wstart)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows_per_split < S &&
      (!ws || !counters || (S + rows_per_split - 1) / rows_per_split > kMaxSplits))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params32 p{static_cast<const float*>(q), static_cast<float*>(k),
                   static_cast<float*>(v), static_cast<float*>(o), kv_len,
                   static_cast<const uint8_t*>(kv_valid), pcol, acol, gcnt,
                   static_cast<const float*>(k_new),
                   static_cast<const float*>(v_new), wstart,
                   static_cast<float*>(ws), static_cast<int*>(counters), H,
                   KV, S, D, window, mode, rows_per_split, uniform, q_sb, q_sh,
                   c_sb, c_ss, o_sb, o_sh, scale};
  const int groups = (H / KV + kHeads - 1) / kHeads;
  const int splits = (max(S, 1) + rows_per_split - 1) / rows_per_split;
  const dim3 grid(KV * groups, B, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch32<4>(p, grid, st);
  if (D <= 128) return launch32<8>(p, grid, st);
  return launch32<16>(p, grid, st);
}
