// The weight-streaming mainloop of B5 (int8, M < 512 rows) and B7's
// decode form (grouped int4, M <= 64 rows): the products y [M, N] = x [M,
// K] . W^T where the weights q [N, row_bytes] are the bytes the card must
// move and x is small.
//
// What bounds them on the H100: weight bytes (2 M FLOPs a weight, M <= 64
// at decode). The first design (64-column strips, 64-wide K steps, a
// 3-stage ring of 2-4 KB, byte-wise fragment loads) kept about 16 KB of
// weights in flight an SM and re-staged a 32 x 64 tile of x for every
// 2 KB of int4; this mainloop is its redesign:
//
// - A block of 8 warps owns BN = 128 output columns (16 a warp; 64, 8 a
//   warp, where 128-column blocks would leave an SM one block or none, so
//   that its SM gets a second block to overlap) for BM = MI x 16
//   rows (16, 32 or 64, every warp all of them: each weight is dequantized
//   once a block) and walks its K range in chunks of 128 bytes of every
//   weight row (128 int8 or 256 int4 weights) through a ring of `stages`
//   chunks, as many as fit in half an SM's shared memory (two blocks an
//   SM): 64-96 KB of weights in flight an SM at m = 32 (32-128 KB over
//   the tiles and formats). A chunk is two sub-chunks of 64 bytes a row,
//   each laid out [BN rows, 64 bytes] beside its x [BM rows, 64 or 128 k]
//   and (int4) its group scales [BN, 128 / gs]. The
//   weights arrive by TMA (one thread issues a [BN rows, 64 bytes] box a
//   sub-chunk), x and the scales by cp.async from L2; all of a chunk
//   completes on one mbarrier (the TMA's bytes and every thread's cp.async
//   arrivals), so the ring's depth is chosen at launch. Rows that TMA
//   cannot stride (packed int4 rows only 8-byte aligned: SigLIP fc2's
//   2,152 bytes) take the same kernel with 8-byte cp.async copies. Past the
//   ragged M, N and K edges everything is zero-filled; nothing is copied or
//   padded at call time. The chunk and the ring were chosen in development
//   copies on the H100 (128-byte chunks against 64- and 256-byte ones, one
//   warp row against two at 64 rows); the tile's columns and the split by
//   `testing/profile_quant.py --plans` (PERF.md §6).
// - Whole-word weights: each lane loads one 16-byte word of one weight row
//   a sub-chunk (lanes of a quad side by side: conflict-free) and uses all
//   of it. The mma.sync.m16n8k16 fragment of lane (g, t) holds logical k
//   {2t, 2t+1, 2t+8, 2t+9} of a step; here logical k L of step s is the
//   physical k  16 t + 4 s + 2 (L / 8) + L % 2  (int8: 4 steps a
//   sub-chunk) or  32 t + 4 s + ...  (int4: 8 steps), a bijection on the
//   sub-chunk. x is read through the same map, so the sum is the same
//   product: lane (g, t) reads x[g][16 t ..] (int8) or x[g][32 t ..] (int4)
//   as 16-byte words. x's 16-byte pieces are swizzled in shared memory
//   (piece p of row r at p ^ (2 (p / 8 % 2)) ^ (r % 2)) so those reads are
//   conflict-free too. int8 multiplies x (the A operand, m16 tiles) by the
//   weights (B, n8 tiles); int4 at 128-column tiles and at most 32 rows
//   swaps them: its converted weights are the A operand (a warp's rows g
//   and g + 8) and x the B operand (8 x rows a product), so the conversion
//   writes the four A registers in place and each 16-byte x load is two B
//   registers as it lands. As A, x needed four register copies a product
//   (mma.sync takes A in four consecutive registers, and x's came from two
//   loads) and half of every m16 tile idled at m = 8; as B, neither. (At
//   64-column tiles half of a swapped A is zero rows, and at 64-row tiles
//   its x registers cost a second block an SM: both measured slower
//   swapped.)
// - Dequantization in registers, the numbers of the plain versions: an
//   int8 byte becomes fp32 by one byte permute into 2^23 + (q + 128) and
//   one subtraction, then a bf16 pair (exact); an int4 nibble at bit p of
//   a word (or of the word shifted by 16) by one mask in place into 2^23 +
//   (n + 8) 2^p, a subtraction and the product with its group's fp32 scale
//   pre-divided by 2^p (exact), rounded once to bf16 (Fmt::kInt4): three
//   instructions a nibble and half a pack, where shifting each nibble down
//   first took four. Both are the issue rate's as much as the bytes':
//   int4 spends about 8 thread instructions a weight byte, which is what
//   the card issues while its memory delivers one (B7's prefill form,
//   int4_prefill.cu, takes the rows where the tensor cores bound).
// - Split K without a workspace: the wrapper's plan (ops/quant.py:
//   `stream_plan`) gives each output tile `splits` <= 8 blocks, one thread
//   block cluster, block z taking chunks [z per, (z + 1) per). Each block
//   leaves its fp32 partials in its own shared memory; after a cluster
//   barrier, block r sums the pairs q with q % splits == r over the
//   cluster's blocks in rank order through distributed shared memory (a
//   fixed order: deterministic) and writes them. No device-memory round
//   trip, no counters, no serial last block.
// - The output is bf16, or fp32 (`f32`): a tensor-parallel rank's partial
//   product, which the model group sums before its one rounding.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace vlm {
namespace ws {

namespace cg = cooperative_groups;

constexpr int kSub = 64;       // bytes of each weight row a sub-chunk
constexpr int kSubs = 2;       // sub-chunks a chunk: 128 bytes a row
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplits = 8;  // the portable cluster size
constexpr int kMaxStages = 8;
// the full barriers come first, the ring after them (TMA boxes: 128-byte
// aligned)
constexpr int kRing = 128;
// a block's shared memory: two blocks an SM of 227 KB. (All of it for a
// grid of one block an SM or fewer was slower at down and q/o: a cluster
// of 8 such blocks needs 8 free SMs of one GPC, and 16 clusters no longer
// fit in one wave. PERF.md §6.)
constexpr int kSmemBlock = 113 * 1024;

enum class Fmt { kInt8, kInt4 };

template <Fmt F>
struct Traits;
template <>
struct Traits<Fmt::kInt8> {
  static constexpr int kK = 64;     // weights (k) a sub-chunk
  static constexpr int kSteps = 4;  // k16 steps a sub-chunk
};
template <>
struct Traits<Fmt::kInt4> {
  static constexpr int kK = 128;
  static constexpr int kSteps = 8;
};

// shared-memory position (in 16-byte pieces) of x's piece p of row r
__device__ __forceinline__ int x_piece(int r, int p) {
  return p ^ (((p >> 3) & 1) << 1) ^ (r & 1);
}

// int8 bytes 0-3 of a word (already XORed with 0x80808080: q + 128) as two
// bf16x2 fragment registers, exactly
__device__ __forceinline__ void widen_s8x4(uint32_t u, uint32_t& b0,
                                           uint32_t& b1) {
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) - 8388736.f;
  b0 = pack_bf16(f[0], f[1]);
  b1 = pack_bf16(f[2], f[3]);
}

// the 4 nibbles at bits 0, 4, 8 and 12 of v (a word already XORed with
// 0x88888888: n + 8; or that word shifted right by 16 for its upper four)
// times the group's fp32 scale, each rounded once to bf16. Each nibble is
// taken in place by one LOP3: ORed into 0x4B000000 at bit p it is the fp32
// 2^23 + (n + 8) 2^p, which minus 2^23 + 8 2^p is n 2^p exactly; times
// s4[p / 4] = scale 2^-p (a power of two: exact) it is n * scale rounded
// once to fp32, the plain version's value bit for bit.
__device__ __forceinline__ void dequant_s4x4(uint32_t v, const float* s4,
                                             uint32_t& b0, uint32_t& b1) {
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = (__uint_as_float(and_or(v, 0xFu << (4 * j), 0x4B000000u)) -
            (8388608.f + static_cast<float>(8 << (4 * j)))) * s4[j];
  b0 = pack_bf16(f[0], f[1]);
  b1 = pack_bf16(f[2], f[3]);
}

// word i of a 16-byte vector, for a constant i (no address taken: the
// vector stays in registers)
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// every cp.async this thread issued so far arrives on `bar` when done (the
// arrival counts toward the barrier's expected count)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

struct Args {
  const __nv_bfloat16* x;  // [M, K]
  const uint8_t* q;        // [N, row_bytes]
  const float* scale;      // int8: [N]; int4: [N, G]
  void* y;                 // [M, N] bf16, or fp32 where f32
  int M, N, K, row_bytes;
  int G, lg;               // int4: groups a row, log2(group size)
  int per;                 // chunks a split
  int stages;              // chunks in the ring
  int f32;                 // the output's type: 0 bf16, 1 fp32
};

// bytes of one sub-chunk's weights, x and scales in the ring of a block of
// bm rows and bn columns
template <Fmt F>
__host__ __device__ constexpr int sub_bytes(int bm, int bn, int slots) {
  return bn * kSub + bm * Traits<F>::kK * 2 + bn * slots * 4;
}

// MI m16 tiles a warp (BM = 16 MI rows), NI n8 tiles a warp (the block's
// BN = 64 NI columns: 128, or 64 where a grid of 128-column blocks would
// leave an SM one block or none, ops/quant.py `stream_plan`). LD: how the
// weights move, 0 by TMA boxes of [BN rows, 64 bytes] from `tm_q` (rows
// 16-byte aligned), 8 by 8-byte cp.async (rows 8-byte aligned)
template <Fmt F, int MI, int NI, int LD>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const __grid_constant__ CUtensorMap tm_q, const Args a) {
  using T = Traits<F>;
  constexpr bool kInt4 = F == Fmt::kInt4;
  constexpr int BM = MI * 16;
  constexpr int kNI = NI;
  constexpr int kBN = kWarps * NI * 8;
  constexpr int kXRow = T::kK * 2;         // bytes of a staged x row
  constexpr int kXPieces = T::kK / 8;      // its 16-byte pieces
  constexpr int kWSub = kBN * kSub;
  constexpr int kXSub = BM * kXRow;
  const int slots = kInt4 ? (T::kK >> a.lg) : 0;  // group scales a sub-chunk
  const int sub = sub_bytes<F>(BM, kBN, slots);
  const int stage_bytes = kSubs * sub;

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // one a stage
  unsigned char* ring = smem + kRing;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int chunks = (a.row_bytes + kSubs * kSub - 1) / (kSubs * kSub);
  const int c_begin = blockIdx.z * a.per;
  const int nk = max(0, min(chunks, c_begin + a.per) - c_begin);

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s)
      mbar_init(&full[s], kThreads + (LD == 0 ? 1 : 0));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load = [&](int stage, int c) {
    unsigned char* st = ring + stage * stage_bytes;
    if constexpr (LD == 0) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(&full[stage], kSubs * kWSub);
#pragma unroll
        for (int u = 0; u < kSubs; ++u)
          tma_load_2d(st + u * sub, &tm_q, &full[stage], (c * kSubs + u) * kSub,
                      n0);
      }
    }
#pragma unroll
    for (int u = 0; u < kSubs; ++u) {
      unsigned char* base = st + u * sub;
      const int sc = c * kSubs + u;  // the sub-chunk's index along the row
      // weights: 128 rows x 64 bytes, dense; past N and the row's end zero
      if constexpr (LD != 0) {
        constexpr int kWP = kSub / LD;
        for (int i = threadIdx.x; i < kBN * kWP; i += kThreads) {
          const int r = i / kWP, p = i % kWP;
          const int off = sc * kSub + p * LD;
          const bool ok = n0 + r < a.N && off < a.row_bytes;
          cp_async_small<LD>(base + r * kSub + p * LD,
                             ok ? a.q + (int64_t)(n0 + r) * a.row_bytes + off
                                : a.q, ok);
        }
      }
      // x: BM rows x kK bf16, swizzled pieces
      unsigned char* xd = base + kWSub;
      for (int i = threadIdx.x; i < BM * kXPieces; i += kThreads) {
        const int r = i / kXPieces, p = i % kXPieces;
        const int k = sc * T::kK + p * 8;
        const bool ok = m0 + r < a.M && k < a.K;
        cp_async16(xd + r * kXRow + x_piece(r, p) * 16,
                   ok ? a.x + (int64_t)(m0 + r) * a.K + k : a.x, ok);
      }
      if constexpr (kInt4) {
        float* sd = reinterpret_cast<float*>(xd + kXSub);
        for (int i = threadIdx.x; i < kBN * slots; i += kThreads) {
          const int r = i / slots, j = sc * slots + i % slots;
          const bool ok = n0 + r < a.N && j < a.G;
          cp_async_small<4>(sd + i, ok ? a.scale + (int64_t)(n0 + r) * a.G + j
                                       : a.scale, ok);
        }
      }
    }
    cp_async_arrive(&full[stage]);
  };

  // int4 with two n8 column tiles a warp and at most 32 rows swaps the
  // operands (compute_swapped); elsewhere x is the A operand (compute_x_a):
  // int8 always, int4 at 64-column tiles (half of a swapped A would be
  // zero rows) and 64-row tiles (the swapped form's x tiles took 153-179
  // registers there, one block an SM)
  constexpr bool kSwap = kInt4 && kNI == 2 && MI <= 2;
  // acc[mi kNI + ni] is the m16 x n8 tile (mi, ni) of x . W^T; swapped,
  // acc[j] is the 16 x 8 tile W . x^T of the warp's weight rows (ni = 0,
  // 1: rows g, g + 8) and x rows 8 j .. 8 j + 7
  constexpr int kAcc = kSwap ? 2 * MI : MI * kNI;
  float acc[kAcc][4];
#pragma unroll
  for (int i = 0; i < kAcc; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // this lane's 16-byte word of each of its kNI weight rows, XORed to q +
  // 128 (int8) or n + 8 (int4)
  auto weight_words = [&](const unsigned char* base, uint4 (&w)[kNI]) {
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          base + ((warp * kNI + ni) * 8 + g) * kSub + 16 * t);
      const uint32_t flip = kInt4 ? 0x88888888u : 0x80808080u;
      w[ni] = make_uint4(v.x ^ flip, v.y ^ flip, v.z ^ flip, v.w ^ flip);
    }
  };

  // the group scale of each of the lane's rows (int4) for the 16 k of
  // half h of its span, and its copies scaled by 2^-4, 2^-8, 2^-12
  // (dequant_s4x4)
  auto group_scales = [&](const unsigned char* xt, int h,
                          float (&s4)[kNI][4]) {
    const float* st = reinterpret_cast<const float*>(xt + kXSub);
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni) {
      const float sc = st[((warp * kNI + ni) * 8 + g) * slots +
                          ((32 * t + 16 * h) >> a.lg)];
      s4[ni][0] = sc;
      s4[ni][1] = sc * 0x1p-4f;
      s4[ni][2] = sc * 0x1p-8f;
      s4[ni][3] = sc * 0x1p-12f;
    }
  };

  // one sub-chunk with x as the A operand (m16 tiles, rows g and g + 8)
  // and the converted weights as the B operand (n8 tiles)
  auto compute_x_a = [&](const unsigned char* base) {
    const unsigned char* xt = base + kWSub;
    uint4 w[kNI];
    weight_words(base, w);
    // int8: one half of 4 steps; int4: two, x pieces 4t + 2h and + 1
#pragma unroll
    for (int h = 0; h < T::kSteps / 4; ++h) {
      float s4[kNI][4];
      if constexpr (kInt4) group_scales(xt, h, s4);
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // two steps a piece e of x
        uint4 xa[MI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = mi * 16 + g + 8 * hr;
            const int p = (kInt4 ? 4 * t + 2 * h : 2 * t) + e;
            xa[mi][hr] = *reinterpret_cast<const uint4*>(
                xt + r * kXRow + x_piece(r, p) * 16);
          }
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2) {
          // A: physical k 4s..4s+3 of the lane's span, s = 2e + s2
          uint32_t af[MI][4];
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const uint4 v = xa[mi][hr];
              af[mi][hr] = s2 ? v.z : v.x;      // a0 / a1: k 4s, 4s + 1
              af[mi][2 + hr] = s2 ? v.w : v.y;  // a2 / a3: k 4s + 2, 4s + 3
            }
#pragma unroll
          for (int ni = 0; ni < kNI; ++ni) {
            uint32_t b0, b1;
            if constexpr (kInt4) {
              // bytes 8h + 2e + s2 .. of the word: k 32t + 16h + 4s .. + 3
              const uint32_t u = word(w[ni], 2 * h + e);
              dequant_s4x4(s2 ? u >> 16 : u, s4[ni], b0, b1);
            } else {
              widen_s8x4(word(w[ni], 2 * e + s2), b0, b1);
            }
#pragma unroll
            for (int mi = 0; mi < MI; ++mi)
              mma16816(acc[mi * kNI + ni], af[mi], b0, b1);
          }
        }
      }
    }
  };

  // int4, one sub-chunk, swapped: the converted weights are the A
  // operand (rows g and g + 8 of the warp's 16: its two n8 column tiles),
  // x the B operand (8 x rows a product). So the conversion writes the
  // four A registers in place and each x load is two B registers as they
  // land: no copies between them, one conversion for every x row tile.
  // Step s of the lane's span (s = 4h + 2e + s2) is physical k 32t + 4s ..
  // + 3: bytes 2s, 2s + 1 of the weight word (a0, a2 of row g; a1, a3 of
  // row g + 8) and x piece 4t + 2h + e's words 2 s2, 2 s2 + 1 (b0, b1).
  auto compute_swapped = [&](const unsigned char* base) {
    const unsigned char* xt = base + kWSub;
    uint4 w[kNI];
    weight_words(base, w);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s4[kNI][4];
      group_scales(xt, h, s4);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint4 xb[kAcc];
#pragma unroll
        for (int j = 0; j < kAcc; ++j) {
          const int r = 8 * j + g;
          if (m0 + 8 * j < a.M)
            xb[j] = *reinterpret_cast<const uint4*>(
                xt + r * kXRow + x_piece(r, 4 * t + 2 * h + e) * 16);
        }
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2) {
          uint32_t af[4];
          const uint32_t u0 = word(w[0], 2 * h + e);
          const uint32_t u1 = word(w[kNI - 1], 2 * h + e);
          dequant_s4x4(s2 ? u0 >> 16 : u0, s4[0], af[0], af[2]);
          dequant_s4x4(s2 ? u1 >> 16 : u1, s4[kNI - 1], af[1], af[3]);
#pragma unroll
          for (int j = 0; j < kAcc; ++j)
            if (m0 + 8 * j < a.M)
              mma16816(acc[j], af, s2 ? xb[j].z : xb[j].x,
                       s2 ? xb[j].w : xb[j].y);
        }
      }
    }
  };

  for (int s = 0; s < a.stages - 1; ++s)
    if (s < nk) load(s, c_begin + s);
  // the ring's slots counted without a division: chunk i in slot `stage`
  // at barrier phase `phase`, chunk i + stages - 1 loading into `fill`
  int stage = 0, phase = 0, fill = a.stages - 1;
  for (int i = 0; i < nk; ++i) {
    __syncthreads();  // chunk i - 1 consumed by every warp: its slot is free
    if (i + a.stages - 1 < nk) load(fill, c_begin + i + a.stages - 1);
    fill = fill + 1 == a.stages ? 0 : fill + 1;
    mbar_wait(&full[stage], phase);
    const unsigned char* st = ring + stage * stage_bytes;
    if (++stage == a.stages) {
      stage = 0;
      phase ^= 1;
    }
#pragma unroll
    for (int u = 0; u < kSubs; ++u) {
      if constexpr (kSwap)
        compute_swapped(st + u * sub);
      else
        compute_x_a(st + u * sub);
    }
  }

  // one output value at (row, col) (the swapped form's)
  auto put = [&](int row, int col, float v) {
    if (row >= a.M || col >= a.N) return;
    const int64_t at = (int64_t)row * a.N + col;
    if (a.f32)
      static_cast<float*>(a.y)[at] = v;
    else
      static_cast<__nv_bfloat16*>(a.y)[at] = __float2bfloat16_rn(v);
  };
  // accumulator pair (i, hr): acc[i][2 hr], acc[i][2 hr + 1]; int8's
  // column scale applied
  auto store = [&](int i, int hr, float v0, float v1) {
    if constexpr (kSwap) {
      // W . x^T: weight row g + 8 hr (a column of y) and x rows 8 i + 2t,
      // + 1 (rows of y)
      const int col = n0 + warp * kNI * 8 + g + 8 * hr;
      put(m0 + 8 * i + 2 * t, col, v0);
      put(m0 + 8 * i + 2 * t + 1, col, v1);
    } else {
      const int mi = i / kNI, ni = i % kNI;
      const int row = m0 + mi * 16 + g + 8 * hr;
      const int col = n0 + (warp * kNI + ni) * 8 + 2 * t;  // N even
      if (row >= a.M || col >= a.N) return;
      if constexpr (!kInt4) {
        v0 *= a.scale[col];
        v1 *= a.scale[col + 1];
      }
      const int64_t at = (int64_t)row * a.N + col;
      if (a.f32)
        *reinterpret_cast<float2*>(static_cast<float*>(a.y) + at) =
            make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.y) +
                                           at) = __floats2bfloat162_rn(v0, v1);
    }
  };

  const int splits = gridDim.z;
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        store(i, hr, acc[i][2 * hr], acc[i][2 * hr + 1]);
    return;
  }

  // the cluster's partials: [pair q][thread] float2 in each block's ring
  // (every chunk has landed: each warp waited for each one)
  constexpr int kPairs = kAcc * 2;
  __syncthreads();  // every warp is done with the ring
  float2* part = reinterpret_cast<float2*>(ring);
#pragma unroll
  for (int i = 0; i < kAcc; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      part[(i * 2 + hr) * kThreads + threadIdx.x] =
          make_float2(acc[i][2 * hr], acc[i][2 * hr + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partials are in place
  const int rank = (int)cluster.block_rank();
  for (int q = rank; q < kPairs; q += splits) {
    // every rank's partial loaded before the sum in rank order: issued
    // together, the remote loads overlap (one after another, each waited
    // for its predecessor's add: the reduction took up to 2.5 us of a
    // 5-us launch, PERF.md)
    float2 v[kMaxSplits];
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z)
      if (z < splits)
        v[z] = cluster.map_shared_rank(part, z)[q * kThreads + threadIdx.x];
    float2 sum = make_float2(0.f, 0.f);
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z)
      if (z < splits) {
        sum.x += v[z].x;
        sum.y += v[z].y;
      }
    store(q / 2, q % 2, sum.x, sum.y);
  }
  cluster.sync();  // no block leaves while another reads its partials
}

using KernelFn = void (*)(const CUtensorMap, const Args);

template <Fmt F, int NI, int LD>
KernelFn kernel_for(int bm) {
  return bm == 16   ? stream_kernel<F, 1, NI, LD>
         : bm == 32 ? stream_kernel<F, 2, NI, LD>
         : bm == 64 ? stream_kernel<F, 4, NI, LD>
                    : nullptr;
}

// Launch the kernel of `bm` rows (16, 32 or 64) and `bn` columns (64 or
// 128: the plan's tile) with `splits` blocks of one cluster on each output
// tile and a ring of as many chunks as fit in kSmemBlock (at most
// kMaxStages). The TMA route (LD == 0) encodes its tensor map here: [N
// rows, row_bytes] bytes.
template <Fmt F, int LD>
int launch(Args a, int bm, int bn, int splits, cudaStream_t stream) {
  const KernelFn kernel = bn == 128  ? kernel_for<F, 2, LD>(bm)
                          : bn == 64 ? kernel_for<F, 1, LD>(bm)
                                     : nullptr;
  if (kernel == nullptr || splits < 1 || splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm = {};
  if (LD == 0) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.row_bytes),
                                static_cast<cuuint64_t>(a.N)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.row_bytes)};
    const cuuint32_t box[2] = {kSub, static_cast<cuuint32_t>(bn)};
    if (!tensor_map(&tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.q, 2, dims, strides,
                    box, CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorNotSupported;
  }
  const int slots = F == Fmt::kInt4 ? (Traits<F>::kK >> a.lg) : 0;
  const int stage_bytes = kSubs * sub_bytes<F>(bm, bn, slots);
  a.stages = (kSmemBlock - kRing) / stage_bytes;
  if (a.stages > kMaxStages) a.stages = kMaxStages;
  if (a.stages < 2) a.stages = 2;
  // the ring also holds the cluster's partials: [pairs][threads] float2
  const int partials = (bm / 16) * (bn / 64) * 2 * kThreads * 8;
  const int ring = a.stages * stage_bytes;
  const int smem = kRing + (ring > partials ? ring : partials);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + bn - 1) / bn, (a.M + bm - 1) / bm, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tm, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `splits` blocks of the mainloop's shape (kThreads
// threads, kSmemBlock bytes of shared memory: the most a launch takes) the
// current device runs at once. A cluster's blocks must share one GPC, so
// fewer clusters of 8 fit than the SMs suggest (on the H100, 30 at two
// blocks an SM); ops/quant.py `stream_plan` keeps a grid's clusters within
// one wave of them.
inline int max_clusters(int splits, int* count) {
  const KernelFn kernel = stream_kernel<Fmt::kInt8, 2, 2, 0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBlock);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBlock;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      count, reinterpret_cast<const void*>(kernel), &cfg);
}

}  // namespace ws
}  // namespace vlm
