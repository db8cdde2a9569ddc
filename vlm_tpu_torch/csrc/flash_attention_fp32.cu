// B1, fp32 form: prefill / encoder attention at fp32 accuracy, for models
// that run with quantization "fp32" (vlm_tpu's default compute dtype).
//
// Replaces vlm_tpu/ops/attention.py `_flash_kernel` (launched by
// `_flash_fwd_pallas`) for fp32 operands; the bf16 form is
// flash_attention.cu (wgmma + TMA, bf16 only). Same function as
// `attention_plain`: q [B, H, Sq, D], k/v [B, KV, Sk, D] with any strides
// and a contiguous head dim, grouped-query heads sharing a KV head; masks
// causal with the diagonal at the end of the kv axis, widened by
// prefix_len, and kv_len, all with the finite -1e30, so a row with no live
// key averages V over every key.
//
// What bounds it on the H100: operations. fp32 FMAs on the CUDA cores give
// 67 TFLOP/s; the tensor cores take TF32 (10 mantissa bits). Each fp32
// product here is three TF32 products (common.cuh: split_tf32,
// mma1688_tf32): x = hi + lo, a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b,
// each exact in the tensor core and summed in fp32, so the error is that of
// fp32 sums (one TF32 product alone would err by ~2^-11). mma.sync reaches
// about 300 of the card's 495 TF32 TFLOP/s (testing/tf32_bench.py), so
// about 100 fp32-accurate TFLOP/s at most. The design:
// - Rows. A block of 4 row groups of 16 query rows (the mma's M) takes
//   64 query rows of one (batch, KV head), or 80 (5 row groups) where a
//   block fills its SM and 64-row blocks would overrun one round of the
//   SMs (Gemma's prefill: 128 blocks, not 160, on 132 SMs): (position,
//   head) pairs of hpb = gcd(G, 64) heads of the KV head's group, row r
//   being position p0 + r / hpb of head h0 + r % hpb (ops/attention.py:
//   `fp32_rows`, `flash_plan`), so one K/V tile feeds all 8 Gemma heads.
//   Q stays in shared memory (64 x 256 fp32 is 64 KB). From D = 88 on two
//   warps share a row group, each taking 16 keys of every tile, merged at
//   the end through shared memory (`fp32_key_split`): at D = 256 a block
//   fills its SM, and twice the warps hide the products' latency.
// - Copies. K/V tiles of 32 keys flow through a cp.async ring of 2 or 3
//   stages (3 where the block still leaves room for a second block an SM),
//   so the next tiles land while this one is multiplied. Each copy is as
//   wide as the rows' alignment allows (16, 8 or 4 bytes): any strides,
//   no padded copy. Keys past Sk and columns past D are zero-filled.
// - Head dims. The kernel is built for D padded to 8 KD (KD = 4, 8, 9, 11,
//   16, 24, 32: exact for 64, 72, 88, 128, 256) with zero columns, so no
//   loop inside a tile checks a bound and consecutive products overlap.
// - S = Q K^T with m16n8k8: per k-step of 8 head dims, k position t takes
//   dim 2t and t + 4 takes dim 2t + 1 (any order of the summed index is the
//   same product), so each lane loads its Q and K elements as float2. K
//   and Q rows are padded to a pitch = 8 (mod 16) floats, which puts the
//   4 rows a half warp reads in distinct bank octets. The small terms and
//   hi.hi go to separate accumulators, and each term is issued for all
//   n-tiles before the next, so dependent products sit apart.
// - P V with m16n8k8: the S accumulator holds keys 2t and 2t + 1 of rows
//   g and g + 8, so with k position t as key 2t and t + 4 as key 2t + 1 it
//   is already P's A fragment: no shuffle. V's fragment is then rows 2t and
//   2t + 1, column g; V rows are padded to a pitch = 4 (mod 8) floats so
//   rows 0, 2, 4, 6 fall in distinct bank octets. Four output tiles at a
//   time, term by term.
// - Softmax. Scores in fp32 after the three products, scaled to base 2;
//   -1e30 is set on the finished score (never split). Online softmax per
//   row in registers (max over the 4 lanes of a row), row sums per lane
//   and reduced once at the end.
// - Skipped tiles. A block loads only the tiles that hold a live key of
//   one of its rows, starting at tile (position tile index) mod (its tile
//   count); a block with a row that has no live key (kv_len = 0, a causal
//   row before the first key) loads every tile, so that row's weights are
//   uniform over all Sk keys (the mean of V), as in the bf16 form.
//   tests/test_torch_fp32_forms.py emulates the blocks on the CPU.
// - lse. Where the caller passes lse [B, H, Sq] (B1's differentiable form,
//   for its backward, flash_attention_fp32_bwd.cu), each row's natural-log
//   sum of exp of its scaled, masked scores, (m + log2 l) ln 2 from the
//   running max and sum the row ends with; -1e30 for a row with no live key
//   (the plain version's logsumexp of -1e30 everywhere). Null (serving):
//   nothing is written and the output is the same.
#include "common.cuh"

namespace {

constexpr int kKeys = 32;  // keys a K/V tile
constexpr int kMaxD = 256;

// row pitches in floats for dp = the head dim padded to 8 KD
__host__ __device__ inline int pitch_qk(int dp) { return dp % 16 ? dp : dp + 8; }
__host__ __device__ inline int pitch_v(int dp) { return dp + 4; }

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;  // [B, H, Sq] or null
  const int* kv_len;
  const int* prefix_len;
  int H, KV, Sq, Sk, D, causal, lhpb, positions, stages, wq, wk, wv;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
      o_ss;
  float scale;  // D^-1/2 log2(e): scores in base 2
};

// KD: 8-dim steps of the head dim, padded with zero columns to 8 KD (no
// bound checked inside the loops, so the products of consecutive steps
// and tiles overlap). KS: warps that share a row group, each taking
// 32 / KS keys of every tile (merged at the end). RG: row groups of 16
// query rows (the mma's M) a block.
template <int KD, int KS, int RG>
__global__ void __launch_bounds__(RG * KS * 32)
flash_fp32_kernel(const Params p) {
  constexpr int kRowGroups = RG;
  constexpr int kRows = RG * 16;  // query rows a block
  constexpr int kThreads = RG * KS * 32;
  constexpr int kNT = 4 / KS;     // 8-key n-tiles of a tile a warp takes
  constexpr int dp = 8 * KD;
  extern __shared__ __align__(16) float sm[];
  const int qp = pitch_qk(dp), vp = pitch_v(dp);
  const int stage = kKeys * (qp + vp);  // floats: K [kKeys][qp], V [kKeys][vp]
  float* qs = sm;                       // [kRows][qp]
  float* ring = qs + kRows * qp;
  const int hpb = 1 << p.lhpb;
  const int b = blockIdx.z, h0 = blockIdx.y * hpb;
  const int kvh = h0 / (p.H / p.KV);
  const int p0 = blockIdx.x * p.positions;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % kRowGroups, kh = warp / kRowGroups;

  // the block's key range (the fp32 emulation in
  // tests/test_torch_fp32_forms.py mirrors these lines)
  const int kvl = min(p.kv_len ? p.kv_len[b] : p.Sk, p.Sk);
  const int pfx = p.causal && p.prefix_len ? p.prefix_len[b] : 0;
  const int off = p.Sk - p.Sq;
  int lim_first = kvl, lim_last = kvl;
  if (p.causal) {
    lim_first = min(max(p0 + off + 1, pfx), kvl);
    lim_last = min(max(min(p0 + p.positions, p.Sq) + off, pfx), kvl);
  }
  const int keys = lim_first <= 0 ? p.Sk : lim_last;  // a dead row: every key
  const int nt = (keys + kKeys - 1) / kKeys;
  // the blocks of one KV head start at different tiles (step i takes tile
  // (i + rot) mod nt), so that they do not all ask the same L2 lines at
  // once
  const int rot = blockIdx.x % nt;

  // zero the pad columns [D, dp) of Q and of every ring row once: the
  // copies never write them, and 0 x garbage could be NaN
  const int pad = dp - p.D;
  if (pad) {
    for (int i = threadIdx.x; i < kRows * pad; i += kThreads)
      qs[(i / pad) * qp + p.D + i % pad] = 0.f;
    for (int i = threadIdx.x; i < p.stages * 2 * kKeys * pad; i += kThreads) {
      const int r = i / pad, s = r / (2 * kKeys), rr = r % (2 * kKeys);
      float* row = ring + s * stage +
                   (rr < kKeys ? rr * qp : kKeys * qp + (rr - kKeys) * vp);
      row[p.D + i % pad] = 0.f;
    }
  }

  // Q: row r is position p0 + r / hpb of head h0 + r % hpb; rows past Sq
  // are zero-filled
  {
    const int per = p.wq / 4, chunks = p.D / per;
    for (int i = threadIdx.x; i < kRows * chunks; i += kThreads) {
      const int r = i / chunks, c = i - r * chunks;
      const int pos = p0 + (r >> p.lhpb), h = h0 + (r & (hpb - 1));
      const bool ok = pos < p.Sq;
      const float* src = ok ? p.q + b * p.q_sb + h * p.q_sh +
                                  static_cast<int64_t>(pos) * p.q_ss + c * per
                            : p.q;
      float* dst = qs + r * qp + c * per;
      if (p.wq == 16) vlm::cp_async16(dst, src, ok);
      else if (p.wq == 8) vlm::cp_async_small<8>(dst, src, ok);
      else vlm::cp_async_small<4>(dst, src, ok);
    }
  }
  const float* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const float* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  auto load = [&](int tile, int s) {
    const int k0 = tile * kKeys, valid = min(kKeys, p.Sk - k0);
    float* ks = ring + s * stage;
    vlm::load_rows_f32(ks, qp, kb + static_cast<int64_t>(k0) * p.k_ss,
                       p.k_ss, kKeys, valid, p.D, p.wk);
    vlm::load_rows_f32(ks + kKeys * qp, vp,
                       vb + static_cast<int64_t>(k0) * p.v_ss, p.v_ss, kKeys,
                       valid, p.D, p.wv);
  };
  // Q rides in the first group, with tile 0
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < nt) load((s + rot) % nt, s);
    vlm::cp_async_commit();
  }

  // this lane's rows g and g + 8 of its row group: their key limits
  const int r0 = rg * 16 + g;
  auto row_limit = [&](int r) {
    const int pos = p0 + (r >> p.lhpb);
    return p.causal ? min(max(pos + off + 1, pfx), kvl) : kvl;
  };
  const int lim0 = row_limit(r0), lim1 = row_limit(r0 + 8);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[KD][4];
#pragma unroll
  for (int i = 0; i < KD; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const float* q0 = qs + r0 * qp + 2 * t;
  const float* q1 = q0 + 8 * qp;
  const int key0 = kh * kNT * 8;  // this warp's first key of a tile

  for (int i = 0; i < nt; ++i) {
    const int next = i + p.stages - 1;
    if (next < nt) load((next + rot) % nt, next % p.stages);
    vlm::cp_async_commit();
    if (p.stages == 3) vlm::cp_async_wait<2>();
    else vlm::cp_async_wait<1>();
    __syncthreads();  // tile i (and Q) landed for every warp
    const float* ks = ring + (i % p.stages) * stage;
    const float* vs = ks + kKeys * qp;

    // S [16 rows, kNT n-tiles of 8 keys]: the small terms and hi.hi in
    // separate accumulators
    float sl[kNT][4], sh[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sl[n][e] = sh[n][e] = 0.f;
    const float* kr = ks + (key0 + g) * qp + 2 * t;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(q0 + 8 * kk);
      const float2 x1 = *reinterpret_cast<const float2*>(q1 + 8 * kk);
      uint32_t ah[4], al[4], bh[kNT][2], bl[kNT][2];
      vlm::split_tf32(x0.x, ah[0], al[0]);
      vlm::split_tf32(x1.x, ah[1], al[1]);
      vlm::split_tf32(x0.y, ah[2], al[2]);
      vlm::split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(kr + n * 8 * qp + 8 * kk);
        vlm::split_tf32(y.x, bh[n][0], bl[n][0]);
        vlm::split_tf32(y.y, bh[n][1], bl[n][1]);
      }
      // term by term over the n-tiles: a product's accumulator was last
      // written kNT products before (the mma's latency is ~4 of them)
#pragma unroll
      for (int n = 0; n < kNT; ++n) vlm::mma1688_tf32(sl[n], al, bh[n][0], bh[n][1]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) vlm::mma1688_tf32(sl[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) vlm::mma1688_tf32(sh[n], ah, bh[n][0], bh[n][1]);
    }

    // masks on the finished scores, then the online softmax (base 2)
    const int k0 = (i + rot) % nt * kKeys + key0;
    float x[kNT][4];
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + 8 * n + 2 * t + (e & 1);
        float s = (sh[n][e] + sl[n][e]) * p.scale;
        if (kj >= (e < 2 ? lim0 : lim1)) s = vlm::kNegInf;
        if (kj >= p.Sk) s = -INFINITY;  // past Sk: no key at all
        x[n][e] = s;
        if (e < 2) mx0 = fmaxf(mx0, s);
        else mx1 = fmaxf(mx1, s);
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(vlm::kFullMask, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(vlm::kFullMask, mx1, o));
    }
    // with KS > 1 a warp may have seen no key yet (all its keys past Sk):
    // its weights stay 0 against a base of 0
    const float b0 = mx0 == -INFINITY ? 0.f : mx0;
    const float b1 = mx1 == -INFINITY ? 0.f : mx1;
    const float c0 = exp2f(m0 - b0), c1 = exp2f(m1 - b1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      x[n][0] = exp2f(x[n][0] - b0);
      x[n][1] = exp2f(x[n][1] - b0);
      x[n][2] = exp2f(x[n][2] - b1);
      x[n][3] = exp2f(x[n][3] - b1);
      sum0 += x[n][0] + x[n][1];
      sum1 += x[n][2] + x[n][3];
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) {
      acc[nd][0] *= c0;
      acc[nd][1] *= c0;
      acc[nd][2] *= c1;
      acc[nd][3] *= c1;
    }

    // O += P V: P's A fragment of k-step n (keys 8n..8n+7 of the warp's,
    // k position t as key 2t and t + 4 as key 2t + 1) is the S
    // accumulator as it stands
    uint32_t ph[kNT][4], pl[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      vlm::split_tf32(x[n][0], ph[n][0], pl[n][0]);
      vlm::split_tf32(x[n][2], ph[n][1], pl[n][1]);
      vlm::split_tf32(x[n][1], ph[n][2], pl[n][2]);
      vlm::split_tf32(x[n][3], ph[n][3], pl[n][3]);
    }
    const float* vr = vs + (key0 + 2 * t) * vp + g;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      // 4 output tiles at a time, term by term (as in S)
#pragma unroll
      for (int nd0 = 0; nd0 < KD; nd0 += 4) {
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (nd0 + j >= KD) break;
          vlm::split_tf32(vr[8 * n * vp + 8 * (nd0 + j)], bh[j][0], bl[j][0]);
          vlm::split_tf32(vr[(8 * n + 1) * vp + 8 * (nd0 + j)], bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nd0 + j < KD) vlm::mma1688_tf32(acc[nd0 + j], pl[n], bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nd0 + j < KD) vlm::mma1688_tf32(acc[nd0 + j], ph[n], bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nd0 + j < KD) vlm::mma1688_tf32(acc[nd0 + j], ph[n], bh[j][0], bh[j][1]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  vlm::cp_async_wait<0>();

  if (KS > 1) {
    // the key halves of a row group: the second warp's (m, l, acc) through
    // shared memory (Q's and the ring's, free now), merged into the first's
    float* xm = sm;  // [4][kRowGroups * 32]: m0, m1, l0, l1
    float* xa = xm + 4 * kRowGroups * 32;  // [KD * 4][kRowGroups * 32]
    const int slot = rg * 32 + lane;
    constexpr int kSlots = kRowGroups * 32;
    if (kh == 1) {
      xm[slot] = m0;
      xm[kSlots + slot] = m1;
      xm[2 * kSlots + slot] = l0;
      xm[3 * kSlots + slot] = l1;
#pragma unroll
      for (int nd = 0; nd < KD; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) xa[(nd * 4 + e) * kSlots + slot] = acc[nd][e];
    }
    __syncthreads();
    if (kh == 1) return;
    const float n0 = xm[slot], n1 = xm[kSlots + slot];
    const float mm0 = fmaxf(m0, n0), mm1 = fmaxf(m1, n1);  // finite: kh 0 has key 0
    const float wa0 = exp2f(m0 - mm0), wb0 = exp2f(n0 - mm0);
    const float wa1 = exp2f(m1 - mm1), wb1 = exp2f(n1 - mm1);
    l0 = l0 * wa0 + xm[2 * kSlots + slot] * wb0;
    l1 = l1 * wa1 + xm[3 * kSlots + slot] * wb1;
    m0 = mm0;  // the rows' max, for lse
    m1 = mm1;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[nd][e] = acc[nd][e] * (e < 2 ? wa0 : wa1) +
                     xa[(nd * 4 + e) * kSlots + slot] * (e < 2 ? wb0 : wb1);
  }

#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(vlm::kFullMask, l0, o);
    l1 += __shfl_xor_sync(vlm::kFullMask, l1, o);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    const int pos = p0 + (r >> p.lhpb), h = h0 + (r & (hpb - 1));
    if (pos >= p.Sq) continue;
    const float inv = 1.f / (half ? l1 : l0);
    if (p.lse && t == 0) {
      const float m = half ? m1 : m0;
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + pos] =
          m == vlm::kNegInf ? vlm::kNegInf
                            : (m + log2f(half ? l1 : l0)) * 0.6931471805599453f;
    }
    float* orow = p.o + b * p.o_sb + h * p.o_sh +
                  static_cast<int64_t>(pos) * p.o_ss + 2 * t;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) {
      if (8 * nd + 2 * t < p.D)  // D is even: the pair is whole
        *reinterpret_cast<float2*>(orow + 8 * nd) =
            make_float2(acc[nd][2 * half] * inv, acc[nd][2 * half + 1] * inv);
    }
  }
}

// the bytes of shared memory a block of KD steps and RG row groups takes,
// and its stages
inline void smem_plan(int KD, int RG, int& smem, int& stages) {
  const int dp = 8 * KD;
  const int q_bytes = static_cast<int>(sizeof(float)) * RG * 16 * pitch_qk(dp);
  const int stage_bytes =
      static_cast<int>(sizeof(float)) * kKeys * (pitch_qk(dp) + pitch_v(dp));
  // three stages where the block then leaves room for a second one an SM
  stages = q_bytes + 3 * stage_bytes <= 113 * 1024 ? 3 : 2;
  smem = q_bytes + stages * stage_bytes;
}

template <int KD, int KS, int RG>
int launch(Params p, dim3 grid, cudaStream_t stream) {
  int smem = 0;
  smem_plan(KD, RG, smem, p.stages);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fp32_kernel<KD, KS, RG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fp32_kernel<KD, KS, RG><<<grid, RG * KS * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The forms a head dim of KD steps is built in: one or two warps a row
// group, in blocks of 4 row groups, or of 5 where a block fills an SM
// (KD >= 24)
template <int KD>
int launch_plan(const Params& p, dim3 grid, int ks, int rg,
                cudaStream_t stream) {
  if (rg == 5) {
    if constexpr (KD >= 24)
      return ks == 2 ? launch<KD, 2, 5>(p, grid, stream)
                     : launch<KD, 1, 5>(p, grid, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return ks == 2 ? launch<KD, 2, 4>(p, grid, stream)
                 : launch<KD, 1, 4>(p, grid, stream);
}

}  // namespace

// Strides in elements (batch, head, position; the head dim is contiguous).
// kv_len and prefix_len: [B] int32 or null; prefix_len widens the causal
// mask only. A block takes rows = 64 or 80 query rows (4 or 5 row groups;
// 80 only for D > 128) as (position, head) pairs of hpb heads of a KV
// group (a power of two dividing rows and H / KV); the grid is (gx
// position tiles of rows / hpb, gy = H / hpb, gz = B), as
// ops/attention.py gives it (`fp32_rows`, `flash_plan`), with ks (1 or 2)
// warps a row group (`fp32_key_split`). o's rows must be 8-byte aligned
// (the wrapper allocates it). lse: [B, H, Sq] contiguous fp32, or null.
extern "C" int vlm_flash_attention_fp32(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const int* kv_len,
    const int* prefix_len, int B, int H, int KV, int Sq, int Sk, int D,
    int hpb, int gx, int gy, int gz, int ks, int rows,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
    int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb,
    int64_t o_sh, int64_t o_ss, float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      D <= 0 || D > kMaxD || D % 2 || (rows != 64 && rows != 80) ||
      hpb <= 0 || rows % hpb || (hpb & (hpb - 1)) || (H / KV) % hpb ||
      gy * hpb != H || gz != B ||
      static_cast<int64_t>(gx) * (rows / hpb) < Sq || (ks != 1 && ks != 2) ||
      reinterpret_cast<uintptr_t>(o) % 8 || o_sb % 2 || o_sh % 2 || o_ss % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int lhpb = 0;
  while ((1 << lhpb) < hpb) ++lhpb;
  const Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<float*>(o), lse,
                 kv_len,
                 causal ? prefix_len : nullptr, H, KV, Sq, Sk, D, causal,
                 lhpb, rows / hpb, 0,
                 vlm::copy_width_f32(q, D, q_sb, q_sh, q_ss),
                 vlm::copy_width_f32(k, D, k_sb, k_sh, k_ss),
                 vlm::copy_width_f32(v, D, v_sb, v_sh, v_ss), q_sb, q_sh,
                 q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                 scale * 1.4426950408889634f};
  const dim3 grid(gx, gy, gz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rg = rows / 16;
  // the head dim padded to 8 KD: exact for the path's 64, 72, 88, 128, 256
  const int kd = (D + 7) / 8;
  if (kd <= 4) return launch_plan<4>(p, grid, ks, rg, st);
  if (kd <= 8) return launch_plan<8>(p, grid, ks, rg, st);
  if (kd <= 9) return launch_plan<9>(p, grid, ks, rg, st);
  if (kd <= 11) return launch_plan<11>(p, grid, ks, rg, st);
  if (kd <= 16) return launch_plan<16>(p, grid, ks, rg, st);
  if (kd <= 24) return launch_plan<24>(p, grid, ks, rg, st);
  return launch_plan<32>(p, grid, ks, rg, st);
}
