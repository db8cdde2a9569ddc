// B1-diff backward, fp32 form: dq, dk and dv of o = softmax(q k^T d^-1/2) v
// for the towers that probing trains end to end (CLIP-L D = 64, SigLIP 72,
// EVA 88; also 128).
//
// Replaces the backward of vlm_tpu/ops/attention.py `_flash_attention_diff`
// (`_flash_diff_bwd`, which differentiates `_xla_attention`: vlm_tpu has no
// Pallas backward); its plain version is FlashAttentionFn's recompute
// (ops/attention.py), and testing/attention_grad.py renders this kernel's
// formulation in plain tensor operations. Inputs: q [B, H, Sq, D], k/v
// [B, KV, Sk, D], o and dO as q, with any strides and a contiguous head dim;
// lse [B, H, Sq], the forward's natural-log sum of exp of each row's scaled,
// masked scores (flash_attention_fp32.cu writes it). Masks: none or causal
// with the diagonal at the end of the kv axis. A row with no live key
// (causal, Sq > Sk) softmaxes -1e30 everywhere to uniform weights 1 / Sk in
// the plain version, and the mask blocks its scores' gradient: here P =
// 1 / Sk and dS = 0 for it.
//
// What bounds it on the H100: operations, as the forward. Five products of
// 2 Sq Sk D each (the scores' recompute, dP = dO V^T, dV = P^T dO, dK = dS^T
// Q, dQ = dS K) at fp32 accuracy, each three TF32 mma.sync products
// (common.cuh: split_tf32, mma1688_tf32), as flash_attention_fp32.cu. The
// design (FlashAttention-2's backward, made deterministic), three launches:
// - Pass (a), `delta_kernel`: delta_i = rowsum(dO_i o O_i), a warp a row.
// - Pass (b), `dkv_kernel`: one block of 4 warps per 64-key tile of one
//   (batch, KV head), 16 keys a warp; K and V stay in shared memory, dK and
//   dV in registers. Q, dO, lse and delta tiles of 32 rows (16 from D = 88)
//   stream through a two-stage cp.async ring, over every head of the KV
//   head's group in turn (so grouped heads sum into dK and dV inside the
//   block, in a fixed order): S^T = K Q^T, P^T = exp(S^T - lse), dV +=
//   P^T dO, dP^T = V dO^T, dS^T = P^T o (dP^T - delta), dK += dS^T Q; dS
//   goes to a workspace [B, H, Sq, Sk] (fp32, one score matrix: less than
//   the recompute held). Causal blocks skip the row tiles that see none of
//   their keys (pass (c) masks what they leave unwritten).
// - Pass (c), `dq_kernel`: one block of 4 warps per 64 query rows of one
//   (batch, head), 16 rows a warp: dQ += dS K over 32-key tiles of dS and
//   K through the ring, dQ in registers. Reading dS back costs a write and
//   a read of it; recomputing S and dP here instead (FlashAttention-2's
//   pass) took more than twice as long at CLIP-L's shape (PERF.md).
//   No atomics: every run gives the same bits.
// - Fragments. Products over the head dim take k position t as dim t and
//   t + 4 (the natural order); products over keys or rows take the S^T
//   accumulator as the A fragment as it stands, with k position t as
//   element 2t and t + 4 as 2t + 1 (the forward's P V trick), so B's
//   fragment is rows 2t and 2t + 1, column g. Pass (b)'s tiles have the
//   pitch D + 4 (= 4 mod 8 floats): both read patterns, rows g at columns
//   t and rows 2t at columns g, fall in distinct banks; pass (c) reads dS
//   rows g at columns t (pitch = 4 mod 8) and K rows t at columns g
//   (pitch = 8 mod 32).
// - Head dims: built for D = 64, 72, 88 and 128 (8 KD columns, no padding,
//   no bound checks inside the loops); any other D is refused.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRowsC = 64;     // pass (c): query rows a block
constexpr int kKeysC = 32;     // pass (c): keys a dS/K tile of its ring
constexpr int kKeysB = 64;     // pass (b): keys a block
// the ring's stages: two (three held fewer blocks an SM and ran slower)
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int pitch(int dp) { return dp + 4; }
// a pitch = 8 (mod 32) floats: rows t at columns g fall in distinct banks
__host__ __device__ constexpr int pitch8(int dp) {
  return dp + (40 - dp % 32) % 32;
}

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* lse;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  float* delta;  // [B, H, Sq]: rowsum(dO o O), pass (a) writes it
  float* ds;     // [B, H, Sq, ld_ds]: dS, pass (b) writes it
  int64_t ld_ds;  // Sk rounded up to 4
  int H, KV, G, Sq, Sk, D, causal, wq, wk, wv, wdo;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
      o_ss, do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss,
      dv_sb, dv_sh, dv_ss;
  float scale;   // D^-1/2
  float scale2;  // D^-1/2 log2(e): scores in base 2
  float inv_sk;  // 1 / Sk: a dead row's weights
};

// c[NT tiles of 8 columns] (16 x 8 NT) += A (16 x 8 KD) . B^T, B's rows the
// columns of c: the three TF32 terms, term by term over the n-tiles, the
// small terms in cl, hi.hi in ch. a: this lane's A element (row g, col t);
// b: this lane's B element (row g of n-tile 0, col t); both at pitch vp.
template <int KD, int NT>
__device__ __forceinline__ void dot_rows(float (&cl)[NT][4],
                                         float (&ch)[NT][4],
                                         const float* a, const float* b,
                                         int vp) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) cl[n][e] = ch[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
    vlm::split_tf32(a[8 * kk], ah[0], al[0]);
    vlm::split_tf32(a[8 * vp + 8 * kk], ah[1], al[1]);
    vlm::split_tf32(a[8 * kk + 4], ah[2], al[2]);
    vlm::split_tf32(a[8 * vp + 8 * kk + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      vlm::split_tf32(b[8 * n * vp + 8 * kk], bh[n][0], bl[n][0]);
      vlm::split_tf32(b[8 * n * vp + 8 * kk + 4], bh[n][1], bl[n][1]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) vlm::mma1688_tf32(cl[n], al, bh[n][0], bh[n][1]);
#pragma unroll
    for (int n = 0; n < NT; ++n) vlm::mma1688_tf32(cl[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
    for (int n = 0; n < NT; ++n) vlm::mma1688_tf32(ch[n], ah, bh[n][0], bh[n][1]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ch[n][e] += cl[n][e];
}

// acc (16 x 8 KD) += W (16 x 8 NT, an accumulator of dot_rows as it
// stands) . X (8 NT rows x 8 KD): k position t is W's column 2t and t + 4
// its column 2t + 1, so B's fragment is X's rows 2t and 2t + 1. x: this
// lane's X element (row 2t, col g) at pitch vp. Four output tiles at a
// time, term by term. The call's product sums in a fresh accumulator,
// added to acc by fp32 adds: the tensor core's own accumulation truncates,
// and over dK's chain of G Sq rows that bias alone took a G = 8 case past
// FP32_TOL.
template <int KD, int NT>
__device__ __forceinline__ void acc_rows(float (&acc)[KD][4],
                                         const float (&w)[NT][4],
                                         const float* x, int vp) {
  float c[KD][4];
#pragma unroll
  for (int j = 0; j < KD; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t ah[4], al[4];
    vlm::split_tf32(w[n][0], ah[0], al[0]);
    vlm::split_tf32(w[n][2], ah[1], al[1]);
    vlm::split_tf32(w[n][1], ah[2], al[2]);
    vlm::split_tf32(w[n][3], ah[3], al[3]);
#pragma unroll
    for (int nd0 = 0; nd0 < KD; nd0 += 4) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (nd0 + j >= KD) break;
        vlm::split_tf32(x[8 * n * vp + 8 * (nd0 + j)], bh[j][0], bl[j][0]);
        vlm::split_tf32(x[(8 * n + 1) * vp + 8 * (nd0 + j)], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (nd0 + j < KD) vlm::mma1688_tf32(c[nd0 + j], al, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (nd0 + j < KD) vlm::mma1688_tf32(c[nd0 + j], ah, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (nd0 + j < KD) vlm::mma1688_tf32(c[nd0 + j], ah, bh[j][0], bh[j][1]);
    }
  }
#pragma unroll
  for (int j = 0; j < KD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += c[j][e];
}

// rows [r0, r0 + 16) of a 16 x 8 KD accumulator (the C layout: rows g and g
// + 8, columns 2t and 2t + 1 of each 8-column tile) times s into dst (pitch
// ld elements, rows past n skipped); dst's rows are 8-byte aligned
template <int KD>
__device__ __forceinline__ void store_rows(float* dst, int64_t ld, int n,
                                           const float (&acc)[KD][4],
                                           float s, int g, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (g + 8 * half >= n) continue;
    float* row = dst + (g + 8 * half) * ld + 2 * t;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd)
      *reinterpret_cast<float2*>(row + 8 * nd) =
          make_float2(acc[nd][2 * half] * s, acc[nd][2 * half + 1] * s);
  }
}

// Pass (a): delta = rowsum(dO o O) of 8 rows a block, a warp a row.
__global__ void __launch_bounds__(256) delta_kernel(const Params p) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int pos = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (pos >= p.Sq) return;
  const float* orow = p.o + b * p.o_sb + h * p.o_sh +
                      static_cast<int64_t>(pos) * p.o_ss;
  const float* drow = p.dout + b * p.do_sb + h * p.do_sh +
                      static_cast<int64_t>(pos) * p.do_ss;
  float s = 0.f;
  for (int d = lane; d < p.D; d += 32) s += orow[d] * drow[d];
  s = vlm::warp_sum(s);
  if (lane == 0)
    p.delta[(static_cast<int64_t>(b) * p.H + h) * p.Sq + pos] = s;
}

// Pass (c): dQ = dS K d^-1/2 of 64 query rows of head blockIdx.y, dS from
// pass (b) (a masked key reads as 0: causal blocks of pass (b) leave some
// unwritten).
template <int KD>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params p) {
  constexpr int dp = 8 * KD, kp = pitch8(dp), sp = pitch(kKeysC);
  extern __shared__ __align__(16) float sm[];
  constexpr int stage = kRowsC * sp + kKeysC * kp;  // dS [64][sp], K [32][kp]
  const int b = blockIdx.z, h = blockIdx.y, kvh = h / p.G;
  const int p0 = blockIdx.x * kRowsC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int off = p.Sk - p.Sq;
  const int rows = min(kRowsC, p.Sq - p0);
  // the keys any row of the block sees (none where every row is dead)
  const int keys =
      p.causal ? min(max(p0 + rows + off, 0), p.Sk) : p.Sk;
  const int nt = (keys + kKeysC - 1) / kKeysC;
  const float* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const float* dsb =
      p.ds + ((static_cast<int64_t>(b) * p.H + h) * p.Sq + p0) * p.ld_ds;
  auto load = [&](int tile, int s) {
    const int k0 = tile * kKeysC, valid = min(kKeysC, p.Sk - k0);
    const int chunks = (valid + 3) / 4;  // 16-byte copies a row
    float* st = sm + s * stage;
    for (int i = threadIdx.x; i < kRowsC * (kKeysC / 4); i += kThreads) {
      const int r = i / (kKeysC / 4), c = i % (kKeysC / 4);
      const bool ok = r < rows && c < chunks;
      vlm::cp_async16(st + r * sp + 4 * c,
                      ok ? dsb + r * p.ld_ds + k0 + 4 * c : dsb, ok);
    }
    vlm::load_rows_f32(st + kRowsC * sp, kp,
                       kb + static_cast<int64_t>(k0) * p.k_ss, p.k_ss,
                       kKeysC, valid, p.D, p.wk);
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) load(s, s);
    vlm::cp_async_commit();
  }
  // this lane's rows g and g + 8 of the warp's 16: their key limits
  const int r0 = warp * 16;
  const int lim0 = p.causal ? p0 + r0 + g + off + 1 : p.Sk;
  const int lim1 = lim0 + (p.causal ? 8 : 0);
  float acc[KD][4];
#pragma unroll
  for (int i = 0; i < KD; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int i = 0; i < nt; ++i) {
    const int next = i + kStages - 1;
    if (next < nt) load(next, next % kStages);
    vlm::cp_async_commit();
    vlm::cp_async_wait<kStages - 1>();
    __syncthreads();  // tile i landed for every warp
    const float* st = sm + (i % kStages) * stage;
    const float* kt = st + kRowsC * sp;
    const int k0 = i * kKeysC;
    // this tile's product in a fresh accumulator (see acc_rows)
    float c[KD][4];
#pragma unroll
    for (int j = 0; j < KD; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKeysC / 8; ++kk) {
      // A: dS rows g and g + 8, keys t and t + 4 of this k-step
      const int ka = k0 + 8 * kk + t, kc = ka + 4;
      const float* ar = st + (r0 + g) * sp + 8 * kk + t;
      uint32_t ah[4], al[4];
      vlm::split_tf32(ka < lim0 ? ar[0] : 0.f, ah[0], al[0]);
      vlm::split_tf32(ka < lim1 ? ar[8 * sp] : 0.f, ah[1], al[1]);
      vlm::split_tf32(kc < lim0 ? ar[4] : 0.f, ah[2], al[2]);
      vlm::split_tf32(kc < lim1 ? ar[8 * sp + 4] : 0.f, ah[3], al[3]);
      // B: K rows t and t + 4, column g of each 8-column tile
      const float* br = kt + (8 * kk + t) * kp + g;
#pragma unroll
      for (int nd0 = 0; nd0 < KD; nd0 += 4) {
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (nd0 + j >= KD) break;
          vlm::split_tf32(br[8 * (nd0 + j)], bh[j][0], bl[j][0]);
          vlm::split_tf32(br[4 * kp + 8 * (nd0 + j)], bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nd0 + j < KD) vlm::mma1688_tf32(c[nd0 + j], al, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nd0 + j < KD) vlm::mma1688_tf32(c[nd0 + j], ah, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nd0 + j < KD) vlm::mma1688_tf32(c[nd0 + j], ah, bh[j][0], bh[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < KD; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += c[j][e];
    __syncthreads();  // every warp is done with this stage
  }
  vlm::cp_async_wait<0>();
  store_rows<KD>(p.dq + b * p.dq_sb + h * p.dq_sh +
                     static_cast<int64_t>(p0 + r0) * p.dq_ss,
                 p.dq_ss, rows - r0, acc, p.scale, g, t);
}

// Pass (b): dK and dV of 64 keys of KV head blockIdx.y (NR: 8-row n-tiles
// of a row tile). At D = 64 three blocks an SM: faster than two, though
// ptxas then spills a few registers (PERF.md).
template <int KD, int NR>
__global__ void __launch_bounds__(kThreads, KD == 8 ? 3 : 1)
dkv_kernel(const Params p) {
  constexpr int dp = 8 * KD, vp = pitch(dp);
  constexpr int kRows = 8 * NR;  // rows a step
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                     // [64][vp]
  float* vs = ks + kKeysB * vp;       // [64][vp]
  float* ring = vs + kKeysB * vp;     // 2 x (Q, dO [kRows][vp], lse, delta [kRows])
  constexpr int stage = 2 * kRows * vp + 2 * kRows;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int k0 = blockIdx.x * kKeysB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int off = p.Sk - p.Sq;
  const int nkeys = min(kKeysB, p.Sk - k0);

  vlm::load_rows_f32(ks, vp, p.k + b * p.k_sb + kvh * p.k_sh +
                                 static_cast<int64_t>(k0) * p.k_ss,
                     p.k_ss, kKeysB, nkeys, p.D, p.wk);
  vlm::load_rows_f32(vs, vp, p.v + b * p.v_sb + kvh * p.v_sh +
                                 static_cast<int64_t>(k0) * p.v_ss,
                     p.v_ss, kKeysB, nkeys, p.D, p.wv);
  // the row tiles: from the first row that sees key k0 (from row 0 where
  // a causal row has no live key: its weights cover every key)
  int first = 0;
  if (p.causal && off >= 0) first = max(k0 - off, 0) / kRows;
  const int ntr = (p.Sq + kRows - 1) / kRows - first;
  const int steps = p.G * ntr;
  const int64_t row_b = static_cast<int64_t>(b) * p.H;
  auto load = [&](int step, int s) {
    const int h = kvh * p.G + step / ntr;
    const int r0 = (first + step % ntr) * kRows;
    const int valid = min(kRows, p.Sq - r0);
    float* qt = ring + s * stage;
    float* dt = qt + kRows * vp;
    float* lt = dt + kRows * vp;
    vlm::load_rows_f32(qt, vp, p.q + b * p.q_sb + h * p.q_sh +
                                   static_cast<int64_t>(r0) * p.q_ss,
                       p.q_ss, kRows, valid, p.D, p.wq);
    vlm::load_rows_f32(dt, vp, p.dout + b * p.do_sb + h * p.do_sh +
                                   static_cast<int64_t>(r0) * p.do_ss,
                       p.do_ss, kRows, valid, p.D, p.wdo);
    const int64_t base = (row_b + h) * p.Sq + r0;
    for (int i = threadIdx.x; i < 2 * kRows; i += kThreads) {
      const int r = i % kRows;
      const bool ok = r < valid;
      const float* src = i < kRows ? p.lse + base + r : p.delta + base + r;
      vlm::cp_async_small<4>(lt + i, ok ? src : p.lse, ok);
    }
  };
  // K and V ride in the first group, with step 0
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    vlm::cp_async_commit();
  }

  float dk[KD][4], dv[KD][4];
#pragma unroll
  for (int i = 0; i < KD; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  // this lane's keys (the accumulators' rows g and g + 8 of the warp's 16)
  const int kw = warp * 16;
  const int key0 = k0 + kw + g, key1 = key0 + 8;
  const float* ka = ks + (kw + g) * vp + t;
  const float* va = vs + (kw + g) * vp + t;

  for (int i = 0; i < steps; ++i) {
    const int next = i + kStages - 1;
    if (next < steps) load(next, next % kStages);
    vlm::cp_async_commit();
    vlm::cp_async_wait<kStages - 1>();
    __syncthreads();  // step i (and K, V) landed for every warp
    const float* qt = ring + (i % kStages) * stage;
    const float* dt = qt + kRows * vp;
    const float* lt = dt + kRows * vp;
    const float* delt = lt + kRows;
    const int r0 = (first + i % ntr) * kRows;

    // S^T [16 keys x kRows rows]: element (key g / g + 8, row 8n + 2t (+1))
    float sl[NR][4], s[NR][4];
    dot_rows<KD, NR>(sl, s, ka, qt + g * vp + t, vp);
#pragma unroll
    for (int n = 0; n < NR; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = 8 * n + 2 * t + (e & 1), pos = r0 + rr;
        const int kj = e < 2 ? key0 : key1;
        float pr = 0.f;
        if (pos < p.Sq && kj < p.Sk) {
          if (p.causal && pos + off < 0) pr = p.inv_sk;  // a dead row
          else if (!p.causal || kj <= pos + off)
            pr = exp2f(s[n][e] * p.scale2 - lt[rr] * kLog2e);
        }
        s[n][e] = pr;
      }
    acc_rows<KD, NR>(dv, s, dt + 2 * t * vp + g, vp);
    float dpl[NR][4], dpv[NR][4];
    dot_rows<KD, NR>(dpl, dpv, va, dt + g * vp + t, vp);
#pragma unroll
    for (int n = 0; n < NR; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = 8 * n + 2 * t + (e & 1), pos = r0 + rr;
        // a dead row's scores get no gradient
        const bool dead = p.causal && pos + off < 0;
        s[n][e] = dead ? 0.f : s[n][e] * (dpv[n][e] - delt[rr]);
      }
    {
      // dS to the workspace for pass (c): a row's 8 keys of a lane
      // quartet in one 32-byte sector
      const int h = kvh * p.G + i / ntr;
      float* dsb = p.ds + (row_b + h) * p.Sq * p.ld_ds;
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = r0 + 8 * n + 2 * t + (e & 1);
          const int kj = e < 2 ? key0 : key1;
          if (pos < p.Sq && kj < p.Sk)
            dsb[static_cast<int64_t>(pos) * p.ld_ds + kj] = s[n][e];
        }
    }
    acc_rows<KD, NR>(dk, s, qt + 2 * t * vp + g, vp);
    __syncthreads();  // every warp is done with this stage
  }
  vlm::cp_async_wait<0>();

  const int mine = nkeys - kw;
  store_rows<KD>(p.dk + b * p.dk_sb + kvh * p.dk_sh +
                     static_cast<int64_t>(k0 + kw) * p.dk_ss,
                 p.dk_ss, mine, dk, p.scale, g, t);
  store_rows<KD>(p.dv + b * p.dv_sb + kvh * p.dv_sh +
                     static_cast<int64_t>(k0 + kw) * p.dv_ss,
                 p.dv_ss, mine, dv, 1.f, g, t);
}

template <typename Kernel>
int launch_one(Kernel kernel, const Params& p, dim3 grid, int smem,
               cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int KD, int NR>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int vp = pitch(8 * KD);
  constexpr int f = static_cast<int>(sizeof(float));
  delta_kernel<<<dim3((p.Sq + 7) / 8, p.H, B), 256, 0, stream>>>(p);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  {
    const int fixed = f * 2 * kKeysB * vp,
              stage = f * (2 * 8 * NR * vp + 2 * 8 * NR);
    const dim3 grid((p.Sk + kKeysB - 1) / kKeysB, p.KV, B);
    rc = launch_one(dkv_kernel<KD, NR>, p, grid, fixed + kStages * stage,
                    stream);
    if (rc != 0) return rc;
  }
  const int stage = f * (kRowsC * pitch(kKeysC) + kKeysC * pitch8(8 * KD));
  const dim3 grid((p.Sq + kRowsC - 1) / kRowsC, p.H, B);
  return launch_one(dq_kernel<KD>, p, grid, kStages * stage, stream);
}

}  // namespace

// Strides in elements (batch, head, position; the head dim is contiguous).
// lse: [B, H, Sq] contiguous, from the forward; delta: [B, H, Sq] and ds:
// [B, H, Sq, ld_ds] (ld_ds = Sk rounded up to 4, 16-byte aligned) scratch.
// dq, dk, dv are written whole (no zeroing needed); their rows must be
// 8-byte aligned. Three launches on the stream: passes (a), (b), (c).
extern "C" int vlm_flash_attention_fp32_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* delta, float* ds, int64_t ld_ds, int B, int H, int KV, int Sq,
    int Sk, int D,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
    int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb,
    int64_t o_sh, int64_t o_ss, int64_t do_sb, int64_t do_sh, int64_t do_ss,
    int64_t dq_sb, int64_t dq_sh, int64_t dq_ss, int64_t dk_sb, int64_t dk_sh,
    int64_t dk_ss, int64_t dv_sb, int64_t dv_sh, int64_t dv_ss, float scale,
    int causal, void* stream) {
  const uintptr_t out_align = reinterpret_cast<uintptr_t>(dq) |
                              reinterpret_cast<uintptr_t>(dk) |
                              reinterpret_cast<uintptr_t>(dv);
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      (D != 64 && D != 72 && D != 88 && D != 128) || out_align % 8 ||
      ld_ds < Sk || ld_ds % 4 || reinterpret_cast<uintptr_t>(ds) % 16 ||
      (dq_sb | dq_sh | dq_ss | dk_sb | dk_sh | dk_ss | dv_sb | dv_sh | dv_ss) % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<const float*>(o), lse,
           static_cast<const float*>(dout), static_cast<float*>(dq),
           static_cast<float*>(dk), static_cast<float*>(dv), delta, ds, ld_ds,
           H, KV, H / KV, Sq, Sk, D, causal,
           vlm::copy_width_f32(q, D, q_sb, q_sh, q_ss),
           vlm::copy_width_f32(k, D, k_sb, k_sh, k_ss),
           vlm::copy_width_f32(v, D, v_sb, v_sh, v_ss),
           vlm::copy_width_f32(dout, D, do_sb, do_sh, do_ss),
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
           o_ss, do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh,
           dk_ss, dv_sb, dv_sh, dv_ss, scale, scale * kLog2e,
           1.f / static_cast<float>(Sk)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<8, 4>(p, B, st);
    case 72: return launch<9, 4>(p, B, st);
    case 88: return launch<11, 2>(p, B, st);
    default: return launch<16, 2>(p, B, st);
  }
}
