// The row design of K1's streamed-pair-bias backward for Hopper, sm_90a, at
// 32 heads (ipa_attention_bwd_tc.cu) and at a tensor-parallel rank's 16
// (ipa_attention_bwd_tc16.cu): one template over the model dtype T and the
// head count H, with its launch. Each including source states its bound,
// its times, its shared memory and its C entries.
//
// Three kernels and a bmm a call, all deterministic (no atomics, every sum
// in a fixed order): bwd_dv (the value terms), bwd_rows (the row sweeps),
// bwd_cols (the column sums; it and bwd_dv are ipa_attention_bwd_common.cuh's,
// shared with the 8-head design), and after them the torch.bmm for d_w_pv.
// * bwd_dv: dv = ct_s . v_s + ct_p . v_p for every (row, head, column), f32
//   on CUDA cores, a thread a key column with its 40 values in registers, 16
//   query rows a block. Inside the row kernel's first sweep these loads (128
//   B a head and column in bf16) made the sweep twice as long.
// * bwd_rows: a block owns TI=2 query rows of one batch element for all H
//   heads, so each staged x2d tile serves every head, and is 256 threads, two
//   blocks an SM (at most 128 registers a thread, at most 113 KB of shared
//   memory a block), so one block's barriers and waits hide behind the
//   other's work.
// * g = ct_pr @ w_pv^T is formed at the row kernel's set-up, the block's two
//   rows in f32 on CUDA cores, kThreads / H threads a head; no f32 [H, B,
//   Lq, Cp] tensor goes through device memory for it.
// * Outside the products (sweeps 1 and 3) a warp takes its H / 8 heads two
//   at a time, its lanes a head by 16 consecutive columns, and a thread
//   serves both rows: each key-side value it loads feeds two rows, and a
//   warp's loads of a head cover 16 neighbouring columns. More rows a block
//   would need more of g in shared memory than two blocks leave at 32 heads
//   (67 KB at TI=2); staging the key side, 106 KB a 16-column tile in bf16,
//   does not fit beside it. So the key side and pa are read from L2, in
//   sweeps without barriers, each load issued unconditionally (at the last
//   column past Lk) so that no load waits behind a branch.
// * One pass over x2d: G (C2) and d_x2d (C3) need no D, so the sweep that
//   aggregates wx2d (C1) takes them too, keeps dphat = dv + G in scratch and
//   writes d_x2d once; a sweep without x2d then takes ds once D is known.
//   x2d is read once, so its copies carry an L2 evict-first policy, and the
//   outputs no pass reads again (d_x2d, d_pa, wx2d) are streaming stores,
//   which keep the key side and the kept logits in L2 for sweep 3.
// * The x2d tile is staged by cp.async, zero-filled past Lq and Lk: two
//   stages in bf16 (the next tile is copied under this tile's products), one
//   in f32 (copied under dphat and the next tile's weights).
// bwd_rows makes three sweeps over key tiles of TJ=16 columns:
//   1. statistics: the row max and sum of exp, online, from the logits alone
//      (with pa streamed the logits need no x2d); the logits kept;
//   2. a from the kept logits; on tensor cores wx2d = sum_j a x2d (C1), G =
//      g.x2d (C2) and d_x2d = sum_h a g (C3, written once); dphat = dv + G
//      kept. After it D = sum_j a dv + g.wx2d;
//   3. ds = a (dphat - D), d_pa = pair_w ds, d_q_s and d_q_p summed over the
//      block's columns in registers.
//   Products, 8 warps: C1 and C3 a warp a row and a quarter of the channel
//   pairs; C2 a warp a (row, m16 tile of heads, n8 tile of columns), over
//   all of Cp at 32 heads and over half of it at 16 (4 such tiles for 8
//   warps: the two halves' sums added in a fixed order), its k-steps in turn
//   on four accumulators added in a fixed order. mma.sync with ldmatrix:
//   every product's M is 16 columns or 16 heads a row.
// Operands rounded on the tensor cores:
// * bf16: x2d is bf16 already and enters as it is. The f32 operands a and g
//   are each split into two bf16 terms (hi + lo, 16 significant bits): C1
//   a_hi X + a_lo X, C2 g_hi X + g_lo X, C3 a_hi g_hi + a_hi g_lo + a_lo g_hi
//   (the lo x lo term dropped). Each product carries about 2^-16 of itself,
//   sums are f32. One bf16 rounding of a (2^-9) would already spend the bf16
//   gradients' tolerance on D and d_w_pv.
// * f32: 3xTF32 (big + small TF32 terms, the small x small term dropped),
//   the split by truncation (split_tf32_trunc): some 2^-20 of each product.
// The plain product d_w_pv = wx2d^T ct_pr is left to torch.bmm after
// (ops/ipa_attention.py, as JAX leaves it to XLA), a bmm a (head, batch
// element) and the partials summed in order.
// Scratch in device memory, allocated by the caller: wx2d [H, B, Lq, Cp]
// f32; the logits, dv (then dphat) and ds [B, H, Lq, Lk] f32; the row
// statistics [B, H, Lq, 2] f32 (max, 1/sum).
//
// Shared memory of bwd_rows<T, H>, in bytes at Cp = 256: the x2d stages
// [TI][TJ][Cp + 8], two in bf16 and one in f32, 33,792 either way (the rows'
// q_s and q_p, 7,168 at 32 heads, over them in sweeps 1 and 3); g
// [TI][H][Cp + 8] as two bf16 terms or [TI][H][Cp + 4] f32, 67,584 / 66,560
// at 32 heads and half that at 16; the tile's a as two bf16 terms
// [TI][H][24] or f32 [TI][H][20]; the tile's G [TI][C2 split][H][TJ] f32,
// 4,096; the row warps' g . wx2d [TI][4][H] f32; the row statistics and D
// [TI][H][3] f32.

#pragma once

#include <type_traits>

#include "ipa_attention_bwd_common.cuh"

namespace {

constexpr int kTI = 2;                     // query rows a bwd_rows block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowWarps = kWarps / kTI;    // C1 / C3: warps a row
constexpr int kSlots = kMaxCp / 16 / kRowWarps;  // C1 / C3 channel pairs a warp at the widest Cp
constexpr int kKQ = 4;                     // C2: accumulators, a k-step each in turn
static_assert(kTI * kTJ == 32, "outside the products a lane a (row, column) of a tile");
// A (row, head)'s operands in shared memory, f32: q_s * scalar_w at 0, the
// query points (p * 3 + x) at kQp.
constexpr int kQp = kDK, kRowF = kQp + 12;
static_assert(kQp % 4 == 0 && kRowF % 4 == 0, "float4 rows");

// What the head count decides: the m16 tiles a row's heads fill, the heads
// a warp takes outside the products, the warps that share one C2 tile (each
// a part of Cp), and the threads a head at g's set-up.
template <int H>
struct Heads {
  static constexpr int kMT = H / 16;
  static constexpr int kHeadsAWarp = H / kWarps;
  static constexpr int kC2Split = kWarps / (kTI * kMT * (kTJ / 8));
  static constexpr int kGThreads = kThreads / H;
  static_assert(kMT >= 1 && H % 16 == 0 && kHeadsAWarp % 2 == 0, "heads in pairs a warp");
  static_assert(kRowWarps == 4 && kC2Split >= 1 && kC2Split <= 2 &&
                    kTI * kMT * (kTJ / 8) * kC2Split == kWarps,
                "C2: a warp a (row, m16 tile, n8 tile, part of Cp)");
  static_assert(kThreads % H == 0 && (kGThreads & (kGThreads - 1)) == 0 && H % kColHeads == 0,
                "g's set-up; the column kernel's warps");
};

template <typename T, int H>
constexpr int kStages = std::is_same<T, bf16>::value ? 2 : 1;  // x2d stages

// Shared memory of bwd_rows, byte offsets of its regions:
//   x2d stages  Stages x [TI][TJ][xs_stride] T  (from 0; in sweeps 1 and 3
//               the rows' operands [TI][H][RowF] f32: q_s * scalar_w,
//               q_p)
//   gs          terms x [TI][H][gs_stride] T    g = ct_pr @ w_pv^T
//   as          terms x [TI][H][APS] T          the tile's attention weights
//   gt          [TI][C2Split][H][TJ] f32        the tile's G, a part a warp
//   dxp         [TI][RowWarps][H] f32           g . wx2d, a part a warp
//   st          [TI][H][3] f32                  row max, 1/sum, D
template <typename T, int H>
struct RowLayout {
  int xs_stride, xs_stage, gs_stride;
  int gs, as, gt, dxp, st, total;
  __host__ __device__ explicit RowLayout(int Cp) {
    constexpr int kTerms = Tile<T>::kTerms, kSize = (int)sizeof(T);
    constexpr int kRowBytes = kTI * H * kRowF * 4;
    xs_stride = Cp + Tile<T>::kXsPad;
    xs_stage = kTI * kTJ * xs_stride * kSize;
    gs_stride = Cp + Tile<T>::kGsPad;
    gs = kStages<T, H> * xs_stage > kRowBytes ? kStages<T, H> * xs_stage : kRowBytes;
    as = gs + kTerms * kTI * H * gs_stride * kSize;
    gt = as + kTerms * kTI * H * Tile<T>::kAPS * kSize;
    dxp = gt + kTI * Heads<H>::kC2Split * H * kTJ * 4;
    st = dxp + kTI * kRowWarps * H * 4;
    total = st + kTI * H * 3 * 4;
  }
};

// The x2d rows (i0 + r, j0 + jj, :) of the tile into a stage, [TI][TJ] rows
// of stride elements, zero-filled past Lq and Lk.
template <typename T>
__device__ __forceinline__ void copy_x2d(T* xs, const T* x2d_b, int i0, int j0, int Lq, int Lk,
                                         int Cp, int stride, int tid, uint64_t policy) {
  constexpr int kC = Tile<T>::kChunk;
  const int per_row = Cp / kC;
  // Addresses made afresh each time: kept across the tile loop they took
  // 24 registers the products need.
#pragma unroll 1
  for (int e = tid; e < kTI * kTJ * per_row; e += kThreads) {
    const int c = e % per_row, rj = e / per_row, r = rj / kTJ, jj = rj % kTJ;
    const bool ok = i0 + r < Lq && j0 + jj < Lk;
    const T* src = ok ? x2d_b + ((size_t)(i0 + r) * Lk + j0 + jj) * Cp + c * kC : x2d_b;
    cp_async16_hint(xs + rj * stride + c * kC, src, ok ? 16 : 0, policy);
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, 2)
bwd_rows(const T* __restrict__ q_s, const T* __restrict__ k_s,
         const float* __restrict__ q_p, const float* __restrict__ k_p,
         const T* __restrict__ x2d, const float* __restrict__ bias, const T* __restrict__ pa,
         const float* __restrict__ ct_pr, const T* __restrict__ w_pv,
         T* __restrict__ d_qs, float* __restrict__ d_qp, T* __restrict__ d_x2d,
         T* __restrict__ d_pa, float* __restrict__ wx2d_out, float* __restrict__ ds_out,
         float* __restrict__ logits, float* __restrict__ dvals, float* __restrict__ stats_out,
         int B, int Lq, int Lk, int Cp, float scalar_w, float pair_w) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  constexpr int kAPS = Tile<T>::kAPS;
  constexpr int kMT = Heads<H>::kMT, kHeadsAWarp = Heads<H>::kHeadsAWarp;
  constexpr int kSplit = Heads<H>::kC2Split, kGT = Heads<H>::kGThreads;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const RowLayout<T, H> L(Cp);
  const int S = L.xs_stride, GS = L.gs_stride;
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = reinterpret_cast<T*>(smem + L.gs);  // bf16: hi [TI][H][GS], then lo
  T* as = reinterpret_cast<T*>(smem + L.as);  // bf16: hi [TI][H][APS], then lo
  float* gt = reinterpret_cast<float*>(smem + L.gt);
  float* dxp_sm = reinterpret_cast<float*>(smem + L.dxp);
  float* st_sm = reinterpret_cast<float*>(smem + L.st);
  float* rows_sm = reinterpret_cast<float*>(smem);  // sweeps 1 and 3, over the x2d stages
  const int xs_elems = kTI * kTJ * S;
  const int gs_elems = kTI * H * GS;
  const int as_elems = kTI * H * kAPS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, i0 = blockIdx.x * kTI;
  const int ntiles = (Lk + kTJ - 1) / kTJ;
  const T* x2d_b = x2d + (size_t)b * Lq * Lk * Cp;
  const size_t plane = (size_t)H * kNpts * Lk;
  const float* kp_b = k_p + (size_t)b * 3 * plane;
  const float* bias_b = bias + (size_t)b * Lk;

  // ---- the rows' operands into shared memory (rows past Lq: the last
  // row's, never stored).
  auto load_qp_rows = [&]() {
    for (int e = tid; e < kTI * H * 12; e += kThreads) {
      const int px = e % 12, h = (e / 12) % H, r = e / (12 * H);
      rows_sm[(r * H + h) * kRowF + kQp + px] =
          q_p[(((size_t)b * 3 + px % 3) * H * kNpts + h * kNpts + px / 3) * Lq +
              min(i0 + r, Lq - 1)];
    }
  };
  load_qp_rows();
  for (int e = tid; e < kTI * H * kDK; e += kThreads) {
    const int d = e % kDK, h = (e / kDK) % H, r = e / (kDK * H);
    rows_sm[(r * H + h) * kRowF + d] =
        to_f(q_s[(((size_t)b * H + h) * Lq + min(i0 + r, Lq - 1)) * kDK + d]) * scalar_w;
  }
  {
    // g = ct_pr @ w_pv^T of the block's rows (zero past Lq), in f32 on CUDA
    // cores: a thread takes head tid / kGT and channels tid % kGT + kGT k,
    // so kGT neighbouring threads read kGT neighbouring rows of w_pv[h] (an
    // L2-resident 8 kB a head in bf16, read by every block) and write kGT
    // neighbouring channels of g.
    const int h = tid / kGT;
    float ct[kTI][kDK];
#pragma unroll
    for (int r = 0; r < kTI; ++r) {
      if (i0 + r < Lq) {
        load16(ct_pr + (((size_t)b * H + h) * Lq + i0 + r) * kDK, ct[r]);
      } else {
#pragma unroll
        for (int d = 0; d < kDK; ++d) ct[r][d] = 0.f;
      }
    }
    const T* wh = w_pv + (size_t)h * Cp * kDK;
#pragma unroll 4
    for (int c = tid & (kGT - 1); c < Cp; c += kGT) {
      float w[kDK];
      load16(wh + (size_t)c * kDK, w);
#pragma unroll
      for (int r = 0; r < kTI; ++r) {
        float v = 0.f;
#pragma unroll
        for (int d = 0; d < kDK; ++d) v = fmaf(ct[r][d], w[d], v);
        const int o = (r * H + h) * GS + c;
        if constexpr (kBf) {
          bf16 hi, lo;
          split_bf16(v, hi, lo);
          gs[o] = hi;
          gs[gs_elems + o] = lo;
        } else {
          gs[o] = v;
        }
      }
    }
  }

  // ---- thread roles
  // Outside the products a warp owns heads kHeadsAWarp warp .. + kHeadsAWarp
  // - 1, one at a time (hp), and its lanes the block's two rows (ar) by a
  // tile's 16 columns (jl): a warp's loads of a head's key side cover 16
  // consecutive columns, each serving both rows.
  const int jl = lane & 15, ar = lane >> 4;
  const int ai = i0 + ar, ai_c = min(ai, Lq - 1);
  auto head = [&](int hp) { return warp * kHeadsAWarp + hp; };
  auto pa_row = [&](int h) { return (((size_t)b * H + h) * Lq + ai_c) * Lk; };
  // Products: row pr; C1 / C3 channel slot ce (pairs of n-tiles ce + 4 sl);
  // C2 m-tile cm (heads), n-tile cn (columns) and part kh of Cp's 32-channel
  // chunks (kh, kh + kSplit, ...): a row's warps split by m-tile at 32 heads,
  // by part at 16.
  const int pr = warp / kRowWarps, ce = warp % kRowWarps;
  const int cm = kMT == 2 ? (warp >> 1) & 1 : 0, kh = kSplit == 2 ? (warp >> 1) & 1 : 0;
  const int cn = warp & 1;
  const int g = lane >> 2, q = lane & 3;
  const int npairs = Cp / 16;

  // ================= sweep 1: row statistics; the logits kept =================
  // A thread a (head, column) of each tile for both rows: each key-side
  // value it loads serves two rows. A warp's heads in pairs, lanes hh (head
  // of the pair) by jl (column).
  const int hh = lane >> 4;
  __syncthreads();  // the rows' operands
#pragma unroll 1
  for (int hp2 = 0; hp2 < kHeadsAWarp / 2; ++hp2) {
    const int h = head(2 * hp2 + hh);
    const T* ks_bh = k_s + ((size_t)b * H + h) * Lk * kDK;
    size_t row[kTI];
    float m_run[kTI], l_run[kTI];
#pragma unroll
    for (int r = 0; r < kTI; ++r) {
      row[r] = (((size_t)b * H + h) * Lq + min(i0 + r, Lq - 1)) * Lk;
      m_run[r] = -1e30f;
      l_run[r] = 0.f;
    }
#pragma unroll 2
    for (int t = 0; t < ntiles; ++t) {
      const int j = t * kTJ + jl, jc = min(j, Lk - 1);
      KeyCol kc;
      load_key(kc, ks_bh, kp_b, plane, h, Lk, jc);
      const float bj = bias_b[jc];
      float pav[kTI];  // every load of the column issued before the arithmetic
#pragma unroll
      for (int r = 0; r < kTI; ++r) pav[r] = to_f(pa[row[r] + jc]);
#pragma unroll
      for (int r = 0; r < kTI; ++r) {
        const float* rs = rows_sm + (r * H + h) * kRowF;
        float s = logit_core(rs, rs + kQp, kc) + pair_w * pav[r] + bj;
        if (j >= Lk) s = -INFINITY;
        else if (i0 + r < Lq) logits[row[r] + j] = s;
        const float m_new = fmaxf(m_run[r], s);
        l_run[r] = l_run[r] * expf(m_run[r] - m_new) + expf(s - m_new);
        m_run[r] = m_new;
      }
    }
#pragma unroll
    for (int r = 0; r < kTI; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int o = 1; o < kTJ; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = l_run[r] * expf(m_run[r] - mx);
#pragma unroll
      for (int o = 1; o < kTJ; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (jl == 0) {
        st_sm[(r * H + h) * 3] = mx;
        st_sm[(r * H + h) * 3 + 1] = 1.f / sum;
        if (i0 + r < Lq)
          *reinterpret_cast<float2*>(stats_out + (((size_t)b * H + h) * Lq + i0 + r) * 2) =
              make_float2(mx, 1.f / sum);
      }
    }
  }

  // The kept logits (-inf past Lk) and dv of this thread's (row, head hp)
  // at column jl of tile t (rows past Lq read the last row's, written by
  // its own thread before the block's barrier). Past Lk the last column is
  // read and its value dropped: no load waits on a branch.
  auto fetch = [&](int t, float (&lg)[kHeadsAWarp], float (&dv)[kHeadsAWarp]) {
    const int j = t * kTJ + jl, jc = min(j, Lk - 1);
#pragma unroll
    for (int hp = 0; hp < kHeadsAWarp; ++hp) {
      const size_t row = pa_row(head(hp));
      lg[hp] = logits[row + jc];
      dv[hp] = dvals[row + jc];
    }
#pragma unroll
    for (int hp = 0; hp < kHeadsAWarp; ++hp) {
      lg[hp] = j < Lk ? lg[hp] : -INFINITY;
      dv[hp] = j < Lk ? dv[hp] : 0.f;
    }
  };

  // ================= sweep 2: C1, C2, C3 and dphat =================
  const uint64_t policy = evict_first_policy();
  auto copy_tile = [&](int t) {
    copy_x2d(xs + (t % kStages<T, H>) * xs_elems, x2d_b, i0, t * kTJ, Lq, Lk, Cp, S, tid,
             policy);
    cp_async_commit();
  };
  __syncthreads();  // sweep 1's reads of the cotangents; the kept logits and dv
  copy_tile(0);
  float acc1[kSlots][2][kMT][4];  // [slot][n-tile of the pair][m-tile][4]: wx2d
#pragma unroll
  for (int a = 0; a < kSlots; ++a)
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc1[a][x][m][k] = 0.f;
  float dv_run[kHeadsAWarp], lg[kHeadsAWarp], dvk[kHeadsAWarp];
#pragma unroll
  for (int hp = 0; hp < kHeadsAWarp; ++hp) dv_run[hp] = 0.f;
  fetch(0, lg, dvk);
  for (int t = 0; t < ntiles; ++t) {
    const int j0 = t * kTJ;
    // A: a of this thread's column into the tile's buffer; the next tile's
    // logits and dv fetched under the products.
#pragma unroll
    for (int hp = 0; hp < kHeadsAWarp; ++hp) {
      const float* st_h = st_sm + (ar * H + head(hp)) * 3;
      const float a = expf(lg[hp] - st_h[0]) * st_h[1];
      dv_run[hp] = fmaf(a, dvk[hp], dv_run[hp]);
      const int o = (ar * H + head(hp)) * kAPS + jl;
      if constexpr (kBf) {
        bf16 hi, lo;
        split_bf16(a, hi, lo);
        as[o] = hi;
        as[as_elems + o] = lo;
      } else {
        as[o] = a;
      }
    }
    float lg_n[kHeadsAWarp], dv_n[kHeadsAWarp];
    fetch(min(t + 1, ntiles - 1), lg_n, dv_n);
    cp_async_wait_all();
    __syncthreads();
    if (kStages<T, H> == 2 && t + 1 < ntiles) copy_tile(t + 1);
    const T* X = xs + (t % kStages<T, H>) * xs_elems + pr * kTJ * S;  // the row's x2d tile

    // C1: wx2d[pr][h][c] += a[pr][h][j] x2d[pr][j][c], the warp's channel pairs.
    if constexpr (kBf) {
      uint32_t ahi[kMT][4], alo[kMT][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const bf16* arow = as + (pr * H + m * 16 + (lane & 15)) * kAPS + (lane >> 4) * 8;
        ldmatrix_x4(ahi[m], arow);
        ldmatrix_x4(alo[m], arow + as_elems);
      }
      const bf16* xrow = X + ((lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 8;
#pragma unroll
      for (int sl = 0; sl < kSlots; ++sl) {
        const int p = ce + kRowWarps * sl;
        if (p < npairs) {
          uint32_t bx[4];
          ldmatrix_x4_trans(bx, xrow + p * 16);
#pragma unroll
          for (int m = 0; m < kMT; ++m) {
            mma_bf16(acc1[sl][0][m], ahi[m], bx[0], bx[1]);
            mma_bf16(acc1[sl][0][m], alo[m], bx[0], bx[1]);
            mma_bf16(acc1[sl][1][m], ahi[m], bx[2], bx[3]);
            mma_bf16(acc1[sl][1][m], alo[m], bx[2], bx[3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kTJ / 8; ++ks) {
        uint32_t ab[kMT][4], asm_[kMT][4];
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          const float* a0 = as + (pr * H + m * 16 + g) * kAPS + ks * 8 + q;
          split_tf32_trunc(a0[0], ab[m][0], asm_[m][0]);
          split_tf32_trunc(a0[8 * kAPS], ab[m][1], asm_[m][1]);
          split_tf32_trunc(a0[4], ab[m][2], asm_[m][2]);
          split_tf32_trunc(a0[8 * kAPS + 4], ab[m][3], asm_[m][3]);
        }
#pragma unroll
        for (int sl = 0; sl < kSlots; ++sl) {
          const int p = ce + kRowWarps * sl;
          if (p < npairs) {
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const float* xk = X + (ks * 8 + q) * S + (2 * p + x) * 8 + g;
              uint32_t bb0, bs0, bb1, bs1;
              split_tf32_trunc(xk[0], bb0, bs0);
              split_tf32_trunc(xk[4 * S], bb1, bs1);
#pragma unroll
              for (int m = 0; m < kMT; ++m)
                mma_3xtf32(acc1[sl][x][m], ab[m], asm_[m], bb0, bb1, bs0, bs1);
            }
          }
        }
      }
    }

    // C2: G[pr][h][j] = sum_c g[pr][h][c] x2d[pr][j][c], the warp's m16 x n8
    // tile over its part of Cp: four accumulators take the k-steps in turn
    // (four independent mma chains), added in a fixed order.
    {
      float acc2[kKQ][4];
#pragma unroll
      for (int k = 0; k < kKQ; ++k) acc2[k][0] = acc2[k][1] = acc2[k][2] = acc2[k][3] = 0.f;
      const T* Xc = X + cn * 8 * S;
      if constexpr (kBf) {
        const bf16* grow = gs + (pr * H + cm * 16 + (lane & 15)) * GS + (lane >> 4) * 8;
        const bf16* xrow = Xc + (lane & 7) * S + (lane >> 3) * 8;
        // 32 channels (two k-steps) at a time, into accumulators 2 (k2 & 1)
        // and 2 (k2 & 1) + 1; the warp's chunks 2 kh, 2 kh + 1, then 2 kSplit
        // further on.
        for (int k4 = 2 * kh; k4 < Cp / 32; k4 += 2 * kSplit) {
#pragma unroll
          for (int k2 = 0; k2 < 2; ++k2) {
            if (k4 + k2 < Cp / 32) {
              uint32_t bx[4];  // k-steps 2 (k4 + k2) (bx[0], bx[1]) and the next (bx[2], bx[3])
              ldmatrix_x4(bx, xrow + (k4 + k2) * 32);
#pragma unroll
              for (int kk = 0; kk < 2; ++kk) {
                const int ks = 2 * (k4 + k2) + kk;
                uint32_t ghi[4], glo[4];
                ldmatrix_x4(ghi, grow + ks * 16);
                ldmatrix_x4(glo, grow + gs_elems + ks * 16);
                mma_bf16(acc2[2 * k2 + kk], glo, bx[2 * kk], bx[2 * kk + 1]);
                mma_bf16(acc2[2 * k2 + kk], ghi, bx[2 * kk], bx[2 * kk + 1]);
              }
            }
          }
        }
      } else {
        const float* ga = gs + (pr * H + cm * 16 + g) * GS + q;
        const float* xb = Xc + g * S + q;
        for (int k4 = kh; k4 < Cp / 32; k4 += kSplit) {
#pragma unroll
          for (int kk = 0; kk < kKQ; ++kk) {
            const int c = (kKQ * k4 + kk) * 8;
            uint32_t ab[4], asm_[4], bb0, bs0, bb1, bs1;
            split_tf32_trunc(ga[c], ab[0], asm_[0]);
            split_tf32_trunc(ga[8 * GS + c], ab[1], asm_[1]);
            split_tf32_trunc(ga[c + 4], ab[2], asm_[2]);
            split_tf32_trunc(ga[8 * GS + c + 4], ab[3], asm_[3]);
            split_tf32_trunc(xb[c], bb0, bs0);
            split_tf32_trunc(xb[c + 4], bb1, bs1);
            mma_3xtf32(acc2[kk], ab, asm_, bb0, bb1, bs0, bs1);
          }
        }
      }
      // (head g, columns 2q, 2q + 1) and (head g + 8, the same columns).
      float G[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) G[e] = ((acc2[0][e] + acc2[1][e]) + acc2[2][e]) + acc2[3][e];
      float* gw = gt + ((pr * kSplit + kh) * H + cm * 16 + g) * kTJ + cn * 8 + 2 * q;
      *reinterpret_cast<float2*>(gw) = make_float2(G[0], G[1]);
      *reinterpret_cast<float2*>(gw + 8 * kTJ) = make_float2(G[2], G[3]);
    }

    // C3: d_x2d[pr][j][c] = sum_h a[pr][h][j] g[pr][h][c], the warp's channel
    // pairs of n-tiles, written once.
    {
      const int i = i0 + pr;
      auto store = [&](int p, const float (&acc3)[2][4]) {
        if (i >= Lq) return;
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int j = j0 + g + 8 * hf, c = (2 * p + x) * 8 + 2 * q;
            if (j < Lk) {
              T* dst = d_x2d + (((size_t)b * Lq + i) * Lk + j) * Cp + c;
              const float v0 = acc3[x][2 * hf], v1 = acc3[x][2 * hf + 1];
              if constexpr (kBf) {
                const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
                __stcs(reinterpret_cast<unsigned int*>(dst),
                       *reinterpret_cast<const unsigned int*>(&v));
              } else {
                __stcs(reinterpret_cast<float2*>(dst), make_float2(v0, v1));
              }
            }
          }
      };
#pragma unroll
      for (int sl = 0; sl < kSlots; ++sl) {
        const int p = ce + kRowWarps * sl;
        if (p >= npairs) break;
        float acc3[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        if constexpr (kBf) {
#pragma unroll
          for (int ks = 0; ks < H / 16; ++ks) {
            // A (columns x heads) from [head] rows by ldmatrix.trans; B
            // (heads x channels) likewise.
            uint32_t ahi[4], alo[4], bh[4], bl[4];
            const int hrow = ks * 16 + (lane & 7) + ((lane >> 4) << 3);
            const bf16* arow = as + (pr * H + hrow) * kAPS + ((lane >> 3) & 1) * 8;
            ldmatrix_x4_trans(ahi, arow);
            ldmatrix_x4_trans(alo, arow + as_elems);
            const bf16* grow = gs + (pr * H + ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * GS +
                               (lane >> 4) * 8 + p * 16;
            ldmatrix_x4_trans(bh, grow);
            ldmatrix_x4_trans(bl, grow + gs_elems);
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              mma_bf16(acc3[x], alo, bh[2 * x], bh[2 * x + 1]);
              mma_bf16(acc3[x], ahi, bl[2 * x], bl[2 * x + 1]);
              mma_bf16(acc3[x], ahi, bh[2 * x], bh[2 * x + 1]);
            }
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < H / 8; ++ks) {
            uint32_t ab[4], asm_[4];
            const float* a0 = as + (pr * H + ks * 8 + q) * kAPS + g;
            split_tf32_trunc(a0[0], ab[0], asm_[0]);
            split_tf32_trunc(a0[8], ab[1], asm_[1]);
            split_tf32_trunc(a0[4 * kAPS], ab[2], asm_[2]);
            split_tf32_trunc(a0[4 * kAPS + 8], ab[3], asm_[3]);
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const float* gb = gs + (pr * H + ks * 8 + q) * GS + (2 * p + x) * 8 + g;
              uint32_t bb0, bs0, bb1, bs1;
              split_tf32_trunc(gb[0], bb0, bs0);
              split_tf32_trunc(gb[4 * GS], bb1, bs1);
              mma_3xtf32(acc3[x], ab, asm_, bb0, bb1, bs0, bs1);
            }
          }
        }
        store(p, acc3);
      }
    }
    __syncthreads();  // G; the stage read
    if (kStages<T, H> == 1 && t + 1 < ntiles) copy_tile(t + 1);
    // dphat = dv + G, G's parts added in order.
#pragma unroll
    for (int hp = 0; hp < kHeadsAWarp; ++hp) {
      const int h = head(hp), j = j0 + jl;
      const float* gp = gt + (ar * kSplit * H + h) * kTJ + jl;
      float G = gp[0];
#pragma unroll
      for (int s = 1; s < kSplit; ++s) G += gp[s * H * kTJ];
      if (ai < Lq && j < Lk) dvals[pa_row(h) + j] = dvk[hp] + G;
      lg[hp] = lg_n[hp];
      dvk[hp] = dv_n[hp];
    }
  }

  // wx2d to its scratch ([H, B, Lq, Cp], for d_w_pv) and g . wx2d, a
  // partial a warp summed over its channels, then over the 4 lanes of a head.
  {
    const int i = i0 + pr;
    float dx[kMT][2];  // [m-tile][head g or g + 8]
#pragma unroll
    for (int m = 0; m < kMT; ++m) dx[m][0] = dx[m][1] = 0.f;
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) {
      const int p = ce + kRowWarps * sl;
      if (p < npairs) {
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int m = 0; m < kMT; ++m)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int h = m * 16 + g + 8 * hh, c = (2 * p + x) * 8 + 2 * q;
              const float w0 = acc1[sl][x][m][2 * hh], w1 = acc1[sl][x][m][2 * hh + 1];
              if (i < Lq)
                __stcs(reinterpret_cast<float2*>(wx2d_out + (((size_t)h * B + b) * Lq + i) * Cp +
                                                 c),
                       make_float2(w0, w1));
              const int o = (pr * H + h) * GS + c;
              float g0, g1;
              if constexpr (kBf) {
                g0 = to_f(gs[o]) + to_f(gs[gs_elems + o]);
                g1 = to_f(gs[o + 1]) + to_f(gs[gs_elems + o + 1]);
              } else {
                g0 = gs[o];
                g1 = gs[o + 1];
              }
              dx[m][hh] = fmaf(w1, g1, fmaf(w0, g0, dx[m][hh]));
            }
      }
    }
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = dx[m][hh];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (q == 0) dxp_sm[(pr * kRowWarps + ce) * H + m * 16 + g + 8 * hh] = v;
      }
  }
#pragma unroll
  for (int hp = 0; hp < kHeadsAWarp; ++hp)
#pragma unroll
    for (int o = 1; o < kTJ; o <<= 1) dv_run[hp] += __shfl_xor_sync(0xffffffffu, dv_run[hp], o);
  load_qp_rows();  // the stages are read
  __syncthreads();
#pragma unroll
  for (int hp = 0; hp < kHeadsAWarp; ++hp) {
    float d = dv_run[hp];  // D
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) d += dxp_sm[(ar * kRowWarps + w) * H + head(hp)];
    if (jl == 0) st_sm[(ar * H + head(hp)) * 3 + 2] = d;
  }
  __syncthreads();

  // ================= sweep 3: ds, d_pa, d_q_s, d_q_p =================
  // Sweep 1's roles: a thread a (head, column) of each tile for both rows.
#pragma unroll 1
  for (int hp2 = 0; hp2 < kHeadsAWarp / 2; ++hp2) {
    const int h = head(2 * hp2 + hh);
    const T* ks_bh = k_s + ((size_t)b * H + h) * Lk * kDK;
    size_t row[kTI];
    float dqs[kTI][kDK], dqp[kTI][12];
#pragma unroll
    for (int r = 0; r < kTI; ++r) {
      row[r] = (((size_t)b * H + h) * Lq + min(i0 + r, Lq - 1)) * Lk;
#pragma unroll
      for (int d = 0; d < kDK; ++d) dqs[r][d] = 0.f;
#pragma unroll
      for (int d = 0; d < 12; ++d) dqp[r][d] = 0.f;
    }
    for (int t = 0; t < ntiles; ++t) {
      const int j = t * kTJ + jl, jc = min(j, Lk - 1);
      KeyCol kc;
      load_key(kc, ks_bh, kp_b, plane, h, Lk, jc);
      float lgv[kTI], dph[kTI];  // past Lk the last column's, dropped
#pragma unroll
      for (int r = 0; r < kTI; ++r) {
        lgv[r] = logits[row[r] + jc];
        dph[r] = dvals[row[r] + jc];
      }
#pragma unroll
      for (int r = 0; r < kTI; ++r) {
        const float* st = st_sm + (r * H + h) * 3;  // row max, 1/sum, D
        const float a = j < Lk ? expf(lgv[r] - st[0]) * st[1] : 0.f;
        const float dphat = j < Lk ? dph[r] : 0.f;
        const float ds = a * (dphat - st[2]);
        if (i0 + r < Lq && j < Lk) {
          if constexpr (kBf) {
            const bf16 v = from_f<T>(pair_w * ds);
            __stcs(reinterpret_cast<unsigned short*>(d_pa + row[r] + j),
                   *reinterpret_cast<const unsigned short*>(&v));
          } else {
            __stcs(reinterpret_cast<float*>(d_pa + row[r] + j), pair_w * ds);
          }
          ds_out[row[r] + j] = ds;
        }
#pragma unroll
        for (int d = 0; d < kDK; ++d) dqs[r][d] = fmaf(ds, kc.k[d], dqs[r][d]);
        const float* qp = rows_sm + (r * H + h) * kRowF + kQp;
#pragma unroll
        for (int p = 0; p < kNpts; ++p) {
          const float dx = qp[p * 3] - kc.kp[p * 3], dy = qp[p * 3 + 1] - kc.kp[p * 3 + 1],
                      dz = qp[p * 3 + 2] - kc.kp[p * 3 + 2];
          const float w = -ds * inv_dist(dx, dy, dz);
          dqp[r][p * 3] = fmaf(w, dx, dqp[r][p * 3]);
          dqp[r][p * 3 + 1] = fmaf(w, dy, dqp[r][p * 3 + 1]);
          dqp[r][p * 3 + 2] = fmaf(w, dz, dqp[r][p * 3 + 2]);
        }
      }
    }
    // d_q_s and d_q_p: the 16 lanes of a head summed; lane jl writes value jl.
#pragma unroll
    for (int r = 0; r < kTI; ++r) {
#pragma unroll
      for (int d = 0; d < kDK; ++d)
#pragma unroll
        for (int o = 1; o < kTJ; o <<= 1) dqs[r][d] += __shfl_xor_sync(0xffffffffu, dqs[r][d], o);
#pragma unroll
      for (int d = 0; d < 12; ++d)
#pragma unroll
        for (int o = 1; o < kTJ; o <<= 1) dqp[r][d] += __shfl_xor_sync(0xffffffffu, dqp[r][d], o);
      const int i = i0 + r;
      if (i < Lq) {
        T* dst = d_qs + (((size_t)b * H + h) * Lq + i) * kDK;
#pragma unroll
        for (int d = 0; d < kDK; ++d)
          if (d == jl) dst[d] = from_f<T>(scalar_w * dqs[r][d]);
#pragma unroll
        for (int px = 0; px < 12; ++px)
          if (px == jl)
            d_qp[(((size_t)b * 3 + px % 3) * H * kNpts + h * kNpts + px / 3) * Lq + i] =
                dqp[r][px];
      }
    }
  }
}

// Opt the row kernel into one block's shared memory at pair width Cp, with
// the SM's L1/shared split at its most shared memory (two blocks an SM),
// and the column kernel into its own.
template <typename T, int H>
cudaError_t configure(int Cp) {
  cudaError_t err = cudaFuncSetAttribute(bwd_rows<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         RowLayout<T, H>(Cp).total);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_rows<T, H>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(bwd_cols<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kColSmem);
}

// The C entries' call: operands in ipa_attention_fwd's layouts, checked
// (H heads of width DK, Cp a multiple of 32 up to 256, 16-byte aligned
// tensors), then bwd_dv, bwd_rows and bwd_cols on the stream.
template <typename T, int H>
int launch_backward(const void* q_s, const void* k_s, const void* v_s, const void* q_p,
                    const void* k_p, const void* v_p, const void* x2d, const void* bias,
                    const void* pa, const void* ct_s, const void* ct_p, const void* ct_pr,
                    const void* w_pv, void* d_qs, void* d_ks, void* d_vs, void* d_qp, void* d_kp,
                    void* d_vp, void* d_x2d, void* d_pa, void* wx2d, void* ds, void* logits,
                    void* dvals, void* stats, int B, int heads, int Lq, int Lk, int DK, int Cp,
                    float scalar_w, float pair_w, void* stream) {
  const void* vec[] = {q_s, k_s, v_s, v_p, x2d, pa, ct_s, ct_p, ct_pr, w_pv, d_vp, d_x2d, wx2d,
                       stats};
  bool bad = heads != H || DK != kDK || Cp < 32 || Cp > kMaxCp || Cp % 32 != 0 || B < 1 ||
             Lq < 1 || Lk < 1 || pa == nullptr;
  for (const void* p : vec) bad = bad || misaligned(p);
  if (bad) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = configure<T, H>(Cp);
  if (err != cudaSuccess) return (int)err;
  const dim3 dgrid((Lk + kDvThreads - 1) / kDvThreads, (Lq + kDvRows - 1) / kDvRows, B * H);
  bwd_dv<T><<<dgrid, kDvThreads, 0, st>>>(
      static_cast<const T*>(v_s), static_cast<const float*>(v_p), static_cast<const T*>(ct_s),
      static_cast<const float*>(ct_p), static_cast<float*>(dvals), Lq, Lk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 rgrid((Lq + kTI - 1) / kTI, B);
  const int smem = RowLayout<T, H>(Cp).total;
  bwd_rows<T, H><<<rgrid, kThreads, smem, st>>>(
      static_cast<const T*>(q_s), static_cast<const T*>(k_s), static_cast<const float*>(q_p),
      static_cast<const float*>(k_p), static_cast<const T*>(x2d),
      static_cast<const float*>(bias), static_cast<const T*>(pa),
      static_cast<const float*>(ct_pr), static_cast<const T*>(w_pv), static_cast<T*>(d_qs),
      static_cast<float*>(d_qp),
      static_cast<T*>(d_x2d), static_cast<T*>(d_pa), static_cast<float*>(wx2d),
      static_cast<float*>(ds), static_cast<float*>(logits), static_cast<float*>(dvals),
      static_cast<float*>(stats), B, Lq, Lk, Cp, scalar_w, pair_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 cgrid((Lk + 31) / 32, H / kColHeads, B);
  bwd_cols<T, H><<<cgrid, kColThreads, kColSmem, st>>>(
      static_cast<const T*>(q_s), static_cast<const float*>(q_p), static_cast<const float*>(k_p),
      static_cast<const T*>(ct_s), static_cast<const float*>(ct_p),
      static_cast<const float*>(stats), static_cast<const float*>(logits),
      static_cast<const float*>(ds), static_cast<T*>(d_ks), static_cast<T*>(d_vs),
      static_cast<float*>(d_kp), static_cast<float*>(d_vp), Lq, Lk, scalar_w);
  return (int)cudaGetLastError();
}

template <typename T, int H>
int row_blocks_per_sm(int Cp) {
  int n = 0;
  if (Cp < 32 || Cp > kMaxCp || Cp % 32 != 0 || configure<T, H>(Cp) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bwd_rows<T, H>, kThreads,
                                                    RowLayout<T, H>(Cp).total) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace
