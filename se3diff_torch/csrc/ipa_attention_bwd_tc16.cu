// Fused IPA attention core (backward) at 16 heads, the tensor-core design for
// Hopper, sm_90a.
//
// Replaces no Pallas kernel: it is the counterpart of the XLA function
// se3diff_tpu/ops/pallas_ipa.py::_fused_backward_chunked, the backward behind
// fused_ipa_attention_diff's custom VJP, at the widths of a tensor-parallel
// rank at `--mesh model=2` (the bioemu-v1.0 score model's 32 heads split two
// ways): 16 heads of width 16, the streamed pair bias (has_pa) and Cp a
// multiple of 32 up to 256, in bf16 (ipa_attention_bwd_tc16) and in f32
// (ipa_attention_bwd_tc16_f32): one template, two instantiations. It computes
// what ipa_attention_bwd_tc.cu (the 32-head design) computes, with its
// algebra: f32 attention weights a (never rounded to the model dtype), dist
// = sqrt(max(d2, 0) + 1e-24) with a zero distance subgradient wherever d2 <=
// 0, d_pa = pair_w ds, no gradient for the column bias, every gradient cast
// to its input's dtype once, at the end; ops/ipa_attention.py::
// ipa_attention_backward_tiled is its arithmetic in PyTorch.
//
// Bound on an H100: bytes, in both dtypes. At B=16 L=100 Cp=256 the call
// moves 374 MB in f32 (x2d read and d_x2d written, 164 MB each), 0.112 ms at
// 3.35 TB/s; at the train CLI's B=16 L=64 bf16, 84 MB, 0.025 ms. Its
// operations, priced as the 32-head design's on the units that run them,
// take 0.045 and 0.014 ms there. Half the heads of the 32-head design do
// half its per-pair work over the same x2d bytes.
//
// Design, and what it does about the widths:
// * bwd16_rows: a block owns TI=2 query rows of one batch element for all 16
//   heads, so each staged x2d tile serves every head, and is 256 threads: a
//   thread a (row, head, column pair) outside the products, as in the 32-head
//   design. At 16 heads one m16 tile of mma.sync is exactly one row's heads:
//   the products C1 (wx2d = sum_j a x2d) and C3 (d_x2d = sum_h a g) take a
//   warp a row and a quarter of the channel pairs, C2 (G = g . x2d) a warp a
//   row and a quarter of Cp (its four partial sums added in a fixed order).
// * Two blocks an SM (at most 128 registers a thread, the shared memory
//   below), so one block's barriers and L2 waits hide behind the other's
//   work: the 32-head design's one 512-thread block an SM was latency-bound
//   behind dependent L2 loads of the key side (PERF.md). Widening to
//   4 rows x 16 heads at 512 threads would need 252,416 B of f32 shared
//   memory, more than a block may have; the 32-head layout at 2 rows and 16
//   heads, double-buffered, 126,208 B in f32, one block an SM. So the x2d
//   tile has one stage: its next tile is copied while the threads compute the
//   attention weights, value terms and row gradients of that tile (the
//   latency-bound part), and the products run between two barriers.
// * The key side of a tile (k_s, key points; v_s, v_p: 68 values a head and
//   column, 69.6 kB a 16-column tile in f32) does not fit beside two blocks'
//   x2d; with 2 rows a block each value would serve two threads, so staging
//   it would buy prefetch and not reuse. It is read from L1/L2 as in the
//   32-head design.
// bwd16_rows makes three sweeps over key tiles of TJ=16 columns, pa (sweep
// 1) and x2d (sweeps 2 and 3) staged by cp.async into shared memory in their
// own dtype, zero-filled past Lq and Lk:
//   1. statistics: the row max and sum of exp, online, from the logits alone
//      (with pa streamed the logits need no x2d); the logits are kept;
//   2. a from the kept logits, wx2d = sum_j a x2d on tensor cores (C1) and
//      D's value terms sum_j a dv, dv = ct_s.v_s + ct_p.v_p on CUDA cores
//      (dv kept); then D = those + g.wx2d, g = g_wx2d = ct_pr @ w_pv^T, from
//      the row aggregate wx2d;
//   3. G = g.x2d[i, j, :] on tensor cores (C2), ds = a (dphat - D) with
//      dphat = dv + G, d_pa = pair_w ds, d_q_s and d_q_p summed over the
//      block's columns in registers, and d_x2d = sum_h a g on tensor cores
//      (C3), written once.
// * bwd_cols (ipa_attention_bwd_common.cuh, shared with the 32-head design):
//   the column sums (d_k_s, d_v_s, d_k_p, d_v_p), FlashAttention-2's split: a
//   thread a (head, key column) walks every query row in order, taking a from
//   the kept logits and the saved row statistics, and ds; a warp a head, 8
//   heads a block, so its grid is (Lk/32, H/8, B).
// Both kernels are deterministic: no atomics, every sum in a fixed order.
// Operands rounded on the tensor cores, as in the 32-head design:
// * bf16: x2d is bf16 already and enters as it is. The f32 operands a and g
//   are each split into two bf16 terms (hi + lo, 16 significant bits): C1
//   a_hi X + a_lo X, C2 g_hi X + g_lo X, C3 a_hi g_hi + a_hi g_lo + a_lo g_hi
//   (the lo x lo term dropped).
// * f32: 3xTF32 (big + small TF32 terms, the small x small term dropped).
// Plain products left to torch.bmm outside (ops/ipa_attention.py, as JAX
// leaves them to XLA): g_wx2d = ct_pr @ w_pv^T before, d_w_pv = wx2d^T ct_pr
// after.
// Scratch in device memory, allocated by the caller: g_wx2d and wx2d
// [H, B, Lq, Cp] f32; the logits, dv and ds [B, H, Lq, Lk] f32; the row
// statistics [B, H, Lq, 2] f32 (max, 1/sum).
//
// Shared memory of bwd16_rows at Cp = 256: 74,496 bytes (bf16), 92,416 (f32)
// (two 256-thread blocks an SM); bwd_cols: 90,112 bytes.
// ptxas -v (sm_90a, CUDA 12.8; chip_smoke.py phase 1 prints it): bwd16_rows
// 128 registers, no spills in bf16, 8 bytes spilled (40 loaded) in f32;
// bwd_cols<T, 16> 128 registers, 32 / 48 bytes spilled (bf16 / f32).

#include <type_traits>

#include "ipa_attention_bwd_common.cuh"

namespace {

constexpr int kH = 16;                     // heads: one m16 tile
constexpr int kTI = 2;                     // query rows a bwd16_rows block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowWarps = kWarps / kTI;    // C1 / C3: warps a row (channel-pair quarters)
constexpr int kSlots = kMaxCp / 16 / kRowWarps;  // channel pairs a warp at the widest Cp
constexpr int kKQ = kRowWarps;             // C2: K quarters, a warp each
static_assert(kRowWarps * kTI == kWarps && kKQ == 4, "thread roles");
static_assert(kTI * kH * kTJ == 2 * kThreads, "a thread a (row, head, column pair)");
static_assert(kH == 16 && kH % kColHeads == 0, "one m16 tile a row's heads");

// Shared memory of bwd16_rows, byte offsets of its regions:
//   x2d stage   [TI][TJ][xs_stride] T         (from 0; one stage)
//   pas         2 x [TI][H][PS] T             pa stages (sweep 1)
//   gs          terms x [TI][H][gs_stride] T  g_wx2d
//   as          terms x [TI][H][APS] T        the tile's attention weights
//   gp          [TI][KQ][H][TJ] f32           C2's partial G
//   qs          [TI][H][DK] f32               q_s * scalar_w
//   qp          [TI][H][p*3+x] f32            query points
//   cts, ctp    [TI][H][DK], [TI][H][24] f32  cotangents of out_s, out_p
//   dv          2 x [TI][H] f32               D's value terms, then D
//   dxp         [TI][RowWarps][H] f32         g . wx2d, a part a warp
template <typename T>
struct RowLayout {
  int xs_stride, gs_stride;
  int pas, gs, as, gp, qs, qp, cts, ctp, dv, dxp, total;
  __host__ __device__ explicit RowLayout(int Cp) {
    constexpr int kTerms = Tile<T>::kTerms, kSize = (int)sizeof(T);
    xs_stride = Cp + Tile<T>::kXsPad;
    gs_stride = Cp + Tile<T>::kGsPad;
    pas = kTI * kTJ * xs_stride * kSize;
    gs = pas + 2 * kTI * kH * kPS<T> * kSize;
    as = gs + kTerms * kTI * kH * gs_stride * kSize;
    gp = as + kTerms * kTI * kH * Tile<T>::kAPS * kSize;
    qs = gp + kTI * kKQ * kH * kTJ * 4;
    qp = qs + kTI * kH * kDK * 4;
    cts = qp + kTI * kH * 12 * 4;
    ctp = cts + kTI * kH * kDK * 4;
    dv = ctp + kTI * kH * kVp * 4;
    dxp = dv + 2 * kTI * kH * 4;
    total = dxp + kTI * kRowWarps * kH * 4;
  }
};

// One stage: the pa rows (i0 + r, h) at columns j0 .. j0+15 as the aligned
// chunks that cover them (sweep 1), or the x2d rows (i0 + r, j0 + jj, :)
// (sweeps 2 and 3).
template <typename T>
__device__ __forceinline__ void issue_stage(T* xs, T* pas, const T* x2d_b, const T* pa,
                                            size_t pa_elems, int b, int i0, int j0, int Lq, int Lk,
                                            int Cp, int xs_stride, bool with_x2d, int tid) {
  constexpr int kC = Tile<T>::kChunk;
  for (int e = tid; !with_x2d && e < kTI * kH * kPaChunks<T>; e += kThreads) {
    const int k = e % kPaChunks<T>, h = (e / kPaChunks<T>) % kH, r = e / (kPaChunks<T> * kH);
    const size_t off = (((size_t)b * kH + h) * Lq + min(i0 + r, Lq - 1)) * Lk + j0;
    const size_t chunk = (off & ~(size_t)(kC - 1)) + (size_t)kC * k;
    const int bytes = chunk < pa_elems ? (int)sizeof(T) * (int)min((size_t)kC, pa_elems - chunk) : 0;
    cp_async16(pas + (r * kH + h) * kPS<T> + kC * k, bytes ? pa + chunk : pa, bytes);
  }
  if (!with_x2d) return;
  const int per_row = Cp / kC;
  for (int e = tid; e < kTI * kTJ * per_row; e += kThreads) {
    const int c = e % per_row, rj = e / per_row, r = rj / kTJ, jj = rj % kTJ;
    const bool ok = i0 + r < Lq && j0 + jj < Lk;
    const T* src = ok ? x2d_b + ((size_t)(i0 + r) * Lk + j0 + jj) * Cp + c * kC : x2d_b;
    cp_async16(xs + rj * xs_stride + c * kC, src, ok ? 16 : 0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
bwd16_rows(const T* __restrict__ q_s, const T* __restrict__ k_s, const T* __restrict__ v_s,
           const float* __restrict__ q_p, const float* __restrict__ k_p,
           const float* __restrict__ v_p, const T* __restrict__ x2d,
           const float* __restrict__ bias, const T* __restrict__ pa, const T* __restrict__ ct_s,
           const float* __restrict__ ct_p, const float* __restrict__ g_wx2d,
           T* __restrict__ d_qs, float* __restrict__ d_qp, T* __restrict__ d_x2d,
           T* __restrict__ d_pa, float* __restrict__ wx2d_out, float* __restrict__ ds_out,
           float* __restrict__ logits, float* __restrict__ dvals, float* __restrict__ stats_out,
           int B, int Lq, int Lk, int Cp, float scalar_w, float pair_w) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  constexpr int kAPS = Tile<T>::kAPS;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const RowLayout<T> L(Cp);
  T* xs = reinterpret_cast<T*>(smem);
  T* pas = reinterpret_cast<T*>(smem + L.pas);
  T* gs = reinterpret_cast<T*>(smem + L.gs);  // bf16: hi [TI][H][gs_stride], then lo
  T* as = reinterpret_cast<T*>(smem + L.as);  // bf16: hi [TI][H][APS], then lo
  float* gp = reinterpret_cast<float*>(smem + L.gp);
  float* qs_sm = reinterpret_cast<float*>(smem + L.qs);
  float* qp_sm = reinterpret_cast<float*>(smem + L.qp);
  float* cts_sm = reinterpret_cast<float*>(smem + L.cts);
  float* ctp_sm = reinterpret_cast<float*>(smem + L.ctp);
  float* dv_sm = reinterpret_cast<float*>(smem + L.dv);  // Dv, then D
  float* dxp_sm = reinterpret_cast<float*>(smem + L.dxp);
  const int gs_elems = kTI * kH * L.gs_stride;
  const int as_elems = kTI * kH * kAPS;
  constexpr int kPaElems = kTI * kH * kPS<T>;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, i0 = blockIdx.x * kTI;
  const int ntiles = (Lk + kTJ - 1) / kTJ;
  const T* x2d_b = x2d + (size_t)b * Lq * Lk * Cp;
  const size_t pa_elems = (size_t)B * kH * Lq * Lk;
  const size_t plane = (size_t)kH * kNpts * Lk;
  const float* kp_b = k_p + (size_t)b * 3 * plane;
  const float* bias_b = bias + (size_t)b * Lk;

  // ---- the rows' operands into shared memory (rows past Lq: the last row,
  // never stored; g zero there).
  for (int e = tid; e < kTI * kH * kDK; e += kThreads) {
    const int d = e % kDK, h = (e / kDK) % kH, r = e / (kDK * kH);
    const size_t o = (((size_t)b * kH + h) * Lq + min(i0 + r, Lq - 1)) * kDK + d;
    qs_sm[e] = to_f(q_s[o]) * scalar_w;
    cts_sm[e] = to_f(ct_s[o]);
  }
  for (int e = tid; e < kTI * kH * kVp; e += kThreads) {
    const int c = e % kVp, h = (e / kVp) % kH, r = e / (kVp * kH);
    ctp_sm[e] = ct_p[(((size_t)b * kH + h) * Lq + min(i0 + r, Lq - 1)) * kVp + c];
  }
  for (int e = tid; e < kTI * kH * 12; e += kThreads) {
    const int px = e % 12, h = (e / 12) % kH, r = e / (12 * kH);
    const int p = px / 3, x = px % 3;
    qp_sm[e] = q_p[(((size_t)b * 3 + x) * kH * kNpts + h * kNpts + p) * Lq + min(i0 + r, Lq - 1)];
  }
  for (int e = tid; e < kTI * kH * (Cp / 4); e += kThreads) {
    const int c4 = e % (Cp / 4), h = (e / (Cp / 4)) % kH, r = e / (kH * (Cp / 4));
    const int i = i0 + r;
    const float4 v = i < Lq ? *reinterpret_cast<const float4*>(
                                  g_wx2d + (((size_t)h * B + b) * Lq + i) * Cp + 4 * c4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    const int o = (r * kH + h) * L.gs_stride + 4 * c4;
    if constexpr (kBf) {
      bf16 h0, h1, h2, h3, l0, l1, l2, l3;
      split_bf16(v.x, h0, l0);
      split_bf16(v.y, h1, l1);
      split_bf16(v.z, h2, l2);
      split_bf16(v.w, h3, l3);
      *reinterpret_cast<uint2*>(gs + o) = make_uint2(pack_bf16(h0, h1), pack_bf16(h2, h3));
      *reinterpret_cast<uint2*>(gs + gs_elems + o) = make_uint2(pack_bf16(l0, l1), pack_bf16(l2, l3));
    } else {
      *reinterpret_cast<float4*>(gs + o) = v;
    }
  }

  // ---- thread roles
  // A phases: row r, head h, columns jj and jj + 8 of each tile; 8 lanes a (r, h).
  const int jj = lane & 7, ar = (lane >> 3) & 1, ah = 2 * warp + (lane >> 4);
  const int ai = i0 + ar;
  const float* my_qs = qs_sm + (ar * kH + ah) * kDK;
  const float* my_qp = qp_sm + (ar * kH + ah) * 12;
  const float* my_cts = cts_sm + (ar * kH + ah) * kDK;
  const float* my_ctp = ctp_sm + (ar * kH + ah) * kVp;
  const T* ks_bh = k_s + ((size_t)b * kH + ah) * Lk * kDK;
  const T* vs_bh = v_s + ((size_t)b * kH + ah) * Lk * kDK;
  const float* vp_bh = v_p + ((size_t)b * kH + ah) * Lk * kVp;
  const size_t pa_row = (((size_t)b * kH + ah) * Lq + min(ai, Lq - 1)) * Lk;
  // Products: row pr; C1 / C3 channel pairs ce + 4 sl (n-tiles 2p, 2p + 1);
  // C2 K quarter kq = ce.
  const int pr = warp / kRowWarps, ce = warp % kRowWarps, kq = ce;
  const int g = lane >> 2, q = lane & 3;
  const int npairs = Cp / 16;
  const T* X = xs + pr * kTJ * L.xs_stride;  // the row's x2d rows in the stage

  // pa of (this thread's row, head) at tile column jl, from the stage.
  auto pa_at = [&](const T* pa_t, int j0, int jl) {
    const int sh = (int)((pa_row + j0) & (size_t)(Tile<T>::kChunk - 1));
    return to_f(pa_t[(ar * kH + ah) * kPS<T> + sh + jl]);
  };

  // ================= sweep 1: row statistics =================
  issue_stage(xs, pas, x2d_b, pa, pa_elems, b, i0, 0, Lq, Lk, Cp, L.xs_stride, false, tid);
  cp_async_commit();
  float m_run = -1e30f, l_run = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int j0 = t * kTJ;
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < ntiles)
      issue_stage(xs, pas + ((t + 1) & 1) * kPaElems, x2d_b, pa, pa_elems, b, i0, j0 + kTJ, Lq,
                  Lk, Cp, L.xs_stride, false, tid);
    cp_async_commit();
    const T* pa_t = pas + (t & 1) * kPaElems;
    float s[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int jl = jj + 8 * u, j = j0 + jl;
      const int jc = min(j, Lk - 1);
      KeyCol kc;
      load_key(kc, ks_bh, kp_b, plane, ah, Lk, jc);
      s[u] = logit_core(my_qs, my_qp, kc) + pair_w * pa_at(pa_t, j0, jl) + bias_b[jc];
      if (j >= Lk) s[u] = -INFINITY;
      else if (ai < Lq) logits[pa_row + j] = s[u];
    }
    const float m_new = fmaxf(m_run, fmaxf(s[0], s[1]));
    l_run = l_run * expf(m_run - m_new) + expf(s[0] - m_new) + expf(s[1] - m_new);
    m_run = m_new;
  }
  float row_max = m_run;
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, o));
  float row_sum = l_run * expf(m_run - row_max);
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) row_sum += __shfl_xor_sync(0xffffffffu, row_sum, o);
  const float inv_sum = 1.f / row_sum;
  if (jj == 0 && ai < Lq)
    *reinterpret_cast<float2*>(stats_out + (((size_t)b * kH + ah) * Lq + ai) * 2) =
        make_float2(row_max, inv_sum);

  // Attention weight of this thread's (row, head) at column j, from the
  // logit sweep 1 kept (rows past Lq read the last row's, written by its
  // own thread before the block's barrier).
  auto weight = [&](int j) {
    return j < Lk ? expf(logits[pa_row + j] - row_max) * inv_sum : 0.f;
  };
  // ct_s . v_s[j] + ct_p . v_p[j]
  auto value_term = [&](int jc) {
    float vs[kDK];
    load16(vs_bh + (size_t)jc * kDK, vs);
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < kDK; ++d) acc = fmaf(my_cts[d], vs[d], acc);
    const float4* vp4 = reinterpret_cast<const float4*>(vp_bh + (size_t)jc * kVp);
#pragma unroll
    for (int c = 0; c < kVp / 4; ++c) {
      const float4 v = vp4[c];
      const float4 w = *reinterpret_cast<const float4*>(my_ctp + 4 * c);
      acc = fmaf(w.x, v.x, fmaf(w.y, v.y, fmaf(w.z, v.z, fmaf(w.w, v.w, acc))));
    }
    return acc;
  };
  // a of (this thread's row, head) at tile column jl into the a buffer.
  auto store_a = [&](int jl, float a) {
    const int o = (ar * kH + ah) * kAPS + jl;
    if constexpr (kBf) {
      bf16 hi, lo;
      split_bf16(a, hi, lo);
      as[o] = hi;
      as[as_elems + o] = lo;
    } else {
      as[o] = a;
    }
  };

  // ================= sweep 2: wx2d (C1) and D's value terms =================
  // One x2d stage: tile t lands while the threads compute its a and dv.
  __syncthreads();
  issue_stage(xs, pas, x2d_b, pa, pa_elems, b, i0, 0, Lq, Lk, Cp, L.xs_stride, true, tid);
  cp_async_commit();
  float acc1[kSlots][2][4];  // [slot][n-tile of the pair][4]: wx2d
#pragma unroll
  for (int a = 0; a < kSlots; ++a)
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc1[a][x][k] = 0.f;
  float dv_run = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int j0 = t * kTJ;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int jl = jj + 8 * u, j = j0 + jl;
      const float a = weight(j), dv = value_term(min(j, Lk - 1));
      if (ai < Lq && j < Lk) dvals[pa_row + j] = dv;
      dv_run = fmaf(a, dv, dv_run);
      store_a(jl, a);
    }
    cp_async_wait_all();
    __syncthreads();
    // C1: wx2d[pr][h][c] += a[pr][h][j] x2d[pr][j][c].
    if constexpr (kBf) {
      uint32_t ahi[4], alo[4];
      const bf16* arow = as + (pr * kH + (lane & 15)) * kAPS + (lane >> 4) * 8;
      ldmatrix_x4(ahi, arow);
      ldmatrix_x4(alo, arow + as_elems);
      const bf16* xrow = X + ((lane & 7) + ((lane >> 3) & 1) * 8) * L.xs_stride + (lane >> 4) * 8;
#pragma unroll
      for (int sl = 0; sl < kSlots; ++sl) {
        const int p = ce + kRowWarps * sl;
        if (p < npairs) {
          uint32_t bx[4];
          ldmatrix_x4_trans(bx, xrow + p * 16);
          mma_bf16(acc1[sl][0], ahi, bx[0], bx[1]);
          mma_bf16(acc1[sl][0], alo, bx[0], bx[1]);
          mma_bf16(acc1[sl][1], ahi, bx[2], bx[3]);
          mma_bf16(acc1[sl][1], alo, bx[2], bx[3]);
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kTJ / 8; ++ks) {
        uint32_t ab[4], asm_[4];
        const float* a0 = as + (pr * kH + g) * kAPS + ks * 8 + q;
        split_tf32(a0[0], ab[0], asm_[0]);
        split_tf32(a0[8 * kAPS], ab[1], asm_[1]);
        split_tf32(a0[4], ab[2], asm_[2]);
        split_tf32(a0[8 * kAPS + 4], ab[3], asm_[3]);
#pragma unroll
        for (int sl = 0; sl < kSlots; ++sl) {
          const int p = ce + kRowWarps * sl;
          if (p < npairs) {
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const float* xk = X + (ks * 8 + q) * L.xs_stride + (2 * p + x) * 8 + g;
              uint32_t bb0, bs0, bb1, bs1;
              split_tf32(xk[0], bb0, bs0);
              split_tf32(xk[4 * L.xs_stride], bb1, bs1);
              mma_3xtf32(acc1[sl][x], ab, asm_, bb0, bb1, bs0, bs1);
            }
          }
        }
      }
    }
    __syncthreads();
    if (t + 1 < ntiles) {
      issue_stage(xs, pas, x2d_b, pa, pa_elems, b, i0, j0 + kTJ, Lq, Lk, Cp, L.xs_stride, true,
                  tid);
      cp_async_commit();
    }
  }

  // wx2d to its scratch ([H, B, Lq, Cp], for d_w_pv) and g . wx2d, a
  // partial a warp summed over its channels, then over the 4 lanes of a head.
  {
    const int i = i0 + pr;
    float dx[2] = {0.f, 0.f};  // [head g or g + 8]
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) {
      const int p = ce + kRowWarps * sl;
      if (p < npairs) {
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int h = g + 8 * hh, c = (2 * p + x) * 8 + 2 * q;
            const float w0 = acc1[sl][x][2 * hh], w1 = acc1[sl][x][2 * hh + 1];
            if (i < Lq)
              *reinterpret_cast<float2*>(wx2d_out + (((size_t)h * B + b) * Lq + i) * Cp + c) =
                  make_float2(w0, w1);
            const int o = (pr * kH + h) * L.gs_stride + c;
            float g0, g1;
            if constexpr (kBf) {
              g0 = to_f(gs[o]) + to_f(gs[gs_elems + o]);
              g1 = to_f(gs[o + 1]) + to_f(gs[gs_elems + o + 1]);
            } else {
              g0 = gs[o];
              g1 = gs[o + 1];
            }
            dx[hh] = fmaf(w1, g1, fmaf(w0, g0, dx[hh]));
          }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = dx[hh];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (q == 0) dxp_sm[(pr * kRowWarps + ce) * kH + g + 8 * hh] = v;
    }
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) dv_run += __shfl_xor_sync(0xffffffffu, dv_run, o);
  if (jj == 0) dv_sm[ar * kH + ah] = dv_run;
  __syncthreads();
  if (tid < kTI * kH) {
    const int r = tid / kH, h = tid % kH;
    float d = dv_sm[tid];
    for (int w = 0; w < kRowWarps; ++w) d += dxp_sm[(r * kRowWarps + w) * kH + h];
    dv_sm[kTI * kH + tid] = d;
  }
  __syncthreads();
  const float row_d = dv_sm[kTI * kH + ar * kH + ah];  // D

  // ================= sweep 3: G (C2); ds, d_pa, d_q_s, d_q_p (A); d_x2d (C3) =================
  issue_stage(xs, pas, x2d_b, pa, pa_elems, b, i0, 0, Lq, Lk, Cp, L.xs_stride, true, tid);
  cp_async_commit();
  float dqs[kDK], dqp[12];
#pragma unroll
  for (int d = 0; d < kDK; ++d) dqs[d] = 0.f;
#pragma unroll
  for (int d = 0; d < 12; ++d) dqp[d] = 0.f;

  // C3 for the tile at j0: d_x2d[pr][j][c] = sum_h a[pr][h][j] g[pr][h][c],
  // a channel pair (two n-tiles) at a time.
  auto product_dx2d = [&](int j0) {
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
            if constexpr (kBf)
              *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
            else
              *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          }
        }
    };
    if constexpr (kBf) {
      uint32_t ahi[4], alo[4];
      const int hrow = (lane & 7) + ((lane >> 4) << 3);
      const bf16* arow = as + (pr * kH + hrow) * kAPS + ((lane >> 3) & 1) * 8;
      ldmatrix_x4_trans(ahi, arow);
      ldmatrix_x4_trans(alo, arow + as_elems);
      const bf16* grow =
          gs + (pr * kH + (lane & 7) + ((lane >> 3) & 1) * 8) * L.gs_stride + (lane >> 4) * 8;
#pragma unroll
      for (int sl = 0; sl < kSlots; ++sl) {
        const int p = ce + kRowWarps * sl;
        if (p < npairs) {
          float acc3[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          uint32_t bh[4], bl[4];
          ldmatrix_x4_trans(bh, grow + p * 16);
          ldmatrix_x4_trans(bl, grow + gs_elems + p * 16);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            mma_bf16(acc3[x], alo, bh[2 * x], bh[2 * x + 1]);
            mma_bf16(acc3[x], ahi, bl[2 * x], bl[2 * x + 1]);
            mma_bf16(acc3[x], ahi, bh[2 * x], bh[2 * x + 1]);
          }
          store(p, acc3);
        }
      }
    } else {
      uint32_t ab[kH / 8][4], asm_[kH / 8][4];
#pragma unroll
      for (int ks = 0; ks < kH / 8; ++ks) {
        const float* a0 = as + (pr * kH + ks * 8 + q) * kAPS + g;
        split_tf32(a0[0], ab[ks][0], asm_[ks][0]);
        split_tf32(a0[8], ab[ks][1], asm_[ks][1]);
        split_tf32(a0[4 * kAPS], ab[ks][2], asm_[ks][2]);
        split_tf32(a0[4 * kAPS + 8], ab[ks][3], asm_[ks][3]);
      }
#pragma unroll
      for (int sl = 0; sl < kSlots; ++sl) {
        const int p = ce + kRowWarps * sl;
        if (p < npairs) {
          float acc3[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int ks = 0; ks < kH / 8; ++ks)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const float* gb = gs + (pr * kH + ks * 8 + q) * L.gs_stride + (2 * p + x) * 8 + g;
              uint32_t bb0, bs0, bb1, bs1;
              split_tf32(gb[0], bb0, bs0);
              split_tf32(gb[4 * L.gs_stride], bb1, bs1);
              mma_3xtf32(acc3[x], ab[ks], asm_[ks], bb0, bb1, bs0, bs1);
            }
          store(p, acc3);
        }
      }
    }
  };

  for (int t = 0; t < ntiles; ++t) {
    const int j0 = t * kTJ;
    cp_async_wait_all();
    __syncthreads();
    // C2: G[pr][h][j] = sum_c g[pr][h][c] x2d[pr][j][c], a K quarter a warp.
    {
      float acc2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      if constexpr (kBf) {
        const bf16* grow = gs + (pr * kH + (lane & 15)) * L.gs_stride + (lane >> 4) * 8;
        const bf16* xrow =
            X + ((lane & 7) + ((lane >> 4) << 3)) * L.xs_stride + ((lane >> 3) & 1) * 8;
        for (int ks = kq; ks < Cp / 16; ks += kKQ) {
          uint32_t ghi[4], glo[4], bx[4];
          ldmatrix_x4(ghi, grow + ks * 16);
          ldmatrix_x4(glo, grow + gs_elems + ks * 16);
          ldmatrix_x4(bx, xrow + ks * 16);
          mma_bf16(acc2[0], glo, bx[0], bx[1]);
          mma_bf16(acc2[0], ghi, bx[0], bx[1]);
          mma_bf16(acc2[1], glo, bx[2], bx[3]);
          mma_bf16(acc2[1], ghi, bx[2], bx[3]);
        }
      } else {
        for (int ks = kq; ks < Cp / 8; ks += kKQ) {
          uint32_t ab[4], asm_[4];
          const float* ga = gs + (pr * kH + g) * L.gs_stride + ks * 8 + q;
          split_tf32(ga[0], ab[0], asm_[0]);
          split_tf32(ga[8 * L.gs_stride], ab[1], asm_[1]);
          split_tf32(ga[4], ab[2], asm_[2]);
          split_tf32(ga[8 * L.gs_stride + 4], ab[3], asm_[3]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const float* xb = X + (nt * 8 + g) * L.xs_stride + ks * 8 + q;
            uint32_t bb0, bs0, bb1, bs1;
            split_tf32(xb[0], bb0, bs0);
            split_tf32(xb[4], bb1, bs1);
            mma_3xtf32(acc2[nt], ab, asm_, bb0, bb1, bs0, bs1);
          }
        }
      }
      float* gpw = gp + ((pr * kKQ + kq) * kH + g) * kTJ;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        *reinterpret_cast<float2*>(gpw + nt * 8 + 2 * q) = make_float2(acc2[nt][0], acc2[nt][1]);
        *reinterpret_cast<float2*>(gpw + 8 * kTJ + nt * 8 + 2 * q) =
            make_float2(acc2[nt][2], acc2[nt][3]);
      }
    }
    // C3 of the previous tile, from its a (written in its A part).
    if (t > 0) product_dx2d(j0 - kTJ);
    __syncthreads();
    // The stage is free: tile t + 1 lands while this tile's A part runs.
    if (t + 1 < ntiles) {
      issue_stage(xs, pas, x2d_b, pa, pa_elems, b, i0, j0 + kTJ, Lq, Lk, Cp, L.xs_stride, true,
                  tid);
      cp_async_commit();
    }
    // A: ds and the row gradients.
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int jl = jj + 8 * u, j = j0 + jl, jc = min(j, Lk - 1);
      KeyCol kc;
      load_key(kc, ks_bh, kp_b, plane, ah, Lk, jc);
      const float a = weight(j), dv = j < Lk ? dvals[pa_row + j] : 0.f;
      const float* gpj = gp + (ar * kKQ * kH + ah) * kTJ + jl;
      const float G = ((gpj[0] + gpj[kH * kTJ]) + gpj[2 * kH * kTJ]) + gpj[3 * kH * kTJ];
      const float ds = a * (dv + G - row_d);
      if (ai < Lq && j < Lk) {
        d_pa[pa_row + j] = from_f<T>(pair_w * ds);
        ds_out[pa_row + j] = ds;
      }
#pragma unroll
      for (int d = 0; d < kDK; ++d) dqs[d] = fmaf(ds, kc.k[d], dqs[d]);
#pragma unroll
      for (int p = 0; p < kNpts; ++p) {
        const float dx = my_qp[p * 3] - kc.kp[p * 3], dy = my_qp[p * 3 + 1] - kc.kp[p * 3 + 1],
                    dz = my_qp[p * 3 + 2] - kc.kp[p * 3 + 2];
        const float w = -ds * inv_dist(dx, dy, dz);
        dqp[p * 3] = fmaf(w, dx, dqp[p * 3]);
        dqp[p * 3 + 1] = fmaf(w, dy, dqp[p * 3 + 1]);
        dqp[p * 3 + 2] = fmaf(w, dz, dqp[p * 3 + 2]);
      }
      store_a(jl, a);
    }
  }
  __syncthreads();
  product_dx2d((ntiles - 1) * kTJ);

  // d_q_s and d_q_p: the 8 lanes of a (row, head) summed.
#pragma unroll
  for (int d = 0; d < kDK; ++d)
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) dqs[d] += __shfl_xor_sync(0xffffffffu, dqs[d], o);
#pragma unroll
  for (int d = 0; d < 12; ++d)
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) dqp[d] += __shfl_xor_sync(0xffffffffu, dqp[d], o);
  if (ai < Lq) {
    T* dst = d_qs + (((size_t)b * kH + ah) * Lq + ai) * kDK;
#pragma unroll
    for (int d = 0; d < kDK; ++d)
      if ((d & 7) == jj) dst[d] = from_f<T>(scalar_w * dqs[d]);
#pragma unroll
    for (int px = 0; px < 12; ++px)
      if ((px & 7) == jj)
        d_qp[(((size_t)b * 3 + px % 3) * kH * kNpts + ah * kNpts + px / 3) * Lq + ai] = dqp[px];
  }
}


// Opt the row kernel into one block's shared memory at pair width Cp, with
// the SM's L1/shared split at its most shared memory (two blocks an SM),
// and the column kernel into its own.
template <typename T>
cudaError_t configure(int Cp) {
  cudaError_t err = cudaFuncSetAttribute(bwd16_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         RowLayout<T>(Cp).total);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd16_rows<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(bwd_cols<T, kH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kColSmem);
}

template <typename T>
int launch_backward(const void* q_s, const void* k_s, const void* v_s, const void* q_p,
                    const void* k_p, const void* v_p, const void* x2d, const void* bias,
                    const void* pa, const void* ct_s, const void* ct_p, const void* g_wx2d,
                    void* d_qs, void* d_ks, void* d_vs, void* d_qp, void* d_kp, void* d_vp,
                    void* d_x2d, void* d_pa, void* wx2d, void* ds, void* logits, void* dvals,
                    void* stats, int B, int H, int Lq, int Lk, int DK, int Cp, float scalar_w,
                    float pair_w, void* stream) {
  const void* vec[] = {q_s, k_s, v_s, v_p, x2d, pa, ct_s, ct_p, g_wx2d, d_vp, d_x2d, wx2d, stats};
  bool bad = H != kH || DK != kDK || Cp < 32 || Cp > kMaxCp || Cp % 32 != 0 || B < 1 || Lq < 1 ||
             Lk < 1 || pa == nullptr;
  for (const void* p : vec) bad = bad || misaligned(p);
  if (bad) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = configure<T>(Cp);
  if (err != cudaSuccess) return (int)err;
  const dim3 rgrid((Lq + kTI - 1) / kTI, B);
  bwd16_rows<T><<<rgrid, kThreads, RowLayout<T>(Cp).total, st>>>(
      static_cast<const T*>(q_s), static_cast<const T*>(k_s), static_cast<const T*>(v_s),
      static_cast<const float*>(q_p), static_cast<const float*>(k_p),
      static_cast<const float*>(v_p), static_cast<const T*>(x2d), static_cast<const float*>(bias),
      static_cast<const T*>(pa), static_cast<const T*>(ct_s), static_cast<const float*>(ct_p),
      static_cast<const float*>(g_wx2d), static_cast<T*>(d_qs), static_cast<float*>(d_qp),
      static_cast<T*>(d_x2d), static_cast<T*>(d_pa), static_cast<float*>(wx2d),
      static_cast<float*>(ds), static_cast<float*>(logits), static_cast<float*>(dvals),
      static_cast<float*>(stats), B, Lq, Lk, Cp, scalar_w, pair_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 cgrid((Lk + 31) / 32, kH / kColHeads, B);
  bwd_cols<T, kH><<<cgrid, kColThreads, kColSmem, st>>>(
      static_cast<const T*>(q_s), static_cast<const float*>(q_p), static_cast<const float*>(k_p),
      static_cast<const T*>(ct_s), static_cast<const float*>(ct_p),
      static_cast<const float*>(stats), static_cast<const float*>(logits),
      static_cast<const float*>(ds), static_cast<T*>(d_ks), static_cast<T*>(d_vs),
      static_cast<float*>(d_kp), static_cast<float*>(d_vp), Lq, Lk, scalar_w);
  return (int)cudaGetLastError();
}

template <typename T>
int row_blocks_per_sm(int Cp) {
  int n = 0;
  if (Cp < 32 || Cp > kMaxCp || Cp % 32 != 0 || configure<T>(Cp) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bwd16_rows<T>, kThreads,
                                                    RowLayout<T>(Cp).total) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). The arguments are those of
// ipa_attention_bwd_tc (ipa_attention_bwd_tc.cu), in the same layouts, with
// H = 16: operands in ipa_attention_fwd's layouts, cotangents ct_s
// [B,H,Lq,16] (model dtype) and ct_p [B,H,Lq,24] f32, g_wx2d = ct_pr @ w_pv^T
// as [H,B,Lq,Cp] f32; writes d_q_s, d_k_s, d_v_s (model dtype), d_q_p, d_k_p,
// d_v_p (f32), d_x2d, d_pa (model dtype), and the scratch wx2d [H,B,Lq,Cp],
// ds, logits and dvals [B,H,Lq,Lk] and the row statistics [B,H,Lq,2], all
// f32. Takes H = 16, DK = 16, Cp a multiple of 32 up to 256 and 16-byte
// aligned tensors, and refuses anything else. ipa_attention_bwd_tc16 takes
// bf16 model operands, ipa_attention_bwd_tc16_f32 f32.
int ipa_attention_bwd_tc16(const void* q_s, const void* k_s, const void* v_s, const void* q_p,
                           const void* k_p, const void* v_p, const void* x2d, const void* bias,
                           const void* pa, const void* ct_s, const void* ct_p, const void* g_wx2d,
                           void* d_qs, void* d_ks, void* d_vs, void* d_qp, void* d_kp, void* d_vp,
                           void* d_x2d, void* d_pa, void* wx2d, void* ds, void* logits,
                           void* dvals, void* stats, int B, int H, int Lq, int Lk, int DK, int Cp,
                           float scalar_w, float pair_w, void* stream) {
  return launch_backward<bf16>(q_s, k_s, v_s, q_p, k_p, v_p, x2d, bias, pa, ct_s, ct_p, g_wx2d,
                               d_qs, d_ks, d_vs, d_qp, d_kp, d_vp, d_x2d, d_pa, wx2d, ds, logits,
                               dvals, stats, B, H, Lq, Lk, DK, Cp, scalar_w, pair_w, stream);
}

int ipa_attention_bwd_tc16_f32(const void* q_s, const void* k_s, const void* v_s, const void* q_p,
                               const void* k_p, const void* v_p, const void* x2d, const void* bias,
                               const void* pa, const void* ct_s, const void* ct_p,
                               const void* g_wx2d, void* d_qs, void* d_ks, void* d_vs, void* d_qp,
                               void* d_kp, void* d_vp, void* d_x2d, void* d_pa, void* wx2d,
                               void* ds, void* logits, void* dvals, void* stats, int B, int H,
                               int Lq, int Lk, int DK, int Cp, float scalar_w, float pair_w,
                               void* stream) {
  return launch_backward<float>(q_s, k_s, v_s, q_p, k_p, v_p, x2d, bias, pa, ct_s, ct_p, g_wx2d,
                                d_qs, d_ks, d_vs, d_qp, d_kp, d_vp, d_x2d, d_pa, wx2d, ds, logits,
                                dvals, stats, B, H, Lq, Lk, DK, Cp, scalar_w, pair_w, stream);
}

// Dynamic shared memory of the row kernel at Cp (bf16, f32) and its resident
// blocks an SM (-1 if the device cannot say); the column kernel's is
// ipa_attention_bwd_cols_smem_bytes (ipa_attention_bwd_tc.cu).
int ipa_attention_bwd_tc16_smem_bytes(int Cp) { return RowLayout<bf16>(Cp).total; }
int ipa_attention_bwd_tc16_f32_smem_bytes(int Cp) { return RowLayout<float>(Cp).total; }
int ipa_attention_bwd_tc16_blocks_per_sm(int Cp) { return row_blocks_per_sm<bf16>(Cp); }
int ipa_attention_bwd_tc16_f32_blocks_per_sm(int Cp) { return row_blocks_per_sm<float>(Cp); }

}  // extern "C"
