// Fused IPA attention core (backward) at 8 heads, the tensor-core design for
// Hopper, sm_90a.
//
// Replaces no Pallas kernel: it is the counterpart of the XLA function
// se3diff_tpu/ops/pallas_ipa.py::_fused_backward_chunked, the backward behind
// fused_ipa_attention_diff's custom VJP, at the widths of a tensor-parallel
// rank at `--mesh model=4` (the bioemu-v1.0 score model's 32 heads split four
// ways): 8 heads of width 16, the streamed pair bias (has_pa) and Cp a
// multiple of 32 up to 256, in bf16 (ipa_attention_bwd_tc8) and in f32
// (ipa_attention_bwd_tc8_f32): one template, two instantiations. It computes
// what ipa_attention_bwd_tc.cu (32 heads) and ipa_attention_bwd_tc16.cu (16
// heads) compute, with their algebra: f32 attention weights a (never rounded
// to the model dtype), dist = sqrt(max(d2, 0) + 1e-24) on explicit f32
// differences with a zero distance subgradient wherever d2 <= 0, D = sum_j a
// dv + g . wx2d from the row aggregate wx2d, ds = a (dv + g . x2d - D), d_pa =
// pair_w ds, no gradient for the column bias, every gradient cast to its
// input's dtype once, at the end; ops/ipa_attention.py::
// ipa_attention_backward_tiled is its arithmetic in PyTorch.
//
// Bound on an H100: bytes, in both dtypes. At B=16 L=100 Cp=256 the call
// moves 351 MB in f32 (x2d read and d_x2d written, 164 MB each), 0.105 ms at
// 3.35 TB/s; at the train CLI's B=16 L=64 bf16, 75 MB, 0.022 ms. Half the
// heads of the 16-head design do half its per-pair work over the same x2d
// bytes, so the bytes bound it the more.
//
// Design, and what it does about the widths:
// * bwd8_rows: a block owns TI=4 query rows of one batch element for all 8
//   heads, so each staged x2d tile serves every head, and is 256 threads: a
//   thread a (row, head, column pair) outside the products, as in the 16- and
//   32-head designs, and each key-side value a block reads from L2 serves 4
//   rows. Two warps a row run the products.
// * At 8 heads a row's m16 tile of heads would be half empty, and two rows
//   cannot share an mma (each has its own x2d slice), so the three x2d
//   contractions are shaped to the 8 heads, as the forward design
//   ipa_attention_tc8.cu takes its product:
//   C1 wx2d^T [Cp x 8] += X_r^T [Cp x 16] a_r^T [16 x 8]: M the channels, N
//      the heads, K the tile's columns (the forward's phase B: ldmatrix.trans
//      on the staged tile in bf16; in f32 an m-tile's fragment rows g, g + 8
//      are channels 2g, 2g + 1, two 8-byte words a lane); the two warps of a
//      row take alternate m-tiles;
//   C2 G [16 x 8] = X_r [16 x Cp] g_r^T [Cp x 8]: M the tile's columns, N the
//      heads, K the channels (the two warps of a row take alternate k-steps,
//      their partial sums added in a fixed order);
//   C3 d_x2d_r [16 x Cp] = a_r^T [16 x 8] g_r [8 x Cp]: M the columns, N the
//      channels, K the 8 heads: mma.sync.m16n8k8 (bf16, both operands by
//      ldmatrix.trans; TF32 native), the two warps of a row take alternate
//      channel pairs of n-tiles.
// * One pass over x2d, where the 16-head design makes two: C2 needs g and
//   x2d but not D, so the sweep that aggregates wx2d (C1) also takes G (C2)
//   and keeps dphat = dv + G in scratch, and writes d_x2d (C3, which needs
//   only a and g). A third sweep without x2d then takes ds = a (dphat - D)
//   and the row gradients, once D is known. x2d is read once, so its copies
//   carry an L2 evict-first policy, as in the forward designs.
// * Two blocks an SM (at most 128 registers a thread, the shared memory
//   below), so one block's barriers and L2 waits hide behind the other's
//   work; so the x2d tile has one stage: its next tile is copied while the
//   threads compute the attention weights and value terms of that tile.
//   The first and third sweeps stage nothing and take no barrier: a thread
//   reads its pa, key side and kept scratch from L1/L2.
// bwd8_rows makes three sweeps over key tiles of TJ=16 columns:
//   1. statistics: the row max and sum of exp, online, from the logits alone
//      (with pa streamed the logits need no x2d); the logits are kept;
//   2. a from the kept logits and dv = ct_s.v_s + ct_p.v_p on CUDA cores;
//      then, on tensor cores, wx2d = sum_j a x2d (C1), G = g.x2d (C2) and
//      d_x2d = sum_h a g (C3, written once); dphat = dv + G kept. After it
//      D = sum_j a dv + g.wx2d, g = g_wx2d = ct_pr @ w_pv^T;
//   3. ds = a (dphat - D), d_pa = pair_w ds, d_q_s and d_q_p summed over the
//      block's columns in registers.
// * bwd_cols (ipa_attention_bwd_common.cuh, shared with the 16- and 32-head
//   designs): the column sums (d_k_s, d_v_s, d_k_p, d_v_p), FlashAttention-2's
//   split: a thread a (head, key column) walks every query row in order,
//   taking a from the kept logits and the saved row statistics, and ds; a
//   warp a head, the 8 heads one block, so its grid is (Lk/32, 1, B).
// Both kernels are deterministic: no atomics, every sum in a fixed order.
// Operands rounded on the tensor cores, as in the 16- and 32-head designs:
// * bf16: x2d is bf16 already and enters as it is. The f32 operands a and g
//   are each split into two bf16 terms (hi + lo, 16 significant bits): C1
//   a_hi X + a_lo X, C2 g_hi X + g_lo X, C3 a_hi g_hi + a_hi g_lo + a_lo g_hi
//   (the lo x lo term dropped).
// * f32: 3xTF32 (big + small TF32 terms, the small x small term dropped).
// Plain products left to torch.bmm outside (ops/ipa_attention.py, as JAX
// leaves them to XLA): g_wx2d = ct_pr @ w_pv^T before, d_w_pv = wx2d^T ct_pr
// after.
// Scratch in device memory, allocated by the caller: g_wx2d and wx2d
// [H, B, Lq, Cp] f32; the logits, dphat and ds [B, H, Lq, Lk] f32; the row
// statistics [B, H, Lq, 2] f32 (max, 1/sum).
//
// Shared memory of bwd8_rows at Cp = 256: 80,128 bytes (bf16), 113,408 (f32)
// (two 256-thread blocks an SM); bwd_cols: 90,112 bytes.
// In bytes, [TI][TJ][Cp + 8] x2d stage 33,792 / 67,584; g [TI][H][Cp + 8] as
// two bf16 terms or one f32, 33,792 either way; the tile's a [TI][H][24] as
// two bf16 terms or [TI][H][20] f32, 3,072 / 2,560; the cotangents ct_s and
// ct_p 5,120; C2's partials 4,096; the row warps' g . wx2d 256.
// ptxas -v (sm_90a; chip_smoke.py phase 1 prints it): bwd8_rows 128
// registers, 8 bytes spilled in both dtypes; bwd_cols<T, 8> 128 registers,
// 32 / 48 bytes spilled (bf16 / f32).

#include <type_traits>

#include "ipa_attention_bwd_common.cuh"

namespace {

constexpr int kH = 8;                      // heads: the N of C1 and C2, the K of C3
constexpr int kTI = 4;                     // query rows a bwd8_rows block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowWarps = kWarps / kTI;    // warps a row in the products
constexpr int kSlots = kMaxCp / 16 / kRowWarps;  // C1 m-tiles / C3 n-tile pairs a warp
constexpr int kPad = 8;                    // x2d and g row padding (elements), both dtypes
static_assert(kRowWarps == 2 && kTI * kRowWarps == kWarps, "two warps a row");
static_assert(kTI * kH * 8 == kThreads, "a thread a (row, head, column pair)");
static_assert(kH == 8 && kH % kColHeads == 0, "the heads are an mma's n8 / k8");

// Shared memory of bwd8_rows, byte offsets of its regions:
//   x2d stage   [TI][TJ][stride] T            (from 0; one stage)
//   gs          terms x [TI][H][stride] T     g_wx2d
//   as          terms x [TI][H][APS] T        the tile's attention weights
//   cts, ctp    [TI][H][DK], [TI][H][24] f32  cotangents of out_s, out_p
//   gp          [TI][RowWarps][TJ][H] f32     C2's partial G, a part a warp
//   dxp         [TI][RowWarps][H] f32         g . wx2d, a part a warp
template <typename T>
struct RowLayout {
  int stride;  // elements between rows of the x2d stage and of g
  int gs, as, cts, ctp, gp, dxp, total;
  __host__ __device__ explicit RowLayout(int Cp) {
    constexpr int kTerms = Tile<T>::kTerms, kSize = (int)sizeof(T);
    stride = Cp + kPad;
    gs = kTI * kTJ * stride * kSize;
    as = gs + kTerms * kTI * kH * stride * kSize;
    cts = as + kTerms * kTI * kH * Tile<T>::kAPS * kSize;
    ctp = cts + kTI * kH * kDK * 4;
    gp = ctp + kTI * kH * kVp * 4;
    dxp = gp + kTI * kRowWarps * kTJ * kH * 4;
    total = dxp + kTI * kRowWarps * kH * 4;
  }
};

// d += a b: a 16x8 bf16 (row), b 8x8 bf16 (col), d 16x8 f32.
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// The x2d rows (i0 + r, j0 + jj, :) of the tile into the stage, [TI][TJ]
// rows of stride elements, zero-filled past Lq and Lk.
template <typename T>
__device__ __forceinline__ void copy_x2d(T* xs, const T* x2d_b, int i0, int j0, int Lq, int Lk,
                                         int Cp, int stride, int tid, uint64_t policy) {
  constexpr int kC = Tile<T>::kChunk;
  const int per_row = Cp / kC;
  for (int e = tid; e < kTI * kTJ * per_row; e += kThreads) {
    const int c = e % per_row, rj = e / per_row, r = rj / kTJ, jj = rj % kTJ;
    const bool ok = i0 + r < Lq && j0 + jj < Lk;
    const T* src = ok ? x2d_b + ((size_t)(i0 + r) * Lk + j0 + jj) * Cp + c * kC : x2d_b;
    cp_async16_hint(xs + rj * stride + c * kC, src, ok ? 16 : 0, policy);
  }
}

// The 12 query-point coordinates (p * 3 + x) of row i, head h.
__device__ __forceinline__ void load_qp(float (&qp)[12], const float* q_p, int b, int h, int i,
                                        int Lq) {
#pragma unroll
  for (int px = 0; px < 12; ++px)
    qp[px] = q_p[(((size_t)b * 3 + px % 3) * kH * kNpts + h * kNpts + px / 3) * Lq + i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
bwd8_rows(const T* __restrict__ q_s, const T* __restrict__ k_s, const T* __restrict__ v_s,
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
  const int S = L.stride;
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = reinterpret_cast<T*>(smem + L.gs);  // bf16: hi [TI][H][S], then lo
  T* as = reinterpret_cast<T*>(smem + L.as);  // bf16: hi [TI][H][APS], then lo
  float* cts_sm = reinterpret_cast<float*>(smem + L.cts);
  float* ctp_sm = reinterpret_cast<float*>(smem + L.ctp);
  float* gp = reinterpret_cast<float*>(smem + L.gp);
  float* dxp_sm = reinterpret_cast<float*>(smem + L.dxp);
  const int gs_elems = kTI * kH * S;
  const int as_elems = kTI * kH * kAPS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, i0 = blockIdx.x * kTI;
  const int ntiles = (Lk + kTJ - 1) / kTJ;
  const T* x2d_b = x2d + (size_t)b * Lq * Lk * Cp;
  const size_t plane = (size_t)kH * kNpts * Lk;
  const float* kp_b = k_p + (size_t)b * 3 * plane;
  const float* bias_b = bias + (size_t)b * Lk;

  // ---- the rows' g and cotangents into shared memory (rows past Lq: the
  // last row's cotangents, never stored; g zero there).
  for (int e = tid; e < kTI * kH * kDK; e += kThreads) {
    const int d = e % kDK, h = (e / kDK) % kH, r = e / (kDK * kH);
    cts_sm[e] = to_f(ct_s[(((size_t)b * kH + h) * Lq + min(i0 + r, Lq - 1)) * kDK + d]);
  }
  for (int e = tid; e < kTI * kH * kVp; e += kThreads) {
    const int c = e % kVp, h = (e / kVp) % kH, r = e / (kVp * kH);
    ctp_sm[e] = ct_p[(((size_t)b * kH + h) * Lq + min(i0 + r, Lq - 1)) * kVp + c];
  }
  for (int e = tid; e < kTI * kH * (Cp / 4); e += kThreads) {
    const int c4 = e % (Cp / 4), h = (e / (Cp / 4)) % kH, r = e / (kH * (Cp / 4));
    const int i = i0 + r;
    const float4 v = i < Lq ? *reinterpret_cast<const float4*>(
                                  g_wx2d + (((size_t)h * B + b) * Lq + i) * Cp + 4 * c4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    const int o = (r * kH + h) * S + 4 * c4;
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
  // A parts: row ar, head ah, columns jj and jj + 8 of each tile; 8 lanes a
  // (row, head), a warp's four heads in one row.
  const int jj = lane & 7, ar = warp / kRowWarps, ah = (warp % kRowWarps) * 4 + (lane >> 3);
  const int ai = i0 + ar, ai_c = min(ai, Lq - 1);
  const float* my_cts = cts_sm + (ar * kH + ah) * kDK;
  const float* my_ctp = ctp_sm + (ar * kH + ah) * kVp;
  const T* ks_bh = k_s + ((size_t)b * kH + ah) * Lk * kDK;
  const T* vs_bh = v_s + ((size_t)b * kH + ah) * Lk * kDK;
  const float* vp_bh = v_p + ((size_t)b * kH + ah) * Lk * kVp;
  const size_t pa_row = (((size_t)b * kH + ah) * Lq + ai_c) * Lk;
  // Products: row pr (= ar) of the block, the warp's share ce of it.
  const int pr = ar, ce = warp % kRowWarps;
  const int g = lane >> 2, q = lane & 3;
  const int npairs = Cp / 16;
  const T* X = xs + pr * kTJ * S;  // the row's x2d tile in the stage
  const T* G_r = gs + pr * kH * S;
  const T* A_r = as + pr * kH * kAPS;

  // ================= sweep 1: row statistics =================
  float row_max, inv_sum;
  {
    float qs[kDK], qp[12];
    load16(q_s + (((size_t)b * kH + ah) * Lq + ai_c) * kDK, qs);
#pragma unroll
    for (int d = 0; d < kDK; ++d) qs[d] *= scalar_w;
    load_qp(qp, q_p, b, ah, ai_c, Lq);
    float m_run = -1e30f, l_run = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      const int j0 = t * kTJ;
      float s[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + jj + 8 * u, jc = min(j, Lk - 1);
        KeyCol kc;
        load_key(kc, ks_bh, kp_b, plane, ah, Lk, jc);
        s[u] = logit_regs(qs, qp, kc) + pair_w * to_f(pa[pa_row + jc]) + bias_b[jc];
        if (j >= Lk) s[u] = -INFINITY;
        else if (ai < Lq) logits[pa_row + j] = s[u];
      }
      const float m_new = fmaxf(m_run, fmaxf(s[0], s[1]));
      l_run = l_run * expf(m_run - m_new) + expf(s[0] - m_new) + expf(s[1] - m_new);
      m_run = m_new;
    }
    row_max = m_run;
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, o));
    float row_sum = l_run * expf(m_run - row_max);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) row_sum += __shfl_xor_sync(0xffffffffu, row_sum, o);
    inv_sum = 1.f / row_sum;
  }
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

  // ================= sweep 2: C1, C2, C3 and dphat =================
  const uint64_t policy = evict_first_policy();
  __syncthreads();  // g, the cotangents and the kept logits
  copy_x2d(xs, x2d_b, i0, 0, Lq, Lk, Cp, S, tid, policy);
  cp_async_commit();
  float acc1[kSlots][4];  // wx2d^T of the warp's m-tiles: [slot][4]
#pragma unroll
  for (int a = 0; a < kSlots; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc1[a][k] = 0.f;
  float dv_run = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int j0 = t * kTJ;
    // A: a and dv of this thread's two columns; a into the tile's buffer.
    float dvk[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int jl = jj + 8 * u, j = j0 + jl;
      const float a = weight(j);
      dvk[u] = value_term(min(j, Lk - 1));
      dv_run = fmaf(a, dvk[u], dv_run);
      const int o = (ar * kH + ah) * kAPS + jl;
      if constexpr (kBf) {
        bf16 hi, lo;
        split_bf16(a, hi, lo);
        as[o] = hi;
        as[as_elems + o] = lo;
      } else {
        as[o] = a;
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // C1: wx2d^T[c][h] += sum_j x2d[pr][j][c] a[pr][h][j], the warp's m-tiles.
    if constexpr (kBf) {
      const uint32_t* brow = reinterpret_cast<const uint32_t*>(A_r + g * kAPS + 2 * q);
      const uint32_t bhi0 = brow[0], bhi1 = brow[4];
      const uint32_t blo0 = brow[as_elems / 2], blo1 = brow[as_elems / 2 + 4];
      const bf16* xa = X + ((lane & 7) + ((lane >> 4) & 1) * 8) * S + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int sl = 0; sl < kSlots; ++sl) {
        const int mt = ce + kRowWarps * sl;
        if (mt < npairs) {
          uint32_t fa[4];
          ldmatrix_x4_trans(fa, xa + mt * 16);
          mma_bf16(acc1[sl], fa, bhi0, bhi1);
          mma_bf16(acc1[sl], fa, blo0, blo1);
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kTJ / 8; ++ks) {
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(A_r[g * kAPS + ks * 8 + q], bb0, bs0);
        split_tf32(A_r[g * kAPS + ks * 8 + q + 4], bb1, bs1);
        const float* xa = X + (ks * 8 + q) * S + 2 * g;
#pragma unroll
        for (int sl = 0; sl < kSlots; ++sl) {
          const int mt = ce + kRowWarps * sl;
          if (mt < npairs) {
            const float2 x0 = *reinterpret_cast<const float2*>(xa + mt * 16);
            const float2 x1 = *reinterpret_cast<const float2*>(xa + 4 * S + mt * 16);
            uint32_t ab[4], asm_[4];
            split_tf32(x0.x, ab[0], asm_[0]);
            split_tf32(x0.y, ab[1], asm_[1]);
            split_tf32(x1.x, ab[2], asm_[2]);
            split_tf32(x1.y, ab[3], asm_[3]);
            mma_3xtf32(acc1[sl], ab, asm_, bb0, bb1, bs0, bs1);
          }
        }
      }
    }

    // C2: G[j][h] = sum_c x2d[pr][j][c] g[pr][h][c], the warp's k-steps.
    {
      float acc2[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (kBf) {
        const bf16* xa = X + (lane & 15) * S + (lane >> 4) * 8;
        const uint32_t* gw = reinterpret_cast<const uint32_t*>(G_r + g * S + 2 * q);
        for (int ks = ce; ks < Cp / 16; ks += kRowWarps) {
          uint32_t fa[4];
          ldmatrix_x4(fa, xa + ks * 16);
          const int w = ks * 8;  // 32-bit words of 16 channels
          mma_bf16(acc2, fa, gw[w + gs_elems / 2], gw[w + 4 + gs_elems / 2]);
          mma_bf16(acc2, fa, gw[w], gw[w + 4]);
        }
      } else {
        // Fragment k-index q is channel 2q of the step, q + 4 channel 2q + 1.
        const float* xa = X + g * S + 2 * q;
        const float* gb = G_r + g * S + 2 * q;
        for (int ks = ce; ks < Cp / 8; ks += kRowWarps) {
          const float2 x0 = *reinterpret_cast<const float2*>(xa + ks * 8);
          const float2 x1 = *reinterpret_cast<const float2*>(xa + 8 * S + ks * 8);
          const float2 gv = *reinterpret_cast<const float2*>(gb + ks * 8);
          uint32_t ab[4], asm_[4], bb0, bs0, bb1, bs1;
          split_tf32(x0.x, ab[0], asm_[0]);
          split_tf32(x1.x, ab[1], asm_[1]);
          split_tf32(x0.y, ab[2], asm_[2]);
          split_tf32(x1.y, ab[3], asm_[3]);
          split_tf32(gv.x, bb0, bs0);
          split_tf32(gv.y, bb1, bs1);
          mma_3xtf32(acc2, ab, asm_, bb0, bb1, bs0, bs1);
        }
      }
      // (column g, heads 2q, 2q + 1) and (column g + 8, the same heads).
      float* gpw = gp + (pr * kRowWarps + ce) * kTJ * kH + 2 * q;
      *reinterpret_cast<float2*>(gpw + g * kH) = make_float2(acc2[0], acc2[1]);
      *reinterpret_cast<float2*>(gpw + (g + 8) * kH) = make_float2(acc2[2], acc2[3]);
    }

    // C3: d_x2d[pr][j][c] = sum_h a[pr][h][j] g[pr][h][c], the warp's
    // channel pairs of n-tiles, written once.
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
              if constexpr (kBf)
                *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
              else
                *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            }
          }
      };
      if constexpr (kBf) {
        // A (columns x heads) and B (heads x channels) both from [head] rows
        // by ldmatrix.trans: hi of columns 0-7, 8-15, then lo.
        uint32_t fa[4];
        ldmatrix_x4_trans(fa, A_r + (lane & 7) * kAPS + ((lane >> 3) & 1) * 8 +
                                  (lane >> 4) * as_elems);
        const bf16* grow = G_r + (lane & 7) * S + ((lane >> 3) & 1) * 8 + (lane >> 4) * gs_elems;
#pragma unroll
        for (int sl = 0; sl < kSlots; ++sl) {
          const int p = ce + kRowWarps * sl;
          if (p < npairs) {
            float acc3[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
            uint32_t fb[4];  // hi of n-tiles 2p, 2p + 1, then lo
            ldmatrix_x4_trans(fb, grow + p * 16);
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              mma_bf16_k8(acc3[x], fa[2], fa[3], fb[x]);
              mma_bf16_k8(acc3[x], fa[0], fa[1], fb[2 + x]);
              mma_bf16_k8(acc3[x], fa[0], fa[1], fb[x]);
            }
            store(p, acc3);
          }
        }
      } else {
        uint32_t ab[4], asm_[4];
        split_tf32(A_r[q * kAPS + g], ab[0], asm_[0]);
        split_tf32(A_r[q * kAPS + g + 8], ab[1], asm_[1]);
        split_tf32(A_r[(q + 4) * kAPS + g], ab[2], asm_[2]);
        split_tf32(A_r[(q + 4) * kAPS + g + 8], ab[3], asm_[3]);
#pragma unroll
        for (int sl = 0; sl < kSlots; ++sl) {
          const int p = ce + kRowWarps * sl;
          if (p < npairs) {
            float acc3[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const float* gb = G_r + q * S + (2 * p + x) * 8 + g;
              uint32_t bb0, bs0, bb1, bs1;
              split_tf32(gb[0], bb0, bs0);
              split_tf32(gb[4 * S], bb1, bs1);
              mma_3xtf32(acc3[x], ab, asm_, bb0, bb1, bs0, bs1);
            }
            store(p, acc3);
          }
        }
      }
    }
    __syncthreads();
    // The stage is free: tile t + 1 lands while the next tile's A part runs.
    if (t + 1 < ntiles) {
      copy_x2d(xs, x2d_b, i0, j0 + kTJ, Lq, Lk, Cp, S, tid, policy);
      cp_async_commit();
    }
    // dphat = dv + G, the two warps' partial G added in a fixed order.
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int jl = jj + 8 * u, j = j0 + jl;
      const float* gpj = gp + (ar * kRowWarps * kTJ + jl) * kH + ah;
      const float G = gpj[0] + gpj[kTJ * kH];
      if (ai < Lq && j < Lk) dvals[pa_row + j] = dvk[u] + G;
    }
  }

  // wx2d to its scratch ([H, B, Lq, Cp], for d_w_pv) and g . wx2d, a
  // partial a warp summed over its channels, then over the 8 lanes of a
  // head pair. Accumulator e of an m-tile is head 2q + (e & 1) at channel
  // g + 8 (e >> 1) (bf16) or 2g + (e >> 1) (f32) of the tile.
  {
    const int i = i0 + pr;
    float dx[2] = {0.f, 0.f};  // heads 2q, 2q + 1
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) {
      const int mt = ce + kRowWarps * sl;
      if (mt < npairs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = 2 * q + (e & 1);
          const int c = mt * 16 + (kBf ? g + 8 * (e >> 1) : 2 * g + (e >> 1));
          const float w = acc1[sl][e];
          if (i < Lq) wx2d_out[(((size_t)h * B + b) * Lq + i) * Cp + c] = w;
          const int o = (pr * kH + h) * S + c;
          float gv;
          if constexpr (kBf)
            gv = to_f(gs[o]) + to_f(gs[gs_elems + o]);
          else
            gv = gs[o];
          dx[e & 1] = fmaf(w, gv, dx[e & 1]);
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = dx[hh];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) dxp_sm[(pr * kRowWarps + ce) * kH + 2 * q + hh] = v;
    }
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) dv_run += __shfl_xor_sync(0xffffffffu, dv_run, o);
  __syncthreads();
  const float row_d = dv_run + (dxp_sm[ar * kRowWarps * kH + ah] +
                                dxp_sm[(ar * kRowWarps + 1) * kH + ah]);  // D

  // ================= sweep 3: ds, d_pa, d_q_s, d_q_p =================
  float qp[12];
  load_qp(qp, q_p, b, ah, ai_c, Lq);
  float dqs[kDK], dqp[12];
#pragma unroll
  for (int d = 0; d < kDK; ++d) dqs[d] = 0.f;
#pragma unroll
  for (int d = 0; d < 12; ++d) dqp[d] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = t * kTJ + jj + 8 * u, jc = min(j, Lk - 1);
      KeyCol kc;
      load_key(kc, ks_bh, kp_b, plane, ah, Lk, jc);
      const float a = weight(j), dphat = j < Lk ? dvals[pa_row + j] : 0.f;
      const float ds = a * (dphat - row_d);
      if (ai < Lq && j < Lk) {
        d_pa[pa_row + j] = from_f<T>(pair_w * ds);
        ds_out[pa_row + j] = ds;
      }
#pragma unroll
      for (int d = 0; d < kDK; ++d) dqs[d] = fmaf(ds, kc.k[d], dqs[d]);
#pragma unroll
      for (int p = 0; p < kNpts; ++p) {
        const float dx = qp[p * 3] - kc.kp[p * 3], dy = qp[p * 3 + 1] - kc.kp[p * 3 + 1],
                    dz = qp[p * 3 + 2] - kc.kp[p * 3 + 2];
        const float w = -ds * inv_dist(dx, dy, dz);
        dqp[p * 3] = fmaf(w, dx, dqp[p * 3]);
        dqp[p * 3 + 1] = fmaf(w, dy, dqp[p * 3 + 1]);
        dqp[p * 3 + 2] = fmaf(w, dz, dqp[p * 3 + 2]);
      }
    }
  }

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
  cudaError_t err = cudaFuncSetAttribute(bwd8_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         RowLayout<T>(Cp).total);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd8_rows<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
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
  bwd8_rows<T><<<rgrid, kThreads, RowLayout<T>(Cp).total, st>>>(
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
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bwd8_rows<T>, kThreads,
                                                    RowLayout<T>(Cp).total) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). The arguments are those of
// ipa_attention_bwd_tc (ipa_attention_bwd_tc.cu), in the same layouts, with
// H = 8: operands in ipa_attention_fwd's layouts, cotangents ct_s
// [B,H,Lq,16] (model dtype) and ct_p [B,H,Lq,24] f32, g_wx2d = ct_pr @ w_pv^T
// as [H,B,Lq,Cp] f32; writes d_q_s, d_k_s, d_v_s (model dtype), d_q_p, d_k_p,
// d_v_p (f32), d_x2d, d_pa (model dtype), and the scratch wx2d [H,B,Lq,Cp],
// ds, logits and dvals (here dphat = dv + G) [B,H,Lq,Lk] and the row
// statistics [B,H,Lq,2], all f32. Takes H = 8, DK = 16, Cp a multiple of 32
// up to 256 and 16-byte aligned tensors, and refuses anything else.
// ipa_attention_bwd_tc8 takes bf16 model operands, ipa_attention_bwd_tc8_f32
// f32.
int ipa_attention_bwd_tc8(const void* q_s, const void* k_s, const void* v_s, const void* q_p,
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

int ipa_attention_bwd_tc8_f32(const void* q_s, const void* k_s, const void* v_s, const void* q_p,
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
int ipa_attention_bwd_tc8_smem_bytes(int Cp) { return RowLayout<bf16>(Cp).total; }
int ipa_attention_bwd_tc8_f32_smem_bytes(int Cp) { return RowLayout<float>(Cp).total; }
int ipa_attention_bwd_tc8_blocks_per_sm(int Cp) { return row_blocks_per_sm<bf16>(Cp); }
int ipa_attention_bwd_tc8_f32_blocks_per_sm(int Cp) { return row_blocks_per_sm<float>(Cp); }

}  // extern "C"
