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
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md; chip_smoke.py phases 6 and
// 19, in turns with the PyTorch backward): 0.289 ms in f32 at B=16 L=100,
// 2.8x the bytes bound (the first design 0.433); 0.096 ms in bf16 at B=16
// L=64, 4.3x (0.161); 0.316 / 0.416 ms at B=40 L=77 with 9 masked columns.
// Of that (scripts/k1_bwd_parts.py tc8, f32 / bf16) bwd8_rows takes 0.226 /
// 0.051 ms, bwd_cols 0.026 / 0.013, bwd_dv 0.011 / 0.005, the d_w_pv bmm
// and its sum 0.017 / 0.011. What limits the row kernel now, by the clock
// (scripts/k1_bwd_variants.py --heads 8 clock: SM cycles of a block, f32
// B=16 L=100 / bf16 L=64): the products 36 / 25%, C3's d_x2d stores the
// most of them (without C3 the call is 19 / 10% shorter; trading lanes'
// pairs into one 8- or 16-byte store a column gained 15% in bf16, where
// two stores wrote half sectors, and nothing in f32); sweep 3 14 / 24%;
// sweep 2's weights and fetch 15 / 11%, its barrier and dphat 13 / 3%
// (there the f32 stage's next tile is copied); set-up 6 / 9%; sweep 1
// 9 / 9%.
//
// Three kernels and a bmm a call, all deterministic (no atomics, every sum in
// a fixed order): bwd_dv (the value terms), bwd8_rows (the row sweeps),
// bwd_cols<T, 8> (the column sums); bwd_dv and bwd_cols are
// ipa_attention_bwd_common.cuh's, shared with the 16- and 32-head designs;
// after them the torch.bmm for d_w_pv = wx2d^T ct_pr (a plain product JAX
// leaves to XLA).
// * bwd8_rows: a block owns TI=4 query rows of one batch element for all 8
//   heads, so each staged x2d tile serves every head; 256 threads, two
//   blocks an SM (at most 128 registers a thread).
// * g = ct_pr @ w_pv^T is formed at its set-up, the block's 4 rows in f32 on
//   CUDA cores, a warp a head: no f32 [8, B, Lq, Cp] tensor goes through
//   device memory for it.
// * Outside the products (sweeps 1, 2's weights and 3) a warp is a head and
//   its lanes two row pairs by a tile's 16 columns: each key-side value a
//   thread loads serves two rows, a warp's loads cover 16 consecutive
//   columns of its head, and every load is issued at the clamped column
//   min(j, Lk - 1), its value dropped past Lk, so that no load waits behind
//   a branch. The rows' q_s scalar_w and q_p are read from shared memory
//   (over the x2d stages in sweeps 1 and 3); a thread's rows' statistics
//   and D stay in its registers.
// * At 8 heads a row's m16 tile of heads would be half empty, and two rows
//   cannot share an mma (each has its own x2d slice), so the three x2d
//   contractions take the 8 heads as mma's N (or K), as the forward design
//   ipa_attention_tc8.cu takes its product; two warps a row:
//   C1 wx2d^T [Cp x 8] += X_r^T [Cp x 16] a_r^T [16 x 8]: M the channels, N
//      the heads, K the tile's columns (ldmatrix.trans on the staged tile in
//      bf16; in f32 an m-tile's fragment rows g, g + 8 are channels 2g,
//      2g + 1, two 8-byte words a lane); the two warps of a row take
//      alternate m-tiles;
//   C2 G [16 x 8] = X_r [16 x Cp] g_r^T [Cp x 8]: M the tile's columns, N the
//      heads, K the channels (the two warps of a row take alternate k-steps,
//      their partial sums added in a fixed order);
//   C3 d_x2d_r [16 x Cp] = a_r^T [16 x 8] g_r [8 x Cp]: M the columns, N the
//      channels, K the 8 heads: mma.sync.m16n8k8 (bf16, both operands by
//      ldmatrix.trans; TF32 native), the two warps of a row take alternate
//      channel pairs of n-tiles.
// * One pass over x2d: G (C2) and d_x2d (C3) need no D, so the sweep that
//   aggregates wx2d (C1) takes them too, keeps dphat = dv + G in scratch and
//   writes d_x2d once; a sweep without x2d then takes ds once D is known.
//   x2d is read once, so its copies carry an L2 evict-first policy, and the
//   outputs no pass reads again (d_x2d, d_pa, wx2d) are streaming stores,
//   which keep the key side and the kept logits in L2 for sweep 3.
// * The x2d tile is staged by cp.async, zero-filled past Lq and Lk: two
//   stages in bf16 (the next tile is copied under this tile's products), one
//   in f32 (copied under dphat and the next tile's weights).
// bwd8_rows makes three sweeps over key tiles of TJ=16 columns:
//   1. statistics: the row max and sum of exp, online, from the logits alone
//      (with pa streamed the logits need no x2d); the logits kept;
//   2. a from the kept logits and dv from bwd_dv's scratch; on tensor cores
//      wx2d = sum_j a x2d (C1), G = g.x2d (C2) and d_x2d = sum_h a g (C3,
//      written once); dphat = dv + G kept. After it D = sum_j a dv +
//      g.wx2d;
//   3. ds = a (dphat - D), d_pa = pair_w ds, d_q_s and d_q_p summed over the
//      block's columns in registers.
//   In sweep 2, C3 runs first, so that its d_x2d stores drain under C1 and
//   C2; each lane trades one n-tile's channel pair with its neighbour and
//   writes 4 consecutive channels a column at once.
// * bwd_cols<T, 8>: the column sums (d_k_s, d_v_s, d_k_p, d_v_p),
//   FlashAttention-2's split, from the kept logits, the saved row statistics
//   and ds; at 8 heads each head's query rows are split over 4 warps of a
//   block, each a contiguous quarter, the parts added in a fixed order, so
//   its grid is (Lk/32, 4, B): 256 blocks at B=16 L=100 where a warp a head
//   gave 64.
// Operands rounded on the tensor cores, as in the 16- and 32-head designs:
// * bf16: x2d is bf16 already and enters as it is. The f32 operands a and g
//   are each split into two bf16 terms (hi + lo, 16 significant bits): C1
//   a_hi X + a_lo X, C2 g_hi X + g_lo X, C3 a_hi g_hi + a_hi g_lo + a_lo g_hi
//   (the lo x lo term dropped).
// * f32: 3xTF32 (big + small TF32 terms, the small x small term dropped),
//   the split by truncation (split_tf32_trunc).
// Scratch in device memory, allocated by the caller: wx2d [H, B, Lq, Cp]
// f32; the logits, dv (then dphat) and ds [B, H, Lq, Lk] f32; the row
// statistics [B, H, Lq, 2] f32 (max, 1/sum).
//
// Shared memory of bwd8_rows at Cp = 256: 108,800 bytes (bf16), 108,288 (f32)
// (two 256-thread blocks an SM); bwd_cols: 90,112 bytes.
// In bytes, the x2d stages [TI][TJ][Cp + 8], two in bf16 and one in f32,
// 67,584 either way (the rows' q_s and q_p [H][TI][28] f32, 3,584, over them
// in sweeps 1 and 3); g [TI][H][Cp + 8] as two bf16 terms or one f32, 33,792
// either way; the tile's a [TI][H][24] as two bf16 terms or [TI][H][20] f32,
// 3,072 / 2,560; C2's partials [TI][2][TJ][H] f32 4,096; the row warps' g .
// wx2d 256.
// ptxas -v (sm_90a; chip_smoke.py phase 1 prints it): bwd8_rows 128
// registers, 4 bytes spilled in bf16, none in f32; bwd_cols<T, 8> 128
// registers, 16 bytes spilled (16 / 40 loaded, bf16 / f32); two blocks an
// SM for both.

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
static_assert(kWarps == kH && (kTI / 2) * kTJ == 32,
              "outside the products a warp a head, a lane a (row pair, column)");
static_assert(kH == 8 && kH % kColHeads == 0, "the heads are an mma's n8 / k8");
// A (head, row)'s operands in shared memory, f32: q_s * scalar_w at 0, the
// query points (p * 3 + x) at kQp.
constexpr int kQp = kDK, kRowF = kQp + 12;
static_assert(kQp % 4 == 0 && kRowF % 4 == 0, "float4 rows");

template <typename T>
constexpr int kStages = std::is_same<T, bf16>::value ? 2 : 1;  // x2d stages

// Shared memory of bwd8_rows, byte offsets of its regions:
//   x2d stages  Stages x [TI][TJ][stride] T  (from 0; in sweeps 1 and 3 the
//               rows' operands [H][TI][RowF] f32: q_s * scalar_w, q_p)
//   gs          terms x [TI][H][stride] T     g = ct_pr @ w_pv^T
//   as          terms x [TI][H][APS] T        the tile's attention weights
//   gp          [TI][RowWarps][TJ][H] f32     C2's partial G, a part a warp
//   dxp         [TI][RowWarps][H] f32         g . wx2d, a part a warp
template <typename T>
struct RowLayout {
  int stride;  // elements between rows of the x2d stage and of g
  int gs, as, gp, dxp, total;
  __host__ __device__ explicit RowLayout(int Cp) {
    constexpr int kTerms = Tile<T>::kTerms, kSize = (int)sizeof(T);
    constexpr int kRowBytes = kTI * kH * kRowF * 4;
    stride = Cp + kPad;
    const int xs_stage = kTI * kTJ * stride * kSize;
    gs = kStages<T> * xs_stage > kRowBytes ? kStages<T> * xs_stage : kRowBytes;
    as = gs + kTerms * kTI * kH * stride * kSize;
    gp = as + kTerms * kTI * kH * Tile<T>::kAPS * kSize;
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

// The x2d rows (i0 + r, j0 + jj, :) of the tile into a stage, [TI][TJ] rows
// of stride elements, zero-filled past Lq and Lk: a warp a row at a time,
// its lanes the row's 16-byte chunks, so no address needs a division by the
// runtime width (with one, issuing the f32 copy took a quarter of a block's
// cycles).
template <typename T>
__device__ __forceinline__ void copy_x2d(T* xs, const T* x2d_b, int i0, int j0, int Lq, int Lk,
                                         int Cp, int stride, int warp, int lane, uint64_t policy) {
  constexpr int kC = Tile<T>::kChunk;
  const int per_row = Cp / kC;
#pragma unroll 1
  for (int rj = warp; rj < kTI * kTJ; rj += kWarps) {
    const int r = rj / kTJ, jj = rj % kTJ;
    const bool ok = i0 + r < Lq && j0 + jj < Lk;
    const T* src = ok ? x2d_b + ((size_t)(i0 + r) * Lk + j0 + jj) * Cp : x2d_b;
    T* dst = xs + rj * stride;
    for (int c = lane; c < per_row; c += 32)
      cp_async16_hint(dst + c * kC, ok ? src + c * kC : x2d_b, ok ? 16 : 0, policy);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
bwd8_rows(const T* __restrict__ q_s, const T* __restrict__ k_s, const float* __restrict__ q_p,
          const float* __restrict__ k_p, const T* __restrict__ x2d,
          const float* __restrict__ bias, const T* __restrict__ pa,
          const float* __restrict__ ct_pr, const T* __restrict__ w_pv,
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
  float* gp = reinterpret_cast<float*>(smem + L.gp);
  float* dxp_sm = reinterpret_cast<float*>(smem + L.dxp);
  float* rows_sm = reinterpret_cast<float*>(smem);  // sweeps 1 and 3, over the x2d stages
  const int xs_elems = kTI * kTJ * S;
  const int gs_elems = kTI * kH * S;
  const int as_elems = kTI * kH * kAPS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, i0 = blockIdx.x * kTI;
  const int ntiles = (Lk + kTJ - 1) / kTJ;
  const T* x2d_b = x2d + (size_t)b * Lq * Lk * Cp;
  const size_t plane = (size_t)kH * kNpts * Lk;
  const float* kp_b = k_p + (size_t)b * 3 * plane;
  const float* bias_b = bias + (size_t)b * Lk;

  // ---- the rows' operands into shared memory, [H][TI] so that a warp's
  // two row pairs read other banks (rows past Lq: the last row's, never
  // stored).
  auto load_qp_rows = [&]() {
    for (int e = tid; e < kTI * kH * 12; e += kThreads) {
      const int px = e % 12, r = (e / 12) % kTI, h = e / (12 * kTI);
      rows_sm[(h * kTI + r) * kRowF + kQp + px] =
          q_p[(((size_t)b * 3 + px % 3) * kH * kNpts + h * kNpts + px / 3) * Lq +
              min(i0 + r, Lq - 1)];
    }
  };
  load_qp_rows();
  for (int e = tid; e < kTI * kH * kDK; e += kThreads) {
    const int d = e % kDK, r = (e / kDK) % kTI, h = e / (kDK * kTI);
    rows_sm[(h * kTI + r) * kRowF + d] =
        to_f(q_s[(((size_t)b * kH + h) * Lq + min(i0 + r, Lq - 1)) * kDK + d]) * scalar_w;
  }
  {
    // g = ct_pr @ w_pv^T of the block's rows (zero past Lq), in f32 on CUDA
    // cores: a warp a head, a lane channels lane + 32 k, so a warp reads 32
    // neighbouring rows of w_pv[h] (an L2-resident 8 kB a head in bf16, read
    // by every block) and writes 32 neighbouring channels of g.
    const int h = warp;
    float ct[kTI][kDK];
#pragma unroll
    for (int r = 0; r < kTI; ++r) {
      if (i0 + r < Lq) {
        load16(ct_pr + (((size_t)b * kH + h) * Lq + i0 + r) * kDK, ct[r]);
      } else {
#pragma unroll
        for (int d = 0; d < kDK; ++d) ct[r][d] = 0.f;
      }
    }
    const T* wh = w_pv + (size_t)h * Cp * kDK;
#pragma unroll 2
    for (int c = lane; c < Cp; c += 32) {
      float w[kDK];
      load16(wh + (size_t)c * kDK, w);
#pragma unroll
      for (int r = 0; r < kTI; ++r) {
        float v = 0.f;
#pragma unroll
        for (int d = 0; d < kDK; ++d) v = fmaf(ct[r][d], w[d], v);
        const int o = (r * kH + h) * S + c;
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
  // Outside the products: a warp is head ah, its lanes row pair rp (rows
  // 2 rp and 2 rp + 1 of the block, u = 0, 1) by column jl of a tile.
  const int ah = warp, rp = lane >> 4, jl = lane & 15;
  size_t row[2];  // (b, ah, row) * Lk; rows past Lq take the last row
#pragma unroll
  for (int u = 0; u < 2; ++u)
    row[u] = (((size_t)b * kH + ah) * Lq + min(i0 + 2 * rp + u, Lq - 1)) * Lk;
  const float* rows_mine = rows_sm + (ah * kTI + 2 * rp) * kRowF;  // row u at + u kRowF
  const T* ks_bh = k_s + ((size_t)b * kH + ah) * Lk * kDK;
  // Products: row pr of the block, the warp's share ce of it.
  const int pr = warp / kRowWarps, ce = warp % kRowWarps;
  const int g = lane >> 2, q = lane & 3;
  const int npairs = Cp / 16;

  // ================= sweep 1: row statistics; the logits kept =================
  __syncthreads();  // the rows' operands
  float row_max[2], inv_sum[2];
  {
    float m_run[2] = {-1e30f, -1e30f}, l_run[2] = {0.f, 0.f};
#pragma unroll 2
    for (int t = 0; t < ntiles; ++t) {
      const int j = t * kTJ + jl, jc = min(j, Lk - 1);
      KeyCol kc;
      load_key(kc, ks_bh, kp_b, plane, ah, Lk, jc);
      const float bj = bias_b[jc];
      float pav[2];  // every load of the column issued before the arithmetic
#pragma unroll
      for (int u = 0; u < 2; ++u) pav[u] = to_f(pa[row[u] + jc]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* rs = rows_mine + u * kRowF;
        float s = logit_core(rs, rs + kQp, kc) + pair_w * pav[u] + bj;
        if (j >= Lk) s = -INFINITY;
        else if (i0 + 2 * rp + u < Lq) logits[row[u] + j] = s;
        const float m_new = fmaxf(m_run[u], s);
        l_run[u] = l_run[u] * expf(m_run[u] - m_new) + expf(s - m_new);
        m_run[u] = m_new;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float mx = m_run[u];
#pragma unroll
      for (int o = 1; o < kTJ; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = l_run[u] * expf(m_run[u] - mx);
#pragma unroll
      for (int o = 1; o < kTJ; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      row_max[u] = mx;
      inv_sum[u] = 1.f / sum;
      const int i = i0 + 2 * rp + u;
      if (jl == 0 && i < Lq)
        *reinterpret_cast<float2*>(stats_out + (((size_t)b * kH + ah) * Lq + i) * 2) =
            make_float2(mx, inv_sum[u]);
    }
  }

  // The kept logits (-inf past Lk) and dv of this thread's rows at column jl
  // of tile t (rows past Lq read the last row's, written before the block's
  // barrier). Past Lk the last column is read and its value dropped: no
  // load waits on a branch.
  auto fetch = [&](int t, float (&lg)[2], float (&dv)[2]) {
    const int j = t * kTJ + jl, jc = min(j, Lk - 1);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      lg[u] = logits[row[u] + jc];
      dv[u] = dvals[row[u] + jc];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      lg[u] = j < Lk ? lg[u] : -INFINITY;
      dv[u] = j < Lk ? dv[u] : 0.f;
    }
  };

  // ================= sweep 2: C1, C2, C3 and dphat =================
  const uint64_t policy = evict_first_policy();
  auto copy_tile = [&](int t) {
    copy_x2d(xs + (t % kStages<T>) * xs_elems, x2d_b, i0, t * kTJ, Lq, Lk, Cp, S, warp, lane,
             policy);
    cp_async_commit();
  };
  __syncthreads();  // sweep 1's reads of the rows' operands; the kept logits
  copy_tile(0);
  float acc1[kSlots][4];  // wx2d^T of the warp's m-tiles: [slot][4]
#pragma unroll
  for (int a = 0; a < kSlots; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc1[a][k] = 0.f;
  float dv_run[2] = {0.f, 0.f}, lg[2], dvk[2];
  fetch(0, lg, dvk);
  for (int t = 0; t < ntiles; ++t) {
    const int j0 = t * kTJ;
    // A: a of this thread's column into the tile's buffer; the next tile's
    // logits and dv fetched under the products.
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float a = expf(lg[u] - row_max[u]) * inv_sum[u];
      dv_run[u] = fmaf(a, dvk[u], dv_run[u]);
      const int o = ((2 * rp + u) * kH + ah) * kAPS + jl;
      if constexpr (kBf) {
        bf16 hi, lo;
        split_bf16(a, hi, lo);
        as[o] = hi;
        as[as_elems + o] = lo;
      } else {
        as[o] = a;
      }
    }
    float lg_n[2], dv_n[2];
    fetch(min(t + 1, ntiles - 1), lg_n, dv_n);
    cp_async_wait_all();
    __syncthreads();
    if (kStages<T> == 2 && t + 1 < ntiles) copy_tile(t + 1);
    const T* X = xs + (t % kStages<T>) * xs_elems + pr * kTJ * S;  // the row's x2d tile
    const T* G_r = gs + pr * kH * S;
    const T* A_r = as + pr * kH * kAPS;

    // C3: d_x2d[pr][j][c] = sum_h a[pr][h][j] g[pr][h][c], the warp's
    // channel pairs of n-tiles, written once; first, so that its stores
    // drain under C1 and C2, which touch no device memory.
    {
      const int i = i0 + pr;
      // A channel pair of n-tiles (16 channels from 16 p) to d_x2d: lane q
      // holds channels 2q, 2q + 1 of each n-tile at columns g and g + 8;
      // it trades one n-tile's pair with lane q ^ 1, so that an even lane
      // holds channels 4 (q / 2) .. + 3 of the first n-tile, an odd one
      // those of the second, and writes them in one 8-byte (bf16) or
      // 16-byte (f32) store a column: a warp's store then fills whole
      // 32-byte sectors of each column, which two bf16 stores of half the
      // width would fill by halves.
      auto store = [&](int p, const float (&acc3)[2][4]) {
        if (i >= Lq) return;  // the warp's row: the same for every lane
        const bool odd = q & 1;
        const int c = p * 16 + (odd ? 8 : 0) + (q >> 1) * 4;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int j = j0 + g + 8 * hf;
          // Selects, not a runtime index, so that acc3 stays in registers.
          const float keep[2] = {odd ? acc3[1][2 * hf] : acc3[0][2 * hf],
                                 odd ? acc3[1][2 * hf + 1] : acc3[0][2 * hf + 1]};
          const float give[2] = {odd ? acc3[0][2 * hf] : acc3[1][2 * hf],
                                 odd ? acc3[0][2 * hf + 1] : acc3[1][2 * hf + 1]};
          T* dst = d_x2d + (((size_t)b * Lq + i) * Lk + min(j, Lk - 1)) * Cp + c;
          if constexpr (kBf) {
            const __nv_bfloat162 k = __floats2bfloat162_rn(keep[0], keep[1]);
            const __nv_bfloat162 s = __floats2bfloat162_rn(give[0], give[1]);
            const unsigned int kw = *reinterpret_cast<const unsigned int*>(&k);
            const unsigned int rw =
                __shfl_xor_sync(0xffffffffu, *reinterpret_cast<const unsigned int*>(&s), 1);
            if (j < Lk) __stcs(reinterpret_cast<uint2*>(dst), odd ? make_uint2(rw, kw)
                                                                  : make_uint2(kw, rw));
          } else {
            const float r0 = __shfl_xor_sync(0xffffffffu, give[0], 1);
            const float r1 = __shfl_xor_sync(0xffffffffu, give[1], 1);
            if (j < Lk)
              __stcs(reinterpret_cast<float4*>(dst),
                     odd ? make_float4(r0, r1, keep[0], keep[1])
                         : make_float4(keep[0], keep[1], r0, r1));
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
        split_tf32_trunc(A_r[q * kAPS + g], ab[0], asm_[0]);
        split_tf32_trunc(A_r[q * kAPS + g + 8], ab[1], asm_[1]);
        split_tf32_trunc(A_r[(q + 4) * kAPS + g], ab[2], asm_[2]);
        split_tf32_trunc(A_r[(q + 4) * kAPS + g + 8], ab[3], asm_[3]);
#pragma unroll
        for (int sl = 0; sl < kSlots; ++sl) {
          const int p = ce + kRowWarps * sl;
          if (p < npairs) {
            float acc3[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const float* gb = G_r + q * S + (2 * p + x) * 8 + g;
              uint32_t bb0, bs0, bb1, bs1;
              split_tf32_trunc(gb[0], bb0, bs0);
              split_tf32_trunc(gb[4 * S], bb1, bs1);
              mma_3xtf32(acc3[x], ab, asm_, bb0, bb1, bs0, bs1);
            }
            store(p, acc3);
          }
        }
      }
    }

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
        split_tf32_trunc(A_r[g * kAPS + ks * 8 + q], bb0, bs0);
        split_tf32_trunc(A_r[g * kAPS + ks * 8 + q + 4], bb1, bs1);
        const float* xa = X + (ks * 8 + q) * S + 2 * g;
#pragma unroll
        for (int sl = 0; sl < kSlots; ++sl) {
          const int mt = ce + kRowWarps * sl;
          if (mt < npairs) {
            const float2 x0 = *reinterpret_cast<const float2*>(xa + mt * 16);
            const float2 x1 = *reinterpret_cast<const float2*>(xa + 4 * S + mt * 16);
            uint32_t ab[4], asm_[4];
            split_tf32_trunc(x0.x, ab[0], asm_[0]);
            split_tf32_trunc(x0.y, ab[1], asm_[1]);
            split_tf32_trunc(x1.x, ab[2], asm_[2]);
            split_tf32_trunc(x1.y, ab[3], asm_[3]);
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
          split_tf32_trunc(x0.x, ab[0], asm_[0]);
          split_tf32_trunc(x1.x, ab[1], asm_[1]);
          split_tf32_trunc(x0.y, ab[2], asm_[2]);
          split_tf32_trunc(x1.y, ab[3], asm_[3]);
          split_tf32_trunc(gv.x, bb0, bs0);
          split_tf32_trunc(gv.y, bb1, bs1);
          mma_3xtf32(acc2, ab, asm_, bb0, bb1, bs0, bs1);
        }
      }
      // (column g, heads 2q, 2q + 1) and (column g + 8, the same heads).
      float* gpw = gp + (pr * kRowWarps + ce) * kTJ * kH + 2 * q;
      *reinterpret_cast<float2*>(gpw + g * kH) = make_float2(acc2[0], acc2[1]);
      *reinterpret_cast<float2*>(gpw + (g + 8) * kH) = make_float2(acc2[2], acc2[3]);
    }
    __syncthreads();  // G; the stage read
    if (kStages<T> == 1 && t + 1 < ntiles) copy_tile(t + 1);
    // dphat = dv + G, the two warps' partial G added in a fixed order.
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = 2 * rp + u, j = j0 + jl;
      const float* gpj = gp + (r * kRowWarps * kTJ + jl) * kH + ah;
      const float G = gpj[0] + gpj[kTJ * kH];
      if (i0 + r < Lq && j < Lk) dvals[row[u] + j] = dvk[u] + G;
      lg[u] = lg_n[u];
      dvk[u] = dv_n[u];
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
          if (i < Lq) __stcs(wx2d_out + (((size_t)h * B + b) * Lq + i) * Cp + c, w);
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
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int o = 1; o < kTJ; o <<= 1) dv_run[u] += __shfl_xor_sync(0xffffffffu, dv_run[u], o);
  load_qp_rows();  // the stages are read
  __syncthreads();
  float row_d[2];  // D
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float* dxr = dxp_sm + (2 * rp + u) * kRowWarps * kH + ah;
    row_d[u] = dv_run[u] + (dxr[0] + dxr[kH]);
  }

  // ================= sweep 3: ds, d_pa, d_q_s, d_q_p =================
  // Sweep 1's roles: each key-side value a thread loads serves its two rows.
  {
    float dqs[2][kDK], dqp[2][12];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int d = 0; d < kDK; ++d) dqs[u][d] = 0.f;
#pragma unroll
      for (int d = 0; d < 12; ++d) dqp[u][d] = 0.f;
    }
    for (int t = 0; t < ntiles; ++t) {
      const int j = t * kTJ + jl, jc = min(j, Lk - 1);
      KeyCol kc;
      load_key(kc, ks_bh, kp_b, plane, ah, Lk, jc);
      float lgv[2], dph[2];  // past Lk the last column's, dropped
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        lgv[u] = logits[row[u] + jc];
        dph[u] = dvals[row[u] + jc];
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float a = j < Lk ? expf(lgv[u] - row_max[u]) * inv_sum[u] : 0.f;
        const float dphat = j < Lk ? dph[u] : 0.f;
        const float ds = a * (dphat - row_d[u]);
        if (i0 + 2 * rp + u < Lq && j < Lk) {
          if constexpr (kBf) {
            const bf16 v = from_f<T>(pair_w * ds);
            __stcs(reinterpret_cast<unsigned short*>(d_pa + row[u] + j),
                   *reinterpret_cast<const unsigned short*>(&v));
          } else {
            __stcs(reinterpret_cast<float*>(d_pa + row[u] + j), pair_w * ds);
          }
          ds_out[row[u] + j] = ds;
        }
#pragma unroll
        for (int d = 0; d < kDK; ++d) dqs[u][d] = fmaf(ds, kc.k[d], dqs[u][d]);
        const float* qp = rows_mine + u * kRowF + kQp;
#pragma unroll
        for (int p = 0; p < kNpts; ++p) {
          const float dx = qp[p * 3] - kc.kp[p * 3], dy = qp[p * 3 + 1] - kc.kp[p * 3 + 1],
                      dz = qp[p * 3 + 2] - kc.kp[p * 3 + 2];
          const float w = -ds * inv_dist(dx, dy, dz);
          dqp[u][p * 3] = fmaf(w, dx, dqp[u][p * 3]);
          dqp[u][p * 3 + 1] = fmaf(w, dy, dqp[u][p * 3 + 1]);
          dqp[u][p * 3 + 2] = fmaf(w, dz, dqp[u][p * 3 + 2]);
        }
      }
    }
    // d_q_s and d_q_p: the 16 lanes of a row pair summed; lane jl writes
    // value jl.
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int d = 0; d < kDK; ++d)
#pragma unroll
        for (int o = 1; o < kTJ; o <<= 1) dqs[u][d] += __shfl_xor_sync(0xffffffffu, dqs[u][d], o);
#pragma unroll
      for (int d = 0; d < 12; ++d)
#pragma unroll
        for (int o = 1; o < kTJ; o <<= 1) dqp[u][d] += __shfl_xor_sync(0xffffffffu, dqp[u][d], o);
      const int i = i0 + 2 * rp + u;
      if (i < Lq) {
        T* dst = d_qs + (((size_t)b * kH + ah) * Lq + i) * kDK;
#pragma unroll
        for (int d = 0; d < kDK; ++d)
          if (d == jl) dst[d] = from_f<T>(scalar_w * dqs[u][d]);
#pragma unroll
        for (int px = 0; px < 12; ++px)
          if (px == jl)
            d_qp[(((size_t)b * 3 + px % 3) * kH * kNpts + ah * kNpts + px / 3) * Lq + i] =
                dqp[u][px];
      }
    }
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

// The C entries' call: operands in ipa_attention_fwd's layouts, checked
// (8 heads of width DK, Cp a multiple of 32 up to 256, 16-byte aligned
// tensors), then bwd_dv, bwd8_rows and bwd_cols on the stream.
template <typename T>
int launch_backward(const void* q_s, const void* k_s, const void* v_s, const void* q_p,
                    const void* k_p, const void* v_p, const void* x2d, const void* bias,
                    const void* pa, const void* ct_s, const void* ct_p, const void* ct_pr,
                    const void* w_pv, void* d_qs, void* d_ks, void* d_vs, void* d_qp, void* d_kp,
                    void* d_vp, void* d_x2d, void* d_pa, void* wx2d, void* ds, void* logits,
                    void* dvals, void* stats, int B, int H, int Lq, int Lk, int DK, int Cp,
                    float scalar_w, float pair_w, void* stream) {
  const void* vec[] = {q_s, k_s, v_s, v_p, x2d, pa, ct_s, ct_p, ct_pr, w_pv, d_vp, d_x2d, wx2d,
                       stats};
  bool bad = H != kH || DK != kDK || Cp < 32 || Cp > kMaxCp || Cp % 32 != 0 || B < 1 || Lq < 1 ||
             Lk < 1 || pa == nullptr;
  for (const void* p : vec) bad = bad || misaligned(p);
  if (bad) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = configure<T>(Cp);
  if (err != cudaSuccess) return (int)err;
  const dim3 dgrid((Lk + kDvThreads - 1) / kDvThreads, (Lq + kDvRows - 1) / kDvRows, B * kH);
  bwd_dv<T><<<dgrid, kDvThreads, 0, st>>>(
      static_cast<const T*>(v_s), static_cast<const float*>(v_p), static_cast<const T*>(ct_s),
      static_cast<const float*>(ct_p), static_cast<float*>(dvals), Lq, Lk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 rgrid((Lq + kTI - 1) / kTI, B);
  bwd8_rows<T><<<rgrid, kThreads, RowLayout<T>(Cp).total, st>>>(
      static_cast<const T*>(q_s), static_cast<const T*>(k_s), static_cast<const float*>(q_p),
      static_cast<const float*>(k_p), static_cast<const T*>(x2d), static_cast<const float*>(bias),
      static_cast<const T*>(pa), static_cast<const float*>(ct_pr), static_cast<const T*>(w_pv),
      static_cast<T*>(d_qs), static_cast<float*>(d_qp), static_cast<T*>(d_x2d),
      static_cast<T*>(d_pa), static_cast<float*>(wx2d), static_cast<float*>(ds),
      static_cast<float*>(logits), static_cast<float*>(dvals), static_cast<float*>(stats), B, Lq,
      Lk, Cp, scalar_w, pair_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 cgrid((Lk + 31) / 32, kH * kColParts<kH> / kColHeads, B);
  bwd_cols<T, kH><<<cgrid, kColThreads, kColSmem, st>>>(
      static_cast<const T*>(q_s), static_cast<const float*>(q_p), static_cast<const float*>(k_p),
      static_cast<const T*>(ct_s), static_cast<const float*>(ct_p),
      static_cast<const float*>(stats), static_cast<const float*>(logits),
      static_cast<const float*>(ds), static_cast<T*>(d_ks), static_cast<T*>(d_vs),
      static_cast<float*>(d_kp), static_cast<float*>(d_vp), Lq, Lk, scalar_w);
  return (int)cudaGetLastError();
}

// Resident blocks an SM of the row kernel at Cp and of the column kernel
// (-1 if the device cannot say).
template <typename T>
int row_blocks_per_sm(int Cp) {
  int n = 0;
  if (Cp < 32 || Cp > kMaxCp || Cp % 32 != 0 || configure<T>(Cp) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bwd8_rows<T>, kThreads,
                                                    RowLayout<T>(Cp).total) != cudaSuccess)
    return -1;
  return n;
}

template <typename T>
int col_blocks_per_sm() {
  int n = 0;
  if (configure<T>(kMaxCp) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bwd_cols<T, kH>, kColThreads,
                                                    kColSmem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). The arguments are those of
// ipa_attention_bwd_tc (ipa_attention_bwd_tc.cu), in the same layouts, with
// H = 8: operands in ipa_attention_fwd's layouts, w_pv [H,Cp,16] in the
// model dtype, cotangents ct_s [B,H,Lq,16] (model dtype), ct_p [B,H,Lq,24]
// and ct_pr [B,H,Lq,16] f32; writes d_q_s, d_k_s, d_v_s (model dtype),
// d_q_p, d_k_p, d_v_p (f32), d_x2d, d_pa (model dtype), and the scratch
// wx2d [H,B,Lq,Cp], ds, logits and dvals (dv, then dphat = dv + G)
// [B,H,Lq,Lk] and the row statistics [B,H,Lq,2], all f32. Takes H = 8,
// DK = 16, Cp a multiple of 32 up to 256 and 16-byte aligned tensors, and
// refuses anything else. ipa_attention_bwd_tc8 takes bf16 model operands,
// ipa_attention_bwd_tc8_f32 f32.
int ipa_attention_bwd_tc8(const void* q_s, const void* k_s, const void* v_s, const void* q_p,
                          const void* k_p, const void* v_p, const void* x2d, const void* bias,
                          const void* pa, const void* ct_s, const void* ct_p, const void* ct_pr,
                          const void* w_pv, void* d_qs, void* d_ks, void* d_vs, void* d_qp,
                          void* d_kp, void* d_vp, void* d_x2d, void* d_pa, void* wx2d, void* ds,
                          void* logits, void* dvals, void* stats, int B, int H, int Lq, int Lk,
                          int DK, int Cp, float scalar_w, float pair_w, void* stream) {
  return launch_backward<bf16>(q_s, k_s, v_s, q_p, k_p, v_p, x2d, bias, pa, ct_s, ct_p, ct_pr,
                               w_pv, d_qs, d_ks, d_vs, d_qp, d_kp, d_vp, d_x2d, d_pa, wx2d, ds,
                               logits, dvals, stats, B, H, Lq, Lk, DK, Cp, scalar_w, pair_w,
                               stream);
}

int ipa_attention_bwd_tc8_f32(const void* q_s, const void* k_s, const void* v_s, const void* q_p,
                              const void* k_p, const void* v_p, const void* x2d, const void* bias,
                              const void* pa, const void* ct_s, const void* ct_p,
                              const void* ct_pr, const void* w_pv, void* d_qs, void* d_ks,
                              void* d_vs, void* d_qp, void* d_kp, void* d_vp, void* d_x2d,
                              void* d_pa, void* wx2d, void* ds, void* logits, void* dvals,
                              void* stats, int B, int H, int Lq, int Lk, int DK, int Cp,
                              float scalar_w, float pair_w, void* stream) {
  return launch_backward<float>(q_s, k_s, v_s, q_p, k_p, v_p, x2d, bias, pa, ct_s, ct_p, ct_pr,
                                w_pv, d_qs, d_ks, d_vs, d_qp, d_kp, d_vp, d_x2d, d_pa, wx2d, ds,
                                logits, dvals, stats, B, H, Lq, Lk, DK, Cp, scalar_w, pair_w,
                                stream);
}

// Dynamic shared memory of the row kernel at Cp (bf16, f32) and its resident
// blocks an SM, and the column kernel's resident blocks an SM (-1 if the
// device cannot say); the column kernel's shared memory is
// ipa_attention_bwd_cols_smem_bytes (ipa_attention_bwd_tc.cu).
int ipa_attention_bwd_tc8_smem_bytes(int Cp) { return RowLayout<bf16>(Cp).total; }
int ipa_attention_bwd_tc8_f32_smem_bytes(int Cp) { return RowLayout<float>(Cp).total; }
int ipa_attention_bwd_tc8_blocks_per_sm(int Cp) { return row_blocks_per_sm<bf16>(Cp); }
int ipa_attention_bwd_tc8_f32_blocks_per_sm(int Cp) { return row_blocks_per_sm<float>(Cp); }
int ipa_attention_bwd_tc8_cols_blocks_per_sm() { return col_blocks_per_sm<bf16>(); }
int ipa_attention_bwd_tc8_f32_cols_blocks_per_sm() { return col_blocks_per_sm<float>(); }

}  // extern "C"
