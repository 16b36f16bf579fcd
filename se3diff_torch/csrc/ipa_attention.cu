// Fused IPA attention core (forward) for Hopper, sm_90a.
//
// Replaces the TPU kernel se3diff_tpu/ops/pallas_ipa.py::_kernel, launched by
// fused_ipa_attention, in both of its variants. For batch b, query row i, key
// column j and head h it computes
//
//   s[h,i,j] = scalar_w <q_s, k_s> - sum_{p<4} sqrt(max(|q_p - k_p|^2, 0) + 1e-24)
//              + pair_w pa[h,i,j] + bias[j]
//   a        = softmax_j(s)                       (online, f32)
//   out_s    = sum_j a v_s                        [B,H,Lq,dk]   model dtype
//   out_p    = sum_j a v_p                        [B,H,Lq,24]   f32
//   out_pair = (sum_j a x2d[i,j,:]) @ w_pv[h]     [B,H,Lq,dk]   model dtype
//
// with the pair bias pa either streamed from device memory (`has_pa=True`,
// pa [B,H,Lq,Lk]) or computed here from the tile's x2d as
// pa[h,i,j] = sum_p x2d[i,j,p] w_pb[p,h] (`has_pa=False`, pallas_ipa.py:399-406:
// w_pb [Cp,H] f32 rounded to x2d's dtype, f32 sums, pa itself never rounded).
//
// Layouts (the JAX kernel's): q/k/v_s [B,H,L,dk]; point planes [B,3,H*4,L] f32,
// pre-scaled by 0.5*point_weight[h]; v_p [B,H,Lk,24] f32; x2d [B,Lq,Lk,Cp];
// pa [B,H,Lq,Lk]; w_pv [H,Cp,dk]; bias [B,Lk] f32 (NEG_INF = -1e30 at masked
// columns, so the online softmax never meets inf - inf). Heads: 32 (the score
// model), 4 (the PPFT control net), 8 or 16, of width 16 or 8 (the training
// example's 4 heads of 8). Every width the card takes that no other design
// takes runs here; this design stays compiled for the other designs' widths
// as their yardstick.
//
// Bound on an H100: bytes. At the sampling shape (B=40, L=100, H=32, dk=16,
// Cp=256, bf16) a launch must read 204.8 MB of x2d, 25.6 MB of pa and about
// 37 MB of everything else and write 20 MB: 288 MB, 86 us at 3.35 TB/s.
// Design, and why:
// * x2d is read from device memory once: a block owns TI=4 query rows of one
//   batch element for ALL heads, so each x2d row segment serves every head.
//   The TPU program keeps an f32 [ti, H, Cp] aggregate (4 MiB at ti=128) in
//   VMEM; here the aggregate of the 4 rows (128 KB at 32 heads) lives in the
//   registers of the block's 16*H threads (4 rows x 4 heads x 4 channels
//   each), so it never touches shared or device memory until the finalize.
// * Every block also reads the key side of its batch element (k_s, v_s, key
//   points, v_p: ~0.66 MB at L=100, from L2). Four rows a block amortise
//   that four ways; the register budget of the aggregate caps TI at 4.
// * Per key tile of 32 columns, phase A gives each warp two heads with one
//   column per lane: coalesced loads of k_s rows, point planes and pa,
//   warp-shuffle max/sum for the online softmax, and the v_s/v_p sums for
//   its heads, kDK lanes a head's v_s channels and the rest its v_p ones (at
//   width 8 a head's 32 value channels fill one warp). Phase B: all threads
//   accumulate the x2d aggregate from the tile's probabilities in shared
//   memory. A block has 16 threads a head at either width, so phase B
//   covers Cp <= 256 with the same registers at width 8.
// * has_pa=False: w_pb (at most 32 KB) is staged in shared memory once per
//   block, and before phase A the block computes the tile's [TJ, TI, H] pair
//   bias from x2d into shared memory, each thread one (column, row) and up to
//   8 heads. The logits need x2d before the softmax and phase B needs it
//   after, so this version reads each x2d tile twice, the second time from
//   L2 (prefetched); staging the tile once is later work.
// * The finalize stages the aggregate in shared memory and multiplies by
//   w_pv, read once per block for its 4 rows.
// Point distances are explicit differences in f32 on the CUDA cores (no
// TF32). In bf16 mode the probabilities that multiply v_s and x2d are
// rounded to bf16 first, as the TPU kernel does; every sum is f32. Ragged
// tails (j >= Lk, i >= Lq) are masked here, so callers never pad. At 4 heads
// a block is 64 threads and phase B keeps only Cp/4 of them busy: correct,
// slow per byte.
// This version uses CUDA-core FMAs. ipa_attention_tc.cu stages x2d by
// cp.async and runs phase B on tensor cores, for bf16 at 32 heads.
// The kernel template and its launchers are in ipa_attention_simt.cuh; this
// file instantiates heads of width 16 and holds the C entry, and
// ipa_attention_w8.cu the width-8 instances (nvcc builds the two in
// parallel: the 32 instances of one file took 49 s).

#include "ipa_attention_simt.cuh"

extern "C" {

// ipa_attention_w8.cu: this function's arguments, at heads of width 8.
int ipa_attention_simt8_fwd(const void* q_s, const void* k_s, const void* v_s, const void* q_p,
                            const void* k_p, const void* v_p, const void* x2d, const void* w_pv,
                            const void* bias, const void* pa, const void* w_pb, void* out_s,
                            void* out_p, void* out_pair, int B, int H, int Lq, int Lk, int Cp,
                            int is_bf16, int has_pa, float scalar_w, float pair_w, void* stream);

// Returns a cudaError_t (0 on success). The caller has validated shapes,
// dtypes, contiguity and alignment; unsupported head counts and widths are
// refused here.
// has_pa != 0 streams pa [B,H,Lq,Lk]; has_pa == 0 computes it from x2d and
// w_pb [Cp,H] f32.
int ipa_attention_fwd(const void* q_s, const void* k_s, const void* v_s, const void* q_p,
                      const void* k_p, const void* v_p, const void* x2d, const void* w_pv,
                      const void* bias, const void* pa, const void* w_pb, void* out_s,
                      void* out_p, void* out_pair, int B, int H, int Lq, int Lk, int DK,
                      int Cp, int is_bf16, int has_pa, float scalar_w, float pair_w,
                      void* stream) {
  if ((DK != 8 && DK != 16) || Cp < kCQ || Cp > kMaxCp || Cp % kCQ != 0 || B < 1 || Lq < 1 ||
      Lk < 1 || (has_pa ? pa == nullptr : w_pb == nullptr))
    return (int)cudaErrorInvalidValue;
  if (DK == 8)
    return ipa_attention_simt8_fwd(q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa, w_pb, out_s,
                                   out_p, out_pair, B, H, Lq, Lk, Cp, is_bf16, has_pa, scalar_w,
                                   pair_w, stream);
  return dispatch_heads<16>(make_args(q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa, w_pb,
                                      out_s, out_p, out_pair, B, Lq, Lk, Cp, scalar_w, pair_w),
                            H, is_bf16 != 0, has_pa != 0, static_cast<cudaStream_t>(stream));
}

const char* ipa_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// 1 when the kernel is built for H heads (4, 8, 16 and 32), else 0.
int ipa_attention_takes_heads(int H) { return H == 4 || H == 8 || H == 16 || H == 32; }
// 1 when the kernel is built for heads of width DK (8 and 16), else 0.
int ipa_attention_takes_head_dim(int DK) { return DK == 8 || DK == 16; }

}  // extern "C"
