// Fused IPA attention core (backward) at 16 heads, the tensor-core design for
// Hopper, sm_90a.
//
// Replaces no Pallas kernel: it is the counterpart of the XLA function
// se3diff_tpu/ops/pallas_ipa.py::_fused_backward_chunked, the backward behind
// fused_ipa_attention_diff's custom VJP, at the widths of a tensor-parallel
// rank at `--mesh model=2` (the bioemu-v1.0 score model's 32 heads split two
// ways): 16 heads of width 16, the streamed pair bias (has_pa) and Cp a
// multiple of 32 up to 256, in bf16 (ipa_attention_bwd_tc16) and in f32
// (ipa_attention_bwd_tc16_f32). It computes what ipa_attention_bwd_tc.cu
// (the 32-head design) computes, with its algebra: f32 attention weights a
// (never rounded to the model dtype), dist = sqrt(max(d2, 0) + 1e-24) with a
// zero distance subgradient wherever d2 <= 0, D = sum_j a dv + g . wx2d from
// the row aggregate wx2d, d_pa = pair_w ds, no gradient for the column bias,
// every gradient cast to its input's dtype once, at the end;
// ops/ipa_attention.py::ipa_attention_backward_tiled is its arithmetic in
// PyTorch.
//
// Bound on an H100: bytes, in both dtypes. At B=16 L=100 Cp=256 the call
// moves 374 MB in f32 (x2d read and d_x2d written, 164 MB each), 0.112 ms at
// 3.35 TB/s; at the train CLI's B=16 L=64 bf16, 84 MB, 0.025 ms. Its
// operations, priced as the 32-head design's on the units that run them,
// take 0.045 and 0.014 ms there. Half the heads of the 32-head design do
// half its per-pair work over the same x2d bytes.
//
// The design is ipa_attention_bwd_rows.cuh's, at H = 16: bwd_dv (the value
// terms), bwd_rows<T, 16> (2 rows x 16 heads a 256-thread block, two blocks
// an SM; one pass over x2d with an L2 evict-first policy, d_x2d, d_pa and
// wx2d by streaming stores; g = ct_pr @ w_pv^T formed at its set-up, 16
// threads a head, each block reading half of what a 32-head block reads of
// w_pv; the truncating 3xTF32 split in f32), bwd_cols<T, 16>, then the
// torch.bmm for d_w_pv. At 16 heads one m16 tile is a row's heads, so C2 has
// only 4 (row, m16, n8) tiles for 8 warps: two warps share a tile, each
// taking alternate pairs of Cp's 32-channel chunks, and the two parts are
// added in a fixed order when dphat is formed.
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, scripts/k1_bwd_variants.py
// --heads 16, the call in turns with itself): 0.449-0.454 ms in f32 at B=16
// L=100 (the first design 0.650), 4.0x the bytes bound; 0.175-0.176 ms in
// bf16 at B=16 L=64 (0.231), 7.0x. Of that, bwd_rows<T, 16> takes 0.337 /
// 0.094 ms, bwd_cols 0.060 / 0.037, bwd_dv 0.019 / 0.008, the d_w_pv bmm
// 0.018 / 0.014. What limits the row kernel now, by the clock (SM cycles of
// a block, f32 B=16 L=100 / bf16 L=64): the products 29 / 22%; sweeps 1
// and 3, 11 + 16% / 11 + 25%, latency-bound on the key side's L2 loads
// (staging it by cp.async, two tiles ahead, made both sweeps slower: the
// variant staged_keys); g's set-up 12 / 14%, which reads all of the 16
// heads' w_pv from L2 for each 2-row block (256 KB in f32: cut, 7% / 3% of
// the call); sweep 2's weights and fetch 17 / 9%. A second f32 x2d stage
// fits at two blocks an SM and gains nothing (f32_two_stages); three blocks
// an SM spill (lb3, +30-40%).
//
// Shared memory of bwd_rows<T, 16> at Cp = 256: 75,648 bytes (bf16), 74,624 (f32)
// (two 256-thread blocks an SM); bwd_cols: 90,112 bytes.
// ptxas -v (sm_90a; chip_smoke.py phase 1 prints it): bwd_rows<T, 16> 127
// (bf16) and 128 (f32) registers, no spills.

#include "ipa_attention_bwd_rows.cuh"

namespace {

constexpr int kH = 16;  // heads: one m16 tile a row

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). The arguments are those of
// ipa_attention_bwd_tc (ipa_attention_bwd_tc.cu), in the same layouts, with
// H = 16: operands in ipa_attention_fwd's layouts, w_pv [H,Cp,16] in the
// model dtype, cotangents ct_s [B,H,Lq,16] (model dtype), ct_p [B,H,Lq,24]
// and ct_pr [B,H,Lq,16] f32; writes d_q_s, d_k_s, d_v_s (model dtype),
// d_q_p, d_k_p, d_v_p (f32), d_x2d, d_pa (model dtype), and the scratch
// wx2d [H,B,Lq,Cp], ds, logits and dvals (dv, then dphat = dv + G)
// [B,H,Lq,Lk] and the row statistics [B,H,Lq,2], all f32. Takes H = 16, DK = 16, Cp a multiple of 32 up to 256 and 16-byte
// aligned tensors, and refuses anything else. ipa_attention_bwd_tc16 takes
// bf16 model operands, ipa_attention_bwd_tc16_f32 f32.
int ipa_attention_bwd_tc16(const void* q_s, const void* k_s, const void* v_s, const void* q_p,
                           const void* k_p, const void* v_p, const void* x2d, const void* bias,
                           const void* pa, const void* ct_s, const void* ct_p, const void* ct_pr,
                           const void* w_pv, void* d_qs, void* d_ks, void* d_vs, void* d_qp,
                           void* d_kp, void* d_vp, void* d_x2d, void* d_pa, void* wx2d, void* ds,
                           void* logits, void* dvals, void* stats, int B, int H, int Lq, int Lk,
                           int DK, int Cp, float scalar_w, float pair_w, void* stream) {
  return launch_backward<bf16, kH>(q_s, k_s, v_s, q_p, k_p, v_p, x2d, bias, pa, ct_s, ct_p, ct_pr,
                                   w_pv, d_qs, d_ks, d_vs, d_qp, d_kp, d_vp, d_x2d, d_pa, wx2d, ds,
                                   logits, dvals, stats, B, H, Lq, Lk, DK, Cp, scalar_w, pair_w,
                                   stream);
}

int ipa_attention_bwd_tc16_f32(const void* q_s, const void* k_s, const void* v_s, const void* q_p,
                               const void* k_p, const void* v_p, const void* x2d, const void* bias,
                               const void* pa, const void* ct_s, const void* ct_p,
                               const void* ct_pr, const void* w_pv, void* d_qs, void* d_ks,
                               void* d_vs, void* d_qp, void* d_kp, void* d_vp, void* d_x2d,
                               void* d_pa, void* wx2d, void* ds, void* logits, void* dvals,
                               void* stats, int B, int H, int Lq, int Lk, int DK, int Cp,
                               float scalar_w, float pair_w, void* stream) {
  return launch_backward<float, kH>(q_s, k_s, v_s, q_p, k_p, v_p, x2d, bias, pa, ct_s, ct_p, ct_pr,
                                    w_pv, d_qs, d_ks, d_vs, d_qp, d_kp, d_vp, d_x2d, d_pa, wx2d, ds,
                                    logits, dvals, stats, B, H, Lq, Lk, DK, Cp, scalar_w, pair_w,
                                    stream);
}

// Dynamic shared memory of the row kernel at Cp (bf16, f32) and its resident
// blocks an SM (-1 if the device cannot say); the column kernel's is
// ipa_attention_bwd_cols_smem_bytes (ipa_attention_bwd_tc.cu).
int ipa_attention_bwd_tc16_smem_bytes(int Cp) { return RowLayout<bf16, kH>(Cp).total; }
int ipa_attention_bwd_tc16_f32_smem_bytes(int Cp) { return RowLayout<float, kH>(Cp).total; }
int ipa_attention_bwd_tc16_blocks_per_sm(int Cp) { return row_blocks_per_sm<bf16, kH>(Cp); }
int ipa_attention_bwd_tc16_f32_blocks_per_sm(int Cp) { return row_blocks_per_sm<float, kH>(Cp); }

}  // extern "C"
