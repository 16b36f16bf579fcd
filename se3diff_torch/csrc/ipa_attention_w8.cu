// The CUDA-core design of K1's forward ("simt", ipa_attention.cu) at heads
// of width 8: its instances in a translation unit of their own, so that
// nvcc builds them beside the width-16 ones (the 32 instances of one source
// took 49 s, the critical path of the library's build). Replaces the same
// TPU kernel as ipa_attention.cu, se3diff_tpu/ops/pallas_ipa.py::_kernel.

#include "ipa_attention_simt.cuh"

extern "C" {

// ipa_attention_fwd's arguments but DK (8 here), validated there.
int ipa_attention_simt8_fwd(const void* q_s, const void* k_s, const void* v_s, const void* q_p,
                            const void* k_p, const void* v_p, const void* x2d, const void* w_pv,
                            const void* bias, const void* pa, const void* w_pb, void* out_s,
                            void* out_p, void* out_pair, int B, int H, int Lq, int Lk, int Cp,
                            int is_bf16, int has_pa, float scalar_w, float pair_w, void* stream) {
  return dispatch_heads<8>(make_args(q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa, w_pb,
                                     out_s, out_p, out_pair, B, Lq, Lk, Cp, scalar_w, pair_w),
                           H, is_bf16 != 0, has_pa != 0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
