// TF32 tensor-core helpers of the f32 designs for Hopper, sm_90a:
// ipa_attention_tc_f32.cu (the 32-head forward, streamed and in-kernel pair
// bias) and ipa_attention_bwd_common.cuh (the streamed-pair-bias backward
// designs) include it. mma.sync m16n8k8 in TF32, an f32 operand split into
// a big and a small TF32 term (rounded or truncated), and the 3xTF32
// product of two split operands.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// d += a b: a 16x8 TF32 (row), b 8x8 TF32 (col), d 16x8 f32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as big + small TF32 terms; big's low 13 bits cleared, so x - big is exact.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  uint32_t b, s;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(b) : "f"(x));
  b &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(s) : "f"(x - __uint_as_float(b)));
  big = b;
  small = s;  // mma reads the top 19 bits of a TF32 operand
}

// x as big + small TF32 terms by truncation: big is x with its low 13 bits
// cleared, small the exact rest, whose low bits the tensor cores drop. Two
// instructions where split_tf32 takes four; each product keeps some 2^-20
// of itself.
__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a b in 3xTF32: the small x small term is the only one dropped.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

}  // namespace
