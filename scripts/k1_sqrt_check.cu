// Holds the tensor-core K1 kernel's square root (sqrt_from_1e24 in
// se3diff_torch/csrc/ipa_attention_tc.cu, which this file includes) against
// sqrtf on every finite float from 1e-24 up, and reports inf. On a machine
// with an NVIDIA H100 and nvcc, from the root of a checkout:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o .work/k1_sqrt_check \
//       scripts/k1_sqrt_check.cu && .work/k1_sqrt_check
//
// Prints the count of inputs checked and of results that differ; exits 1 if
// any differs.

#include "../se3diff_torch/csrc/ipa_attention_tc.cu"

#include <stdio.h>
#include <string.h>

namespace {

__global__ void compare(uint32_t lo, uint32_t n, unsigned long long* differ, float* example) {
  for (uint32_t k = blockIdx.x * blockDim.x + threadIdx.x; k < n; k += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(lo + k);
    if (__float_as_uint(sqrtf(x)) != __float_as_uint(sqrt_from_1e24(x))) {
      atomicAdd(differ, 1ull);
      *example = x;
    }
  }
}

__global__ void at_inf_nan(float* out) {
  out[0] = sqrt_from_1e24(__int_as_float(0x7f800000));
  out[1] = sqrt_from_1e24(__int_as_float(0x7fc00000));
}

}  // namespace

int main() {
  unsigned long long* differ;
  float *example, *inf_result;
  cudaMallocManaged(&differ, sizeof(*differ));
  cudaMallocManaged(&example, sizeof(*example));
  cudaMallocManaged(&inf_result, 2 * sizeof(*inf_result));
  *differ = 0;
  *example = 0.f;
  const float first = 1e-24f;
  uint32_t lo;
  memcpy(&lo, &first, sizeof(lo));
  const uint32_t hi = 0x7f800000u;  // inf: every finite float below it
  compare<<<8192, 256>>>(lo, hi - lo, differ, example);
  at_inf_nan<<<1, 1>>>(inf_result);
  if (cudaDeviceSynchronize() != cudaSuccess) {
    printf("k1_sqrt_check: launch failed\n");
    return 2;
  }
  printf("k1_sqrt_check: %u finite floats in [1e-24, FLT_MAX]: %llu differ from sqrtf; "
         "sqrt_from_1e24(inf) = %g, sqrt_from_1e24(nan) = %g\n",
         hi - lo, *differ, inf_result[0], inf_result[1]);
  if (*differ) printf("k1_sqrt_check: one that differs: %g\n", *example);
  return *differ ? 1 : 0;
}
