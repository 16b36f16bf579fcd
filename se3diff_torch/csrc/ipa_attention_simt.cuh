// The CUDA-core design of K1's forward ("simt"): its kernel template and
// launchers, included by ipa_attention.cu (heads of width 16 and the C
// entry) and ipa_attention_w8.cu (heads of width 8), two translation units
// that nvcc builds in parallel. The design note is ipa_attention.cu's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Scalar channels per head (kDK): a template parameter, 8 or 16.
constexpr int kNpts = 4;       // query/key points per head
constexpr int kVp = 24;        // value-point channels per head: 8 points x xyz
constexpr int kTI = 4;         // query rows per block
constexpr int kTJ = 32;        // key columns per tile: one per lane in phase A
constexpr int kMaxCp = 256;
constexpr int kHQ = 4;         // heads per phase-B thread
constexpr int kCQ = 4;         // channels per phase-B thread

// Shape constants of the kernel for kH heads of width kDK: 16 threads a
// head, so phase A has two heads a warp, phase B 64 channel quads a head
// group of 4, and the finalize one thread per (head, channel) (half of the
// threads at width 8).
template <int kH, int kDK>
struct Heads {
  static constexpr int kSV = kDK + kVp;  // value channels a phase-A warp sums per head
  static constexpr int kThreads = 16 * kH;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kHeadsPerWarp = kH / kWarps;  // phase A
  static constexpr int kCG = kThreads / (kH / kHQ);  // channel quads per head group
  static constexpr int kPS = kTI * kH + 4;           // padded column stride of p tiles
  static constexpr int kPAS = kTI * kH + 1;          // ... of the pair-bias tile
  static constexpr int kHP = kH < 8 ? kH : 8;        // heads per pair-bias item
  static_assert(kCG * kCQ == kMaxCp, "phase B covers Cp <= 256");
  static_assert(kHeadsPerWarp * kWarps == kH, "phase A covers all heads");
  static_assert(kH % kHQ == 0 && kHP % 4 == 0 && kH % kHP == 0, "head groups");

  // Floats of the loop-time shared buffers (the finalize reuses them).
  __host__ __device__ static constexpr int loop_floats(int Cp, bool has_pa) {
    return kH * kDK * kTI + kH * kNpts * 3 * kTI + 3 * kTJ * kPS +
           (has_pa ? 0 : kTJ * kPAS + Cp * kH);
  }
  __host__ __device__ static constexpr int region_floats(int Cp, bool has_pa) {
    return loop_floats(Cp, has_pa) > kTI * kH * (Cp + 4) ? loop_floats(Cp, has_pa)
                                                         : kTI * kH * (Cp + 4);
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float2 bf2_to_f2(uint32_t bits) {
  __nv_bfloat162 v;
  *reinterpret_cast<uint32_t*>(&v) = bits;
  return __bfloat1622float2(v);
}

// Four consecutive elements (16-byte aligned for f32, 8-byte for bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = bf2_to_f2(raw.x), b = bf2_to_f2(raw.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__device__ __forceinline__ float lds(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int kH, int kDK, bool kHasPa>
__global__ void __launch_bounds__(16 * kH, 1)
ipa_attention_kernel(const T* __restrict__ q_s, const T* __restrict__ k_s,
                     const T* __restrict__ v_s, const float* __restrict__ q_p,
                     const float* __restrict__ k_p, const float* __restrict__ v_p,
                     const T* __restrict__ x2d, const T* __restrict__ w_pv,
                     const float* __restrict__ bias, const T* __restrict__ pa,
                     const float* __restrict__ w_pb, T* __restrict__ out_s,
                     float* __restrict__ out_p, T* __restrict__ out_pair, int Lq, int Lk,
                     int Cp, float scalar_w, float pair_w) {
  using K = Heads<kH, kDK>;
  constexpr int kThreads = K::kThreads, kWarps = K::kWarps, kSV = K::kSV;
  constexpr int kHeadsPerWarp = K::kHeadsPerWarp, kCG = K::kCG;
  constexpr int kPS = K::kPS, kPAS = K::kPAS, kHP = K::kHP, kNHG = kH / kHP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int wxs = Cp + 4;  // padded channel stride of the finalize buffer
  const int region = K::region_floats(Cp, kHasPa);
  float* q_sm = smem;                            // [H][DK][TI]   q_s * scalar_w
  float* qp_sm = q_sm + kH * kDK * kTI;          // [H*4][3][TI]  query points
  float* pb_sm = qp_sm + kH * kNpts * 3 * kTI;   // [TJ][TI][H]   p rounded (x2d)
  float* pr_sm = pb_sm + kTJ * kPS;              // [TJ][H][TI]   p rounded (v_s)
  float* pf_sm = pr_sm + kTJ * kPS;              // [TJ][H][TI]   p (v_p)
  float* pa_sm = pf_sm + kTJ * kPS;              // [TJ][TI][H]   x2d @ w_pb (has_pa=False)
  float* wpb_sm = pa_sm + kTJ * kPAS;            // [Cp][H]       w_pb rounded (has_pa=False)
  float* wx_sm = smem;                           // [TI][H][wxs]  after the loop
  float* corr_sm = smem + region;                // [TI][H]; 1/l after the loop
  float* m_sm = corr_sm + kTI * kH;              // [TI][H]
  float* l_sm = m_sm + kTI * kH;                 // [TI][H]
  float* acc_sm = l_sm + kTI * kH;               // [TI][H][SV]   v_s | v_p sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, i0 = blockIdx.x * kTI;

  for (int e = tid; e < kTI * kH * kDK; e += kThreads) {
    const int r = e / (kH * kDK), h = (e / kDK) % kH, d = e % kDK;
    const int i = min(i0 + r, Lq - 1);  // rows past Lq load, never store
    q_sm[(h * kDK + d) * kTI + r] =
        to_f(q_s[(((size_t)b * kH + h) * Lq + i) * kDK + d]) * scalar_w;
  }
  for (int e = tid; e < kTI * 3 * kH * kNpts; e += kThreads) {
    const int r = e / (3 * kH * kNpts), x = (e / (kH * kNpts)) % 3, hp = e % (kH * kNpts);
    const int i = min(i0 + r, Lq - 1);
    qp_sm[(hp * 3 + x) * kTI + r] = q_p[(((size_t)b * 3 + x) * kH * kNpts + hp) * Lq + i];
  }
  for (int e = tid; e < kTI * kH; e += kThreads) {
    m_sm[e] = -1e30f;
    l_sm[e] = 0.f;
  }
  for (int e = tid; e < kTI * kH * kSV; e += kThreads) acc_sm[e] = 0.f;
  if constexpr (!kHasPa) {
    for (int e = tid; e < Cp * kH; e += kThreads) wpb_sm[e] = to_f(from_f<T>(w_pb[e]));
  }

  // Phase-B identity: heads hg*4 .. +3, channels c0 .. c0+3, all TI rows.
  const int hg = tid / kCG;
  const int c0 = kCQ * (tid % kCG);
  const bool c_ok = c0 < Cp;
  float acc[kTI][kHQ][kCQ];
#pragma unroll
  for (int r = 0; r < kTI; ++r)
#pragma unroll
    for (int a = 0; a < kHQ; ++a)
#pragma unroll
      for (int c = 0; c < kCQ; ++c) acc[r][a][c] = 0.f;
  __syncthreads();

  const size_t plane = (size_t)kH * kNpts * Lk;
  const float* kp_b = k_p + (size_t)b * 3 * plane;
  const float* bias_b = bias + (size_t)b * Lk;

  for (int j0 = 0; j0 < Lk; j0 += kTJ) {
    const int ncols = min(kTJ, Lk - j0);
    const bool j_ok = lane < ncols;
    const int jc = j_ok ? j0 + lane : Lk - 1;  // clamped column for loads
    const float bias_j = bias_b[jc];

    // Bring the tile's x2d rows (phase B) and this warp's v_s / v_p columns
    // (phase A) towards the SMs while the logits are computed.
    {
      const int row_lines = ncols * Cp * (int)sizeof(T) / 128;
      for (int e = tid; e < kTI * row_lines; e += kThreads) {
        const int r = e / row_lines, line = e % row_lines;
        const char* row = reinterpret_cast<const char*>(
            x2d + (((size_t)b * Lq + min(i0 + r, Lq - 1)) * Lk + j0) * Cp);
        prefetch_l2(row + (size_t)line * 128);
      }
#pragma unroll
      for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
        const size_t bh = (size_t)b * kH + warp + kWarps * hh;
        const char* vs = reinterpret_cast<const char*>(v_s + (bh * Lk + j0) * kDK);
        const char* vp = reinterpret_cast<const char*>(v_p + (bh * Lk + j0) * kVp);
        if (lane * 128 < ncols * kDK * (int)sizeof(T)) prefetch_l2(vs + lane * 128);
        for (int line = lane; line * 128 < ncols * kVp * 4; line += 32) prefetch_l2(vp + line * 128);
      }
    }

    // -------- has_pa=False: the tile's pair bias x2d @ w_pb --------
    if constexpr (!kHasPa) {
      for (int e = tid; e < kTJ * kTI * kNHG; e += kThreads) {
        const int g = e % kNHG, r = (e / kNHG) % kTI, jj = e / (kNHG * kTI);
        float sum[kHP];
#pragma unroll
        for (int a = 0; a < kHP; ++a) sum[a] = 0.f;
        if (jj < ncols) {
          const T* xr = x2d + (((size_t)b * Lq + min(i0 + r, Lq - 1)) * Lk + j0 + jj) * Cp;
          const float* wg = wpb_sm + g * kHP;
#pragma unroll 2
          for (int c = 0; c < Cp; c += 4) {
            const float4 xv = load4(xr + c);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float x = lds(xv, k);
              const float* w = wg + (c + k) * kH;
#pragma unroll
              for (int a = 0; a < kHP; a += 4) {
                const float4 w4 = *reinterpret_cast<const float4*>(w + a);
                sum[a] = fmaf(x, w4.x, sum[a]);
                sum[a + 1] = fmaf(x, w4.y, sum[a + 1]);
                sum[a + 2] = fmaf(x, w4.z, sum[a + 2]);
                sum[a + 3] = fmaf(x, w4.w, sum[a + 3]);
              }
            }
          }
        }
#pragma unroll
        for (int a = 0; a < kHP; ++a) pa_sm[jj * kPAS + r * kH + g * kHP + a] = sum[a];
      }
      __syncthreads();
    }

    // -------- phase A: logits, online softmax, v_s / v_p sums --------
#pragma unroll 1
    for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
      const int h = warp + kWarps * hh;
      const size_t bh = (size_t)b * kH + h;
      float s[kTI];
#pragma unroll
      for (int r = 0; r < kTI; ++r) s[r] = 0.f;
      {
        const T* krow = k_s + (bh * Lk + jc) * kDK;
#pragma unroll
        for (int d4 = 0; d4 < kDK / 4; ++d4) {
          const float4 kv = load4(krow + 4 * d4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float kd = lds(kv, e);
            const float4 qd =
                *reinterpret_cast<const float4*>(q_sm + (h * kDK + 4 * d4 + e) * kTI);
            s[0] = fmaf(qd.x, kd, s[0]);
            s[1] = fmaf(qd.y, kd, s[1]);
            s[2] = fmaf(qd.z, kd, s[2]);
            s[3] = fmaf(qd.w, kd, s[3]);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < kNpts; ++p) {
        const int hp = h * kNpts + p;
        const size_t o = (size_t)hp * Lk + jc;
        const float kx = kp_b[o], ky = kp_b[plane + o], kz = kp_b[2 * plane + o];
        const float4 qx = *reinterpret_cast<const float4*>(qp_sm + (hp * 3 + 0) * kTI);
        const float4 qy = *reinterpret_cast<const float4*>(qp_sm + (hp * 3 + 1) * kTI);
        const float4 qz = *reinterpret_cast<const float4*>(qp_sm + (hp * 3 + 2) * kTI);
#pragma unroll
        for (int r = 0; r < kTI; ++r) {
          const float dx = lds(qx, r) - kx, dy = lds(qy, r) - ky, dz = lds(qz, r) - kz;
          const float d2 = fmaf(dx, dx, fmaf(dy, dy, dz * dz));
          s[r] -= sqrtf(fmaxf(d2, 0.f) + 1e-24f);
        }
      }
#pragma unroll
      for (int r = 0; r < kTI; ++r) {
        float pair;
        if constexpr (kHasPa) {
          pair = to_f(pa[(bh * Lq + min(i0 + r, Lq - 1)) * Lk + jc]);
        } else {
          pair = pa_sm[lane * kPAS + r * kH + h];
        }
        s[r] += pair_w * pair + bias_j;
        if (!j_ok) s[r] = -INFINITY;
      }

      float corr[kTI];
#pragma unroll
      for (int r = 0; r < kTI; ++r) {
        const float m_old = m_sm[r * kH + h];
        const float m_new = fmaxf(m_old, warp_max(s[r]));
        corr[r] = expf(m_old - m_new);
        const float p = expf(s[r] - m_new);  // exactly 0 past the tail
        const float l_new = l_sm[r * kH + h] * corr[r] + warp_sum(p);
        const float p_rnd = to_f(from_f<T>(p));
        pb_sm[lane * kPS + r * kH + h] = p_rnd;
        pr_sm[lane * kPS + h * kTI + r] = p_rnd;
        pf_sm[lane * kPS + h * kTI + r] = p;
        __syncwarp();
        if (lane == 0) {
          m_sm[r * kH + h] = m_new;
          l_sm[r * kH + h] = l_new;
          corr_sm[r * kH + h] = corr[r];
        }
      }
      __syncwarp();

      // Value sums for head h: lane c < kDK is v_s channel c, kDK <= c < 32
      // is v_p channel c-kDK, and at width 16 lanes below 8 also take v_p
      // channel 16+c.
      {
        float part0[kTI], part1[kTI];
#pragma unroll
        for (int r = 0; r < kTI; ++r) part0[r] = part1[r] = 0.f;
        const bool scalar = lane < kDK;
        const bool second = lane < kSV - 32;
        const T* vs_col = v_s + (bh * Lk + j0) * kDK + (lane & (kDK - 1));
        const float* vp_col = v_p + (bh * Lk + j0) * kVp + (scalar ? lane + 32 - kDK : lane - kDK);
#pragma unroll 8
        for (int jj = 0; jj < ncols; ++jj) {
          const float4 prr = *reinterpret_cast<const float4*>(pr_sm + jj * kPS + h * kTI);
          const float4 pff = *reinterpret_cast<const float4*>(pf_sm + jj * kPS + h * kTI);
          const float v0 = scalar ? to_f(vs_col[jj * kDK]) : vp_col[jj * kVp];
          const float4 p0 = scalar ? prr : pff;
          part0[0] = fmaf(p0.x, v0, part0[0]);
          part0[1] = fmaf(p0.y, v0, part0[1]);
          part0[2] = fmaf(p0.z, v0, part0[2]);
          part0[3] = fmaf(p0.w, v0, part0[3]);
          if (second) {
            const float v1 = vp_col[jj * kVp];
            part1[0] = fmaf(pff.x, v1, part1[0]);
            part1[1] = fmaf(pff.y, v1, part1[1]);
            part1[2] = fmaf(pff.z, v1, part1[2]);
            part1[3] = fmaf(pff.w, v1, part1[3]);
          }
        }
#pragma unroll
        for (int r = 0; r < kTI; ++r) {
          float* a = acc_sm + (r * kH + h) * kSV + lane;
          a[0] = a[0] * corr[r] + part0[r];
          if (second) a[32] = a[32] * corr[r] + part1[r];
        }
      }
    }
    __syncthreads();

    // -------- phase B: x2d aggregate for all heads --------
    if (c_ok) {
#pragma unroll
      for (int r = 0; r < kTI; ++r) {
        const float4 cr = *reinterpret_cast<const float4*>(corr_sm + r * kH + hg * kHQ);
#pragma unroll
        for (int a = 0; a < kHQ; ++a) {
          const float c = lds(cr, a);
#pragma unroll
          for (int k = 0; k < kCQ; ++k) acc[r][a][k] *= c;
        }
      }
      const T* xrow[kTI];
#pragma unroll
      for (int r = 0; r < kTI; ++r)
        xrow[r] = x2d + (((size_t)b * Lq + min(i0 + r, Lq - 1)) * Lk + j0) * Cp + c0;
#pragma unroll 2
      for (int jj = 0; jj < ncols; ++jj) {
        float4 xv[kTI];
#pragma unroll
        for (int r = 0; r < kTI; ++r) xv[r] = load4(xrow[r] + (size_t)jj * Cp);
#pragma unroll
        for (int r = 0; r < kTI; ++r) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(pb_sm + jj * kPS + r * kH + hg * kHQ);
#pragma unroll
          for (int a = 0; a < kHQ; ++a) {
            const float p = lds(p4, a);
            acc[r][a][0] = fmaf(p, xv[r].x, acc[r][a][0]);
            acc[r][a][1] = fmaf(p, xv[r].y, acc[r][a][1]);
            acc[r][a][2] = fmaf(p, xv[r].z, acc[r][a][2]);
            acc[r][a][3] = fmaf(p, xv[r].w, acc[r][a][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // ---------------- finalize ----------------
#pragma unroll 1
  for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
    const int h = warp + kWarps * hh;
    const size_t bh = (size_t)b * kH + h;
#pragma unroll
    for (int r = 0; r < kTI; ++r) {
      const float inv_l = 1.f / l_sm[r * kH + h];
      const int i = i0 + r;
      if (lane == 0) corr_sm[r * kH + h] = inv_l;
      if (i < Lq) {
        const float* a = acc_sm + (r * kH + h) * kSV;
        if (lane < kDK)
          out_s[(bh * Lq + i) * kDK + lane] = from_f<T>(a[lane] * inv_l);
        else
          out_p[(bh * Lq + i) * kVp + lane - kDK] = a[lane] * inv_l;
        if (lane < kSV - 32) out_p[(bh * Lq + i) * kVp + lane + 32 - kDK] = a[lane + 32] * inv_l;
      }
    }
  }
  if (c_ok) {
#pragma unroll
    for (int r = 0; r < kTI; ++r)
#pragma unroll
      for (int a = 0; a < kHQ; ++a)
        *reinterpret_cast<float4*>(wx_sm + (r * kH + hg * kHQ + a) * wxs + c0) =
            make_float4(acc[r][a][0], acc[r][a][1], acc[r][a][2], acc[r][a][3]);
  }
  __syncthreads();

  // out_pair[r, h, d] = (1/l[r, h]) sum_c wx[r, h, c] w_pv[h, c, d]: thread
  // (h, d) reads its w_pv column once for the block's rows.
  if (kDK == 16 || tid < kH * kDK) {
    const int h = tid / kDK, d = tid % kDK;
    float o[kTI];
#pragma unroll
    for (int r = 0; r < kTI; ++r) o[r] = 0.f;
    const T* wcol = w_pv + (size_t)h * Cp * kDK + d;
#pragma unroll 16
    for (int c = 0; c < Cp; ++c) {
      const float w = to_f(wcol[(size_t)c * kDK]);
#pragma unroll
      for (int r = 0; r < kTI; ++r) o[r] = fmaf(wx_sm[(r * kH + h) * wxs + c], w, o[r]);
    }
#pragma unroll
    for (int r = 0; r < kTI; ++r) {
      const int i = i0 + r;
      if (i < Lq)
        out_pair[(((size_t)b * kH + h) * Lq + i) * kDK + d] =
            from_f<T>(o[r] * corr_sm[r * kH + h]);
    }
  }
}

struct Args {
  const void *q_s, *k_s, *v_s;
  const float *q_p, *k_p, *v_p;
  const void *x2d, *w_pv;
  const float* bias;
  const void* pa;
  const float* w_pb;
  void* out_s;
  float* out_p;
  void* out_pair;
  int B, Lq, Lk, Cp;
  float scalar_w, pair_w;
};

template <typename T, int kH, int kDK, bool kHasPa>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using K = Heads<kH, kDK>;
  auto kernel = ipa_attention_kernel<T, kH, kDK, kHasPa>;
  const size_t smem = sizeof(float) * (size_t)(K::region_floats(a.Cp, kHasPa) +
                                               3 * kTI * kH + kTI * kH * K::kSV);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Lq + kTI - 1) / kTI, a.B);
  kernel<<<grid, K::kThreads, smem, stream>>>(
      static_cast<const T*>(a.q_s), static_cast<const T*>(a.k_s),
      static_cast<const T*>(a.v_s), a.q_p, a.k_p, a.v_p, static_cast<const T*>(a.x2d),
      static_cast<const T*>(a.w_pv), a.bias, static_cast<const T*>(a.pa), a.w_pb,
      static_cast<T*>(a.out_s), a.out_p, static_cast<T*>(a.out_pair), a.Lq, a.Lk, a.Cp,
      a.scalar_w, a.pair_w);
  return cudaGetLastError();
}

template <typename T, int kH, int kDK>
cudaError_t launch_variant(const Args& a, bool has_pa, cudaStream_t stream) {
  return has_pa ? launch<T, kH, kDK, true>(a, stream) : launch<T, kH, kDK, false>(a, stream);
}

template <int kH, int kDK>
cudaError_t launch_dtype(const Args& a, bool is_bf16, bool has_pa, cudaStream_t stream) {
  return is_bf16 ? launch_variant<__nv_bfloat16, kH, kDK>(a, has_pa, stream)
                 : launch_variant<float, kH, kDK>(a, has_pa, stream);
}


// The kernel for H heads of width kDK (4, 8, 16 or 32).
template <int kDK>
int dispatch_heads(const Args& a, int H, bool is_bf16, bool has_pa, cudaStream_t st) {
  switch (H) {
    case 4: return (int)launch_dtype<4, kDK>(a, is_bf16, has_pa, st);
    case 8: return (int)launch_dtype<8, kDK>(a, is_bf16, has_pa, st);
    case 16: return (int)launch_dtype<16, kDK>(a, is_bf16, has_pa, st);
    case 32: return (int)launch_dtype<32, kDK>(a, is_bf16, has_pa, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

inline Args make_args(const void* q_s, const void* k_s, const void* v_s, const void* q_p,
                      const void* k_p, const void* v_p, const void* x2d, const void* w_pv,
                      const void* bias, const void* pa, const void* w_pb, void* out_s,
                      void* out_p, void* out_pair, int B, int Lq, int Lk, int Cp, float scalar_w,
                      float pair_w) {
  return Args{q_s, k_s, v_s,
              static_cast<const float*>(q_p), static_cast<const float*>(k_p),
              static_cast<const float*>(v_p), x2d, w_pv, static_cast<const float*>(bias),
              pa, static_cast<const float*>(w_pb), out_s, static_cast<float*>(out_p),
              out_pair, B, Lq, Lk, Cp, scalar_w, pair_w};
}

}  // namespace
