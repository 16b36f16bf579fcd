#!/usr/bin/env python3
"""Variants of K1's backward row design at 32 heads
(``csrc/ipa_attention_bwd_tc.cu``, routes "bwd_tc" and "bwd_tc_f32") or at
a tensor-parallel rank's 16 (``csrc/ipa_attention_bwd_tc16.cu``, routes
"bwd_tc16" and "bwd_tc16_f32"), both ``csrc/ipa_attention_bwd_rows.cuh``'s
``bwd_rows<T, H>``, or of the 8-head design (``csrc/ipa_attention_bwd_tc8.cu``,
routes "bwd_tc8" and "bwd_tc8_f32": ``bwd8_rows``, and the column kernel's
row split at 8 heads), timed in turns with the source as committed, and
where the row kernel spends its time, on one H100.

    python3 scripts/k1_bwd_variants.py [--heads 32|16|8] [variant ...]

from the root of a checkout, on a machine with an NVIDIA H100, nvcc and a
CUDA build of PyTorch. A variant is the sources with text patches applied,
each patch's text found once in the design's source and the headers it
includes (the row design's header and the shared header; at 8 heads the
shared header); every variant named (all of the head count's by default) and the
committed sources are built with nvcc, one process a source, all started
together, into libraries of their own under ``.work/k1_bwd_variants/``
(listed in .gitignore). At 32 heads (the default) at the train step's B=16
L=100 (bf16 and f32) and the learning run's B=32 L=56 (bf16); at 16 heads
at the ``--mesh model=2`` f32 step's B=16 L=100, the train CLI's B=16 L=64
bf16 and B=40 L=77 with 9 masked columns (both dtypes), and at 8 heads at
the same shapes (the ``--mesh model=4`` step's and the CLI's); Cp=256. Each
variant's call (``ops.ipa_attention._launch_backward`` with the variant's
library: the value-term, row and column kernels and the ``bmm``) is timed by
``chip_smoke.cuda_time_ms`` in turns with the committed source's on the
same inputs (committed, variant, variant, committed), and its gradients
are held against the committed source's (a variant that cuts work is
timed, and its error printed, not checked). Prints a line a variant and
shape with ptxas's register and spill report, then the card's name and
power limit.

The variants at 32 and 16 heads:

- ``clock`` (no change to the arithmetic): thread 0 of each block of
  ``bwd_rows`` adds ``clock64()`` differences at the phase boundaries to
  a device counter; prints the mean SM cycles a block spends in each phase
  (set-up, sweep 1, sweep 2's weights and fetch, its wait and first
  barrier, its products, its second barrier and dphat, the epilogue and D,
  sweep 3 with the row gradients' writes);
- ``one_stage`` (bf16 only): one x2d stage, as in f32;
- ``early_copy``: at 16 heads the rows' operands in a region of their own
  (3,584 B), so that the first x2d tile is copied at the block's start,
  under g's set-up and sweep 1, not after sweep 1;
- ``staged_keys`` (its patches in ``k1_bwd_variants_staged_keys.json``):
  at 16 heads each thread stages its column's key side (k_s, the 12
  key-point coordinates) for sweeps 1 and 3 by ``cp.async`` two tiles
  ahead into two key stages over sweep 2's regions, the column bias, pa,
  the kept logits and dphat one tile ahead in registers, g formed after
  sweep 1;
- ``f32_two_stages`` (f32 only; at 32 heads it does not fit two blocks an
  SM): two x2d stages, as in bf16, the next tile copied under this tile's
  products;
- ``lb3``: the row kernel's launch bounds at three blocks an SM (at most 85
  registers a thread; the 16-head layout fits three blocks' shared memory);
- ``sweep1_unroll4``: sweep 1's tile loop unrolled four times (two
  committed);
- ``unroll3``: sweep 3's tile loop unrolled twice, so a column's loads can
  be issued under the previous column's arithmetic;
- ``g_unroll8``: the set-up's loop over w_pv rows unrolled eight times
  (four committed);
- ``c2_two_pass`` (f32 only): G's four accumulators in two passes over Cp
  (k-steps 0 and 1 mod 4, then 2 and 3), at most three live, the same
  bits;
- ``c1_m_outer`` (f32 only): the aggregate's loop with the m16 tile
  outermost, one tile's split weights live at a time;
- ``late_fetch``: the next tile's logits and dv fetched after the products
  (not held in registers across them);
- ``dv_rows32``, ``dv_rows64``: the value-term kernel bwd_dv at 32 or 64
  query rows a block, not 16;
- ``cols_chunk8``, ``cols_chunk16``: the column kernel
  (ipa_attention_bwd_common.cuh) stages each lane's logits and ds 8 or 16
  rows ahead, not 4 (at 16, 139 kB of shared memory, one block an SM);
- ``cols_unroll2``: the column kernel's row loop unrolled twice;
- cuts (timed, their error printed, not checked): ``no_copy`` (no x2d
  tile copied: the products read what the stage holds), ``no_fetch``
  (sweep 2 reads no kept logits or dv), ``no_sweep1`` (no statistics
  sweep), ``no_setup`` (g not formed: the set-up's loop over w_pv cut),
  ``no_sweep3`` (the row
  kernel without its third sweep: no ds, d_pa, d_q_s, d_q_p), ``no_c2``
  (without G's products), ``no_c3`` (without d_x2d's products and
  stores).

The variants at 8 heads (``bwd8_rows``; its 4-row blocks in the clock's
count of blocks):

- ``clock``: the same phases of ``bwd8_rows``;
- ``one_stage`` (bf16 only): one x2d stage, as in f32;
- ``div_copy``: the x2d copy addressed a 16-byte chunk a thread, by
  division by the runtime row width (the first design's and the row
  design's), not a warp a row;
- ``c3_narrow``: C3's d_x2d stores two of 4 (bf16) or 8 (f32) bytes a lane
  and column, without the lanes' trade (the first design's);
- ``x2d_wb``: d_x2d by plain (write-back) stores, not streaming ones;
- ``c3_last``: C3 after C1 and C2 in the products (the first design's
  order), its stores then draining at the barrier after them;
- ``cols_parts1``, ``cols_parts2``, ``cols_parts8`` (their sums in another
  order: timed, their error printed, not checked): the column kernel's
  query rows of a head on 1 warp (the first design's grid of 64 blocks at
  B=16 L=100), 2 or 8 warps, not 4;
- ``unroll3``: sweep 3's tile loop unrolled twice;
- ``g_unroll4``: the set-up's loop over w_pv rows unrolled four times (two
  committed);
- ``late_fetch``: the next tile's logits and dv fetched after the products;
- timed, their error printed, not checked: ``f32_round`` (f32 only: the
  3xTF32 split rounded to nearest, ``split_tf32``, as the first design
  split it) and the cuts ``no_copy``, ``no_fetch``, ``no_sweep1``,
  ``no_setup``, ``no_sweep3``, ``no_c2``, ``no_c3``, as at 32 and 16 heads.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "se3diff_torch" / "csrc"
SOURCES = {32: CSRC / "ipa_attention_bwd_tc.cu", 16: CSRC / "ipa_attention_bwd_tc16.cu",
           8: CSRC / "ipa_attention_bwd_tc8.cu"}
ROW_HEADERS = (CSRC / "ipa_attention_bwd_rows.cuh", CSRC / "ipa_attention_bwd_common.cuh")
HEADERS = {32: ROW_HEADERS, 16: ROW_HEADERS, 8: (CSRC / "ipa_attention_bwd_common.cuh",)}
ROWS_A_BLOCK = {32: 2, 16: 2, 8: 4}
ROUTES = {32: "bwd_tc", 16: "bwd_tc16", 8: "bwd_tc8"}
OUT = REPO / ".work" / "k1_bwd_variants"
PHASES = ("set-up (g, cotangents)", "sweep 1", "sweep 2: weights, fetch", "sweep 2: wait, barrier",
          "sweep 2: C1-C3", "sweep 2: barrier, dphat", "epilogue, D", "sweep 3")
# (B, L, dtype, masked columns), by heads.
SHAPES = {32: [(16, 100, "bfloat16", 0), (16, 100, "float32", 0), (32, 56, "bfloat16", 0)],
          16: [(16, 100, "float32", 0), (16, 64, "bfloat16", 0), (40, 77, "bfloat16", 9),
               (40, 77, "float32", 9)]}
SHAPES[8] = SHAPES[16]


def _mark(k: int) -> str:
    return (f"  if (tid == 0) {{ const long long n = clock64(); "
            f"atomicAdd(&g_clk[{k}], (unsigned long long)(n - clk)); clk = n; }}\n")


CLOCK = [
    ("namespace {\n\nconstexpr int kTI = 2; ",
     "namespace {\n\n__device__ unsigned long long g_clk[16];\n\nconstexpr int kTI = 2; "),
    ("  const float* bias_b = bias + (size_t)b * Lk;\n\n  // ---- the rows' operands",
     "  const float* bias_b = bias + (size_t)b * Lk;\n  long long clk = clock64();\n\n"
     "  // ---- the rows' operands"),
    ("  __syncthreads();  // the rows' operands\n",
     "  __syncthreads();  // the rows' operands\n" + _mark(0)),
    ("  // The kept logits (-inf past Lk) and dv of this thread's (row, head hp)\n",
     _mark(1) + "  // The kept logits (-inf past Lk) and dv of this thread's (row, head hp)\n"),
    ("    cp_async_wait_all();\n    __syncthreads();\n"
     "    if (kStages<T, H> == 2 && t + 1 < ntiles) copy_tile(t + 1);\n",
     "  " + _mark(2) + "    cp_async_wait_all();\n    __syncthreads();\n"
     "    if (kStages<T, H> == 2 && t + 1 < ntiles) copy_tile(t + 1);\n  " + _mark(3)),
    ("    __syncthreads();  // G; the stage read\n",
     "  " + _mark(4) + "    __syncthreads();  // G; the stage read\n"),
    ("      dvk[hp] = dv_n[hp];\n    }\n", "      dvk[hp] = dv_n[hp];\n    }\n  " + _mark(5)),
    ("  __syncthreads();\n\n  // ================= sweep 3",
     "  __syncthreads();\n" + _mark(6) + "\n  // ================= sweep 3"),
    ("dqp[r][px];\n      }\n    }\n  }\n}\n",
     "dqp[r][px];\n      }\n    }\n  }\n" + _mark(7) + "}\n"),
    ('extern "C" {\n',
     'extern "C" {\n\n// The phase counters: copied to host (16 values) and cleared.\n'
     "int bwd_clk_take(unsigned long long* host) {\n"
     "  cudaError_t err = cudaMemcpyFromSymbol(host, g_clk, sizeof(g_clk));\n"
     "  if (err != cudaSuccess) return (int)err;\n"
     "  static const unsigned long long zero[16] = {};\n"
     "  return (int)cudaMemcpyToSymbol(g_clk, zero, sizeof(g_clk));\n}\n"),
]

# The f32 aggregate (C1) and G (C2) as committed, and as the variants
# c1_m_outer and c2_two_pass write them.
C1_F32 = """\
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
      }"""
C1_F32_M_OUTER = """\
#pragma unroll
      for (int ks = 0; ks < kTJ / 8; ++ks) {
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          uint32_t ab[4], asm_[4];
          const float* a0 = as + (pr * H + m * 16 + g) * kAPS + ks * 8 + q;
          split_tf32_trunc(a0[0], ab[0], asm_[0]);
          split_tf32_trunc(a0[8 * kAPS], ab[1], asm_[1]);
          split_tf32_trunc(a0[4], ab[2], asm_[2]);
          split_tf32_trunc(a0[8 * kAPS + 4], ab[3], asm_[3]);
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
                mma_3xtf32(acc1[sl][x][m], ab, asm_, bb0, bb1, bs0, bs1);
              }
            }
          }
        }
      }"""
C2_F32 = """\
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
        }"""
C2_F32_TWO_PASS = """\
        const float* ga = gs + (pr * H + cm * 16 + g) * GS + q;
        const float* xb = Xc + g * S + q;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
          for (int k4 = kh; k4 < Cp / 32; k4 += kSplit) {
#pragma unroll
            for (int kk2 = 0; kk2 < 2; ++kk2) {
              const int c = (kKQ * k4 + 2 * half + kk2) * 8;
              uint32_t ab[4], asm_[4], bb0, bs0, bb1, bs1;
              split_tf32_trunc(ga[c], ab[0], asm_[0]);
              split_tf32_trunc(ga[8 * GS + c], ab[1], asm_[1]);
              split_tf32_trunc(ga[c + 4], ab[2], asm_[2]);
              split_tf32_trunc(ga[8 * GS + c + 4], ab[3], asm_[3]);
              split_tf32_trunc(xb[c], bb0, bs0);
              split_tf32_trunc(xb[c + 4], bb1, bs1);
              if (kk2)
                mma_3xtf32(p1, ab, asm_, bb0, bb1, bs0, bs1);
              else
                mma_3xtf32(p0, ab, asm_, bb0, bb1, bs0, bs1);
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (half == 0) {
              acc2[0][e] = p0[e] + p1[e];
              acc2[1][e] = 0.f;
            } else {
              acc2[2][e] = p0[e];
              acc2[3][e] = p1[e];
            }
          }
        }"""
FETCH = ("    float lg_n[kHeadsAWarp], dv_n[kHeadsAWarp];\n"
         "    fetch(min(t + 1, ntiles - 1), lg_n, dv_n);\n")
DPHAT = "    // dphat = dv + G, G's parts added in order.\n"
STAGES = "constexpr int kStages = std::is_same<T, bf16>::value ? 2 : 1;"
SWEEP3 = ("  for (int hp2 = 0; hp2 < kHeadsAWarp / 2; ++hp2) {\n"
          "    const int h = head(2 * hp2 + hh);\n"
          "    const T* ks_bh = k_s + ((size_t)b * H + h) * Lk * kDK;\n"
          "    size_t row[kTI];\n    float dqs")
C2_OPEN = "    // C2: G[pr][h][j] = sum_c g[pr][h][c] x2d[pr][j][c], the warp's m16 x n8\n"
C3_LOOP = ("        const int p = ce + kRowWarps * sl;\n        if (p >= npairs) break;\n")
BOTH = ("bfloat16", "float32")
# early_copy: at 16 heads the rows' operands in a region of their own, so
# that the first x2d tile is copied at the block's start.
EARLY_COPY = [
    ("template <typename T, int H>\nconstexpr int kStages = std::is_same<T, bf16>::value ? 2 : 1;"
     "  // x2d stages\n",
     "template <typename T, int H>\nconstexpr int kStages = std::is_same<T, bf16>::value ? 2 : 1;\n"
     "template <int H>\nconstexpr bool kEarlyCopy = H == 16;\n"),
    ("  int gs, as, gt, dxp, st, total;", "  int gs, as, gt, dxp, st, rows, total;"),
    ("    gs = kStages<T, H> * xs_stage > kRowBytes ? kStages<T, H> * xs_stage : kRowBytes;",
     "    gs = kStages<T, H> * xs_stage > kRowBytes || kEarlyCopy<H> ? kStages<T, H> * xs_stage\n"
     "                                                                : kRowBytes;"),
    ("    total = st + kTI * H * 3 * 4;\n",
     "    rows = kEarlyCopy<H> ? st + kTI * H * 3 * 4 : 0;\n"
     "    total = (kEarlyCopy<H> ? rows + kRowBytes : st + kTI * H * 3 * 4);\n"),
    ("  float* rows_sm = reinterpret_cast<float*>(smem);",
     "  float* rows_sm = reinterpret_cast<float*>(smem + L.rows);"),
    ("  const uint64_t policy = evict_first_policy();\n  auto copy_tile = [&](int t) {\n"
     "    copy_x2d(xs + (t % kStages<T, H>) * xs_elems, x2d_b, i0, t * kTJ, Lq, Lk, Cp, S, tid,\n"
     "             policy);\n    cp_async_commit();\n  };\n", ""),
    ("  const float* bias_b = bias + (size_t)b * Lk;\n",
     "  const float* bias_b = bias + (size_t)b * Lk;\n"
     "  const uint64_t policy = evict_first_policy();\n"
     "  auto copy_tile = [&](int t) {\n"
     "    copy_x2d(xs + (t % kStages<T, H>) * xs_elems, x2d_b, i0, t * kTJ, Lq, Lk, Cp, S, tid,\n"
     "             policy);\n"
     "    cp_async_commit();\n"
     "  };\n"
     "  if constexpr (kEarlyCopy<H>) copy_tile(0);\n"),
    ("  copy_tile(0);\n  float acc1", "  if constexpr (!kEarlyCopy<H>) copy_tile(0);\n  float acc1"),
    ("  load_qp_rows();  // the stages are read\n",
     "  if constexpr (!kEarlyCopy<H>) load_qp_rows();\n"),
]
# staged_keys: its patches, 380 lines, kept beside this script.
STAGED_KEYS = [tuple(x) for x in json.loads(
    (Path(__file__).with_name("k1_bwd_variants_staged_keys.json")).read_text())["patches"]]

VARIANTS = {  # name: (patches, dtypes it applies to, cuts work)
    "clock": (CLOCK, BOTH, False),
    "one_stage": ([(STAGES, "constexpr int kStages = 1;")], ("bfloat16",), False),
    "f32_two_stages": ([(STAGES, "constexpr int kStages = 2;")], ("float32",), False),
    "lb3": ([("template <typename T, int H>\n__global__ void __launch_bounds__(kThreads, 2)\nbwd_rows(",
              "template <typename T, int H>\n__global__ void __launch_bounds__(kThreads, 3)\n"
              "bwd_rows(")], BOTH, False),
    "sweep1_unroll4": ([("#pragma unroll 2\n    for (int t = 0; t < ntiles; ++t) {\n"
                         "      const int j = t * kTJ + jl, jc = min(j, Lk - 1);\n      KeyCol kc;\n"
                         "      load_key(kc, ks_bh, kp_b, plane, h, Lk, jc);\n      const float bj",
                         "#pragma unroll 4\n    for (int t = 0; t < ntiles; ++t) {\n"
                         "      const int j = t * kTJ + jl, jc = min(j, Lk - 1);\n      KeyCol kc;\n"
                         "      float bj, pav")],
                       BOTH, False),
    "unroll3": ([("      for (int d = 0; d < 12; ++d) dqp[r][d] = 0.f;\n    }\n"
                  "    for (int t = 0; t < ntiles; ++t) {",
                  "      for (int d = 0; d < 12; ++d) dqp[r][d] = 0.f;\n    }\n#pragma unroll 2\n"
                  "    for (int t = 0; t < ntiles; ++t) {")], BOTH, False),
    "g_unroll8": ([("#pragma unroll 4\n    for (int c = tid & (kGT - 1); c < Cp; c += kGT) {",
                    "#pragma unroll 8\n    for (int c = tid & (kGT - 1); c < Cp; c += kGT) {")],
                  BOTH, False),
    "c2_two_pass": ([(C2_F32, C2_F32_TWO_PASS)], ("float32",), False),
    "c1_m_outer": ([(C1_F32, C1_F32_M_OUTER)], ("float32",), False),
    "late_fetch": ([(FETCH + "    cp_async_wait_all();", "    cp_async_wait_all();"),
                    (DPHAT, FETCH + DPHAT)], BOTH, False),
    "dv_rows32": ([("constexpr int kDvRows = 16; ", "constexpr int kDvRows = 32; ")], BOTH, False),
    "dv_rows64": ([("constexpr int kDvRows = 16; ", "constexpr int kDvRows = 64; ")], BOTH, False),
    "cols_chunk8": ([("constexpr int kColChunk = 4; ", "constexpr int kColChunk = 8; ")],
                    BOTH, False),
    "cols_chunk16": ([("constexpr int kColChunk = 4; ", "constexpr int kColChunk = 16;")],
                     BOTH, False),
    "cols_unroll2": ([("    stage(0);\n    for (int rr = 0; rr < nrows; ++rr) {",
                       "    stage(0);\n#pragma unroll 2\n"
                       "    for (int rr = 0; rr < nrows; ++rr) {")], BOTH, False),
    "early_copy": (EARLY_COPY, BOTH, False),
    "staged_keys": (STAGED_KEYS, BOTH, False),
    "no_copy": ([("  for (int e = tid; e < kTI * kTJ * per_row; e += kThreads) {",
                  "  for (int e = tid; e < 0; e += kThreads) {")], BOTH, True),
    "no_fetch": ([("      lg[hp] = logits[row + jc];\n      dv[hp] = dvals[row + jc];",
                   "      lg[hp] = 1e-3f * jc;\n      dv[hp] = 1e-3f * (jc + row);")], BOTH, True),
    "no_sweep1": ([("  for (int hp2 = 0; hp2 < kHeadsAWarp / 2; ++hp2) {\n"
                    "    const int h = head(2 * hp2 + hh);\n"
                    "    const T* ks_bh = k_s + ((size_t)b * H + h) * Lk * kDK;\n"
                    "    size_t row[kTI];\n    float m_run",
                    "  for (int hp2 = 0; hp2 < 0; ++hp2) {\n"
                    "    const int h = head(2 * hp2 + hh);\n"
                    "    const T* ks_bh = k_s + ((size_t)b * H + h) * Lk * kDK;\n"
                    "    size_t row[kTI];\n    float m_run")], BOTH, True),
    "no_setup": ([("    for (int c = tid & (kGT - 1); c < Cp; c += kGT) {",
                   "    for (int c = tid & (kGT - 1); c < 0; c += kGT) {")], BOTH, True),
    "no_sweep3": ([(SWEEP3, SWEEP3.replace("hp2 < kHeadsAWarp / 2", "hp2 < 0"))], BOTH, True),
    "no_c2": ([(C2_OPEN, "    if (false)\n" + C2_OPEN)], BOTH, True),
    "no_c3": ([(C3_LOOP, C3_LOOP + "        if (npairs > 0) break;\n")], BOTH, True),
}


# The 8-head design's clock: bwd8_rows' phases, as CLOCK marks bwd_rows'.
CLOCK8 = [
    ("namespace {\n\nconstexpr int kH = 8; ",
     "namespace {\n\n__device__ unsigned long long g_clk[16];\n\nconstexpr int kH = 8; "),
    ("  const float* bias_b = bias + (size_t)b * Lk;\n\n  // ---- the rows' operands into shared "
     "memory, [H][TI]",
     "  const float* bias_b = bias + (size_t)b * Lk;\n  long long clk = clock64();\n\n"
     "  // ---- the rows' operands into shared memory, [H][TI]"),
    ("  __syncthreads();  // the rows' operands\n",
     "  __syncthreads();  // the rows' operands\n" + _mark(0)),
    ("  // The kept logits (-inf past Lk) and dv of this thread's rows at column jl\n",
     _mark(1) + "  // The kept logits (-inf past Lk) and dv of this thread's rows at column jl\n"),
    ("    cp_async_wait_all();\n    __syncthreads();\n"
     "    if (kStages<T> == 2 && t + 1 < ntiles) copy_tile(t + 1);\n",
     "  " + _mark(2) + "    cp_async_wait_all();\n    __syncthreads();\n"
     "    if (kStages<T> == 2 && t + 1 < ntiles) copy_tile(t + 1);\n  " + _mark(3)),
    ("    __syncthreads();  // G; the stage read\n",
     "  " + _mark(4) + "    __syncthreads();  // G; the stage read\n"),
    ("      dvk[u] = dv_n[u];\n    }\n", "      dvk[u] = dv_n[u];\n    }\n  " + _mark(5)),
    ("    row_d[u] = dv_run[u] + (dxr[0] + dxr[kH]);\n  }\n",
     "    row_d[u] = dv_run[u] + (dxr[0] + dxr[kH]);\n  }\n" + _mark(6)),
    ("                dqp[u][px];\n      }\n    }\n  }\n}\n",
     "                dqp[u][px];\n      }\n    }\n  }\n" + _mark(7) + "}\n"),
    CLOCK[-1],
]
SWEEP1_8 = ("    for (int t = 0; t < ntiles; ++t) {\n"
            "      const int j = t * kTJ + jl, jc = min(j, Lk - 1);\n      KeyCol kc;\n"
            "      load_key(kc, ks_bh, kp_b, plane, ah, Lk, jc);\n      const float bj")
SWEEP3_8 = SWEEP1_8.replace("      const float bj", "      float lgv[2]")
FETCH8 = "    float lg_n[2], dv_n[2];\n    fetch(min(t + 1, ntiles - 1), lg_n, dv_n);\n"
DPHAT8 = "    // dphat = dv + G, the two warps' partial G added in a fixed order.\n"
COLS = "constexpr int kColParts = H == 8 ? 4 : 1;"
C3_STORE8_NARROW = """\
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
"""
# C3's block of the committed 8-head source (c3_last moves it after C2) and
# its d_x2d store (c3_narrow replaces it).
_TC8 = SOURCES[8].read_text()
C3_BLOCK8 = _TC8[_TC8.index("    // C3: d_x2d[pr][j][c]"):_TC8.index("    // C1: wx2d^T[c][h]")]
_STORE8 = C3_BLOCK8.index("      // A channel pair of n-tiles")
C3_STORE8 = C3_BLOCK8[_STORE8:C3_BLOCK8.index("      };\n", _STORE8) + len("      };\n")]
COPY8 = """\
#pragma unroll 1
  for (int rj = warp; rj < kTI * kTJ; rj += kWarps) {
    const int r = rj / kTJ, jj = rj % kTJ;
    const bool ok = i0 + r < Lq && j0 + jj < Lk;
    const T* src = ok ? x2d_b + ((size_t)(i0 + r) * Lk + j0 + jj) * Cp : x2d_b;
    T* dst = xs + rj * stride;
    for (int c = lane; c < per_row; c += 32)
      cp_async16_hint(dst + c * kC, ok ? src + c * kC : x2d_b, ok ? 16 : 0, policy);
  }"""
COPY8_DIV = """\
  const int tid = warp * 32 + lane;
#pragma unroll 1
  for (int e = tid; e < kTI * kTJ * per_row; e += kThreads) {
    const int c = e % per_row, rj = e / per_row, r = rj / kTJ, jj = rj % kTJ;
    const bool ok = i0 + r < Lq && j0 + jj < Lk;
    const T* src = ok ? x2d_b + ((size_t)(i0 + r) * Lk + j0 + jj) * Cp + c * kC : x2d_b;
    cp_async16_hint(xs + rj * stride + c * kC, src, ok ? 16 : 0, policy);
  }"""
VARIANTS8 = {  # name: (patches, dtypes it applies to, cuts work or changes the roundings)
    "clock": (CLOCK8, BOTH, False),
    "one_stage": ([(STAGES, "constexpr int kStages = 1;")], ("bfloat16",), False),
    "div_copy": ([(COPY8, COPY8_DIV)], BOTH, False),
    "c3_narrow": ([(C3_STORE8, C3_STORE8_NARROW)], BOTH, False),
    "x2d_wb": ([("            if (j < Lk) __stcs(reinterpret_cast<uint2*>(dst), odd ? make_uint2(rw, kw)\n"
                 "                                                                  : make_uint2(kw, rw));",
                 "            if (j < Lk) *reinterpret_cast<uint2*>(dst) = odd ? make_uint2(rw, kw)\n"
                 "                                                             : make_uint2(kw, rw);"),
                ("              __stcs(reinterpret_cast<float4*>(dst),\n"
                 "                     odd ? make_float4(r0, r1, keep[0], keep[1])\n"
                 "                         : make_float4(keep[0], keep[1], r0, r1));",
                 "              *reinterpret_cast<float4*>(dst) =\n"
                 "                  odd ? make_float4(r0, r1, keep[0], keep[1])\n"
                 "                      : make_float4(keep[0], keep[1], r0, r1);")], BOTH, False),
    "c3_last": ([(C3_BLOCK8 + "    // C1: wx2d", "    // C1: wx2d"),
                 ("    }\n    __syncthreads();  // G; the stage read\n",
                  "    }\n\n" + C3_BLOCK8.rstrip("\n")
                  + "\n    __syncthreads();  // G; the stage read\n")],
                BOTH, False),
    "cols_parts1": ([(COLS, COLS.replace("? 4", "? 1"))], BOTH, True),
    "cols_parts2": ([(COLS, COLS.replace("? 4", "? 2"))], BOTH, True),
    "cols_parts8": ([(COLS, COLS.replace("? 4", "? 8"))], BOTH, True),
    "unroll3": ([(SWEEP3_8, "#pragma unroll 2\n" + SWEEP3_8)], BOTH, False),
    "g_unroll4": ([("#pragma unroll 2\n    for (int c = lane; c < Cp; c += 32) {",
                    "#pragma unroll 4\n    for (int c = lane; c < Cp; c += 32) {")], BOTH, False),
    "late_fetch": ([(FETCH8 + "    cp_async_wait_all();", "    cp_async_wait_all();"),
                    (DPHAT8, FETCH8 + DPHAT8)], BOTH, False),
    "f32_round": ([('#include "ipa_attention_bwd_common.cuh"\n\nnamespace {\n\nconstexpr int kH = 8;',
                    '#include "ipa_attention_bwd_common.cuh"\n\n#define split_tf32_trunc split_tf32\n\n'
                    "namespace {\n\nconstexpr int kH = 8;")], ("float32",), True),
    "no_copy": ([("    for (int c = lane; c < per_row; c += 32)\n",
                  "    for (int c = lane; c < 0; c += 32)\n")], BOTH, True),
    "no_fetch": ([("      lg[u] = logits[row[u] + jc];\n      dv[u] = dvals[row[u] + jc];",
                   "      lg[u] = 1e-3f * jc;\n      dv[u] = 1e-3f * (jc + u);")], BOTH, True),
    "no_sweep1": ([(SWEEP1_8, SWEEP1_8.replace("t < ntiles", "t < 0"))], BOTH, True),
    "no_setup": ([("    for (int c = lane; c < Cp; c += 32) {",
                   "    for (int c = lane; c < 0; c += 32) {")], BOTH, True),
    "no_sweep3": ([(SWEEP3_8, SWEEP3_8.replace("t < ntiles", "t < 0"))], BOTH, True),
    "no_c2": ([("    // C2: G[j][h] = sum_c x2d[pr][j][c] g[pr][h][c], the warp's k-steps.\n",
                "    if (false)\n    // C2: G[j][h] = sum_c x2d[pr][j][c] g[pr][h][c], the warp's "
                "k-steps.\n")], BOTH, True),
    "no_c3": ([("    // C3: d_x2d[pr][j][c] = sum_h a[pr][h][j] g[pr][h][c], the warp's\n",
                "    if (false)\n    // C3: d_x2d[pr][j][c] = sum_h a[pr][h][j] g[pr][h][c], the "
                "warp's\n")], BOTH, True),
}

def patched(source: Path, headers, patches) -> list[str]:
    """The design's source and the headers it includes with each patch
    applied: a (text, replacement) pair whose text occurs once in one of
    them and nowhere else."""
    texts = [source.read_text(), *(h.read_text() for h in headers)]
    for old, new in patches:
        counts = [x.count(old) for x in texts]
        if sorted(counts) != [0] * len(headers) + [1]:
            raise SystemExit(f"a patch's text occurs {counts} times: {old[:80]!r}")
        k = counts.index(1)
        texts[k] = texts[k].replace(old, new)
    return texts


def build(name: str, source: Path, headers, texts: list[str], nvcc: str,
          flags) -> tuple[str, Path | None, str]:
    """Builds the patched source beside its patched headers, in a directory
    of its own."""
    (OUT / name).mkdir(parents=True, exist_ok=True)
    src, lib = OUT / name / source.name, OUT / f"{name}.so"
    for path, text in zip((source, *headers), texts):
        (OUT / name / path.name).write_text(text)
    # Headers that no patch touches come from the checkout.
    res = subprocess.run([nvcc, *flags, "-I", str(CSRC), "-shared", "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    lines = (res.stdout + res.stderr).splitlines()
    report = "; ".join(x.split(":", 1)[-1].strip() for i, x in enumerate(lines)
                       if ("registers" in x or "spill" in x)
                       and any("bwd_rows" in y or "bwd8_rows" in y or "bwd_cols" in y
                               for y in lines[max(0, i - 3):i]))
    return name, lib if res.returncode == 0 else None, report or res.stderr[-1500:]


def main(argv: list[str]) -> int:
    import torch

    heads = 32
    if argv[:1] == ["--heads"]:
        heads, argv = int(argv[1]), argv[2:]
    variants = VARIANTS8 if heads == 8 else VARIANTS
    names = argv or list(variants)
    if heads not in SOURCES or any(n not in variants for n in names):
        print(f"k1_bwd_variants: [--heads {'|'.join(map(str, SOURCES))}] and variants "
              f"{sorted(variants)}, got --heads {heads} {names}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k1_bwd_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from se3diff_torch.ops import ipa_attention as k1

    OUT.mkdir(parents=True, exist_ok=True)
    source, headers = SOURCES[heads], HEADERS[heads]
    texts = {"committed": patched(source, headers, [])}
    texts.update({n: patched(source, headers, variants[n][0]) for n in names})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(texts)) as pool:
        built = {name: (lib, report) for name, lib, report in pool.map(
            lambda item: build(item[0], source, headers, item[1], k1._nvcc(), k1.NVCC_FLAGS),
            texts.items())}
    print(f"[bwd-variants] {len(built)} sources built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    route = ROUTES[heads]
    libs = {}
    for name, (path, report) in built.items():
        if path is None:
            print(f"[bwd-variants] {name}: build failed: {report}")
            return 1
        lib = ctypes.CDLL(str(path))
        for sym in (f"ipa_attention_{route}", f"ipa_attention_{route}_f32"):
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = [vp] * 26 + [ci] * 6 + [cf, cf, vp], ci
        libs[name] = lib

    sw, pw = cs.K1_KW["scalar_w"], cs.K1_KW["pair_w"]

    def caller(name, args, cts):
        def run():
            saved = k1._lib
            k1._lib = libs[name]  # _launch_backward's kernel from this library
            try:
                return k1._launch_backward(args, cts, sw, pw, counted=False)
            finally:
                k1._lib = saved
        return run

    def largest_rel(got, want):
        return max((a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(),
                                                                    1e-30)
                   for a, b in zip(got, want) if a is not None)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, L, dname, masked in SHAPES[heads]:
        dtype = getattr(torch, dname)
        args = cs.k1_inputs(B, L, dtype, gen, masked_cols=masked, H=heads)
        cts = (torch.randn(B, heads, L, 16, generator=gen, device="cuda").to(dtype),
               torch.randn(B, heads, L, 24, generator=gen, device="cuda"),
               torch.randn(B, heads, L, 16, generator=gen, device="cuda").to(dtype))
        base = caller("committed", args, cts)
        want = base()
        for name in names:
            patches, dtypes, cuts = variants[name]
            if dname not in dtypes:
                continue
            var = caller(name, args, cts)
            err = largest_rel(var(), want)
            t = [cs.cuda_time_ms(f, reps=20) for f in (base, var, var, base)]
            ok = cuts or err == 0.0
            print(f"[bwd-variants] {name:10s} H={heads} B={B} L={L} masked={masked} "
                  f"{dname}: committed "
                  f"{(t[0] + t[3]) / 2:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), variant "
                  f"{(t[1] + t[2]) / 2:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), "
                  f"{100 * ((t[1] + t[2]) / (t[0] + t[3]) - 1):+.1f}%; largest gradient error "
                  f"against the committed source {err:.2e} x its max"
                  f"{' (cuts work)' if cuts else ''} {'ok' if ok else 'DIFFERS'} | "
                  f"{built[name][1]}", flush=True)
            if name == "clock":
                take = libs[name].bwd_clk_take
                take.argtypes, take.restype = [ctypes.c_void_p], ci
                host = (ctypes.c_ulonglong * 16)()
                take(host)  # clear
                var()
                torch.cuda.synchronize()
                if take(host):
                    raise RuntimeError("bwd_clk_take failed")
                rows = ROWS_A_BLOCK[heads]
                blocks = ((L + rows - 1) // rows) * B
                cyc = [host[k] / blocks for k in range(len(PHASES))]
                total = sum(cyc)
                kernel = "bwd8_rows" if heads == 8 else "bwd_rows"
                print(f"[bwd-variants] clock H={heads} B={B} L={L} {dname}: {total:.0f} SM cycles "
                      f"a block of {kernel} ({blocks} blocks): "
                      + ", ".join(f"{p} {c:.0f} ({100 * c / total:.1f}%)"
                                  for p, c in zip(PHASES, cyc)), flush=True)
            if not ok:
                return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[bwd-variants] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
