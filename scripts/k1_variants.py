#!/usr/bin/env python3
"""Design variants of K1's 16- and 8-head kernels, timed in turns with the
sources as committed, on one H100.

    python3 scripts/k1_variants.py [variant ...]

from the root of a checkout, on a machine with an NVIDIA H100, nvcc and a
CUDA build of PyTorch. A variant is ``se3diff_torch/csrc/ipa_attention_tc16.cu``
("tc16", bf16), ``ipa_attention_tc16_f32.cu`` ("tc16_f32", f32),
``ipa_attention_tc8.cu`` ("tc8") or ``ipa_attention_tc8_f32.cu`` ("tc8_f32")
with text patches applied, each patch's text found once. Every variant
named (all by default) and the committed sources are built with nvcc, one
process a source, all started together. At a tensor-parallel rank's
shapes (Cp=256; 16 heads at B=16, L=100 and L=64; 8 heads at B=40 L=100
and the ``model=4`` path's B=16 L=64 bf16, L=100 f32) and at B=40 L=77 with
9 masked columns, each variant is held against the plain version at
``chip_smoke.TOL`` and timed by ``chip_smoke.cuda_time_ms`` in turns with
the committed source on the same inputs (committed, variant, variant,
committed). Prints a line a variant and shape with ptxas's register and
spill report, then the card's name and power limit. Outputs go to
``.work/k1_variants/`` (listed in .gitignore).

The variants are designs measured against the committed ones and not kept:

- ``two_barrier`` (both): the next x2d tile issued before phase A behind a
  second barrier a tile (three pa buffers), so its copy has two phases to
  land in, not one;
- ``row_pairs`` (f32): the value sums on the logits' groups of eight lanes,
  each lane 5 of a head's 40 channels for its two rows, not a half-warp a
  head over all four rows;
- ``row_pairs_layout_a`` (f32): that, with 8 query rows and 512 threads a
  block, one block an SM;
- ``l1_prefetch`` (both): the next key tile prefetched to L1, not L2;
- ``double_buffer`` (the 8-head designs): two x2d stages a block, each
  warp refilling its row of the stage it just read with the tile after
  next, so a copy has a whole tile to land in; one block an SM, up to 255
  registers a thread.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "se3diff_torch" / "csrc"
OUT = REPO / ".work" / "k1_variants"


def _two_barrier(el: str, ty: str) -> list[tuple[str, str]]:
    """Issue tile t+1's x2d (and tile t+2's pa) before phase A of tile t,
    behind a barrier at the tile's start; wait for tile t's x2d only."""
    return [
        (f"    ps = pas + 2 * kTI * kH * kPS * {el};", f"    ps = pas + 3 * kTI * kH * kPS * {el};"),
        (f"    const {ty}* pa_t = pas + buf * kTileP;",
         f"    const {ty}* pa_t = pas + (t % 3) * kTileP;\n"
         "    if (t > 0) __syncthreads();\n"
         "    if (t + 1 < ntiles)\n"
         "      issue_x2d(xs + (buf ^ 1) * xs_elems, x2d_b, i0, j0 + kTJ, Lq, Lk, Cp, L.xs_stride, tid,\n"
         "                stream);\n"
         "    if (t + 2 < ntiles)\n"
         "      issue_pa(pas + ((t + 2) % 3) * kTileP, pa, pa_elems, b, i0, j0 + 2 * kTJ, Lq, Lk, tid,\n"
         "               stream);\n"
         "    cp_async_commit();"),
        ("""    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < ntiles)
      issue_x2d(xs + (buf ^ 1) * xs_elems, x2d_b, i0, j0 + kTJ, Lq, Lk, Cp, L.xs_stride, tid,
                stream);
    if (t + 2 < ntiles)
      issue_pa(pas + buf * kTileP, pa, pa_elems, b, i0, j0 + 2 * kTJ, Lq, Lk, tid, stream);
    cp_async_commit();""", """    cp_async_wait<1>();
    __syncthreads();"""),
    ]


# The f32 value sums on the logits' row-pair groups (strides two floats
# past a multiple of 32, as the four heads of such a warp need).
ROW_PAIRS = [
    (r'''constexpr int kTJ = 8;                       // key columns per tile: a lane of a group each
constexpr int kRows = 2;                     // query rows of a phase-A group (of 8 lanes)
constexpr int kMaxCp = 256;
''',
     r'''constexpr int kTJ = 8;                       // key columns per tile: a lane of a group each
constexpr int kRows = 2;                     // query rows of a phase-A group
constexpr int kCh = kSV / kTJ;               // value channels a phase-A lane: 5
constexpr int kMaxCp = 256;
'''),
    (r'''constexpr int kPaChunks = 3;                 // 16-byte chunks covering 8 pa columns
// Per-head strides of the phase-A arrays, in floats: four past a multiple
// of 32, so a warp's two heads and two row pairs read distinct banks.
constexpr int kQS = kDK * kTI + 4;           // q_s * scalar_w   [DK][TI]
constexpr int kQPS = kNpts * 3 * kTI + 4;    // query points     [4][3][TI]
constexpr int kPWS = kTJ * kTI + 4;          // p (value sums)   [TJ][TI]
static_assert(kH == 2 * kWarps && kTJ == 8 && kTI == 2 * kRows,
              "phase A: a half-warp a head, eight lanes a (row pair, column)");
static_assert(kWarpsPerRow * kTI == kWarps, "phase B: a warp a row half");
static_assert(kDK == 16 && kVp - 16 <= 16, "value sums: a half-warp lane a channel, and 8 more");
static_assert(kPaChunks * 4 <= kPS, "pa chunks fit a row");
''',
     r'''constexpr int kPaChunks = 3;                 // 16-byte chunks covering 8 pa columns
// Per-head strides of the phase-A arrays, in floats: two past a multiple of
// 32, so the four heads of a warp read distinct banks.
constexpr int kQS = kDK * kTI + 2;           // q_s * scalar_w   [DK][TI]
constexpr int kQPS = kNpts * 3 * kTI + 2;    // query points     [4][3][TI]
constexpr int kPWS = kTJ * kTI + 2;          // p (value sums)   [TJ][TI]
static_assert(kH * kTJ * (kTI / kRows) == kThreads, "phase A: a thread a (head, column, row pair)");
static_assert(kWarpsPerRow * kTI == kWarps, "phase B: a warp a row half");
static_assert(kCh * kTJ == kSV && kDK % kTJ == 0, "phase A: value channels a lane");
static_assert(kPaChunks * 4 <= kPS, "pa chunks fit a row");
'''),
    (r'''
  // Phase-A identity: head h (a half-warp each), query rows r0, r0 + 1 (eight
  // lanes each) and column col of the tile; in the value sums, lane hl of the
  // head's half-warp.
  const int col = lane & (kTJ - 1), hl = lane & 15;
  const int h = 2 * warp + (lane >> 4), r0 = ((lane >> 3) & 1) * kRows;
  const size_t bh = (size_t)b * kH + h;
''',
     r'''
  // Phase-A identity: head h and query rows r0, r0 + 1 (a group of eight
  // lanes each), column col of the tile.
  const int col = lane & (kTJ - 1);
  const int grp = warp * (32 / kTJ) + lane / kTJ;
  const int h = grp % kH, r0 = (grp / kH) * kRows;
  const size_t bh = (size_t)b * kH + h;
'''),
    (r'''  const float* qph = qp_sm + h * kQPS + r0;
  float* pw = reinterpret_cast<float*>(smem + L.pw) + h * kPWS;  // this head's [TJ][TI]
  // Low two bits of each row's element offset in pa: 32-bit wraparound keeps them.
''',
     r'''  const float* qph = qp_sm + h * kQPS + r0;
  float* pw = reinterpret_cast<float*>(smem + L.pw) + h * kPWS + r0;  // this group's
  // Low two bits of each row's element offset in pa: 32-bit wraparound keeps them.
'''),
    (r'''      for (int k = 0; k < kRows; ++k) p_t[((r0 + k) * kH + h) * kPS + col] = p[k];
      *reinterpret_cast<float2*>(pw + col * kTI + r0) = make_float2(p[0], p[1]);
      if (col == 0) {
''',
     r'''      for (int k = 0; k < kRows; ++k) p_t[((r0 + k) * kH + h) * kPS + col] = p[k];
      *reinterpret_cast<float2*>(pw + col * kTI) = make_float2(p[0], p[1]);
      if (col == 0) {
'''),
    (r'''
      // Value sums (f32 p, f32 values) for the four rows: lane hl of the
      // head's half-warp is v_s channel hl and v_p channel hl, and lanes below
      // 8 also take v_p channel 16 + hl. The other row pair's corrections
      // come from the other eight lanes.
      {
        const float o0 = __shfl_xor_sync(0xffffffffu, corr[0], 8);
        const float o1 = __shfl_xor_sync(0xffffffffu, corr[1], 8);
        const bool first = r0 == 0;
        const float c4[kTI] = {first ? corr[0] : o0, first ? corr[1] : o1, first ? o0 : corr[0],
                               first ? o1 : corr[1]};
        const bool second = hl < kVp - 16;
        float os[kTI], op0[kTI], op1[kTI];
#pragma unroll
        for (int r = 0; r < kTI; ++r) os[r] = op0[r] = op1[r] = 0.f;
        const float* vs_col = v_s + (bh * Lk + j0) * kDK + hl;
        const float* vp_col = v_p + (bh * Lk + j0) * kVp + hl;
#pragma unroll
        for (int jj = 0; jj < kTJ; ++jj) {
          const float4 pf = *reinterpret_cast<const float4*>(pw + jj * kTI);
          const bool ok = jj < ncols;
          const float vs = ok ? vs_col[jj * kDK] : 0.f;
          const float v0 = ok ? vp_col[jj * kVp] : 0.f;
          const float v1 = ok && second ? vp_col[jj * kVp + 16] : 0.f;
#pragma unroll
          for (int r = 0; r < kTI; ++r) {
            os[r] = fmaf(lds(pf, r), vs, os[r]);
            op0[r] = fmaf(lds(pf, r), v0, op0[r]);
            op1[r] = fmaf(lds(pf, r), v1, op1[r]);
          }
''',
     r'''
      // Value sums (f32 p, f32 values): lane col takes channels col + 8 c,
      // c < 5, of the head's [v_s | v_p] for both rows.
      {
        float part[kCh][kRows];
#pragma unroll
        for (int c = 0; c < kCh; ++c) part[c][0] = part[c][1] = 0.f;
        const float* vs_row = v_s + (bh * Lk + j0) * kDK + col;
        const float* vp_row = v_p + (bh * Lk + j0) * kVp + col;
#pragma unroll
        for (int jj = 0; jj < kTJ; ++jj) {
          const float2 pf = *reinterpret_cast<const float2*>(pw + jj * kTI);
          const bool ok = jj < ncols;
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            const int ch = kTJ * c;  // + col
            const float v =
                !ok ? 0.f : ch < kDK ? vs_row[jj * kDK + ch] : vp_row[jj * kVp + ch - kDK];
            part[c][0] = fmaf(pf.x, v, part[c][0]);
            part[c][1] = fmaf(pf.y, v, part[c][1]);
          }
'''),
    (r'''#pragma unroll
        for (int r = 0; r < kTI; ++r) {
          float* a = vacc + (r * kH + h) * kSV;
          a[hl] = a[hl] * c4[r] + os[r];
          a[kDK + hl] = a[kDK + hl] * c4[r] + op0[r];
          if (second) a[kDK + 16 + hl] = a[kDK + 16 + hl] * c4[r] + op1[r];
        }
''',
     r'''#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          float* a = vacc + ((r0 + k) * kH + h) * kSV + col;
#pragma unroll
          for (int c = 0; c < kCh; ++c) a[kTJ * c] = a[kTJ * c] * corr[k] + part[c][k];
        }
'''),
    (r'''#pragma unroll
  for (int r = 0; r < kTI; ++r) {
    const int i = i0 + r;
    if (i < Lq) {
      const float inv_l = 1.f / l_sm[r * kH + h];
      const float* a = vacc + (r * kH + h) * kSV;
      out_s[(bh * Lq + i) * kDK + hl] = a[hl] * inv_l;
      out_p[(bh * Lq + i) * kVp + hl] = a[kDK + hl] * inv_l;
      if (hl < kVp - 16) out_p[(bh * Lq + i) * kVp + 16 + hl] = a[kDK + 16 + hl] * inv_l;
    }
''',
     r'''#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = i0 + r0 + k;
    if (i < Lq) {
      const float inv_l = 1.f / l_sm[(r0 + k) * kH + h];
      const float* a = vacc + ((r0 + k) * kH + h) * kSV + col;
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        const int ch = kTJ * c + col;
        if (kTJ * c < kDK)
          out_s[(bh * Lq + i) * kDK + ch] = a[kTJ * c] * inv_l;
        else
          out_p[(bh * Lq + i) * kVp + ch - kDK] = a[kTJ * c] * inv_l;
      }
    }
'''),
]

LAYOUT_A = [("constexpr int kTI = 4; ", "constexpr int kTI = 8; "),
            ("constexpr int kThreads = 256;", "constexpr int kThreads = 512;"),
            ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")]
L1_PREFETCH = [('asm volatile("prefetch.global.L2 [%0];" ::"l"(p));',
                'asm volatile("prefetch.global.L1 [%0];" ::"l"(p));')]


def _double_buffer(el: str) -> list[tuple[str, str]]:
    """Two x2d stages for the 8-head designs: tile t+2 is copied into the
    stage tile t was read from; tile t's wait leaves only tile t+1's copy in
    flight (pa gets a commit group of its own); one block an SM."""
    stage = "kTI * kTJ * L.xs_stride"
    return [
        (f"pas = kTI * kTJ * xs_stride * {el};", f"pas = 2 * kTI * kTJ * xs_stride * {el};"),
        ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)"),
        ("  if (ntiles > 1) issue_pa(pas + kTileP, pa, pa_elems, b, i0, kTJ, Lq, Lk, tid, stream);\n"
         "  cp_async_commit();\n",
         "  if (ntiles > 1) issue_pa(pas + kTileP, pa, pa_elems, b, i0, kTJ, Lq, Lk, tid, stream);\n"
         "  cp_async_commit();\n"
         "  if (ntiles > 1)\n"
         f"    issue_x2d_row(xs_row + {stage}, x2d_b, i0 + warp, kTJ, Lq, Lk, Cp, L.xs_stride, lane,\n"
         "                  stream);\n"
         "  cp_async_commit();\n"),
        ("  cp_async_wait<1>();  // the first pa tile", "  cp_async_wait<2>();  // the first pa tile"),
        ("    cp_async_wait<0>();\n    __syncthreads();\n    if (t + 2 < ntiles)\n"
         "      issue_pa(pas + buf * kTileP, pa, pa_elems, b, i0, j0 + 2 * kTJ, Lq, Lk, tid, stream);\n",
         "    cp_async_wait<1>();\n    __syncthreads();\n    if (t + 2 < ntiles)\n"
         "      issue_pa(pas + buf * kTileP, pa, pa_elems, b, i0, j0 + 2 * kTJ, Lq, Lk, tid, stream);\n"
         "    cp_async_commit();\n"),
        ("xs_row + ((lane & 7)", f"xs_row + buf * {stage} + ((lane & 7)")
        if el == "2" else
        ("const float* xa = xs_row + q", f"const float* xa = xs_row + buf * {stage} + q"),
        ("    if (t + 1 < ntiles)\n      issue_x2d_row(xs_row, x2d_b, i0 + warp, j0 + kTJ,",
         f"    if (t + 2 < ntiles)\n      issue_x2d_row(xs_row + buf * {stage}, x2d_b, i0 + warp, j0 + 2 * kTJ,"),
    ]


VARIANTS = {  # name: (design, patches)
    "tc16:two_barrier": ("tc16", _two_barrier("2", "__nv_bfloat16")),
    "tc16_f32:two_barrier": ("tc16_f32", _two_barrier("4", "float")),
    "tc16_f32:row_pairs": ("tc16_f32", ROW_PAIRS),
    "tc16_f32:row_pairs_layout_a": ("tc16_f32", ROW_PAIRS + LAYOUT_A),
    "tc16:l1_prefetch": ("tc16", L1_PREFETCH),
    "tc16_f32:l1_prefetch": ("tc16_f32", L1_PREFETCH),
    "tc8:double_buffer": ("tc8", _double_buffer("2")),
    "tc8_f32:double_buffer": ("tc8_f32", _double_buffer("4")),
}
# Per design: dtype, heads and the (B, L, masked columns) shapes timed.
DESIGNS = {"tc16": ("bfloat16", 16, [(16, 64, 0), (16, 100, 0), (40, 77, 9)]),
           "tc16_f32": ("float32", 16, [(16, 100, 0), (16, 64, 0), (40, 77, 9)]),
           "tc8": ("bfloat16", 8, [(40, 100, 0), (16, 64, 0), (40, 77, 9)]),
           "tc8_f32": ("float32", 8, [(40, 100, 0), (16, 100, 0), (40, 77, 9)])}


def patched(design: str, patches) -> str:
    text = (CSRC / f"ipa_attention_{design}.cu").read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"{design}: a patch's text occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def build(name: str, text: str, nvcc: str, flags) -> tuple[str, Path | None, str]:
    src, lib = OUT / f"{name.replace(':', '_')}.cu", OUT / f"{name.replace(':', '_')}.so"
    src.write_text(text)
    res = subprocess.run([nvcc, *flags, "-shared", "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    report = "; ".join(x.split(":", 1)[-1].strip() for x in (res.stdout + res.stderr).splitlines()
                       if "registers" in x or "spill" in x)
    return name, lib if res.returncode == 0 else None, report or res.stderr[-1500:]


def main(argv: list[str]) -> int:
    import torch

    names = argv or list(VARIANTS)
    if any(n not in VARIANTS for n in names):
        print(f"k1_variants: variants are {sorted(VARIANTS)}, got {names}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k1_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from se3diff_torch.ops import ipa_attention as k1

    OUT.mkdir(parents=True, exist_ok=True)
    designs = sorted({VARIANTS[n][0] for n in names})
    texts = {d: patched(d, []) for d in designs}
    texts.update({n: patched(*VARIANTS[n]) for n in names})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(texts)) as pool:
        built = {name: (lib, report) for name, lib, report in pool.map(
            lambda item: build(*item, k1._nvcc(), k1.NVCC_FLAGS), texts.items())}
    print(f"[variants] {len(built)} sources built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, (lib, report) in built.items():
        if lib is None:
            print(f"[variants] {name}: build failed: {report}")
            return 1

    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def launcher(name, design, args, B, L, H):
        fn = getattr(ctypes.CDLL(str(built[name][0])), f"ipa_attention_{design}_fwd")
        fn.argtypes, fn.restype = [vp] * 14 + [ci] * 8 + [cf, cf, vp], ci
        outs = (torch.empty_like(args[0]), torch.empty(B, H, L, 24, device="cuda"),
                torch.empty_like(args[0]))

        def run():
            err = fn(*(t.data_ptr() for t in args), None, *(t.data_ptr() for t in outs), B, H, L,
                     L, 16, 256, int(args[0].dtype == torch.bfloat16), 1, cs.K1_KW["scalar_w"],
                     cs.K1_KW["pair_w"], torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: launch failed ({err})")
            return outs
        return run

    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in names:
        design = VARIANTS[name][0]
        dname, H, shapes = DESIGNS[design]
        for B, L, masked in shapes:
            args = cs.k1_inputs(B, L, getattr(torch, dname), gen, masked, H=H)
            want = k1.ipa_attention_plain(*args, **cs.K1_KW)
            base = launcher(design, design, args, B, L, H)
            var = launcher(name, design, args, B, L, H)
            errs = [cs.max_err(f(), want) for f in (base, var)]
            t = [cs.cuda_time_ms(f, reps=20) for f in (base, var, var, base)]
            ok = all(e <= cs.TOL[dname] * s for e, s in errs)
            print(f"[variants] {name:30s} B={B} L={L} masked={masked}: committed "
                  f"{(t[0] + t[3]) / 2:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), variant "
                  f"{(t[1] + t[2]) / 2:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), "
                  f"{100 * ((t[1] + t[2]) / (t[0] + t[3]) - 1):+.1f}%; max_abs_err vs plain "
                  f"{errs[0][0]:.2e} / {errs[1][0]:.2e} (tol {cs.TOL[dname] * errs[1][1]:.2e}) "
                  f"{'ok' if ok else 'FAIL'} | {built[name][1]}", flush=True)
            if not ok:
                return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[variants] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
