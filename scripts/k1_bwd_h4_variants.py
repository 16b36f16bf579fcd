#!/usr/bin/env python3
"""Where the time of K1's backward at the PPFT control net's widths goes, and
design variants of it, timed in turns with the committed source on one H100.

    python3 scripts/k1_bwd_h4_variants.py [variant ...]

from the root of a checkout, on a machine with an NVIDIA H100, nvcc and a
CUDA build of PyTorch. A variant is ``se3diff_torch/csrc/ipa_attention_bwd_h4.cu``
(route "bwd_h4": f32, 4 heads, ``w_pb``) with text patches applied, each
patch's text found once. Every variant named (all by default) and the
committed source are built with nvcc, one process a source, all started
together. At the PPFT step's shape (B=256 L=56 Cp=32) and at L=57 with 5
masked columns, each variant's call (its row, column and reduction kernels)
is timed by ``chip_smoke.cuda_time_ms`` in turns with the committed source
on the same inputs (committed, variant, variant, committed). A cut (``no_*``)
leaves part of the work out, so its outputs are wrong by construction and
only its time is read, as the share of the call that part costs; a design
variant computes the same function and is held against the committed
source's gradients at ``chip_smoke.GRAD_TOL`` f32. Prints a line a variant
and shape with ptxas's register and spill report, then the card's name and
power limit. Outputs go to ``.work/k1_bwd_h4_variants/`` (listed in
.gitignore).

- ``no_sweep2``: the row kernel's second sweep (a, ds, d_x2d, d_q_s, d_q_p);
- ``no_uv``: sweep 1's x2d aggregates U and V (d_w_pv's and d_w_pb's terms);
- ``no_cols``: the column kernel;
- ``three_stage``: three x2d stages, the copy of tile t+2 issued at tile t
  (tiles land two tiles ahead; at most one key chunk, L <= 64);
- ``w_smem``: w_pb (times pair_w) read from shared memory where it is used,
  not held in 16 registers a thread;
- ``cols_lb4``: the column kernel held to 128 registers, four blocks an SM;
- ``cols_lb4_rows8``: that, with chunks of 8 rows.

Two variants measured here were faster and are the committed source now:
sweep 1 behind the warp's barrier, not the block's, and the column kernel's
16-row loop without an early exit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "se3diff_torch" / "csrc" / "ipa_attention_bwd_h4.cu"
OUT = REPO / ".work" / "k1_bwd_h4_variants"
# (B, L, masked columns) at 4 heads, Cp=32, f32.
SHAPES = [(256, 56, 0), (256, 57, 5)]

_WAIT = ("    cp_async_wait_all();\n    if (jl == 0) __syncthreads(); else __syncwarp();\n"
         "    if (t + 1 < ntiles)\n"
         "      issue_x2d<kMaxC>(xs + ((t + 1) & 1) * TI * rs, tile, j0 + kTJ, tid, policy);\n")
VARIANTS = {
    "no_sweep2": [("  for (int t = 0; t < ntiles; ++t) {\n    const int j0 = t * kTJ, jl = j0 % kKC;\n"
                   "    if (restage && jl == 0) {",
                   "  for (int t = 0; t < 0; ++t) {\n    const int j0 = t * kTJ, jl = j0 % kKC;\n"
                   "    if (restage && jl == 0) {")],
    "no_uv": [("    // U += p x2d, V += p dphat x2d, from the stage.\n#pragma unroll\n"
               "    for (int jj = 0; jj < kTJ; ++jj) {",
               "    // U += p x2d, V += p dphat x2d, from the stage.\n#pragma unroll\n"
               "    for (int jj = 0; jj < 0; ++jj) {")],
    "no_cols": [("  bwd_h4_cols<<<", "  if (false) bwd_h4_cols<<<")],
    "three_stage": [
        ("  const int x2d = 2 * TI * kTJ * Cp,", "  const int x2d = 3 * TI * kTJ * Cp,"),
        ("__device__ __forceinline__ void cp_async_wait_all() {",
         "__device__ __forceinline__ void cp_async_wait_one() {\n"
         "  asm volatile(\"cp.async.wait_group 1;\\n\" ::: \"memory\");\n}\n"
         "__device__ __forceinline__ void cp_async_wait_all() {"),
        ("  issue_x2d<kMaxC>(xs, tile, 0, tid, policy);\n  cp_async_commit();\n",
         "  issue_x2d<kMaxC>(xs, tile, 0, tid, policy);\n  cp_async_commit();\n"
         "  if (ntiles > 1) issue_x2d<kMaxC>(xs + TI * rs, tile, kTJ, tid, policy);\n"
         "  cp_async_commit();\n"),
        ("    const float* xr = xs + (t & 1) * TI * rs + r * rs;  // this row's 4 columns",
         "    const float* xr = xs + (t % 3) * TI * rs + r * rs;  // this row's 4 columns"),
        (_WAIT, "    cp_async_wait_one();\n    if (jl == 0) __syncthreads(); else __syncwarp();\n"
                "    if (t + 2 < ntiles)\n"
                "      issue_x2d<kMaxC>(xs + ((t + 2) % 3) * TI * rs, tile, j0 + 2 * kTJ, tid, policy);\n"),
    ],
    "w_smem": [
        ("  return (stage_floats(Cp, TI) + kKeyF) * 4;", "  return (stage_floats(Cp, TI) + kKeyF + 4 * kMaxCp) * 4;"),
        ("  float4 w[kNC][4], gw[kNC][4];\n#pragma unroll\n  for (int k = 0; k < kNC; ++k) {\n"
         "    const int c4 = g + kTPR * k;\n#pragma unroll\n    for (int cc = 0; cc < 4; ++cc) {\n"
         "      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);\n"
         "      if (c4 < cq) v = reinterpret_cast<const float4*>(w_pb)[4 * c4 + cc];\n"
         "      w[k][cc] = make_float4(v.x * pair_w, v.y * pair_w, v.z * pair_w, v.w * pair_w);\n"
         "    }\n  }\n",
         "  float4 gw[kNC][4];\n  float* wsm = key + kKeyF;\n"
         "  for (int e = tid; e < Cp * kH; e += nthr) wsm[e] = w_pb[e] * pair_w;\n"),
        ("      float pa[kH] = {0.f, 0.f, 0.f, 0.f}, pg[kH] = {0.f, 0.f, 0.f, 0.f};\n",
         "      float pa[kH] = {0.f, 0.f, 0.f, 0.f}, pg[kH] = {0.f, 0.f, 0.f, 0.f};\n"
         "      float4 w[kNC][4];\n#pragma unroll\n      for (int k = 0; k < kNC; ++k)\n"
         "#pragma unroll\n        for (int cc = 0; cc < 4; ++cc)\n"
         "          w[k][cc] = g + kTPR * k < cq ? reinterpret_cast<const float4*>(wsm)[4 * (g + kTPR * k) + cc]\n"
         "                                       : make_float4(0.f, 0.f, 0.f, 0.f);\n"),
        ("              const float4 gg = gw[k][cc], ww = w[k][cc];",
         "              const float4 gg = gw[k][cc], ww = reinterpret_cast<const float4*>(wsm)[4 * c4 + cc];"),
    ],
    "cols_lb4": [("__launch_bounds__(kColThreads)\nbwd_h4_cols(", "__launch_bounds__(kColThreads, 4)\nbwd_h4_cols(")],
    "cols_lb4_rows8": [("__launch_bounds__(kColThreads)\nbwd_h4_cols(", "__launch_bounds__(kColThreads, 4)\nbwd_h4_cols("),
                       ("constexpr int kColRows = 16; ", "constexpr int kColRows = 8; ")],
}


def build(name: str, nvcc: str, flags) -> tuple[str, Path | None, str]:
    text = SOURCE.read_text()
    for old, new in VARIANTS.get(name, []):
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the patch's text occurs {text.count(old)} times in {SOURCE.name}")
        text = text.replace(old, new)
    src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(text)
    res = subprocess.run([nvcc, *flags, "-shared", "-o", str(lib), str(src)], capture_output=True,
                         text=True)
    report = "; ".join(x.split(":", 1)[-1].strip() for x in (res.stdout + res.stderr).splitlines()
                       if "registers" in x or "spill" in x)
    return name, lib if res.returncode == 0 else None, report or res.stderr[-1500:]


def main(argv: list[str]) -> int:
    import torch

    names = argv or list(VARIANTS)
    if any(n not in VARIANTS for n in names):
        print(f"k1_bwd_h4_variants: variants are {sorted(VARIANTS)}, got {names}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k1_bwd_h4_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from se3diff_torch.ops import ipa_attention as k1

    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 1) as pool:
        built = dict((n, (lib, rep)) for n, lib, rep in pool.map(
            lambda n: build(n, k1._nvcc(), k1.NVCC_FLAGS), ["committed", *names]))
    print(f"[bwd-h4-variants] {len(built)} sources built in {time.perf_counter() - t0:.1f} s", flush=True)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {}
    for n, (lib, rep) in built.items():
        if lib is None:
            print(f"[bwd-h4-variants] {n}: build failed: {rep}")
            return 1
        so = ctypes.CDLL(str(lib))
        so.ipa_attention_bwd_h4.argtypes, so.ipa_attention_bwd_h4.restype = [vp] * 25 + [ci] * 6 + [cf, cf, vp], ci
        so.ipa_attention_bwd_h4_row_blocks.argtypes, so.ipa_attention_bwd_h4_row_blocks.restype = [ci] * 3, ci
        fns[n] = so

    kw = chip_smoke.K1_KW
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, L, masked in SHAPES:
        args = chip_smoke.k1_inputs(B, L, torch.float32, gen, masked, H=4, cp=32, in_kernel=True)
        cts = tuple(torch.randn(s, generator=gen, device="cuda")
                    for s in ((B, 4, L, 16), (B, 4, L, 24), (B, 4, L, 16)))
        q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, _, w_pb = args
        outs = [torch.empty_like(t) for t in (q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, w_pb)]
        scratch = [torch.empty(B, 4, L, -(-L // 4) * 4, device="cuda") for _ in range(2)]
        parts = torch.empty(fns["committed"].ipa_attention_bwd_h4_row_blocks(B, L, 32), 4 * 32 * 17,
                            device="cuda")
        ptrs = [t.data_ptr() for t in (q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, w_pb, *cts,
                                       *outs, *scratch, parts)]

        def caller(so):
            def run():
                err = so.ipa_attention_bwd_h4(*ptrs, B, 4, L, L, 16, 32, kw["scalar_w"], kw["pair_w"],
                                              torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed ({err})")
            return run

        base = caller(fns["committed"])
        base()
        want = [o.clone() for o in outs]
        for n in names:
            run = caller(fns[n])
            run()
            torch.cuda.synchronize()
            worst = max((o - w).abs().max().item() / w.abs().max().item() for o, w in zip(outs, want))
            times = [chip_smoke.cuda_time_ms(fn, reps=20) for fn in (base, run, run, base)]
            ms, var = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
            held = "" if n.startswith("no_") else (
                f"; gradients against the committed source {worst:.2e} x max "
                + ("(within GRAD_TOL)" if worst <= chip_smoke.GRAD_TOL["float32"] else "(BEYOND GRAD_TOL)"))
            print(f"[bwd-h4-variants] B={B} L={L} masked={masked} {n:12s} {var:.4f} ms against the "
                  f"committed {ms:.4f} ({100 * (ms - var) / ms:+.1f}%; "
                  + ", ".join(f"{t:.4f}" for t in times) + f"){held} | {built[n][1]}", flush=True)
        del args, cts, outs, scratch, want
    print(f"[bwd-h4-variants] committed | {built['committed'][1]}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[bwd-h4-variants] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
