#!/usr/bin/env python3
"""Where the time of K1's hand-written designs goes, by ablation, on one H100.

    python3 scripts/k1_ablation.py [tc] [tc_f32] [tc16] [tc16_f32] [tc8] [tc8_f32] [h4]

from the root of a checkout, on a machine with an NVIDIA H100, nvcc and a
CUDA build of PyTorch. For each design named (all by default: "tc",
``se3diff_torch/csrc/ipa_attention_tc.cu``, bf16; "tc_f32",
``se3diff_torch/csrc/ipa_attention_tc_f32.cu``, f32; "tc16" and
"tc16_f32", ``se3diff_torch/csrc/ipa_attention_tc16{,_f32}.cu``, the same
at 16 heads; "tc8" and "tc8_f32", ``se3diff_torch/csrc/ipa_attention_tc8{,_f32}.cu``,
at 8 heads; "h4", ``se3diff_torch/csrc/ipa_attention_h4.cu``, f32, the
in-kernel pair bias)
it compiles the source as it is and in variants that each cut one part of
the work (a loop made empty, a copy not issued), one nvcc process a
variant, all started together, and times every variant with CUDA events
at the design's widths and the shapes of the paths that launch it (the
32-head tensor-core designs: Cp=256, the sampling path's and the PPFT
score model's shapes; the 16-head ones: Cp=256, a tensor-parallel rank's
shapes in the mesh trainer, B=16 at L=100 and L=64; the 8-head ones:
Cp=256, B=40 L=100 and a rank's shape at ``--mesh model=4``, B=16 L=64 in
bf16 and L=100 in f32; "h4": 4 heads, Cp=32,
the PPFT control net's B=256 L=56 and a batch of 64). A variant's outputs are wrong by construction: only its time is
read, as the share of the full kernel's time that the part it cuts costs.
Prints one line a variant with ptxas's register and spill report, then the
card's name and power limit. Outputs go to ``.work/k1_ablation/`` (listed
in .gitignore).
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
OUT = REPO / ".work" / "k1_ablation"

_PHASE_A = ("    for (int hh = 0; hh < kHeadsPerWarp; ++hh) {\n      const int h = warp + kWarps * hh;\n"
            "      const size_t bh = (size_t)b * kH + h;\n      float s[kTI];")
_PHASE_A_F32 = "    // -------- phase A: logits, online softmax, v_s / v_p sums --------\n    {"
# The 16-head designs' cuts that both sources share.
_TC16 = {
    "phase_a": [(_PHASE_A_F32, _PHASE_A_F32.replace("\n    {", "\n    if (false) {"))],
    "points": [("for (int p = 0; p < kNpts; ++p) {", "for (int p = 0; p < 0; ++p) {")],
    "v_sums": [("for (int jj = 0; jj < kTJ; ++jj) {", "for (int jj = 0; jj < 0; ++jj) {")],
    "key_prefetch": [("if (t + 1 < ntiles) {\n      const int jn", "if (false) {\n      const int jn")],
    "rescale": [("if (rescale && nt < nt_count) {", "if (false) {")],
    "x2d_copy": [("for (int k = 0; k < kMaxCp / 32; ++k)", "for (int k = 0; k < 0; ++k)")],
    "pa_copy": [("if (tid >= kTI * kH * kPaChunks) return;", "return;")],
}
# The 8-head designs' cuts that both sources share (their accumulators are
# m-tiles of channels, their x2d copies a warp's own row).
_TC8 = {
    **{k: v for k, v in _TC16.items() if k not in ("rescale", "x2d_copy")},
    "rescale": [("if (rescale && mt < mt_count) {", "if (false) {")],
    "x2d_copy": [("for (int k = 0; k < kMaxCp / 16; ++k)", "for (int k = 0; k < 0; ++k)")],
}
# Each cut: (text in the source, its replacement). Every text must occur once.
CUTS = {
    "tc": {
        "phase_a": [(_PHASE_A, _PHASE_A.replace("hh < kHeadsPerWarp", "hh < 0"))],
        "points": [("for (int p = 0; p < kNpts; ++p) {", "for (int p = 0; p < 0; ++p) {")],
        "v_p_sums": [("for (int jj = 0; jj < kTJ; ++jj) {", "for (int jj = 0; jj < 0; ++jj) {")],
        "v_s_mma": [("for (int ks = 0; ks < kTJ / 16; ++ks) {\n          const int k0",
                     "for (int ks = 0; ks < 0; ++ks) {\n          const int k0")],
        "phase_b_mma": [("if (2 * np + 1 < nt_count) {", "if (false) {"),
                        ("} else if (2 * np < nt_count) {", "} else if (false) {")],
        "finalize_mma": [("for (int k0 = 0; k0 < Cp; k0 += 16) {",
                          "for (int k0 = 0; k0 < 0; k0 += 16) {")],
        "x2d_copy": [("for (int rj = warp; rj < kTI * kTJ; rj += kWarps) {",
                      "for (int rj = warp; rj < 0; rj += kWarps) {")],
    },
    "tc_f32": {
        "phase_a": [(_PHASE_A_F32, _PHASE_A_F32.replace("\n    {", "\n    if (false) {"))],
        "points": [("for (int p = 0; p < kNpts; ++p) {", "for (int p = 0; p < 0; ++p) {")],
        "v_sums": [("for (int jj = 0; jj < kTJ; ++jj) {", "for (int jj = 0; jj < 0; ++jj) {")],
        "phase_b_mma": [("          if (nt < nt_count) {\n            uint32_t bb0",
                         "          if (false) {\n            uint32_t bb0")],
        "projection": [("for (int c = cq; c < Cp; c += 4) {", "for (int c = cq; c < 0; c += 4) {")],
        # 3xTF32 down to one TF32 product a term in phase B.
        "small_terms": [("  mma_tf32(d, as, bb0, bb1);\n  mma_tf32(d, ab, bs0, bs1);\n", "")],
        "x2d_copy": [("for (int k = 0; k < kMaxCp / 32; ++k)", "for (int k = 0; k < 0; ++k)")],
        "pa_copy": [("for (int e = tid; e < kTI * kH * kPaChunks; e += kThreads) {",
                     "for (int e = tid; e < 0; e += kThreads) {")],
    },
    "tc16": {
        **_TC16,
        "phase_b_mma": [("if (2 * np < nt_count) {", "if (false) {")],
        "finalize_mma": [("for (int k0 = 0; k0 < Cp; k0 += 16) {",
                          "for (int k0 = 0; k0 < 0; k0 += 16) {")],
    },
    "tc16_f32": {
        **_TC16,
        "phase_b_mma": [("        if (nt < nt_count) {\n          uint32_t bb0",
                         "        if (false) {\n          uint32_t bb0")],
        "projection": [("for (int c = cq; c < Cp; c += kTI) {", "for (int c = cq; c < 0; c += kTI) {")],
        # 3xTF32 down to one TF32 product a term in phase B.
        "small_terms": [("  mma_tf32(d, as, bb0, bb1);\n  mma_tf32(d, ab, bs0, bs1);\n", "")],
    },
    "tc8": {
        **_TC8,
        "phase_b_mma": [("if (mt < mt_count) {\n          uint32_t a[4];",
                         "if (false) {\n          uint32_t a[4];")],
        "finalize_mma": [("for (int k0 = 0; k0 < Cp; k0 += 16) {",
                          "for (int k0 = 0; k0 < 0; k0 += 16) {")],
    },
    "tc8_f32": {
        **_TC8,
        "phase_b_mma": [("if (mt < mt_count) {\n          const float2 x0",
                         "if (false) {\n          const float2 x0")],
        "projection": [("for (int c = cq; c < Cp; c += kTI) {", "for (int c = cq; c < 0; c += kTI) {")],
        # 3xTF32 down to one TF32 product a term in phase B.
        "small_terms": [("  mma_tf32(d, as, bb0, bb1);\n  mma_tf32(d, ab, bs0, bs1);\n", "")],
    },
    "h4": {
        "logits": [("    for (int jj = 0; jj < kTJ; ++jj) {\n      float part[kH]",
                    "    for (int jj = 0; jj < 0; ++jj) {\n      float part[kH]")],
        "pair_bias": [("      for (int k = 0; k < kNC; ++k) {\n        const int c4 = g + kTPR * k;\n        xv[jj][k]",
                       "      for (int k = 0; k < 0; ++k) {\n        const int c4 = g + kTPR * k;\n        xv[jj][k]")],
        "points": [("      for (int k = 0; k < 2; ++k) {\n        const float4 kp = kp4",
                    "      for (int k = 0; k < 0; ++k) {\n        const float4 kp = kp4")],
        "rescale": [("if (!__all_sync(0xffffffffu, corr == 1.f)) {", "if (false) {")],
        "x2d_sums": [("      for (int k = 0; k < kNC; ++k) {\n        const float4 x = xv[jj][k];",
                      "      for (int k = 0; k < 0; ++k) {\n        const float4 x = xv[jj][k];")],
        "value_sums": [("      for (int c = 0; c < kVQ; ++c) {\n        av[0][c]", "      for (int c = 0; c < 0; ++c) {\n        av[0][c]")],
        "projection": [("for (int c = 0; c < Cp; ++c) {\n      const float x = xh[c];",
                        "for (int c = 0; c < 0; ++c) {\n      const float x = xh[c];")],
        "x2d_copy": [("  for (int k = 0; k < kMaxC / 8; ++k) {", "  for (int k = 0; k < 0; ++k) {")],
        "key_copy": [("for (int e = tid; e < kH * kKC * 4; e += nthr) {", "for (int e = tid; e < 0; e += nthr) {"),
                     ("for (int e = tid; e < kH * kKC * 6; e += nthr) {", "for (int e = tid; e < 0; e += nthr) {"),
                     ("for (int e = tid; e < 3 * kH * kNpts * kKC; e += nthr) {", "for (int e = tid; e < 0; e += nthr) {"),
                     ("for (int j = tid; j < kKC; j += nthr) {", "for (int j = tid; j < 0; j += nthr) {")],
    },
}
DESIGNS = {  # source, C symbol, dtype name, heads, Cp, has_pa, shapes (B, L)
    "tc": ("ipa_attention_tc.cu", "ipa_attention_tc_fwd", "bfloat16", 32, 256, True,
           [(40, 100), (256, 56)]),
    "tc_f32": ("ipa_attention_tc_f32.cu", "ipa_attention_tc_f32_fwd", "float32", 32, 256, True,
               [(40, 100), (256, 56)]),
    "tc16": ("ipa_attention_tc16.cu", "ipa_attention_tc16_fwd", "bfloat16", 16, 256, True,
             [(16, 64), (16, 100)]),
    "tc16_f32": ("ipa_attention_tc16_f32.cu", "ipa_attention_tc16_f32_fwd", "float32", 16, 256,
                 True, [(16, 100), (16, 64)]),
    "tc8": ("ipa_attention_tc8.cu", "ipa_attention_tc8_fwd", "bfloat16", 8, 256, True,
            [(40, 100), (16, 64)]),
    "tc8_f32": ("ipa_attention_tc8_f32.cu", "ipa_attention_tc8_f32_fwd", "float32", 8, 256, True,
                [(40, 100), (16, 100)]),
    "h4": ("ipa_attention_h4.cu", "ipa_attention_h4_fwd", "float32", 4, 32, False,
           [(256, 56), (64, 56)]),
}


def variants(design: str) -> dict[str, list[tuple[str, str]]]:
    cuts = CUTS[design]
    if design == "h4":
        return {"full": [], **{f"no_{k}": v for k, v in cuts.items()}}
    proj = "finalize_mma" if design in ("tc", "tc16", "tc8") else "projection"
    return {"full": [], **{f"no_{k}": v for k, v in cuts.items()},
            f"no_phase_a_no_{proj}": cuts["phase_a"] + cuts[proj]}


def build(design: str, name: str, nvcc: str, flags) -> tuple[str, str, Path | None, str]:
    source = CSRC / DESIGNS[design][0]
    text = source.read_text()
    for old, new in variants(design)[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{design} {name}: the cut's text occurs {text.count(old)} times in "
                             f"{source.name}")
        text = text.replace(old, new)
    src, lib = OUT / f"{design}_{name}.cu", OUT / f"{design}_{name}.so"
    src.write_text(text)
    res = subprocess.run([nvcc, *flags, "-shared", "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    report = "; ".join(x.split(":", 1)[-1].strip() for x in (res.stdout + res.stderr).splitlines()
                       if "registers" in x or "spill" in x)
    return design, name, lib if res.returncode == 0 else None, report or res.stderr[-1500:]


def main(argv: list[str]) -> int:
    import torch

    designs = argv or list(DESIGNS)
    if any(d not in DESIGNS for d in designs):
        print(f"k1_ablation: designs are {sorted(DESIGNS)}, got {designs}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k1_ablation: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from se3diff_torch.ops import ipa_attention as k1

    OUT.mkdir(parents=True, exist_ok=True)
    jobs = [(d, n) for d in designs for n in variants(d)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build(*j, k1._nvcc(), k1.NVCC_FLAGS), jobs))
    print(f"[ablation] {len(built)} variants built in {time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(scalar_w=1.0 / 48**0.5, pair_w=1.0 / 3**0.5)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for design in designs:
        _, symbol, dname, H, cp, has_pa, shapes = DESIGNS[design]
        dt = getattr(torch, dname)
        inputs = {}
        for B, L in shapes:
            g = lambda *s, scale=1.0: torch.randn(s, generator=gen, device="cuda") * scale
            # The pair bias streamed (pa, w_pb None) or computed in the kernel (w_pb).
            inputs[(B, L)] = [g(B, H, L, 16).to(dt), g(B, H, L, 16).to(dt), g(B, H, L, 16).to(dt),
                              g(B, 3, 4 * H, L, scale=0.3), g(B, 3, 4 * H, L, scale=0.3),
                              g(B, H, L, 24), g(B, L, L, cp, scale=0.5).to(dt),
                              g(H, cp, 16, scale=0.06 * (256 / cp) ** 0.5).to(dt),
                              torch.zeros(B, L, device="cuda"),
                              g(B, H, L, L).to(dt) if has_pa else None,
                              None if has_pa else g(cp, H, scale=cp**-0.5)]
        full = {}
        for d, name, lib, report in built:
            if d != design:
                continue
            if lib is None:
                print(f"[ablation] {design} {name}: build failed: {report}")
                return 1
            fn = getattr(ctypes.CDLL(str(lib)), symbol)
            fn.argtypes, fn.restype = [vp] * 14 + [ci] * 8 + [cf, cf, vp], ci
            times = []
            for B, L in shapes:
                a = inputs[(B, L)]
                outs = (torch.empty_like(a[0]), torch.empty(B, H, L, 24, device="cuda"),
                        torch.empty_like(a[0]))

                def run():
                    err = fn(*(None if t is None else t.data_ptr() for t in a),
                             *(t.data_ptr() for t in outs), B, H, L, L, 16, cp,
                             int(dt == torch.bfloat16), int(has_pa), kw["scalar_w"],
                             kw["pair_w"], torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{design} {name}: launch failed ({err})")

                for _ in range(3):
                    run()
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    run()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end) / 20)
            full = full or dict(zip(shapes, times))
            print(f"[ablation] {design:7s}{name:28s}" + "  ".join(
                f"B={B} L={L} {t:.4f} ms ({100 * (full[(B, L)] - t) / full[(B, L)]:+.1f}% cut)"
                for (B, L), t in zip(shapes, times)) + f" | {report}", flush=True)
        del inputs
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[ablation] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
