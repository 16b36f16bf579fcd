#!/usr/bin/env python3
"""Where the time of K1's tensor-core designs goes, by ablation, on one H100.

    python3 scripts/k1_ablation.py [tc] [tc_f32]

from the root of a checkout, on a machine with an NVIDIA H100, nvcc and a
CUDA build of PyTorch. For each design named (both by default: "tc",
``se3diff_torch/csrc/ipa_attention_tc.cu``, bf16; "tc_f32",
``se3diff_torch/csrc/ipa_attention_tc_f32.cu``, f32) it compiles the source
as it is and in variants that each cut one part of the work (a loop made
empty, a copy not issued), one nvcc process a variant, all started
together, and times every variant with CUDA events at the PPFT score
model's and the sampling path's shapes (32 heads, Cp=256, the design's
dtype). A variant's outputs are wrong by construction: only its time is
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
SHAPES = [(40, 100), (256, 56)]  # (B, L): sampling, the PPFT score model

_PHASE_A = ("    for (int hh = 0; hh < kHeadsPerWarp; ++hh) {\n      const int h = warp + kWarps * hh;\n"
            "      const size_t bh = (size_t)b * kH + h;\n      float s[kTI];")
_PHASE_A_F32 = "    // -------- phase A: logits, online softmax, v_s / v_p sums --------\n    {"
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
}
DESIGNS = {  # source, C symbol, dtype name
    "tc": ("ipa_attention_tc.cu", "ipa_attention_tc_fwd", "bfloat16"),
    "tc_f32": ("ipa_attention_tc_f32.cu", "ipa_attention_tc_f32_fwd", "float32"),
}


def variants(design: str) -> dict[str, list[tuple[str, str]]]:
    cuts = CUTS[design]
    proj = "finalize_mma" if design == "tc" else "projection"
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
        dt = getattr(torch, DESIGNS[design][2])
        inputs = {}
        for B, L in SHAPES:
            g = lambda *s, scale=1.0: torch.randn(s, generator=gen, device="cuda") * scale
            inputs[(B, L)] = [g(B, 32, L, 16).to(dt), g(B, 32, L, 16).to(dt), g(B, 32, L, 16).to(dt),
                              g(B, 3, 128, L, scale=0.3), g(B, 3, 128, L, scale=0.3), g(B, 32, L, 24),
                              g(B, L, L, 256, scale=0.5).to(dt), g(32, 256, 16, scale=0.06).to(dt),
                              torch.zeros(B, L, device="cuda"), g(B, 32, L, L).to(dt)]
        full = {}
        for d, name, lib, report in built:
            if d != design:
                continue
            if lib is None:
                print(f"[ablation] {design} {name}: build failed: {report}")
                return 1
            fn = getattr(ctypes.CDLL(str(lib)), DESIGNS[design][1])
            fn.argtypes, fn.restype = [vp] * 14 + [ci] * 8 + [cf, cf, vp], ci
            times = []
            for B, L in SHAPES:
                a = inputs[(B, L)]
                outs = (torch.empty_like(a[0]), torch.empty(B, 32, L, 24, device="cuda"),
                        torch.empty_like(a[0]))

                def run():
                    err = fn(*(t.data_ptr() for t in a), None, *(t.data_ptr() for t in outs),
                             B, 32, L, L, 16, 256, int(dt == torch.bfloat16), 1, kw["scalar_w"],
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
            full = full or dict(zip(SHAPES, times))
            print(f"[ablation] {design:7s}{name:28s}" + "  ".join(
                f"B={B} L={L} {t:.4f} ms ({100 * (full[(B, L)] - t) / full[(B, L)]:+.1f}% cut)"
                for (B, L), t in zip(SHAPES, times)) + f" | {report}", flush=True)
        del inputs
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[ablation] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
