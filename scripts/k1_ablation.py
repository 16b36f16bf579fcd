#!/usr/bin/env python3
"""Where the time of K1's tensor-core design goes, by ablation, on one H100.

    python3 scripts/k1_ablation.py

from the root of a checkout, on a machine with an NVIDIA H100, nvcc and a
CUDA build of PyTorch. It compiles ``se3diff_torch/csrc/ipa_attention_tc.cu``
as it is and in variants that each cut one part of the work (a loop made
empty, a copy not issued), one nvcc process a variant, all started
together, and times every variant with CUDA events at the PPFT score
model's and the sampling path's shapes (bf16, 32 heads, Cp=256). A variant's
outputs are wrong by construction: only its time is read, as the share of
the full kernel's time that the part it cuts costs. Prints one line a
variant with ptxas's register and spill report, then the card's name and
power limit. Outputs go to ``.work/k1_ablation/`` (listed in .gitignore).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "se3diff_torch" / "csrc" / "ipa_attention_tc.cu"
OUT = REPO / ".work" / "k1_ablation"
SHAPES = [(40, 100), (256, 56)]  # (B, L): sampling, the PPFT score model

_PHASE_A = ("    for (int hh = 0; hh < kHeadsPerWarp; ++hh) {\n      const int h = warp + kWarps * hh;\n"
            "      const size_t bh = (size_t)b * kH + h;\n      float s[kTI];")
# Each cut: (text in the source, its replacement). Every text must occur once.
CUTS = {
    "phase_a": [(_PHASE_A, _PHASE_A.replace("hh < kHeadsPerWarp", "hh < 0"))],
    "points": [("for (int p = 0; p < kNpts; ++p) {", "for (int p = 0; p < 0; ++p) {")],
    "v_p_sums": [("for (int jj = 0; jj < kTJ; ++jj) {", "for (int jj = 0; jj < 0; ++jj) {")],
    "v_s_mma": [("for (int ks = 0; ks < kTJ / 16; ++ks) {\n          const int k0",
                 "for (int ks = 0; ks < 0; ++ks) {\n          const int k0")],
    "phase_b_mma": [("if (2 * np + 1 < nt_count) {", "if (false) {"),
                    ("} else if (2 * np < nt_count) {", "} else if (false) {")],
    "finalize_mma": [("for (int k0 = 0; k0 < Cp; k0 += 16) {", "for (int k0 = 0; k0 < 0; k0 += 16) {")],
    "x2d_copy": [("for (int rj = warp; rj < kTI * kTJ; rj += kWarps) {",
                  "for (int rj = warp; rj < 0; rj += kWarps) {")],
}
VARIANTS = {"full": [], **{f"no_{k}": v for k, v in CUTS.items()},
            "no_phase_a_no_finalize_mma": CUTS["phase_a"] + CUTS["finalize_mma"]}


def build(name: str, nvcc: str, flags) -> tuple[str, Path | None, str]:
    text = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the cut's text occurs {text.count(old)} times in {SOURCE.name}")
        text = text.replace(old, new)
    src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(text)
    res = subprocess.run([nvcc, *flags, "-shared", "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    report = "; ".join(x.split(":", 1)[-1].strip() for x in (res.stdout + res.stderr).splitlines()
                       if "registers" in x or "spill" in x)
    return name, lib if res.returncode == 0 else None, report or res.stderr[-1500:]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_ablation: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from se3diff_torch.ops import ipa_attention as k1

    OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda n: build(n, k1._nvcc(), k1.NVCC_FLAGS), VARIANTS))
    print(f"[ablation] {len(built)} variants built in {time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(scalar_w=1.0 / 48**0.5, pair_w=1.0 / 3**0.5)
    inputs = {}
    for B, L in SHAPES:
        g = lambda *s, scale=1.0: torch.randn(s, generator=gen, device="cuda") * scale
        bf = torch.bfloat16
        inputs[(B, L)] = [g(B, 32, L, 16).to(bf), g(B, 32, L, 16).to(bf), g(B, 32, L, 16).to(bf),
                          g(B, 3, 128, L, scale=0.3), g(B, 3, 128, L, scale=0.3), g(B, 32, L, 24),
                          g(B, L, L, 256, scale=0.5).to(bf), g(32, 256, 16, scale=0.06).to(bf),
                          torch.zeros(B, L, device="cuda"), g(B, 32, L, L).to(bf)]
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    full = {}
    for name, lib, report in built:
        if lib is None:
            print(f"[ablation] {name}: build failed: {report}")
            return 1
        fn = ctypes.CDLL(str(lib)).ipa_attention_tc_fwd
        fn.argtypes, fn.restype = [vp] * 14 + [ci] * 8 + [cf, cf, vp], ci
        times = []
        for B, L in SHAPES:
            a = inputs[(B, L)]
            outs = (torch.empty_like(a[0]), torch.empty(B, 32, L, 24, device="cuda"),
                    torch.empty_like(a[0]))

            def run():
                err = fn(*(t.data_ptr() for t in a), None, *(t.data_ptr() for t in outs),
                         B, 32, L, L, 16, 256, 1, 1, kw["scalar_w"], kw["pair_w"],
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")

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
        print("[ablation] " + f"{name:28s}" + "  ".join(
            f"B={B} L={L} {t:.4f} ms ({100 * (full[(B, L)] - t) / full[(B, L)]:+.1f}% cut)"
            for (B, L), t in zip(SHAPES, times)) + f" | {report}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[ablation] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
