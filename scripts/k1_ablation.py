#!/usr/bin/env python3
"""Where the time of K1's hand-written designs goes, by ablation, on one H100.

    python3 scripts/k1_ablation.py [tc] [tc_f32] [tc_pb] [tc_pb_f32] [tc16] [tc16_f32] [tc8]
                                   [tc8_f32] [h4]
    python3 scripts/k1_ablation.py --against OTHER_CSRC [design ...]

from the root of a checkout, on a machine with an NVIDIA H100, nvcc and a
CUDA build of PyTorch. For each design named (all by default: "tc",
``se3diff_torch/csrc/ipa_attention_tc.cu``, bf16; "tc_f32",
``se3diff_torch/csrc/ipa_attention_tc_f32.cu``, f32; "tc_pb" and "tc_pb_f32",
the in-kernel pair bias's variants of those two sources; "tc16" and
"tc16_f32", ``se3diff_torch/csrc/ipa_attention_tc16{,_f32}.cu``, the same
at 16 heads; "tc8" and "tc8_f32", ``se3diff_torch/csrc/ipa_attention_tc8{,_f32}.cu``,
at 8 heads; "h4", ``se3diff_torch/csrc/ipa_attention_h4.cu``, f32, the
in-kernel pair bias)
it compiles the source as it is and in variants that each cut one part of
the work (a loop made empty, a copy not issued), one nvcc process a
variant, all started together, and times every variant with CUDA events
at the design's widths and the shapes of the paths that launch it (the
32-head tensor-core designs: Cp=256, the sampling path's and the PPFT
score model's shapes, the in-kernel variants at the same shapes, where
``no_pair_bias_mma`` is the share of the pa contraction; the 16-head ones: Cp=256, a tensor-parallel rank's
shapes in the mesh trainer, B=16 at L=100 and L=64; the 8-head ones:
Cp=256, B=40 L=100 and a rank's shape at ``--mesh model=4``, B=16 L=64 in
bf16 and L=100 in f32; "h4": 4 heads, Cp=32,
the PPFT control net's B=256 L=56 and a batch of 64). A variant's outputs are wrong by construction: only its time is
read, as the share of the full kernel's time that the part it cuts costs.
Prints one line a variant with ptxas's register and spill report, then the
card's name and power limit. Outputs go to ``.work/k1_ablation/`` (listed
in .gitignore).

With ``--against OTHER_CSRC`` (another tree's ``se3diff_torch/csrc``, say
the parent commit's unpacked by ``git archive`` into a directory that
.gitignore lists) it cuts nothing: it builds each design's source from
both trees, prints the ptxas report of each, and times the two at the
design's shapes in turns (other, this, this, other) on the same inputs,
with the outputs' largest difference.
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
_ONE_TERM = ("  mma_tf32(d, as, bb0, bb1);\n  mma_tf32(d, ab, bs0, bs1);\n", "")
# The 32-head f32 design's TF32 helpers come from a header: its cut of the
# small terms puts the header's text, cut, in place of the include.
_TF32_INCLUDE = '#include "ipa_attention_tf32.cuh"\n'
_TF32_ONE_TERM = (CSRC / "ipa_attention_tf32.cuh").read_text().replace(
    "#pragma once\n", "").replace(*_ONE_TERM)
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
        "small_terms": [(_TF32_INCLUDE, _TF32_ONE_TERM)],
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
        "small_terms": [_ONE_TERM],
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
        "small_terms": [_ONE_TERM],
    },
    "tc_pb": {
        "phase_a": [(_PHASE_A, _PHASE_A.replace("hh < kHeadsPerWarp", "hh < 0"))],
        "points": [("for (int p = 0; p < kNpts; ++p) {", "for (int p = 0; p < 0; ++p) {")],
        "v_p_sums": [("for (int jj = 0; jj < kTJ; ++jj) {", "for (int jj = 0; jj < 0; ++jj) {")],
        "v_s_mma": [("for (int ks = 0; ks < kTJ / 16; ++ks) {\n          const int k0",
                     "for (int ks = 0; ks < 0; ++ks) {\n          const int k0")],
        "phase_b_mma": [("if (2 * np + 1 < nt_count) {", "if (false) {"),
                        ("} else if (2 * np < nt_count) {", "} else if (false) {")],
        "pair_bias_mma": [("for (int c0 = 0; c0 < Cp; c0 += 16) {",
                           "for (int c0 = 0; c0 < 0; c0 += 16) {")],
        "finalize_mma": [("for (int k0 = 0; k0 < Cp; k0 += 16) {",
                          "for (int k0 = 0; k0 < 0; k0 += 16) {")],
        # The prologue's two tiles (issue_x2d) and every later tile, which
        # each query row's warps copy (issue_x2d_row).
        "x2d_copy": [("for (int rj = warp; rj < kTI * kTJ; rj += kWarps) {",
                      "for (int rj = warp; rj < 0; rj += kWarps) {"),
                     ("for (int jj = warp % kWarpsPerRow; jj < kTJ; jj += kWarpsPerRow) {",
                      "for (int jj = warp % kWarpsPerRow; jj < 0; jj += kWarpsPerRow) {")],
    },
    "tc_pb_f32": {
        "phase_a": [(_PHASE_A_F32, _PHASE_A_F32.replace("\n    {", "\n    if (false) {"))],
        "points": [("for (int p = 0; p < kNpts; ++p) {", "for (int p = 0; p < 0; ++p) {")],
        "v_sums": [("for (int jj = 0; jj < kTJ; ++jj) {", "for (int jj = 0; jj < 0; ++jj) {")],
        "phase_b_mma": [("          if (nt < nt_count) {\n            uint32_t bb0",
                         "          if (false) {\n            uint32_t bb0")],
        "pair_bias_mma": [("for (int c0 = 0; c0 < Cp; c0 += 8) {", "for (int c0 = 0; c0 < 0; c0 += 8) {")],
        "projection": [("for (int c = cq; c < Cp; c += 4) {", "for (int c = cq; c < 0; c += 4) {")],
        # 3xTF32 down to one TF32 product a term, in phase B and the pair bias.
        "small_terms": [(_TF32_INCLUDE, _TF32_ONE_TERM)],
        "x2d_copy": [("for (int k = 0; k < kMaxCp / 32; ++k)", "for (int k = 0; k < 0; ++k)")],
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
    "tc_pb": ("ipa_attention_tc.cu", "ipa_attention_tc_pb_fwd", "bfloat16", 32, 256, False,
              [(40, 100), (256, 56)]),
    "tc_pb_f32": ("ipa_attention_tc_f32.cu", "ipa_attention_tc_pb_f32_fwd", "float32", 32, 256,
                  False, [(40, 100), (256, 56)]),
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
    proj = "finalize_mma" if design in ("tc", "tc_pb", "tc16", "tc8") else "projection"
    return {"full": [], **{f"no_{k}": v for k, v in cuts.items()},
            f"no_phase_a_no_{proj}": cuts["phase_a"] + cuts[proj]}


def build(design: str, name: str, nvcc: str, flags, csrc: Path = CSRC,
          tag: str = "") -> tuple[str, str, Path | None, str]:
    """The design's source from ``csrc`` with the variant's cuts applied
    (none for "full"), built as ``.work/k1_ablation/{tag}{design}_{name}``;
    its own headers come from ``csrc``."""
    source = csrc / DESIGNS[design][0]
    text = source.read_text()
    for old, new in variants(design)[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{design} {name}: the cut's text occurs {text.count(old)} times in "
                             f"{source.name}")
        text = text.replace(old, new)
    src, lib = OUT / f"{tag}{design}_{name}.cu", OUT / f"{tag}{design}_{name}.so"
    src.write_text(text)
    res = subprocess.run([nvcc, *flags, "-I", str(csrc), "-shared", "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    report = "; ".join(x.split(":", 1)[-1].strip() for x in (res.stdout + res.stderr).splitlines()
                       if "registers" in x or "spill" in x)
    return design, name, lib if res.returncode == 0 else None, report or res.stderr[-1500:]


def inputs(design: str, B: int, L: int, gen) -> list:
    """The C entry's operands at the design's widths: the pair bias streamed
    (pa, w_pb None) or computed in the kernel (w_pb)."""
    import torch

    _, _, dname, H, cp, has_pa, _ = DESIGNS[design]
    dt = getattr(torch, dname)
    g = lambda *s, scale=1.0: torch.randn(s, generator=gen, device="cuda") * scale
    return [g(B, H, L, 16).to(dt), g(B, H, L, 16).to(dt), g(B, H, L, 16).to(dt),
            g(B, 3, 4 * H, L, scale=0.3), g(B, 3, 4 * H, L, scale=0.3), g(B, H, L, 24),
            g(B, L, L, cp, scale=0.5).to(dt), g(H, cp, 16, scale=0.06 * (256 / cp) ** 0.5).to(dt),
            torch.zeros(B, L, device="cuda"), g(B, H, L, L).to(dt) if has_pa else None,
            None if has_pa else g(cp, H, scale=cp**-0.5)]


def launcher(design: str, lib: Path, a: list, B: int, L: int):
    """A call of the library's C entry on ``a``, and the outputs it writes."""
    import torch

    _, symbol, dname, H, cp, has_pa, _ = DESIGNS[design]
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = [vp] * 14 + [ci] * 8 + [cf, cf, vp], ci
    outs = (torch.empty_like(a[0]), torch.empty(B, H, L, 24, device="cuda"), torch.empty_like(a[0]))

    def run():
        err = fn(*(None if t is None else t.data_ptr() for t in a), *(t.data_ptr() for t in outs),
                 B, H, L, L, 16, cp, int(dname == "bfloat16"), int(has_pa), 1.0 / 48**0.5,
                 1.0 / 3**0.5, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{design} {lib.name}: launch failed ({err})")

    return run, outs


def timed(run) -> float:
    """ms a launch: 20 launches after 3, by CUDA events."""
    import torch

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 20


def ablate(designs: list[str], built: list, gen) -> int:
    for design in designs:
        shapes = DESIGNS[design][6]
        operands = {(B, L): inputs(design, B, L, gen) for B, L in shapes}
        full = {}
        for d, name, lib, report in built:
            if d != design:
                continue
            if lib is None:
                print(f"[ablation] {design} {name}: build failed: {report}")
                return 1
            times = [timed(launcher(design, lib, operands[(B, L)], B, L)[0]) for B, L in shapes]
            full = full or dict(zip(shapes, times))
            print(f"[ablation] {design:7s}{name:28s}" + "  ".join(
                f"B={B} L={L} {t:.4f} ms ({100 * (full[(B, L)] - t) / full[(B, L)]:+.1f}% cut)"
                for (B, L), t in zip(shapes, times)) + f" | {report}", flush=True)
        del operands
    return 0


def against(designs: list[str], built: list, gen) -> int:
    """Each design's full source from the other tree and from this one, timed
    in turns (other, this, this, other) on the same inputs."""
    for i, design in enumerate(designs):
        libs = {}
        for tree, (_, _, lib, report) in zip(("other", "this"), built[2 * i:2 * i + 2]):
            print(f"[ablation] {design} {tree}: ptxas {report}", flush=True)
            if lib is None:
                return 1
            libs[tree] = lib
        for B, L in DESIGNS[design][6]:
            a = inputs(design, B, L, gen)
            runs = {tree: launcher(design, lib, a, B, L) for tree, lib in libs.items()}
            t = [timed(runs[tree][0]) for tree in ("other", "this", "this", "other")]
            diff = max((x.float() - y.float()).abs().max().item()
                       for x, y in zip(runs["other"][1], runs["this"][1]))
            print(f"[ablation] {design} B={B} L={L} {DESIGNS[design][2]}: other {t[0]:.4f}, "
                  f"{t[3]:.4f} ms; this {t[1]:.4f}, {t[2]:.4f} ms "
                  f"({100 * ((t[1] + t[2]) / (t[0] + t[3]) - 1):+.1f}%); outputs differ by at most "
                  f"{diff:.3e}", flush=True)
            del a, runs
    return 0


def main(argv: list[str]) -> int:
    import torch

    other = None
    if argv[:1] == ["--against"]:
        if len(argv) < 2 or not Path(argv[1]).is_dir():
            print("k1_ablation: --against takes another tree's se3diff_torch/csrc", file=sys.stderr)
            return 2
        other, argv = Path(argv[1]).resolve(), argv[2:]
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
    if other is None:
        jobs = [(d, n, CSRC, "") for d in designs for n in variants(d)]
    else:
        jobs = [(d, "full", csrc, tag) for d in designs
                for csrc, tag in ((other, "other_"), (CSRC, ""))]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build(j[0], j[1], k1._nvcc(), k1.NVCC_FLAGS, *j[2:]), jobs))
    print(f"[ablation] {len(built)} builds in {time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rc = (ablate if other is None else against)(designs, built, gen)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[ablation] {card}")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
