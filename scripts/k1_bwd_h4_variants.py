#!/usr/bin/env python3
"""Where the time of K1's backward at the PPFT control net's widths goes, and
design variants of it, timed in turns with the committed source on one H100.

    python3 scripts/k1_bwd_h4_variants.py [variant ...]
    python3 scripts/k1_bwd_h4_variants.py --against OTHER_CSRC

from the root of a checkout, on a machine with an NVIDIA H100, nvcc and a
CUDA build of PyTorch. A variant is ``se3diff_torch/csrc/ipa_attention_bwd_h4.cu``
(route "bwd_h4": f32, 4 heads, ``w_pb``) with text patches applied, each
patch's text found once. Every variant named (all by default) and the
committed source are built with nvcc, one process a source, all started
together. At the PPFT step's shape (B=256 L=56 Cp=32) and at L=57 with 5
masked columns, each variant's call (its four kernels) is timed by
``chip_smoke.cuda_time_ms`` in turns with the committed source on the same
inputs (committed, variant, variant, committed). A cut (``no_*``) leaves
part of the work out, so its outputs are wrong by construction and only its
time is read, as the share of the call that part costs; a design variant
computes the same function and is held against the committed source's
gradients at ``chip_smoke.GRAD_TOL`` f32. Prints a line a variant and shape
with ptxas's register and spill report, then the card's name and power
limit. Outputs go to ``.work/k1_bwd_h4_variants/`` (listed in .gitignore).
ptxas's lines are each given after their entry function's mangled name.

With ``--against OTHER_CSRC`` (another tree's ``se3diff_torch/csrc``, say the
parent commit's unpacked by ``git archive`` into a directory that .gitignore
lists) the one variant is that tree's ``ipa_attention_bwd_h4.cu`` as it is,
timed in turns with the committed source at the same shapes, with the
largest difference of any gradient (0 when the two are bit for bit equal);
then the two trees' streamed variant ("bwd_h4s") at the same shapes, bit for
bit and in turns.

Cuts:
- ``no_prologue``: the row block's logits' CUDA-core terms and value terms
  (at L <= 64; above, ``bwd_h4_pre`` takes them);
- ``no_uv``: sweep 1's U | V product (d_w_pv's and d_w_pb's terms);
- ``no_sweep2``: the row kernel's second sweep (a, ds, d_x2d, d_q_s, d_q_p);
- ``no_dq``: sweep 2's d_q_s and d_q_p;
- ``no_cols``: the column kernel;
- ``no_copy``: sweep 1's x2d copies (the stages keep what they held);
- ``no_pag``: sweep 1's pa | G product;
- ``no_setup``: the row's set-up of g and w_pb (W);
- ``no_keyload``: the row block's loads of the key side for the prologue
  (zeros in their place).
Design variants:
- ``stages3``: three x2d stages a warp at Cp <= 32, not two (129 KB a
  block: one block an SM, not two);
- ``late_x2d``: the first x2d tiles copied after the block's other operands
  have landed, not before.
- ``clock``: not a variant but a reading: SM cycles of each live warp of
  ``bwd_h4_rows`` by phase (``clock64()``), summed over 10 calls.
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

_SWEEP2 = ("tt < ntiles; ++tt) {\n      const int ja = tt * kTJ + gr, jb = ja + 8;\n"
           "      const bool oka = ja < Lk, okb = jb < Lk;  // the columns")
_UV = "        if (16 * mt < C16) {\n#pragma unroll\n          for (int ks = 0; ks < 2; ++ks) {"
_ST = "constexpr int stages(int maxc) { return maxc > 32 ? 1 : 2; }"
_PRO = "    for (int r = 0; r < rows; ++r) {"
_X2D0 = ("  cp_async_commit();\n#pragma unroll\n  for (int st = 0; st + 1 < kStages; ++st) {\n"
         "    if (live && st < ntiles)\n"
         "      issue_x2d(xs + st * kTJ * S, x_row, st * kTJ, Lk, Cp, C16 / 4, S, lane, policy);\n"
         "    cp_async_commit();\n  }\n")
_WAIT0 = ("  cp_async_wait<kStages - 1>();  // the query side and w_pv (the oldest group) have landed\n"
          "  __syncthreads();\n")
VARIANTS = {
    "no_prologue": [(_PRO, _PRO.replace("r < rows", "r < 0"))],
    "no_uv": [(_UV, _UV.replace("16 * mt < C16", "false"))],
    "no_sweep2": [(_SWEEP2, _SWEEP2.replace("tt < ntiles", "tt < 0"))],
    "no_dq": [("        if (k ? hb : ha) {", "        if (false) {")],
    "no_cols": [("  bwd_h4_cols<kH, kDK><<<", "  if (false) bwd_h4_cols<kH, kDK><<<")],
    "no_copy": [("    cp_async16(dst + 4 * part, ok ? src + 4 * part : x_row, ok ? 16 : 0, policy);",
                 "    if (false) cp_async16(dst + 4 * part, ok ? src + 4 * part : x_row, ok ? 16 : 0, policy);")],
    "no_pag": [("          mma_tf32(c, a.big, wb[ks].big[0], wb[ks].big[1]);",
                "          if (false) mma_tf32(c, a.big, wb[ks].big[0], wb[ks].big[1]);"),
               ("          mma_tf32(c2, a.small, wb[ks].big[0], wb[ks].big[1]);\n"
                "          mma_tf32(c2, a.big, wb[ks].small[0], wb[ks].small[1]);\n", "")],
    "no_setup": [("      if (h >= kHT) break;", "      break;")],
    "no_keyload": [("  if (pro) {\n    const size_t kr = ((size_t)b * kH + hp) * Lk + min(jp, Lk - 1);",
                    "#pragma unroll\n  for (int q = 0; q < kDK; ++q) kk[q] = vv[q] = 0.f;\n#pragma unroll\n"
                    "  for (int q = 0; q < kVp; ++q) vp[q] = 0.f;\n#pragma unroll\n"
                    "  for (int q = 0; q < 12; ++q) kp[q] = 0.f;\n"
                    "  if (false) {\n    const size_t kr = ((size_t)b * kH + hp) * Lk + min(jp, Lk - 1);")],
    "stages3": [(_ST, _ST.replace("? 1 : 2", "? 1 : 3"))],
    "late_x2d": [(_X2D0, "  cp_async_commit();\n"),
                 (_WAIT0, _WAIT0.replace("cp_async_wait<kStages - 1>()", "cp_async_wait<0>()")
                  + _X2D0[len("  cp_async_commit();\n"):])],
    # SM cycles by phase: lane 0 of each live warp adds its phases' clock64()
    # spans to a device counter, read by h4_clock_read.
    "clock": [
        ("namespace {\n\n// Heads (kH", "namespace {\n\n__device__ unsigned long long h4_clock[8];\n\n// Heads (kH"),
        ("  const uint64_t policy = evict_first_policy();\n\n  // The rows' query side",
         "  const uint64_t policy = evict_first_policy();\n  long long ck[9];\n"
         "#pragma unroll\n  for (int k = 0; k < 9; ++k) ck[k] = clock64();\n\n  // The rows' query side"),
        ("have landed\n  __syncthreads();\n", "have landed\n  __syncthreads();\n  ck[1] = clock64();\n"),
        ("  __syncthreads();  // w_pv is read: the key side goes over it\n",
         "  __syncthreads();  // w_pv is read: the key side goes over it\n  ck[2] = clock64();\n"),
        ("  __syncthreads();\n\n  // pa | G's B operand",
         "  __syncthreads();\n  ck[3] = clock64();\n\n  // pa | G's B operand"),
        ("    cp_async_wait_all();\n    __syncwarp();\n\n",
         "    cp_async_wait_all();\n    __syncwarp();\n    ck[4] = clock64();\n\n"),
        ("    // ================= sweep 2: a, ds, d_x2d, d_q_s, d_q_p =================",
         "    ck[5] = clock64();\n    // ================= sweep 2: a, ds, d_x2d, d_q_s, d_q_p ================="),
        ("    // d_q_s and d_q_p of head t: the 8 lanes' sums added in a fixed order.",
         "    ck[6] = clock64();\n    // d_q_s and d_q_p of head t: the 8 lanes' sums added in a fixed order."),
        ("  } else {\n    // A row past Lq adds zeros",
         "    ck[7] = clock64();\n  } else {\n    // A row past Lq adds zeros"),
        ("    part[e] = acc;\n  }\n}\n\n// ================= bwd_h4_cols",
         "    part[e] = acc;\n  }\n  ck[8] = clock64();\n  if (live && lane == 0)\n"
         "#pragma unroll\n    for (int k = 0; k < 8; ++k) atomicAdd(&h4_clock[k], (unsigned long long)(ck[k + 1] - ck[k]));\n"
         "}\n\n// ================= bwd_h4_cols"),
        ("}  // extern \"C\"",
         "int h4_clock_read(unsigned long long* out) {\n"
         "  cudaError_t err = cudaMemcpyFromSymbol(out, h4_clock, sizeof(h4_clock));\n"
         "  if (err == cudaSuccess) {\n    static const unsigned long long zero[8] = {};\n"
         "    err = cudaMemcpyToSymbol(h4_clock, zero, sizeof(zero));\n  }\n  return (int)err;\n}\n\n"
         "}  // extern \"C\""),
    ],
}
CLOCK_PHASES = ("loads and barrier", "set-up of W and barrier", "prologue (s0, dv) and barrier",
                "sweep 1", "between the sweeps", "sweep 2 (before the d_q sums)",
                "d_q sums and stores", "block barrier and partials")


def ptxas_report(log: str) -> str:
    """ptxas's register, shared-memory and spill lines, each after the
    mangled name of the entry function they describe."""
    out, entry = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.split()[-1]
        elif "registers" in line or "spill" in line:
            out.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return " | ".join(out)


def build(name: str, nvcc: str, flags, source: Path = SOURCE) -> tuple[str, Path | None, str]:
    text = source.read_text()
    for old, new in VARIANTS.get(name, []):
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the patch's text occurs {text.count(old)} times in {SOURCE.name}")
        text = text.replace(old, new)
    src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(text)
    res = subprocess.run([nvcc, *flags, "-shared", "-o", str(lib), str(src)], capture_output=True,
                         text=True)
    return name, lib if res.returncode == 0 else None, (
        ptxas_report(res.stdout + res.stderr) or res.stderr[-1500:])


def main(argv: list[str]) -> int:
    import torch

    other = None
    if argv[:1] == ["--against"]:
        if len(argv) != 2 or not (Path(argv[1]) / SOURCE.name).is_file():
            print("k1_bwd_h4_variants: --against takes another tree's se3diff_torch/csrc",
                  file=sys.stderr)
            return 2
        other, argv = Path(argv[1]).resolve() / SOURCE.name, ["against"]
    names = argv or list(VARIANTS)
    if other is None and any(n not in VARIANTS for n in names):
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
            lambda n: build(n, k1._nvcc(), k1.NVCC_FLAGS, other if n == "against" else SOURCE),
            ["committed", *names]))
    print(f"[bwd-h4-variants] {len(built)} sources built in {time.perf_counter() - t0:.1f} s", flush=True)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {}
    for n, (lib, rep) in built.items():
        if lib is None:
            print(f"[bwd-h4-variants] {n}: build failed: {rep}")
            return 1
        so = ctypes.CDLL(str(lib))
        for entry in (so.ipa_attention_bwd_h4, so.ipa_attention_bwd_h4s):
            entry.argtypes, entry.restype = [vp] * 25 + [ci] * 6 + [cf, cf, vp], ci
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
            if n == "clock":
                counts = (ctypes.c_ulonglong * 8)()
                run()
                torch.cuda.synchronize()
                fns[n].h4_clock_read(counts)  # reset
                for _ in range(10):
                    run()
                torch.cuda.synchronize()
                if fns[n].h4_clock_read(counts):
                    raise RuntimeError("h4_clock_read failed")
                total = sum(counts)
                rows = 10 * B * L
                print(f"[bwd-h4-variants] B={B} L={L} masked={masked} clock: "
                      f"{total / rows:.0f} SM cycles a warp-row: " + "; ".join(
                          f"{ph} {100 * c / total:.1f}%" for ph, c in zip(CLOCK_PHASES, counts)),
                      flush=True)
                continue
            run()
            torch.cuda.synchronize()
            worst = max((o - w).abs().max().item() / w.abs().max().item() for o, w in zip(outs, want))
            times = [chip_smoke.cuda_time_ms(fn, reps=20) for fn in (base, run, run, base)]
            ms, var = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
            held = "" if n.startswith("no_") else (
                f"; gradients against the committed source {worst:.2e} x max "
                + ("(within GRAD_TOL)" if worst <= chip_smoke.GRAD_TOL["float32"] else "(BEYOND GRAD_TOL)"))
            if n == "against":
                held += ("; bit for bit equal" if all(torch.equal(o, w) for o, w in zip(outs, want))
                         else "; NOT bit for bit equal")
            print(f"[bwd-h4-variants] B={B} L={L} masked={masked} {n:12s} {var:.4f} ms against the "
                  f"committed {ms:.4f} ({100 * (ms - var) / ms:+.1f}%; "
                  + ", ".join(f"{t:.4f}" for t in times) + f"){held} | {built[n][1]}", flush=True)
        del args, cts, outs, scratch, want
    if other is not None:
        # The streamed variant ("bwd_h4s", pa in place of w_pb, d_pa out) of
        # both trees at the same shapes, bit for bit and in turns.
        for B, L, masked in SHAPES:
            args = chip_smoke.k1_inputs(B, L, torch.float32, gen, masked, H=4, cp=32)
            cts = tuple(torch.randn(s, generator=gen, device="cuda")
                        for s in ((B, 4, L, 16), (B, 4, L, 24), (B, 4, L, 16)))
            outs = {n: [torch.empty_like(t) for t in args if t.dim() and t is not args[8]]
                    for n in ("committed", "against")}
            scratch = [torch.empty(B, 4, L, -(-L // 4) * 4, device="cuda") for _ in range(2)]
            parts = torch.empty(fns["committed"].ipa_attention_bwd_h4_row_blocks(B, L, 32),
                                4 * 32 * 16, device="cuda")

            def streamed(n):
                ptrs = [t.data_ptr() for t in (*args, *cts, *outs[n], *scratch, parts)]

                def run():
                    err = fns[n].ipa_attention_bwd_h4s(*ptrs, B, 4, L, L, 16, 32, kw["scalar_w"],
                                                       kw["pair_w"],
                                                       torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed ({err})")
                return run

            base, run = streamed("committed"), streamed("against")
            base(), run()
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(outs["committed"], outs["against"]))
            times = [chip_smoke.cuda_time_ms(fn, reps=20) for fn in (base, run, run, base)]
            ms, var = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
            print(f"[bwd-h4-variants] bwd_h4s B={B} L={L} masked={masked} against {var:.4f} ms "
                  f"against the committed {ms:.4f} ({100 * (ms - var) / ms:+.1f}%; "
                  + ", ".join(f"{t:.4f}" for t in times)
                  + f"); {'bit for bit equal' if equal else 'NOT bit for bit equal'}", flush=True)
            del args, cts, outs, scratch
    print(f"[bwd-h4-variants] committed | {built['committed'][1]}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[bwd-h4-variants] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
