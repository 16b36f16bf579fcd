#!/usr/bin/env python3
"""Where the time of K1's backward kernel goes, by kernel, on one H100.

    python3 scripts/k1_bwd_parts.py [tc] [tc16] [tc8] [h4] [h4s]

from the root of a checkout, on a machine with an NVIDIA H100, nvcc and a
CUDA build of PyTorch (no argument: all five). Builds the IPA attention library,
then for each shape the paths give a backward kernel calls
``ops.ipa_attention._launch_backward`` once to warm up and once under
``torch.profiler``, and prints the device time of every kernel of the call
beside the call's time by CUDA events (the median of 20), then the card's
name and power limit. ``tc``: 32 heads of 16, Cp=256, the streamed pair
bias (routes "bwd_tc", "bwd_tc_f32": the value-term kernel ``bwd_dv``, the
row kernel ``bwd_rows<T, 32>``, the column kernel ``bwd_cols``, the
``bmm`` for d_w_pv and the casts and copies around them) at the train
step's B=16 L=100 in bf16 and f32, the PPFT learning run's B=32 L=56 bf16
and an SP slab of 150 rows of L=300 in f32. ``tc16``: the same at a
tensor-parallel rank's 16 heads (routes "bwd_tc16", "bwd_tc16_f32":
``bwd_dv``, ``bwd_rows<T, 16>``, ``bwd_cols``; no ``bmm`` for g) at the
``--mesh model=2`` f32 step's B=16 L=100, the train CLI's B=16 L=64 bf16,
and B=40 L=77 with 9 masked columns in both dtypes. ``tc8``: the same at a rank's 8 heads at
``--mesh model=4`` (routes "bwd_tc8", "bwd_tc8_f32": ``bwd_dv``,
``bwd8_rows``, ``bwd_cols``; no ``bmm`` for g) at the same four shapes. ``h4``: 4
heads of 16, f32, the pair bias from ``w_pb`` (route "bwd_h4": ``bwd_h4_pre``,
``bwd_h4_rows``, ``bwd_h4_cols``, ``bwd_h4_wsum``) at the PPFT step's B=256
L=56 Cp=32, L=57 with 5 masked columns, Cp=64, B=64 L=100 and B=64 L=56;
before its shapes, ptxas's registers and spills of the bwd_h4 kernels and
the row kernel's resident blocks an SM. ``h4s``: the same source's streamed
variant (route "bwd_h4s": ``bwd_h4_rows`` and ``bwd_h4_cols``, the
``bwd_h4_wsum`` of d_w_pv alone, ``bwd_h4s_pre`` above 64 key columns) at
the training example's widths, 4 heads of 8, Cp=16: its batch B=8 L=8, B=8
L=64 with 4 masked columns, B=64 L=100; and at 4 heads of 16, Cp=32, B=64
L=100.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# (B, query rows, key columns, dtype, heads, Cp, masked columns[, head width]), by design.
SHAPES = {
    "tc": [(16, 100, 100, "bfloat16", 32, 256, 0), (16, 100, 100, "float32", 32, 256, 0),
           (32, 56, 56, "bfloat16", 32, 256, 0), (4, 150, 300, "float32", 32, 256, 0)],
    "tc16": [(16, 100, 100, "float32", 16, 256, 0), (16, 64, 64, "bfloat16", 16, 256, 0),
             (40, 77, 77, "bfloat16", 16, 256, 9), (40, 77, 77, "float32", 16, 256, 9)],
    "tc8": [(16, 100, 100, "float32", 8, 256, 0), (16, 64, 64, "bfloat16", 8, 256, 0),
            (40, 77, 77, "bfloat16", 8, 256, 9), (40, 77, 77, "float32", 8, 256, 9)],
    "h4": [(256, 56, 56, "float32", 4, 32, 0), (256, 57, 57, "float32", 4, 32, 5),
           (256, 56, 56, "float32", 4, 64, 0), (64, 100, 100, "float32", 4, 32, 0),
           (64, 56, 56, "float32", 4, 32, 0)],
    "h4s": [(8, 8, 8, "float32", 4, 16, 0, 8), (8, 64, 64, "float32", 4, 16, 4, 8),
            (64, 100, 100, "float32", 4, 16, 0, 8), (64, 100, 100, "float32", 4, 32, 0, 16)],
}


def _inputs(B, Lq, Lk, dtype, H, cp, masked, gen, in_kernel, dk=16):
    """The streamed pair bias, or with ``in_kernel`` ``w_pb`` in its place,
    at heads of width ``dk``."""
    import torch

    r = lambda *s, scale=1.0: torch.randn(s, generator=gen, device="cuda") * scale  # noqa: E731
    bias = torch.zeros(B, Lk, device="cuda")
    if masked:
        bias[:, -masked:] = -1e30
    args = [r(B, H, Lq, dk).to(dtype), r(B, H, Lk, dk).to(dtype), r(B, H, Lk, dk).to(dtype),
            r(B, 3, H * 4, Lq, scale=0.3), r(B, 3, H * 4, Lk, scale=0.3), r(B, H, Lk, 24, scale=2.0),
            r(B, Lq, Lk, cp, scale=0.5).to(dtype), r(H, cp, dk, scale=0.06).to(dtype), bias]
    args += [None, r(cp, H, scale=cp**-0.5)] if in_kernel else [r(B, H, Lq, Lk).to(dtype)]
    cts = (r(B, H, Lq, dk).to(dtype), r(B, H, Lq, 24), r(B, H, Lq, dk).to(dtype))
    return args, cts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_bwd_parts: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from se3diff_torch.ops import ipa_attention as k1
    from se3diff_torch.utils.profiling import profile_device

    designs = sys.argv[1:] or list(SHAPES)
    if any(d not in SHAPES for d in designs):
        print(f"k1_bwd_parts: designs are {sorted(SHAPES)}, got {designs}", file=sys.stderr)
        return 2
    _, report = k1.build_library()
    if "h4" in designs or "h4s" in designs:
        lines = report.splitlines()
        for n, line in enumerate(lines):
            if "Compiling entry function" in line and ("bwd_h4_" in line or "bwd_h4s_" in line):
                name = line.split("'")[1] if "'" in line else line
                usage = "; ".join(x.split(":", 1)[-1].strip() for x in lines[n + 1:n + 4]
                                  if "registers" in x or "spill" in x)
                print(f"[k1-bwd-parts] ptxas {name}: {usage}")
        lib = k1._library()
        for cp in (32, 64):
            print(f"[k1-bwd-parts] bwd_h4_rows at Cp={cp}: "
                  f"{lib.ipa_attention_bwd_h4_smem_bytes(cp)} bytes of shared memory, "
                  f"{lib.ipa_attention_bwd_h4_blocks_per_sm(cp)} blocks (8 warps each) an SM "
                  "resident")
    kw = dict(scalar_w=1.0 / 48**0.5, pair_w=1.0 / 3**0.5)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for design, (B, Lq, Lk, dname, H, cp, masked, *width) in ((d, s) for d in designs
                                                              for s in SHAPES[d]):
        dk = width[0] if width else 16
        args, cts = _inputs(B, Lq, Lk, getattr(torch, dname), H, cp, masked, gen, design == "h4",
                            dk)

        def call():
            return k1._launch_backward(args, cts, kw["scalar_w"], kw["pair_w"], counted=False)

        call()
        torch.cuda.synchronize()
        times = []
        for _ in range(20):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        prof = profile_device(call)
        route = k1.backward_route(args[0].dtype, H, dk, cp, design != "h4")
        print(f"[k1-bwd-parts] H={H}x{dk} Cp={cp} B={B} Lq={Lq} Lk={Lk} masked={masked} {dname} "
              f"route {route}: call "
              f"{statistics.median(times):.4f} ms "
              f"by events (median of 20); device kernel time {prof.total_ms:.4f} ms in "
              f"{prof.count} kernels:")
        for row in prof.rows:
            print(f"[k1-bwd-parts]   {row.total_ms:8.4f} ms x{row.count} {row.name[:100]}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
