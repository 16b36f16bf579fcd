#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``se3diff_torch``) on one card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one NVIDIA H100 (Hopper,
sm_90a), nvcc and a CUDA build of PyTorch. Phases, each fatal on error:

1. device and build: the card's name and power limit; build the IPA
   attention kernel from ``se3diff_torch/csrc`` with nvcc (time, ptxas report);
2. the kernel against its plain PyTorch version on the card, at the main
   path's shape (B=40, L=100, 32 heads of 16, Cp=256, streamed pair bias) in
   bf16 and f32 and at a ragged L=77 with masked columns; error beside its
   tolerance, kernel / plain / bound times;
3. one full-width score evaluation (bioemu-v1.0 widths, weights from a
   seed) through the kernel, through the plain core on the card, and on the
   CPU;
4. the main path: ``se3diff_torch.sampling.pipeline.sample`` for
   GYDPETGTWG x10 (L=100), bf16, dpm_2m 30 steps, batch 40, 80 samples,
   dummy embeddings; output files and finite coordinates are checked, the
   kernel's launch count must be 8 layers x 30 evaluations x 2 batches, and
   the device physicality filter must agree with the numpy filter;
5. a profile of one main-path batch: device time by kernel;
6. the ``kernels`` line, the card line, and the final ``ok`` line.

Exits nonzero, printing no result, without CUDA or outside a checkout.
Outputs go to ``.work/chip_smoke/`` inside the checkout (listed in .gitignore).
"""

from __future__ import annotations

import json
import logging
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT = REPO / ".work" / "chip_smoke"
H100_BYTES_PER_S = 3.35e12                        # HBM3, H100 SXM data sheet
H100_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / f32 CUDA-core peaks
DEVICE = "cuda"
MAIN_SEQ = "GYDPETGTWG" * 10
MAIN_BATCH, MAIN_SAMPLES, MAIN_STEPS, N_LAYERS = 40, 80, 30, 8
K1_CASES = [(40, 100, "bfloat16", 0), (40, 100, "float32", 0),
            (40, 77, "bfloat16", 9), (40, 77, "float32", 9)]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}         # x max(1, max|plain|)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_inputs(B, L, dtype, gen, masked_cols=0):
    """Kernel-layout operands at the model's scales (q/k/v ~ 1, planes ~ nm)."""
    import torch

    H, dk, cp, dev = 32, 16, 256, DEVICE
    g = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale
    bias = torch.zeros(B, L, device=dev)
    if masked_cols:
        bias[:, -masked_cols:] = -1e30
    return (
        g(B, H, L, dk).to(dtype), g(B, H, L, dk).to(dtype), g(B, H, L, dk).to(dtype),
        g(B, 3, H * 4, L, scale=0.3), g(B, 3, H * 4, L, scale=0.3), g(B, H, L, 24, scale=2.0),
        g(B, L, L, cp, scale=0.5).to(dtype), g(H, cp, dk, scale=0.06).to(dtype), bias,
        g(B, H, L, L).to(dtype),
    )


def k1_bound(args, outs, dtype_name):
    """Least time for one call: bytes (each input read once, each output
    written once) over HBM rate vs operations over the type's peak."""
    q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa = args
    B, H, Lq, dk = q_s.shape
    Lk, cp = k_s.shape[2], x2d.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs))
    # Per (b, h, i, j): scalar logit 2dk, 4 point distances ~11 each, softmax
    # and bias ~8, v_s 2dk, v_p 48, x2d 2Cp; finalize 2 Cp dk per (b, h, i).
    ops = B * H * Lq * Lk * (4 * dk + 44 + 8 + 48 + 2 * cp) + 2 * B * H * Lq * cp * dk
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_OPS_PER_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def max_err(got, want):
    err = max((a.float() - b.float().to(a.device)).abs().max().item() for a, b in zip(got, want))
    scale = max(1.0, max(b.float().abs().max().item() for b in want))
    return err, scale


def phase_build():
    from se3diff_torch.ops import ipa_attention as k1

    t0 = time.perf_counter()
    path, report = k1.build_library()
    log(f"[build] {path.relative_to(REPO)} built in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] ptxas: {line.strip()}")
    return k1


def phase_kernel(k1):
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    results = {}
    kw = dict(scalar_w=1.0 / 48**0.5, pair_w=1.0 / 3**0.5)
    for B, L, dname, masked in K1_CASES:
        args = k1_inputs(B, L, getattr(torch, dname), gen, masked)
        got = k1.ipa_attention(*args, **kw)
        torch.cuda.synchronize()
        want = k1.ipa_attention_plain(*args, **kw)
        err, scale = max_err(got, want)
        tol = TOL[dname] * scale
        ms = cuda_time_ms(lambda: k1.ipa_attention(*args, **kw), reps=20)
        plain_ms = cuda_time_ms(lambda: k1.ipa_attention_plain(*args, **kw), reps=5)
        bound_ms, bound_by, nbytes, ops = k1_bound(args, got, dname)
        log(
            f"[k1] B={B} L={L} {dname} masked_cols={masked}: max_abs_err={err:.3e} "
            f"(tol {tol:.3e}) ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
            f"({bound_by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP) "
            "library_ms=null (no single PyTorch call computes this function)"
        )
        if not err <= tol:
            raise AssertionError(f"kernel disagrees with its plain version: {err} > {tol}")
        results[(B, L, dname)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by
        )
        del args, got, want
    return results


def phase_score_eval():
    import torch
    from unittest import mock

    from se3diff_torch.models import dig
    from se3diff_torch.ops.ipa_attention import ipa_attention_plain
    from se3diff_torch.sampling.bundle import BIOEMU_V1_MODEL

    from se3diff_torch.ops.so3 import rotquat_to_rotmat

    B, L = 4, len(MAIN_SEQ)
    gen = torch.Generator().manual_seed(1)
    model = dig.init_weights(dig.DiGConditionalScoreModel(**BIOEMU_V1_MODEL), gen).eval()
    quat = torch.randn(B, L, 4, generator=gen)
    inputs = (
        torch.randn(B, L, 3, generator=gen),
        rotquat_to_rotmat(quat / quat.norm(dim=-1, keepdim=True)),
        torch.rand(B, generator=gen),
        torch.randn(B, L, 384, generator=gen),
        torch.randn(B, L, L, 128, generator=gen) * 0.5,
    )
    with torch.inference_mode():
        ref_cpu = model(*inputs)
        model.to(DEVICE)
        cu = [x.to(DEVICE) for x in inputs]
        got = model(*cu)
        torch.cuda.synchronize()
        with mock.patch.object(dig, "ipa_attention", ipa_attention_plain):
            plain = model(*cu)
        for name, want, tol in (("plain core on the card", plain, 1e-3), ("CPU", ref_cpu, 1e-3)):
            err, scale = max_err(got, want)
            log(f"[score] f32 full width B={B} L={L}: kernel vs {name}: max_abs_err={err:.3e} "
                f"(tol {tol * scale:.3e})")
            if not err <= tol * scale:
                raise AssertionError(f"score evaluation disagrees with the {name}")
        model16 = dig.DiGConditionalScoreModel(**BIOEMU_V1_MODEL, dtype=torch.bfloat16)
        model16.to(DEVICE).eval()
        model16.load_state_dict(model.state_dict())
        got16 = model16(*cu)
        with mock.patch.object(dig, "ipa_attention", ipa_attention_plain):
            plain16 = model16(*cu)
        err, scale = max_err(got16, plain16)
        log(f"[score] bf16 full width: kernel vs plain core: max_abs_err={err:.3e} "
            f"(tol {5e-2 * scale:.3e}); vs f32 kernel: {max_err(got16, got)[0]:.3e}")
        if not err <= 5e-2 * scale:
            raise AssertionError("bf16 score evaluation disagrees with the plain core")
        for t in (*got, *got16):
            if not torch.isfinite(t).all():
                raise AssertionError("non-finite score")


class _Breakdown(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        if "wall breakdown" in record.getMessage():
            self.lines.append(record.getMessage())


def phase_main_path(k1, card):
    import numpy as np
    import torch

    from se3diff_torch.sampling.bundle import BIOEMU_V1_SO3, random_bundle
    from se3diff_torch.sampling.pipeline import sample
    from se3diff_torch.struct.atoms import atom37_from_frames, atom37_mask
    from se3diff_torch.struct.physics import filter_unphysical_masks, filter_unphysical_masks_device
    from se3diff_torch.struct.residues import sequence_to_aatype

    t0 = time.perf_counter()
    bundle = random_bundle(
        denoiser="dpm_2m", dtype=torch.bfloat16, device=DEVICE, seed=0,
        so3_kwargs=dict(BIOEMU_V1_SO3, cache_dir=str(OUT / "so3_cache")),
    )
    log(f"[main] bundle (bioemu-v1.0 widths, seed 0, production SO(3) tables) "
        f"in {time.perf_counter() - t0:.2f} s")
    # Fresh output directories: sample() resumes from batch files it finds.
    for d in ("warmup", "main"):
        shutil.rmtree(OUT / d, ignore_errors=True)
    handler = _Breakdown()
    plog = logging.getLogger("se3diff_torch.sampling.pipeline")
    plog.addHandler(handler)
    plog.setLevel(logging.DEBUG)
    kw = dict(
        bundle=bundle, batch_size=MAIN_BATCH, embeds_backend="dummy",
        cache_embeds_dir=str(OUT / "embeds"), filter_samples=False,
    )
    # Warm-up: one batch into its own directory (library loads, allocator).
    t0 = time.perf_counter()
    sample(MAIN_SEQ, MAIN_BATCH, str(OUT / "warmup"), **kw)
    log(f"[main] warm-up batch: {time.perf_counter() - t0:.2f} s")

    out = OUT / "main"
    k1.launches = 0
    t0 = time.perf_counter()
    sample(MAIN_SEQ, MAIN_SAMPLES, str(out), **kw)
    wall = time.perf_counter() - t0
    launches = k1.launches

    expect = N_LAYERS * MAIN_STEPS * (MAIN_SAMPLES // MAIN_BATCH)
    log(f"[main] L={len(MAIN_SEQ)} bf16 dpm_2m-{MAIN_STEPS} batch {MAIN_BATCH}: {MAIN_SAMPLES} samples "
        f"in {wall:.3f} s = {MAIN_SAMPLES / wall * 3600:.1f} structures/hr; "
        f"{handler.lines[-1]}; ipa_attention launches {launches} (expected {expect}); {card}")
    if launches != expect:
        raise AssertionError(f"ipa_attention launched {launches} times, expected {expect}")
    if not (out / "topology.pdb").exists():
        raise AssertionError("topology.pdb missing")
    if not ((out / "samples.xtc").exists() or (out / "samples.pdb").exists()):
        raise AssertionError("no trajectory written")
    aatype = sequence_to_aatype(MAIN_SEQ)
    mask = atom37_mask(aatype)
    kept = 0
    for f in sorted(out.glob("batch_*.npz")):
        with np.load(f) as d:
            pos, rot = d["pos"], d["node_orientations"]
        if pos.shape != (MAIN_BATCH, len(MAIN_SEQ), 3) or not (np.isfinite(pos).all() and np.isfinite(rot).all()):
            raise AssertionError(f"{f.name}: bad shape {pos.shape} or non-finite coordinates")
        atom37, _ = atom37_from_frames(
            torch.from_numpy(pos).to(DEVICE), torch.from_numpy(rot).to(DEVICE), aatype
        )
        keep = filter_unphysical_masks_device(atom37, mask).cpu().numpy()
        ok = filter_unphysical_masks(atom37.cpu().numpy(), mask)
        if not np.array_equal(keep, ok[0] & ok[1] & ok[2]):
            raise AssertionError("device physicality filter disagrees with the numpy filter")
        kept += int(keep.sum())
    log(f"[main] outputs ok: finite coordinates; physicality filter on the card agrees with "
        f"numpy ({kept}/{MAIN_SAMPLES} frames physical with random weights)")
    return bundle, launches, wall


def phase_profile(bundle):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from se3diff_torch.sampling.embeds import get_embeds, load_embeds
    from se3diff_torch.sampling.pipeline import stage_conditioning

    single, pair = load_embeds(*get_embeds(MAIN_SEQ, str(OUT / "embeds"), backend="dummy"))
    s, p, m, _ = stage_conditioning(single, pair, bundle.device)
    run = bundle.sampler(MAIN_BATCH, len(MAIN_SEQ))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(torch.Generator(device=DEVICE).manual_seed(7), s, p, m)
    torch.cuda.synchronize()
    batch_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(torch.Generator(device=DEVICE).manual_seed(7), s, p, m)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernels only: CPU-side aten ops, and the device-timeline annotations
    # that span each op's kernels, carry those kernels' time as well.
    dev = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
         and e.self_device_time_total > 0),
        key=lambda x: -x[1],
    )
    total_ms = sum(t for _, t, _ in dev)
    log(f"[profile] one batch (B={MAIN_BATCH}, dpm_2m-{MAIN_STEPS}) under the profiler: wall "
        f"{wall_ms:.1f} ms, device kernel time {total_ms:.1f} ms; unprofiled batch wall "
        f"{batch_wall_ms:.1f} ms, so the device is busy {100 * total_ms / batch_wall_ms:.1f}% "
        f"of it")
    for key, t, n in dev[:12]:
        log(f"[profile]   {t:9.2f} ms {100 * t / total_ms:5.1f}%  x{n:<5d} {key[:90]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (REPO / "se3diff_torch" / "csrc" / "ipa_attention.cu").is_file():
        print("chip_smoke: run from a checkout of the repository (se3diff_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    OUT.mkdir(parents=True, exist_ok=True)
    # Plain-version references run in full f32 (no TF32) on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {card}; torch {torch.__version__} CUDA {torch.version.cuda}")

    t_all = time.perf_counter()
    k1 = phase_build()
    k1_results = phase_kernel(k1)
    phase_score_eval()
    bundle, launches, _ = phase_main_path(k1, card)
    phase_profile(bundle)

    main_case = k1_results[K1_CASES[0][:3]]
    kernels = {"kernels": [{
        "name": "ipa_attention",
        "route": "cuda",
        "source": "se3diff_torch/csrc/ipa_attention.cu",
        "replaces": "se3diff_tpu/ops/pallas_ipa.py:322",
        "launches": launches,
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
        "verdict": "pass",
    }]}
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
