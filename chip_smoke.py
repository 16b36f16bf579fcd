#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``se3diff_torch``) on one card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one NVIDIA H100 (Hopper,
sm_90a), nvcc and a CUDA build of PyTorch. Phases, each fatal on error:

1. device and build: the card's name and power limit; build the IPA
   attention kernels from ``se3diff_torch/csrc`` with nvcc, one process a
   source (time, ptxas report: registers, spills and shared memory of the
   "tc", "tc_f32", "tc_pb", "tc_pb_f32", "h4", "tc16", "tc16_f32", "tc8" and "tc8_f32" kernels,
   the 16- and 8-head designs' resident blocks an SM, the backward kernels'
   value-term, row and column
   kernels, "bwd_tc" and "bwd_tc_f32", "bwd_tc16" and "bwd_tc16_f32",
   "bwd_tc8" and "bwd_tc8_f32" (with the row kernel's resident blocks an
   SM, at 8 heads the column kernel's too), and "bwd_h4"'s two row
   instantiations, its kernel of the logits' CUDA-core terms, column kernel
   and weight-gradient reduction, with its row kernel's shared memory and
   resident blocks and warps an SM);
2. the kernel against its plain PyTorch version on the card, at the main
   path's shape (B=40, L=100, 32 heads of 16, Cp=256, streamed pair bias) in
   bf16 and f32, at a ragged L=77 with masked columns, and at the PPFT score
   model's B=256, L=56 and the train forward's B=16, L=100, each in bf16 and
   f32; error beside its tolerance, kernel / plain / bound times. Every case
   takes a tensor-core design (route "tc" in bf16, "tc_f32" in f32); beside
   it the CUDA-core design on the same inputs, timed in turns with it
   (``prev_ms``, its error against the new one), and ptxas's registers and
   spills for the route's kernel (and the f32 design's shared memory);
3. one full-width score evaluation (bioemu-v1.0 widths, weights from a
   seed) through the kernel, through the plain core on the card, and on the
   CPU;
4. the main path: ``se3diff_torch.sampling.pipeline.sample`` for
   GYDPETGTWG x10 (L=100), bf16, dpm_2m 30 steps, batch 40, 80 samples,
   dummy embeddings; output files and finite coordinates are checked, the
   kernel's launch count must be 8 layers x 30 evaluations x 2 batches, all
   on the "tc" route, and
   the device physicality filter must agree with the numpy filter; then one
   batch of the same path in f32, the sample CLI's default dtype: 240
   launches, all on "tc_f32", finite coordinates, its wall beside the bf16
   run's;
5. a profile of one main-path batch: device time by kernel;
6. K1's gradient on the card: the autograd Function (kernel forward; the
   backward kernel, "bwd_tc" in bf16 and "bwd_tc_f32" in f32, at 32 heads)
   against autograd through the plain version (in f64: in f32 its point
   gradients lose up to some 1e-4 to cancellation) at B=16, L=100 (bf16, f32),
   L=77 with 9 masked columns, B=4, L=200, an SP slab (B=4, rows 0-150 of
   L=300, f32 and bf16) and the learning run's B=32, L=56 (bf16), and at a
   tensor-parallel rank's 16 heads B=40, L=77 with 9 masked columns (bf16
   on "bwd_tc16", f32 on "bwd_tc16_f32") and at a rank's 8 heads the same
   (bf16 on "bwd_tc8", f32 on "bwd_tc8_f32"); each
   gradient's error beside its tolerance; autograd's backward on the route
   of its widths; the kernel's second call equal to its first bit for bit;
   the kernel timed in turns with the PyTorch backward
   (``ipa_attention_backward``), both beside the bound of the kernel's
   design (its bytes and its operations on the units that run them), with their device kernel time and kernel count; forward ms beside
   its bound, peak memory beside the plain autograd's;
7. one full-width DSM loss and gradient (bioemu-v1.0 widths, seed-0
   weights, f32) on the card through the kernel and on the CPU through the
   plain version, on the same injected noise; every parameter must get a
   nonzero gradient on the card;
8. the training path: ``python -m se3diff_torch.train``'s ``main`` on the
   repository's two test ensembles (one L=64 bucket), full width, bf16,
   batch 16, 30 steps with checkpoints every 10; then 20 steps, interrupted,
   and a resume to 30, which must give the same weights bit for bit; K1
   launches (all "tc") and K1 backward passes 8 per step (all on the backward
   kernel "bwd_tc"); the export loads through ``load_bundle`` and one
   score evaluation runs from it;
9. train-step throughput at ``bench.py --train``'s shape (L=100, B=16, bf16):
   ``dsm_train_examples_per_hour_L100_B16`` (8 backward passes a step on
   "bwd_tc"), the forward / backward / optimizer split and a profile of one
   step, K1's backward labelled where autograd dispatches it; then the same
   in f32, the train CLI's default dtype (every backward on "bwd_tc_f32");
10. sequence- and data-parallel sampling (``se3diff_torch.parallel``):
   (a) ``sp_ipa_attention``'s row-slab launches, concatenated, against
   ``ipa_attention_plain`` over all rows at B=4, L=300 on 2 and 4 slabs and
   L=301 with 9 masked columns (ragged slabs), bf16 and f32; ms per slab
   launch beside its bound, the plain slab's time and the full-rows launch;
   then 2 gloo ranks spawned on the one card (NCCL refuses two ranks on one
   device) run, in one group, (b) one full-width score evaluation at L=300,
   B=4, f32 and bf16, against the same evaluation in this process; (c) the
   SP sampling path, ``sampling.pipeline.sample`` through an SP bundle for
   GYDPETGTWG x30 (L=300), bf16, dpm_2m 30 steps, batch 4, 8 samples:
   rank 0 writes finite outputs, each rank launches K1 8 x 30 x 2 times
   through ``sp_ipa_attention``, all "tc"; wall, structures/hr and peak memory per
   rank beside the same run in this process; (d) DP sampling at L=100,
   B=8, f32, dpm_2m 30 steps from t=0.5, against this process's batch of
   the same seed. The f32 score and DP launches all take "tc_f32". Two ranks on one card show correctness and per-rank
   memory, not multi-GPU speed;
11. ``[k1-inkernel]``: K1 with the pair bias computed in the kernel
   (``w_pb``, has_pa=False) at 32 heads on the "tc_pb" (bf16) and
   "tc_pb_f32" (f32) designs, their counts zeroed before and each case one
   counted launch: B=40 L=100 Cp=256, L=57 with 5 masked columns, Cp=96,
   and the SP path's B=4 L=300 as 2 row slabs, each against the plain
   version and the CUDA-core design (``TOL``), timed in turns with the
   CUDA-core design and the two-step (pa by ``torch.matmul``, then the
   streamed design), beside its bytes bound and its operations on the
   design's units and all in f32, with the card's name and power limit;
   then against the plain version at the PPFT control net's width
   (B=256, L=56, 4 heads, Cp=32, f32) and ragged and masked at L=57; the
   streamed variant at 4 heads, and at 8 and 16 heads (bf16 and f32);
   in-kernel row slabs at 4 heads; every 4-head in-kernel f32 case and
   slab takes the "h4" design, timed in turns with the CUDA-core design
   ("simt", ``prev_ms``) on the same inputs, with its error against it; the
   Function's gradients with ``w_pb`` against autograd of the plain version
   (at 4 heads in f32 on the backward kernel "bwd_h4": B=256 and B=64 at
   L=56, L=57 with 5 masked columns, Cp=64, B=64 L=100 and a 28-row slab of
   L=56, each against the PyTorch backward, a second call bit for bit,
   timed in turns with it beside its bound and plain autograd's time, and
   peak memory; at B=256 L=56 the kernel's no more than the PyTorch
   backward's);
   the streamed 16-head cases (B=40 L=77 masked, Cp=96, and B=2 with 5 rows
   of 70 columns, a partial last key tile) take "tc16" in bf16 and
   "tc16_f32" in f32, the streamed 8-head ones (B=40 L=100, B=40 L=77
   masked, Cp=96, 5 rows of 70 columns) "tc8" and "tc8_f32", each held
   against the plain version and the CUDA-core design at ``TOL`` and timed
   in turns with the latter;
12. ``[ppft]``: ``python -m se3diff_torch.finetune``'s main on the card at
   bioemu-v1.0 widths (score model seed 0, bf16; near-zero 2-layer d64
   control net, f32), 2 training and 1 validation GRB2-SH3 mutants, dummy
   embeddings, heun_finetune cut to batch 64 and 25 steps, 1 epoch: finite
   losses and gradients, moved control-net weights, checkpoints and
   history.json, K1 launches by variant and by route (streamed "tc",
   in-kernel "h4") and backward passes as counted (all the control net's,
   on the backward kernel "bwd_h4", none on "torch");
13. ``[ppft-step]``: one PPFT step at ``bench.py --finetune``'s shape (L=56,
   path batch 256, heun_finetune 100 steps): path generation, replay
   gradient and step seconds, ``finetune_steps_per_hour_L56_B256_heun100``,
   peak memory, K1 launches by variant and by route, and the device's busy
   share from a profile of a step cut to 10 heun steps, with the score
   model's and the control net's K1 time and the control net's backward
   kernels' ("bwd_h4", by name);
14. ``[sample-cli]``: ``python -m se3diff_torch.sample``'s main with
   ``--denoiser heun`` (100 steps, 2 evaluations a step) and ``--denoiser
   euler_maruyama`` (200 steps, 1) for GYDPETGTWG x10 (L=100), one batch of
   40, f32 (the CLI's default), the seed-0 bioemu-v1.0-width checkpoint of
   phase 12, dummy embeddings: files written, finite coordinates, 1,600 K1
   launches a run, all "tc_f32"; wall and structures/hr beside phase 4's f32
   dpm_2m batch, the physicality filter's verdicts printed;
15. ``[ppft-sde-dpm]``: phase 12's CLI run recording with
   ``sde_dpm_solver_finetune`` at its 50 steps (2 evaluations a step), and
   ``[ppft-sde-dpm-step]``: phase 13's step with it (800 streamed K1
   launches on "tc", 400 in-kernel on "h4", 100 K1 backward passes on
   "bwd_h4"; finite
   path, loss and gradients), printed beside phase 13's heun step;
16. ``[toy]``: ``examples/torch_toy_so3.py``'s ``main`` (``examples/toy_so3.py``
   on ``se3diff_torch.toy``) at its full settings on the card: the
   IGSO(3)-mixture SDE's tables, DSM training (1,500 steps at batch 4,096), base sampling (4,096 x 200 EM steps) and
   its mixture weights, PPFT fine-tuning toward h* = (0.4, 0.2, 0.4) (150
   steps, cut to 75 to keep the phase under 90 s; paths of 1,024 x 100)
   and fine-tuned sampling: the loss must fall below 0.85 of its start, the
   base weights lie within 0.05 of (0.3, 0.4, 0.3) and fine-tuning shrink
   their L1 distance to h* (whether it halves it is printed); walls,
   steps/s and peak memory; kernels a step and the device's busy share
   from a profile of 5 more DSM steps and 1 more fine-tuning step;
17. ``[observables]``: ``compute_h_binary``, ``compute_h_raw``,
   ``compute_h_for_grb2_sh3_raw`` and ``compute_h_for_psd95_pdz3`` on the card
   against the CPU on the same values (256 noisy copies of each reference
   and phase 13's last positions): FNC within 1e-5, RMSD within 1e-4 nm
   (2e-6 of the largest centred coordinate where that is more),
   binary outputs equal off the thresholds; each reference scores folded;
   ms per call; a ModelCIF of one phase-4 structure written and read back
   within 1e-3 A. Neither phase launches K1;
18. ``[ppft-learn]``: the PPFT learning run's two scripts in this process at
   full width, cut in length: ``scripts/torch_pretrain_sh3_prior.py``
   (200 DSM steps at batch 32 on GRB2-SH3 mutant ensembles around the SH3
   reference, bf16; every loss finite, 8 K1 forwards on "tc" and 8 backward
   passes a step; ``params.npz`` reloads into a fresh model that scores a
   fixed batch bit for bit as the trained one; 64 sampled WT structures,
   dpm_solver-30, h finite within [0, 1]), then
   ``scripts/torch_ppft_trainer_run.py`` on that prior (1 epoch, 2 training
   and 1 validation mutants, path batch 256, EM-200): validation at epochs 0
   and 1 finite, the epoch-0 path KL under 1e-6, a positive training path
   KL, ``finetune_model.npz`` equal to the best epoch's checkpoint, K1
   launches streamed on "tc" and in-kernel on "h4" at the recorder's counts,
   every backward pass on "bwd_h4";
   the DSM step ms, the update wall and the phase wall; K1 timed at the DSM
   step's shape (B=32, L=56, bf16; its backward there is phase 6's);
19. ``[mesh-train]``: DP+TP DSM training (``python -m se3diff_torch.train
   --mesh``) in one spawn of 2 gloo ranks sharing the card (NCCL refuses two
   ranks on one device; the NCCL branch, one card a rank, is not run here):
   (a) one f32 step at bioemu-v1.0 widths (seed-0 weights), B=16, L=100,
   fixed noise, as ``data=2`` (K1 on "tc_f32", 8 rows a rank, its backward
   on "bwd_tc_f32") and as ``model=2`` (K1 on "tc16_f32" at 16 heads, its
   backward on "bwd_tc16_f32"), each against this process's
   one-device step on the whole batch: the loss within 1e-5 relative, the
   clipped gradients of ``model=2`` within 1e-4 of each one's largest
   entry; ``data=2`` equals, bit for bit, this process's step with the
   gradient accumulated over the ranks' two halves, whose own gap to the
   whole batch's gradient (1.8e-3 on the card) is held at 1e-2; the
   updated weights within 1e-5 of the largest weight wherever the
   gradient's sign is beyond the step's gradient limit; the two ranks' gathered weights and gradients equal; 8 K1
   forwards and 8 backward passes a step on each rank; the ms a step and
   the wall and count of its all-reduces; (b) the train CLI's rank function as ``--mesh model=2`` at
   bf16 on the two test ensembles (one L=64 bucket), batch 16: 10 steps
   with checkpoints every 5, then 5 steps, interrupted, and a resume to 10,
   which must equal the uninterrupted weights bit for bit; 80 "tc16"
   launches and 80 backward passes ("bwd_tc16") a rank; the export loads through
   ``load_bundle`` and one score evaluation runs from it. K1 at 16 heads
   ("tc16_f32" at the f32 step's shape, "tc16" at the CLI's) is held
   against its plain version and the CUDA-core design and timed in turns
   with the latter beside its bound, and its gradients against autograd of
   the plain version, the backward kernel ("bwd_tc16_f32", "bwd_tc16")
   against the PyTorch backward and against itself bit for bit, timed in
   turns with it beside its bound, with peak memory, at both shapes. Then
   one spawn of 4 gloo ranks sharing the card at ``model=4`` (8 heads a
   rank): (a) the f32 step as ``model=4`` against this process's whole-batch
   step at ``model=2``'s limits, the four ranks' weights and gradients
   equal, 8 "tc8_f32" forwards and 8 backward passes on "bwd_tc8_f32" a
   rank; (b) the train CLI's rank function as ``--mesh model=4`` at bf16,
   batch 16, 3 steps: finite losses, 24 "tc8" launches and 24 backward
   passes on "bwd_tc8" a rank, none on "simt" or "torch". K1 at 8 heads
   ("tc8_f32" at the f32 step's shape, "tc8" at the CLI's) is held against
   its plain version and the CUDA-core design and timed in turns with the
   latter beside its bound, and its gradients against autograd of the plain
   version, the backward kernel ("bwd_tc8_f32", "bwd_tc8") against the
   PyTorch backward and against itself bit for bit, timed in turns with it
   beside its bound, with peak memory, at both shapes;
20. ``[sp-pp-train]``: (c) K1 at this slice's new shapes against its plain
   version, each timed in turns with the CUDA-core design beside its bound:
   a PP microbatch B=4 L=100 (bf16 "tc", f32 "tc_f32"), a Picard sweep's
   B=30 L=100 f32 and B=200 L=100 bf16 (K1's backward on the SP step's
   150-row slab of L=300 is phase 6's). Then one spawn of 2
   gloo ranks sharing the card, at bioemu-v1.0 widths (seed-0 weights),
   each against this process: (a) one f32 SP DSM step
   (``training/dsm.py::sp_train_step``) at B=4 L=300 (150-row slabs): the
   loss within 1e-5 relative, the clipped gradients within 1e-4 of each
   one's largest entry, equal on both ranks, 8 "tc_f32" launches and 8
   backward passes ("bwd_tc_f32") a rank; (b) PP (``parallel/pipeline.py``) at pipe=2 (4
   layers a stage), B=16 L=100, 4 microbatches: the f32 forward within
   1e-4 of the largest output (16 "tc_f32" launches a rank), one f32 DSM
   step (loss and gradients as (a); 32 launches, the backward's recompute
   included, and 16 backward passes a rank on "bwd_tc_f32"), then 5 bf16
   steps with AdamW (backward passes on "bwd_tc"), each loss within 1e-2
   relative (the largest gap printed);
21. ``[picard]``: ``parallel_picard_em`` at ``bench.py --picard``'s shape
   (bf16, B=1 L=100, em-200, the cache built once at batch 200) at 8, 25
   and 50 sweeps against the sequential ``euler_maruyama``-200: walls, the
   median of 3, and their ratio; 8 "tc" launches a sweep (1,600 at B=1 for
   the sequential run), checked; f32 em-30 with 30 sweeps against the
   sequential run on the same generator (the gaps printed, not held); the
   closed-form model's 8 sweeps against 8 sequential steps on the card,
   held at the CPU test's tolerances (5e-4 nm, 5e-3 rad);
22. ``[bench]``: the benchmarks of ``se3diff_torch.benchmarks``. First K1 at
   the sample CLI's shapes (B=10, L=60 and L=77, f32, "tc_f32") and at the
   training example's (B=8 L=8, 4 heads, "simt"), each held against its
   plain version at ``TOL`` and timed while the host runs nothing else.
   (b) The sample CLI at bioemu-v1.0 widths (seed 0, f32, dpm_2m-30, dummy
   embeddings) writes 10 samples of md_emulation's cath1_1bl0A02 (L=60) and
   of multiconf_ood60's P50405 (L=77), 240 "tc_f32" launches a run; both
   are found by sequence and scored by the benchmark CLI
   (``--skip_filtering``): finite or NaN metrics. (c) One score evaluation
   at B=40 L=100 bf16 under ``utils.profiling``: the table of its kernels
   with their launch sites, K1's "tc" kernel a row of 8. (d)
   ``examples/torch_train_from_scratch.py --steps 500`` on the card (its
   narrowest card width, d64, 4 heads: K1 on "simt"): the samples' mean
   pairwise Ca distance at most halfway from the prior's to the data's.
   (a) Then ``python -m se3diff_torch.benchmarks eval`` on each of the
   seven benchmarks' directories of the reference's fixture
   (``tests/test_data/samples_example``; it holds no multiconf_oodval
   samples, so that run must skip it), filtering on, one child process a
   benchmark on one core each, all at once: exit 0, each benchmark in its
   ``benchmark_metrics.json`` with its output files (``results.h5`` where
   h5py imports), walls; the reference's recorded ood60 values (RMSD
   coverage at the last threshold 0.8157894736842105 within 1e-12,
   E1C7U0's 1-recall within 1% of 6.0333076);
then the ``kernels`` line, the card line, and the final ``ok`` line.

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
H100_TF32_OPS_PER_S = 495e12                      # dense TF32 tensor-core peak
DEVICE = "cuda"
MAIN_SEQ = "GYDPETGTWG" * 10
MAIN_BATCH, MAIN_SAMPLES, MAIN_STEPS, N_LAYERS = 40, 80, 30, 8
K1_CASES = [(40, 100, "bfloat16", 0), (40, 100, "float32", 0),
            (40, 77, "bfloat16", 9), (40, 77, "float32", 9),
            (256, 56, "bfloat16", 0), (256, 56, "float32", 0),
            (16, 100, "bfloat16", 0), (16, 100, "float32", 0)]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}         # x max(1, max|plain|)
K1_KW = dict(scalar_w=1.0 / 48**0.5, pair_w=1.0 / 3**0.5)
TRAIN_BATCH, TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_STOP = 16, 30, 10, 20
# The last case has two row chunks of the backward (L > 128).
K1_GRAD_CASES = [(TRAIN_BATCH, 100, "bfloat16", 0), (TRAIN_BATCH, 100, "float32", 0),
                 (TRAIN_BATCH, 77, "bfloat16", 9), (TRAIN_BATCH, 77, "float32", 9),
                 (4, 200, "bfloat16", 0)]
# Phase 6's further cases, the shapes the training paths give K1's backward
# (B, L, dtype, masked columns, query rows): an SP slab of 150 of L=300 rows
# (phase 20 (a)) and the PPFT learning run's DSM step (phase 18).
K1_GRAD_PATH_CASES = [(4, 300, "float32", 0, 150), (4, 300, "bfloat16", 0, 150),
                      (32, 56, "bfloat16", 0, None)]
# Phase 6 at a tensor-parallel rank's 16 heads (routes "bwd_tc16" and
# "bwd_tc16_f32") and 8 heads (routes "bwd_tc8" and "bwd_tc8_f32"; phase 19
# times the mesh paths' shapes): B=40, L=77 with 9 masked columns (ragged
# row and key tiles), (B, L, dtype, masked columns).
K1_GRAD_TP_CASES = [(40, 77, "bfloat16", 9), (40, 77, "float32", 9)]
# Gradient tolerances x max|reference| of each gradient, the reference being
# autograd through the plain version on the same values (in f64 on a kernel
# route, in f32 on "torch": see _grad_case): f32, sums in another order;
# bf16, the same plus one rounding of the f32 gradient to bf16 (8
# significant bits: at most 2^-8 of the value).
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2.0**-8 + 1e-4}
SP_SEQ = "GYDPETGTWG" * 30                       # L=300
SP_RANKS, SP_BATCH, SP_SAMPLES = 2, 4, 8
# (B, L, dtype, masked columns, slabs); the first is the SP path's shape.
SLAB_CASES = [(4, 300, dt, 0, n) for dt in ("bfloat16", "float32") for n in (2, 4)] + [
    (4, 301, dt, 9, n) for dt in ("bfloat16", "float32") for n in (2, 4)]
DP_L, DP_BATCH, DP_SEED = 100, 8, 5
# DP runs dpm_2m-30 from t=0.5: from the production t=0.99, random weights
# end at positions of some 260 nm (about 1/alpha(0.99) = 64 times the
# prior's), where an absolute tolerance of 2e-4 is a relative one of 1e-6;
# from t=0.5 they stay within a few nm.
DP_DENOISER = {"_target_": "dpm_solver_pp2m", "num_steps": 30, "max_t": 0.5, "min_t": 0.001}
DP_TOL = 2e-4
# K1 with the pair bias computed in the kernel (has_pa=False), and K1 at the
# control net's 4 heads: (B, L, heads, Cp, dtype, masked columns, in-kernel).
# (a) the control net's width at the PPFT path's batch, (b) ragged and
# masked, (c) at the PPFT CLI run's path batch of 64 and at the "h4"
# design's largest Cp, (d) the in-kernel pair bias at 16 and 8 heads (still
# "simt"); then the streamed variant at 4 heads.
INKERNEL_CASES = [(256, 56, 4, 32, "float32", 0, True),
                  (256, 57, 4, 32, "float32", 5, True), (64, 56, 4, 32, "float32", 0, True),
                  *[(40, 100, H, 256, dt, 0, True) for H in (16, 8) for dt in ("bfloat16", "float32")],
                  (256, 56, 4, 64, "float32", 0, True), (256, 56, 4, 32, "float32", 0, False),
                  (256, 57, 4, 32, "float32", 5, False),
                  (40, 100, 8, 256, "bfloat16", 0, False), (40, 100, 8, 256, "float32", 0, False),
                  (40, 77, 8, 256, "bfloat16", 9, False), (40, 77, 8, 256, "float32", 9, False),
                  (40, 77, 16, 256, "bfloat16", 9, False), (40, 77, 16, 256, "float32", 9, False)]
# The in-kernel pair bias at 32 heads (routes "tc_pb" bf16, "tc_pb_f32"
# f32): (B, L, Cp, dtype, masked columns) at full width, L=57 masked (a
# ragged last key tile and row block) and Cp=96; then (B, L, slabs): the SP
# path's shape as row slabs in both dtypes.
PB32_ROUTES = {"bfloat16": "tc_pb", "float32": "tc_pb_f32"}
PB32_CASES = [(40, 100, 256, dt, 0) for dt in PB32_ROUTES] + [
    (40, 57, 256, dt, 5) for dt in PB32_ROUTES] + [(40, 100, 96, dt, 0) for dt in PB32_ROUTES]
PB32_SLAB = (4, 300, 2)
# K1's gradient with the in-kernel pair bias: (B, L, heads, Cp, dtype, masked
# columns, query rows). At 4 heads in f32 the backward takes the kernel
# "bwd_h4": the PPFT step's batch (the first, the kernels line's shape), the
# PPFT CLI's path batch of 64, L=57 masked, the largest Cp, L=100 (two key
# chunks of 64) and a 28-row slab of L=56; at 32 heads (no path) "torch".
INKERNEL_GRAD_CASES = [(256, 56, 4, 32, "float32", 0, 56), (64, 56, 4, 32, "float32", 0, 56),
                       (256, 57, 4, 32, "float32", 5, 57), (256, 56, 4, 64, "float32", 0, 56),
                       (64, 100, 4, 32, "float32", 0, 100), (256, 56, 4, 32, "float32", 0, 28),
                       (16, 100, 32, 256, "bfloat16", 0, 100), (16, 77, 32, 256, "float32", 9, 77)]
# K1 at a tensor-parallel rank's 16 heads with the streamed pair bias: the
# route of each dtype, and (B, Lq, Lk, Cp, dtype, masked columns) of phase
# 11's further cases: Cp=96 (three n-tile pairs a warp), and a partial last
# key tile with rows != columns (B=40 L=77 masked is in INKERNEL_CASES).
H16_ROUTES = {"bfloat16": "tc16", "float32": "tc16_f32"}
K1_H16_CASES = [(16, 100, 100, 96, dt, 0) for dt in H16_ROUTES] + [
    (2, 5, 70, 256, dt, 0) for dt in H16_ROUTES]
# The same at a rank's 8 heads at --mesh model=4 (B=40 L=100 and L=77
# masked are in INKERNEL_CASES), and the design of each head count.
H8_ROUTES = {"bfloat16": "tc8", "float32": "tc8_f32"}
K1_H8_CASES = [(16, 100, 100, 96, dt, 0) for dt in H8_ROUTES] + [
    (2, 5, 70, 256, dt, 0) for dt in H8_ROUTES]
TP_ROUTES = {16: H16_ROUTES, 8: H8_ROUTES}
# PPFT (python -m se3diff_torch.finetune): GRB2-SH3 (L=56) mutants from the
# repository's CSV, bioemu-v1.0's 2-layer d64 control net (bench.py:63-67).
GRB2_CSV = "assets/reference_h/GRB2_SH3_high_confidence.csv"
FT_MODEL = dict(dim_model=64, dim_pair=32, num_layers=2, num_heads=4, dim_hidden=128, dropout=0.1)
FT_LAYERS = FT_MODEL["num_layers"]
# The CLI run is cut to fit the time: path batch 64 (of 256), heun 25 steps
# (of 100), one epoch over 2 training mutants and 1 validation mutant.
PPFT_CLI_BATCH, PPFT_CLI_STEPS = 64, 25
# bench.py --finetune's shape: L=56, path batch 256 (each recorder at its
# registry step count, RECORDERS).
PPFT_BATCH = 256
# Path recorders the PPFT phases drive: (registry step count, as in
# config/denoiser/*_finetune.yaml; score-model and control-net evaluations a step).
RECORDERS = {"heun_finetune": (100, 3), "sde_dpm_solver_finetune": (50, 2)}
# Phase 14: the sample CLI with the stochastic samplers at their registry
# step counts; evaluations per step: heun 2 (churned point and endpoint),
# euler_maruyama 1.
CLI_SAMPLERS = {"heun": (100, 2), "euler_maruyama": (200, 1)}
# Phase 16: examples/toy_so3.py at its full settings. Mixture components at
# I, R_y(pi/2), R_z(pi) (se3diff.ipynb cell 2), fine-tuning target h*.
TOY_MUS = [[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
           [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]],
           [[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0]]]
TOY_SIGMAS, TOY_WEIGHTS, TOY_H_STARS = [0.2, 0.1, 0.3], [0.3, 0.4, 0.3], [0.4, 0.2, 0.4]
TOY_SO3 = dict(num_sigma=100, num_omega=1000, l_max=1000)
TOY_TRAIN_STEPS, TOY_BATCH, TOY_SAMPLE_STEPS, TOY_ASSIGN_L_MAX = 1500, 4096, 200, 200
# Cut: 75 fine-tuning optimizer steps of the example's 150. At 150 the phase
# took 117.9 s on an H100 80GB HBM3 (1.59 steps/s, eager and host-bound)
# against its 90 s limit; nothing else is cut. So the check that fine-tuning
# halves the weights' L1 distance to h* (150 steps: 0.3072 -> 0.0708 there)
# is printed, not asserted; the distance must shrink.
TOY_FT_STEPS_FULL = 150
TOY_FT = dict(num_steps_opt=75, batch_size=1024, num_steps=100, l_max=TOY_ASSIGN_L_MAX)
# Phase 17: the PPFT references and a batch of noisy copies of each.
OBS_REFS = {"grb2_sh3": "assets/structures/2vwf_trimmed_SH3.pdb",
            "psd95_pdz3": "assets/structures/1be9_trimmed.pdb"}
OBS_BATCH = 256
# Phase 18: the PPFT learning run's two scripts at full width, cut in length
# only, to stay under 90 s: pretraining 200 of 3,000 DSM steps at batch 32
# (warm-up 20 of 200, which must be shorter than the run), 64 of 256 frames
# a mutant, the mutants of 4 of 60 covered updates, with the 64-structure
# dpm_solver-30 sample check; fine-tuning 1 of 5 epochs over 2 of 25
# training mutants and 1 of 4 validation mutants, path batch 256, EM-200.
LEARN_SCRIPTS = ("torch_pretrain_sh3_prior", "torch_ppft_trainer_run")
LEARN_PRIOR_ARGV = ["--steps", "200", "--batch", "32", "--frames", "64", "--covered_steps", "4",
                    "--warmup_steps", "20"]
LEARN_PPFT_ARGV = ["--num_epochs", "1", "--train_mutants", "2", "--val_size", "1"]
LEARN_L, LEARN_DSM_BATCH, LEARN_CHECK_BATCH = 56, 32, 64
# (steps, score-model and control-net evaluations a step) of the recorder
# and of the sample check's dpm_solver (a midpoint evaluation a step).
LEARN_RECORDER, LEARN_CHECK = (200, 1), (30, 2)
LEARN_PHASE_LIMIT_S = 90.0
# Phase 19: DP+TP training on 2 gloo ranks sharing the card. (a) one f32
# step at B=16, L=100 as data=2 and as model=2 (K1 at 16 heads a rank), at
# the trainer's default lr. Each step's gradients have their own limit
# against this process's step on the whole batch, as a share of each
# tensor's largest entry. model=2 runs on the whole batch: 1e-4. data=2
# sums two halves of 8, and must equal, bit for bit, this process's step
# with the gradient accumulated over those halves; that accumulation itself
# differs from the whole batch's by up to 1.77e-3 on the card (x1d_proj;
# scripts/torch_dp_grad_gap.py measures where the gap comes from), so
# data=2 against the whole batch is held at 1e-2.
MESH_RANKS, MESH_B, MESH_L, MESH_LR, MESH_TIMED = 2, 16, 100, 1e-4, 3
MESH_LOSS_TOL, MESH_WEIGHT_TOL = 1e-5, 1e-5
# model=4 splits the heads four ways as model=2 splits them two ways, on
# the whole batch: the same limit.
MESH_GRAD_TOL = {"data=2": 1e-2, "model=2": 1e-4, "model=4": 1e-4}
# (b) the train CLI's rank function at model=2, bf16, batch 16.
MESH_STEPS, MESH_CKPT_EVERY, MESH_STOP = 10, 5, 5
# Then one spawn of 4 ranks at model=4 (8 heads a rank): (a) the f32 step,
# (b) the CLI's rank function, bf16, batch 16, a few steps.
MESH4_RANKS, MESH4_CLI_STEPS = 4, 3
# Phase 20: SP and PP training on 2 gloo ranks sharing the card, bioemu-v1.0
# widths, seed-0 weights, at the trainer's default lr. (a) one f32 SP step at
# B=4, L=300 (150-row slabs); (b) PP at pipe=2 (4 layers a stage), B=16,
# L=100, 4 microbatches of 4: one f32 forward and one f32 step, then 5 bf16
# steps with the optimizer, each loss against this process's at 1e-2
# (microbatching changes the bf16 GEMMs' shapes). Loss within 1e-5 relative,
# forward outputs and clipped gradients within 1e-4 of each one's largest
# entry. (c) K1 at the shapes this slice's paths give it.
SPT_B, SPT_L = 4, 300
PP_PIPE, PP_B, PP_L, PP_M = 2, 16, 100, 4
PP_BF16_STEPS, PP_BF16_SEED, PP_BF16_RTOL = 5, 200, 1e-2
SPPP_LOSS_TOL, SPPP_TOL = 1e-5, 1e-4
# (B, L, dtype): a PP microbatch in bf16 and f32, a Picard sweep's batch at
# em-30 (f32) and em-200 (bf16).
NEW_K1_CASES = [(PP_B // PP_M, PP_L, "bfloat16"), (PP_B // PP_M, PP_L, "float32"),
                (30, 100, "float32"), (200, 100, "bfloat16")]
# Phase 21: parallel_picard_em at bench.py --picard's shape (B=1, L=100,
# em-200, bf16; the cache built once at batch steps x B), against the
# sequential euler_maruyama-200; walls the median of 3. Then f32 em-30 with
# 30 sweeps against the sequential run (a reading), and the closed-form
# model's equality of 8 sweeps and 8 steps (a gate, at the CPU test's
# tolerances).
PICARD_L, PICARD_STEPS, PICARD_SWEEPS, PICARD_REPS = 100, 200, (8, 25, 50), 3
PICARD_F32_STEPS = 30
PICARD_POS_ATOL, PICARD_ROT_RAD = 5e-4, 5e-3
# The CPU test's SO(3) SDE for the closed-form model (tests/test_denoise.py).
PICARD_ANALYTIC_SO3 = dict(num_sigma=200, num_omega=1000, l_max=1000, eps_t=0.001)
# Phase 22: the benchmarks. (a) The CLI on the reference's fixture; the
# reference's recorded ood60 values (its tests/test_multiconf_evaluator.py).
# (b) The sample CLI (f32, dpm_2m-30, 10 samples) for two test cases. (c) A
# profile of one score evaluation (B, L) in bf16. (d) The training example.
BENCH_FIXTURE = "tests/test_data/samples_example"
BENCH_OOD60_COVERAGE, BENCH_E1C7U0_RECALL = 0.8157894736842105, 6.0333076
BENCH_FILES = {"folding_free_energies": ["results_systems.csv", "results_metrics.csv", "contact_scores.npz"],
               "md_emulation": ["results_metrics.csv", "results_projections.npz"],
               "multiconf": ["summary.json", "multiconf_results.npz"]}
BENCH_CASES = {"md_emulation": "cath1_1bl0A02", "multiconf_ood60": "P50405"}
BENCH_SAMPLES, BENCH_STEPS, BENCH_PROFILE = 10, 30, (40, 100)
BENCH_TRAIN_STEPS, BENCH_SIMT4_SHAPE = 500, (8, 8, 4, 16)  # (B, L, heads, Cp)
# K1 at the sample CLI's shapes in (b): one batch of 10, L=60 and L=77, f32.
BENCH_K1_CASES = [(BENCH_SAMPLES, 60, "float32"), (BENCH_SAMPLES, 77, "float32")]
BENCH_EVAL_TIMEOUT_S = 600.0
ENSEMBLES = [
    ("tests/test_data/samples_example/md_emulation/cath1_1bl0A02.xtc",
     "tests/test_data/samples_example/md_emulation/cath1_1bl0A02.pdb"),
    ("tests/test_data/samples_example/folding_free_energies/test_1TG0.xtc",
     "tests/test_data/samples_example/folding_free_energies/test_1TG0.pdb"),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events. A
    spin kernel holds the stream while the calls are enqueued, so a call
    shorter than the host's time to launch it is timed back to back on the
    device, not at the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0  # the host's time to enqueue one call
    torch.cuda.synchronize()
    torch.cuda._sleep(int((1.5 * reps * host_s + 1e-3) * 2e9))  # cycles at up to 2 GHz
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_inputs(B, L, dtype, gen, masked_cols=0, H=32, cp=256, in_kernel=False, Lq=None):
    """Kernel-layout operands at the model's scales (q/k/v ~ 1, planes ~ nm)
    for ``L`` key columns and ``Lq`` query rows (``L`` unless given): the
    ten of the streamed pair bias, or with ``in_kernel`` eleven, ``pa`` None
    and ``w_pb [cp, H]`` f32 last."""
    import torch

    dk, dev = 16, DEVICE
    Lq = L if Lq is None else Lq
    g = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale
    bias = torch.zeros(B, L, device=dev)
    if masked_cols:
        bias[:, -masked_cols:] = -1e30
    args = (
        g(B, H, Lq, dk).to(dtype), g(B, H, L, dk).to(dtype), g(B, H, L, dk).to(dtype),
        g(B, 3, H * 4, Lq, scale=0.3), g(B, 3, H * 4, L, scale=0.3), g(B, H, L, 24, scale=2.0),
        g(B, Lq, L, cp, scale=0.5).to(dtype), g(H, cp, dk, scale=0.06 * (256 / cp) ** 0.5).to(dtype),
        bias,
    )
    if in_kernel:
        return (*args, None, g(cp, H, scale=cp**-0.5))
    return (*args, g(B, H, Lq, L).to(dtype))


def k1_bound(args, outs, dtype_name):
    """Least time for one call: bytes (each input read once, each output
    written once) over HBM rate vs operations over the type's peak."""
    q_s, k_s, x2d = args[0], args[1], args[6]
    in_kernel = len(args) == 11 and args[10] is not None
    B, H, Lq, dk = q_s.shape
    Lk, cp = k_s.shape[2], x2d.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs) if t is not None)
    # Per (b, h, i, j): scalar logit 2dk, 4 point distances ~11 each, softmax
    # and bias ~8, v_s 2dk, v_p 48, x2d 2Cp, and 2Cp more for the in-kernel
    # pair bias; finalize 2 Cp dk per (b, h, i).
    ops = (B * H * Lq * Lk * (4 * dk + 44 + 8 + 48 + 2 * cp * (2 if in_kernel else 1))
           + 2 * B * H * Lq * cp * dk)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_OPS_PER_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def k1_pb32_ops_ms(args, dtype_name):
    """The in-kernel 32-head designs' operations as times (ms): on the units
    the design runs them on, and all in f32 on CUDA cores. The design runs
    the x2d aggregate and the pair bias (2 Cp operations each a head, row
    and column) on tensor cores, bf16 operands once ("tc_pb") or three TF32
    terms ("tc_pb_f32"); the finalize's projection (2 Cp dk a head and row)
    in two bf16 terms on tensor cores in bf16, on CUDA cores in f32; the
    rest (``k1_bound``'s per-pair terms) in f32 on CUDA cores."""
    q_s, k_s, x2d = args[0], args[1], args[6]
    B, H, Lq, dk = q_s.shape
    Lk, cp = k_s.shape[2], x2d.shape[-1]
    pairs = B * H * Lq * Lk
    rest, contractions, projection = pairs * (4 * dk + 44 + 8 + 48), pairs * 4 * cp, B * H * Lq * 2 * cp * dk
    f32 = H100_OPS_PER_S["float32"]
    if dtype_name == "bfloat16":
        design = (contractions + 2 * projection) / H100_OPS_PER_S["bfloat16"] + rest / f32
    else:
        design = 3 * contractions / H100_TF32_OPS_PER_S + (projection + rest) / f32
    return design * 1e3, (contractions + projection + rest) / f32 * 1e3


def only_routes(k1, **counts):
    """K1's launches by route as ``counts`` on the routes named and none on
    any other."""
    return {**dict.fromkeys(k1.launches_by_route, 0), **counts}


def only_bwd_routes(k1, **counts):
    """K1's backward passes by backward route as ``counts`` on the routes
    named and none on any other."""
    return {**dict.fromkeys(k1.backward_calls_by_route, 0), **counts}


def max_err(got, want):
    err = max((a.float() - b.float().to(a.device)).abs().max().item() for a, b in zip(got, want))
    scale = max(1.0, max(b.float().abs().max().item() for b in want))
    return err, scale


def ptxas_summary(report: str, kernel: str) -> str:
    """ptxas's spill and register lines for the entry functions whose
    mangled name holds ``kernel``."""
    lines = report.splitlines()
    found = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            found += [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                      if "registers" in x or "spill" in x]
    return "; ".join(found) or "not reported"


def phase_build():
    from se3diff_torch.ops import ipa_attention as k1

    t0 = time.perf_counter()
    path, report = k1.build_library()
    log(f"[build] {path.relative_to(REPO)} built in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] ptxas: {line.strip()}")
    lib = k1._library()
    # The 32-head sources' template instances: the streamed pair bias
    # (ILb0E) and the in-kernel one (ILb1E, routes "tc_pb", "tc_pb_f32").
    ptxas = {"tc": ptxas_summary(report, "ipa_attention_tc_kernelILb0E"),
             "tc_f32": ptxas_summary(report, "ipa_attention_tc_f32_kernelILb0E")
             + f"; dynamic shared memory {lib.ipa_attention_tc_f32_smem_bytes(256)} bytes at Cp=256",
             "tc_pb": ptxas_summary(report, "ipa_attention_tc_kernelILb1E")
             + f"; dynamic shared memory {lib.ipa_attention_tc_pb_smem_bytes(256)} bytes at Cp=256",
             "tc_pb_f32": ptxas_summary(report, "ipa_attention_tc_f32_kernelILb1E")
             + f"; dynamic shared memory {lib.ipa_attention_tc_pb_f32_smem_bytes(256)} bytes at "
             "Cp=256",
             **{r: ptxas_summary(report, f"ipa_attention_{r}_kernel") + "; dynamic shared memory "
                f"{getattr(lib, f'ipa_attention_{r}_smem_bytes')(256)} bytes at Cp=256, "
                f"{getattr(lib, f'ipa_attention_{r}_blocks_per_sm')(256)} blocks an SM resident"
                for r in ("tc16", "tc16_f32", "tc8", "tc8_f32")},
             # Two instantiations: Cp <= 32 (every path) and Cp <= 64.
             "h4": f"Cp <= 32: {ptxas_summary(report, 'ipa_attention_h4_kernelILi32E')}; dynamic "
                   f"shared memory {lib.ipa_attention_h4_smem_bytes(32)} bytes at Cp=32 | Cp <= 64: "
                   f"{ptxas_summary(report, 'ipa_attention_h4_kernelILi64E')}"}
    cols = lib.ipa_attention_bwd_cols_smem_bytes()
    # The 32-, 16- and 8-head backward: the row kernel's resident blocks an
    # SM beside (at 8 heads the column kernel's too, its rows split over
    # warps). The 32- and 16-head routes run the row design bwd_rows<T, H>,
    # the 8-head ones bwd8_rows, each with the value terms' kernel bwd_dv<T>
    # before it.
    for route, rows, heads, t in (("bwd_tc", "bwd_rowsI13__nv_bfloat16Li32E", 32, "13__nv_bfloat16"),
                                  ("bwd_tc_f32", "bwd_rowsIfLi32E", 32, "f"),
                                  ("bwd_tc16", "bwd_rowsI13__nv_bfloat16Li16E", 16,
                                   "13__nv_bfloat16"),
                                  ("bwd_tc16_f32", "bwd_rowsIfLi16E", 16, "f"),
                                  ("bwd_tc8", "bwd8_rowsI13__nv_bfloat16E", 8, "13__nv_bfloat16"),
                                  ("bwd_tc8_f32", "bwd8_rowsIfE", 8, "f")):
        smem = getattr(lib, f"ipa_attention_{route}_smem_bytes")(256)
        blocks = getattr(lib, f"ipa_attention_{route}_blocks_per_sm")(256)
        ptxas[route] = (f"rows: {ptxas_summary(report, rows)}; dynamic shared "
                        f"memory {smem} bytes at Cp=256, {blocks} blocks an SM resident | cols: "
                        f"{ptxas_summary(report, f'bwd_colsI{t}Li{heads}E')}; dynamic shared "
                        f"memory {cols} bytes")
        if heads == 8:
            ptxas[route] += (f", {getattr(lib, f'ipa_attention_{route}_cols_blocks_per_sm')()} "
                             "blocks an SM resident")
        ptxas[route] += f" | dv: {ptxas_summary(report, f'bwd_dvI{t}E')}"
    # bwd_h4: two row instantiations (Cp <= 32, every path; Cp <= 64) with
    # their resident blocks (8 warps each) an SM, the kernel of the logits'
    # CUDA-core terms, the column kernel and the reduction of d_w_pv's and
    # d_w_pb's partials.
    h4_rows = " | ".join(
        f"rows Cp <= {cp}: {ptxas_summary(report, f'bwd_h4_rowsILi{cp}E')}; dynamic shared memory "
        f"{lib.ipa_attention_bwd_h4_smem_bytes(cp)} bytes at Cp={cp} (8 rows), "
        f"{lib.ipa_attention_bwd_h4_blocks_per_sm(cp)} blocks an SM resident "
        f"({8 * lib.ipa_attention_bwd_h4_blocks_per_sm(cp)} warps)" for cp in (32, 64))
    ptxas["bwd_h4"] = (
        f"{h4_rows} | pre: {ptxas_summary(report, 'bwd_h4_pre')} | cols: "
        f"{ptxas_summary(report, 'bwd_h4_cols')} | wsum: {ptxas_summary(report, 'bwd_h4_wsum')}")
    for route in ("tc", "tc_f32", "tc_pb", "tc_pb_f32", "h4", "tc16", "tc16_f32", "tc8", "tc8_f32",
                  "bwd_tc", "bwd_tc_f32", "bwd_tc16", "bwd_tc16_f32", "bwd_tc8", "bwd_tc8_f32",
                  "bwd_h4"):
        log(f"[build] ptxas ({route}): {ptxas[route]}")
    return k1, ptxas


def _timed_with_simt(k1, launch, args, kw, route, ptxas):
    """The route's launch ``launch()`` and the CUDA-core design on the same
    inputs: a non-"simt" route is timed in turns with ``simt`` (route,
    simt, route, simt). Returns the result keys and the log's detail."""
    if route == "simt":
        ms = cuda_time_ms(launch, reps=20)
        return dict(ms=ms, design=route), f"route {route} ms={ms:.4f}"

    def prev():
        return k1._launch_design("simt", *args, **kw)

    prev_err = max_err(launch(), prev())[0]
    times = [cuda_time_ms(fn, reps=20) for fn in (launch, prev) * 2]
    ms, prev_ms = (times[0] + times[2]) / 2, (times[1] + times[3]) / 2
    return dict(ms=ms, prev_ms=prev_ms, err_vs_prev=prev_err, design=route), (
        f"route {route} ms={ms:.4f} ({times[0]:.4f}, {times[2]:.4f}) prev_ms={prev_ms:.4f} "
        f"({times[1]:.4f}, {times[3]:.4f}; the CUDA-core design, {prev_ms / ms:.2f}x) "
        f"max_abs_err vs the CUDA-core design {prev_err:.3e}; ptxas ({route}): {ptxas[route]}")


def _forward_case(k1, ptxas, gen, B, L, dname, masked):
    """One streamed 32-head K1 case on the card: the route's launch against
    the plain version (fatal beyond ``TOL``), then its time beside the
    CUDA-core design's, the plain version's and the bound."""
    import torch

    kw = K1_KW
    dtype = getattr(torch, dname)
    args = k1_inputs(B, L, dtype, gen, masked)
    route = k1.kernel_route(dtype, 32, 16, 256, True)
    before = k1.launches_by_route[route]
    got = k1.ipa_attention(*args, **kw)
    torch.cuda.synchronize()
    if k1.launches_by_route[route] != before + 1:
        raise AssertionError(f"ipa_attention did not launch the {route!r} design")
    want = k1.ipa_attention_plain(*args, **kw)
    err, scale = max_err(got, want)
    tol = TOL[dname] * scale
    plain_ms = cuda_time_ms(lambda: k1.ipa_attention_plain(*args, **kw), reps=5)
    bound_ms, bound_by, nbytes, ops = k1_bound(args, got, dname)
    res, detail = _timed_with_simt(k1, lambda: k1.ipa_attention(*args, **kw), args, kw, route,
                                   ptxas)
    res.update(max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    log(
        f"[k1] B={B} L={L} {dname} masked_cols={masked}: max_abs_err={err:.3e} "
        f"(tol {tol:.3e}) {detail} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
        f"({bound_by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP) "
        "library_ms=null (no single PyTorch call computes this function)"
    )
    if not err <= tol:
        raise AssertionError(f"kernel disagrees with its plain version: {err} > {tol}")
    return res


def phase_kernel(k1, ptxas):
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    return {(B, L, dname): _forward_case(k1, ptxas, gen, B, L, dname, masked)
            for B, L, dname, masked in K1_CASES}


def phase_score_eval():
    import torch
    from unittest import mock

    from se3diff_torch.models import dig
    from se3diff_torch.ops import ipa_attention as k1
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
        # The model's attention core (sp_ipa_attention) calls k1.ipa_attention.
        with mock.patch.object(k1, "ipa_attention", k1.ipa_attention_plain):
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
        with mock.patch.object(k1, "ipa_attention", k1.ipa_attention_plain):
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
    _reset_k1(k1)
    t0 = time.perf_counter()
    sample(MAIN_SEQ, MAIN_SAMPLES, str(out), **kw)
    wall = time.perf_counter() - t0
    launches, routes = k1.launches, dict(k1.launches_by_route)

    expect = N_LAYERS * MAIN_STEPS * (MAIN_SAMPLES // MAIN_BATCH)
    log(f"[main] L={len(MAIN_SEQ)} bf16 dpm_2m-{MAIN_STEPS} batch {MAIN_BATCH}: {MAIN_SAMPLES} samples "
        f"in {wall:.3f} s = {MAIN_SAMPLES / wall * 3600:.1f} structures/hr; "
        f"{handler.lines[-1]}; ipa_attention launches {launches} (expected {expect}), by route "
        f"{routes}; {card}")
    if launches != expect or routes != only_routes(k1, tc=expect):
        raise AssertionError(f"ipa_attention launched {launches} times ({routes}), expected "
                             f"{expect}, all on the tensor-core route")
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
    f32_launches, f32_wall = _main_path_f32(k1, card, wall)
    return bundle, launches, f32_launches, f32_wall


def _main_path_f32(k1, card, bf16_wall):
    """One batch of the main path in f32, the sample CLI's default dtype:
    every K1 launch on the "tc_f32" route. Returns its launches and wall."""
    import numpy as np
    import torch

    from se3diff_torch.sampling.bundle import BIOEMU_V1_SO3, random_bundle
    from se3diff_torch.sampling.pipeline import sample

    bundle = random_bundle(
        denoiser="dpm_2m", dtype=torch.float32, device=DEVICE, seed=0,
        so3_kwargs=dict(BIOEMU_V1_SO3, cache_dir=str(OUT / "so3_cache")),
    )
    out = OUT / "main_f32"
    shutil.rmtree(out, ignore_errors=True)
    _reset_k1(k1)
    t0 = time.perf_counter()
    sample(MAIN_SEQ, MAIN_BATCH, str(out), bundle=bundle, batch_size=MAIN_BATCH,
           embeds_backend="dummy", cache_embeds_dir=str(OUT / "embeds"), filter_samples=False)
    wall = time.perf_counter() - t0
    launches, routes = k1.launches, dict(k1.launches_by_route)
    expect = N_LAYERS * MAIN_STEPS
    log(f"[main] L={len(MAIN_SEQ)} f32 dpm_2m-{MAIN_STEPS} one batch of {MAIN_BATCH} (no warm-up "
        f"in f32): {wall:.3f} s = {MAIN_BATCH / wall * 3600:.1f} structures/hr (bf16 run above: "
        f"{MAIN_SAMPLES / bf16_wall * 3600:.1f}); ipa_attention launches {launches} (expected "
        f"{expect}), by route {routes}; {card}")
    if launches != expect or routes != only_routes(k1, tc_f32=expect):
        raise AssertionError(f"f32 sampling launched K1 {launches} times ({routes}), expected "
                             f"{expect}, all on the f32 tensor-core route")
    files = sorted(out.glob("batch_*.npz"))
    if len(files) != 1:
        raise AssertionError(f"f32 sampling wrote {len(files)} batch files, expected 1")
    with np.load(files[0]) as d:
        pos, rot = d["pos"], d["node_orientations"]
    if pos.shape != (MAIN_BATCH, len(MAIN_SEQ), 3) or not (np.isfinite(pos).all() and np.isfinite(rot).all()):
        raise AssertionError(f"f32 sampling: bad shape {pos.shape} or non-finite coordinates")
    log("[main] f32 outputs ok: one batch file, finite coordinates")
    return launches, wall


def phase_profile(bundle):
    import torch

    from se3diff_torch.sampling.embeds import get_embeds, load_embeds
    from se3diff_torch.sampling.pipeline import stage_conditioning
    from se3diff_torch.utils.profiling import profile_device

    single, pair = load_embeds(*get_embeds(MAIN_SEQ, str(OUT / "embeds"), backend="dummy"))
    s, p, m, _ = stage_conditioning(single, pair, bundle.device)
    run = bundle.sampler(MAIN_BATCH, len(MAIN_SEQ))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(torch.Generator(device=DEVICE).manual_seed(7), s, p, m)
    torch.cuda.synchronize()
    batch_wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernels only (profile_device leaves out the CPU-side aten ops and the
    # device-timeline annotations, which carry their kernels' time as well).
    prof = profile_device(lambda: run(torch.Generator(device=DEVICE).manual_seed(7), s, p, m))
    wall_ms, total_ms = prof.wall_ms, prof.total_ms
    dev = [(r.name, r.total_ms, r.count) for r in prof.rows]
    log(f"[profile] one batch (B={MAIN_BATCH}, dpm_2m-{MAIN_STEPS}) under the profiler: wall "
        f"{wall_ms:.1f} ms, device kernel time {total_ms:.1f} ms; unprofiled batch wall "
        f"{batch_wall_ms:.1f} ms, so the device is busy {100 * total_ms / batch_wall_ms:.1f}% "
        f"of it")
    for key, t, n in dev[:12]:
        log(f"[profile]   {t:9.2f} ms {100 * t / total_ms:5.1f}%  x{n:<5d} {key[:90]}")


def kernel_time_ms(fn):
    """Device kernel time (ms) and kernel count of one warm call of ``fn``,
    from the profiler: the gaps in which the device waits for the host's
    launches are left out."""
    import torch

    from se3diff_torch.utils.profiling import profile_device

    fn()
    torch.cuda.synchronize()
    prof = profile_device(fn)
    return prof.total_ms, prof.count


def k1_bwd_bound(args, cts, grads, route="torch"):
    """Least time for one backward call on ``route``: the larger of the bytes
    (inputs and cotangents read once, gradients written once) over the HBM
    rate and the design's operations over the peak of the units that run
    them. On "torch" every operation is f32 on CUDA cores. The kernel
    routes run the x2d contractions (2 Cp operations each per head, row and
    column) on tensor cores, each product as many times as it has terms
    ("bwd_tc", "bwd_tc16", "bwd_tc8": a x2d and g x2d two bf16 terms, a g
    three; "bwd_tc_f32", "bwd_tc16_f32", "bwd_tc8_f32": 3xTF32, three TF32
    terms each; "bwd_h4": the three and the in-kernel pair bias's three,
    its recompute, d_w_pb and its d_x2d term, all 3xTF32), and the
    rest in f32 on CUDA cores; the
    two units' times are added. Returns the bound, what bounds it, the
    bytes, the all-f32 operation count and the design's operations time
    (ms)."""
    q_s, k_s, x2d = args[0], args[1], args[6]
    in_kernel = len(args) == 11 and args[10] is not None
    B, H, Lq, dk = q_s.shape
    Lk, cp = k_s.shape[2], x2d.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *cts, *grads) if t is not None)
    # Per (b, h, i, j): logits 2dk + 4 x (6 + 4) points + 8 softmax/bias;
    # wx2d 2Cp; dphat 2dk + 48 + 2Cp; ds 4; d_qs, d_ks 4dk; distance weights
    # 20; d_qp, d_kp 48; d_x2d 2Cp; d_pa 1; d_vs 2dk, d_vp 48; the in-kernel
    # pair bias adds its recompute, d_w_pb and its d_x2d term, 2Cp each. Per
    # (b, h, i): g_wx2d and d_w_pv, 2 Cp dk each.
    pairs = B * H * Lq * Lk
    ops = pairs * (10 * dk + (12 if in_kernel else 6) * cp + 217) + 4 * B * H * Lq * cp * dk
    f32_ms = lambda n: n / H100_OPS_PER_S["float32"] * 1e3
    if route == "torch":
        ops_ms = f32_ms(ops)
    else:
        terms, rate = ((3 + 3 + 3, H100_TF32_OPS_PER_S) if route.endswith("_f32")
                       else (2 + 2 + 3, H100_OPS_PER_S["bfloat16"]))
        products = 3
        if route == "bwd_h4":
            terms, rate, products = 6 * 3, H100_TF32_OPS_PER_S, 6
        tensor_ops = pairs * 2 * cp * terms
        ops_ms = tensor_ops / rate * 1e3 + f32_ms(ops - pairs * 2 * cp * products)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return (max(t_bytes, ops_ms), ("bytes" if t_bytes >= ops_ms else "operations"), nbytes, ops,
            ops_ms)


def peak_mb(fn):
    """Device memory ``fn()`` allocates at its peak beyond what was live, MB."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def _grad_case(k1, gen, B, L, dname, masked, H=32, Lq=None, cp=256, in_kernel=False,
               tag="k1-grad"):
    """One case of K1's gradient on the card (``H`` heads, pair width
    ``cp``, the pair bias streamed or, with ``in_kernel``, from ``w_pb``;
    ``Lq`` query rows of ``L`` columns: a row slab when fewer): the autograd
    Function against autograd through the plain version (fatal beyond
    ``GRAD_TOL``; in f64 on a kernel route, whose errors against the plain
    version in f32 are printed beside, in f32 on "torch"), its backward on
    ``backward_route``'s route (fatal otherwise). On a kernel route
    ("bwd_tc", "bwd_tc_f32", "bwd_tc16", "bwd_tc16_f32", "bwd_tc8",
    "bwd_tc8_f32", "bwd_h4") the
    kernel's gradients against ``ipa_attention_backward``'s on the same
    values in f64 (fatal beyond twice ``GRAD_TOL``: each is within it of the
    reference; against its f32 gradients printed), its second
    call equal to its first bit for bit (fatal otherwise), and the two timed
    in turns (kernel, PyTorch, kernel, PyTorch), each with its device kernel
    time and count. Then the
    forward's and the route's backward times beside their bounds (the
    backward's: ``k1_bwd_bound`` on its route, with its bytes bound, its
    operations on the route's units and every operation in f32 on CUDA
    cores printed), the plain autograd backward's time and the peak
    memories of the Function's forward and backward, of plain autograd and
    (on a kernel route) of the forward with the PyTorch backward."""
    import torch

    kw = K1_KW
    names = ("q_s", "k_s", "v_s", "q_p", "k_p", "v_p", "x2d", "w_pv", "bias", "pa",
             *(("w_pb",) if in_kernel else ()))
    dtype = getattr(torch, dname)
    Lq = L if Lq is None else Lq
    route = k1.backward_route(dtype, H, 16, cp, not in_kernel)
    args = k1_inputs(B, L, dtype, gen, masked, H=H, cp=cp, in_kernel=in_kernel, Lq=Lq)
    leaves = [None if t is None else t.clone().requires_grad_(n != "bias")
              for n, t in zip(names, args)]
    grad_names = [n for n, t in zip(names, leaves) if t is not None and n != "bias"]
    diff = [leaves[names.index(n)] for n in grad_names]
    cts = tuple(
        torch.randn(shape, generator=gen, device=DEVICE).to(dt)
        for shape, dt in (((B, H, Lq, 16), dtype), ((B, H, Lq, 24), torch.float32),
                          ((B, H, Lq, 16), dtype))
    )
    before, bwd_before = k1.launches, dict(k1.backward_calls_by_route)
    outs = k1.ipa_attention(*leaves, **kw)
    if k1.launches != before + 1 or any(o.grad_fn is None for o in outs):
        raise AssertionError("ipa_attention on CUDA tensors did not launch or lost autograd history")
    got = torch.autograd.grad(outs, diff, cts)
    if k1.backward_calls_by_route != {**bwd_before, route: bwd_before[route] + 1}:
        raise AssertionError(f"autograd's backward left the {route!r} route: "
                             f"{k1.backward_calls_by_route} after {bwd_before}")
    def plain_grads(dtype):
        ref = [None if t is None else t.detach().to(dtype).requires_grad_(n != "bias")
               for n, t in zip(names, args)]
        return torch.autograd.grad(k1.ipa_attention_plain(*ref, **kw),
                                   [ref[names.index(n)] for n in grad_names],
                                   [c.to(dtype) for c in cts])

    def errors(grads, want):
        rel = {n: (g.to(w.dtype) - w).abs().max().item() / w.abs().max().item()
               for n, g, w in zip(grad_names, grads, want)}
        return rel, max((g.to(w.dtype) - w).abs().max().item() for g, w in zip(grads, want))

    # The reference: the plain version's gradients in f32 on route "torch",
    # which forms d2 = q2 + k2 - 2 q.k in f32 as the plain version does; in
    # f64 on the kernel routes, which take point distances from explicit
    # differences. In f32 that form loses up to some 1e-4 of the largest
    # point gradient at close point pairs, which the kernels do not (both
    # printed on the kernel routes).
    ref_dtype, ref_name = ((torch.float32, "f32") if route == "torch"
                           else (torch.float64, "f64"))
    want = plain_grads(ref_dtype)
    torch.cuda.synchronize()
    for name, g, p, w in zip(grad_names, got, diff, want):
        if g.dtype != p.dtype or g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"d_{name}: dtype/shape mismatch or non-finite values")
    rel, abs_err = errors(got, want)  # max |error| / max |reference| of each gradient
    worst = max(rel, key=rel.get)
    if not rel[worst] <= GRAD_TOL[dname]:
        raise AssertionError(f"d_{worst} disagrees with autograd of the plain version in "
                             f"{ref_name}: {rel[worst]:.3e} x max|reference| > "
                             f"{GRAD_TOL[dname]:.3e}")
    rel32 = None if route == "torch" else errors(got, plain_grads(torch.float32))[0]
    del want
    plain_outs = k1.ipa_attention_plain(*leaves, **kw)
    plain_args = [None if t is None else t.detach() for t in leaves]
    sw, pw = kw["scalar_w"], kw["pair_w"]
    with torch.no_grad():
        fwd_ms = cuda_time_ms(lambda: k1.ipa_attention(*plain_args, **kw), reps=20)
        grads = k1.ipa_attention_backward(plain_args, cts, **kw)

        def pytorch_bwd():
            return k1.ipa_attention_backward(plain_args, cts, **kw)

        if route == "torch":
            bwd_ms = torch_ms = cuda_time_ms(pytorch_bwd, reps=10)
            kernel_ms, kernels = torch_kernel_ms, torch_kernels = kernel_time_ms(pytorch_bwd)
            vs_torch, identical, detail = None, None, ""
        else:
            def kernel_bwd():
                return k1._launch_backward(plain_args, cts, sw, pw, counted=False)

            def largest_rel(got, want):
                return max((a.to(b.dtype) - b).abs().max().item() / b.abs().max().item()
                           for a, b in zip(got, want) if a is not None)

            first, second = kernel_bwd(), kernel_bwd()
            identical = all(a is None and b is None or torch.equal(a, b)
                            for a, b in zip(first, second))
            # Against the PyTorch backward on the same values in f64 (its f32
            # point gradients carry the plain version's cancellation), and
            # in f32 (printed).
            torch64 = k1.ipa_attention_backward(
                [None if t is None else t.double() for t in plain_args],
                [c.double() for c in cts], **kw)
            vs_torch, vs_torch32 = largest_rel(first, torch64), largest_rel(first, grads)
            del first, second, torch64
            times = [cuda_time_ms(fn, reps=10) for fn in (kernel_bwd, pytorch_bwd) * 2]
            bwd_ms, torch_ms = (times[0] + times[2]) / 2, (times[1] + times[3]) / 2
            kernel_ms, kernels = kernel_time_ms(kernel_bwd)
            if kernels == 0:  # the profiler saw none of the library's kernels: not measured
                kernel_ms = None
            torch_kernel_ms, torch_kernels = kernel_time_ms(pytorch_bwd)
            detail = (f"; the PyTorch backward (ipa_attention_backward) ms={torch_ms:.4f} "
                      f"({times[1]:.4f}, {times[3]:.4f}; {torch_ms / bwd_ms:.2f}x the kernel's), "
                      f"device kernel time {torch_kernel_ms:.4f} ms in {torch_kernels} kernels; "
                      f"kernel against it in f64: largest gradient error {vs_torch:.2e} x its "
                      f"max (tol {2 * GRAD_TOL[dname]:.2e}; in f32 {vs_torch32:.2e}); second "
                      "kernel call "
                      + ("bit for bit equal to the first" if identical else "DIFFERS from the first"))
    plain_bwd_ms = cuda_time_ms(
        lambda: torch.autograd.grad(plain_outs, diff, cts, retain_graph=True), reps=5)
    fwd_bound, fwd_by, _, _ = (
        k1_pb32_bound(plain_args, outs, dname)[:4]
        if k1.kernel_route(getattr(torch, dname), H, 16, cp, not in_kernel) in PB32_ROUTES.values()
        else k1_bound(plain_args, outs, dname))
    bwd_bound, bwd_by, nbytes, ops, design_ms = k1_bwd_bound(plain_args, cts, grads, route)
    bytes_ms, ops_ms = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_OPS_PER_S["float32"] * 1e3
    del plain_outs, outs, got
    mem = peak_mb(lambda: torch.autograd.grad(k1.ipa_attention(*leaves, **kw), diff, cts))
    plain_mem = peak_mb(lambda: torch.autograd.grad(k1.ipa_attention_plain(*leaves, **kw), diff, cts))

    def torch_fwd_bwd():
        with torch.no_grad():
            k1.ipa_attention(*plain_args, **kw)
            return k1.ipa_attention_backward(plain_args, cts, **kw)

    torch_mem = None if route == "torch" else peak_mb(torch_fwd_bwd)
    log(
        f"[{tag}] H={H} Cp={cp} {'w_pb' if in_kernel else 'pa'} B={B} Lq={Lq} L={L} {dname} "
        f"masked_cols={masked} backward route {route}: gradient errors x max|"
        f"{ref_name} reference| "
        + ", ".join(f"d_{n} {v:.2e}" for n, v in rel.items())
        + f" (tol {GRAD_TOL[dname]:.2e}"
        + ("" if rel32 is None else "; against the plain version in f32 "
           + ", ".join(f"d_{n} {v:.2e}" for n, v in rel32.items()))
        + f"); forward ms={fwd_ms:.4f} bound_ms={fwd_bound:.4f} "
        f"({fwd_by}); backward ({route}) ms={bwd_ms:.4f}, device kernel time "
        + ("not measured (the profiler saw no kernel of the call)" if kernel_ms is None
           else f"{kernel_ms:.4f} ms in {kernels} kernels")
        + f"{detail}; backward bound_ms={bwd_bound:.4f} ({bwd_by}; the route's "
        f"operations on their units {design_ms:.4f} ms, bytes {nbytes / 1e6:.1f} MB {bytes_ms:.4f} "
        f"ms; all {ops / 1e9:.2f} GFLOP in f32 on CUDA cores {ops_ms:.4f} ms); plain autograd backward ms={plain_bwd_ms:.4f}; peak memory of forward + backward "
        f"{mem:.1f} MB, plain autograd {plain_mem:.1f} MB"
        + ("" if torch_mem is None else f", forward + the PyTorch backward {torch_mem:.1f} MB")
    )
    if route != "torch" and not (identical and vs_torch <= 2 * GRAD_TOL[dname]):
        raise AssertionError(f"the {route} kernel is not deterministic or disagrees with "
                             f"ipa_attention_backward in f64 ({vs_torch:.3e})")
    return dict(
        max_abs_err=abs_err, max_rel_err=rel[worst], fwd_ms=fwd_ms, ms=bwd_ms, plain_ms=plain_bwd_ms,
        max_rel_err_vs_f32_plain=None if rel32 is None else max(rel32.values()),
        bound_ms=bwd_bound, bound_by=bwd_by, bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
        design_ops_ms=design_ms,
        route=route, torch_ms=torch_ms, kernel_ms=kernel_ms, kernels=kernels,
        torch_kernel_ms=torch_kernel_ms, torch_kernels=torch_kernels, peak_mb=mem,
        plain_peak_mb=plain_mem, torch_peak_mb=torch_mem,
    )


def phase_kernel_grad(k1):
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    cases = [(*c, None) for c in K1_GRAD_CASES] + K1_GRAD_PATH_CASES
    results = {(B, L, dname, Lq or L): _grad_case(k1, gen, B, L, dname, masked, Lq=Lq)
               for B, L, dname, masked, Lq in cases}
    # At 16 and 8 heads, keyed with the heads last.
    for H in (16, 8):
        for B, L, dname, masked in K1_GRAD_TP_CASES:
            results[B, L, dname, L, H] = _grad_case(k1, gen, B, L, dname, masked, H=H)
    return results


def phase_dsm_grad(k1):
    import copy

    import numpy as np
    import torch

    from se3diff_torch.diffusion.denoise import SDEs
    from se3diff_torch.models import dig
    from se3diff_torch.sampling.bundle import BIOEMU_V1_MODEL, BIOEMU_V1_SO3
    from se3diff_torch.sde.so3_sde import DiGSO3SDE
    from se3diff_torch.sde.vpsde import CosineVPSDE
    from se3diff_torch.training.data import MultiEnsembleDataset
    from se3diff_torch.training.dsm import draw_noise, dsm_loss

    mds = MultiEnsembleDataset.from_trajectories(
        [(REPO / a, REPO / b) for a, b in ENSEMBLES], bucket=32, embeds_backend="dummy",
        cache_embeds_dir=str(OUT / "embeds"),
    )
    # cath1: 60 residues in the 64 bucket, so 4 masked rows per frame.
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in mds.batch(0, np.arange(4)).items()}
    so3 = dict(BIOEMU_V1_SO3, cache_dir=str(OUT / "so3_cache"))
    sdes_cpu = SDEs(pos=CosineVPSDE(), node_orientations=DiGSO3SDE(**so3))
    sdes_gpu = SDEs(pos=CosineVPSDE(), node_orientations=DiGSO3SDE(**so3, device=DEVICE))
    model = dig.init_weights(dig.DiGConditionalScoreModel(**BIOEMU_V1_MODEL), torch.Generator().manual_seed(0))
    model.eval()
    model_gpu = copy.deepcopy(model).to(DEVICE)
    noise = draw_noise(torch.Generator().manual_seed(3), batch, sdes_cpu)

    t0 = time.perf_counter()
    loss_cpu = dsm_loss(model, batch, noise, sdes_cpu)
    loss_cpu.backward()
    cpu_s = time.perf_counter() - t0
    k1.launches = 0
    loss_gpu = dsm_loss(model_gpu, {k: v.to(DEVICE) for k, v in batch.items()},
                        type(noise)(*(x.to(DEVICE) for x in noise)), sdes_gpu)
    loss_gpu.backward()
    torch.cuda.synchronize()
    if k1.launches != N_LAYERS:
        raise AssertionError(f"DSM forward launched K1 {k1.launches} times, expected {N_LAYERS}")
    rel_loss = abs(loss_gpu.item() - loss_cpu.item()) / abs(loss_cpu.item())
    errs, zero = [], []
    for (name, p_cpu), p_gpu in zip(model.named_parameters(), model_gpu.parameters()):
        if p_gpu.grad is None or not p_gpu.grad.abs().max().item() > 0:
            zero.append(name)
            continue
        ref = p_cpu.grad.abs().max().item()
        errs.append(((p_gpu.grad.cpu() - p_cpu.grad).abs().max().item() / ref, name))
    errs.sort(reverse=True)
    tol_loss, tol_grad = 1e-5, 1e-3
    log(f"[dsm-grad] full width f32 B=4 L=64 (4 masked rows): loss card {loss_gpu.item():.6f} "
        f"cpu {loss_cpu.item():.6f} rel_err={rel_loss:.2e} (tol {tol_loss:.0e}); "
        f"{len(errs)} parameter tensors with nonzero gradient on the card, {len(zero)} without; "
        f"max relative gradient error {errs[0][0]:.2e} ({errs[0][1]}), median "
        f"{errs[len(errs) // 2][0]:.2e} (tol {tol_grad:.0e} x max|cpu grad| per tensor); "
        f"CPU forward+backward {cpu_s:.1f} s")
    if zero:
        raise AssertionError(f"parameters without gradient on the card: {zero[:5]}")
    if not rel_loss <= tol_loss or not errs[0][0] <= tol_grad:
        raise AssertionError("DSM loss or gradient on the card disagrees with the CPU")


class _Interrupt(Exception):
    pass


def phase_train_path(k1, card):
    """The train CLI end to end; returns the K1 launches and K1 backward
    passes of its uninterrupted 30-step run."""
    import numpy as np
    import torch
    from unittest import mock

    from se3diff_torch import train
    from se3diff_torch.sampling.bundle import load_bundle
    from se3diff_torch.training.data import MultiEnsembleDataset

    def argv(ckpt_dir):
        a = [x for traj, top in ENSEMBLES for x in ("--trajectory", str(REPO / traj),
                                                      "--topology", str(REPO / top))]
        return a + [
            "--bucket", "32", "--batch_size", str(TRAIN_BATCH), "--dtype", "bfloat16",
            "--steps", str(TRAIN_STEPS), "--ckpt_every", str(TRAIN_CKPT_EVERY),
            "--log_every", "10", "--ckpt_dir", str(ckpt_dir), "--embeds_backend", "dummy",
            "--cache_embeds_dir", str(OUT / "embeds"), "--so3_cache_dir", str(OUT / "so3_cache"),
        ]

    full, part = OUT / "train_full", OUT / "train_part"
    for d in (full, part):
        shutil.rmtree(d, ignore_errors=True)

    _reset_k1(k1)
    t0 = time.perf_counter()
    train.main(argv(full))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, backwards, routes = k1.launches, k1.backward_calls, dict(k1.launches_by_route)
    bwd_routes = dict(k1.backward_calls_by_route)
    losses = [json.loads(x)["loss"] for x in (full / "train_log.jsonl").read_text().splitlines()]
    log(f"[train] train CLI, 2 ensembles (L=64 bucket), bioemu-v1.0 widths, bf16, batch "
        f"{TRAIN_BATCH}, {TRAIN_STEPS} steps: {wall:.2f} s with set-up; loss at steps 10/20/30 "
        f"{losses}; K1 launches {launches} (by route {routes}), K1 backward passes {backwards} "
        f"(by route {bwd_routes}; expected {N_LAYERS * TRAIN_STEPS} each, every launch on the "
        f"tensor-core route, every backward on the kernel bwd_tc); {card}")
    if launches != N_LAYERS * TRAIN_STEPS or backwards != N_LAYERS * TRAIN_STEPS:
        raise AssertionError(f"training launched K1 {launches} times and ran {backwards} backwards")
    if routes != only_routes(k1, tc=launches):
        raise AssertionError(f"bf16 training launches left the tensor-core route: {routes}")
    if bwd_routes != only_bwd_routes(k1, bwd_tc=backwards):
        raise AssertionError(f"bf16 training's backward left the kernel route: {bwd_routes}")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite training loss")

    orig = MultiEnsembleDataset.batch_fn

    def interrupted(self, *a, **kw):
        fn = orig(self, *a, **kw)

        def step_fn(step):
            if step == TRAIN_STOP:
                raise _Interrupt
            return fn(step)
        return step_fn

    k1.launches = 0
    with mock.patch.object(MultiEnsembleDataset, "batch_fn", interrupted):
        try:
            train.main(argv(part))
            raise AssertionError("the interrupted run was not interrupted")
        except _Interrupt:
            pass
    first = k1.launches
    k1.launches = 0
    train.main(argv(part))
    second = k1.launches
    with np.load(full / "params.npz") as a, np.load(part / "params.npz") as b:
        diffs = {k: float(np.abs(a[k] - b[k]).max()) for k in a.files if not np.array_equal(a[k], b[k])}
    log(f"[train] interrupted at step {TRAIN_STOP} ({first} K1 launches) and resumed to "
        f"{TRAIN_STEPS} ({second} launches): "
        + ("weights equal the uninterrupted run's bit for bit" if not diffs else
           f"{len(diffs)} tensors differ, largest {max(diffs.values()):.3e} "
           f"({max(diffs, key=diffs.get)})"))
    if (first, second) != (N_LAYERS * TRAIN_STOP, N_LAYERS * (TRAIN_STEPS - TRAIN_STOP)):
        raise AssertionError("K1 launches of the interrupted and resumed runs are wrong")
    if diffs:
        raise AssertionError("the resumed run differs from the uninterrupted one")

    bundle = load_bundle(full / "params.npz", device=DEVICE, dtype=torch.bfloat16,
                         so3_cache_dir=str(OUT / "so3_cache"))
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    L = 64
    with torch.inference_mode():
        pos, rot = bundle.model(
            torch.randn(2, L, 3, generator=gen, device=DEVICE), torch.eye(3, device=DEVICE).expand(2, L, 3, 3),
            torch.full((2,), 0.5, device=DEVICE), torch.randn(2, L, 384, generator=gen, device=DEVICE),
            torch.randn(2, L, L, 128, generator=gen, device=DEVICE) * 0.2,
        )
    if not (pos.shape == rot.shape == (2, L, 3) and torch.isfinite(pos).all() and torch.isfinite(rot).all()):
        raise AssertionError("score evaluation from the exported weights failed")
    log(f"[train] export {full.relative_to(REPO)}/params.npz + config.yaml loads through "
        f"load_bundle; one bf16 score evaluation from it is finite")
    return launches, backwards, bwd_routes


def phase_train_throughput(k1, card):
    import numpy as np
    import torch
    from torch.profiler import record_function
    from unittest import mock

    from se3diff_torch.diffusion.denoise import SDEs
    from se3diff_torch.models import dig
    from se3diff_torch.ops.so3 import rotvec_to_rotmat
    from se3diff_torch.sampling.bundle import BIOEMU_V1_MODEL, BIOEMU_V1_SO3
    from se3diff_torch.sde.so3_sde import DiGSO3SDE
    from se3diff_torch.sde.vpsde import CosineVPSDE
    from se3diff_torch.training.dsm import step_backward, step_loss, step_update, train_step
    from se3diff_torch.training.loop import TrainConfig, make_optimizer, step_generator
    from se3diff_torch.utils.profiling import profile_device

    B, L = TRAIN_BATCH, 100
    rng = np.random.default_rng(0)  # bench.py:219-231
    pos0 = (rng.standard_normal((B, L, 3)) * 0.5).astype(np.float32)
    rot0 = rotvec_to_rotmat(torch.from_numpy((rng.standard_normal((B, L, 3)) * 0.4).astype(np.float32)))
    batch = {
        "pos": torch.from_numpy(pos0), "rot": rot0,
        "single": torch.from_numpy((rng.standard_normal((B, L, 384)) * 0.5).astype(np.float32)),
        "pair": torch.from_numpy((rng.standard_normal((B, L, L, 128)) * 0.2).astype(np.float32)),
    }
    batch = {k: v.to(DEVICE) for k, v in batch.items()}
    sdes = SDEs(pos=CosineVPSDE(), node_orientations=DiGSO3SDE(
        **dict(BIOEMU_V1_SO3, cache_dir=str(OUT / "so3_cache")), device=DEVICE))

    def case(dtype, route):
        """The step at ``dtype``, every K1 backward on ``route``; returns
        examples an hour from the median step."""
        dname = str(dtype).removeprefix("torch.")
        model = dig.DiGConditionalScoreModel(**BIOEMU_V1_MODEL, dtype=dtype)
        dig.init_weights(model, torch.Generator().manual_seed(0)).to(DEVICE)
        cfg = TrainConfig(lr=1e-4)
        opt = make_optimizer(cfg, model.parameters())

        def gen(i):
            return step_generator(0, i, torch.device(DEVICE))

        def step(i):
            return train_step(model, opt, batch, gen(i), sdes, lr=cfg.lr, grad_clip=cfg.grad_clip)

        for i in range(3):
            step(i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        bwd_before = dict(k1.backward_calls_by_route)
        for i in range(3, 13):
            t0 = time.perf_counter()
            loss = step(i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        med = float(np.median(times))
        bwd_routes = {k: n - bwd_before[k] for k, n in k1.backward_calls_by_route.items()}
        log(f"[train-step] L={L} B={B} {dname} full width, 10 timed steps: median {med * 1e3:.2f} ms, "
            f"min {min(times) * 1e3:.2f} ms, max {max(times) * 1e3:.2f} ms; loss {loss.item():.4f}; "
            f"peak device memory {peak_gb:.2f} GB; K1 backward passes by route {bwd_routes} "
            f"(expected {10 * N_LAYERS} on {route}); {card}")
        if bwd_routes != only_bwd_routes(k1, **{route: 10 * N_LAYERS}):
            raise AssertionError(f"the train step's K1 backward left the kernel route: {bwd_routes}")

        # Forward / backward / optimizer split, by CUDA events, over 5 steps:
        # the three parts train_step is made of, called in its order.
        split = {"noise+forward": [], "backward": [], "optimizer": []}
        for i in range(13, 18):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            loss = step_loss(model, batch, gen(i), sdes)
            ev[1].record()
            step_backward(opt, loss)
            ev[2].record()
            step_update(model, opt, lr=cfg.lr, grad_clip=cfg.grad_clip)
            ev[3].record()
            torch.cuda.synchronize()
            for key, a, b in zip(split, ev[:-1], ev[1:]):
                split[key].append(a.elapsed_time(b))
        split_ms = {k: float(np.median(v)) for k, v in split.items()}
        log(f"[train-step] {dname} split of one step (median of 5, CUDA events): "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in split_ms.items()))

        # One profiled step, train_step's three parts with labels; the K1
        # backward is labelled where autograd dispatches it (k1._backward, on
        # either route), without touching the library. A CPU-side label's
        # device time is the kernel time of what was launched under it.
        bwd = k1._backward

        def labelled(*a, **kw):
            with record_function("ipa_attention_backward"):
                return bwd(*a, **kw)

        def labelled_step():
            with record_function("forward"):
                loss = step_loss(model, batch, gen(18), sdes)
            step_backward(opt, loss)
            with record_function("optimizer"):
                step_update(model, opt, lr=cfg.lr, grad_clip=cfg.grad_clip)

        with mock.patch.object(k1, "_backward", labelled):
            prof = profile_device(labelled_step, labels=("forward", "optimizer", "ipa_attention_backward"))
        kernels = [(r.name, r.total_ms, r.count) for r in prof.rows]
        total = prof.total_ms
        if not total > 0:
            raise AssertionError("the profiler recorded no device time for the train step")

        # Kernels launched through ctypes (the library carries its own CUDA
        # runtime) fall under no label: K1's forward kernel and the backward
        # kernel's bwd_dv / bwd_rows / bwd_cols are added to their labels
        # by name (the backward's label alone once held 0.94 ms of 8 calls).
        k1_fwd = sum(t for k, t, _ in kernels if "ipa_attention" in k)
        k1_bwd_own = sum(t for k, t, _ in kernels
                         if any(n in k for n in ("bwd_dv", "bwd_rows", "bwd_cols")))
        fwd_label, opt_ms, bwd_label = (prof.labels[k] for k in ("forward", "optimizer",
                                                                 "ipa_attention_backward"))
        fwd, k1_bwd = fwd_label + k1_fwd, bwd_label + k1_bwd_own
        bwd_ms = total - fwd - opt_ms
        log(f"[train-profile] one {dname} step: device kernel time {total:.2f} ms in "
            f"{sum(n for _, _, n in kernels)} kernels, busy "
            f"{100 * total / (med * 1e3):.1f}% of the median unprofiled step; forward (noise "
            f"included) {fwd:.2f} ms, backward {bwd_ms:.2f} ms ({100 * bwd_ms / total:.1f}%), "
            f"optimizer {opt_ms:.2f} ms; K1 forward kernel {k1_fwd:.2f} ms ({100 * k1_fwd / total:.1f}%), "
            f"K1 backward (8 calls, route {route}) {k1_bwd:.2f} ms ({100 * k1_bwd / total:.1f}%: "
            f"bwd_dv, bwd_rows and bwd_cols {k1_bwd_own:.2f} ms, the ops around them "
            f"{bwd_label:.2f} ms)")
        for key, t, n in kernels[:12]:
            log(f"[train-profile]   {t:8.2f} ms {100 * t / total:5.1f}%  x{n:<5d} {key[:90]}")
        value = B * 3600.0 / med
        log(f"[train-step] dsm_train_examples_per_hour_L{L}_B{B} ({dname}) = {value:.1f} "
            f"(median step; {B * 3600.0 / min(times):.1f} from the fastest step)")
        return value

    value = case(torch.bfloat16, "bwd_tc")
    # The train CLI's default dtype: every backward on bwd_tc_f32.
    case(torch.float32, "bwd_tc_f32")
    return value


def phase_sp_kernel(k1):
    """Slab launches of sp_ipa_attention, concatenated, against the plain
    version over all rows; returns per-case results."""
    import torch

    from se3diff_torch.parallel.mesh import row_slabs

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    kw = dict(scalar_w=1.0 / 48**0.5, pair_w=1.0 / 3**0.5)
    results = {}
    for B, L, dname, masked, n in SLAB_CASES:
        args = k1_inputs(B, L, getattr(torch, dname), gen, masked)
        q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa = args
        want = k1.ipa_attention_plain(*args, **kw)
        full_ms = cuda_time_ms(lambda: k1.ipa_attention(*args, **kw), reps=20)
        got, slabs = [], []
        for r0, r1 in row_slabs(L, n):
            slab = (q_s[:, :, r0:r1].contiguous(), k_s, v_s, q_p[..., r0:r1].contiguous(), k_p,
                    v_p, x2d[:, r0:r1].contiguous(), w_pv, bias, pa[:, :, r0:r1].contiguous())
            route = k1.kernel_route(getattr(torch, dname), 32, 16, 256, True)
            before = k1.launches_by_route[route]
            outs = k1.sp_ipa_attention((r0, r1), *slab, **kw)
            if k1.launches_by_route[route] != before + 1:
                raise AssertionError(f"sp_ipa_attention did not launch the {route!r} design")
            torch.cuda.synchronize()
            ms = cuda_time_ms(lambda: k1.sp_ipa_attention((r0, r1), *slab, **kw), reps=20)
            plain_ms = cuda_time_ms(lambda: k1.ipa_attention_plain(*slab, **kw), reps=5)
            bound_ms, bound_by, nbytes, _ = k1_bound(slab, outs, dname)
            got.append(outs)
            slabs.append(dict(rows=r1 - r0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, mb=nbytes / 1e6))
            del slab
        got = [torch.cat([o[i] for o in got], dim=2) for i in range(3)]
        err, scale = max_err(got, want)
        tol = TOL[dname] * scale
        def each(key, fmt=".4f"):
            return "/".join(format(sl[key], fmt) for sl in slabs)

        log(f"[sp-k1] B={B} L={L} {dname} masked_cols={masked} {n} slabs ({each('rows', 'd')} "
            f"rows): max_abs_err={err:.3e} (tol {tol:.3e}); per slab launch ms={each('ms')} "
            f"bound_ms={each('bound_ms')} ({slabs[0]['bound_by']}; {each('mb', '.1f')} MB) "
            f"plain_ms={each('plain_ms')}; "
            f"full-rows launch ms={full_ms:.4f}; library_ms=null (no single PyTorch call "
            "computes this function)")
        if not err <= tol:
            raise AssertionError(f"slab launches disagree with the plain version: {err} > {tol}")
        results[(B, L, dname, masked, n)] = dict(max_abs_err=err, full_ms=full_ms, **slabs[0])
        del args, want, got
    return results


def _sp_score_inputs(B, L, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, L, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    rot = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(B, L, 3, 3)
    return (
        rng.standard_normal((B, L, 3)).astype(np.float32), rot.astype(np.float32),
        rng.uniform(0.05, 0.95, B).astype(np.float32),
        rng.standard_normal((B, L, 384)).astype(np.float32),
        (rng.standard_normal((B, L, L, 128)) * 0.5).astype(np.float32),
    )


def phase_parallel(k1, card):
    """(b)-(d): one spawn of SP_RANKS gloo ranks on the card, held against
    this process. Returns the per-rank SP sampling launch counts."""
    from datetime import timedelta

    import numpy as np
    import torch

    from se3diff_torch.diffusion import denoise
    from se3diff_torch.models import dig
    from se3diff_torch.parallel import programs, run_ranks
    from se3diff_torch.sampling.bundle import BIOEMU_V1_MODEL, BIOEMU_V1_SO3, random_bundle
    from se3diff_torch.sampling.embeds import get_embeds, load_embeds
    from se3diff_torch.sampling.pipeline import sample, stage_conditioning

    # This process's references.
    L = len(SP_SEQ)
    inputs = _sp_score_inputs(SP_BATCH, L, seed=8)
    ref = {}
    with torch.inference_mode():
        for dname in ("float32", "bfloat16"):
            model = dig.DiGConditionalScoreModel(**BIOEMU_V1_MODEL, dtype=getattr(torch, dname))
            dig.init_weights(model, torch.Generator().manual_seed(1)).to(DEVICE).eval()
            ref[dname] = [o.float().cpu().numpy()
                          for o in model(*(torch.from_numpy(x).to(DEVICE) for x in inputs))]
            del model
    so3 = dict(BIOEMU_V1_SO3, cache_dir=str(OUT / "so3_cache"))
    bundle_kw = dict(denoiser="dpm_2m", dtype=torch.bfloat16, seed=0, so3_kwargs=so3)
    for d in ("sp_warmup", "sp_main", "one_warmup", "one_main"):
        shutil.rmtree(OUT / d, ignore_errors=True)
    sample_kw = dict(sequence=SP_SEQ, num_samples=SP_SAMPLES, batch_size=SP_BATCH,
                     embeds_backend="dummy", cache_embeds_dir=str(OUT / "embeds"),
                     filter_samples=False)
    bundle = random_bundle(**bundle_kw, device=DEVICE)
    sample(**{**sample_kw, "num_samples": SP_BATCH, "output_dir": str(OUT / "one_warmup")},
           bundle=bundle)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = 0
    t0 = time.perf_counter()
    sample(**sample_kw, output_dir=str(OUT / "one_main"), bundle=bundle)
    torch.cuda.synchronize()
    one_wall, one_launches = time.perf_counter() - t0, k1.launches
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    del bundle
    dp_kw = dict(denoiser=DP_DENOISER, dtype=torch.float32, seed=0, so3_kwargs=so3)
    single, pair = load_embeds(*get_embeds(MAIN_SEQ, str(OUT / "embeds"), backend="dummy"))
    bundle = random_bundle(**dp_kw, device=DEVICE)
    s_d, p_d, _, _ = stage_conditioning(single, pair, bundle.device)
    with torch.inference_mode():
        dp_ref = [t.cpu().numpy() for t in bundle.sampler(DP_BATCH, DP_L)(
            torch.Generator(device=DEVICE).manual_seed(DP_SEED), s_d, p_d)]
        # Each rank's rows replayed here at the rank's batch size, from the
        # same prior rows: the DP run must give exactly these.
        pos0, rot0 = denoise._prior(torch.Generator(device=DEVICE).manual_seed(DP_SEED),
                                    bundle.sdes, DP_BATCH, DP_L)
        per = DP_BATCH // SP_RANKS
        cache = bundle.model.embed_conditioning(s_d.expand(per, *s_d.shape),
                                                p_d.expand(per, *p_d.shape))
        replay = [denoise.solve_from(
            bundle.denoiser, bundle.sdes,
            lambda x, r, t: bundle.model.score_from_cache(x, r, t, cache),
            pos0[i * per:(i + 1) * per], rot0[i * per:(i + 1) * per]) for i in range(SP_RANKS)]
        dp_replay = [torch.cat([o[k] for o in replay]).cpu().numpy() for k in range(2)]
    del bundle, cache, replay
    torch.cuda.empty_cache()

    steps = [
        (programs.sp_score, (BIOEMU_V1_MODEL, 1, inputs, "float32")),
        (programs.sp_score, (BIOEMU_V1_MODEL, 1, inputs, "bfloat16")),
        (programs.sp_sample, (bundle_kw, {**sample_kw, "output_dir": str(OUT / "sp_main")},
                              str(OUT / "sp_warmup"))),
        (programs.dp_sample, (dp_kw, single, pair, DP_BATCH, DP_SEED)),
    ]
    t0 = time.perf_counter()
    ranks = run_ranks(programs.in_turn, SP_RANKS, [DEVICE + ":0"] * SP_RANKS, args=(steps,),
                      timeout=900.0, group_timeout=timedelta(seconds=300))
    log(f"[parallel] {SP_RANKS} gloo ranks spawned on cuda:0 ran (b)-(d) in "
        f"{time.perf_counter() - t0:.1f} s with start-up")

    # (b) SP score against one process.
    for i, (dname, tol, route) in enumerate((("float32", 1e-3, "tc_f32"), ("bfloat16", 5e-2, "tc"))):
        for r, res in enumerate(ranks):
            out = res[i]
            err = max(float(np.abs(out["pos"] - ref[dname][0]).max()),
                      float(np.abs(out["rot"] - ref[dname][1]).max()))
            scale = max(1.0, max(float(np.abs(x).max()) for x in ref[dname]))
            log(f"[sp-score] {dname} full width B={SP_BATCH} L={L} rank {r} rows {out['rows']}: "
                f"vs one process max_abs_err={err:.3e} (tol {tol * scale:.3e}); K1 launches "
                f"{out['launches']} (expected {N_LAYERS}), by route {out['launches_by_route']}")
            want_routes = only_routes(k1, **{route: N_LAYERS})
            if not err <= tol * scale or out["launches"] != N_LAYERS \
                    or out["launches_by_route"] != want_routes:
                raise AssertionError(f"SP score evaluation ({dname}, rank {r}) is wrong")

    # (c) SP sampling path.
    expect = N_LAYERS * MAIN_STEPS * (SP_SAMPLES // SP_BATCH)
    sp_runs = [res[2] for res in ranks]
    wall = max(run["wall_s"] for run in sp_runs)
    for run in sp_runs:
        peak = "not measured" if run["peak_bytes"] is None else f"{run['peak_bytes'] / 1e9:.3f} GB"
        log(f"[sp-main] rank {run['rank']}: L={L} bf16 dpm_2m-{MAIN_STEPS} batch {SP_BATCH}, "
            f"{SP_SAMPLES} samples in {run['wall_s']:.3f} s = "
            f"{SP_SAMPLES / run['wall_s'] * 3600:.1f} structures/hr; peak device memory "
            f"{peak}; K1 launches {run['launches']} (expected {expect}; on this path every "
            f"one is a slab launch of sp_ipa_attention), by route {run['launches_by_route']}")
        if run["launches"] != expect or run["launches_by_route"] != only_routes(k1, tc=expect):
            raise AssertionError(f"rank {run['rank']} launched K1 {run['launches']} times "
                                 f"({run['launches_by_route']})")
    log(f"[sp-main] one process, same run: {one_wall:.3f} s = "
        f"{SP_SAMPLES / one_wall * 3600:.1f} structures/hr; peak device memory {one_peak:.3f} GB; "
        f"K1 launches {one_launches}; {card}")
    files = sorted((OUT / "sp_main").glob("batch_*.npz"))
    if len(files) != SP_SAMPLES // SP_BATCH or not (OUT / "sp_main" / "topology.pdb").exists():
        raise AssertionError("rank 0 did not write the SP run's outputs")
    diff = 0.0
    for f in files:
        with np.load(f) as a, np.load(OUT / "one_main" / f.name) as b:
            if a["pos"].shape != (SP_BATCH, L, 3) or not (
                    np.isfinite(a["pos"]).all() and np.isfinite(a["node_orientations"]).all()):
                raise AssertionError(f"{f.name}: bad shape or non-finite coordinates")
            diff = max(diff, float(np.abs(a["pos"] - b["pos"]).max()))
    log(f"[sp-main] rank 0 wrote {len(files)} batch files, topology and trajectory; finite "
        f"coordinates; largest position difference from the one-process run {diff:.3e} nm (bf16)")

    # (d) DP rows: exactly this process's replay of each rank's rows at the
    # rank's batch size; within DP_TOL of the batch of DP_BATCH, whose GEMMs
    # have other shapes and so sum in another order.
    largest = float(np.abs(dp_ref[0]).max())
    for r, res in enumerate(ranks):
        got = (res[3]["pos"], res[3]["node_orientations"])
        replay_err = max(float(np.abs(g - w).max()) for g, w in zip(got, dp_replay))
        err = max(float(np.abs(g - w).max()) for g, w in zip(got, dp_ref))
        routes = res[3]["launches_by_route"]
        log(f"[dp] rank {r}: {DP_BATCH} samples at L={DP_L}, f32 dpm_2m-"
            f"{DP_DENOISER['num_steps']} from t={DP_DENOISER['max_t']} over {SP_RANKS} ranks, "
            f"same seed: against this process's replay of the ranks' rows (batch "
            f"{DP_BATCH // SP_RANKS}) max_abs_err={replay_err:.3e} (tol 1e-6); against the "
            f"batch of {DP_BATCH} max_abs_err={err:.3e} (tol {DP_TOL:.1e}); largest position "
            f"{largest:.3f} nm; K1 launches by route {routes}")
        if not replay_err <= 1e-6 or not err <= DP_TOL:
            raise AssertionError("DP rows differ from the single-device rows")
        dp_launches = N_LAYERS * DP_DENOISER["num_steps"]
        if routes != only_routes(k1, tc_f32=dp_launches):
            raise AssertionError(f"DP rank {r} launched K1 {routes}, expected {dp_launches} "
                                 "on the f32 tensor-core route")
    return [run["launches"] for run in sp_runs]


def _pb32_timed(k1, args, route, dname):
    """An in-kernel 32-head launch of ``route`` timed in turns (route, simt,
    two-step, twice) with the CUDA-core design and with the two-step a
    caller could run without the variant (pa = x2d @ w_pb by one
    ``torch.matmul`` in the model dtype, then the streamed tensor-core
    design), all uncounted on the same inputs. Returns the times and each
    yardstick's error against the route's outputs, and those outputs."""
    import torch

    kw = K1_KW
    B, H, Lq, _ = args[0].shape
    Lk, cp = args[1].shape[2], args[6].shape[-1]
    w_pb_t = args[10].t().to(args[6].dtype)                  # [H, Cp], rounded to x2d's dtype
    x2d_t = args[6].view(B, Lq * Lk, cp).transpose(1, 2)     # [B, Cp, Lq*Lk]
    streamed = "tc" if dname == "bfloat16" else "tc_f32"

    def new():
        return k1._launch_design(route, *args, **kw)

    def prev():
        return k1._launch_design("simt", *args, **kw)

    def two_step():
        pa = torch.matmul(w_pb_t, x2d_t).view(B, H, Lq, Lk)
        return k1._launch_design(streamed, *args[:9], pa, **kw)

    ref = new()
    prev_err, two_err = max_err(ref, prev())[0], max_err(ref, two_step())[0]
    times = [cuda_time_ms(fn, reps=20) for fn in (new, prev, two_step) * 2]
    return dict(ms=(times[0] + times[3]) / 2, prev_ms=(times[1] + times[4]) / 2,
                twostep_ms=(times[2] + times[5]) / 2, err_vs_prev=prev_err,
                err_vs_twostep=two_err, times=times, design=route), ref


def k1_pb32_bound(args, outs, dname):
    """The in-kernel 32-head designs' bound: the larger of the bytes bound
    and the operations on the units the design runs them on (``bound_ms``,
    ``bound_by``), with the bytes and operations it is made of, the bytes
    time, the design's operations time and every operation priced in f32 on
    CUDA cores."""
    _, _, nbytes, ops = k1_bound(args, outs, dname)
    design_ms, f32_ms = k1_pb32_ops_ms(args, dname)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    bound_by = "bytes" if bytes_ms >= design_ms else "operations"
    return max(bytes_ms, design_ms), bound_by, nbytes, ops, bytes_ms, design_ms, f32_ms


def _pb32_log(tag, res, args, outs, dname, card):
    """The readings of an in-kernel 32-head case: times in turns, bounds
    (``k1_pb32_bound``; ``ops_bound_ms`` is the all-f32 price, kept beside
    it)."""
    bound_ms, bound_by, nbytes, ops, bytes_ms, design_ms, f32_ms = k1_pb32_bound(args, outs, dname)
    t = res["times"]
    log(f"[k1-inkernel] {tag}: route {res['design']} ms={res['ms']:.4f} ({t[0]:.4f}, {t[3]:.4f}) "
        f"prev_ms={res['prev_ms']:.4f} ({t[1]:.4f}, {t[4]:.4f}; simt, {res['prev_ms'] / res['ms']:.2f}x) "
        f"twostep_ms={res['twostep_ms']:.4f} ({t[2]:.4f}, {t[5]:.4f}; pa by torch.matmul then "
        f"{'tc' if dname == 'bfloat16' else 'tc_f32'}, {res['twostep_ms'] / res['ms']:.2f}x) "
        f"max_abs_err vs simt {res['err_vs_prev']:.3e}, vs the two-step {res['err_vs_twostep']:.3e}; "
        f"bound_ms={bound_ms:.4f} ({bound_by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP; "
        f"{res['ms'] / bound_ms:.1f}x the bound) bytes_bound_ms={bytes_ms:.4f} "
        f"design_ops_ms={design_ms:.4f} ops_bound_ms={f32_ms:.4f} (all f32) library_ms=null (no "
        f"single PyTorch call computes this function); {card}")
    res.update(bound_ms=bound_ms, bound_by=bound_by, bytes_bound_ms=bytes_ms,
               design_ops_ms=design_ms, ops_bound_ms=f32_ms)


def _pb32_case(k1, gen, B, L, cp, dname, masked, card):
    """One in-kernel 32-head case: one counted launch of the route's design
    against the plain version and the CUDA-core design (each fatal beyond
    ``TOL``), then its time in turns with the CUDA-core design and the
    two-step, beside the plain version's and the bounds."""
    import torch

    dtype, route = getattr(torch, dname), PB32_ROUTES[dname]
    args = k1_inputs(B, L, dtype, gen, masked, cp=cp, in_kernel=True)
    if k1.kernel_route(dtype, 32, 16, cp, False) != route:
        raise AssertionError(f"in-kernel K1 at 32 heads, Cp={cp}, {dname} takes route "
                             f"{k1.kernel_route(dtype, 32, 16, cp, False)!r}, not {route!r}")
    before = dict(k1.launches_by_route)
    got = k1.ipa_attention(*args, **K1_KW)
    torch.cuda.synchronize()
    if k1.launches_by_route != {**before, route: before[route] + 1}:
        raise AssertionError(f"in-kernel ipa_attention at 32 heads did not launch {route!r} once")
    want = k1.ipa_attention_plain(*args, **K1_KW)
    err, scale = max_err(got, want)
    tol = TOL[dname] * scale
    res, _ = _pb32_timed(k1, args, route, dname)
    res.update(max_abs_err=err, plain_ms=cuda_time_ms(lambda: k1.ipa_attention_plain(*args, **K1_KW),
                                                      reps=5))
    _pb32_log(f"has_pa=False B={B} L={L} H=32 Cp={cp} {dname} masked_cols={masked}: "
              f"max_abs_err={err:.3e} (tol {tol:.3e}) plain_ms={res['plain_ms']:.4f}", res, args,
              got, dname, card)
    if not (err <= tol and res["err_vs_prev"] <= tol):
        raise AssertionError(f"{route} disagrees with the plain version ({err:.3e}) or the "
                             f"CUDA-core design ({res['err_vs_prev']:.3e}) beyond {tol:.3e}")
    if (B, L, cp) == PB32_CASES[0][:3] and not res["ms"] < res["prev_ms"]:
        raise AssertionError(f"{route} ({res['ms']:.4f} ms) is not faster than simt "
                             f"({res['prev_ms']:.4f} ms) on the same inputs")
    return res


def _pb32_slabs(k1, gen, dname, card):
    """The SP path's shape as row slabs with the in-kernel pair bias at 32
    heads (``sp_ipa_attention`` with ``pa=None``): each slab one counted
    launch of the route's design, the slabs together against the plain
    version on all rows (fatal beyond ``TOL``), the first slab timed in
    turns with the CUDA-core design and the two-step."""
    import torch

    from se3diff_torch.parallel.mesh import row_slabs

    dtype, route = getattr(torch, dname), PB32_ROUTES[dname]
    B, L, n = PB32_SLAB
    args = k1_inputs(B, L, dtype, gen, 0, in_kernel=True)
    want = k1.ipa_attention_plain(*args, **K1_KW)
    got, res = [], None
    for r0, r1 in row_slabs(L, n):
        slab = list(args)
        slab[0], slab[3], slab[6] = (args[0][:, :, r0:r1].contiguous(),
                                     args[3][..., r0:r1].contiguous(), args[6][:, r0:r1].contiguous())
        before = dict(k1.launches_by_route)
        got.append(k1.sp_ipa_attention((r0, r1), *slab, **K1_KW))
        torch.cuda.synchronize()
        if k1.launches_by_route != {**before, route: before[route] + 1}:
            raise AssertionError(f"an in-kernel 32-head slab did not launch {route!r} once")
        if res is None:
            res, _ = _pb32_timed(k1, slab, route, dname)
            res.update(plain_ms=cuda_time_ms(lambda: k1.ipa_attention_plain(*slab, **K1_KW), reps=5))
            _pb32_log(f"sp_ipa_attention has_pa=False B={B} L={L} H=32 {dname}, slab rows {r0}:{r1} "
                      f"plain_ms={res['plain_ms']:.4f}", res, slab, got[-1], dname, card)
    got = [torch.cat([o[i] for o in got], dim=2) for i in range(3)]
    err, scale = max_err(got, want)
    log(f"[k1-inkernel] sp_ipa_attention has_pa=False B={B} L={L} H=32 {dname}, {n} slabs: "
        f"max_abs_err={err:.3e} (tol {TOL[dname] * scale:.3e})")
    if not (err <= TOL[dname] * scale and res["err_vs_prev"] <= TOL[dname] * scale):
        raise AssertionError(f"in-kernel 32-head slab launches disagree with the plain version "
                             f"({err:.3e}) or simt ({res['err_vs_prev']:.3e})")
    res.update(max_abs_err=err)
    return res


def phase_inkernel(k1, ptxas, card):
    """K1 with the pair bias computed in the kernel (has_pa=False) and K1 at
    the control net's 4 heads, against the plain version; row slabs of the
    in-kernel variant at 4 heads; the "h4" route timed in turns with the
    CUDA-core design; at 32 heads the "tc_pb" / "tc_pb_f32" designs (their
    launch counts zeroed before and read after), timed in turns with the
    CUDA-core design and the two-step; the Function's gradients with
    ``w_pb`` against autograd of the plain version (``_grad_case``: at 4
    heads in f32 the backward kernel "bwd_h4", against the PyTorch backward
    and itself, timed in turns with the former). Returns per-case results."""
    import torch

    from se3diff_torch.parallel.mesh import row_slabs

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    kw = dict(scalar_w=1.0 / 48**0.5, pair_w=1.0 / 3**0.5)
    results = {}
    # The in-kernel pair bias at 32 heads: every case and slab one counted
    # launch of its dtype's route, and nothing else counted.
    _reset_k1(k1)
    for B, L, cp, dname, masked in PB32_CASES:
        results[("pb32", B, L, cp, dname)] = _pb32_case(k1, gen, B, L, cp, dname, masked, card)
    for dname in PB32_ROUTES:
        results[("pb32_slab", dname)] = _pb32_slabs(k1, gen, dname, card)
    per_route = {r: sum(1 for c in PB32_CASES if PB32_ROUTES[c[3]] == r) + PB32_SLAB[2]
                 for r in PB32_ROUTES.values()}
    if k1.launches_by_route != only_routes(k1, **per_route):
        raise AssertionError(f"the 32-head in-kernel cases launched {k1.launches_by_route}, not "
                             f"{per_route} on their routes alone")
    results["pb32_launches"] = per_route
    log(f"[k1-inkernel] 32 heads in-kernel: launches by route {per_route}, none on simt")
    for B, L, H, cp, dname, masked, in_kernel in INKERNEL_CASES:
        dtype = getattr(torch, dname)
        args = k1_inputs(B, L, dtype, gen, masked, H=H, cp=cp, in_kernel=in_kernel)
        variant = "w_pb" if in_kernel else "pa"
        route = k1.kernel_route(dtype, H, 16, cp, not in_kernel)
        before, by_route = k1.launches_by_variant[variant], k1.launches_by_route[route]
        got = k1.ipa_attention(*args, **kw)
        torch.cuda.synchronize()
        if k1.launches_by_variant[variant] != before + 1 or k1.launches_by_route[route] != by_route + 1:
            raise AssertionError(f"ipa_attention ({variant}) on CUDA tensors did not launch the "
                                 f"{route!r} design")
        if (H, dname, in_kernel) == (4, "float32", True) and route != "h4":
            raise AssertionError(f"the control net's width took route {route!r}, not 'h4'")
        want = k1.ipa_attention_plain(*args, **kw)
        err, scale = max_err(got, want)
        tol = TOL[dname] * scale
        res, detail = _timed_with_simt(k1, lambda: k1.ipa_attention(*args, **kw), args, kw, route,
                                       ptxas)
        if route in (*H16_ROUTES.values(), *H8_ROUTES.values()) and not res["err_vs_prev"] <= tol:
            raise AssertionError(f"{route} disagrees with the CUDA-core design: "
                                 f"{res['err_vs_prev']} > {tol}")
        plain_ms = cuda_time_ms(lambda: k1.ipa_attention_plain(*args, **kw), reps=5)
        bound_ms, bound_by, nbytes, ops = k1_bound(args, got, dname)
        log(f"[k1-inkernel] {'has_pa=False' if in_kernel else 'has_pa=True'} B={B} L={L} H={H} "
            f"Cp={cp} {dname} masked_cols={masked}: max_abs_err={err:.3e} (tol {tol:.3e}) "
            f"{detail} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}; "
            f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP) library_ms=null (no single PyTorch "
            "call computes this function)")
        if not err <= tol:
            raise AssertionError(f"kernel disagrees with its plain version: {err} > {tol}")
        results[(B, L, H, cp, dname, in_kernel)] = dict(
            max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, **res)
        del args, got, want

    # Row slabs (sp_ipa_attention with pa=None) at the control net's width.
    B, L, H, cp = PPFT_BATCH, 56, 4, 32
    args = k1_inputs(B, L, torch.float32, gen, 0, H=H, cp=cp, in_kernel=True)
    want = k1.ipa_attention_plain(*args, **kw)
    got, slabs = [], []
    for r0, r1 in row_slabs(L, 2):
        slab = list(args)
        slab[0], slab[3], slab[6] = (args[0][:, :, r0:r1].contiguous(), args[3][..., r0:r1].contiguous(),
                                     args[6][:, r0:r1].contiguous())
        before = k1.launches_by_route["h4"]
        got.append(k1.sp_ipa_attention((r0, r1), *slab, **kw))
        if k1.launches_by_route["h4"] != before + 1:
            raise AssertionError("an in-kernel 4-head slab did not launch the 'h4' design")
        res, detail = _timed_with_simt(
            k1, lambda: k1.sp_ipa_attention((r0, r1), *slab, **kw), slab, kw, "h4", ptxas)
        res.update(bound_ms=k1_bound(slab, got[-1], "float32")[0],
                   plain_ms=cuda_time_ms(lambda: k1.ipa_attention_plain(*slab, **kw), reps=5))
        log(f"[k1-inkernel] sp_ipa_attention has_pa=False B={B} L={L} H={H} f32, slab rows "
            f"{r0}:{r1}: {detail} bound_ms={res['bound_ms']:.4f} plain_ms={res['plain_ms']:.4f}")
        slabs.append(res)
    got = [torch.cat([o[i] for o in got], dim=2) for i in range(3)]
    err, scale = max_err(got, want)
    log(f"[k1-inkernel] sp_ipa_attention has_pa=False B={B} L={L} H={H} f32, 2 slabs: "
        f"max_abs_err={err:.3e} (tol {TOL['float32'] * scale:.3e})")
    if not err <= TOL["float32"] * scale:
        raise AssertionError("in-kernel slab launches disagree with the plain version")
    results["sp_h4"] = dict(max_abs_err=err, **slabs[0])
    del args, want, got

    # The Function's gradients with w_pb: 4 heads in f32 on the kernel
    # "bwd_h4", timed in turns with the PyTorch backward; its forward and
    # backward's peak memory at the PPFT step's shape no more than the
    # forward with the PyTorch backward's.
    for B, L, H, cp, dname, masked, Lq in INKERNEL_GRAD_CASES:
        res = _grad_case(k1, gen, B, L, dname, masked, H=H, Lq=Lq, cp=cp, in_kernel=True,
                         tag="k1-inkernel")
        if (H, dname) == (4, "float32") and res["route"] != "bwd_h4":
            raise AssertionError(f"the control net's backward took route {res['route']!r}, not 'bwd_h4'")
        results[("grad", B, L, H, cp, dname, Lq)] = res
    main = results[("grad",) + INKERNEL_GRAD_CASES[0][:5] + INKERNEL_GRAD_CASES[0][6:]]
    if not main["peak_mb"] <= main["torch_peak_mb"]:
        raise AssertionError(f"bwd_h4's forward + backward peaks at {main['peak_mb']:.1f} MB, above "
                             f"the forward with the PyTorch backward's {main['torch_peak_mb']:.1f} MB")

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    for H, cases in ((16, K1_H16_CASES), (8, K1_H8_CASES)):
        for B, Lq, Lk, cp, dname, masked in cases:
            results[(f"h{H}", B, Lq, Lk, cp, dname)] = _tp_case(
                k1, ptxas, gen, H, B, Lq, Lk, cp, dname, masked, tag="k1-inkernel")
    return results


def phase_ppft_files():
    """Inputs of the PPFT phases in OUT/ppft: seed-0 score weights at
    bioemu-v1.0 widths, a config.yaml with score_model and finetune_model
    blocks and the production SDEs, a near-zero control net (seed 1), and
    2 training + 1 validation GRB2-SH3 mutants from the repository's CSV."""
    import numpy as np
    import torch
    import yaml

    from se3diff_torch.models import dig
    from se3diff_torch.sampling.bundle import BIOEMU_V1_MODEL, BIOEMU_V1_SO3, initialize_weights_to_near_zero

    d = OUT / "ppft"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    score = dig.init_weights(dig.DiGConditionalScoreModel(**BIOEMU_V1_MODEL), torch.Generator().manual_seed(0))
    np.savez(d / "score.npz", **{k: v.numpy() for k, v in score.state_dict().items()})
    ft = dig.init_weights(dig.DiGConditionalScoreModel(**FT_MODEL), torch.Generator().manual_seed(1))
    initialize_weights_to_near_zero(ft)
    np.savez(d / "ft0.npz", **{k: v.numpy() for k, v in ft.state_dict().items()})
    target = "bioemu.shortcuts.DiGConditionalScoreModel"
    cfg = {
        "score_model": {"_target_": target, **BIOEMU_V1_MODEL},
        "finetune_model": {"_target_": target, **FT_MODEL},
        "sdes": {
            "node_orientations": {"_target_": "bioemu.shortcuts.DiGSO3SDE", **BIOEMU_V1_SO3},
            "pos": {"_target_": "bioemu.shortcuts.CosineVPSDE", "s": 0.008},
        },
    }
    (d / "config.yaml").write_text(yaml.safe_dump(cfg, sort_keys=False))
    lines = (REPO / GRB2_CSV).read_text().splitlines()
    (d / "train.csv").write_text("\n".join(lines[:3]) + "\n")
    (d / "val.csv").write_text("\n".join([lines[0], lines[3]]) + "\n")
    return d


def _reset_k1(k1):
    k1.launches = k1.backward_calls = 0
    k1.launches_by_variant.update(pa=0, w_pb=0)
    k1.launches_by_route.update(dict.fromkeys(k1.launches_by_route, 0))
    k1.backward_calls_by_route.update(dict.fromkeys(k1.backward_calls_by_route, 0))


def _check_ppft_routes(k1, launches):
    """The score model's streamed bf16 launches take the tensor-core route,
    the control net's in-kernel f32 launches at 4 heads the "h4" design;
    every backward pass is the control net's (the score model is frozen),
    on the backward kernel "bwd_h4" and none on the PyTorch backward."""
    routes = dict(k1.launches_by_route)
    if routes != only_routes(k1, tc=launches["pa"], h4=launches["w_pb"]):
        raise AssertionError(f"PPFT launches by route {routes} do not follow their variants {launches}")
    bwd_routes = dict(k1.backward_calls_by_route)
    if bwd_routes != only_bwd_routes(k1, bwd_h4=k1.backward_calls):
        raise AssertionError(f"PPFT backward passes by route {bwd_routes}: expected all on bwd_h4")
    return routes


def phase_ppft_cli(k1, files, card, denoiser="heun_finetune", steps=PPFT_CLI_STEPS):
    """``python -m se3diff_torch.finetune``'s main on the card at full widths,
    cut in batch (and, where ``steps`` is given, in steps), recording with
    ``denoiser``. Returns K1's launches by variant and its backward passes in
    the run."""
    import numpy as np
    import torch
    from unittest import mock

    from se3diff_torch import finetune
    from se3diff_torch.models import dig
    from se3diff_torch.ppft import trainer

    out = OUT / "ppft_out"
    shutil.rmtree(out, ignore_errors=True)
    finite = []
    make = trainer.make_finetune_step_fns

    def checked(*a, **kw):
        grad_fn, val_fn = make(*a, **kw)

        def grad_fn_checked(*args):
            grads, loss = grad_fn(*args)
            finite.append(all(bool(torch.isfinite(g).all()) for g in grads.values())
                          and any(bool(g.abs().max() > 0) for g in grads.values()))
            return grads, loss
        return grad_fn_checked, val_fn

    argv = [
        "--csv_path", str(files / "train.csv"), "--csv_path_val", str(files / "val.csv"),
        "--sequence_col", "seq", "--h_stars_cols", "f_dg_pred", "--h_stars_from_dg",
        "--ckpt_path", str(files / "score.npz"), "--model_config_path", str(files / "config.yaml"),
        "--finetune_ckpt_path", str(files / "ft0.npz"), "--denoiser_type", denoiser,
        *(["--num_steps", str(steps)] if steps else []),
        "--batch_size", str(PPFT_CLI_BATCH), "--num_epochs", "1",
        "--output_dir", str(out), "--cache_embeds_dir", str(OUT / "embeds"), "--embeds_backend", "dummy",
        "--so3_cache_dir", str(OUT / "so3_cache"), "--dtype", "bfloat16", "--device", DEVICE,
    ]
    _reset_k1(k1)
    t0 = time.perf_counter()
    with mock.patch.object(trainer, "make_finetune_step_fns", checked):
        finetune.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, backwards = dict(k1.launches_by_variant), k1.backward_calls
    routes = _check_ppft_routes(k1, launches)
    hist = json.loads((out / "history.json").read_text())
    losses = [e["loss"] for e in hist["train"]] + [e["val_loss"] for e in hist["val"]]
    with np.load(out / "finetune_model_0.npz") as a, np.load(out / "finetune_model_1.npz") as b:
        moved = [k for k in a.files if not np.array_equal(a[k], b[k])]
        finite_params = all(np.isfinite(b[k]).all() for k in b.files)
        n_params = len([k for k in a.files if a[k].size])
    model = dig.DiGConditionalScoreModel(**FT_MODEL)
    model.load_state_dict(trainer.load_finetune_params(out / "finetune_model.npz"), strict=True)
    # Paths: validation at epochs 0 and 1 (1 mutant each) and 2 training
    # paths; the replay runs the control net twice a step (checkpoint).
    paths, train = 4, 2
    n = steps or RECORDERS[denoiser][0]
    evals = RECORDERS[denoiser][1] * n
    expect = {"pa": paths * evals * N_LAYERS,
              "w_pb": paths * evals * FT_LAYERS + train * 2 * n * FT_LAYERS}
    expect_bwd = train * n * FT_LAYERS
    tag = "[ppft]" if denoiser == "heun_finetune" else "[ppft-sde-dpm]"
    cut = f"{steps} steps (of 100)" if steps else f"its {n} steps"
    log(f"{tag} finetune CLI on the card: GRB2-SH3 (L=56) 2 training + 1 validation mutants, "
        f"h*=sigmoid(-dG), FoldingStability on 2vwf_trimmed_SH3.pdb, bioemu-v1.0 score model "
        f"(seed 0, bf16) + 2-layer d64 control net (near-zero, f32), {denoiser}; cut to path "
        f"batch {PPFT_CLI_BATCH} (of 256), {cut}, 1 epoch: {wall:.2f} s "
        f"with set-up; losses (train, val e0, val e1) {losses}; {len(moved)}/{n_params} control-net "
        f"tensors moved; K1 launches by variant {launches} (expected {expect}), by route "
        f"{routes}, K1 backward "
        f"passes {backwards} (expected {expect_bwd}); gradients finite and nonzero on "
        f"{sum(finite)}/{len(finite)} replays; {card}")
    if not all(np.isfinite(losses)) or not finite or not all(finite) or not finite_params:
        raise AssertionError("non-finite PPFT loss, gradient or parameter")
    if not moved:
        raise AssertionError("the control net's parameters did not move")
    for name in ("finetune_model.npz", "finetune_model_0.npz", "finetune_model_1.npz", "history.json"):
        if not (out / name).exists():
            raise AssertionError(f"{name} missing")
    if launches != expect or backwards != expect_bwd:
        raise AssertionError("PPFT K1 launches or backward passes are not the expected counts")
    return launches, backwards


def phase_ppft_step(k1, files, card, denoiser="heun_finetune", beside=None):
    """One PPFT step at bench.py --finetune's shape, recording with
    ``denoiser`` at its registry step count: path generation, replay
    gradient and AdamW update, timed, with launches by variant and peak
    memory; then a profile of a step cut to 10 steps for the device's busy
    share and the split of kernel time. ``beside`` is an earlier step's
    result of this run, printed beside this one."""
    from functools import partial

    import numpy as np
    import torch

    from se3diff_torch.ppft import trainer
    from se3diff_torch.utils.profiling import profile_device

    L = 56
    bundle = trainer.load_finetune_bundle(
        files / "score.npz", model_config_path=files / "config.yaml",
        finetune_ckpt_path=files / "ft0.npz", denoiser_type=denoiser,
        so3_cache_dir=str(OUT / "so3_cache"), dtype=torch.bfloat16, device=DEVICE,
    )
    rng = np.random.default_rng(0)  # bench.py --finetune's conditioning
    single = torch.from_numpy((rng.standard_normal((L, 384)) * 0.5).astype(np.float32)).to(DEVICE)
    pair = torch.from_numpy((rng.standard_normal((L, L, 128)) * 0.2).astype(np.float32)).to(DEVICE)
    h_stars = torch.full((PPFT_BATCH, 1), 0.7, device=DEVICE)
    model = bundle.finetune_model
    opt = torch.optim.AdamW(model.parameters(), lr=5e-4, eps=1e-8)
    grad_fn, _ = trainer.make_finetune_step_fns(bundle)

    def one_step(num_steps, seed):
        sampler = trainer.make_path_sampler(
            bundle._replace(denoiser=partial(bundle.denoiser, num_steps=num_steps)), PPFT_BATCH, L)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = sampler(torch.Generator(device=DEVICE).manual_seed(seed), single, pair)
        hs = bundle.h_func(path.pos_path[-1], "")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads, val = grad_fn(path, single, pair, hs, h_stars)
        for name, p in model.named_parameters():
            p.grad = grads[name]
        opt.step()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        finite_grads = all(bool(torch.isfinite(g).all()) for g in grads.values())
        opt.zero_grad(set_to_none=True)
        return t1 - t0, t2 - t1, float(val), path, finite_grads

    one_step(5, 0)  # warm-up: allocator, library loads
    _reset_k1(k1)
    torch.cuda.reset_peak_memory_stats()
    steps, per_step = RECORDERS[denoiser]
    t_path, t_grad, val, path, finite_grads = one_step(steps, 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches, backwards = dict(k1.launches_by_variant), k1.backward_calls
    routes = _check_ppft_routes(k1, launches)
    finite = all(bool(torch.isfinite(x).all()) for x in (path.pos_path, path.rot_path, *path.us.values(),
                                                        *path.dWs.values()))
    final_pos = path.pos_path[-1].detach().clone()  # phase 17's observables
    del path
    step_s = t_path + t_grad
    value = 3600.0 / step_s
    # The replay runs the control net twice a recorded step (checkpoint).
    expect = {"pa": per_step * steps * N_LAYERS,
              "w_pb": per_step * steps * FT_LAYERS + 2 * steps * FT_LAYERS}
    tag = "[ppft-step]" if denoiser == "heun_finetune" else "[ppft-sde-dpm-step]"
    metric = f"finetune_steps_per_hour_L{L}_B{PPFT_BATCH}_{denoiser.removesuffix('_finetune')}{steps}"
    then = "" if beside is None else (
        f" (beside {beside['denoiser']}-{beside['steps']} in this run: path {beside['t_path']:.3f} s, "
        f"replay + update {beside['t_grad']:.3f} s, step {beside['t_path'] + beside['t_grad']:.3f} s)")
    log(f"{tag} L={L} B={PPFT_BATCH} {denoiser}-{steps}, score model bf16, control "
        f"net f32: path generation {t_path:.3f} s, replay gradient + update {t_grad:.3f} s, step "
        f"{step_s:.3f} s{then}; val loss {val:.5f}; peak device memory {peak_gb:.2f} GB; K1 "
        f"launches by variant {launches} (expected {expect}), by route {routes}, K1 backward "
        f"passes {backwards} (expected {steps * FT_LAYERS}); {card}")
    if not finite or not finite_grads or not np.isfinite(val):
        raise AssertionError("non-finite PPFT path, gradient or loss")
    if launches != expect or backwards != steps * FT_LAYERS:
        raise AssertionError("PPFT step K1 launches or backward passes are not the expected counts")

    cut = 10
    t_path_c, t_grad_c, *_ = one_step(cut, 2)
    prof = profile_device(lambda: one_step(cut, 2))
    kernels = [(r.name, r.total_ms, r.count) for r in prof.rows]
    total = prof.total_ms
    if not total > 0:
        raise AssertionError("the profiler recorded no device time for the PPFT step")
    # The backward's four kernels (pre, rows, cols, wsum) by name: a launch
    # through ctypes carries no record_function label.
    k1_split = {"tc": sum(t for k, t, _ in kernels if "ipa_attention_tc_kernel" in k),
                "h4": sum(t for k, t, _ in kernels if "ipa_attention_h4_kernel" in k),
                "bwd_h4": sum(t for k, t, _ in kernels if "bwd_h4_" in k)}
    bwd_h4_count = sum(n for k, _, n in kernels if "bwd_h4_rows" in k)
    wall_ms = (t_path_c + t_grad_c) * 1e3
    log(f"{tag} profile of a step cut to {cut} steps: device kernel time {total:.1f} ms "
        f"in {sum(n for _, _, n in kernels)} kernels against an unprofiled wall of {wall_ms:.1f} ms, "
        f"so the device is busy {100 * total / wall_ms:.1f}%; K1 score model (32 heads, streamed, "
        f"tensor-core design) {k1_split['tc']:.1f} ms, K1 control net (4 heads, in-kernel, "
        f"h4 design) {k1_split['h4']:.1f} ms, its backward (bwd_h4_pre, bwd_h4_rows, "
        f"bwd_h4_cols, bwd_h4_wsum) {k1_split['bwd_h4']:.1f} ms in {bwd_h4_count} calls")
    for key, t, n in kernels[:10]:
        log(f"[ppft-profile]   {t:9.2f} ms {100 * t / total:5.1f}%  x{n:<6d} {key[:90]}")
    log(f"{tag} {metric} = {value:.1f}")
    return dict(value=value, launches=launches, backwards=backwards, busy=total / wall_ms,
                control_net_k1_ms=k1_split["h4"], control_net_bwd_ms=k1_split["bwd_h4"],
                control_net_bwd_calls=bwd_h4_count, denoiser=denoiser, steps=steps,
                t_path=t_path, t_grad=t_grad, final_pos=final_pos)


def phase_sample_cli(k1, files, card, dpm_f32_wall):
    """``python -m se3diff_torch.sample``'s main with each sampler of
    ``CLI_SAMPLERS`` at its registry step count: L=100, one batch of 40, f32
    (the CLI's default), the seed-0 bioemu-v1.0-width checkpoint and
    production SO(3) tables of the PPFT phases, dummy embeddings. Every K1
    launch on "tc_f32", finite coordinates; the physicality filter's verdicts
    are printed, not asserted (random weights give unphysical frames).
    Returns each sampler's launches and walls."""
    import re

    import numpy as np
    import torch

    from se3diff_torch import sample as sample_cli
    from se3diff_torch.struct.atoms import atom37_from_frames, atom37_mask
    from se3diff_torch.struct.physics import filter_unphysical_masks_device
    from se3diff_torch.struct.residues import sequence_to_aatype

    handler = _Breakdown()
    plog = logging.getLogger("se3diff_torch.sampling.pipeline")
    plog.addHandler(handler)
    plog.setLevel(logging.DEBUG)
    aatype = sequence_to_aatype(MAIN_SEQ)
    mask = atom37_mask(aatype)
    results = {}
    for name, (steps, per_step) in CLI_SAMPLERS.items():
        out = OUT / f"cli_{name}"
        shutil.rmtree(out, ignore_errors=True)
        argv = [
            "--sequence", MAIN_SEQ, "--num_samples", str(MAIN_BATCH), "--output_dir", str(out),
            "--ckpt_path", str(files / "score.npz"), "--model_config_path", str(files / "config.yaml"),
            "--denoiser", name, "--embeds_backend", "dummy", "--cache_embeds_dir", str(OUT / "embeds"),
            "--so3_cache_dir", str(OUT / "so3_cache"), "--exact_batch_size", str(MAIN_BATCH),
            "--no-filter_samples", "--device", DEVICE,
        ]
        _reset_k1(k1)
        t0 = time.perf_counter()
        sample_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, routes = k1.launches, dict(k1.launches_by_route)
        loop_s = float(re.search(r"loop=([0-9.]+)s", handler.lines[-1]).group(1))
        batches = sorted(out.glob("batch_*.npz"))
        if len(batches) != 1 or not (out / "topology.pdb").exists():
            raise AssertionError(f"--denoiser {name}: {len(batches)} batch files, expected 1, "
                                 f"and a topology")
        with np.load(batches[0]) as d:
            pos, rot = d["pos"], d["node_orientations"]
        if pos.shape != (MAIN_BATCH, len(MAIN_SEQ), 3) or not (np.isfinite(pos).all()
                                                               and np.isfinite(rot).all()):
            raise AssertionError(f"--denoiser {name}: bad shape {pos.shape} or non-finite coordinates")
        atom37, _ = atom37_from_frames(torch.from_numpy(pos).to(DEVICE), torch.from_numpy(rot).to(DEVICE),
                                       aatype)
        kept = int(filter_unphysical_masks_device(atom37, mask).sum())
        expect = N_LAYERS * steps * per_step
        log(f"[sample-cli] sample CLI --denoiser {name} ({steps} steps, {steps * per_step} score "
            f"evaluations): L={len(MAIN_SEQ)} f32, one batch of {MAIN_BATCH}: wall {wall:.3f} s with "
            f"set-up, {handler.lines[-1]} = {MAIN_BATCH / loop_s * 3600:.1f} structures/hr on the "
            f"loop (phase 4's f32 dpm_2m-{MAIN_STEPS} batch: {dpm_f32_wall:.3f} s = "
            f"{MAIN_BATCH / dpm_f32_wall * 3600:.1f}); max |pos| {np.abs(pos).max():.1f} nm; "
            f"physical frames {kept}/{MAIN_BATCH} (random weights); ipa_attention launches "
            f"{launches} (expected {expect}), by route {routes}; {card}")
        if launches != expect or routes != only_routes(k1, tc_f32=expect):
            raise AssertionError(f"--denoiser {name} launched K1 {launches} times ({routes}), "
                                 f"expected {expect}, all on the f32 tensor-core route")
        results[name] = dict(launches=launches, wall=wall, loop_s=loop_s)
    return results


def phase_toy(k1, card):
    """``examples/torch_toy_so3.py``'s ``main`` (``examples/toy_so3.py`` through
    ``se3diff_torch.toy``) at its full settings on the card: DSM training (1,500 steps at batch 4,096), base sampling
    (4,096 x 200 steps) and its mixture weights, PPFT fine-tuning toward h*
    (150 steps, paths of 1,024 x 100), fine-tuned sampling and its weights.
    The trained loss must fall below 0.85 of its start, the base weights lie
    within 0.05 of the mixture's, and fine-tuning (cut to 75 of the
    example's 150 steps, ``TOY_FT``) shrink their L1 distance to h*; whether
    it halves it, as at 150 steps, is printed. Then a profile of 5 more DSM
    steps and 1 more fine-tuning step: kernels a step and the busy share."""
    import copy

    import torch

    from se3diff_torch.toy import finetune_toy, train_toy

    example = _load_example("torch_toy_so3")
    _reset_k1(k1)
    torch.cuda.reset_peak_memory_stats()
    r = example.main(["--device", DEVICE, "--ft_steps", str(TOY_FT["num_steps_opt"]),
                      "--so3_cache_dir", str(OUT / "so3_cache"), "--no_plot"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    settings = r["settings"]
    if (settings["so3"], settings["train_steps"], settings["train_batch"], settings["sample_steps"],
            example.SAMPLE_BATCH, example.ASSIGN_L_MAX) != (
            TOY_SO3, TOY_TRAIN_STEPS, TOY_BATCH, TOY_SAMPLE_STEPS, TOY_BATCH, TOY_ASSIGN_L_MAX) or (
            settings["ft_steps"], settings["ft_batch"], settings["ft_path_steps"]) != (
            TOY_FT["num_steps_opt"], TOY_FT["batch_size"], TOY_FT["num_steps"]):
        raise AssertionError(f"the toy example's settings {settings} are not the phase's")
    if (example.MUS, example.SIGMAS, example.WEIGHTS, example.H_STARS) != (
            TOY_MUS, TOY_SIGMAS, TOY_WEIGHTS, TOY_H_STARS):
        raise AssertionError("the toy example's mixture or h* is not the notebook's")
    sde, model, ft_model, gen = r["sde"], r["model"], r["ft_model"], r["gen"]
    mus, sigmas, weights, h_stars = r["mus"], r["sigmas"], r["weights"], r["h_stars"]
    losses, ft_losses, xs, path, base_w, ft_w = (r[k] for k in ("losses", "ft_losses", "xs", "path",
                                                                "base_w", "ft_w"))
    t_tables, t_train, t_base, t_ft, t_ft_sample, wall = (r[k] for k in (
        "t_tables", "t_train", "t_base", "t_ft", "t_ft_sample", "wall"))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    losses, ft_losses = losses.cpu(), ft_losses.cpu()
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    base_d, ft_d = float((base_w - h_stars).abs().sum()), float((ft_w - h_stars).abs().sum())
    fmt = lambda w: "[" + ", ".join(f"{float(x):.4f}" for x in w) + "]"  # noqa: E731
    log(f"[toy] DiGMixSO3SDE({TOY_SO3}) tables {t_tables:.2f} s; train_toy {TOY_TRAIN_STEPS} steps at "
        f"batch {TOY_BATCH}: {t_train:.3f} s = {TOY_TRAIN_STEPS / t_train:.1f} steps/s, loss first-10 "
        f"mean {first:.4f}, last-10 mean {last:.4f} ({last / first:.3f}x)")
    log(f"[toy] reverse_diffusion {TOY_BATCH} x {TOY_SAMPLE_STEPS} steps: {t_base:.3f} s; base weights "
        f"{fmt(base_w)} against {fmt(weights)}, L1 to h* {base_d:.4f}")
    log(f"[toy] finetune_toy {TOY_FT['num_steps_opt']} steps (cut from {TOY_FT_STEPS_FULL}; paths "
        f"{TOY_FT['batch_size']} x "
        f"{TOY_FT['num_steps']}, l_max {TOY_FT['l_max']}): {t_ft:.3f} s = "
        f"{TOY_FT['num_steps_opt'] / t_ft:.2f} steps/s, loss {float(ft_losses[0]):.5f} -> "
        f"{float(ft_losses[-1]):.5f}; reverse_finetune_diffusion {TOY_BATCH} x {TOY_SAMPLE_STEPS}: "
        f"{t_ft_sample:.3f} s; fine-tuned weights {fmt(ft_w)} against h* {fmt(h_stars)}, L1 to h* "
        f"{ft_d:.4f} (base {base_d:.4f}; {ft_d / base_d:.3f}x, "
        f"{'under' if ft_d < 0.5 * base_d else 'not under'} half: printed, not asserted, at the cut)")
    log(f"[toy] phase wall {wall:.1f} s; peak device memory {peak_gb:.3f} GB; {card}")
    finite = all(bool(torch.isfinite(x).all()) for x in (losses, ft_losses, xs, *path))
    if not finite:
        raise AssertionError("non-finite toy loss or sample")
    if not last < 0.85 * first:
        raise AssertionError(f"the DSM loss fell only to {last / first:.3f} of its start (need < 0.85)")
    if float((base_w - weights).abs().max()) > 0.05:
        raise AssertionError(f"base weights {fmt(base_w)} are not within 0.05 of {fmt(weights)}")
    if not ft_d < base_d:
        raise AssertionError(f"fine-tuning moved the weights' L1 distance to h* from {base_d:.4f} "
                             f"to {ft_d:.4f}, not closer")
    if k1.launches:
        raise AssertionError(f"the toy launched K1 {k1.launches} times; it has no attention")

    # Where a step's time goes: 5 more DSM steps and 1 more fine-tuning step
    # (on copies of the models), unprofiled and then under the profiler.
    for what, n, fn in (
        ("DSM train steps", 5, lambda: train_toy(gen, sde, copy.deepcopy(model), mus, sigmas, weights,
                                                 num_steps=5, batch_size=TOY_BATCH, device=DEVICE)),
        ("fine-tuning step", 1, lambda: finetune_toy(gen, sde, model, copy.deepcopy(ft_model), mus, sigmas,
                                                     h_stars, **dict(TOY_FT, num_steps_opt=1), device=DEVICE)),
    ):
        _, wall_s = timed(fn)
        kernel_ms, count = _profiled_kernels(fn)
        log(f"[toy-profile] {n} {what}: {count} kernels ({count / n:.0f} a step), {kernel_ms:.1f} ms of "
            f"device time against an unprofiled wall of {wall_s * 1e3:.1f} ms: the device is busy "
            f"{100 * kernel_ms / (wall_s * 1e3):.1f}%, {wall_s * 1e6 / count:.1f} us of wall a kernel")
    return dict(wall=wall, t_train=t_train, t_ft=t_ft, base_w=base_w.tolist(), ft_w=ft_w.tolist())


def _profiled_kernels(fn):
    """Device kernel time (ms) and kernel count of ``fn()`` under the profiler."""
    from se3diff_torch.utils.profiling import profile_device

    prof = profile_device(fn)
    if not prof.rows:
        raise AssertionError("the profiler recorded no device time")
    return prof.total_ms, prof.count


def _noisy_copies(ref_nm, rng, n):
    """``n`` copies of the reference (nm) with Gaussian noise of 0 to 0.6 nm,
    each rotated at random and shifted, f32."""
    import numpy as np

    out = []
    for s in np.linspace(0.0, 0.6, n):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        out.append((ref_nm + rng.standard_normal(ref_nm.shape) * s) @ q.T + rng.standard_normal(3))
    return np.stack(out).astype(np.float32)


def phase_observables(k1, card, ppft_pos):
    """The PPFT observables on the card against the same calls on the CPU, on
    the GRB2-SH3 and PSD95-PDZ3 references' noisy copies (B=256) and phase
    13's last positions; each reference scores folded; ms per call. Then a
    ModelCIF of one phase-4 structure, written and read back."""
    import numpy as np
    import torch

    from se3diff_torch.ppft import observables as obs
    from se3diff_torch.struct import Structure, read_cif, write_modelcif
    from se3diff_torch.struct.atoms import atom37_from_frames
    from se3diff_torch.struct.residues import sequence_to_aatype

    out = OUT / "observables"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    _reset_k1(k1)
    rng = np.random.default_rng(17)
    refs = {name: str(REPO / path) for name, path in OBS_REFS.items()}
    calls = {
        "compute_h_binary": lambda pos, ref: obs.compute_h_binary(pos, ref),
        "compute_h_raw": lambda pos, ref: obs.compute_h_raw(pos, ref),
        "compute_h_for_grb2_sh3_raw": lambda pos, ref: obs.compute_h_for_grb2_sh3_raw(pos, None, ref),
        "compute_h_for_psd95_pdz3": lambda pos, ref: obs.compute_h_for_psd95_pdz3(pos, None, ref),
    }
    raw_calls = ("compute_h_raw", "compute_h_for_grb2_sh3_raw")
    cases = [
        ("grb2_sh3", "noisy", _noisy_copies(obs.load_ref(refs["grb2_sh3"]), rng, OBS_BATCH),
         ("compute_h_binary", "compute_h_raw", "compute_h_for_grb2_sh3_raw")),
        ("psd95_pdz3", "noisy", _noisy_copies(obs.load_ref(refs["psd95_pdz3"]), rng, OBS_BATCH),
         ("compute_h_binary", "compute_h_raw", "compute_h_for_psd95_pdz3")),
        ("grb2_sh3", "ppft-heun100", ppft_pos.float().cpu().numpy(),
         ("compute_h_binary", "compute_h_raw", "compute_h_for_grb2_sh3_raw")),
    ]

    def wall_ms(fn, cuda, reps=20):
        fn()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if cuda:
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    for ref_name, batch, pos_np, names in cases:
        ref = refs[ref_name]
        pos_cpu = torch.from_numpy(pos_np)
        pos_gpu = pos_cpu.to(DEVICE)
        raw_cpu = obs.compute_h_raw(pos_cpu, ref).numpy()
        near = (np.abs(raw_cpu[:, 0] - obs.PROTEIN_FOLDED_Q_THRESHOLD) < 1e-4) | (
            np.abs(raw_cpu[:, 1] - obs.LOOP_FOLDED_RMSD_NM) < 1e-4)
        # 1e-4 nm, or 2e-6 (some 17 f32 roundings) of the largest centred
        # coordinate where that is more: the random-weight PPFT path ends
        # hundreds of nm out, where f32 cannot resolve 1e-4 nm.
        centred = pos_np - pos_np.mean(1, keepdims=True)
        rmsd_tol = max(1e-4, 2e-6 * float(np.abs(centred).max()))
        for name in names:
            got = calls[name](pos_gpu, ref)
            want = calls[name](pos_cpu, ref).numpy()
            if got.device.type != torch.device(DEVICE).type or got.shape != (len(pos_np), 2):
                raise AssertionError(f"{name}: output on {got.device} of shape {tuple(got.shape)}")
            got = got.cpu().numpy()
            if name in raw_calls:
                err = np.abs(got - want).max(0)
                ok = err[0] <= 1e-5 and err[1] <= rmsd_tol
                verdict = (f"max |card - CPU| FNC {err[0]:.2e} (tol 1e-5), RMSD {err[1]:.2e} nm "
                           f"(tol {rmsd_tol:.2e})")
                summary = f"mean ({want[:, 0].mean():.4f}, {want[:, 1].mean():.4f} nm)"
            else:
                differ = (got != want).any(-1)
                ok = not (differ & ~near).any()
                verdict = (f"{int(differ.sum())} rows differ from the CPU's, {int(near.sum())} within 1e-4 "
                           f"of a threshold")
                summary = f"folded {want[:, 0].mean():.3f}, loop bound {want[:, 1].mean():.3f}"
            ms = wall_ms(lambda: calls[name](pos_gpu, ref), cuda=True)
            ms_cpu = wall_ms(lambda: calls[name](pos_cpu, ref), cuda=False, reps=5)
            log(f"[observables] {ref_name} {batch} B={len(pos_np)} {name}: {summary}; {verdict}; "
                f"card {ms:.3f} ms/call, CPU {ms_cpu:.3f} ms/call; {card}")
            if not (ok and np.isfinite(got).all()):
                raise AssertionError(f"{name} on {ref_name} {batch}: card and CPU disagree ({verdict})")

    for ref_name, ref in refs.items():
        own = torch.from_numpy(obs.load_ref(ref))[None].to(DEVICE)
        h = obs.compute_h_binary(own, ref).cpu().numpy()
        if h.tolist() != [[1.0, 1.0]]:
            raise AssertionError(f"the {ref_name} reference scores {h.tolist()}, not folded and bound")
    log(f"[observables] each reference scores [[1.0, 1.0]] (folded, loop bound) on the card; {card}")

    batch_file = sorted((OUT / "main").glob("batch_*.npz"))[0]
    with np.load(batch_file) as d:
        pos, rot = d["pos"][0], d["node_orientations"][0]
    aatype = np.asarray(sequence_to_aatype(MAIN_SEQ))
    atom37, mask = atom37_from_frames(torch.from_numpy(pos), torch.from_numpy(rot), aatype)
    struct = Structure(atom37=atom37.numpy()[None], mask=mask.numpy().astype(bool), aatype=aatype)
    cif = out / "main_frame0.cif"
    write_modelcif(struct, str(cif))
    back = read_cif(str(cif))
    m = struct.mask
    err = float(np.abs(back.atom37[:, m] - struct.atom37[:, m]).max())
    log(f"[observables] ModelCIF of phase 4's {batch_file.name} frame 0 (L={len(aatype)}, "
        f"{int(m.sum())} atoms, max |x| {np.abs(struct.atom37[:, m]).max():.1f} A): written and read "
        f"back, max |read - written| {err:.2e} A (tol 1e-3)")
    if (back.num_models != 1 or not np.array_equal(back.mask, m)
            or not np.array_equal(back.aatype, aatype) or not err <= 1e-3):
        raise AssertionError("the ModelCIF round trip changed the structure")
    if k1.launches:
        raise AssertionError(f"the observables launched K1 {k1.launches} times")


def _load_script(name):
    """``scripts/{name}.py`` as a module (scripts/ is not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_ppft_learn(k1, ptxas, card):
    """The PPFT learning run's scripts in this process, so K1's counters see
    their launches: ``scripts/torch_pretrain_sh3_prior.py``'s main (DSM at
    full width in bf16, the export, the sample check), then
    ``scripts/torch_ppft_trainer_run.py``'s main on that prior. Then K1 and
    its backward timed at the DSM step's shape (B=32, L=56, bf16)."""
    from unittest import mock

    import numpy as np
    import torch

    from se3diff_torch.models import dig
    from se3diff_torch.models.convert import load_checkpoint
    from se3diff_torch.training import loop

    prior_script, ppft_script = (_load_script(n) for n in LEARN_SCRIPTS)
    d = OUT / "learn"
    shutil.rmtree(d, ignore_errors=True)
    t_phase = time.perf_counter()

    # Every step's loss (kept on the device, read once at the end), and K1's
    # counters when train_dsm returns: the sample check comes after it.
    losses, dsm = [], {}
    train_step, train_dsm = loop.train_step, loop.train_dsm

    def recorded_step(*a, **kw):
        losses.append(train_step(*a, **kw).detach())
        return losses[-1]

    def counted_train_dsm(*a, **kw):
        out = train_dsm(*a, **kw)
        dsm.update(launches=k1.launches, routes=dict(k1.launches_by_route), backwards=k1.backward_calls,
                   bwd_routes=dict(k1.backward_calls_by_route))
        return out

    _reset_k1(k1)
    t0 = time.perf_counter()
    with mock.patch.object(loop, "train_step", recorded_step), \
            mock.patch.object(loop, "train_dsm", counted_train_dsm):
        model, summary = prior_script.main([*LEARN_PRIOR_ARGV, "--ckpt_dir", str(d / "prior"),
                                            "--output", str(d / "prior.json"), "--device", DEVICE])
    torch.cuda.synchronize()
    prior_wall = time.perf_counter() - t0
    launches, routes, backwards = k1.launches, dict(k1.launches_by_route), k1.backward_calls
    steps = summary["steps"]
    check_launches = launches - dsm["launches"]
    expect_check = LEARN_CHECK[0] * LEARN_CHECK[1] * N_LAYERS
    sampled = summary["sampled_h"]
    all_finite = bool(torch.isfinite(torch.stack(losses)).all())
    log(f"[ppft-learn] pretraining (scripts/torch_pretrain_sh3_prior.py, bioemu-v1.0 widths, "
        f"{summary['params_M']}M parameters, bf16): {steps} DSM steps at batch {summary['batch']} "
        f"over {summary['systems']} mutants x {summary['frames_per_system']} frames in "
        f"{prior_wall:.2f} s with set-up, median step {summary['dsm_step_ms']:.2f} ms; logged losses "
        f"{json.loads((d / 'prior.json').read_text())['loss_history']}, {len(losses)} step losses "
        f"{'all finite' if all_finite else 'NOT all finite'}; K1 launches {dsm['launches']} "
        f"(by route {dsm['routes']}), backward passes {dsm['backwards']} (by route "
        f"{dsm['bwd_routes']}; expected {N_LAYERS * steps} each: {N_LAYERS} a step, every launch on "
        f"tc, every backward on bwd_tc); sample check "
        f"({LEARN_CHECK_BATCH} WT structures, dpm_solver-{LEARN_CHECK[0]}) {check_launches} launches "
        f"(expected {expect_check}), sampled h mean {sampled['mean']:.4g}, q {sampled['quantiles']}; "
        f"ensemble h mean {summary['ensemble_h']['mean']:.4g}; {card}")
    if len(losses) != steps or not all_finite:
        raise AssertionError("a DSM loss of the pretraining run is not finite")
    if (dsm["launches"], dsm["backwards"]) != (N_LAYERS * steps, N_LAYERS * steps):
        raise AssertionError("DSM K1 launches or backward passes are not 8 a step")
    if routes != only_routes(k1, tc=launches) or backwards != dsm["backwards"]:
        raise AssertionError(f"the pretraining run's launches left the tensor-core route: {routes}")
    if dsm["bwd_routes"] != only_bwd_routes(k1, bwd_tc=dsm["backwards"]):
        raise AssertionError(f"the pretraining run's backward left bwd_tc: {dsm['bwd_routes']}")
    if check_launches != expect_check:
        raise AssertionError("the sample check's K1 launches are not the expected count")
    q = sampled["quantiles"]
    if not (np.isfinite(sampled["mean"]) and 0.0 <= q[0] <= q[-1] <= 1.0):
        raise AssertionError(f"sampled h is not finite within [0, 1]: {sampled}")

    # The export reloads into a fresh model that scores a fixed batch as the
    # trained model does, bit for bit.
    fresh = dig.DiGConditionalScoreModel(dtype=torch.bfloat16)
    fresh.load_state_dict(load_checkpoint(str(d / "prior" / "params.npz")), strict=True)
    fresh.to(DEVICE).eval()
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    L = LEARN_L
    x = (torch.randn(2, L, 3, generator=gen, device=DEVICE),
         torch.eye(3, device=DEVICE).expand(2, L, 3, 3).contiguous(),
         torch.full((2,), 0.3, device=DEVICE), torch.randn(2, L, 384, generator=gen, device=DEVICE),
         torch.randn(2, L, L, 128, generator=gen, device=DEVICE) * 0.2)
    with torch.inference_mode():
        same = all(torch.equal(a, b) for a, b in zip(model.eval()(*x), fresh(*x)))
    log(f"[ppft-learn] params.npz reloaded into a fresh model: score on a fixed batch "
        f"{'equal to the trained model bit for bit' if same else 'DIFFERS from the trained model'}")
    if not same:
        raise AssertionError("the exported prior does not reload bit for bit")
    del model, fresh

    _reset_k1(k1)
    t0 = time.perf_counter()
    best = ppft_script.main([*LEARN_PPFT_ARGV, "--prior_params", str(d / "prior" / "params.npz"),
                             "--output_dir", str(d / "ppft"), "--device", DEVICE])
    torch.cuda.synchronize()
    ppft_wall = time.perf_counter() - t0
    launches, ppft_backwards = dict(k1.launches_by_variant), k1.backward_calls
    routes = _check_ppft_routes(k1, launches)
    hist = json.loads((d / "ppft" / "history.json").read_text())
    n, per = LEARN_RECORDER
    train = hist["train"][0]
    updates = int(LEARN_PPFT_ARGV[LEARN_PPFT_ARGV.index("--train_mutants") + 1])
    # Paths: validation at epochs 0 and 1 (1 mutant each) and one a training
    # update; the replay runs the control net twice a step (checkpoint).
    paths = 2 + updates
    expect = {"pa": paths * per * n * N_LAYERS,
              "w_pb": paths * per * n * FT_LAYERS + updates * 2 * n * FT_LAYERS}
    expect_bwd = updates * n * FT_LAYERS
    best_epoch = hist["best_epoch"]
    with np.load(d / "ppft" / "finetune_model.npz") as a, \
            np.load(d / "ppft" / f"finetune_model_{best_epoch}.npz") as b:
        best_equal = sorted(a.files) == sorted(b.files) and all(
            np.array_equal(a[k], b[k]) and np.array_equal(a[k], best[k].cpu().numpy()) for k in a.files)
    vals = [(e["epoch"], e["val_loss"], e["val_path_kl"]) for e in hist["val"]]
    update_s = train["seconds"] / updates
    log(f"[ppft-learn] fine-tuning (scripts/torch_ppft_trainer_run.py): GRB2-SH3 {updates} training "
        f"+ 1 validation mutants, path batch {hist['config']['batch_size']}, "
        f"euler_maruyama_finetune-{n}, 1 epoch: {ppft_wall:.2f} s with set-up; validation (epoch, "
        f"EV+KL, path KL) {vals}; training loss {train['loss']}, mean path KL "
        f"{train['mean_path_kl']}, max {train['max_path_kl']}; wall of an update (path, h, replay, "
        f"AdamW) {update_s:.3f} s, of a validation {hist['val'][0]['seconds']:.3f} s; best epoch "
        f"{best_epoch}, finetune_model.npz {'equals' if best_equal else 'DIFFERS from'} its "
        f"checkpoint; K1 launches by variant {launches} (expected {expect}), by route {routes}, "
        f"backward passes {ppft_backwards} (expected {expect_bwd}); {card}")
    if [v[0] for v in vals] != [0, 1] or not np.isfinite([v[1:] for v in vals]).all():
        raise AssertionError("history.json lacks finite validation at epochs 0 and 1")
    if not vals[0][2] < 1e-6:
        raise AssertionError(f"epoch-0 path KL {vals[0][2]} is not that of a near-zero control")
    if not (train["mean_path_kl"] > 0 and np.isfinite(train["loss"])):
        raise AssertionError("the updates left the control at zero or the loss is not finite")
    if not best_equal:
        raise AssertionError("finetune_model.npz is not the best epoch's checkpoint")
    if launches != expect or ppft_backwards != expect_bwd:
        raise AssertionError("PPFT K1 launches or backward passes are not the expected counts")
    scripts_wall = time.perf_counter() - t_phase

    # The DSM step's K1 forward for PERF.md's table (its backward is phase
    # 6's K1_GRAD_PATH_CASES).
    fwd = _forward_case(k1, ptxas, torch.Generator(device=DEVICE).manual_seed(12),
                        LEARN_DSM_BATCH, L, "bfloat16", 0)
    wall = time.perf_counter() - t_phase
    log(f"[ppft-learn] DSM step {summary['dsm_step_ms']:.2f} ms, update {update_s:.3f} s; the two "
        f"scripts {scripts_wall:.1f} s (limit {LEARN_PHASE_LIMIT_S:.0f} s), the phase with the "
        f"B={LEARN_DSM_BATCH} L={L} K1 timings {wall:.1f} s; {card}")
    return dict(dsm_launches=dsm["launches"], dsm_backwards=dsm["backwards"],
                check_launches=check_launches, ppft_launches=launches, ppft_backwards=ppft_backwards,
                fwd=fwd)


def _tp_case(k1, ptxas, gen, H, B, Lq, Lk, cp, dname, masked=0, tag="k1-tp"):
    """K1 at a tensor-parallel rank's H heads with the streamed pair bias
    (16 heads at model=2: route "tc16" in bf16, "tc16_f32" in f32; 8 heads
    at model=4: "tc8", "tc8_f32"): one counted launch against the plain
    version and against the CUDA-core design on the same inputs (each fatal
    beyond ``TOL``), then its time in turns with the CUDA-core design's,
    beside the plain version's and the bound."""
    import torch

    dtype = getattr(torch, dname)
    args = k1_inputs(B, Lk, dtype, gen, masked, H=H, cp=cp, Lq=Lq)
    route = k1.kernel_route(dtype, H, 16, cp, True)
    if route != TP_ROUTES[H][dname]:
        raise AssertionError(f"K1 at {H} heads, Cp={cp}, {dname} takes route {route!r}, not "
                             f"{TP_ROUTES[H][dname]!r}")
    before = dict(k1.launches_by_route)
    got = k1.ipa_attention(*args, **K1_KW)
    torch.cuda.synchronize()
    if k1.launches_by_route != {**before, route: before[route] + 1}:
        raise AssertionError(f"ipa_attention at {H} heads did not launch the {route!r} design once")
    want = k1.ipa_attention_plain(*args, **K1_KW)
    err, scale = max_err(got, want)
    tol = TOL[dname] * scale
    plain_ms = cuda_time_ms(lambda: k1.ipa_attention_plain(*args, **K1_KW), reps=5)
    bound_ms, bound_by, nbytes, ops = k1_bound(args, got, dname)
    res, detail = _timed_with_simt(k1, lambda: k1.ipa_attention(*args, **K1_KW), args, K1_KW,
                                   route, ptxas)
    log(f"[{tag}] {H} heads B={B} Lq={Lq} Lk={Lk} Cp={cp} {dname} masked_cols={masked}: "
        f"max_abs_err={err:.3e} (tol {tol:.3e}) {detail} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP; "
        f"{res['ms'] / bound_ms:.1f}x the bound) library_ms=null (no single PyTorch call "
        "computes this function)")
    if not (err <= tol and res["err_vs_prev"] <= tol):
        raise AssertionError(f"{route} disagrees with the plain version ({err:.3e}) or the "
                             f"CUDA-core design ({res['err_vs_prev']:.3e}) beyond {tol:.3e}")
    res.update(max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    return res


def phase_mesh_train(k1, ptxas, card):
    """(a) one DP and one TP f32 step against this process's step; (b) the
    train CLI's rank function at model=2, interrupted and resumed. One spawn
    of MESH_RANKS gloo ranks on the card. Returns the readings the kernels
    line carries."""
    from datetime import timedelta
    from functools import partial

    import numpy as np
    import torch

    from se3diff_torch.diffusion.denoise import SDEs
    from se3diff_torch.models import dig
    from se3diff_torch.parallel import programs, run_ranks
    from se3diff_torch.sampling.bundle import BIOEMU_V1_MODEL, BIOEMU_V1_SO3, load_bundle
    from se3diff_torch.sde.so3_sde import DiGSO3SDE
    from se3diff_torch.sde.vpsde import CosineVPSDE
    from se3diff_torch.training.dsm import draw_noise, dsm_denominator, dsm_loss, step_update
    from se3diff_torch.training.loop import TrainConfig, make_optimizer

    t_phase = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(19)
    heads = BIOEMU_V1_MODEL["num_heads"] // MESH_RANKS
    if heads != 16:
        raise AssertionError(f"a rank at model={MESH_RANKS} has {heads} heads, not 16")
    # K1 at a TP rank's heads at both of this phase's shapes: the forward in
    # turns with the CUDA-core design, then the gradients and the backward.
    h16 = {"f32": _tp_case(k1, ptxas, gen, 16, MESH_B, MESH_L, MESH_L, 256, "float32",
                           tag="mesh-k1"),
           "bf16": _tp_case(k1, ptxas, gen, 16, TRAIN_BATCH, 64, 64, 256, "bfloat16",
                            tag="mesh-k1")}
    bwd = {"f32": _grad_case(k1, gen, MESH_B, MESH_L, "float32", 0, H=heads),
           "bf16": _grad_case(k1, gen, TRAIN_BATCH, 64, "bfloat16", 0, H=heads)}

    # (a) This process's one-device f32 steps on the same weights, batch and
    # noise: on the whole batch, and with the gradient accumulated over the
    # data=2 ranks' two halves (the DP step's arithmetic, which it must equal).
    B, L = MESH_B, MESH_L
    batch = _numpy_batch(B, L, 19)
    so3 = dict(BIOEMU_V1_SO3, cache_dir=str(OUT / "so3_cache"))
    sdes = SDEs(pos=CosineVPSDE(), node_orientations=DiGSO3SDE(**so3, device=DEVICE))
    model = dig.init_weights(dig.DiGConditionalScoreModel(**BIOEMU_V1_MODEL),
                             torch.Generator().manual_seed(0))
    weights = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    b_dev = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
    noise = draw_noise(torch.Generator(device=DEVICE).manual_seed(19), b_dev, sdes)

    def one_process(halves):
        model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
        model.to(DEVICE).eval()
        opt = make_optimizer(TrainConfig(lr=MESH_LR), model.parameters())
        opt.zero_grad(set_to_none=True)
        loss = 0.0
        for b0, b1 in halves:
            part = dsm_loss(model, {k: v[b0:b1] for k, v in b_dev.items()},
                            type(noise)(*(x[b0:b1] for x in noise)), sdes,
                            denom=dsm_denominator(b_dev))
            part.backward()
            loss = loss + part.detach()
        step_update(model, opt, lr=MESH_LR, grad_clip=1.0)
        return (loss.item(), {k: v.cpu().numpy().copy() for k, v in model.state_dict().items()},
                {n: p.grad.cpu().numpy().copy() for n, p in model.named_parameters()})

    ref = {"whole batch": one_process([(0, B)]),
           "data=2 halves": one_process([(0, B // 2), (B // 2, B)])}
    del model, b_dev
    torch.cuda.empty_cache()
    noise_np = tuple(x.cpu().numpy() for x in noise)

    # (b) The train CLI's argv (--mesh is what the CLI reads; the rank function
    # is handed the axes).
    full, part = OUT / "mesh_full", OUT / "mesh_part"
    for d in (full, part):
        shutil.rmtree(d, ignore_errors=True)

    def argv(ckpt_dir, model=MESH_RANKS, steps=MESH_STEPS, ckpt_every=MESH_CKPT_EVERY,
             log_every=5):
        a = [x for traj, top in ENSEMBLES for x in ("--trajectory", str(REPO / traj),
                                                      "--topology", str(REPO / top))]
        return a + [
            "--bucket", "32", "--batch_size", str(TRAIN_BATCH), "--dtype", "bfloat16",
            "--steps", str(steps), "--ckpt_every", str(ckpt_every), "--log_every",
            str(log_every), "--ckpt_dir", str(ckpt_dir), "--embeds_backend", "dummy",
            "--cache_embeds_dir", str(OUT / "embeds"), "--so3_cache_dir", str(OUT / "so3_cache"),
            "--mesh", f"model={model}", "--device", "cuda",
        ]

    step = partial(programs.mesh_step, lr=MESH_LR, timed_steps=MESH_TIMED)
    args = (BIOEMU_V1_MODEL, weights, batch, noise_np, so3)
    steps = [
        (step, (MESH_RANKS, 1, *args)),
        (step, (1, MESH_RANKS, *args)),
        (programs.train_rank, (argv(full), 1, MESH_RANKS)),
        (programs.train_rank, (argv(part), 1, MESH_RANKS, MESH_STOP)),
        (programs.train_rank, (argv(part), 1, MESH_RANKS)),
    ]
    t0 = time.perf_counter()
    ranks = run_ranks(programs.in_turn, MESH_RANKS, [DEVICE + ":0"] * MESH_RANKS, args=(steps,),
                      timeout=900.0, group_timeout=timedelta(seconds=300))
    spawn_s = time.perf_counter() - t0
    log(f"[mesh-train] {MESH_RANKS} gloo ranks spawned on {DEVICE}:0 ran (a)-(b) in "
        f"{spawn_s:.1f} s with start-up")

    zero = dict.fromkeys(k1.launches_by_route, 0)
    whole_w = ref["whole batch"][1]
    largest_w = max(float(np.abs(w).max()) for w in whole_w.values() if w.size)

    def errors(o, want, grad_tol):
        # A first AdamW step moves a weight by lr g / (|g| + eps): where
        # rounding can flip a gradient's sign the weights may differ by up to
        # 2 lr. Held: the entries whose whole-batch gradient exceeds twice
        # the gradient tolerance of its tensor's largest entry.
        loss, w, g = want
        held = {k: np.abs(x) > 2 * grad_tol * np.abs(x).max() for k, x in g.items() if x.size}
        return (abs(o["loss"] - loss) / abs(loss),
                max(float(np.abs(o["weights"][k] - w[k]).max()) for k in held),
                max(float(np.abs(o["weights"][k] - w[k])[held[k]].max(initial=0.0)) for k in held),
                max(((float(np.abs(o["grads"][k] - g[k]).max() / np.abs(g[k]).max()), k)
                     for k in held)),
                sum(int(m.sum()) for m in held.values()), sum(m.size for m in held.values()))

    readings = {}
    for i, (name, route, bwd_route) in enumerate((("data=2", "tc_f32", "bwd_tc_f32"),
                                                  ("model=2", "tc16_f32", "bwd_tc16_f32"))):
        outs = [r[i] for r in ranks]
        o = outs[0]
        grad_tol = MESH_GRAD_TOL[name]
        same = all(np.array_equal(x[key][k], o[key][k]) for x in outs[1:]
                   for key in ("weights", "grads") for k in o[key])
        step_ms = float(np.median(o["step_ms"]))
        for r, x in enumerate(outs):
            log(f"[mesh-train] (a) {name} rank {r}: K1 launches by route {x['launches_by_route']}, "
                f"backward passes {x['backward_calls']} by route {x['backward_calls_by_route']} "
                f"(expected {N_LAYERS} each, on {route} and {bwd_route}); "
                f"step ms {', '.join(f'{t:.1f}' for t in x['step_ms'])}; all-reduces a step "
                f"{x['all_reduces']:.0f}, their wall with the wait for the other rank "
                f"{x['all_reduce_ms']:.1f} ms")
        loss_err, w_all, w_err, (g_err, g_key), n_held, n_all = errors(o, ref["whole batch"],
                                                                        grad_tol)
        log(f"[mesh-train] (a) {name}, f32 full width B={B} L={L}, one step against this "
            f"process's on the whole batch: loss {o['loss']:.6f} vs {ref['whole batch'][0]:.6f} "
            f"rel_err={loss_err:.2e} (tol {MESH_LOSS_TOL:.0e}); clipped gradients "
            f"max_rel_err={g_err:.2e} ({g_key}; tol {grad_tol:.0e} x each one's largest "
            f"entry); updated weights max_abs_err={w_err:.2e} on the {n_held} of {n_all} entries "
            f"whose gradient exceeds {2 * grad_tol:.0e} of its tensor's largest (tol "
            f"{MESH_WEIGHT_TOL * largest_w:.2e} = {MESH_WEIGHT_TOL:.0e} x the largest weight "
            f"{largest_w:.3f}), {w_all:.2e} on all (at most 2 lr = {2 * MESH_LR:.0e}); ranks' "
            f"weights and gradients equal: {same}; median step {step_ms:.1f} ms; {card}")
        ok = (loss_err <= MESH_LOSS_TOL and g_err <= grad_tol
              and w_err <= MESH_WEIGHT_TOL * largest_w and same)
        if name == "data=2":
            want_loss, want_w, want_g = ref["data=2 halves"]
            exact = (o["loss"] == want_loss
                     and all(np.array_equal(o["weights"][k], w) for k, w in want_w.items())
                     and all(np.array_equal(o["grads"][k], g) for k, g in want_g.items()))
            log(f"[mesh-train] (a) data=2 against this process's step with the gradient "
                f"accumulated over the ranks' two halves: loss, gradients and weights "
                + ("equal bit for bit" if exact else "DIFFER (expected bit for bit)"))
            ok = ok and exact
        if not ok:
            raise AssertionError(f"the {name} step disagrees with one process")
        for x in outs:
            if (x["launches_by_route"] != {**zero, route: N_LAYERS} or x["backward_calls"] != N_LAYERS
                    or x["backward_calls_by_route"] != only_bwd_routes(k1, **{bwd_route: N_LAYERS})):
                raise AssertionError(f"the {name} step launched K1 {x['launches_by_route']} "
                                     f"with backward passes {x['backward_calls_by_route']}")
        readings[name] = dict(step_ms=step_ms, all_reduce_ms=o["all_reduce_ms"],
                              launches=sum(x["launches_by_route"][route] for x in outs),
                              backwards=sum(x["backward_calls"] for x in outs),
                              bwd_route=bwd_route,
                              bwd_launches=sum(x["backward_calls_by_route"][bwd_route] for x in outs))

    # (b) The CLI's rank function: full run, interrupted run, resume.
    runs = [[r[j] for r in ranks] for j in (2, 3, 4)]
    expect = (N_LAYERS * MESH_STEPS, N_LAYERS * MESH_STOP, N_LAYERS * (MESH_STEPS - MESH_STOP))
    for label, run, n in zip(("10 steps", "interrupted at step 5", "resumed to 10"), runs, expect):
        for x in run:
            log(f"[mesh-train] (b) model={MESH_RANKS} bf16 B={TRAIN_BATCH} L=64, {label}, rank "
                f"{x['rank']}: {x['wall_s']:.1f} s with set-up; logged losses {x['history']}; K1 "
                f"launches by route {x['launches_by_route']}, backward passes "
                f"{x['backward_calls']} by route {x['backward_calls_by_route']} (expected {n} each, "
                f"on tc16 and bwd_tc16)")
            if (x["launches_by_route"] != {**zero, "tc16": n} or x["backward_calls"] != n
                    or x["backward_calls_by_route"] != only_bwd_routes(k1, bwd_tc16=n)):
                raise AssertionError(f"the CLI rank ({label}) launched K1 {x['launches_by_route']}")
    if not all(np.isfinite(x["history"]).all() for x in runs[0]):
        raise AssertionError("non-finite loss in the mesh run")
    with np.load(full / "params.npz") as a, np.load(part / "params.npz") as b:
        diffs = [k for k in a.files if a[k].tobytes() != b[k].tobytes()]
    log(f"[mesh-train] (b) interrupted at step {MESH_STOP} and resumed to {MESH_STEPS}: "
        + ("weights equal the uninterrupted run's bit for bit" if not diffs
           else f"{len(diffs)} tensors differ ({diffs[:3]})"))
    if diffs:
        raise AssertionError("the resumed mesh run differs from the uninterrupted one")
    bundle = load_bundle(full / "params.npz", device=DEVICE, dtype=torch.bfloat16,
                         so3_cache_dir=str(OUT / "so3_cache"))
    g = torch.Generator(device=DEVICE).manual_seed(4)
    with torch.inference_mode():
        pos, rot = bundle.model(
            torch.randn(2, 64, 3, generator=g, device=DEVICE),
            torch.eye(3, device=DEVICE).expand(2, 64, 3, 3), torch.full((2,), 0.5, device=DEVICE),
            torch.randn(2, 64, 384, generator=g, device=DEVICE),
            torch.randn(2, 64, 64, 128, generator=g, device=DEVICE) * 0.2,
        )
    if not (pos.shape == rot.shape == (2, 64, 3) and torch.isfinite(pos).all()
            and torch.isfinite(rot).all()):
        raise AssertionError("score evaluation from the mesh export failed")
    log(f"[mesh-train] (b) export {full.relative_to(REPO)}/params.npz + config.yaml loads through "
        f"load_bundle; one bf16 score evaluation from it is finite")
    del bundle, pos, rot
    torch.cuda.empty_cache()
    mesh4 = _mesh4(k1, ptxas, card, gen, step, args, ref["whole batch"], errors, largest_w,
                   argv(OUT / "mesh4_cli", model=MESH4_RANKS, steps=MESH4_CLI_STEPS,
                        ckpt_every=MESH4_CLI_STEPS, log_every=1))
    wall = time.perf_counter() - t_phase
    log(f"[mesh-train] phase wall {wall:.1f} s (the 2-rank spawn {spawn_s:.1f} s, the 4-rank "
        f"spawn {mesh4['spawn_s']:.1f} s); {card}")
    return dict(h16=h16, bwd=bwd, readings=readings, mesh4=mesh4,
                cli_launches=sum(x["launches_by_route"]["tc16"] for x in runs[0]),
                cli_backwards=sum(x["backward_calls"] for x in runs[0]),
                cli_bwd_launches=sum(x["backward_calls_by_route"]["bwd_tc16"] for x in runs[0]))


def _mesh4(k1, ptxas, card, gen, step, args, whole, errors, largest_w, cli_argv):
    """Phase 19's ``model=4`` spawn: K1 at a rank's 8 heads at both of its
    shapes against its plain version and the CUDA-core design, timed in
    turns with the latter, and its gradients and the backward kernel
    (``_grad_case``); then one spawn of MESH4_RANKS gloo ranks on the
    card: (a) the f32 mesh step against ``whole`` (this process's step on
    the whole batch), (b) the train CLI's rank function with ``cli_argv``.
    Every forward on "tc8_f32" / "tc8", none on "simt"; every backward on
    "bwd_tc8_f32" / "bwd_tc8", none on "torch". Returns the readings the
    kernels line carries."""
    from datetime import timedelta

    import numpy as np

    from se3diff_torch.parallel import programs, run_ranks

    h8 = {"f32": _tp_case(k1, ptxas, gen, 8, MESH_B, MESH_L, MESH_L, 256, "float32",
                          tag="mesh-k1"),
          "bf16": _tp_case(k1, ptxas, gen, 8, TRAIN_BATCH, 64, 64, 256, "bfloat16", tag="mesh-k1")}
    bwd = {"f32": _grad_case(k1, gen, MESH_B, MESH_L, "float32", 0, H=8),
           "bf16": _grad_case(k1, gen, TRAIN_BATCH, 64, "bfloat16", 0, H=8)}
    shutil.rmtree(cli_argv[cli_argv.index("--ckpt_dir") + 1], ignore_errors=True)
    steps = [(step, (1, MESH4_RANKS, *args)), (programs.train_rank, (cli_argv, 1, MESH4_RANKS))]
    t0 = time.perf_counter()
    ranks = run_ranks(programs.in_turn, MESH4_RANKS, [DEVICE + ":0"] * MESH4_RANKS, args=(steps,),
                      timeout=900.0, group_timeout=timedelta(seconds=300))
    spawn_s = time.perf_counter() - t0
    log(f"[mesh-train] {MESH4_RANKS} gloo ranks spawned on {DEVICE}:0 ran model={MESH4_RANKS} (a)-(b) "
        f"in {spawn_s:.1f} s with start-up")

    # (a) The f32 step at model=4.
    name, grad_tol = f"model={MESH4_RANKS}", MESH_GRAD_TOL[f"model={MESH4_RANKS}"]
    outs = [r[0] for r in ranks]
    o = outs[0]
    same = all(np.array_equal(x[key][k], o[key][k]) for x in outs[1:]
               for key in ("weights", "grads") for k in o[key])
    step_ms = float(np.median(o["step_ms"]))
    for r, x in enumerate(outs):
        log(f"[mesh-train] (a) {name} rank {r}: K1 launches by route {x['launches_by_route']}, "
            f"backward passes {x['backward_calls']} by route {x['backward_calls_by_route']} "
            f"(expected {N_LAYERS} each, on tc8_f32 and bwd_tc8_f32); step ms "
            f"{', '.join(f'{t:.1f}' for t in x['step_ms'])}; all-reduces a step "
            f"{x['all_reduces']:.0f}, their wall with the wait for the other ranks "
            f"{x['all_reduce_ms']:.1f} ms")
    loss_err, w_all, w_err, (g_err, g_key), n_held, n_all = errors(o, whole, grad_tol)
    log(f"[mesh-train] (a) {name}, f32 full width B={MESH_B} L={MESH_L}, one step against this "
        f"process's on the whole batch: loss {o['loss']:.6f} vs {whole[0]:.6f} "
        f"rel_err={loss_err:.2e} (tol {MESH_LOSS_TOL:.0e}); clipped gradients "
        f"max_rel_err={g_err:.2e} ({g_key}; tol {grad_tol:.0e} x each one's largest entry); "
        f"updated weights max_abs_err={w_err:.2e} on the {n_held} of {n_all} entries whose "
        f"gradient exceeds {2 * grad_tol:.0e} of its tensor's largest (tol "
        f"{MESH_WEIGHT_TOL * largest_w:.2e}), {w_all:.2e} on all; the {MESH4_RANKS} ranks' "
        f"weights and gradients equal: {same}; median step {step_ms:.1f} ms; {card}")
    if not (loss_err <= MESH_LOSS_TOL and g_err <= grad_tol
            and w_err <= MESH_WEIGHT_TOL * largest_w and same):
        raise AssertionError(f"the {name} step disagrees with one process")
    fwd_ok = lambda x, route, n: x["launches_by_route"] == only_routes(k1, **{route: n})
    bwd_ok = lambda x, route, n: (x["backward_calls"] == n and x["backward_calls_by_route"]
                                  == only_bwd_routes(k1, **{route: n}))
    for x in outs:
        if not (fwd_ok(x, "tc8_f32", N_LAYERS) and bwd_ok(x, "bwd_tc8_f32", N_LAYERS)):
            raise AssertionError(f"the {name} step launched K1 {x['launches_by_route']} with "
                                 f"backward passes {x['backward_calls_by_route']}")

    # (b) The CLI's rank function at model=4, bf16.
    n = N_LAYERS * MESH4_CLI_STEPS
    cli = [r[1] for r in ranks]
    for x in cli:
        log(f"[mesh-train] (b) {name} bf16 B={TRAIN_BATCH} L=64, {MESH4_CLI_STEPS} steps, rank "
            f"{x['rank']}: {x['wall_s']:.1f} s with set-up; logged losses {x['history']}; K1 "
            f"launches by route {x['launches_by_route']}, backward passes {x['backward_calls']} "
            f"by route {x['backward_calls_by_route']} (expected {n} each, on tc8 and bwd_tc8)")
        if not (fwd_ok(x, "tc8", n) and bwd_ok(x, "bwd_tc8", n)):
            raise AssertionError(f"the {name} CLI rank launched K1 {x['launches_by_route']} with "
                                 f"backward passes {x['backward_calls_by_route']}")
        if len(x["history"]) != MESH4_CLI_STEPS or not np.isfinite(x["history"]).all():
            raise AssertionError(f"the {name} CLI rank logged losses {x['history']}")
    return dict(h8=h8, bwd=bwd, spawn_s=spawn_s, step_ms=step_ms, all_reduce_ms=o["all_reduce_ms"],
                launches=sum(x["launches_by_route"]["tc8_f32"] for x in outs),
                backwards=sum(x["backward_calls"] for x in outs),
                bwd_launches=sum(x["backward_calls_by_route"]["bwd_tc8_f32"] for x in outs),
                cli_launches=sum(x["launches_by_route"]["tc8"] for x in cli),
                cli_backwards=sum(x["backward_calls"] for x in cli),
                cli_bwd_launches=sum(x["backward_calls_by_route"]["bwd_tc8"] for x in cli))


def _numpy_batch(B, L, seed):
    """A DSM batch of random frames near the identity and conditioning
    (phases 19 and 20)."""
    import numpy as np
    import torch

    from se3diff_torch.ops.so3 import rotvec_to_rotmat

    rng = np.random.default_rng(seed)
    return {
        "pos": (rng.standard_normal((B, L, 3)) * 0.5).astype(np.float32),
        "rot": rotvec_to_rotmat(torch.from_numpy(
            (rng.standard_normal((B, L, 3)) * 0.4).astype(np.float32))).numpy(),
        "single": (rng.standard_normal((B, L, 384)) * 0.5).astype(np.float32),
        "pair": (rng.standard_normal((B, L, L, 128)) * 0.2).astype(np.float32),
    }


def _rel_gap(got, want):
    """max |got - want| / max |want| over the entries of two dicts, and the key."""
    import numpy as np

    return max((float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30)), k)
               for k, w in want.items())


def phase_sp_pp_train(k1, ptxas, card):
    """(c) K1 at this slice's new shapes; (a) one SP and (b) PP steps and a
    PP forward on 2 gloo ranks sharing the card, against this process.
    Returns the readings the kernels line carries."""
    from datetime import timedelta
    from functools import partial

    import numpy as np
    import torch

    from se3diff_torch.diffusion.denoise import SDEs
    from se3diff_torch.models import dig
    from se3diff_torch.parallel import programs, run_ranks
    from se3diff_torch.sampling.bundle import BIOEMU_V1_MODEL, BIOEMU_V1_SO3
    from se3diff_torch.sde.so3_sde import DiGSO3SDE
    from se3diff_torch.sde.vpsde import CosineVPSDE
    from se3diff_torch.training.dsm import (
        DSMNoise, clip_by_global_norm, draw_noise, dsm_loss, step_update,
    )
    from se3diff_torch.training.loop import TrainConfig, make_optimizer

    t_phase = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(20)
    new = {case: _forward_case(k1, ptxas, gen, *case, 0) for case in NEW_K1_CASES}

    so3 = dict(BIOEMU_V1_SO3, cache_dir=str(OUT / "so3_cache"))
    sdes = SDEs(pos=CosineVPSDE(), node_orientations=DiGSO3SDE(**so3, device=DEVICE))
    init = dig.init_weights(dig.DiGConditionalScoreModel(**BIOEMU_V1_MODEL),
                            torch.Generator().manual_seed(0))
    weights = {k: v.numpy().copy() for k, v in init.state_dict().items()}
    del init

    def ref_model(dtype):
        m = dig.DiGConditionalScoreModel(**BIOEMU_V1_MODEL, dtype=dtype)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
        return m.to(DEVICE).eval()

    def on_device(batch):
        return {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}

    def one_step(batch, noise):
        """This process's f32 DSM loss and clipped gradients."""
        m = ref_model(torch.float32)
        loss = dsm_loss(m, on_device(batch), DSMNoise(*(torch.from_numpy(x).to(DEVICE)
                                                        for x in noise)), sdes)
        loss.backward()
        clip_by_global_norm([p.grad for p in m.parameters()], 1.0)
        return loss.item(), {n: p.grad.cpu().numpy() for n, p in m.named_parameters()}

    sp_batch, pp_batch = _numpy_batch(SPT_B, SPT_L, 20), _numpy_batch(PP_B, PP_L, 21)
    sp_noise, pp_noise = (
        tuple(x.cpu().numpy() for x in draw_noise(torch.Generator(device=DEVICE).manual_seed(seed),
                                                  on_device(b), sdes))
        for seed, b in ((20, sp_batch), (21, pp_batch)))
    pp_inputs = (pp_batch["pos"], pp_batch["rot"], pp_noise[0], pp_batch["single"],
                 pp_batch["pair"])
    ref = {"sp": one_step(sp_batch, sp_noise), "pp": one_step(pp_batch, pp_noise)}
    with torch.inference_mode():
        ref["pp_score"] = [o.cpu().numpy() for o in ref_model(torch.float32)(
            *(torch.from_numpy(x).to(DEVICE) for x in pp_inputs))]
    m16 = ref_model(torch.bfloat16)
    opt = make_optimizer(TrainConfig(lr=MESH_LR), m16.parameters())
    b16, ref["bf16"] = on_device(pp_batch), []
    for i in range(PP_BF16_STEPS):
        nz = draw_noise(torch.Generator(device=DEVICE).manual_seed(PP_BF16_SEED + i), b16, sdes)
        loss = dsm_loss(m16, b16, nz, sdes)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        step_update(m16, opt, lr=MESH_LR, grad_clip=1.0)
        ref["bf16"].append(loss.item())
    del m16, opt, b16
    torch.cuda.empty_cache()

    pp_step = partial(programs.pp_step, n_microbatches=PP_M, lr=MESH_LR)
    grid = (1, PP_PIPE, BIOEMU_V1_MODEL, weights)
    steps = [
        (partial(programs.sp_step, lr=MESH_LR), (BIOEMU_V1_MODEL, weights, sp_batch, sp_noise, so3)),
        (programs.pp_score, (*grid, pp_inputs, PP_M)),
        (pp_step, (*grid, pp_batch, pp_noise, so3)),
        (partial(pp_step, dtype="bfloat16", steps=PP_BF16_STEPS, seed=PP_BF16_SEED),
         (*grid, pp_batch, None, so3)),
    ]
    t0 = time.perf_counter()
    ranks = run_ranks(programs.in_turn, 2, [DEVICE + ":0"] * 2, args=(steps,),
                      timeout=900.0, group_timeout=timedelta(seconds=300))
    spawn_s = time.perf_counter() - t0
    log(f"[sp-pp-train] 2 gloo ranks spawned on {DEVICE}:0 ran (a)-(b) in {spawn_s:.1f} s with "
        "start-up")
    zero = dict.fromkeys(k1.launches_by_route, 0)
    layers_a_stage = N_LAYERS // PP_PIPE

    # (a) SP: each rank's 150 rows, the full gradient on every rank.
    sp = [r[0] for r in ranks]
    loss, grads = ref["sp"]
    loss_err = abs(sp[0]["loss"] - loss) / abs(loss)
    g_err, g_key = _rel_gap(sp[0]["grads"], grads)
    same = all(np.array_equal(x["grads"][k], sp[0]["grads"][k]) for x in sp[1:] for k in grads)
    for x in sp:
        log(f"[sp-pp-train] (a) SP rank rows {x['rows']}: K1 launches by route "
            f"{x['launches_by_route']}, backward passes {x['backward_calls']} by route "
            f"{x['backward_calls_by_route']} (expected {N_LAYERS} each, on tc_f32 and bwd_tc_f32)")
    log(f"[sp-pp-train] (a) SP f32 full width B={SPT_B} L={SPT_L}, one step against this "
        f"process's: loss {sp[0]['loss']:.6f} vs {loss:.6f} rel_err={loss_err:.2e} (tol "
        f"{SPPP_LOSS_TOL:.0e}); clipped gradients max_rel_err={g_err:.2e} ({g_key}; tol "
        f"{SPPP_TOL:.0e} x each one's largest entry); ranks' gradients equal: {same}; {card}")
    if not (loss_err <= SPPP_LOSS_TOL and g_err <= SPPP_TOL and same):
        raise AssertionError("the SP step disagrees with one process")
    for x in sp:
        if (x["launches_by_route"] != {**zero, "tc_f32": N_LAYERS}
                or x["backward_calls"] != N_LAYERS
                or x["backward_calls_by_route"] != only_bwd_routes(k1, bwd_tc_f32=N_LAYERS)):
            raise AssertionError(f"the SP step launched K1 {x['launches_by_route']} with "
                                 f"{x['backward_calls']} backward passes")

    # (b) PP: the forward, the f32 step, the bf16 steps.
    fwd = [r[1] for r in ranks]
    f_err = max(float(np.abs(x[key] - w).max() / np.abs(w).max())
                for x in fwd for key, w in zip(("pos", "rot"), ref["pp_score"]))
    log(f"[sp-pp-train] (b) PP pipe={PP_PIPE} ({layers_a_stage} layers a stage) M={PP_M} f32 "
        f"B={PP_B} L={PP_L}: forward against this process's score max_rel_err={f_err:.2e} (tol "
        f"{SPPP_TOL:.0e} x the largest output); K1 launches by route "
        + ", ".join(str(x["launches_by_route"]) for x in fwd)
        + f" (expected {PP_M * layers_a_stage} a rank: {PP_M} microbatches x {layers_a_stage} "
        "layers, on tc_f32)")
    if f_err > SPPP_TOL or any(x["launches_by_route"] != {**zero, "tc_f32": PP_M * layers_a_stage}
                               for x in fwd):
        raise AssertionError("the PP forward disagrees with one process or launched K1 otherwise")
    pps = [r[2] for r in ranks]
    merged = {}
    for x in pps:
        for k, g in x["grads"].items():
            if k in merged and not np.array_equal(merged[k], g):
                raise AssertionError(f"the stages' gradients of the replicated {k} differ")
            merged[k] = g
    loss, grads = ref["pp"]
    loss_err = abs(pps[0]["losses"][0] - loss) / abs(loss)
    if set(merged) != set(grads):
        raise AssertionError("the stages do not cover every parameter's gradient")
    g_err, g_key = _rel_gap(merged, grads)
    n_step = 2 * PP_M * layers_a_stage
    for x in pps:
        log(f"[sp-pp-train] (b) PP step stage {x['stage']}: K1 launches by route "
            f"{x['launches_by_route']}, backward passes {x['backward_calls']} by route "
            f"{x['backward_calls_by_route']} (expected {n_step} forward launches, the backward's "
            f"recompute included, on tc_f32, and {n_step // 2} backward passes on bwd_tc_f32)")
    log(f"[sp-pp-train] (b) PP f32 step against this process's: loss {pps[0]['losses'][0]:.6f} vs "
        f"{loss:.6f} rel_err={loss_err:.2e} (tol {SPPP_LOSS_TOL:.0e}); clipped gradients "
        f"max_rel_err={g_err:.2e} ({g_key}; tol {SPPP_TOL:.0e} x each one's largest entry); {card}")
    if not (loss_err <= SPPP_LOSS_TOL and g_err <= SPPP_TOL):
        raise AssertionError("the PP step disagrees with one process")
    for x in pps:
        if (x["launches_by_route"] != {**zero, "tc_f32": n_step}
                or x["backward_calls"] != n_step // 2
                or x["backward_calls_by_route"] != only_bwd_routes(k1, bwd_tc_f32=n_step // 2)):
            raise AssertionError(f"the PP step launched K1 {x['launches_by_route']}")
    bf = [r[3] for r in ranks]
    gaps = [abs(a - b) / abs(b) for a, b in zip(bf[0]["losses"], ref["bf16"])]
    log(f"[sp-pp-train] (b) PP bf16, {PP_BF16_STEPS} steps with AdamW: losses "
        + ", ".join(f"{a:.5f}" for a in bf[0]["losses"]) + " vs this process's "
        + ", ".join(f"{b:.5f}" for b in ref["bf16"])
        + f"; largest gap {max(gaps):.2e} relative (tol {PP_BF16_RTOL:.0e}); first step's K1 "
        f"launches by route {bf[0]['launches_by_route']}, backward passes "
        f"{bf[0]['backward_calls']} a rank by route {bf[0]['backward_calls_by_route']} (expected "
        f"{n_step} on tc, {n_step // 2} on bwd_tc)")
    if (max(gaps) > PP_BF16_RTOL or not all(x["losses"] == bf[0]["losses"] for x in bf)
            or any(x["launches_by_route"] != {**zero, "tc": n_step} for x in bf)
            or any(x["backward_calls_by_route"] != only_bwd_routes(k1, bwd_tc=n_step // 2)
                   for x in bf)
            or not np.isfinite(bf[0]["losses"]).all()):
        raise AssertionError("the PP bf16 steps disagree with one process")
    wall = time.perf_counter() - t_phase
    log(f"[sp-pp-train] phase wall {wall:.1f} s (the spawn {spawn_s:.1f} s); {card}")
    return dict(new=new,
                sp_launches=sum(x["launches_by_route"]["tc_f32"] for x in sp),
                sp_backwards=sum(x["backward_calls"] for x in sp),
                pp_launches=sum(x["launches_by_route"]["tc_f32"] for x in fwd + pps),
                pp_backwards=sum(x["backward_calls"] for x in pps),
                pp_bf16_launches=sum(x["launches_by_route"]["tc"] for x in bf),
                pp_bf16_backwards=sum(x["backward_calls_by_route"]["bwd_tc"] for x in bf))


def _analytic_model(sdes):
    """Closed-form scores (tests/test_denoise.py's model): positions from
    N(1.5, 0.5^2), rotations at the identity."""
    import torch

    from se3diff_torch.ops.so3 import rotmat_to_rotvec
    from se3diff_torch.sde.base import bcast_right

    def model_fn(pos, rot, t):
        alpha = bcast_right(sdes.pos._marginal_mean_coeff(t), pos)
        var = alpha**2 * 0.25 + 1.0 - alpha**2
        pos_raw = -(pos - alpha * 1.5) / var * torch.sqrt(1.0 - alpha**2)
        score_rot = sdes.node_orientations.compute_score(rotmat_to_rotvec(rot), t, method="table")
        return pos_raw, score_rot / bcast_right(sdes.node_orientations.get_score_scaling(t),
                                                score_rot)

    return model_fn


def _gaps(a, b):
    """Largest position gap and geodesic rotation gap (rad) of two samples."""
    import torch

    rel = torch.einsum("...ji,...jk->...ik", a[1].double(), b[1].double())
    cos = ((rel.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2).clamp(-1.0, 1.0)
    return (a[0] - b[0]).abs().max().item(), torch.arccos(cos).max().item()


def phase_picard(k1, card):
    """``parallel_picard_em`` against the sequential ``euler_maruyama`` on the
    card; returns the walls and launch counts for the kernels line."""
    import numpy as np
    import torch

    from se3diff_torch.diffusion import denoise
    from se3diff_torch.models import dig
    from se3diff_torch.sampling.bundle import BIOEMU_V1_MODEL, BIOEMU_V1_SO3
    from se3diff_torch.sde.so3_sde import DiGSO3SDE
    from se3diff_torch.sde.vpsde import CosineVPSDE

    t_phase = time.perf_counter()
    L = PICARD_L
    sdes = denoise.SDEs(pos=CosineVPSDE(), node_orientations=DiGSO3SDE(
        **BIOEMU_V1_SO3, cache_dir=str(OUT / "so3_cache"), device=DEVICE))
    rng = np.random.default_rng(0)
    single = torch.from_numpy((rng.standard_normal((1, L, 384)) * 0.5).astype(np.float32))
    pair = torch.from_numpy((rng.standard_normal((1, L, L, 128)) * 0.2).astype(np.float32))
    single, pair = single.to(DEVICE), pair.to(DEVICE)

    def sampler(model, fn, eval_batch, steps, **kw):
        with torch.inference_mode():
            cache = model.embed_conditioning(single.expand(eval_batch, -1, -1),
                                             pair.expand(eval_batch, -1, -1, -1))

        def run(seed, steps=steps):
            gen = torch.Generator(device=DEVICE).manual_seed(seed)
            with torch.inference_mode():
                out = fn(gen, sdes, lambda p, r, t: model.score_from_cache(p, r, t, cache), 1, L,
                         num_steps=steps, **kw)
            torch.cuda.synchronize()
            return out
        return run

    def walls(run, route, launches):
        """Median wall of PICARD_REPS runs; K1's launches in the first, checked."""
        times = []
        for i in range(PICARD_REPS):
            _reset_k1(k1)
            t0 = time.perf_counter()
            out = run(i + 1)
            times.append(time.perf_counter() - t0)
            if i == 0 and k1.launches_by_route != only_routes(k1, **{route: launches}):
                raise AssertionError(f"expected {launches} K1 launches on {route}, got "
                                     f"{k1.launches_by_route}")
            if not (torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all()):
                raise AssertionError("non-finite Picard or sequential sample")
        return float(np.median(times)), times

    model = dig.init_weights(dig.DiGConditionalScoreModel(**BIOEMU_V1_MODEL, dtype=torch.bfloat16),
                             torch.Generator().manual_seed(0)).to(DEVICE).eval()
    seq = sampler(model, denoise.euler_maruyama, 1, PICARD_STEPS)
    seq(0, steps=5)                                   # warm the B=1 shapes
    res = {"seq": walls(seq, "tc", N_LAYERS * PICARD_STEPS)}
    for sweeps in PICARD_SWEEPS:
        pic = sampler(model, denoise.parallel_picard_em, PICARD_STEPS, PICARD_STEPS,
                      num_sweeps=sweeps)
        if sweeps == PICARD_SWEEPS[0]:
            pic(0)                                    # warm the B=200 shapes
        res[sweeps] = walls(pic, "tc", N_LAYERS * sweeps)
        del pic
    t_seq = res["seq"][0]
    log(f"[picard] bf16 full width B=1 L={L} em-{PICARD_STEPS}: sequential euler_maruyama "
        f"{t_seq:.3f} s (median of {PICARD_REPS}: "
        + ", ".join(f"{t:.3f}" for t in res["seq"][1]) + f"; {N_LAYERS * PICARD_STEPS} K1 launches "
        "at B=1 on tc); " + "; ".join(
            f"Picard {s} sweeps {res[s][0]:.3f} s (" + ", ".join(f"{t:.3f}" for t in res[s][1])
            + f"; {N_LAYERS * s} launches at B={PICARD_STEPS} on tc), {res[s][0] / t_seq:.3f}x the "
            "sequential wall" for s in PICARD_SWEEPS) + f"; {card}")
    del model
    torch.cuda.empty_cache()

    # f32 em-30: 30 sweeps against the sequential run on the same generator.
    model = dig.init_weights(dig.DiGConditionalScoreModel(**BIOEMU_V1_MODEL),
                             torch.Generator().manual_seed(0)).to(DEVICE).eval()
    n = PICARD_F32_STEPS
    _reset_k1(k1)
    a = sampler(model, denoise.euler_maruyama, 1, n)(7)
    seq_routes = dict(k1.launches_by_route)
    _reset_k1(k1)
    b = sampler(model, denoise.parallel_picard_em, n, n, num_sweeps=n)(7)
    pic_routes = dict(k1.launches_by_route)
    pos_gap, rot_gap = _gaps(a, b)
    log(f"[picard] f32 em-{n} against {n} sweeps, same generator: largest position gap "
        f"{pos_gap:.3e} nm, rotation gap {rot_gap:.3e} rad (a reading: batch-{n} and batch-1 "
        f"GEMMs round apart); K1 launches sequential {seq_routes}, Picard {pic_routes}")
    if (seq_routes != only_routes(k1, tc_f32=N_LAYERS * n)
            or pic_routes != only_routes(k1, tc_f32=N_LAYERS * n)):
        raise AssertionError("the f32 em-30 runs launched K1 otherwise")
    del model
    torch.cuda.empty_cache()

    # The closed-form model: 8 sweeps equal 8 sequential steps (a gate).
    sdes = denoise.SDEs(pos=CosineVPSDE(), node_orientations=DiGSO3SDE(
        **PICARD_ANALYTIC_SO3, cache_dir=str(OUT / "so3_cache"), device=DEVICE))
    model_fn = _analytic_model(sdes)
    gen = lambda: torch.Generator(device=DEVICE).manual_seed(11)  # noqa: E731
    a = denoise.euler_maruyama(gen(), sdes, model_fn, 16, 3, num_steps=8)
    b = denoise.parallel_picard_em(gen(), sdes, model_fn, 16, 3, num_steps=8, num_sweeps=8)
    pos_gap_a, rot_gap_a = _gaps(a, b)
    log(f"[picard] closed-form model, 8 sweeps against euler_maruyama-8 (B=16 L=3) on the card: "
        f"position gap {pos_gap_a:.3e} (tol {PICARD_POS_ATOL:.0e}), rotation gap {rot_gap_a:.3e} "
        f"rad (tol {PICARD_ROT_RAD:.0e})")
    if not (pos_gap_a <= PICARD_POS_ATOL and rot_gap_a < PICARD_ROT_RAD):
        raise AssertionError("Picard with as many sweeps as steps differs from euler_maruyama")
    wall = time.perf_counter() - t_phase
    log(f"[picard] phase wall {wall:.1f} s; {card}")
    return dict(seq_s=t_seq, walls={s: res[s][0] for s in PICARD_SWEEPS},
                launches={s: N_LAYERS * s for s in PICARD_SWEEPS}, f32_launches=N_LAYERS * n,
                f32_gaps=(pos_gap, rot_gap))


def _load_example(name):
    """``examples/{name}.py`` as a module (examples/ is not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bench_eval(samples, names, out, *flags):
    """``python -m se3diff_torch.benchmarks eval`` on ``samples`` as a child
    process on one core, its log in ``out``.log; returns the process, whose
    ``end`` a waiting thread stamps."""
    import os
    import threading

    out.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "se3diff_torch.benchmarks", "eval", *map(str, samples),
           "--benchmarks", *names, "--output_dir", str(out), "--no_plots", *flags]
    logf = open(out.with_suffix(".log"), "w")
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=str(REPO))
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=logf, stderr=subprocess.STDOUT, env=env)
    proc.start, proc.end, proc.logf = time.perf_counter(), None, logf

    def wait():
        proc.wait()
        proc.end = time.perf_counter()

    proc.waiter = threading.Thread(target=wait, daemon=True)
    proc.waiter.start()
    return proc


def _bench_join(proc, what):
    """Wait for an eval child; fatal unless it exited 0. Returns its wall."""
    proc.waiter.join(timeout=BENCH_EVAL_TIMEOUT_S)
    if proc.end is None:
        proc.kill()
        raise AssertionError(f"{what}: the benchmark CLI did not finish in {BENCH_EVAL_TIMEOUT_S} s")
    proc.logf.close()
    if proc.returncode != 0:
        tail = Path(proc.logf.name).read_text()[-3000:]
        raise AssertionError(f"{what}: the benchmark CLI exited {proc.returncode}:\n{tail}")
    return proc.end - proc.start


def _finite_or_nan(values):
    import math

    return all(isinstance(v, float) and (math.isfinite(v) or math.isnan(v)) for v in values)


def _host_call_ms(fn, calls=200):
    """The host's wall a call of ``fn()`` over ``calls`` calls enqueued back
    to back (the device keeps up with short kernels), ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def _simt4_case(k1, gen):
    """K1 at the training example's shape on the card (B=8, L=8, 4 heads of
    16, Cp=16, f32, streamed pair bias: the "simt" design) against its plain
    version (fatal beyond ``TOL``), with its time, the plain version's and
    the bound; beside it the launch floor: an empty kernel's device time
    back to back (``torch.cuda._sleep(0)``), and the host's wall a call of
    the wrapper and of the empty kernel."""
    import torch

    B, L, H, cp = BENCH_SIMT4_SHAPE
    args = k1_inputs(B, L, torch.float32, gen, H=H, cp=cp)
    route = k1.kernel_route(torch.float32, H, 16, cp, True)
    if route != "simt":
        raise AssertionError(f"K1 at the training example's shape takes route {route!r}, not 'simt'")
    before = dict(k1.launches_by_route)
    got = k1.ipa_attention(*args, **K1_KW)
    torch.cuda.synchronize()
    if k1.launches_by_route != {**before, route: before[route] + 1}:
        raise AssertionError("ipa_attention at 4 heads did not launch the 'simt' design once")
    want = k1.ipa_attention_plain(*args, **K1_KW)
    err, scale = max_err(got, want)
    tol = TOL["float32"] * scale
    ms = cuda_time_ms(lambda: k1.ipa_attention(*args, **K1_KW), reps=20)
    plain_ms = cuda_time_ms(lambda: k1.ipa_attention_plain(*args, **K1_KW), reps=5)
    bound_ms, bound_by, nbytes, ops = k1_bound(args, got, "float32")
    empty_ms = cuda_time_ms(lambda: torch.cuda._sleep(0), reps=20)
    host_ms = _host_call_ms(lambda: k1._launch_design("simt", *args, **K1_KW))
    empty_host_ms = _host_call_ms(lambda: torch.cuda._sleep(0))
    log(f"[bench-k1] 4 heads B={B} L={L} Cp={cp} f32 streamed (the training example's shape): "
        f"max_abs_err={err:.3e} (tol {tol:.3e}) route {route} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_ms:.5f} ({bound_by}; {nbytes / 1e3:.1f} kB, {ops / 1e6:.2f} MFLOP; "
        f"{ms / bound_ms:.0f}x the bound) library_ms=null (no single PyTorch call computes this "
        f"function); an empty kernel back to back {empty_ms:.4f} ms on the device; the host's wall "
        f"a call, enqueued back to back: the wrapper {host_ms:.4f} ms, the empty kernel "
        f"{empty_host_ms:.4f} ms")
    if not err <= tol:
        raise AssertionError(f"the simt design disagrees with its plain version: {err} > {tol}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                design=route, empty_kernel_ms=empty_ms, host_call_ms=host_ms,
                empty_kernel_host_ms=empty_host_ms)


def phase_bench(k1, ptxas, card):
    """Phase 22: the benchmarks. First K1 at the shapes (b) and (d) give it,
    each against its plain version. (b) The sample CLI at bioemu-v1.0 widths
    (seed 0, f32, dpm_2m-30) for two benchmark test cases, 10 samples each
    (240 "tc_f32" launches a run), scored by the benchmark CLI. (c) A profile
    of one score evaluation at B=40 L=100 bf16 through ``utils.profiling``:
    K1's "tc" kernel 8 times. (d) ``examples/torch_train_from_scratch.py``
    at 500 steps on the card: the samples' mean pairwise distance at most
    halfway from the prior's to the data's. (a) Then, with the host idle,
    the benchmark CLI on the reference's fixture, one child process a
    benchmark, all at once: exit 0, every benchmark in its
    ``benchmark_metrics.json`` with its output files, and the reference's
    recorded ood60 values. Returns the kernels line's readings."""
    import importlib.util
    import json as json_

    import torch

    from se3diff_torch import sample as sample_cli
    from se3diff_torch.benchmarks import align
    from se3diff_torch.benchmarks.core import ALL_BENCHMARKS, Benchmark, rows_where
    from se3diff_torch.benchmarks.multiconf import MetricType, coverage, evaluate_multiconf, k_recall
    from se3diff_torch.benchmarks.samples import IndexedSamples, find_samples_in_dir
    from se3diff_torch.models import dig
    from se3diff_torch.sampling.bundle import BIOEMU_V1_MODEL
    from se3diff_torch.utils.profiling import format_device_profile, profile_device

    t_phase = time.perf_counter()
    root = OUT / "bench"
    shutil.rmtree(root, ignore_errors=True)
    fixture = REPO / BENCH_FIXTURE

    native = align._load_tmlib() is not None
    log(f"[bench] native TM-score library loaded: {native}")
    if not native:
        raise AssertionError("native/libtmscore.so did not load: the benchmarks would run on numpy")

    # K1 at (b)'s and (d)'s shapes, timed while the host runs nothing else.
    gen = torch.Generator(device=DEVICE).manual_seed(22)
    sample_cases = {case: _forward_case(k1, ptxas, gen, *case, 0) for case in BENCH_K1_CASES}
    simt4 = _simt4_case(k1, gen)

    # (b) The sample CLI for two test cases, then the benchmark CLI on them.
    samples_root = root / "samples"
    sample_walls, sample_launches = {}, {}
    for bm_name, tc in BENCH_CASES.items():
        seq = rows_where(Benchmark(bm_name).metadata, "test_case", tc)[0]["sequence"]
        if (BENCH_SAMPLES, len(seq), "float32") not in sample_cases:
            raise AssertionError(f"{tc}'s length {len(seq)} is not a K1 case checked above")
        argv = ["--sequence", seq, "--num_samples", str(BENCH_SAMPLES), "--output_dir",
                str(samples_root / tc), "--denoiser", "dpm_2m", "--embeds_backend", "dummy",
                "--cache_embeds_dir", str(OUT / "embeds"), "--no-filter_samples", "--device", DEVICE]
        _reset_k1(k1)
        t0 = time.perf_counter()
        sample_cli.main(argv)
        torch.cuda.synchronize()
        sample_walls[tc] = time.perf_counter() - t0
        launches, routes = k1.launches, dict(k1.launches_by_route)
        expect = N_LAYERS * BENCH_STEPS
        log(f"[bench] (b) sample CLI {bm_name} {tc} (L={len(seq)}): {BENCH_SAMPLES} samples, f32, "
            f"dpm_2m-{BENCH_STEPS}, seed-0 bioemu-v1.0 weights: wall {sample_walls[tc]:.2f} s with "
            f"set-up; ipa_attention launches {launches} (expected {expect}), by route {routes}")
        if launches != expect or routes != only_routes(k1, tc_f32=expect):
            raise AssertionError(f"the sample CLI for {tc} launched K1 {launches} times ({routes}), "
                                 f"expected {expect}, all on the f32 tensor-core route")
        sample_launches[tc] = launches
    found = find_samples_in_dir(samples_root)
    for bm_name, tc in BENCH_CASES.items():
        cases = IndexedSamples.from_benchmark(Benchmark(bm_name), found).test_case_to_sequencesamples
        if tc not in cases:
            raise AssertionError(f"{tc}'s samples were not found by sequence for {bm_name}: {list(cases)}")
    scored = _bench_eval([samples_root], list(BENCH_CASES), root / "scored", "--skip_filtering")
    score_wall = _bench_join(scored, "scoring the port's samples")
    metrics = json_.loads((root / "scored" / "benchmark_metrics.json").read_text())
    for bm_name in BENCH_CASES:
        if bm_name not in metrics or not _finite_or_nan(list(metrics[bm_name].values())):
            raise AssertionError(f"{bm_name} of the port's samples is missing or not finite: {metrics}")
    log(f"[bench] (b) benchmark CLI on the port's samples (--skip_filtering: random weights give "
        f"unphysical frames): wall {score_wall:.2f} s; "
        + "; ".join(f"{k}: " + ", ".join(f"{m} {v:.4g}" for m, v in vals.items())
                    for k, vals in metrics.items()))

    # (c) One score evaluation at B=40 L=100 bf16 under the profiler.
    B, L = BENCH_PROFILE
    model = dig.DiGConditionalScoreModel(**BIOEMU_V1_MODEL, dtype=torch.bfloat16)
    dig.init_weights(model, torch.Generator().manual_seed(0)).to(DEVICE).eval()
    g = torch.Generator(device=DEVICE).manual_seed(3)
    pos = torch.randn(B, L, 3, generator=g, device=DEVICE)
    rot = torch.linalg.qr(torch.randn(B, L, 3, 3, generator=g, device=DEVICE))[0]
    t = torch.full((B,), 0.5, device=DEVICE)
    single = torch.randn(B, L, 384, generator=g, device=DEVICE) * 0.5
    pair = torch.randn(B, L, L, 128, generator=g, device=DEVICE) * 0.2

    def evaluation():
        with torch.no_grad():
            return model(pos, rot, t, single, pair)

    evaluation()
    torch.cuda.synchronize()
    _reset_k1(k1)
    prof = profile_device(evaluation, device=DEVICE, with_stack=True)
    tc_rows = [r for r in prof.rows if "ipa_attention_tc_kernel" in r.name]
    log(f"[bench] (c) one score evaluation B={B} L={L} bf16 through utils.profiling: wall "
        f"{prof.wall_ms:.2f} ms under the profiler, {prof.count} kernels, {prof.total_ms:.2f} ms of "
        f"device time; K1 launches {dict(k1.launches_by_route)}\n" + format_device_profile(prof.rows, 12))
    if len(tc_rows) != 1 or tc_rows[0].count != N_LAYERS or k1.launches_by_route["tc"] != N_LAYERS:
        raise AssertionError(f"the profile holds K1's tc kernel as {[(r.name, r.count) for r in tc_rows]}, "
                             f"expected one row of {N_LAYERS}")
    profile_launches = k1.launches_by_route["tc"]
    del model

    # (d) The known-answer training example on the card.
    example = _load_example("torch_train_from_scratch")
    _reset_k1(k1)
    t0 = time.perf_counter()
    res = example.main(["--steps", str(BENCH_TRAIN_STEPS), "--device", DEVICE,
                        "--ckpt_dir", str(root / "train_example")])
    train_wall = time.perf_counter() - t0
    launches, routes, backwards = k1.launches, dict(k1.launches_by_route), k1.backward_calls
    layers = res["model"]["num_layers"]
    expect = layers * (BENCH_TRAIN_STEPS + example.SAMPLE_STEPS)
    halfway = (res["d_prior"] + res["d_data"]) / 2
    log(f"[bench] (d) examples/torch_train_from_scratch.py --steps {BENCH_TRAIN_STEPS} on the card, "
        f"model {res['model']}: loss {res['history'][0]:.4f} -> {res['history'][-1]:.4f}, training "
        f"{res['train_s']:.2f} s, sampling ({example.SAMPLE_STEPS} EM steps) {res['sample_s']:.2f} s, "
        f"wall {train_wall:.2f} s; mean pairwise distance: prior {res['d_prior']:.4f}, samples "
        f"{res['d_model']:.4f}, data {res['d_data']:.4f} (halfway {halfway:.4f}); K1 launches "
        f"{launches} (expected {expect}), by route {routes}, backward passes {backwards} "
        f"(expected {layers * BENCH_TRAIN_STEPS})")
    if launches != expect or routes != only_routes(k1, simt=expect) or backwards != layers * BENCH_TRAIN_STEPS:
        raise AssertionError("the training example's K1 launches or backward passes are not the expected counts")
    if not res["d_model"] <= halfway:
        raise AssertionError(f"the samples' mean pairwise distance {res['d_model']:.4f} is not at most "
                             f"halfway ({halfway:.4f}) from the prior's to the data's")

    # (a) Every benchmark by the CLI on its fixture directory, with filtering.
    # The fixture holds no multiconf_oodval samples: that run reads the whole
    # fixture and must skip the benchmark, as the reference's CLI does.
    procs = {}
    for bm in ALL_BENCHMARKS:
        d = fixture / bm.value
        procs[bm.value] = _bench_eval([d if d.is_dir() else fixture], [bm.value],
                                      root / "fixture" / bm.value)
    log(f"[bench] (a) {len(procs)} benchmark CLI processes started on {BENCH_FIXTURE} (filtering on, "
        f"one core each)")
    h5 = importlib.util.find_spec("h5py") is not None
    walls = {}
    for name, proc in procs.items():
        walls[name] = _bench_join(proc, name)
        out = root / "fixture" / name
        got = json_.loads((out / "benchmark_metrics.json").read_text())
        if name == Benchmark.MULTICONF_OODVAL.value:
            if got or "Skipping multiconf_oodval" not in Path(proc.logf.name).read_text():
                raise AssertionError(f"multiconf_oodval has no fixture samples, yet the CLI gave {got}")
            continue
        files = BENCH_FILES.get(name, BENCH_FILES["multiconf"]) + (
            ["results.h5"] if h5 and name not in BENCH_FILES else [])
        missing = [f for f in files + ["filter_statistics.json"] if not (out / name / f).exists()]
        if name not in got or missing or not _finite_or_nan(list(got[name].values())):
            raise AssertionError(f"{name}: metrics {got}, missing files {missing}")
    res_ood = evaluate_multiconf(
        IndexedSamples.from_benchmark(Benchmark.MULTICONF_OOD60,
                                      find_samples_in_dir(fixture / "multiconf_ood60")),
        references_dir=str(Path(Benchmark.MULTICONF_OOD60.asset_dir) / "reference"),
        metric_types=[MetricType.RMSD],
        references_localresidinfo_dir=str(Path(Benchmark.MULTICONF_OOD60.asset_dir) / "local_residinfo"),
    )
    rmsd = {tc: e.metrics_against_references[MetricType.RMSD] for tc, e in res_ood.items()}
    cov = float(coverage(rmsd, MetricType.RMSD)[1][-1])
    recall = k_recall(rmsd, MetricType.RMSD, k=1)["E1C7U0"]
    log("[bench] (a) benchmark CLI on the reference's fixture, walls (s, the seven at once): "
        + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
        + f"; results.h5 written: {h5}; ood60 unfiltered RMSD coverage at the last threshold "
        f"{cov!r} (reference 0.8157894736842105), E1C7U0 1-recall {recall:.7f} (reference "
        f"{BENCH_E1C7U0_RECALL}, {100 * abs(recall / BENCH_E1C7U0_RECALL - 1):.3f}% off)")
    if abs(cov - BENCH_OOD60_COVERAGE) > 1e-12 or abs(recall / BENCH_E1C7U0_RECALL - 1) > 0.01:
        raise AssertionError(f"the reference's recorded ood60 values are not met: {cov}, {recall}")
    wall = time.perf_counter() - t_phase
    log(f"[bench] phase 22 wall {wall:.1f} s; {card}")
    return dict(sample_launches=sample_launches, profile_launches=profile_launches,
                train_launches=launches, train_backwards=backwards, simt4=simt4,
                sample_cases=sample_cases, wall=wall)


def _case_keys(prefix, case):
    """A forward case's readings for the kernels line, under ``prefix``."""
    return {f"{prefix}_{k}": case[k] for k in ("ms", "prev_ms", "plain_ms", "bound_ms",
                                                "bound_by", "max_abs_err")}


def _h16_entry(case, l77, bwd):
    """The kernels line's readings of a 16-head design: its case at a mesh
    path's shape, at B=40 L=77 with 9 masked columns, and K1's backward at
    the path's shape (the kernel ``csrc/ipa_attention_bwd_tc16.cu``, timed
    in turns with the PyTorch backward, ``backward_torch_ms``)."""
    return {
        "max_abs_err": case["max_abs_err"], "ms": case["ms"], "plain_ms": case["plain_ms"],
        "bound_ms": case["bound_ms"], "bound_by": case["bound_by"], "library_ms": None,
        "verdict": "pass", "design": case["design"],
        "prev_source": "se3diff_torch/csrc/ipa_attention.cu", "prev_ms": case["prev_ms"],
        "max_abs_err_vs_prev": case["err_vs_prev"],
        "B40_L77_masked_ms": l77["ms"], "B40_L77_masked_prev_ms": l77["prev_ms"],
        "B40_L77_masked_bound_ms": l77["bound_ms"], "B40_L77_masked_max_abs_err": l77["max_abs_err"],
        "backward_route": bwd["route"],
        "backward_source": "se3diff_torch/csrc/ipa_attention_bwd_tc16.cu",
        "backward_replaces": "se3diff_tpu/ops/pallas_ipa.py:1036",
        "backward_ms": bwd["ms"], "backward_torch_ms": bwd["torch_ms"],
        "backward_plain_ms": bwd["plain_ms"],
        "backward_bound_ms": bwd["bound_ms"], "backward_bound_by": bwd["bound_by"],
        "backward_max_rel_err": bwd["max_rel_err"],
    }


def _h8_entry(case, path_name, path, l77):
    """The kernels line's readings of an 8-head design: its case at B=40
    L=100, at the model=4 path's shape (``path``, under ``path_name``) and
    at B=40 L=77 with 9 masked columns, each beside the CUDA-core design
    timed in turns (``prev_ms``)."""
    return {
        "max_abs_err": case["max_abs_err"], "ms": case["ms"], "plain_ms": case["plain_ms"],
        "bound_ms": case["bound_ms"], "bound_by": case["bound_by"], "library_ms": None,
        "verdict": "pass", "design": case["design"],
        "prev_source": "se3diff_torch/csrc/ipa_attention.cu", "prev_ms": case["prev_ms"],
        "max_abs_err_vs_prev": case["err_vs_prev"],
        **_case_keys(path_name, path), **_case_keys("B40_L77_masked", l77),
    }


def _pb32_entry(inkernel, dname):
    """The kernels line's readings of an in-kernel 32-head design: its
    launches in phase 11, its case at B=40 L=100 Cp=256 beside the CUDA-core
    design (prev) and the two-step, with both operation bounds, and its
    cases at L=57 masked, Cp=96 and the first of the SP path's row slabs."""
    main = inkernel[("pb32", 40, 100, 256, dname)]
    keys = ("ms", "prev_ms", "twostep_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")
    return {
        "launches": inkernel["pb32_launches"][PB32_ROUTES[dname]],
        "max_abs_err": main["max_abs_err"], "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
        "verdict": "pass", "design": main["design"],
        "prev_source": "se3diff_torch/csrc/ipa_attention.cu", "prev_ms": main["prev_ms"],
        "max_abs_err_vs_prev": main["err_vs_prev"], "twostep_ms": main["twostep_ms"],
        "max_abs_err_vs_twostep": main["err_vs_twostep"],
        "bytes_bound_ms": main["bytes_bound_ms"], "design_ops_ms": main["design_ops_ms"],
        "ops_bound_ms": main["ops_bound_ms"],
        **{f"B40_L57_masked_{k}": inkernel[("pb32", 40, 57, 256, dname)][k] for k in keys},
        **{f"Cp96_{k}": inkernel[("pb32", 40, 100, 96, dname)][k] for k in keys},
        **{f"B4_L300_slab150_{k}": inkernel[("pb32_slab", dname)][k] for k in keys},
    }


def _bwd_keys(prefix, case):
    """A backward case's readings for the kernels line, under ``prefix``."""
    return {f"{prefix}_{k}": case[k] for k in ("ms", "torch_ms", "plain_ms", "bound_ms", "bound_by",
                                                "bytes_bound_ms", "max_rel_err", "peak_mb")}


def _bwd_entry(case):
    """The kernels line's readings of a backward kernel at its main shape:
    ``ms`` the kernel's (timed in turns with the PyTorch backward,
    ``torch_ms``), ``plain_ms`` autograd through the plain version,
    ``bound_ms`` the larger of the bytes bound (``bytes_bound_ms``) and the
    design's operations on their units (``design_ops_ms``; ``ops_bound_ms``
    every operation in f32 on CUDA cores), the device kernel time and count of
    each, and peak memory of the Function's forward and backward against
    plain autograd's; the errors are against the plain version in f64
    (``max_rel_err_vs_f32_plain`` in f32)."""
    keys = ("max_abs_err", "max_rel_err", "max_rel_err_vs_f32_plain", "ms", "plain_ms",
            "bound_ms", "bound_by",
            "bytes_bound_ms", "design_ops_ms", "ops_bound_ms", "torch_ms", "kernel_ms", "kernels",
            "torch_kernel_ms", "torch_kernels", "peak_mb", "plain_peak_mb")
    return {**{k: case[k] for k in keys}, "library_ms": None, "verdict": "pass"}


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
    k1, ptxas = phase_build()
    k1_results = phase_kernel(k1, ptxas)
    phase_score_eval()
    bundle, sample_launches, f32_sample_launches, f32_wall = phase_main_path(k1, card)
    phase_profile(bundle)
    del bundle
    grad_results = phase_kernel_grad(k1)
    phase_dsm_grad(k1)
    train_launches, train_backwards, train_bwd_routes = phase_train_path(k1, card)
    phase_train_throughput(k1, card)
    slab_results = phase_sp_kernel(k1)
    sp_rank_launches = phase_parallel(k1, card)
    inkernel = phase_inkernel(k1, ptxas, card)
    files = phase_ppft_files()
    ppft_launches, ppft_backwards = phase_ppft_cli(k1, files, card)
    step = phase_ppft_step(k1, files, card)
    t_new = time.perf_counter()
    cli = phase_sample_cli(k1, files, card, f32_wall)
    sde_launches, sde_backwards = phase_ppft_cli(k1, files, card, "sde_dpm_solver_finetune", steps=None)
    sde_step = phase_ppft_step(k1, files, card, "sde_dpm_solver_finetune", beside=step)
    log(f"[done] phases 14-15 (the sample CLI with heun and euler_maruyama, PPFT with "
        f"sde_dpm_solver_finetune) in {time.perf_counter() - t_new:.1f} s")
    t_new = time.perf_counter()
    phase_toy(k1, card)
    phase_observables(k1, card, step["final_pos"])
    log(f"[done] phases 16-17 (the SO(3) toy, the observables) in {time.perf_counter() - t_new:.1f} s")
    learn = phase_ppft_learn(k1, ptxas, card)
    mesh = phase_mesh_train(k1, ptxas, card)
    t_new = time.perf_counter()
    sppp = phase_sp_pp_train(k1, ptxas, card)
    picard = phase_picard(k1, card)
    log(f"[done] phases 20-21 (SP and PP training, Picard) in {time.perf_counter() - t_new:.1f} s")
    bench = phase_bench(k1, ptxas, card)

    main_case = k1_results[K1_CASES[0][:3]]
    ppft_case = k1_results[(256, 56, "bfloat16")]
    f32_case, f32_ppft, f32_train = (k1_results[(B, L, "float32")] for B, L in ((40, 100), (256, 56), (16, 100)))
    bwd_case = grad_results[(TRAIN_BATCH, 100, "bfloat16", 100)]
    bwd_f32 = grad_results[(TRAIN_BATCH, 100, "float32", 100)]
    sp_case = slab_results[SLAB_CASES[0]]
    h4_case = inkernel[(PPFT_BATCH, 56, 4, 32, "float32", False)]
    ft_case = inkernel[(PPFT_BATCH, 56, 4, 32, "float32", True)]
    ft57_case = inkernel[(PPFT_BATCH, 57, 4, 32, "float32", True)]
    ft_bwd = inkernel[("grad",) + INKERNEL_GRAD_CASES[0][:5] + INKERNEL_GRAD_CASES[0][6:]]
    ft_bwd_cases = {c[:5] + c[6:]: inkernel[("grad",) + c[:5] + c[6:]] for c in INKERNEL_GRAD_CASES}
    h16_l77 = {dname: inkernel[(40, 77, 16, 256, dname, False)] for dname in H16_ROUTES}
    h8_main = {dname: inkernel[(40, 100, 8, 256, dname, False)] for dname in H8_ROUTES}
    h8_l77 = {dname: inkernel[(40, 77, 8, 256, dname, False)] for dname in H8_ROUTES}
    mesh4 = mesh["mesh4"]
    log(f"[k1] launches: sampling path {sample_launches}, training path {train_launches}, PPFT "
        f"CLI {ppft_launches}, PPFT step {step['launches']}, sample CLI heun "
        f"{cli['heun']['launches']} and euler_maruyama {cli['euler_maruyama']['launches']}, PPFT "
        f"CLI sde_dpm {sde_launches}, PPFT step sde_dpm {sde_step['launches']}; backward passes: "
        f"training path {train_backwards}, PPFT CLI {ppft_backwards}, PPFT step "
        f"{step['backwards']}, PPFT CLI sde_dpm {sde_backwards}, PPFT step sde_dpm "
        f"{sde_step['backwards']}; PPFT learning run: DSM {learn['dsm_launches']} launches and "
        f"{learn['dsm_backwards']} backward passes, sample check {learn['check_launches']}, "
        f"fine-tuning {learn['ppft_launches']} and {learn['ppft_backwards']} backward passes; "
        f"mesh training (2 ranks): the data=2 step {mesh['readings']['data=2']['launches']} "
        f"tc_f32, the model=2 step {mesh['readings']['model=2']['launches']} tc16_f32, the CLI's "
        f"10 steps at model=2 {mesh['cli_launches']} tc16 and {mesh['cli_backwards']} backward "
        f"passes ({mesh['cli_bwd_launches']} on bwd_tc16), the model=2 step's "
        f"{mesh['readings']['model=2']['bwd_launches']} on bwd_tc16_f32; mesh training (4 "
        f"ranks): the model=4 step {mesh4['launches']} tc8_f32, the CLI's {MESH4_CLI_STEPS} steps "
        f"at model=4 {mesh4['cli_launches']} tc8, their backward passes {mesh4['backwards']} "
        f"({mesh4['bwd_launches']} on bwd_tc8_f32) and {mesh4['cli_backwards']} "
        f"({mesh4['cli_bwd_launches']} on bwd_tc8); SP training (2 "
        f"ranks) {sppp['sp_launches']} slab launches on tc_f32 and "
        f"{sppp['sp_backwards']} backward passes; PP (2 stages) f32 forward and step "
        f"{sppp['pp_launches']} on tc_f32, {sppp['pp_backwards']} backward passes, bf16 first "
        f"step {sppp['pp_bf16_launches']} on tc; Picard bf16 "
        + ", ".join(f"{s} sweeps {n}" for s, n in picard["launches"].items())
        + f" on tc, f32 30 sweeps {picard['f32_launches']} on tc_f32; benchmarks: sample CLI "
        f"{bench['sample_launches']} on tc_f32, the profiled evaluation {bench['profile_launches']} "
        f"on tc, the training example {bench['train_launches']} on simt and "
        f"{bench['train_backwards']} backward passes")
    kernels = {"kernels": [{
        "name": "ipa_attention",
        "route": "cuda",
        "source": "se3diff_torch/csrc/ipa_attention_tc.cu",
        "replaces": "se3diff_tpu/ops/pallas_ipa.py:322",
        "launches": sample_launches + train_launches,
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
        "verdict": "pass",
        # bf16, 32 heads, streamed pa: the tensor-core design; prev_ms is the
        # CUDA-core design (se3diff_torch/csrc/ipa_attention.cu) on the same inputs.
        "design": main_case["design"],
        "prev_source": "se3diff_torch/csrc/ipa_attention.cu",
        "prev_ms": main_case["prev_ms"],
        "max_abs_err_vs_prev": main_case["err_vs_prev"],
        # The PPFT score model's shape: B=256, L=56, bf16.
        "B256_L56_ms": ppft_case["ms"],
        "B256_L56_prev_ms": ppft_case["prev_ms"],
        "B256_L56_bound_ms": ppft_case["bound_ms"],
        "B256_L56_plain_ms": ppft_case["plain_ms"],
        "B256_L56_max_abs_err": ppft_case["max_abs_err"],
        # Streamed launches of the PPFT CLI run's score model, counted apart,
        # and of the sde_dpm_solver_finetune CLI run and step (phase 15).
        "launches_ppft": ppft_launches["pa"],
        "launches_ppft_sde_dpm": sde_launches["pa"],
        "launches_ppft_sde_dpm_step": sde_step["launches"]["pa"],
        # The PPFT learning run (phase 18): its DSM steps, its sample check
        # and its fine-tuning recorder, and the DSM step's shape (B=32, L=56).
        "launches_ppft_learn_dsm": learn["dsm_launches"],
        "launches_ppft_learn_check": learn["check_launches"],
        "launches_ppft_learn": learn["ppft_launches"]["pa"],
        "B32_L56_ms": learn["fwd"]["ms"],
        "B32_L56_prev_ms": learn["fwd"]["prev_ms"],
        "B32_L56_plain_ms": learn["fwd"]["plain_ms"],
        "B32_L56_bound_ms": learn["fwd"]["bound_ms"],
        "B32_L56_max_abs_err": learn["fwd"]["max_abs_err"],
        # At the control net's 4 heads: B=256, L=56, Cp=32, f32.
        "h4_max_abs_err": h4_case["max_abs_err"],
        "h4_ms": h4_case["ms"],
        "h4_plain_ms": h4_case["plain_ms"],
        "h4_bound_ms": h4_case["bound_ms"],
        "h4_bound_by": h4_case["bound_by"],
        # The backward (B=16, L=100, bf16) is the kernel "bwd_tc" (its own
        # entry below); backward_calls: autograd's backward passes in the
        # training run.
        "backward_route": bwd_case["route"],
        "backward_source": "se3diff_torch/csrc/ipa_attention_bwd_tc.cu",
        "backward_replaces": "se3diff_tpu/ops/pallas_ipa.py:1036",
        "backward_calls": train_backwards,
        "backward_max_abs_err": bwd_case["max_abs_err"],
        "backward_max_rel_err": bwd_case["max_rel_err"],
        "backward_ms": bwd_case["ms"],
        "backward_plain_ms": bwd_case["plain_ms"],
        "backward_bound_ms": bwd_case["bound_ms"],
        "backward_bound_by": bwd_case["bound_by"],
        "backward_calls_ppft_learn_dsm": learn["dsm_backwards"],
        # Phase 21: a Picard sweep of em-200 at B=1 (K1 at B=200), launches
        # of one run at each sweep count; phase 20 (b): the bf16 PP step's
        # microbatch (B=4), its first step summed over the 2 stages.
        "launches_picard": picard["launches"],
        "picard_wall_s": picard["walls"],
        "picard_sequential_em200_wall_s": picard["seq_s"],
        "launches_pp_bf16_step": sppp["pp_bf16_launches"],
        **_case_keys("B200_L100", sppp["new"][(200, 100, "bfloat16")]),
        **_case_keys("B4_L100", sppp["new"][(PP_B // PP_M, PP_L, "bfloat16")]),
        # Phase 22 (c): the profiled score evaluation (B=40, L=100).
        "launches_bench_profile": bench["profile_launches"],
    }, {
        # f32, 32 heads, streamed pa (every CLI's default dtype): the f32
        # tensor-core design; prev_ms is the CUDA-core design on the same inputs.
        "name": "ipa_attention_f32",
        "route": "cuda",
        "source": "se3diff_torch/csrc/ipa_attention_tc_f32.cu",
        "replaces": "se3diff_tpu/ops/pallas_ipa.py:322",
        # The f32 batch of the sampling path (phase 4); the sample CLI's
        # heun and euler_maruyama batches (phase 14).
        "launches": f32_sample_launches,
        "launches_heun": cli["heun"]["launches"],
        "launches_em": cli["euler_maruyama"]["launches"],
        "max_abs_err": f32_case["max_abs_err"],
        "ms": f32_case["ms"],
        "plain_ms": f32_case["plain_ms"],
        "bound_ms": f32_case["bound_ms"],
        "bound_by": f32_case["bound_by"],
        "library_ms": None,
        "verdict": "pass",
        "design": f32_case["design"],
        "prev_source": "se3diff_torch/csrc/ipa_attention.cu",
        "prev_ms": f32_case["prev_ms"],
        "max_abs_err_vs_prev": f32_case["err_vs_prev"],
        # The PPFT score model's shape at the finetune CLI's default f32.
        "B256_L56_ms": f32_ppft["ms"],
        "B256_L56_prev_ms": f32_ppft["prev_ms"],
        "B256_L56_bound_ms": f32_ppft["bound_ms"],
        "B256_L56_plain_ms": f32_ppft["plain_ms"],
        "B256_L56_max_abs_err": f32_ppft["max_abs_err"],
        # The data=2 mesh step (phase 19 (a)), summed over its 2 ranks.
        "launches_mesh_dp": mesh["readings"]["data=2"]["launches"],
        # The train forward's shape at the train CLI's default f32.
        "B16_L100_ms": f32_train["ms"],
        "B16_L100_prev_ms": f32_train["prev_ms"],
        "B16_L100_bound_ms": f32_train["bound_ms"],
        "B16_L100_max_abs_err": f32_train["max_abs_err"],
        # Phase 20 (b): the PP forward and step at pipe=2, summed over the 2
        # stages, at its microbatch (B=4); phase 21: f32 em-30 with 30
        # sweeps (K1 at B=30).
        "launches_pp": sppp["pp_launches"],
        "backward_calls_pp": sppp["pp_backwards"],
        "launches_picard_f32": picard["f32_launches"],
        # Phase 22 (b): the sample CLI for each benchmark test case scored,
        # and K1 at its shapes (B=10, L=60 and L=77).
        "launches_bench_samples": bench["sample_launches"],
        **_case_keys("B10_L60", bench["sample_cases"][BENCH_K1_CASES[0]]),
        **_case_keys("B10_L77", bench["sample_cases"][BENCH_K1_CASES[1]]),
        **_case_keys("B4_L100", sppp["new"][(PP_B // PP_M, PP_L, "float32")]),
        **_case_keys("B30_L100", sppp["new"][(30, 100, "float32")]),
    }, {
        "name": "sp_ipa_attention",
        "route": "cuda",
        "source": "se3diff_torch/csrc/ipa_attention_tc.cu",
        "replaces": "se3diff_tpu/ops/pallas_ipa.py:874",
        # K1's launches in the SP sampling run, summed over its ranks;
        # launches_per_rank holds each.
        "launches": sum(sp_rank_launches),
        "launches_per_rank": sp_rank_launches,
        # The SP path's shape: B=4, L=300, bf16, one of 2 slabs (150 rows).
        "max_abs_err": sp_case["max_abs_err"],
        "ms": sp_case["ms"],
        "plain_ms": sp_case["plain_ms"],
        "bound_ms": sp_case["bound_ms"],
        "bound_by": sp_case["bound_by"],
        "library_ms": None,
        "verdict": "pass",
        "full_rows_ms": sp_case["full_ms"],
        # In-kernel pair bias at 4 heads: B=256, L=56, f32, one of 2 slabs.
        "h4_max_abs_err": inkernel["sp_h4"]["max_abs_err"],
        "h4_ms": inkernel["sp_h4"]["ms"],
        "h4_plain_ms": inkernel["sp_h4"]["plain_ms"],
        "h4_bound_ms": inkernel["sp_h4"]["bound_ms"],
        "h4_prev_ms": inkernel["sp_h4"]["prev_ms"],
        # Phase 20 (a): the f32 SP DSM step (150-row slabs of L=300 on
        # tc_f32), summed over its 2 ranks; the backward on one slab is
        # ipa_attention_backward_f32's B4_L300_rows150 readings (phase 6).
        "launches_sp_train": sppp["sp_launches"],
        "backward_calls_sp_train": sppp["sp_backwards"],
        "backward_route": grad_results[(4, 300, "float32", 150)]["route"],
        "backward_source": "se3diff_torch/csrc/ipa_attention_bwd_tc.cu",
        "backward_replaces": "se3diff_tpu/ops/pallas_ipa.py:1036",
    }, {
        "name": "ipa_attention_in_kernel_pair_bias",
        "route": "cuda",
        "source": "se3diff_torch/csrc/ipa_attention_h4.cu",
        "replaces": "se3diff_tpu/ops/pallas_ipa.py:399",
        # has_pa=False launches of the PPFT CLI run (control net: recording
        # and replay).
        "launches": ppft_launches["w_pb"],
        "launches_ppft_step": step["launches"]["w_pb"],
        # The same with sde_dpm_solver_finetune (phase 15).
        "launches_ppft_sde_dpm": sde_launches["w_pb"],
        "launches_ppft_sde_dpm_step": sde_step["launches"]["w_pb"],
        "launches_ppft_learn": learn["ppft_launches"]["w_pb"],
        # The control net's shape on the PPFT path: B=256, L=56, 4 heads, Cp=32, f32.
        "max_abs_err": ft_case["max_abs_err"],
        "ms": ft_case["ms"],
        "plain_ms": ft_case["plain_ms"],
        "bound_ms": ft_case["bound_ms"],
        "bound_by": ft_case["bound_by"],
        "library_ms": None,
        "verdict": "pass",
        # f32, 4 heads, in-kernel pa: the h4 design; prev_ms is the CUDA-core
        # design (its source, prev_source) on the same inputs, timed in turns.
        "design": ft_case["design"],
        "prev_source": "se3diff_torch/csrc/ipa_attention.cu",
        "prev_ms": ft_case["prev_ms"],
        "max_abs_err_vs_prev": ft_case["err_vs_prev"],
        # L=57 with 5 masked columns, the same widths.
        "L57_masked_ms": ft57_case["ms"],
        "L57_masked_prev_ms": ft57_case["prev_ms"],
        "L57_masked_bound_ms": ft57_case["bound_ms"],
        "L57_masked_max_abs_err": ft57_case["max_abs_err"],
        # The control net's K1 device time in the PPFT step's 10-step profile.
        "ppft_profile_ms": step["control_net_k1_ms"],
        # The backward is the kernel "bwd_h4" (its own entry below).
        "backward_route": ft_bwd["route"],
        "backward_source": "se3diff_torch/csrc/ipa_attention_bwd_h4.cu",
        "backward_replaces": "se3diff_tpu/ops/pallas_ipa.py:1036",
        "backward_calls": ppft_backwards,
        "backward_calls_ppft_sde_dpm": sde_backwards,
        "backward_calls_ppft_sde_dpm_step": sde_step["backwards"],
        "backward_calls_ppft_learn": learn["ppft_backwards"],
        "backward_max_abs_err": ft_bwd["max_abs_err"],
        "backward_max_rel_err": ft_bwd["max_rel_err"],
        "backward_ms": ft_bwd["ms"],
        "backward_plain_ms": ft_bwd["plain_ms"],
        "backward_bound_ms": ft_bwd["bound_ms"],
        "backward_bound_by": ft_bwd["bound_by"],
    }, {
        # The in-kernel pair bias at 32 heads in bf16 (route tc_pb): phase
        # 11's counted launches (the entry points ipa_attention and
        # sp_ipa_attention with w_pb; no CLI path launches it), at B=40
        # L=100 Cp=256; prev_ms is the CUDA-core design (prev_source) and
        # twostep_ms pa by torch.matmul then the streamed design, both on the
        # same inputs, timed in turns.
        "name": "ipa_attention_in_kernel_pair_bias_32_heads",
        "route": "cuda",
        "source": "se3diff_torch/csrc/ipa_attention_tc.cu",
        "replaces": "se3diff_tpu/ops/pallas_ipa.py:399",
        **_pb32_entry(inkernel, "bfloat16"),
    }, {
        # The same in f32 (route tc_pb_f32).
        "name": "ipa_attention_in_kernel_pair_bias_32_heads_f32",
        "route": "cuda",
        "source": "se3diff_torch/csrc/ipa_attention_tc_f32.cu",
        "replaces": "se3diff_tpu/ops/pallas_ipa.py:399",
        **_pb32_entry(inkernel, "float32"),
    }, {
        # K1 at a TP rank's 16 heads in bf16 (route tc16): the train CLI's 10
        # mesh steps at model=2 (phase 19 (b)), summed over its 2 ranks, at
        # its shape, B=16 L=64; prev_ms is the CUDA-core design
        # (prev_source) on the same inputs, timed in turns.
        "name": "ipa_attention_16_heads",
        "route": "cuda",
        "source": "se3diff_torch/csrc/ipa_attention_tc16.cu",
        "replaces": "se3diff_tpu/ops/pallas_ipa.py:322",
        "launches": mesh["cli_launches"],
        **_h16_entry(mesh["h16"]["bf16"], h16_l77["bfloat16"], mesh["bwd"]["bf16"]),
        "backward_calls": mesh["cli_backwards"],
    }, {
        # The same at f32 (route tc16_f32): the model=2 mesh step (phase 19
        # (a)), summed over its 2 ranks, at its shape, B=16 L=100.
        "name": "ipa_attention_16_heads_f32",
        "route": "cuda",
        "source": "se3diff_torch/csrc/ipa_attention_tc16_f32.cu",
        "replaces": "se3diff_tpu/ops/pallas_ipa.py:322",
        "launches": mesh["readings"]["model=2"]["launches"],
        **_h16_entry(mesh["h16"]["f32"], h16_l77["float32"], mesh["bwd"]["f32"]),
        "backward_calls": mesh["readings"]["model=2"]["backwards"],
    }, {
        # K1 at a TP rank's 8 heads in bf16 (route tc8): the train CLI's
        # steps at model=4 (phase 19 (b)), summed over its 4 ranks; ms at
        # B=40 L=100, with the CLI's shape (B=16 L=64) and B=40 L=77 masked
        # beside; prev_ms is the CUDA-core design (prev_source) on the same
        # inputs, timed in turns. Its backward is the kernel "bwd_tc8" (its
        # own entry below).
        "name": "ipa_attention_8_heads",
        "route": "cuda",
        "source": "se3diff_torch/csrc/ipa_attention_tc8.cu",
        "replaces": "se3diff_tpu/ops/pallas_ipa.py:322",
        "launches": mesh4["cli_launches"],
        **_h8_entry(h8_main["bfloat16"], "B16_L64", mesh4["h8"]["bf16"], h8_l77["bfloat16"]),
        "backward_route": mesh4["bwd"]["bf16"]["route"],
        "backward_source": "se3diff_torch/csrc/ipa_attention_bwd_tc8.cu",
        "backward_replaces": "se3diff_tpu/ops/pallas_ipa.py:1036",
        "backward_calls": mesh4["cli_backwards"],
    }, {
        # The same at f32 (route tc8_f32): the model=4 mesh step (phase 19
        # (a)), summed over its 4 ranks; its shape B=16 L=100 beside.
        "name": "ipa_attention_8_heads_f32",
        "route": "cuda",
        "source": "se3diff_torch/csrc/ipa_attention_tc8_f32.cu",
        "replaces": "se3diff_tpu/ops/pallas_ipa.py:322",
        "launches": mesh4["launches"],
        **_h8_entry(h8_main["float32"], "B16_L100", mesh4["h8"]["f32"], h8_l77["float32"]),
        "backward_route": mesh4["bwd"]["f32"]["route"],
        "backward_source": "se3diff_torch/csrc/ipa_attention_bwd_tc8.cu",
        "backward_replaces": "se3diff_tpu/ops/pallas_ipa.py:1036",
        "backward_calls": mesh4["backwards"],
    }, {
        # K1 at 4 heads of 16 with the streamed pair bias, f32 (route simt,
        # the CUDA-core design): the training example on the card (phase 22
        # (d), 500 DSM steps and 100 EM steps of a 2-layer d64 model), at its
        # shape, B=8 L=8, Cp=16.
        "name": "ipa_attention_4_heads_streamed",
        "route": "cuda",
        "source": "se3diff_torch/csrc/ipa_attention.cu",
        "replaces": "se3diff_tpu/ops/pallas_ipa.py:322",
        "launches": bench["train_launches"],
        "max_abs_err": bench["simt4"]["max_abs_err"],
        "ms": bench["simt4"]["ms"],
        "plain_ms": bench["simt4"]["plain_ms"],
        "bound_ms": bench["simt4"]["bound_ms"],
        "bound_by": bench["simt4"]["bound_by"],
        "library_ms": None,
        "verdict": "pass",
        "design": bench["simt4"]["design"],
        # The launch floor in the same run: an empty kernel's device time back
        # to back, and the host's wall a call (the wrapper, the empty kernel).
        "empty_kernel_ms": bench["simt4"]["empty_kernel_ms"],
        "host_call_ms": bench["simt4"]["host_call_ms"],
        "empty_kernel_host_ms": bench["simt4"]["empty_kernel_host_ms"],
        "backward_route": "torch",
        "backward_source": "se3diff_torch/ops/ipa_attention.py",
        "backward_replaces": "se3diff_tpu/ops/pallas_ipa.py:1036",
        "backward_calls": bench["train_backwards"],
    }, {
        # K1's backward at 32 heads with the streamed pair bias in bf16 (route
        # bwd_tc): autograd's backward passes in the train CLI's run (phase 8),
        # and at the train step's shape (B=16, L=100) its gradients against
        # autograd of the plain version, timed in turns with the PyTorch
        # backward (torch_ms). No Pallas kernel: "replaces" is the XLA
        # backward behind fused_ipa_attention_diff's custom VJP.
        "name": "ipa_attention_backward",
        "route": "cuda",
        "source": "se3diff_torch/csrc/ipa_attention_bwd_tc.cu",
        "replaces": "se3diff_tpu/ops/pallas_ipa.py:1036",
        "launches": train_bwd_routes["bwd_tc"],
        **_bwd_entry(bwd_case),
        # The PPFT learning run's DSM steps (phase 18), the bf16 PP step's
        # first step summed over its 2 stages (phase 20 (b)), and phase 6's
        # further shapes.
        "launches_ppft_learn_dsm": learn["dsm_backwards"],
        "launches_pp_bf16_step": sppp["pp_bf16_backwards"],
        **_bwd_keys("B32_L56", grad_results[(LEARN_DSM_BATCH, LEARN_L, "bfloat16", LEARN_L)]),
        **_bwd_keys("B4_L300_rows150", grad_results[(4, 300, "bfloat16", 150)]),
        **_bwd_keys("B16_L77_masked", grad_results[(TRAIN_BATCH, 77, "bfloat16", 77)]),
        **_bwd_keys("B4_L200", grad_results[(4, 200, "bfloat16", 200)]),
    }, {
        # The same in f32 (route bwd_tc_f32, the train CLI's default dtype):
        # the data=2 mesh step (phase 19 (a)), summed over its 2 ranks; the
        # SP and PP f32 steps (phase 20).
        "name": "ipa_attention_backward_f32",
        "route": "cuda",
        "source": "se3diff_torch/csrc/ipa_attention_bwd_tc.cu",
        "replaces": "se3diff_tpu/ops/pallas_ipa.py:1036",
        "launches": mesh["readings"]["data=2"]["bwd_launches"],
        **_bwd_entry(bwd_f32),
        "launches_sp_train": sppp["sp_backwards"],
        "launches_pp": sppp["pp_backwards"],
        **_bwd_keys("B4_L300_rows150", grad_results[(4, 300, "float32", 150)]),
        **_bwd_keys("B16_L77_masked", grad_results[(TRAIN_BATCH, 77, "float32", 77)]),
    }, {
        # K1's backward at a TP rank's 16 heads with the streamed pair bias in
        # bf16 (route bwd_tc16): autograd's backward passes in the train CLI's
        # 10 mesh steps at model=2 (phase 19 (b)), summed over its 2 ranks, and
        # at its shape (B=16, L=64) the gradients against autograd of the
        # plain version, timed in turns with the PyTorch backward (torch_ms);
        # phase 6's B=40 L=77 masked beside.
        "name": "ipa_attention_backward_16_heads",
        "route": "cuda",
        "source": "se3diff_torch/csrc/ipa_attention_bwd_tc16.cu",
        "replaces": "se3diff_tpu/ops/pallas_ipa.py:1036",
        "launches": mesh["cli_bwd_launches"],
        **_bwd_entry(mesh["bwd"]["bf16"]),
        "torch_peak_mb": mesh["bwd"]["bf16"]["torch_peak_mb"],
        **_bwd_keys("B40_L77_masked", grad_results[(40, 77, "bfloat16", 77, 16)]),
    }, {
        # The same in f32 (route bwd_tc16_f32): the model=2 mesh step (phase
        # 19 (a)), summed over its 2 ranks, at its shape (B=16, L=100).
        "name": "ipa_attention_backward_16_heads_f32",
        "route": "cuda",
        "source": "se3diff_torch/csrc/ipa_attention_bwd_tc16.cu",
        "replaces": "se3diff_tpu/ops/pallas_ipa.py:1036",
        "launches": mesh["readings"]["model=2"]["bwd_launches"],
        **_bwd_entry(mesh["bwd"]["f32"]),
        "torch_peak_mb": mesh["bwd"]["f32"]["torch_peak_mb"],
        **_bwd_keys("B40_L77_masked", grad_results[(40, 77, "float32", 77, 16)]),
    }, {
        # K1's backward at a TP rank's 8 heads with the streamed pair bias in
        # bf16 (route bwd_tc8): autograd's backward passes in the train CLI's
        # steps at model=4 (phase 19 (b)), summed over its 4 ranks, and at
        # its shape (B=16, L=64) the gradients against autograd of the plain
        # version, timed in turns with the PyTorch backward (torch_ms);
        # phase 6's B=40 L=77 masked beside.
        "name": "ipa_attention_backward_8_heads",
        "route": "cuda",
        "source": "se3diff_torch/csrc/ipa_attention_bwd_tc8.cu",
        "replaces": "se3diff_tpu/ops/pallas_ipa.py:1036",
        "launches": mesh4["cli_bwd_launches"],
        **_bwd_entry(mesh4["bwd"]["bf16"]),
        "torch_peak_mb": mesh4["bwd"]["bf16"]["torch_peak_mb"],
        **_bwd_keys("B40_L77_masked", grad_results[(40, 77, "bfloat16", 77, 8)]),
    }, {
        # The same in f32 (route bwd_tc8_f32): the model=4 mesh step (phase
        # 19 (a)), summed over its 4 ranks, at its shape (B=16, L=100).
        "name": "ipa_attention_backward_8_heads_f32",
        "route": "cuda",
        "source": "se3diff_torch/csrc/ipa_attention_bwd_tc8.cu",
        "replaces": "se3diff_tpu/ops/pallas_ipa.py:1036",
        "launches": mesh4["bwd_launches"],
        **_bwd_entry(mesh4["bwd"]["f32"]),
        "torch_peak_mb": mesh4["bwd"]["f32"]["torch_peak_mb"],
        **_bwd_keys("B40_L77_masked", grad_results[(40, 77, "float32", 77, 8)]),
    }, {
        # K1's backward at the PPFT control net's widths (route bwd_h4: f32, 4
        # heads, in-kernel w_pb, Cp <= 64): autograd's backward passes in the
        # PPFT step (phase 13), and at its shape (B=256, L=56, Cp=32) the
        # gradients against autograd of the plain version, timed in turns
        # with the PyTorch backward (torch_ms). No Pallas kernel: "replaces"
        # is the XLA backward's has_pa=False branch.
        "name": "ipa_attention_backward_h4",
        "route": "cuda",
        "source": "se3diff_torch/csrc/ipa_attention_bwd_h4.cu",
        "replaces": "se3diff_tpu/ops/pallas_ipa.py:1036",
        "launches": step["backwards"],
        **_bwd_entry(ft_bwd),
        "torch_peak_mb": ft_bwd["torch_peak_mb"],
        # The PPFT CLI runs (phases 12, 15), the sde_dpm step (phase 15) and
        # the learning run's fine-tuning (phase 18); the backward kernels'
        # device time and calls in phase 13's 10-step profile.
        "launches_ppft_cli": ppft_backwards,
        "launches_ppft_sde_dpm": sde_backwards,
        "launches_ppft_sde_dpm_step": sde_step["backwards"],
        "launches_ppft_learn": learn["ppft_backwards"],
        "ppft_profile_ms": step["control_net_bwd_ms"],
        "ppft_profile_calls": step["control_net_bwd_calls"],
        **_bwd_keys("B64_L56", ft_bwd_cases[(64, 56, 4, 32, "float32", 56)]),
        **_bwd_keys("B256_L57_masked", ft_bwd_cases[(256, 57, 4, 32, "float32", 57)]),
        **_bwd_keys("B256_L56_Cp64", ft_bwd_cases[(256, 56, 4, 64, "float32", 56)]),
        **_bwd_keys("B64_L100", ft_bwd_cases[(64, 100, 4, 32, "float32", 100)]),
        **_bwd_keys("B256_L56_rows28", ft_bwd_cases[(256, 56, 4, 32, "float32", 28)]),
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
