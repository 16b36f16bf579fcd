"""Where the f32 DSM gradients of a whole batch and of its two halves part.

A data-parallel step on two ranks sums the gradients of the batch's two
halves; one process on the whole batch computes the same sum in another
order. This script measures how far apart the two come, tensor by tensor,
and whether the gap is the rounding of one implementation or a property of
the f32 gradient itself. On the inputs of ``chip_smoke.py`` phase 19 (a)
(bioemu-v1.0 widths, seed-0 weights, B=16, L=100, noise drawn from seed
19), one process computes the DSM loss's gradients on the whole batch and
accumulated over its halves, on ``--device`` (the card: K1 on "tc_f32")
and on the CPU (K1's plain version, another BLAS), and prints, for the
tensors with the largest gaps:

* ``device_gap`` / ``cpu_gap``: whole against halves on each, as a share of
  the tensor's largest whole-batch entry;
* ``device_vs_cpu``: the two whole-batch gradients against each other, the
  same share;
* ``norm_share``: the tensor's gradient norm over the global norm.

For ``x1d_proj``'s linear (the node embedding's weight, ``W`` with
``dL/dW = G^T X`` summed over the B*L tokens, ``G = dL/dx1d``, ``X`` the
normed single representation) it also prints the share at which ``G``
itself differs between whole and halves on the device, and the
cancellation of the token sum: ``max (|G|^T |X|) / max |G^T X|``. A gap of
``G``'s share times that factor is rounding that the sum magnifies.

It also prints what decides whether the card's f32 matrix products run in
TF32 (``torch.backends.cuda.matmul.allow_tf32`` and the environment's
``NVIDIA_TF32_OVERRIDE`` / ``TORCH_ALLOW_TF32_CUBLAS_OVERRIDE``) and, as a
probe, the error of one f32 product at the node embedding's shape (B*L or
B*L/2 tokens by 384, times 384 by 512) against float64: about 1e-7 of
the largest entry in full f32, 1e-4 or more in TF32. Running it with
``NVIDIA_TF32_OVERRIDE=0`` (TF32 off in cuBLAS) shows what the gap is
without TF32. On the device it also runs both steps with K1's plain
version (no kernel, autograd for its backward) and compares the routes.
``stream_gap`` follows the gap back through the layers: the gradient of
each encoder layer's input and of the diff head's, whole against halves.

Prints one JSON line and the card's name and power limit.

    python3 scripts/torch_dp_grad_gap.py                 # on the card
    NVIDIA_TF32_OVERRIDE=0 python3 scripts/torch_dp_grad_gap.py
    python3 scripts/torch_dp_grad_gap.py --tiny --device cpu   # smoke
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

B, L, SEED = 16, 100, 19
TOP = 8
TINY_MODEL = dict(dim_model=32, dim_pair=16, num_layers=2, num_heads=4, dim_hidden=64,
                  dropout=0.0)
TINY_SO3 = dict(num_sigma=40, num_omega=100, l_max=100)


def make_inputs(batch: int, length: int, seed: int) -> dict[str, np.ndarray]:
    """The batch of ``chip_smoke.py`` phase 19 (a), from ``seed``."""
    import torch

    from se3diff_torch.ops.so3 import rotvec_to_rotmat

    rng = np.random.default_rng(seed)
    return {
        "pos": (rng.standard_normal((batch, length, 3)) * 0.5).astype(np.float32),
        "rot": rotvec_to_rotmat(torch.from_numpy(
            (rng.standard_normal((batch, length, 3)) * 0.4).astype(np.float32))).numpy(),
        "single": (rng.standard_normal((batch, length, 384)) * 0.5).astype(np.float32),
        "pair": (rng.standard_normal((batch, length, length, 128)) * 0.2).astype(np.float32),
    }


def gradients(model, batch, noise, sdes, halves):
    """The DSM loss's gradients summed over ``halves`` (row ranges), with
    every part over the whole batch's denominator, and ``dL/dx1d`` of each
    part's rows. Returns ``(loss, {name: grad}, G [B, L, D])`` in numpy."""
    import torch

    from se3diff_torch.models import dig
    from se3diff_torch.training.dsm import dsm_denominator, dsm_loss

    captured, stream = [], []
    embed = dig.DistributionalGraphormer.embed_conditioning

    def capturing(self, *a, **kw):
        cache = embed(self, *a, **kw)
        cache["x1d"].retain_grad()
        captured.append(cache["x1d"])
        return cache

    at_compute = {}

    def keep_input(module, args):
        # The gradient as autograd computes it (a copy), and as it stands
        # after the whole backward pass (retain_grad): they differ if a later
        # operation writes into its buffer.
        i = len(stream)
        args[0].register_hook(lambda g: at_compute.__setitem__(i, g.detach().clone()))
        args[0].retain_grad()
        stream.append(args[0])

    pre_relu = {"fc_t": [], "fc_eps": []}

    def keep_pre_relu(name):
        return lambda module, args: pre_relu[name].append(args[0].detach().float().cpu())

    st = model.model_nn.st_module
    hooks = [m.register_forward_pre_hook(keep_input) for m in (*st.encoder.layers, st.diff_head)]
    hooks += [getattr(st.diff_head, n)[2].register_forward_pre_hook(keep_pre_relu(n))
              for n in pre_relu]
    model.zero_grad(set_to_none=True)
    model.eval()
    loss = 0.0
    dig.DistributionalGraphormer.embed_conditioning = capturing
    try:
        for b0, b1 in halves:
            part = dsm_loss(model, {k: v[b0:b1] for k, v in batch.items()},
                            type(noise)(*(x[b0:b1] for x in noise)), sdes,
                            denom=dsm_denominator(batch))
            part.backward()
            loss += part.item()
    finally:
        dig.DistributionalGraphormer.embed_conditioning = embed
        for h in hooks:
            h.remove()
    grads = {n: p.grad.detach().cpu().numpy().copy() for n, p in model.named_parameters()}
    G = torch.cat([x.grad for x in captured]).float().cpu().numpy()
    # The input of each encoder layer and of the diff head, and its
    # gradient, parts joined.
    n = len(stream) // len(halves)
    layers = [torch.cat([stream[k * n + i].grad for k in range(len(halves))]).float().cpu().numpy()
              for i in range(n)]
    values = [torch.cat([stream[k * n + i] for k in range(len(halves))]).detach().float().cpu()
              .numpy() for i in range(n)]
    computed = [torch.cat([at_compute[k * n + i] for k in range(len(halves))]).float().cpu()
                .numpy() for i in range(n)]
    relu_in = {n: torch.cat(v).numpy() for n, v in pre_relu.items()}
    return loss, grads, G, layers, values, computed, relu_in


def relu_flips(a: dict, b: dict) -> dict:
    """Where two runs' diff-head ReLUs (``fc_t``, ``fc_eps``) take their
    inputs on opposite sides of zero: the count, and the largest
    ``|input|`` at such an entry in either run. A flip switches that
    entry's gradient on or off, whatever the size of the input."""
    out = {}
    for n in a:
        flip = (a[n] > 0) != (b[n] > 0)
        out[n] = {"flips": int(flip.sum()),
                  "largest_input": float(max(np.abs(a[n][flip]).max(initial=0.0),
                                             np.abs(b[n][flip]).max(initial=0.0)))}
    return out


def k1_probe(operands: dict, halves) -> dict:
    """K1 on the operands its first call (layer 0) got in the whole-batch
    step: its forward (the kernel on a CUDA device) on the whole batch
    against each half's launch and against the plain version, and
    :func:`ipa_attention_backward` on a fixed cotangent, whole against
    halves, each as a share of the whole batch's largest entry. Per-example
    outputs and gradients compare row for row; ``w_pv``'s gradient, a sum
    over the batch, as the halves' sum."""
    import torch

    from se3diff_torch.ops import ipa_attention as k1

    args, kw = operands["args"], operands["kw"]
    cut = [[x[b0:b1] if i in (0, 1, 2, 3, 4, 5, 6, 8, 9) else x for i, x in enumerate(args)]
           for b0, b1 in halves]
    fwd = k1.ipa_attention(*args, **kw)
    fwd_parts = [k1.ipa_attention(*c, **kw) for c in cut]
    plain = k1.ipa_attention_plain(*args, **kw)
    out = {"forward_whole_vs_halves": [share(torch.cat([p[j] for p in fwd_parts]).float().cpu()
                                             .numpy(), fwd[j].float().cpu().numpy())
                                       for j in range(3)],
           "forward_vs_plain": [share(fwd[j].float().cpu().numpy(), plain[j].float().cpu().numpy())
                                for j in range(3)]}
    g = torch.Generator(device=fwd[0].device).manual_seed(5)
    cts = [torch.randn(x.shape, generator=g, device=x.device, dtype=x.dtype) for x in fwd]
    scal = dict(scalar_w=kw["scalar_w"], pair_w=kw["pair_w"])
    d_whole = k1.ipa_attention_backward(args, cts, **scal)
    d_parts = [k1.ipa_attention_backward(c, [ct[b0:b1] for ct in cts], **scal)
               for c, (b0, b1) in zip(cut, halves)]
    names = ["q_s", "k_s", "v_s", "q_p", "k_p", "v_p", "x2d", "w_pv", "bias", "pa"]
    back = {}
    for i, name in enumerate(names):
        if d_whole[i] is None:
            continue
        parts = [d[i] for d in d_parts]
        joined = sum(parts) if name == "w_pv" else torch.cat(parts)
        back[name] = share(joined.float().cpu().numpy(), d_whole[i].float().cpu().numpy())
    out["backward_whole_vs_halves"] = back
    return out


def share(a: np.ndarray, b: np.ndarray) -> float:
    """max |a - b| as a share of max |b|."""
    return float(np.abs(a - b).max() / np.abs(b).max())


def product_error(device: str, rows: int, seed: int = 0) -> float:
    """max |X W - (X W in float64)| over max |X W in float64|, for an f32
    product of ``rows`` tokens by 384 times 384 by 512 on ``device``."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x, w = torch.randn(rows, 384, generator=g), torch.randn(384, 512, generator=g)
    want = x.double() @ w.double()
    got = (x.to(device) @ w.to(device)).cpu().double()
    return float((got - want).abs().max() / want.abs().max())


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true", help="narrow model, small tables, B=4 L=12")
    args = p.parse_args(argv)

    import torch

    from se3diff_torch.ops import ipa_attention as k1

    from se3diff_torch.diffusion.denoise import SDEs
    from se3diff_torch.models import dig
    from se3diff_torch.sampling.bundle import BIOEMU_V1_MODEL, BIOEMU_V1_SO3
    from se3diff_torch.sde.so3_sde import DiGSO3SDE
    from se3diff_torch.sde.vpsde import CosineVPSDE
    from se3diff_torch.training.dsm import draw_noise

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA device")
    model_cfg = TINY_MODEL if args.tiny else BIOEMU_V1_MODEL
    batch_size, length = (4, 12) if args.tiny else (B, L)
    so3 = dict(BIOEMU_V1_SO3, **(TINY_SO3 if args.tiny else {}))
    t0 = time.perf_counter()
    batch_np = make_inputs(batch_size, length, SEED)
    weights = dig.init_weights(dig.DiGConditionalScoreModel(**model_cfg),
                               torch.Generator().manual_seed(0)).state_dict()
    halves = [(0, batch_size // 2), (batch_size // 2, batch_size)]
    noise_np, runs = None, {}
    with tempfile.TemporaryDirectory() as cache_dir:
        for dev in (args.device, "cpu"):
            sdes = SDEs(pos=CosineVPSDE(),
                        node_orientations=DiGSO3SDE(**so3, cache_dir=cache_dir, device=dev))
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
            if noise_np is None:
                noise = draw_noise(torch.Generator(device=dev).manual_seed(SEED), batch, sdes)
                noise_np = tuple(x.cpu().numpy() for x in noise)
            noise = type(noise)(*(torch.from_numpy(x).to(dev) for x in noise_np))
            model = dig.DiGConditionalScoreModel(**model_cfg)
            model.load_state_dict(weights)
            model.to(dev)
            operands, core = {}, k1.ipa_attention

            def recording(q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa=None, w_pb=None,
                          **scal):
                args = (q_s, k_s, v_s, q_p, k_p, v_p, x2d, w_pv, bias, pa)
                operands.setdefault("args", tuple(None if x is None else x.detach().clone()
                                                  for x in args))
                operands.setdefault("kw", dict(w_pb=w_pb, **scal))
                return core(*args, w_pb=w_pb, **scal)

            k1.ipa_attention = recording
            try:
                whole = gradients(model, batch, noise, sdes, [(0, batch_size)])
            finally:
                k1.ipa_attention = core
            runs[dev] = {"whole": whole, "halves": gradients(model, batch, noise, sdes, halves),
                         "k1": k1_probe(operands, halves)}
            if dev != "cpu":   # the same on the device with K1's plain version
                k1.ipa_attention = k1.ipa_attention_plain
                try:
                    runs["plain"] = {s: gradients(model, batch, noise, sdes, h)
                                     for s, h in (("whole", [(0, batch_size)]), ("halves", halves))}
                finally:
                    k1.ipa_attention = core
            del model, batch
    dev_w, dev_h, cpu_w, cpu_h = (runs[d][k][1] for d in (args.device, "cpu")
                                  for k in ("whole", "halves"))
    names = [n for n, g in dev_w.items() if np.abs(g).max() > 0]
    total = float(np.sqrt(sum(float(np.square(g.astype(np.float64)).sum()) for g in dev_w.values())))
    rows = sorted(({"tensor": n, "device_gap": share(dev_h[n], dev_w[n]),
                    "cpu_gap": share(cpu_h[n], cpu_w[n]),
                    "device_vs_cpu": share(dev_w[n], cpu_w[n]),
                    "norm_share": float(np.linalg.norm(dev_w[n]) / total)} for n in names),
                  key=lambda r: -r["device_gap"])

    # x1d_proj's linear: the gap of its input gradient G and the token sum's
    # cancellation.
    X = torch.nn.functional.layer_norm(torch.from_numpy(batch_np["single"]), (384,),
                                       weights["model_nn.x1d_proj.0.weight"],
                                       weights["model_nn.x1d_proj.0.bias"]).numpy()
    X = X.reshape(-1, 384).astype(np.float64)
    G_w = runs[args.device]["whole"][2]
    G_h = runs[args.device]["halves"][2]
    stream_gap = [share(h, w) for h, w in zip(runs[args.device]["halves"][3],
                                              runs[args.device]["whole"][3])]
    stream_value_gap = [share(h, w) for h, w in zip(runs[args.device]["halves"][4],
                                                    runs[args.device]["whole"][4])]
    stream_computed_gap = [share(h, w) for h, w in zip(runs[args.device]["halves"][5],
                                                       runs[args.device]["whole"][5])]
    after_vs_computed = {s: max(share(a, c) for a, c in zip(runs[args.device][s][3],
                                                             runs[args.device][s][5]))
                         for s in ("whole", "halves")}
    flips = {"device_whole_vs_halves": relu_flips(runs[args.device]["whole"][6],
                                                  runs[args.device]["halves"][6]),
             "cpu_whole_vs_halves": relu_flips(runs["cpu"]["whole"][6], runs["cpu"]["halves"][6]),
             "device_vs_cpu_whole": relu_flips(runs[args.device]["whole"][6],
                                               runs["cpu"]["whole"][6])}
    # The head input's gradient, whole against halves, on the tokens where
    # no ReLU input of the head flipped.
    w_relu, h_relu = runs[args.device]["whole"][6], runs[args.device]["halves"][6]
    flipped = np.zeros(w_relu["fc_t"].shape[:-1], bool)
    for n in w_relu:
        flipped |= ((w_relu[n] > 0) != (h_relu[n] > 0)).any(-1)
    head_w, head_h = runs[args.device]["whole"][5][-1], runs[args.device]["halves"][5][-1]
    head_gap_unflipped = float(np.abs(head_w - head_h)[~flipped].max() / np.abs(head_w).max())
    routes = {}
    if "plain" in runs:
        flips["kernel_vs_plain_whole"] = relu_flips(runs[args.device]["whole"][6],
                                                    runs["plain"]["whole"][6])
        flips["kernel_vs_plain_halves"] = relu_flips(runs[args.device]["halves"][6],
                                                     runs["plain"]["halves"][6])
        flips["plain_whole_vs_halves"] = relu_flips(runs["plain"]["whole"][6],
                                                    runs["plain"]["halves"][6])
        pw, ph = runs["plain"]["whole"][1], runs["plain"]["halves"][1]
        routes = {"plain_whole_vs_halves": max(share(ph[n], pw[n]) for n in names),
                  "kernel_vs_plain_whole": max(share(dev_w[n], pw[n]) for n in names),
                  "kernel_vs_plain_halves": max(share(dev_h[n], ph[n]) for n in names),
                  "plain_device_vs_cpu": max(share(pw[n], cpu_w[n]) for n in names)}
    Gf = G_w.reshape(-1, G_w.shape[-1]).astype(np.float64)
    cancellation = float((np.abs(Gf).T @ np.abs(X)).max() / np.abs(Gf.T @ X).max())
    w_name = "model_nn.x1d_proj.1.weight"
    result = {
        "device": args.device, "B": batch_size, "L": length,
        "loss": {"device_whole": runs[args.device]["whole"][0],
                 "device_halves": runs[args.device]["halves"][0],
                 "cpu_whole": runs["cpu"]["whole"][0], "cpu_halves": runs["cpu"]["halves"][0]},
        "max_device_gap": rows[0]["device_gap"],
        "max_cpu_gap": max(r["cpu_gap"] for r in rows),
        "max_device_vs_cpu": max(r["device_vs_cpu"] for r in rows),
        "top": rows[:TOP],
        "x1d_proj_weight": {
            "device_gap": next(r["device_gap"] for r in rows if r["tensor"] == w_name),
            "G_device_gap": share(G_h, G_w),
            "token_sum_cancellation": cancellation,
        },
        # dL/d(input of encoder layer 0..n-1, then of the diff head), whole
        # against halves on the device: where, going back from the head,
        # the gap first opens.
        "stream_gap": stream_gap,
        # The inputs themselves (the forward), the same way.
        "stream_value_gap": stream_value_gap,
        # The gradients as autograd computed them, whole against halves, and
        # the largest change of any of them between then and the end of the
        # backward pass.
        "stream_computed_gap": stream_computed_gap,
        "stream_after_vs_computed": after_vs_computed,
        # The device's gradients with the kernel route against K1's plain
        # version (largest share over the tensors).
        "routes": routes,
        # The diff head's ReLU inputs on opposite sides of zero between the
        # same pairs of runs.
        "relu_flips": flips,
        "flipped_tokens": int(flipped.sum()),
        "head_input_grad_gap_unflipped_tokens": head_gap_unflipped,
        "k1_probe": runs[args.device]["k1"],
        "tf32": {
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            **{k: os.environ.get(k) for k in ("NVIDIA_TF32_OVERRIDE",
                                              "TORCH_ALLOW_TF32_CUBLAS_OVERRIDE")},
            "product_error": {n: product_error(args.device, n)
                              for n in (batch_size * length, batch_size * length // 2)},
        },
        "wall_s": time.perf_counter() - t0,
    }
    for r in rows[:TOP]:
        print(f"{r['tensor']}: device_gap={r['device_gap']:.3e} cpu_gap={r['cpu_gap']:.3e} "
              f"device_vs_cpu={r['device_vs_cpu']:.3e} norm_share={r['norm_share']:.3e}")
    x = result["x1d_proj_weight"]
    print(f"{w_name}: gap {x['device_gap']:.3e}; G = dL/dx1d gap {x['G_device_gap']:.3e}; "
          f"token-sum cancellation {x['token_sum_cancellation']:.1f}")
    print(f"TF32: {result['tf32']}")
    print("dL/d(layer input), layers 0.. then the head, whole vs halves: "
          + ", ".join(f"{g:.2e}" for g in stream_gap))
    print("layer inputs themselves, whole vs halves: "
          + ", ".join(f"{g:.2e}" for g in stream_value_gap))
    print(f"K1 at layer 0: {result['k1_probe']}")
    print("as computed, whole vs halves: " + ", ".join(f"{g:.2e}" for g in stream_computed_gap)
          + f"; changed after computing: {after_vs_computed}")
    print(f"routes: {routes}")
    print(f"ReLU flips: {flips}")
    print(f"head input's gradient, whole vs halves, on the {flipped.size - int(flipped.sum())} "
          f"tokens with no flip: {head_gap_unflipped:.2e}")
    if args.device.startswith("cuda"):
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        result["card"] = card.stdout.strip().splitlines()[0] if card.returncode == 0 else None
        print(result["card"])
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
