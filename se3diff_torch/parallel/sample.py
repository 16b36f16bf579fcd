"""Data-parallel (DP) ensemble sampling over a group of ranks.

Counterpart of ``se3diff_tpu/parallel/sample.py``. Sampling has no
steady-state communication: every rank draws the whole batch's prior from
one seed (``torch.Generator(device).manual_seed(seed)``, through
``diffusion/denoise.py::_prior``), keeps its own rows and runs the solver on
them; a stochastic solver (``heun``, ``euler_maruyama``) draws each step's
normals for the whole batch from the same generator and keeps its rows too; one :func:`~.mesh.gather_rows` per output assembles the batch at the
end. So DP reproduces the single-device batch of the same seed, as the JAX
package's DP reproduces the unsharded key. The batch is rounded up to the
world size and the surplus rows (copies of real ones) are trimmed.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from se3diff_torch.diffusion import denoise
from se3diff_torch.parallel.mesh import RankContext, gather_rows, round_up_batch
from se3diff_torch.sampling.bundle import Bundle


def make_sharded_sampler(bundle: Bundle, ctx: RankContext, batch: int, length: int) -> Callable:
    """``sampler(seed, single [L, 384], pair [L, L, 128][, mask [L]]) ->
    (pos, rot)`` for ``batch`` samples, split over ``ctx``'s ranks. Every
    rank must call it with the same arguments; every rank gets the whole
    batch back. The bundle's denoiser runs on the rank's rows through
    :func:`~se3diff_torch.diffusion.denoise.solve_from`, any sampler the
    bundles offer."""
    padded = round_up_batch(batch, ctx.world)
    per = padded // ctx.world
    b0, b1 = ctx.rank * per, (ctx.rank + 1) * per

    @torch.inference_mode()
    def sampler(seed: int, single, pair, mask=None):
        gen = torch.Generator(device=bundle.device).manual_seed(seed)
        pos, rot = denoise._prior(gen, bundle.sdes, batch, length)
        # Surplus rows repeat real ones; they are solved and dropped.
        keep = torch.arange(b0, b1, device=pos.device) % batch
        pos, rot = pos[keep], rot[keep]
        s = single.expand(per, *single.shape)
        p = pair.expand(per, *pair.shape)
        m = None if mask is None else mask.expand(per, *mask.shape)
        cache = bundle.model.embed_conditioning(s, p, m)

        def model_fn(x, r, t):
            return bundle.model.score_from_cache(x, r, t, cache)

        def draws(like):
            z = torch.randn((batch, *like.shape[1:]), generator=gen, dtype=like.dtype,
                            device=like.device)
            return z[keep]

        pos, rot = denoise.solve_from(bundle.denoiser, bundle.sdes, model_fn, pos, rot, draws)
        pos = gather_rows(pos.contiguous(), b0, b1, padded, dim=0, group=ctx.group)
        rot = gather_rows(rot.contiguous(), b0, b1, padded, dim=0, group=ctx.group)
        return pos[:batch], rot[:batch]

    return sampler


def sample_batch_sharded(
    bundle: Bundle,
    ctx: RankContext,
    single: np.ndarray,
    pair: np.ndarray,
    batch: int,
    seed: int = 0,
) -> dict[str, np.ndarray]:
    """DP counterpart of one batch of ``sampling.pipeline.sample``: the
    conditioning is copied to the rank's device and ``batch`` samples come
    back as numpy on every rank."""
    dev = bundle.device
    single_d = torch.as_tensor(np.asarray(single, np.float32), device=dev)
    pair_d = torch.as_tensor(np.asarray(pair, np.float32), device=dev)
    sampler = make_sharded_sampler(bundle, ctx, batch, single_d.shape[0])
    pos, rot = sampler(seed, single_d, pair_d)
    return {"pos": pos.cpu().numpy(), "node_orientations": rot.cpu().numpy()}
