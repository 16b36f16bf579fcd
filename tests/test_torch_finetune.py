"""PPFT fine-tuning in the port against the JAX package.

1. Integrals and losses against the reference's golden recording
   (``tests/test_data/golden_so3/ppft_reference.npz``, float64): values at
   rtol 1e-12, the control gradient at rtol 1e-10 (as tests/test_golden_ppft.py).
2. The h-functions on the SH3 reference, f32, at 1e-6.
3. The predictor's stochastic steps and traceback, and the path recorders
   (``euler_maruyama_finetune``, ``heun_finetune``, ``sde_dpm_solver_finetune``),
   fed JAX's prior and JAX's standard-normal draws (recovered by replaying its
   key splits; the DPM recorder draws none after the prior), on
   tiny DiG models carried over by ``state_dict_from_jax``. f32; the steps
   at 1e-5 of the output scale, the recorded paths at 2e-4 (each model
   evaluation adds a few ulps, the recorder carries them forward; the
   port's attention sums in another order).
4. The replay gradient (f32) on a JAX-recorded path against JAX's
   ``grad_fn`` run in float64: every parameter's gradient within 1e-5 of
   its largest entry on a heun path from t=0.5, within 2e-4 on heun and
   DPM paths from t=0.99.
5. The loop and the CLI on the CPU: checkpoints load in the JAX package.
"""

import inspect
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch.diffusion import denoise as tden
from se3diff_torch.diffusion.predictors import EulerMaruyamaPredictor as TorchEM
from se3diff_torch.models.convert import state_dict_from_jax
from se3diff_torch.models.dig import DiGConditionalScoreModel as TorchDiG
from se3diff_torch.ops import ipa_attention as k1
from se3diff_torch.ppft import h_functions as th
from se3diff_torch.ppft import trainer as ttr
from se3diff_torch.ppft.integrals import compute_int_dws, compute_int_u_u_dt
from se3diff_torch.ppft.losses import compute_ev_loss, compute_kl_loss
from se3diff_torch.sampling.bundle import Bundle, initialize_weights_to_near_zero
from se3diff_torch.sde.so3_sde import DiGSO3SDE as TorchSO3
from se3diff_torch.sde.vpsde import CosineVPSDE as TorchVP
from se3diff_tpu.diffusion import denoise as jden
from se3diff_tpu.diffusion.predictors import EulerMaruyamaPredictor as JaxEM
from se3diff_tpu.models.dig import DiGConditionalScoreModel as FlaxDiG
from se3diff_tpu.ppft import h_functions as jh
from se3diff_tpu.ppft import trainer as jtr
from se3diff_tpu.sampling.bundle import Bundle as JaxBundle
from se3diff_tpu.sde.so3_sde import DiGSO3SDE as JaxSO3
from se3diff_tpu.sde.vpsde import CosineVPSDE as JaxVP

ASSETS = Path(__file__).parent.parent / "assets"
GOLDEN = Path(__file__).parent / "test_data" / "golden_so3" / "ppft_reference.npz"
SO3 = dict(num_sigma=32, num_omega=128, l_max=100, sigma_max=1.65, eps_t=1e-3)
B, L, STEPS = 4, 6, 8
SEQ = "GYDPET"
BASE_CFG = dict(num_layers=1, dim_model=16, dim_pair=8, num_heads=2, dim_hidden=16, dropout=0.0)
FT_CFG = dict(num_layers=1, dim_model=8, dim_pair=8, num_heads=2, dim_hidden=8, dropout=0.0)


# ---------------------------------------------------------------- golden


def _golden_loss(us, g):
    int_dws = compute_int_dws(us=us, dWs=g["dWs"])
    int_uudt = compute_int_u_u_dt(us=us, dts=g["dts"])
    ev = compute_ev_loss(ws=int_dws, hs=g["hs"], h_stars=g["h_stars"],
                         from_int_dws=True, use_stab=True, tol=1e-7)
    kl = compute_kl_loss(ws=int_dws, int_u_u_dt=int_uudt, int_u_u_dt_sg=int_uudt.detach(),
                         from_int_dws=True, use_rloo=True)
    return ev + 0.1 * kl, (int_dws, int_uudt, ev, kl)


def test_integrals_losses_and_gradient_match_golden():
    with np.load(GOLDEN) as d:
        g = {k: torch.from_numpy(d[k]) for k in d}
    us = g["us"].clone().requires_grad_(True)
    loss, (int_dws, int_uudt, ev, kl) = _golden_loss(us, g)
    assert us.dtype == torch.float64
    np.testing.assert_allclose(int_dws.detach().numpy(), g["int_dws"].numpy(), rtol=1e-12)
    np.testing.assert_allclose(int_uudt.detach().numpy(), g["int_uudt"].numpy(), rtol=1e-12)
    np.testing.assert_allclose(ev.item(), float(g["ev"]), rtol=1e-12)
    np.testing.assert_allclose(kl.item(), float(g["kl"]), rtol=1e-12)
    (grad,) = torch.autograd.grad(loss, us)
    np.testing.assert_allclose(grad.numpy(), g["grad_us"].numpy(), rtol=1e-10, atol=1e-14)


def test_validation_losses_match_jax(rng):
    """The ws = 1 forms (no linearization, no stabilization, no RLOO)."""
    from se3diff_tpu.ppft.losses import compute_ev_loss as jev, compute_kl_loss as jkl

    hs, hstar = rng.uniform(0, 1, (5, 2)), rng.uniform(0, 1, 2)
    uu = rng.uniform(0, 3, 5)
    ws = np.ones(5)
    got = (compute_ev_loss(ws=torch.from_numpy(ws), hs=torch.from_numpy(hs), h_stars=torch.from_numpy(hstar),
                           from_int_dws=False, use_stab=False),
           compute_kl_loss(ws=torch.from_numpy(ws), int_u_u_dt=torch.from_numpy(uu),
                           int_u_u_dt_sg=torch.from_numpy(uu), from_int_dws=False, use_rloo=False))
    want = (jev(ws=jnp.asarray(ws), hs=jnp.asarray(hs), h_stars=jnp.asarray(hstar),
                from_int_dws=False, use_stab=False),
            jkl(ws=jnp.asarray(ws), int_u_u_dt=jnp.asarray(uu), int_u_u_dt_sg=jnp.asarray(uu),
                from_int_dws=False, use_rloo=False))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(float(g_), float(w_), rtol=1e-12)


# ---------------------------------------------------------------- h functions


def test_h_functions_match_jax_on_sh3_reference(rng):
    ref_path = str(ASSETS / "structures" / "2vwf_trimmed_SH3.pdb")
    ref = th.load_ref(ref_path)
    np.testing.assert_array_equal(ref, jh.load_ref(ref_path))
    assert th.DEFAULT_SH3_REF == jh.DEFAULT_SH3_REF
    # Near-native and far-from-native samples: p_folded spans (0, 1).
    pos = (ref[None] + rng.standard_normal((3, len(ref), 3)) * np.array([0.02, 0.1, 0.5])[:, None, None])
    pos = pos.astype(np.float32)
    for name in ("folding_stability", "folding_binding"):
        got = th.H_FUNCTIONS[name](ref_path=ref_path)(torch.from_numpy(pos), "seq")
        want = np.asarray(jh.H_FUNCTIONS[name](ref_path=ref_path)(jnp.asarray(pos), "seq"))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    p = th.FoldingStability(ref_path=ref_path)(torch.from_numpy(pos), "")[:, 0]
    np.testing.assert_allclose(float(th.compute_dg(p)), float(jh.compute_dg(jnp.asarray(p.numpy()))),
                               rtol=1e-5)


# ---------------------------------------------------------------- predictors


@pytest.fixture(scope="module")
def sdes(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("so3"))
    return (
        jden.SDEs(pos=JaxVP(), node_orientations=JaxSO3(**SO3, cache_dir=cache)),
        tden.SDEs(pos=TorchVP(), node_orientations=TorchSO3(**SO3, cache_dir=cache, device="cpu")),
    )


def _rot(rng, *shape):
    q = np.stack([np.linalg.qr(rng.standard_normal((3, 3)))[0] for _ in range(int(np.prod(shape)))])
    q *= np.sign(np.linalg.det(q))[:, None, None]
    return q.reshape(*shape, 3, 3).astype(np.float32)


@pytest.mark.parametrize("channel", ["pos", "node_orientations"])
def test_predictor_steps_match_jax(sdes, rng, channel):
    sdes_j, sdes_t = sdes
    x = rng.standard_normal((B, L, 3)).astype(np.float32) if channel == "pos" else _rot(rng, B, L)
    score, u = (rng.standard_normal((B, L, 3)).astype(np.float32) for _ in range(2))
    t, dt = np.full((B,), 0.4, np.float32), np.float32(-0.05)
    key = jax.random.key(3)
    z = np.asarray(jax.random.normal(key, (B, L, 3), jnp.float32))
    em_j, em_t = JaxEM(getattr(sdes_j, channel)), TorchEM(getattr(sdes_t, channel))
    X, T, S, U, Z = (torch.from_numpy(np.array(a)) for a in (x, t, score, u, z))

    got = em_t.update_given_score(Z, X, T, float(dt), S, U)
    want = em_j.update_given_score(key, jnp.asarray(x), jnp.asarray(t), dt, jnp.asarray(score), jnp.asarray(u))
    got_fwd = em_t.forward_sde_step(Z, X, T, float(-dt))
    want_fwd = em_j.forward_sde_step(key, jnp.asarray(x), jnp.asarray(t), -dt)
    for g, w in zip((*got, *got_fwd), (*want, *want_fwd)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * max(1.0, np.abs(w).max()))

    x_next = got[0]
    back = em_t.traceback_brownian_motion(x_next, X, T, float(dt), S, U)
    want_back = em_j.traceback_brownian_motion(
        jnp.asarray(x_next.numpy()), jnp.asarray(x), jnp.asarray(t), dt, jnp.asarray(score), jnp.asarray(u))
    np.testing.assert_allclose(back.numpy(), np.asarray(want_back), atol=1e-4)
    # The traceback recovers the increment the step drew.
    np.testing.assert_allclose(back.numpy(), got[2].numpy(), atol=1e-3)
    # A generator draws a fresh z of the drift's shape.
    drawn = em_t.update_given_score(torch.Generator().manual_seed(0), X, T, float(dt), S)[2]
    assert drawn.shape == (B, L, 3) and not torch.equal(drawn, got[2])


# ---------------------------------------------------------------- recorders


def _flax(cfg, seed, rng, single, pair):
    model = FlaxDiG(**cfg, use_pallas=False)
    variables = jax.jit(model.init)(
        jax.random.key(seed), jnp.zeros((1, L, 3)), jnp.broadcast_to(jnp.eye(3), (1, L, 3, 3)),
        jnp.full((1,), 0.5), jnp.asarray(single[None]), jnp.asarray(pair[None]),
    )
    # Spread the point weights and biases away from their inits.
    variables = jax.tree.map(
        lambda x: x + 0.05 * jnp.asarray(rng.standard_normal(x.shape), x.dtype), variables)
    port = TorchDiG(**cfg).eval()
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model, variables, port


@pytest.fixture(scope="module")
def models(sdes):
    rng = np.random.default_rng(11)
    single = (rng.standard_normal((L, 384)) * 0.3).astype(np.float32)
    pair = (rng.standard_normal((L, L, 128)) * 0.1).astype(np.float32)
    base = _flax(BASE_CFG, 0, rng, single, pair)
    ft = _flax(FT_CFG, 1, rng, single, pair)
    sdes_j, sdes_t = sdes
    jbundle = jtr.FinetuneBundle(
        base=JaxBundle(model=base[0], params=base[1], sdes=sdes_j, denoiser=None, config={}),
        finetune_model=ft[0], finetune_params=ft[1], denoiser=None, h_func=_mean_pos_h_jax,
    )
    tbundle = ttr.FinetuneBundle(
        base=Bundle(model=base[2], sdes=sdes_t, denoiser=None, config={}, device=torch.device("cpu")),
        finetune_model=ft[2], denoiser=None, h_func=_mean_pos_h,
    )
    return jbundle, tbundle, single, pair


def _mean_pos_h_jax(pos, sequence):
    return jax.nn.sigmoid(jnp.mean(pos, axis=(-1, -2)))[:, None]


def _mean_pos_h(pos, sequence):
    """Toy differentiable observable: sigmoid of the mean coordinate, [B, 1]."""
    return torch.sigmoid(pos.mean(dim=(-1, -2)))[:, None]


def _jax_draws(key, steps):
    """The prior key and each step's (z_pos, z_rot), as the JAX recorders
    split their key (denoise.py:163-172, :286-297)."""
    key, prior_key = jax.random.split(key)
    zp, zr = [], []
    for _ in range(steps):
        key, k_pos, k_rot = jax.random.split(key, 3)
        zp.append(np.asarray(jax.random.normal(k_pos, (B, L, 3), jnp.float32)))
        zr.append(np.asarray(jax.random.normal(k_rot, (B, L, 3), jnp.float32)))
    return prior_key, (torch.from_numpy(np.stack(zp)), torch.from_numpy(np.stack(zr)))


# name: (JAX recorder, the port's loop, its arguments after the time grid,
# base and control evaluations a step)
RECORDERS = {
    "euler_maruyama_finetune": (jden.euler_maruyama_finetune, tden._euler_maruyama_finetune_loop, (), 1),
    "heun_finetune": (jden.heun_finetune, tden._heun_finetune_loop, (0.5,), 3),
    "sde_dpm_solver_finetune": (jden.sde_dpm_solver_finetune, tden._sde_dpm_solver_finetune_loop, (), 2),
}


def _jax_path(jbundle, recorder, key, single, pair, steps=STEPS):
    sampler = jtr.make_path_sampler(
        jbundle._replace(denoiser=partial(RECORDERS[recorder][0], num_steps=steps)), B, L)
    return sampler(key, jbundle.base.params, jbundle.finetune_params,
                   jnp.asarray(single), jnp.asarray(pair))


@pytest.mark.parametrize("recorder", sorted(RECORDERS))
def test_recorders_match_jax_on_the_same_prior_and_draws(models, recorder):
    jbundle, tbundle, single, pair = models
    key = jax.random.key(7)
    want = _jax_path(jbundle, recorder, key, single, pair)
    prior_key, draws = _jax_draws(key, STEPS)
    pos0, rot0 = jden._prior(prior_key, jbundle.base.sdes, B, L, jnp.float32)
    np.testing.assert_array_equal(np.asarray(pos0), np.asarray(want.pos_path[0]))

    calls = {"pa": 0, "w_pb": 0}
    real = k1.ipa_attention

    def spy(*args, **kw):
        calls["pa" if args[9] is not None else "w_pb"] += 1
        return real(*args, **kw)

    _, loop, extra, per_step = RECORDERS[recorder]
    noise = (draws,) if "draws" in inspect.signature(loop).parameters else ()
    s, p = torch.from_numpy(single), torch.from_numpy(pair)
    base = tbundle.base.model
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(k1, "ipa_attention", spy)
        cache = base.embed_conditioning(s.expand(B, L, 384), p.expand(B, L, L, 128))
        ft_fn = ttr._finetune_model_fn(tbundle, s, p, B)
        got = loop(tbundle.base.sdes, lambda x, r, t: base.score_from_cache(x, r, t, cache), ft_fn,
                   torch.from_numpy(np.array(pos0)), torch.from_numpy(np.array(rot0)), *noise,
                   STEPS, 0.99, 0.001, *extra, torch.float32)
    evals = STEPS * per_step
    # Base model (1 layer) on the streamed pair bias, control net in-kernel.
    assert calls == {"pa": evals, "w_pb": evals}
    pairs = [(got.pos_path, want.pos_path), (got.rot_path, want.rot_path),
             (got.timesteps, want.timesteps)]
    pairs += [(got.us[k], want.us[k]) for k in got.us] + [(got.dWs[k], want.dWs[k]) for k in got.dWs]
    for g, w in pairs:
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4 * max(1.0, np.abs(w).max()))


def test_public_recorder_draws_from_its_generator(models):
    _, tbundle, single, pair = models
    bundle = tbundle._replace(denoiser=partial(tden.heun_finetune, num_steps=3))
    runs = [ttr.generate_finetune_batch(torch.Generator().manual_seed(2), bundle,
                                        torch.from_numpy(single), torch.from_numpy(pair), 2)
            for _ in range(2)]
    for a, b in zip(runs[0][:3], runs[1][:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert runs[0].pos_path.shape == (4, 2, L, 3) and runs[0].us["pos"].shape == (3, 2, L, 3)


# ---------------------------------------------------------------- replay gradient


def _float64(tree):
    return jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _replay_gradients(models, max_t, recorder=jden.heun_finetune):
    """The port's f32 replay gradient and JAX's ``grad_fn`` in float64 on the
    same parameters and the same JAX-recorded f32 path from ``max_t``.
    Returns each gradient's largest error relative to its largest entry,
    and the two validation losses."""
    import dataclasses

    jbundle, tbundle, single, pair = models
    sampler = jtr.make_path_sampler(
        jbundle._replace(denoiser=partial(recorder, num_steps=STEPS, max_t=max_t)), B, L)
    path = sampler(jax.random.key(9), jbundle.base.params, jbundle.finetune_params,
                   jnp.asarray(single), jnp.asarray(pair))
    hs = _mean_pos_h_jax(path.pos_path[-1], SEQ)
    h_stars = jnp.asarray([0.9], jnp.float32)
    jb64 = jbundle._replace(
        base=dataclasses.replace(jbundle.base, model=jbundle.base.model.clone(dtype=jnp.float64),
                                 params=_float64(jbundle.base.params)),
        finetune_model=jbundle.finetune_model.clone(dtype=jnp.float64),
        finetune_params=_float64(jbundle.finetune_params),
    )
    grad_fn_j, _ = jtr.make_finetune_step_fns(jb64, lambda_=0.1)
    grads_j, val_j = grad_fn_j(jb64.finetune_params, _float64(path), jnp.asarray(single, jnp.float64),
                               jnp.asarray(pair, jnp.float64), _float64(hs), _float64(h_stars))
    want = {k: v.double() for k, v in state_dict_from_jax(grads_j).items()}

    to_t = lambda x: torch.from_numpy(np.array(x, np.float32))
    tpath = tden.DenoisedSDEPath(
        to_t(path.pos_path), to_t(path.rot_path), to_t(path.timesteps),
        {k: to_t(v) for k, v in path.us.items()}, {k: to_t(v) for k, v in path.dWs.items()})
    grad_fn, _ = ttr.make_finetune_step_fns(tbundle, lambda_=0.1)
    backwards = k1.backward_calls
    grads, val = grad_fn(tpath, torch.from_numpy(single), torch.from_numpy(pair), to_t(hs), to_t(h_stars))
    # One K1 backward per layer per recorded step (checkpointed replay).
    assert k1.backward_calls == backwards + STEPS * FT_CFG["num_layers"]
    assert set(grads) == {k for k in want if k != "model_nn.step_emb.dummy"}
    errors = {}
    for name, g in grads.items():
        w = want[name]
        scale = w.abs().max().item()
        assert scale > 0, name
        errors[name] = (g.double() - w).abs().max().item() / scale
    return errors, float(val), float(val_j)


def test_replay_gradient_matches_jax_grad_fn(models):
    """The port's f32 replay gradient against JAX's ``grad_fn`` run in
    float64 on a JAX-recorded f32 path from t=0.5, where positions stay
    within a few nm: within 1e-5 of each gradient's largest entry. (JAX's
    own f32 ``grad_fn`` is 0.7-1.5e-5 from its float64 one on such paths,
    so two f32 gradients cannot be held to 1e-5 of each other.)"""
    errors, val, val_j = _replay_gradients(models, max_t=0.5)
    np.testing.assert_allclose(val, val_j, rtol=1e-5)
    for name, err in errors.items():
        assert err <= 1e-5, (name, err)


def test_replay_gradient_from_t099_matches_jax_grad_fn(models):
    """As above on a path from t=0.99, the production recorders' start
    (``FINETUNE_DENOISERS``), whose positions reach some 200 nm. There
    JAX's own f32 ``grad_fn`` is about 3e-5 from its float64 one and the
    port's f32 gradient about 4e-5, so the port is held to 2e-4 of each
    gradient's largest entry."""
    errors, val, val_j = _replay_gradients(models, max_t=0.99)
    np.testing.assert_allclose(val, val_j, rtol=1e-5)
    for name, err in errors.items():
        assert err <= 2e-4, (name, err)


def test_replay_gradient_on_a_dpm_path_matches_jax_grad_fn(models):
    """As above on a path that ``sde_dpm_solver_finetune`` recorded from
    t=0.99: the replay reads only ``(pos_path, rot_path, timesteps, us,
    dWs)``, so a DPM path replays as a heun path does. Held to 2e-4 of each
    gradient's largest entry."""
    errors, val, val_j = _replay_gradients(models, max_t=0.99, recorder=jden.sde_dpm_solver_finetune)
    np.testing.assert_allclose(val, val_j, rtol=1e-5)
    for name, err in errors.items():
        assert err <= 2e-4, (name, err)


# ---------------------------------------------------------------- loop and CLI


def test_loop_on_the_cpu_writes_checkpoints_jax_loads(models, tmp_path):
    _, tbundle, _, _ = models
    ft = TorchDiG(**FT_CFG).eval()
    ft.load_state_dict(tbundle.finetune_model.state_dict())
    bundle = tbundle._replace(finetune_model=ft,
                              denoiser=partial(tden.euler_maruyama_finetune, num_steps=4))
    csv = tmp_path / "train.csv"
    csv.write_text("seq,h0\n" + f"{SEQ},0.8\nGYDPEA,0.7\n")
    cfg = ttr.FinetuneConfig(batch_size=3, num_epochs=1, save_every_n_epochs=1,
                             val_every_n_epochs=1, lambda_=0.01)
    before = {k: v.clone() for k, v in ft.state_dict().items()}
    best = ttr.finetune(csv, csv, "seq", "h0", bundle, cfg, output_dir=tmp_path / "out",
                        cache_embeds_dir=str(tmp_path / "embeds"), embeds_backend="dummy", seed=0)
    out = tmp_path / "out"
    import json

    hist = json.loads((out / "history.json").read_text())
    assert [v["epoch"] for v in hist["val"]] == [0, 1] and hist["train"][0]["skipped_updates"] == 0
    assert any(not torch.equal(before[k], v) for k, v in ft.state_dict().items())
    ck = {e: jtr.load_finetune_params(out / f"finetune_model_{e}.npz") for e in (0, 1)}
    leaves = [jax.tree.leaves(ck[e]) for e in (0, 1)]
    assert sum(float(np.abs(np.asarray(a) - np.asarray(b)).sum()) for a, b in zip(*leaves)) > 0
    jax_best = jtr.load_finetune_params(out / "finetune_model.npz")
    np.testing.assert_array_equal(
        np.asarray(jax_best["params"]["model_nn"]["st_module"]["layer_0"]["attn"]["fc_out"]["bias"]),
        best["model_nn.st_module.encoder.layers.0.attn.fc_out.bias"].numpy())
    # ... and the port reads the JAX package's own export.
    jtr.save_finetune_params(jax_best, tmp_path / "from_jax.npz")
    back = TorchDiG(**FT_CFG)
    back.load_state_dict(ttr.load_finetune_params(tmp_path / "from_jax.npz"), strict=True)
    for k, v in back.state_dict().items():
        torch.testing.assert_close(v, best[k], rtol=0, atol=0, msg=k)


def test_kl_guard_skips_every_update(models, tmp_path):
    _, tbundle, _, _ = models
    ft = TorchDiG(**FT_CFG).eval()
    ft.load_state_dict(tbundle.finetune_model.state_dict())
    bundle = tbundle._replace(finetune_model=ft,
                              denoiser=partial(tden.euler_maruyama_finetune, num_steps=3))
    csv = tmp_path / "train.csv"
    csv.write_text("seq,h0\n" + f"{SEQ},0.8\n{SEQ},0.8\n")
    cfg = ttr.FinetuneConfig(batch_size=3, num_epochs=1, save_every_n_epochs=1,
                             val_every_n_epochs=1, kl_guard=-1.0)
    ttr.finetune(csv, csv, "seq", "h0", bundle, cfg, output_dir=tmp_path / "out",
                 cache_embeds_dir=str(tmp_path / "embeds"), embeds_backend="dummy")
    import json

    assert json.loads((tmp_path / "out" / "history.json").read_text())["train"][0]["skipped_updates"] == 2
    with np.load(tmp_path / "out" / "finetune_model_0.npz") as a, \
            np.load(tmp_path / "out" / "finetune_model_1.npz") as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_dataset_batches(tmp_path):
    csv = tmp_path / "d.csv"
    csv.write_text("seq,a,b\nAAA,0.1,0.2\nCCC,0.3,0.4\nDDD,0.5,0.6\n")
    ds = ttr.SequenceHStarsDataset(csv, "seq", ["a", "b"])
    ref = jtr.SequenceHStarsDataset(csv, "seq", ["a", "b"])
    assert len(ds) == 3 and ds[1][0] == "CCC"
    np.testing.assert_array_equal(ds[1][1], ref[1][1])
    order = [[s for s, _ in b] for b in ds.batches(2, True, np.random.default_rng(5))]
    assert order == [[s for s, _ in b] for b in ref.batches(2, True, np.random.default_rng(5))]
    # Free-energy columns become sigmoid(-dg) targets, computed in float64.
    dg = np.array([[0.1, 0.2], [0.3, 0.4], [0.5, 0.6]])
    np.testing.assert_array_equal(ttr.SequenceHStarsDataset(csv, "seq", ["a", "b"], from_dg=True).h_stars,
                                  (1.0 / (1.0 + np.exp(dg))).astype(np.float32))
    with pytest.raises(ValueError):
        ttr.SequenceHStarsDataset(csv, "seq", ["missing"])


def test_near_zero_init_matches_jax(models):
    jbundle, _, _, _ = models
    from se3diff_tpu.sampling.bundle import initialize_weights_to_near_zero as jax_near_zero

    port = TorchDiG(**FT_CFG)
    port.load_state_dict(state_dict_from_jax(jbundle.finetune_params))
    initialize_weights_to_near_zero(port)
    want = state_dict_from_jax(jax_near_zero(jbundle.finetune_params))
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=1e-6, atol=0, msg=k)


TINY_CONFIG = """
score_model:
  _target_: bioemu.shortcuts.DiGConditionalScoreModel
  dim_hidden: 16
  dim_model: 16
  dim_pair: 8
  dropout: 0.0
  num_heads: 2
  num_layers: 1
finetune_model:
  _target_: bioemu.shortcuts.DiGConditionalScoreModel
  dim_hidden: 8
  dim_model: 8
  dim_pair: 8
  dropout: 0.0
  num_heads: 2
  num_layers: 1
sdes:
  node_orientations:
    _target_: bioemu.shortcuts.DiGSO3SDE
    eps_t: 0.001
    l_max: 100
    num_omega: 128
    num_sigma: 32
    omega_exponent: 3
    sigma_max: 1.65
    sigma_min: 0.02
    tol: 1.0e-07
  pos:
    _target_: bioemu.shortcuts.CosineVPSDE
    s: 0.008
"""


def test_cli_on_grb2_csv_on_the_cpu(tmp_path):
    """``python -m se3diff_torch.finetune --device cpu`` on two GRB2-SH3
    mutants: sigmoid(-dg) targets, FoldingStability on the SH3 reference,
    a near-zero control net from ``--finetune_ckpt_path``; the output loads
    in the JAX package."""
    from se3diff_torch import finetune as cli
    from se3diff_torch.models.dig import init_weights

    lines = (ASSETS / "reference_h" / "GRB2_SH3_high_confidence.csv").read_text().splitlines()
    (tmp_path / "grb2.csv").write_text("\n".join(lines[:3]) + "\n")
    (tmp_path / "config.yaml").write_text(TINY_CONFIG)
    score = init_weights(TorchDiG(num_layers=1, dim_model=16, dim_pair=8, num_heads=2, dim_hidden=16),
                         torch.Generator().manual_seed(0))
    np.savez(tmp_path / "score.npz", **{k: v.numpy() for k, v in score.state_dict().items()})
    ft = initialize_weights_to_near_zero(init_weights(TorchDiG(**FT_CFG), torch.Generator().manual_seed(1)))
    ttr.save_finetune_params(ft.state_dict(), tmp_path / "ft0.npz")
    out, dump = tmp_path / "out", tmp_path / "dump"
    cli.main([
        "--csv_path", str(tmp_path / "grb2.csv"), "--csv_path_val", str(tmp_path / "grb2.csv"),
        "--h_stars_cols", "f_dg_pred", "--h_stars_from_dg",
        "--ckpt_path", str(tmp_path / "score.npz"), "--model_config_path", str(tmp_path / "config.yaml"),
        "--finetune_ckpt_path", str(tmp_path / "ft0.npz"),
        # The reference trainer YAML loads; the flags below override it.
        "--finetune_config_path", str(Path(jtr.__file__).parent.parent / "config" / "finetune" / "finetune.yaml"),
        "--h_func_ref_path", str(ASSETS / "structures" / "2vwf_trimmed_SH3.pdb"),
        "--num_steps", "3", "--batch_size", "3", "--num_epochs", "1", "--output_dir", str(out),
        "--cache_embeds_dir", str(tmp_path / "embeds"), "--embeds_backend", "dummy",
        "--so3_cache_dir", str(tmp_path / "so3"), "--debug_dump_dir", str(dump), "--device", "cpu",
    ])
    jtr.load_finetune_params(out / "finetune_model.npz")
    import json

    cfg = json.loads((out / "history.json").read_text())["config"]
    assert (cfg["batch_size"], cfg["num_epochs"], cfg["save_every_n_epochs"]) == (3, 1, 2)
    assert (dump / "topology.pdb").exists() and len(list(dump.glob("batch_*.npz"))) == 1


@pytest.mark.parametrize("body,msg", [
    ("_target_: my.custom.MyHFunc\n", "unknown _target_"),
    ("_target_: bioemu.shortcuts.FoldingStability\nkk: -24.0\n", "unknown kwargs"),
])
def test_cli_refuses_bad_h_func_yaml(tmp_path, body, msg):
    from se3diff_torch import finetune as cli

    (tmp_path / "h.yaml").write_text(body)
    with pytest.raises(SystemExit, match=msg):
        cli._h_func_from_yaml(str(tmp_path / "h.yaml"))
