"""The port's SO(3) toy (``se3diff_torch.toy``) against ``se3diff_tpu.toy``.

On the CPU at small SO(3) tables (num_sigma 32, num_omega 256, l_max 200),
f32. The flax ``ScoreNet`` parameters are carried across by
``state_dict_from_flax``, and JAX's draws (recovered by replaying its key
splits) are fed to the port's deterministic cores:

* ``ScoreNet`` forward at atol 1e-5; the mixture draw on JAX's component
  indices, axis normals and angle uniforms at atol 1e-5;
* the analytic mixture pdf and ``assign_igso3`` at atol 1e-4;
* the DSM loss on JAX's ``(x_0, t, x_t)`` at rtol 1e-5, its gradients within
  1e-4 of each gradient's largest entry, and three ``train_toy`` steps
  (losses and parameters at atol 1e-5);
* both reverse samplers over 8 steps at B=16 on JAX's prior and normals
  (xs, us and dWs within 1e-4), and the fine-tuning loss and its gradient on
  those draws at rtol 1e-4;
* the entry points refuse ``device="cuda"`` where CUDA is absent.
"""

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch import toy as ttoy
from se3diff_torch.toy import finetune as tft
from se3diff_torch.toy import train as ttrain
from se3diff_torch.toy.models import DiGMixSO3SDE as TorchMix
from se3diff_torch.toy.models import ScoreNet as TorchNet
from se3diff_torch.toy.models import state_dict_from_flax
from se3diff_tpu import toy as jtoy
from se3diff_tpu.toy import finetune as jft
from se3diff_tpu.toy import train as jtrain
from se3diff_tpu.toy.models import DiGMixSO3SDE as JaxMix
from se3diff_tpu.toy.models import ScoreNet as JaxNet

SO3 = dict(num_sigma=32, num_omega=256, l_max=200)
L_MAX = 200
B, STEPS = 16, 8
TRAIN_B = 64
MUS = np.stack([
    np.eye(3),
    [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]],
    [[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0]],
]).astype(np.float32)
SIGMAS = np.array([0.2, 0.1, 0.3], np.float32)
WEIGHTS = np.array([0.3, 0.4, 0.3], np.float32)
H_STARS = np.array([0.4, 0.2, 0.4], np.float32)
MIX = tuple(jnp.asarray(a) for a in (MUS, SIGMAS, WEIGHTS))
TMIX = tuple(torch.from_numpy(a) for a in (MUS, SIGMAS, WEIGHTS))


@pytest.fixture(scope="module", autouse=True)
def jax_in_f32():
    """The JAX package's toy as it runs outside the tests: without x64, so
    its uniform draws and time grid are f32 like the port's."""
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def sdes():
    return JaxMix(**SO3), TorchMix(**SO3)


class _CompiledInitNet(JaxNet):
    """The flax ScoreNet with its ``init`` compiled as one program (run op by
    op, as ``train_toy`` calls it, it takes seconds)."""

    def init(self, *args, **kwargs):
        return jax.jit(super().init)(*args, **kwargs)


def _init(key):
    return _CompiledInitNet().init(key, jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (1, 3, 3)),
                                   jnp.zeros((1,), jnp.float32))


def _port_net(params):
    net = TorchNet()
    net.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return net


@pytest.fixture(scope="module")
def nets():
    """Score model and finetune model, flax and port, on the same weights."""
    params, ft_params = _init(jax.random.key(1)), _init(jax.random.key(2))
    return params, ft_params, _port_net(params), _port_net(ft_params)


def _jfn(params):
    return lambda x, t: JaxNet().apply(params, x, t)


def _rotations(rng, n):
    q = np.stack([np.linalg.qr(rng.standard_normal((3, 3)))[0] for _ in range(n)])
    return (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def test_package_exports_jax_s_names():
    assert ttoy.__all__ == jtoy.__all__
    assert all(hasattr(ttoy, n) for n in ttoy.__all__)


def test_score_net_forward_matches_flax(nets, rng):
    params, _, net, _ = nets
    x = _rotations(rng, 64)
    t = rng.uniform(0.0, 1.0, 64).astype(np.float32)
    want = np.asarray(jax.jit(_jfn(params))(jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = net(_t(x), _t(t))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert net.rot_ln.eps == 1e-6


def test_default_init_is_flax_s_lecun_normal():
    torch.manual_seed(0)
    net = TorchNet()
    for lin in (net.rot_embed, net.fc1, net.fc2, net.fc3):
        std = float(lin.weight.detach().std())
        assert abs(std - lin.in_features ** -0.5) < 0.25 * lin.in_features ** -0.5
        assert float(lin.weight.detach().abs().max()) <= 2.0 * lin.in_features ** -0.5 / 0.8796 + 1e-6
        assert not lin.bias.any()


def _jax_mixture_draws(key, n):
    """What JaxMix.sample_multiple_igso3(key, ...) draws (toy/models.py,
    so3_sde.py: sample_igso3, _sample_angles)."""
    key_k, key_r = jax.random.split(key)
    k = jax.random.categorical(key_k, jnp.log(MIX[2] + 1e-12), shape=(n,))
    key_axis, key_angle = jax.random.split(key_r)
    axes = jax.random.normal(key_axis, (n, 3), jnp.float32)
    p = jax.random.uniform(key_angle, (n,), jnp.float32)
    return torch.from_numpy(np.array(k)), _t(axes), _t(p)


@lru_cache
def _mixture_fn(jsde, n):
    return jax.jit(lambda key: jsde.sample_multiple_igso3(key, *MIX, n))


def test_mixture_draw_on_jax_s_draws(sdes):
    jsde, tsde = sdes
    key = jax.random.key(3)
    want = np.asarray(_mixture_fn(jsde, 256)(key))
    got = tsde.mixture_from_draws(TMIX[0], TMIX[1], *_jax_mixture_draws(key, 256))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    drawn = tsde.sample_multiple_igso3(torch.Generator().manual_seed(0), *TMIX, 256)
    again = tsde.sample_multiple_igso3(torch.Generator().manual_seed(0), *TMIX, 256)
    assert drawn.shape == (256, 3, 3) and torch.equal(drawn, again)
    eye = torch.eye(3).expand(256, 3, 3)
    torch.testing.assert_close(drawn.transpose(-1, -2) @ drawn, eye, atol=1e-5, rtol=0)


def test_mixture_marginal_pdf_matches_jax():
    omega, pdf = ttrain.igso3_mixture_marginal_pdf(*TMIX, l_max=L_MAX, num_points=200)
    jomega, jpdf = jax.jit(partial(jtrain.igso3_mixture_marginal_pdf, l_max=L_MAX, num_points=200))(*MIX)
    np.testing.assert_allclose(omega.numpy(), np.asarray(jomega), atol=1e-6, rtol=0)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), atol=1e-4, rtol=0)
    assert float(pdf.max()) > 1.0


def test_assign_igso3_matches_jax(sdes):
    """Within 1e-4 of JAX, or no farther from the float64 evaluation than
    JAX is: in the tails of every component the f32 series is rounding noise
    in both packages (ROADMAP § C)."""
    jsde, _ = sdes
    x_0 = np.array(_mixture_fn(jsde, 256)(jax.random.key(4)))
    assign = jax.jit(partial(jft.assign_igso3, l_max=L_MAX))
    for prior in (WEIGHTS, H_STARS):
        got = tft.assign_igso3(_t(x_0), TMIX[0], TMIX[1], _t(prior), l_max=L_MAX).numpy()
        want = np.asarray(assign(jnp.asarray(x_0), MIX[0], MIX[1], jnp.asarray(prior)))
        f64 = tft.assign_igso3(torch.from_numpy(x_0).double(), TMIX[0].double(), TMIX[1].double(),
                               torch.from_numpy(prior).double(), l_max=L_MAX).numpy()
        jax_err = np.abs(want - f64)
        assert np.all(np.abs(got - want) <= 1e-4 + jax_err)
        assert np.mean(jax_err > 1e-4) < 0.01
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-4)


@lru_cache
def _train_draws_fn(jsde, n):
    """(x_0, t, x_t) of JAX's compute_train_loss(key, ...) (toy/train.py)."""

    @jax.jit
    def draws(key):
        k0, kt, km = jax.random.split(key, 3)
        x_0 = jsde.sample_multiple_igso3(k0, *MIX, n)
        t = jax.random.uniform(kt, (n,))
        return x_0, t, jsde.sample_marginal(km, x_0, t)

    return draws


def _jax_train_draws(jsde, key, n):
    return tuple(_t(x) for x in _train_draws_fn(jsde, n)(key))


def _grads_as_state_dict(grads):
    return state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))


def test_train_loss_and_gradients_on_jax_s_draws(sdes, nets):
    jsde, tsde = sdes
    params, _, net, _ = nets
    key = jax.random.key(5)

    def jloss(p):
        return jtrain.compute_train_loss(key, jsde, _jfn(p), *MIX, TRAIN_B)

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    x_0, t, x_t = _jax_train_draws(jsde, key, TRAIN_B)
    net.zero_grad(set_to_none=True)
    loss = ttrain.train_loss_from_draws(net, tsde, x_0, x_t, t)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    ref = _grads_as_state_dict(jgrads)
    for name, p in net.named_parameters():
        scale = float(ref[name].abs().max())
        assert scale > 0, name
        err = float((p.grad - ref[name]).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)
    net.zero_grad(set_to_none=True)


def test_three_train_toy_steps_match_jax(sdes):
    """Losses at atol 1e-5; parameters at atol 1e-5 wherever no step's
    gradient lies in (0, 1e-7). There Adam's ``g / (|g| + 1e-8)`` turns the
    f32 rounding of a near-zero gradient into a visible share of the
    learning rate, so those entries (under 1% of them) are only held to
    Adam's largest move; ``test_adamw_is_optax_adamw`` holds the optimizer
    itself."""
    jsde, _ = sdes
    tsde = TorchMix(**SO3)
    key = jax.random.key(6)
    params, losses = jtrain.train_toy(key, jsde, _CompiledInitNet(), *MIX, num_steps=3,
                                      batch_size=TRAIN_B)

    # Replay train_toy's key splits: the initial parameters, then one key a step.
    key, init_key = jax.random.split(key)
    step_keys = []
    for _ in range(3):
        key, k = jax.random.split(key)
        step_keys.append(k)
    net = _port_net(_init(init_key))
    small = {name: torch.zeros_like(p, dtype=torch.bool) for name, p in net.named_parameters()}

    def record_small(name):
        def hook(p):
            small[name].logical_or_((p.grad != 0) & (p.grad.abs() < 1e-7))
        return hook

    for name, p in net.named_parameters():
        p.register_post_accumulate_grad_hook(record_small(name))
    net, got = ttrain.train_toy(lambda i: _jax_train_draws(jsde, step_keys[i], TRAIN_B), tsde, net,
                                *TMIX, num_steps=3, batch_size=TRAIN_B, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(losses), atol=1e-5, rtol=0)
    want = _grads_as_state_dict(params)
    assert sum(int(m.sum()) for m in small.values()) < 0.01 * sum(m.numel() for m in small.values())
    for name, p in net.named_parameters():
        err = (p.detach() - want[name]).abs()
        assert float(err[~small[name]].max()) <= 1e-5, name
        assert float(err.max()) <= 3 * 5e-3, name


def test_adamw_is_optax_adamw(rng):
    """``train.adamw`` and ``optax.adamw`` on the same gradients."""
    import optax

    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [rng.standard_normal((4, 5)).astype(np.float32) * s for s in (1.0, 1e-3, 1e-7, 10.0)]
    tx = optax.adamw(5e-3)
    jp, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    lin = torch.nn.Linear(5, 4, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(p0))
    opt = ttrain.adamw(lin, 5e-3)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        lin.weight.grad = torch.from_numpy(g)
        opt.step()
    # A few f32 roundings apart.
    np.testing.assert_allclose(lin.weight.detach().numpy(), np.asarray(jp), atol=1e-7, rtol=1e-6)


@lru_cache
def _reverse_draws_fn(jsde):
    """Prior and per-step normals of JAX's reverse samplers (toy/train.py,
    toy/finetune.py: one split for the prior, one a step)."""

    @jax.jit
    def draws(key):
        key, prior_key = jax.random.split(key)
        prior = jsde.prior_sampling(prior_key, (B, 3, 3))
        z = []
        for _ in range(STEPS):
            key, k = jax.random.split(key)
            z.append(jax.random.normal(k, (B, 3), jnp.float32))
        return prior, jnp.stack(z)

    return draws


def _jax_reverse_draws(jsde, key):
    return tuple(_t(x) for x in _reverse_draws_fn(jsde)(key))


def test_reverse_diffusion_on_jax_s_draws(sdes, nets):
    jsde, tsde = sdes
    params, _, net, _ = nets
    key = jax.random.key(7)
    xs, ts = jax.jit(lambda k: jtrain.reverse_diffusion(k, jsde, _jfn(params), batch_size=B,
                                                     num_steps=STEPS))(key)
    prior, z = _jax_reverse_draws(jsde, key)
    got, got_ts = ttrain.reverse_diffusion_from(prior, tsde, net, z, STEPS)
    assert got.shape == (STEPS + 1, B, 3, 3)
    np.testing.assert_allclose(got_ts.numpy(), np.asarray(ts), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(xs), atol=1e-4, rtol=0)


def test_reverse_finetune_diffusion_on_jax_s_draws(sdes, nets):
    jsde, tsde = sdes
    params, ft_params, net, ft_net = nets
    key = jax.random.key(8)
    want = jax.jit(lambda k: jft.reverse_finetune_diffusion(
        k, jsde, _jfn(params), _jfn(ft_params), batch_size=B, num_steps=STEPS))(key)
    prior, z = _jax_reverse_draws(jsde, key)
    got = tft.reverse_finetune_diffusion_from(prior, tsde, net, ft_net, z, STEPS)
    for name, g, w in zip(("xs", "timesteps", "us", "dWs"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0, err_msg=name)


def _contracting(sde, ops, mus, rotvec, frac=0.9):
    """A base model whose EM mean step takes each state ``frac`` of the way
    to its nearest mixture mean. Its paths end where the mixture's f32
    responsibilities are resolved; from an untrained model's they would be
    rounding noise in both packages (ROADMAP § C). ``ops``: (einsum,
    angle_from_rotmat, argmin)."""
    einsum, angle, argmin = ops

    def fn(x, t):
        rel = einsum("kij,bil->bkjl", mus, x)  # mu_k^T x
        k = argmin(angle(rel)[0], -1)
        q = rotvec(rel[np.arange(x.shape[0]), k])
        # drift * dt = g^2 score / STEPS = -frac q
        score = -frac * q * STEPS / (sde.beta(t) ** 2)[:, None]
        return score / sde.get_score_scaling(t)[:, None]

    return fn


def test_finetune_loss_and_gradient_on_jax_s_draws(sdes, nets):
    """The gradient within 1e-4 of each gradient's largest entry; the value
    at rtol 1e-3. The value of the linearised loss is near zero by
    construction (``int <u, -dW>`` has mean zero): it is the difference of
    terms some 500 times larger, so the rounding of the recorded path (4e-7
    apart between two XLA compilations of the JAX package's own path) moves
    it by some 1e-4 of itself."""
    from se3diff_torch.ops import so3 as tso3
    from se3diff_tpu.ops import so3 as jso3

    jsde, tsde = sdes
    _, ft_params, _, ft_net = nets
    key = jax.random.key(9)
    h_stars = jnp.asarray(H_STARS)
    jbase = _contracting(jsde, (jnp.einsum, jso3.angle_from_rotmat, jnp.argmin), MIX[0],
                         jso3.rotmat_to_rotvec)
    tbase = _contracting(tsde, (torch.einsum, tso3.angle_from_rotmat, torch.argmin), TMIX[0],
                         tso3.rotmat_to_rotvec)

    def jloss(p):
        return jft.compute_finetune_loss(key, jsde, jbase, _jfn(p), MIX[0], MIX[1], h_stars,
                                         batch_size=B, num_steps=STEPS, l_max=L_MAX)

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(ft_params)
    prior, z = _jax_reverse_draws(jsde, key)
    path = tft.reverse_finetune_diffusion_from(prior, tsde, tbase, ft_net, z, STEPS)
    hs = tft.assign_igso3(path[0][-1], TMIX[0], TMIX[1], _t(H_STARS), l_max=L_MAX)
    assert float(hs.max(-1).values.min()) > 0.99 and float(hs.mean(0).min()) > 0.1
    ft_net.zero_grad(set_to_none=True)
    loss = tft.finetune_loss_on_path(path, ft_net, TMIX[0], TMIX[1], _t(H_STARS), l_max=L_MAX)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-3)
    ref = _grads_as_state_dict(jgrads)
    for name, p in ft_net.named_parameters():
        scale = float(ref[name].abs().max())
        err = float((p.grad - ref[name]).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)
    ft_net.zero_grad(set_to_none=True)


def test_public_functions_draw_from_their_generator(sdes, nets):
    _, tsde = sdes
    _, _, net, ft_net = nets
    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    xs, _ = ttrain.reverse_diffusion(gen(), tsde, net, batch_size=B, num_steps=STEPS)
    prior = tsde.prior_sampling(g := gen(), (B, 3, 3))
    xs_from, _ = ttrain.reverse_diffusion_from(prior, tsde, net, g, STEPS)
    assert torch.equal(xs, xs_from)
    loss = tft.compute_finetune_loss(gen(), tsde, net, ft_net, TMIX[0], TMIX[1], _t(H_STARS),
                                     batch_size=B, num_steps=STEPS, l_max=L_MAX)
    path = tft.reverse_finetune_diffusion(gen(), tsde, net, ft_net, batch_size=B, num_steps=STEPS)
    on_path = tft.finetune_loss_on_path(path, ft_net, TMIX[0], TMIX[1], _t(H_STARS), l_max=L_MAX)
    assert torch.equal(loss, on_path) and torch.isfinite(loss)


def test_train_and_finetune_loops_run_on_the_cpu(nets):
    _, _, net, _ = nets
    tsde = TorchMix(**SO3)
    model, losses = ttoy.train_toy(torch.Generator().manual_seed(0), tsde, _port_net(_init(jax.random.key(1))),
                                   *TMIX, num_steps=4, batch_size=32, device="cpu")
    assert losses.shape == (4,) and torch.isfinite(losses).all()
    ft, ft_losses = ttoy.finetune_toy(torch.Generator().manual_seed(0), tsde, model, TorchNet(), TMIX[0],
                                      TMIX[1], _t(H_STARS), num_steps_opt=2, batch_size=8,
                                      num_steps=4, l_max=L_MAX, device="cpu")
    assert ft_losses.shape == (2,) and torch.isfinite(ft_losses).all()
    assert all(p.device.type == "cpu" for p in ft.parameters())


@pytest.mark.parametrize("entry", ["train_toy", "finetune_toy"])
def test_entry_points_refuse_cuda_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available; the error path needs a machine without it")
    tsde = TorchMix(**SO3)
    args = {
        "train_toy": (torch.Generator(), tsde, TorchNet(), *TMIX),
        "finetune_toy": (torch.Generator(), tsde, TorchNet(), TorchNet(), TMIX[0], TMIX[1], _t(H_STARS)),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA was requested but is not available"):
        getattr(ttoy, entry)(*args, device="cuda")
    assert tsde.device.type == "cpu"
