"""Pipeline parallelism (PP) of the PyTorch port
(``parallel/pipeline.py::make_pp_score_fn``, ``training/dsm.py::
pp_train_step``) against the JAX package's ``make_pp_score_fn`` and
sequential model, on gloo ranks on the CPU with K1's plain version.

The JAX package's own cases (``tests/test_parallel.py::
TestPipelineParallel``, ``TestPipelineBf16``) on its model (4 layers,
d_model 16, 4 heads, B=8, L=6), at its tolerances; its 8-device grid
``data=2 x pipe=4`` becomes ``data=1 x pipe=4`` here (at most 4 ranks a
spawn), its ``data=2 x pipe=2`` stays:

(i)   the forward, 4 stages x 1 layer at M=2 and 2 x 2 layers at M=4 (the
      latter with 2 data rows, M=4 microbatches of one), against the port's
      one-process model at atol 1e-5 (the pipeline against the sequential
      model of one package, JAX's relation), and against JAX's
      ``model.apply`` and ``make_pp_score_fn`` at ``1e-4 * max(1,
      |out|max)``: the port's sequential forward itself differs from JAX's
      by 7.1e-5 at outputs of 4.6 and 3.5e-5 at 1.3 on this model (another
      attention, f32);
(ii)  with the last 2 residues masked: the same two tolerances against the
      port's and JAX's ``model.apply``;
(iii) the DSM loss and its gradient through the pipeline (the noise JAX
      draws for a key), 4 stages at M=2 and ``data=2 x pipe=2``, against
      the port's one-process loss and gradient: loss rel 1e-5, gradients
      atol 2e-5; against JAX's sequential loss and gradient at rel 1e-4 and
      ``1e-4 * max(1, |g|max)``, as ``tests/test_torch_training.py`` holds
      the one-process gradient against JAX's (the port's one-process loss
      is 1.7e-5 off JAX's on this model; the pipelined one equals it). The gradients compared are
      the step's, clipped by their global norm (the references clipped the
      same way); each stage holds its layers' gradients, every rank the
      replicated ones, equal bit for bit;
(iv)  bf16: the forward against the port's one-process bf16 model at
      JAX's atol 3e-2 (it is equal here), and against JAX's bf16
      ``model.apply`` at ``3e-2 * max(1, |out|max)``: the port's bf16 model
      is itself 0.038 off JAX's at outputs of 2.8 (another order of bf16
      roundings);
(v)   ``num_layers`` not divisible by the stages raises "not divisible",
      a batch not divisible by the microbatches raises; with one stage the
      pipelined trunk (its recompute backward included) runs in this
      process and equals the model's gradient within 1e-5 of each one's
      largest entry (microbatches round apart from the whole batch).

One spawn of 4 ranks, bounded by group and join timeouts.
"""

from datetime import timedelta
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3diff_torch.diffusion.denoise import SDEs as TorchSDEs
from se3diff_torch.models.convert import state_dict_from_jax
from se3diff_torch.models.dig import DiGConditionalScoreModel as TorchDiG
from se3diff_torch.parallel import programs, run_ranks
from se3diff_torch.parallel.pipeline import make_pp_score_fn
from se3diff_torch.sde.so3_sde import DiGSO3SDE as TorchSO3
from se3diff_torch.sde.vpsde import CosineVPSDE as TorchVP
from se3diff_torch.training.dsm import DSMNoise, clip_by_global_norm, dsm_loss
from se3diff_tpu.diffusion.denoise import SDEs as JaxSDEs
from se3diff_tpu.models.dig import DiGConditionalScoreModel as FlaxDiG
from se3diff_tpu.ops import so3 as jso3
from se3diff_tpu.parallel.mesh import make_mesh
from se3diff_tpu.parallel.pipeline import make_pp_score_fn as jax_make_pp_score_fn
from se3diff_tpu.sde.so3_sde import DiGSO3SDE as JaxSO3
from se3diff_tpu.sde.vpsde import CosineVPSDE as JaxVP
from se3diff_tpu.training import dsm as jdsm
from tests.test_torch_sp_training import _clipped
from tests.test_torch_training import MIN_T, SO3, _jax_noise

W = dict(dim_model=16, dim_pair=8, num_layers=4, num_heads=4, dim_hidden=16, dropout=0.0)
B, L, LR = 8, 6, 1e-4
FWD_ATOL, JAX_FWD_RTOL, LOSS_RTOL, GRAD_ATOL, JAX_GRAD_RTOL, BF16_ATOL = (
    1e-5, 1e-4, 1e-5, 2e-5, 1e-4, 3e-2)
# (data, pipe, microbatches) of the forward cases, then of the gradient cases.
FWD = [(1, 4, 2), (2, 2, 4)]
GRAD = [(1, 4, 2), (2, 2, 2)]
GROUP_TIMEOUT = timedelta(seconds=60)
JOIN_TIMEOUT = 150.0


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    pos = (rng.standard_normal((B, L, 3)) * 0.5).astype(np.float32)
    rot = np.asarray(jso3.rotvec_to_rotmat(
        jnp.asarray(rng.standard_normal((B, L, 3)) * 0.3, jnp.float32)), np.float32)
    t = rng.uniform(0.1, 0.9, (B,)).astype(np.float32)
    single = rng.standard_normal((B, L, 384)).astype(np.float32)
    pair = (rng.standard_normal((B, L, L, 128)) * 0.3).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[:, L - 2:] = False
    flax_model = FlaxDiG(**W)
    args = tuple(map(jnp.asarray, (pos, rot, t, single, pair)))
    params = flax_model.init(jax.random.key(0), *args)
    sd = {k: v.numpy() for k, v in state_dict_from_jax(params).items()}
    batch = {"pos": pos, "rot": rot, "single": single, "pair": pair}
    jsdes = JaxSDEs(pos=JaxVP(), node_orientations=JaxSO3(**SO3))
    key = jax.random.key(11)
    noise = tuple(x.numpy() for x in _jax_noise(key, batch, jsdes))
    return dict(flax_model=flax_model, params=params, sd=sd, args=args, mask=mask,
                inputs=(pos, rot, t, single, pair), batch=batch, jsdes=jsdes, key=key, noise=noise)


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Every PP case of this file in one spawn of 4 ranks."""
    sd, inputs = setup["sd"], setup["inputs"]
    steps = [(programs.pp_score, (data, pipe, W, sd, inputs, M)) for data, pipe, M in FWD]
    steps.append((programs.pp_score, (1, 4, W, sd, inputs + (setup["mask"],), 2)))
    steps += [(partial(programs.pp_step, n_microbatches=M, lr=LR),
               (data, pipe, W, sd, setup["batch"], setup["noise"], SO3)) for data, pipe, M in GRAD]
    steps.append((programs.pp_score, (1, 4, W, sd, inputs, 2, "bfloat16")))
    return run_ranks(programs.in_turn, 4, ["cpu"] * 4, args=(steps,), timeout=JOIN_TIMEOUT,
                     group_timeout=GROUP_TIMEOUT,
                     rendezvous_dir=str(tmp_path_factory.mktemp("rdv")))


def _gathered(outs) -> tuple[np.ndarray, np.ndarray]:
    """The data rows' outputs in batch order, each pipe group's ranks equal."""
    rows = {}
    for o in outs:
        b0, b1 = o["batch_rows"]
        if b0 in rows:
            for a, b in zip(rows[b0], (o["pos"], o["rot"])):
                np.testing.assert_array_equal(a, b)
        rows[b0] = (o["pos"], o["rot"])
    return tuple(np.concatenate([rows[k][i] for k in sorted(rows)]) for i in range(2))


@pytest.mark.parametrize("case", range(len(FWD)), ids=["4stages_x_1layer", "2stages_x_2layers"])
def test_pp_forward_matches_sequential_and_jax(setup, ranks, case):
    data, pipe, M = FWD[case]
    pos, rot = _gathered([r[case] for r in ranks])
    model, params, args = setup["flax_model"], setup["params"], setup["args"]
    ref = jax.jit(model.apply)(params, *args)
    mesh = make_mesh(2 * pipe, model_parallel=pipe, axis_names=("data", "pipe"))
    jax_pp = jax.jit(jax_make_pp_score_fn(model, mesh, n_microbatches=M))(params, *args)
    for got, one, want, want_pp in zip((pos, rot), _one_process(setup), ref, jax_pp):
        np.testing.assert_allclose(got, one, atol=FWD_ATOL)
        for w in (np.asarray(want), np.asarray(want_pp)):
            np.testing.assert_allclose(got, w, atol=JAX_FWD_RTOL * max(1.0, np.abs(w).max()))
    for r in ranks:   # CPU tensors take K1's plain version: no launch
        assert sum(r[case]["launches_by_route"].values()) == 0


def test_pp_forward_with_mask(setup, ranks):
    pos, rot = _gathered([r[len(FWD)] for r in ranks])
    model, params, args = setup["flax_model"], setup["params"], setup["args"]
    ref = jax.jit(model.apply)(params, *args, jnp.asarray(setup["mask"]))
    for got, one, want in zip((pos, rot), _one_process(setup, setup["mask"]), ref):
        np.testing.assert_allclose(got, one, atol=FWD_ATOL)
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, atol=JAX_FWD_RTOL * max(1.0, np.abs(want).max()))


def _one_process(setup, *mask):
    model = TorchDiG(**W).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in setup["sd"].items()}, strict=True)
    with torch.no_grad():
        out = model(*(torch.from_numpy(np.array(x)) for x in (*setup["inputs"], *mask)))
    return [o.numpy() for o in out]


def _merged(outs) -> dict[str, np.ndarray]:
    """The full gradient from the ranks': each stage's layers from its
    rank, the replicated parameters equal on every rank."""
    merged = {}
    for o in outs:
        for k, g in o["grads"].items():
            if k in merged:
                np.testing.assert_array_equal(merged[k], g, err_msg=k)
            merged[k] = g
    return merged


@pytest.mark.parametrize("case", range(len(GRAD)), ids=["4stages_M2", "data2_x_2stages"])
def test_pp_grad_matches_sequential_and_jax(setup, ranks, case):
    data, pipe, M = GRAD[case]
    outs = [r[len(FWD) + 1 + case] for r in ranks]
    for o in outs[1:]:
        assert o["losses"] == outs[0]["losses"]
    stage_layers = W["num_layers"] // pipe
    for r, o in enumerate(outs):
        layers = {int(k.split(".")[4]) for k in o["grads"] if ".encoder.layers." in k}
        stage = r % pipe
        assert layers == set(range(stage * stage_layers, (stage + 1) * stage_layers))
        assert o["backward_calls"] == M * stage_layers // data * data
    got = _merged(outs)

    # The port in one process on the same weights, batch and noise.
    model = TorchDiG(**W).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in setup["sd"].items()}, strict=True)
    sdes = TorchSDEs(pos=TorchVP(), node_orientations=TorchSO3(**SO3))
    loss = dsm_loss(model, {k: torch.from_numpy(v) for k, v in setup["batch"].items()},
                    DSMNoise(*(torch.from_numpy(np.array(x)) for x in setup["noise"])), sdes)
    loss.backward()
    clip_by_global_norm([p.grad for p in model.parameters()], 1.0)
    one = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(one)
    np.testing.assert_allclose(outs[0]["losses"][0], loss.item(), rtol=LOSS_RTOL)
    for k, g in one.items():
        np.testing.assert_allclose(got[k], g, atol=GRAD_ATOL, rtol=0, err_msg=k)

    # JAX's sequential model on the same key.
    jb = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jdsm.dsm_loss(
        p, setup["key"], jb, setup["jsdes"], setup["flax_model"].apply, min_t=MIN_T)))(
        setup["params"])
    jgrads = _clipped({k: v.numpy() for k, v in state_dict_from_jax(jax.device_get(jgrads)).items()
                       if v.numel()})
    np.testing.assert_allclose(outs[0]["losses"][0], float(jloss), rtol=JAX_GRAD_RTOL)
    for k, g in jgrads.items():
        np.testing.assert_allclose(got[k], g, atol=JAX_GRAD_RTOL * max(1.0, np.abs(g).max()),
                                   rtol=0, err_msg=k)


def test_pp_forward_bf16_matches_sequential(setup, ranks):
    pos, rot = _gathered([r[-1] for r in ranks])
    model = TorchDiG(**W, dtype=torch.bfloat16).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in setup["sd"].items()}, strict=True)
    with torch.no_grad():
        one = model(*(torch.from_numpy(np.array(x)) for x in setup["inputs"]))
    ref = jax.jit(FlaxDiG(**W, dtype=jnp.bfloat16).apply)(setup["params"], *setup["args"])
    for got, o, want in zip((pos, rot), one, ref):
        np.testing.assert_allclose(got, o.float().numpy(), atol=BF16_ATOL)
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, atol=BF16_ATOL * max(1.0, np.abs(want).max()))


class _OneRank:
    """A pipe of ``model`` stages without a process group: the stage count
    alone decides the layer split and the refusal; with one stage no
    collective runs."""

    data, data_rank, model_rank, model_group = 1, 0, 0, None

    def __init__(self, model):
        self.model = model


def test_pp_refuses_indivisible_layers_and_batches(setup):
    model = TorchDiG(**W).eval()
    with pytest.raises(ValueError, match="not divisible"):
        make_pp_score_fn(model, _OneRank(3), n_microbatches=2)
    fn = make_pp_score_fn(model, _OneRank(1), n_microbatches=3)
    with pytest.raises(ValueError, match="multiple of n_microbatches"):
        fn(*map(torch.from_numpy, setup["inputs"]))


def test_one_stage_pipeline_gradient_in_process(setup):
    model = TorchDiG(**W).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in setup["sd"].items()}, strict=True)
    inputs = [torch.from_numpy(x) for x in setup["inputs"]]
    fn = make_pp_score_fn(model, _OneRank(1), n_microbatches=4)
    grads = []
    for apply in (model, fn):
        model.zero_grad()
        sum(o.square().sum() for o in apply(*inputs)).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, atol=1e-5 * g.abs().max().item(), rtol=0, msg=k)
