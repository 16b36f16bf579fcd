"""Model bundles: reference-format ``config.yaml`` + checkpoint, or random weights.

Counterpart of ``se3diff_tpu/sampling/bundle.py`` (reference
`bioemu/src/bioemu/sample.py:54-140`) without hydra: the reference's
``_target_`` strings map onto this package's classes, so the same
checkpoint ``config.yaml`` drives both packages. A bundle lives on one
device, chosen by the caller: ``"cuda"`` unless ``device="cpu"`` is asked for.
A bundle given a rank's ``sp`` context (the counterpart of the JAX bundle's
``pair_sharding``) builds a sequence-parallel model: each rank loads the same
weights and holds its row slab of the pair tensors.
"""

from __future__ import annotations

import logging
import os
import re
from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import Any, Callable

import torch
import yaml

from se3diff_torch.diffusion import denoise
from se3diff_torch.models.convert import load_checkpoint
from se3diff_torch.models.dig import DiGConditionalScoreModel, init_weights
from se3diff_torch.ops.ipa_attention import check_card_widths
from se3diff_torch.parallel.mesh import RankContext
from se3diff_torch.sde.so3_sde import DiGSO3SDE
from se3diff_torch.sde.vpsde import CosineVPSDE

logger = logging.getLogger(__name__)

DEFAULT_SO3_CACHE_DIR = os.path.join(os.path.expanduser("~"), ".se3diff_so3_cache")

SUPPORTED_MODEL_NAMES = ("bioemu-v1.0",)
_HF_REPO = "microsoft/bioemu"

# bioemu-v1.0's score model (checkpoints/bioemu-v1.0/config.yaml).
BIOEMU_V1_MODEL = dict(
    dim_model=512, dim_pair=256, num_layers=8, num_heads=32, dim_hidden=1024,
    dropout=0.1, num_buckets=64, max_distance_relative=128,
)
# ... and its SO(3) SDE.
BIOEMU_V1_SO3 = dict(
    eps_t=1e-4, num_sigma=1000, num_omega=2000, omega_exponent=3, l_max=2000,
    sigma_min=0.02, sigma_max=2.33, tol=1e-7,
)


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``; raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but is not available; pass device='cpu' "
            "(--device cpu) to run on the CPU"
        )
    return device


def maybe_download_checkpoint(
    model_name: str | None = "bioemu-v1.0",
    ckpt_path: str | os.PathLike | None = None,
    model_config_path: str | os.PathLike | None = None,
    cache_dir: str | None = None,
) -> tuple[str, str]:
    """Resolve (checkpoint, config) paths, pulling from the HuggingFace hub
    when only a model name is given (sample.py:54-105)."""
    if ckpt_path is not None:
        ckpt_path = str(ckpt_path)
        if model_config_path is None:
            model_config_path = os.path.join(os.path.dirname(ckpt_path), "config.yaml")
        return ckpt_path, str(model_config_path)
    if model_name not in SUPPORTED_MODEL_NAMES:
        raise ValueError(f"model_name must be one of {SUPPORTED_MODEL_NAMES}, got {model_name!r}")
    try:
        from huggingface_hub import hf_hub_download

        ckpt = hf_hub_download(
            _HF_REPO, f"checkpoints/{model_name}/checkpoint.ckpt", cache_dir=cache_dir
        )
        cfg = hf_hub_download(_HF_REPO, f"checkpoints/{model_name}/config.yaml", cache_dir=cache_dir)
        return ckpt, cfg
    except Exception as exc:
        raise RuntimeError(
            f"Could not download {model_name} from the HuggingFace hub (offline "
            "environment?); pass ckpt_path/model_config_path for a local checkpoint."
        ) from exc


# _target_ suffix -> constructor.
_TARGETS: dict[str, Callable] = {
    "DiGConditionalScoreModel": DiGConditionalScoreModel,
    "DiGSO3SDE": DiGSO3SDE,
    "CosineVPSDE": CosineVPSDE,
    "dpm_solver": denoise.dpm_solver,
    "dpm_solver_pp2m": denoise.dpm_solver_pp2m,
    "heun_denoiser": denoise.heun,
    "euler_maruyama_predictor": denoise.euler_maruyama,
    # PPFT path recorders (config/denoiser/*_finetune.yaml).
    "euler_maruyama_predictor_finetune": denoise.euler_maruyama_finetune,
    "heun_denoiser_finetune": denoise.heun_finetune,
    "sde_dpm_solver_finetune": denoise.sde_dpm_solver_finetune,
}

# Scientific notation without a decimal dot: YAML 1.1 reads it as a string.
_NUMERIC_STR = re.compile(r"[+-]?\d+[eE][+-]?\d+")


def instantiate(cfg: dict[str, Any], **overrides: Any):
    """Minimal hydra-style ``_target_`` instantiation against the registry."""
    cfg = dict(cfg)
    target = cfg.pop("_target_")
    partial_ = cfg.pop("_partial_", False)
    for k, v in cfg.items():
        if isinstance(v, str) and _NUMERIC_STR.fullmatch(v):
            cfg[k] = float(v)
    name = target.rsplit(".", 1)[-1]
    if name not in _TARGETS:
        raise KeyError(f"unknown _target_ {target!r}")
    ctor = _TARGETS[name]
    cfg.update(overrides)
    if name == "DiGSO3SDE":
        cfg.setdefault("cache_dir", DEFAULT_SO3_CACHE_DIR)
    if partial_:
        return partial(ctor, **cfg)
    return ctor(**cfg)


@dataclass
class Bundle:
    """A model, its corruption processes and a denoiser, on one device."""

    model: DiGConditionalScoreModel
    sdes: denoise.SDEs
    denoiser: Callable
    config: dict[str, Any]
    device: torch.device

    @property
    def sp(self) -> RankContext | None:
        """The rank's context when the model is sequence-parallel."""
        return self.model.model_nn.sp

    def sampler(self, batch_size: int, length: int) -> Callable:
        """``run(generator, single [L, 384], pair [L, L, 128][, mask [L]]) ->
        (pos, rot)``: embed the conditioning once for the batch, then denoise
        with :meth:`score_from_cache` at every model evaluation. ``mask``
        (True = real residue) masks padded residues out of attention."""

        @torch.inference_mode()
        def run(generator: torch.Generator, single, pair, mask=None):
            s = single.expand(batch_size, *single.shape)
            p = pair.expand(batch_size, *pair.shape)
            m = None if mask is None else mask.expand(batch_size, *mask.shape)
            cache = self.model.embed_conditioning(s, p, m)

            def model_fn(pos, rot, t):
                return self.model.score_from_cache(pos, rot, t, cache)

            return self.denoiser(generator, self.sdes, model_fn, batch=batch_size, length=length)

        return run


DENOISER_DEFAULTS: dict[str, dict[str, Any]] = {
    # config/denoiser/*.yaml in the reference.
    "dpm": dict(fn="dpm_solver", num_steps=50, max_t=0.99, min_t=0.001),
    "dpm_fast": dict(fn="dpm_solver", num_steps=30, max_t=0.99, min_t=0.001),
    # Multistep DPM-Solver++(2M): second order at one model evaluation per step.
    "dpm_2m": dict(fn="dpm_solver_pp2m", num_steps=30, max_t=0.99, min_t=0.001),
    "heun": dict(fn="heun_denoiser", num_steps=100, max_t=0.99, min_t=0.001, noise=0.5),
    "euler_maruyama": dict(fn="euler_maruyama_predictor", num_steps=200, max_t=0.99, min_t=0.001),
}


def make_denoiser(name_or_cfg: str | dict[str, Any]) -> Callable:
    """Denoiser partial from a config name or a reference-format yaml dict."""
    if isinstance(name_or_cfg, str):
        cfg = dict(DENOISER_DEFAULTS[name_or_cfg])
        return partial(_TARGETS[cfg.pop("fn")], **cfg)
    return instantiate({**name_or_cfg, "_partial_": True})


def read_config(checkpoint_path: str | os.PathLike,
                config_path: str | os.PathLike | None = None) -> dict[str, Any]:
    """The reference-format config: ``config_path``, else the
    ``config.yaml`` beside the checkpoint."""
    if config_path is None:
        config_path = Path(checkpoint_path).parent / "config.yaml"
    with open(config_path) as f:
        return yaml.safe_load(f)


def load_bundle(
    checkpoint_path: str | os.PathLike,
    config_path: str | os.PathLike | None = None,
    denoiser: str | dict[str, Any] = "dpm",
    so3_cache_dir: str | None = None,
    model_key: str = "score_model",
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
    sp: RankContext | None = None,
) -> Bundle:
    """Load (model, sdes, denoiser) from a checkpoint and its config.yaml.

    ``model_key`` selects ``score_model`` or ``finetune_model``; the state
    dict must match the model's reference-named keys exactly. ``sp`` makes
    the model sequence-parallel over the rank's group. On a CUDA device
    the model's attention widths are held against the card's kernels
    (``ValueError``) before the device or the checkpoint is touched.
    """
    config = read_config(checkpoint_path, config_path)
    check_card_widths(config[model_key], device, dtype)
    device = resolve_device(device)
    model: DiGConditionalScoreModel = instantiate(dict(config[model_key]), dtype=dtype, sp=sp)
    model.load_state_dict(load_checkpoint(str(checkpoint_path)), strict=True)
    sde_overrides = {"device": device}
    if so3_cache_dir is not None:
        sde_overrides["cache_dir"] = so3_cache_dir
    sdes = denoise.SDEs(
        pos=instantiate(config["sdes"]["pos"]),
        node_orientations=instantiate(config["sdes"]["node_orientations"], **sde_overrides),
    )
    return Bundle(
        model=model.to(device).eval(), sdes=sdes, denoiser=make_denoiser(denoiser),
        config=config, device=device,
    )


def random_bundle(
    model_cfg: dict[str, Any] | None = None,
    denoiser: str | dict[str, Any] = "dpm",
    seed: int = 0,
    so3_kwargs: dict[str, Any] | None = None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
    sp: RankContext | None = None,
) -> Bundle:
    """Bundle with weights drawn from ``seed`` (tests, benchmarks, smoke runs).

    The model defaults to the bioemu-v1.0 widths; the SO(3) tables default
    to a small grid.
    """
    cfg = dict(BIOEMU_V1_MODEL)
    cfg.update(model_cfg or {})
    check_card_widths(cfg, device, dtype)
    device = resolve_device(device)
    model = DiGConditionalScoreModel(**cfg, dtype=dtype, sp=sp)
    init_weights(model, torch.Generator().manual_seed(seed))

    so3 = dict(num_sigma=100, num_omega=500, l_max=500)
    so3.update(so3_kwargs or {})
    sdes = denoise.SDEs(pos=CosineVPSDE(), node_orientations=DiGSO3SDE(**so3, device=device))
    return Bundle(
        model=model.to(device).eval(), sdes=sdes, denoiser=make_denoiser(denoiser),
        config={"score_model": cfg}, device=device,
    )


def initialize_weights_to_near_zero(model: torch.nn.Module, scale: float = 1e-6) -> torch.nn.Module:
    """Scale weight matrices, embeddings and point weights toward zero and
    keep layer norms and biases (finetune.py:102-122), in place; returns
    ``model``. A finetune model so scaled starts as a (near-)zero control,
    so fine-tuning starts from the base model's distribution."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 2 or name.endswith("trained_point_weight"):
                p.mul_(scale)
    return model
