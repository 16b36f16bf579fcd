"""Weights for the DiG score model: reference checkpoints and JAX parameters.

The port's module names are the reference's, so a bioemu state dict loads
into :class:`se3diff_torch.models.dig.DiGConditionalScoreModel` as it is.
:func:`state_dict_from_jax` carries the JAX package's flax parameters (as
numpy) into that layout, mirroring ``flax_to_torch_state_dict``:

* flax ``kernel [in, out]`` -> torch ``weight [out, in]`` (transpose),
* ``{x}_ln`` + ``{x}_proj`` -> ``{x}_proj.0`` / ``{x}_proj.1``,
* ``ffn/fc1``, ``ffn/fc2`` -> ``ffn.ff.0``, ``ffn.ff.3``,
* ``fc_{t,eps}_ln`` / ``_fc1`` / ``_fc2`` -> ``fc_{t,eps}.0`` / ``.1`` / ``.3``,
* ``rp_proj`` embedding as it is, plus the empty ``step_emb.dummy`` sentinel.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

# Linear submodules inside attention: kernels are transposed into weights.
_ATTN_LINEARS = (
    "scalar_query",
    "scalar_key",
    "scalar_value",
    "point_query",
    "point_key",
    "point_value",
    "pair_bias",
    "pair_value",
    "fc_out",
)


def state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``{"params": {"model_nn": ...}}`` variables -> the port's state dict."""
    params = variables["params"]["model_nn"]
    sd: dict[str, np.ndarray] = {}

    for name in ("x1d", "x2d"):
        sd[f"model_nn.{name}_proj.0.weight"] = np.asarray(params[f"{name}_ln"]["scale"])
        sd[f"model_nn.{name}_proj.0.bias"] = np.asarray(params[f"{name}_ln"]["bias"])
        sd[f"model_nn.{name}_proj.1.weight"] = np.asarray(params[f"{name}_proj"]["kernel"]).T
    sd["model_nn.rp_proj.relative_attention_bias.weight"] = np.asarray(
        params["rp_proj"]["relative_attention_bias"]["embedding"]
    )

    st = params["st_module"]
    for lname, layer in st.items():
        if not lname.startswith("layer_"):
            continue
        tp = f"model_nn.st_module.encoder.layers.{int(lname.split('_')[1])}"
        for norm in ("norm1", "norm2"):
            sd[f"{tp}.{norm}.weight"] = np.asarray(layer[norm]["scale"])
            sd[f"{tp}.{norm}.bias"] = np.asarray(layer[norm]["bias"])
        for lin in _ATTN_LINEARS:
            sd[f"{tp}.attn.{lin}.weight"] = np.asarray(layer["attn"][lin]["kernel"]).T
        sd[f"{tp}.attn.fc_out.bias"] = np.asarray(layer["attn"]["fc_out"]["bias"])
        sd[f"{tp}.attn.trained_point_weight"] = np.asarray(layer["attn"]["trained_point_weight"])
        for torch_idx, flax_name in (("0", "fc1"), ("3", "fc2")):
            sd[f"{tp}.ffn.ff.{torch_idx}.weight"] = np.asarray(layer["ffn"][flax_name]["kernel"]).T
            sd[f"{tp}.ffn.ff.{torch_idx}.bias"] = np.asarray(layer["ffn"][flax_name]["bias"])

    dh = st["diff_head"]
    for head in ("fc_t", "fc_eps"):
        tp = f"model_nn.st_module.diff_head.{head}"
        sd[f"{tp}.0.weight"] = np.asarray(dh[f"{head}_ln"]["scale"])
        sd[f"{tp}.0.bias"] = np.asarray(dh[f"{head}_ln"]["bias"])
        for torch_idx, flax_name in (("1", f"{head}_fc1"), ("3", f"{head}_fc2")):
            sd[f"{tp}.{torch_idx}.weight"] = np.asarray(dh[flax_name]["kernel"]).T
            sd[f"{tp}.{torch_idx}.bias"] = np.asarray(dh[flax_name]["bias"])

    sd["model_nn.step_emb.dummy"] = np.zeros((0,), np.float32)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def load_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Read a reference-layout state dict from ``.npz`` (what the JAX
    package's trainers export) or ``.ckpt``/``.pt`` (``weights_only=True``)."""
    if str(path).endswith(".npz"):
        with np.load(path) as sd:
            return {k: torch.from_numpy(np.array(sd[k], dtype=np.float32)) for k in sd.files}
    return torch.load(path, weights_only=True, map_location="cpu")
