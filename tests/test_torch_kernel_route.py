"""The card's IPA attention widths and the rule that picks a kernel design.

``kernel_route`` and ``check_card_widths`` are pure functions of widths and
a device name, so they run without a GPU: the widths the card refuses fail
at bundle load, train start and finetune start with a ``ValueError`` naming
the supported widths, before the device is resolved (which raises a
``RuntimeError`` where CUDA is absent). ``CARD_WIDTHS`` is held against
the head counts the CUDA sources instantiate.
"""

import re
from pathlib import Path

import pytest
import torch
import yaml

from se3diff_torch import finetune, train
from se3diff_torch.ops import ipa_attention as k1
from se3diff_torch.sampling.bundle import BIOEMU_V1_MODEL, load_bundle, random_bundle

CSRC = Path(k1.__file__).resolve().parents[1] / "csrc"
BF16, F32 = torch.bfloat16, torch.float32
WIDTHS_MSG = "take 4, 8, 16, 32 heads of width 16"
# Widths the card refuses: head width 8, and 12 heads of width 16.
REFUSED = [dict(dim_model=32, dim_pair=32, num_heads=4), dict(dim_model=192, dim_pair=64, num_heads=12)]


@pytest.mark.parametrize("dtype,H,dk,cp,has_pa,route", [
    (BF16, 32, 16, 256, True, "tc"),     # the score model in bf16: every main path
    (BF16, 32, 16, 128, True, "tc"),
    (BF16, 32, 16, 96, True, "tc"),
    (BF16, 32, 16, 32, True, "tc"),
    (BF16, 32, 16, 36, True, "simt"),    # Cp not a multiple of 32
    (F32, 32, 16, 256, True, "simt"),    # f32 keeps the CUDA-core design (no TF32)
    (BF16, 32, 16, 256, False, "simt"),  # the in-kernel pair bias
    (F32, 4, 16, 32, False, "simt"),     # the PPFT control net
    (BF16, 4, 16, 32, True, "simt"),
    (BF16, 8, 16, 64, True, "simt"),
    (F32, 16, 16, 128, False, "simt"),
])
def test_route_rule(dtype, H, dk, cp, has_pa, route):
    assert k1.kernel_route(dtype, H, dk, cp, has_pa) == route


@pytest.mark.parametrize("dtype,H,dk,cp,has_pa", [
    (BF16, 12, 16, 256, True),   # heads
    (F32, 2, 16, 32, True),
    (F32, 32, 8, 256, True),     # head width
    (BF16, 32, 16, 260, True),   # Cp > 256
    (F32, 4, 16, 30, False),     # Cp % 4
])
def test_route_rule_raises_for_widths_the_card_refuses(dtype, H, dk, cp, has_pa):
    with pytest.raises(ValueError, match=WIDTHS_MSG):
        k1.kernel_route(dtype, H, dk, cp, has_pa)


def test_card_widths_name_what_the_cuda_sources_instantiate():
    src = (CSRC / "ipa_attention.cu").read_text()
    switch = src[src.index("switch (H) {"):]
    switch = switch[:switch.index("}")]
    cases = {int(a) for a, b in re.findall(r"case (\d+): return \(int\)launch_heads<(\d+)>", switch)
             if a == b}
    takes = src[src.index("int ipa_attention_takes_heads(int H)"):]
    takes = {int(h) for h in re.findall(r"H == (\d+)", takes[:takes.index("}")])}
    assert cases == takes == set(k1.CARD_WIDTHS["heads"])
    tc = (CSRC / "ipa_attention_tc.cu").read_text()
    for text in (src, tc):
        assert f"constexpr int kDK = {k1.CARD_WIDTHS['head_dim']};" in text
        assert f"constexpr int kMaxCp = {k1.CARD_WIDTHS['max_cp']};" in text
    assert "constexpr int kH = 32;" in tc


def test_check_card_widths():
    for cfg in (BIOEMU_V1_MODEL, dict(dim_model=64, dim_pair=32, num_heads=4),
                dict(dim_model=128, dim_pair=64, num_heads=8), dict(dim_model=256, num_heads=16)):
        k1.check_card_widths(cfg, "cuda")
    for cfg in REFUSED + [dict(dim_pair=300), dict(dim_pair=30, dim_model=64, num_heads=4)]:
        with pytest.raises(ValueError, match=WIDTHS_MSG):
            k1.check_card_widths(cfg, "cuda")
        with pytest.raises(ValueError, match=WIDTHS_MSG):
            k1.check_card_widths(cfg, torch.device("cuda", 0))
        k1.check_card_widths(cfg, "cpu")  # the plain version takes any width


def _config(tmp_path, cfg):
    block = {"_target_": "bioemu.shortcuts.DiGConditionalScoreModel", **cfg, "num_layers": 1}
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump({"score_model": block, "finetune_model": block}))
    return path


@pytest.mark.parametrize("cfg", REFUSED)
def test_load_bundle_refuses_card_widths_before_the_device(tmp_path, cfg):
    path = _config(tmp_path, cfg)
    with pytest.raises(ValueError, match=WIDTHS_MSG):
        load_bundle(tmp_path / "missing.npz", config_path=path, device="cuda")
    with pytest.raises(ValueError, match=WIDTHS_MSG):
        random_bundle(model_cfg=cfg, device="cuda")


@pytest.mark.parametrize("cfg", REFUSED)
def test_train_cli_refuses_card_widths_before_the_device(tmp_path, cfg):
    argv = ["--trajectory", str(tmp_path / "missing.xtc"), "--model_config_path",
            str(_config(tmp_path, cfg)), "--device", "cuda"]
    with pytest.raises(ValueError, match=WIDTHS_MSG):
        train.main(argv)


@pytest.mark.parametrize("cfg", REFUSED)
def test_finetune_cli_refuses_card_widths_before_the_device(tmp_path, cfg):
    argv = ["--csv_path", str(tmp_path / "train.csv"), "--csv_path_val", str(tmp_path / "val.csv"),
            "--h_stars_cols", "f_dg_pred", "--ckpt_path", str(tmp_path / "missing.npz"),
            "--model_config_path", str(_config(tmp_path, cfg)), "--device", "cuda"]
    with pytest.raises(ValueError, match=WIDTHS_MSG):
        finetune.main(argv)


def test_control_net_widths_are_checked_apart(tmp_path):
    """A score model the card takes with a control net it refuses."""
    path = tmp_path / "config.yaml"
    target = "bioemu.shortcuts.DiGConditionalScoreModel"
    path.write_text(yaml.safe_dump({
        "score_model": {"_target_": target, **BIOEMU_V1_MODEL},
        "finetune_model": {"_target_": target, **REFUSED[1]},
    }))
    from se3diff_torch.ppft.trainer import load_finetune_bundle

    with pytest.raises(ValueError, match="num_heads=12"):
        load_finetune_bundle(tmp_path / "missing.npz", model_config_path=path, device="cuda")


def test_launch_design_refuses_what_it_does_not_take():
    """The private timing entry: unknown designs, and the tensor-core design
    at widths its route does not take, fail before any build."""
    B, H, L, dk, cp = 1, 4, 3, 16, 32
    z = lambda *s: torch.zeros(s)
    args = (z(B, H, L, dk), z(B, H, L, dk), z(B, H, L, dk), z(B, 3, H * 4, L), z(B, 3, H * 4, L),
            z(B, H, L, 24), z(B, L, L, cp), z(H, cp, dk), z(B, L), z(B, H, L, L))
    kw = dict(scalar_w=1.0, pair_w=1.0)
    with pytest.raises(ValueError, match="design must be one of"):
        k1._launch_design("wgmma", *args, **kw)
    with pytest.raises(ValueError, match="does not take these widths"):
        k1._launch_design("tc", *args, **kw)
