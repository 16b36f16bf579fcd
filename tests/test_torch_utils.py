"""The utility layer of the PyTorch port against the JAX package's.

JAX's ``tests/test_utils.py`` cases run against the port: the step timer's
summary keys and values, ``sync`` over nested containers (CPU tensors and
Python numbers need no wait), the logger and the traceback decorator. The
device profile runs on the CPU here (the CPU's ops in place of the card's
kernels); ``chip_smoke.py`` phase 22 reads K1's kernel from it on the card.
"""

import time

import pytest
import torch

from se3diff_torch.utils import StepTimer, get_logger, print_traceback_on_exception, trace_profile
from se3diff_torch.utils.profiling import OpRow, collect_device_profile, format_device_profile
from se3diff_tpu.utils import StepTimer as JaxStepTimer


def test_step_timer_summary_has_jax_keys():
    timer, ref = StepTimer(), JaxStepTimer()
    for t in (timer, ref):
        for _ in range(3):
            with t.step():
                time.sleep(0.01)
    s = timer.summary(skip_first=1)
    assert set(s) == set(ref.summary(skip_first=1))
    assert s["steps"] == 2
    assert s["mean_s"] >= 0.009
    assert s["steps_per_s"] > 0
    assert StepTimer().summary() == JaxStepTimer().summary() == {}


def test_step_timer_sync_handles_nested_containers():
    timer = StepTimer()
    with timer.step():
        timer.sync({"a": torch.ones(3), "b": [torch.zeros(2), 1.0], "c": (2, {"d": torch.ones(1)})})
    assert len(timer.times) == 1


def test_get_logger_idempotent():
    lg1 = get_logger("se3diff_torch_test_logger")
    lg2 = get_logger("se3diff_torch_test_logger")
    assert lg1 is lg2
    assert len(lg1.handlers) == 1


def test_traceback_decorator_reraises(capsys):
    @print_traceback_on_exception
    def boom(x):
        local_var = x * 2  # noqa: F841 - should appear in the dump
        raise ValueError("nope")

    with pytest.raises(ValueError):
        boom(21)
    err = capsys.readouterr().err
    assert "local_var" in err and "42" in err


def test_collect_device_profile_on_the_cpu(tmp_path):
    x = torch.ones(128, 128)
    rows = collect_device_profile(lambda: torch.tanh(x @ x).sum(), str(tmp_path / "trace"),
                                  device="cpu", with_stack=True)
    assert rows and all(isinstance(r, OpRow) for r in rows)
    for r in rows:
        assert r.total_ms >= 0 and r.count >= 1 and r.bytes_accessed == 0 and r.gb_per_s is None
    assert [r.total_ms for r in rows] == sorted((r.total_ms for r in rows), reverse=True)
    assert any(r.name == "aten::mm" for r in rows)
    assert any("test_torch_utils.py" in r.source for r in rows)
    assert (tmp_path / "trace" / "trace.json").exists()
    text = format_device_profile(rows, top=5)
    assert "total device time" in text and "—" in text and len(text.splitlines()) == 7


def test_launch_site_names_the_ports_own_files():
    """A row's source is the innermost frame outside torch's package: the
    port's module that called the op, not the caller above it."""
    from se3diff_torch.models import dig

    model = dig.init_weights(dig.DiGConditionalScoreModel(
        num_layers=1, dim_model=32, dim_pair=16, num_heads=4, dim_hidden=64, dropout=0.0),
        torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    B, L = 2, 8
    args = (torch.randn(B, L, 3, generator=g), torch.linalg.qr(torch.randn(B, L, 3, 3, generator=g))[0],
            torch.full((B,), 0.5), torch.randn(B, L, 384, generator=g), torch.randn(B, L, L, 128, generator=g))

    def evaluation():
        with torch.no_grad():
            return model(*args)

    rows = collect_device_profile(evaluation, device="cpu", with_stack=True)
    layer_norm = next(r for r in rows if r.name == "aten::native_layer_norm")
    assert layer_norm.source.startswith("se3diff_torch/models/dig.py(")


def test_trace_profile_writes_a_chrome_trace(tmp_path):
    with trace_profile(str(tmp_path), device="cpu"):
        torch.ones(4) + 1
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_profiling_on_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible; the error path needs a CUDA-less host")
    with pytest.raises(RuntimeError, match="CUDA"):
        collect_device_profile(lambda: None)
