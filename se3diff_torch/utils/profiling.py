"""Profiling hooks: ``torch.profiler`` traces, device-kernel tables and
per-step timing.

Counterpart of ``se3diff_tpu/utils/profiling.py``. JAX dispatches
asynchronously and its step timer blocks on every array of a pytree; CUDA
launches are asynchronous too, so :meth:`StepTimer.sync` waits for every
CUDA device that holds a tensor of the step's output. The JAX package's
trace-based op table (per-op source line, HLO category, bytes accessed) has
its counterpart in :func:`collect_device_profile`: the device kernels that
``torch.profiler`` recorded, aggregated by kernel name. The profiler counts
no bytes, so ``bytes_accessed`` is 0 and the table prints no rate.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import torch

logger = logging.getLogger(__name__)

_TRACE_FILE = "trace.json"


def _is_cuda(device) -> bool:
    if torch.device(device).type != "cuda":
        return False
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but CUDA is not available")
    return True


def _activities(cuda: bool) -> list:
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]


def _stack_config(with_stack: bool):
    """The profiler's config that keeps each op's Python stack: without
    ``verbose`` some builds (PyTorch 2.11 with CUDA) record none."""
    from torch._C._profiler import _ExperimentalConfig

    return _ExperimentalConfig(verbose=True) if with_stack else None


@contextlib.contextmanager
def trace_profile(logdir: str, device: str = "cuda", with_stack: bool = False):
    """Profile the block with ``torch.profiler`` (the CUDA activity when
    ``device`` is a card) and write a Chrome trace, ``trace.json``, into
    ``logdir`` (chrome://tracing or Perfetto). Yields the profiler."""
    from torch.profiler import profile

    cuda = _is_cuda(device)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=_activities(cuda), with_stack=with_stack,
                 experimental_config=_stack_config(with_stack)) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(logdir, _TRACE_FILE)
    prof.export_chrome_trace(path)
    logger.info("Wrote profiler trace to %s", path)


@dataclass
class StepTimer:
    """Wall-clock step statistics with device synchronization.

    Usage::

        timer = StepTimer()
        for step in range(n):
            with timer.step():
                out = train_step(...)
                timer.sync(out)
        print(timer.summary())
    """

    times: list[float] = field(default_factory=list)
    _t0: float = 0.0

    @contextlib.contextmanager
    def step(self):
        self._t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - self._t0)

    def sync(self, tree) -> None:
        """Wait for every CUDA device that holds a tensor of ``tree`` (dicts,
        lists and tuples are walked; CPU tensors and Python numbers need no
        wait). Call inside ``step``."""
        devices = set()
        stack = [tree]
        while stack:
            x = stack.pop()
            if isinstance(x, torch.Tensor):
                if x.is_cuda:
                    devices.add(x.device)
            elif isinstance(x, dict):
                stack.extend(x.values())
            elif isinstance(x, (list, tuple)):
                stack.extend(x)
        for device in devices:
            torch.cuda.synchronize(device)

    def summary(self, skip_first: int = 1) -> dict[str, float]:
        ts = self.times[skip_first:] or self.times
        if not ts:
            return {}
        return {
            "steps": len(ts),
            "mean_s": sum(ts) / len(ts),
            "min_s": min(ts),
            "max_s": max(ts),
            "steps_per_s": len(ts) / sum(ts),
        }


def print_traceback_on_exception(fn):
    """Decorator: print an expanded traceback with local variables on
    uncaught exceptions (counterpart of the reference's stackprinter
    decorator, utils.py:54-65; stdlib-only)."""
    import functools
    import traceback

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception:
            import sys

            tb = sys.exc_info()[2]
            traceback.print_exc()
            for frame, _ in traceback.walk_tb(tb):
                name = frame.f_code.co_name
                loc = {
                    k: repr(v)[:120]
                    for k, v in frame.f_locals.items()
                    if not k.startswith("__")
                }
                if loc:
                    print(f"  locals in {name}: {loc}", file=sys.stderr)
            raise

    return wrapper


# --------------------------------------------------------------------- #
# Device-kernel profiles                                                 #
# --------------------------------------------------------------------- #


@dataclass
class OpRow:
    """One aggregated row of a profile: a device kernel (an op's self time
    on the CPU) by name."""

    name: str
    total_ms: float      # summed device time across occurrences
    count: int
    source: str = ""     # "file.py(123): fn" of the launching op, with_stack only
    bytes_accessed: int = 0  # the profiler counts none

    @property
    def gb_per_s(self) -> float | None:
        if self.bytes_accessed <= 0 or self.total_ms <= 0:
            return None
        return (self.bytes_accessed / 1e9) / (self.total_ms / 1e3)


@dataclass
class DeviceProfile:
    """What :func:`profile_device` saw: the kernel rows, the device time of
    the kernels launched under each requested ``record_function`` label and
    the wall of the profiled call (device work included)."""

    rows: list[OpRow]
    labels: dict[str, float]
    wall_ms: float

    @property
    def total_ms(self) -> float:
        return sum(r.total_ms for r in self.rows)

    @property
    def count(self) -> int:
        return sum(r.count for r in self.rows)


def _user_frame(name: str) -> bool:
    """A Python frame of the caller's code: not in torch's own package
    (``torch/...`` or ``.../torch/...``; this package's files are kept),
    not a builtin, not the profiler's ``nn.Module`` scope marker."""
    return "/torch/" not in name and not name.startswith(("torch/", "<built-in", "nn.Module:"))


def _is_python_frame(evt) -> bool:
    """Whether ``evt`` is a Python function's span (recorded with
    ``with_stack`` by the profilers that have the attribute)."""
    return getattr(evt, "is_python_function", False)


def _launch_site(evt) -> str:
    """The innermost Python frame outside torch's own package that
    ``evt`` ran under: its recorded stack where the profiler keeps one, else
    its nearest Python-function ancestor."""
    while evt is not None:
        if _is_python_frame(evt) and _user_frame(evt.name):
            return evt.name
        for frame in getattr(evt, "stack", None) or ():
            if _user_frame(frame):
                return frame
        evt = getattr(evt, "cpu_parent", None)
    return ""


def _sources(prof, cuda: bool) -> dict[str, str]:
    """Kernel (CPU op) name -> the launch site of one of its occurrences."""
    out: dict[str, str] = {}
    for evt in prof.events():
        if _is_python_frame(evt):
            continue
        if cuda:
            kernels = getattr(evt, "kernels", None) or ()
            if kernels:
                site = _launch_site(evt)
                for kernel in kernels:
                    out.setdefault(kernel.name, site)
        elif evt.device_type == torch.autograd.DeviceType.CPU and evt.key not in out:
            out[evt.key] = _launch_site(getattr(evt, "cpu_parent", None))
    return out


def profile_device(
    run: Callable[[], object],
    tmpdir: str | None = None,
    *,
    device: str = "cuda",
    labels: Sequence[str] = (),
    with_stack: bool = False,
) -> DeviceProfile:
    """Run ``run()`` under ``torch.profiler`` and aggregate what the device
    ran, by name, sorted by total time.

    On a card (``device="cuda"``, the default) the rows are every CUDA
    kernel (the device-timeline annotations that span an op's kernels are
    left out: they would count those kernels twice); on the CPU they are the
    ops with a nonzero self time. ``labels`` names ``record_function`` ranges whose
    kernels' device time is wanted. With ``tmpdir`` a Chrome trace is
    written there; ``with_stack`` fills each row's ``source``.
    """
    from torch.profiler import profile

    cuda = _is_cuda(device)
    with profile(activities=_activities(cuda), with_stack=with_stack,
                 experimental_config=_stack_config(with_stack)) as prof:
        t0 = time.perf_counter()
        run()
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if tmpdir is not None:
        os.makedirs(tmpdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(tmpdir, _TRACE_FILE))

    cpu_type = torch.autograd.DeviceType.CPU
    kind = torch.autograd.DeviceType.CUDA if cuda else cpu_type
    events = prof.key_averages()
    sources = _sources(prof, cuda) if with_stack else {}

    def self_us(e) -> float:
        return e.self_device_time_total if cuda else e.self_cpu_time_total

    python_frames = {e.key for e in prof.events() if _is_python_frame(e)}
    rows = [
        OpRow(name=e.key, total_ms=self_us(e) / 1e3, count=e.count, source=sources.get(e.key, ""))
        for e in events
        if e.device_type == kind and not e.is_user_annotation and (cuda or self_us(e) > 0)
        and e.key not in python_frames
    ]
    rows.sort(key=lambda r: -r.total_ms)
    label_ms = {
        name: sum((e.device_time_total if cuda else e.cpu_time_total) for e in events
                  if e.key == name and e.device_type == cpu_type) / 1e3
        for name in labels
    }
    return DeviceProfile(rows=rows, labels=label_ms, wall_ms=wall_ms)


def collect_device_profile(
    run: Callable[[], object], tmpdir: str | None = None, *, device: str = "cuda",
    with_stack: bool = False,
) -> list[OpRow]:
    """The rows of :func:`profile_device`: device kernels by name, sorted
    by total time (the CPU's ops with ``device="cpu"``)."""
    return profile_device(run, tmpdir, device=device, with_stack=with_stack).rows


def format_device_profile(rows: list[OpRow], top: int = 20) -> str:
    lines = [f"{'ms':>9} {'count':>6} {'GB/s':>7}  name | source"]
    for r in rows[:top]:
        rate = "—" if r.gb_per_s is None else f"{r.gb_per_s:.0f}"
        lines.append(
            f"{r.total_ms:9.3f} {r.count:6d} {rate:>7}  {r.name[:90]} | {r.source or '?'}"
        )
    total = sum(r.total_ms for r in rows)
    lines.append(f"(total device time: {total:.2f} ms)")
    return "\n".join(lines)
