"""Run one program on N local ranks, each a spawned process.

:func:`run_ranks` starts ``world`` processes with ``torch.multiprocessing``
(start method ``spawn``), joins them to one group through a ``file://``
rendezvous in a temporary directory (:func:`~.mesh.init_group`), calls
``fn(ctx, *args)`` on every rank and returns what each rank returned, in
rank order. A rank that raises fails the whole run with its traceback; the
others are stopped. ``timeout`` bounds the run and ``group_timeout`` every
collective, so a hung rank fails instead of hanging.

``fn`` and ``args`` are pickled to a file that every child loads, importing
``fn``'s module: it must be a module-level function of an importable module
(never a test module, which would import JAX into the ranks), and what it
returns must pickle (numpy arrays and plain Python values; keep tensors
out, CUDA ones above all).
"""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from se3diff_torch.parallel.mesh import DEFAULT_TIMEOUT, RankContext, init_group


def _worker(rank, world, init_method, devices, group_timeout, program, results):
    try:
        with open(program, "rb") as f:
            fn, args = pickle.load(f)
        ctx = init_group(rank, world, init_method, devices, group_timeout)
        if ctx.device.type == "cpu":  # ranks on the CPU share its cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        try:
            out = fn(ctx, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_ranks(
    fn: Callable[..., Any],
    world: int,
    devices: Sequence[str],
    args: tuple = (),
    timeout: float | None = None,
    group_timeout: timedelta = DEFAULT_TIMEOUT,
    rendezvous_dir: str | None = None,
) -> list[Any]:
    """``[fn(ctx_0, *args), ..., fn(ctx_{world-1}, *args)]``, each on its own
    spawned rank with the device ``devices[rank]``. Raises ``RuntimeError``
    when a rank fails and ``TimeoutError`` when the run outlasts ``timeout``
    seconds (``None``: no limit but ``group_timeout``)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=rendezvous_dir) as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        # The program goes through a file: a start() blocks until its child
        # has read its arguments, so large ones sent that way would start
        # the ranks one after another.
        program = os.path.join(tmp, "program.pkl")
        with open(program, "wb") as f:
            pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
        procs = [
            ctx.Process(
                target=_worker,
                args=(r, world, init_method, list(devices), group_timeout, program, results),
            )
            for r in range(world)
        ]
        deadline = None if timeout is None else time.monotonic() + timeout
        out: dict[int, Any] = {}
        try:
            for p in procs:
                p.start()
            while len(out) < world:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish in {timeout} s")
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = {r: p.exitcode for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out}
                    if not dead:
                        continue
                    try:  # a failed rank queues its traceback before it exits
                        rank, ok, value = results.get(timeout=5.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"rank(s) died without a result: exit codes {dead}"
                        ) from None
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(None if deadline is None else max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.pid is None:  # never started
                    continue
                if p.is_alive():
                    p.kill()
                p.join()
    return [out[r] for r in range(world)]


__all__ = ["RankContext", "run_ranks"]
