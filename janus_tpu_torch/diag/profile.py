"""Profiler integration, on ``torch.profiler``.

The port of ``janus_tpu/diag/profile.py``. ``trace`` records the host's ops
and, with a card present, the card's kernels, and writes a Chrome/Perfetto
trace (``*.pt.trace.json``, openable in ui.perfetto.dev or
chrome://tracing) under ``logdir``. ``annotate`` and ``scope`` are both
``torch.profiler.record_function``: eager torch has no separate device-side
name scope, and a range recorded on the host covers the kernels it
launched. The Radau step names its phases so (``radau.jacobian``,
``radau.factorize``, ``radau.qr_fallback``, ``radau.newton``).
``marginal_seconds`` keeps the reference's contract, timed with CUDA events
on a card.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)


@contextmanager
def trace(logdir: str):
    """Profile the block and write its trace under ``logdir``; yields the
    ``torch.profiler.profile`` (its ``key_averages()`` and ``events()``
    can be read after the block).

    Usage::

        with diag.trace("/tmp/jtrace"):
            solve_ivp(...)
    """
    Path(logdir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))) as p:
        yield p
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def annotate(name: str):
    """A named range in the profile (host ops and the kernels they
    launch)."""
    return record_function(name)


def scope(name: str):
    """A named range around a solver phase: ``record_function``, as
    ``annotate`` (the reference's ``jax.named_scope``)."""
    return record_function(name)


def device_memory_stats(device=None) -> dict:
    """The CUDA caching allocator's statistics for ``device`` (default: the
    current card), with the reference's common keys ``bytes_in_use`` and
    ``peak_bytes_in_use`` (allocated bytes, current and peak). ``{}`` on the
    CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = dict(torch.cuda.memory_stats(device))
    stats["bytes_in_use"] = stats.get("allocated_bytes.all.current", 0)
    stats["peak_bytes_in_use"] = stats.get("allocated_bytes.all.peak", 0)
    return stats


def _on_card(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def marginal_seconds(make_chained: Callable[[int], Callable], *args,
                     n_lo: int = 1, n_hi: int = 6, reps: int = 2) -> float:
    """Marginal wall time of one iteration of a chained computation.

    ``make_chained(n)`` returns a callable running n chained iterations of
    the workload on ``args``. Returns (t(n_hi) − t(n_lo)) / (n_hi − n_lo),
    best of ``reps`` each after a warm-up, which cancels the fixed cost of a
    call. Timed with CUDA events when an argument lies on a card, else with
    the host clock.
    """
    run_lo, run_hi = make_chained(n_lo), make_chained(n_hi)
    card = _on_card(args)

    def once(fn):
        if card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0

    once(run_lo)    # warm-up (a kernel's build, allocator growth)
    once(run_hi)
    best_lo = min(once(run_lo) for _ in range(reps))
    best_hi = min(once(run_hi) for _ in range(reps))
    return max((best_hi - best_lo) / (n_hi - n_lo), 1e-12)
