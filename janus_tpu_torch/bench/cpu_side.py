"""The CPU side of a card check, run in a worker process beside the card's
work: the port's own result on the CPU, on the same inputs, computed while
the card runs its part, so that the check adds little to the run's time.

    ref = Later(fn, *args)      # fn: a module-level function
    ...                         # the card's work
    want = ref.result()         # also stops the worker

The worker is started with ``spawn`` (never a fork of a process that holds
a CUDA context) and runs torch on one thread. ``fn`` must not touch the
card. A worker whose result is never read is joined when the process exits.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor


def _one_thread():
    import torch
    torch.set_num_threads(1)


class Later:
    """``fn(*args)`` started now in a worker process of its own."""

    def __init__(self, fn, *args):
        self._pool = ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"),
            initializer=_one_thread)
        self._future = self._pool.submit(fn, *args)

    def result(self):
        try:
            return self._future.result()
        finally:
            self._pool.shutdown()
