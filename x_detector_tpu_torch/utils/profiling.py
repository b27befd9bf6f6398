"""Profiling and timing utilities.

The port of ``x_detector_tpu/utils/profiling.py``:

  * :func:`trace` -- a context manager around ``torch.profiler`` (CPU and,
    where a card is present, CUDA activities) that writes a Chrome trace
    (``trace.json``, readable in Perfetto or ``chrome://tracing``) into
    ``logdir`` and hands back the profiler for ``key_averages()``;
  * :class:`DeviceTimer` -- the mean time a call of a function over
    distinct pre-staged argument sets, fenced by
    ``torch.cuda.synchronize()`` where the arguments live on the card (the
    card runs calls in order, so one fence after the loop covers them all)
    and by nothing on the CPU, where calls return when done.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Sequence

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body; on exit write ``<logdir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _on_cuda(argsets: Sequence[tuple]) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda
               for args in argsets for a in args)


class DeviceTimer:
    """Mean seconds a call of ``fn(*args)``, cycling through ``argsets``
    (distinct argument tuples, already on their device, so that no cache
    can skip work), after ``warmup`` fenced calls."""

    def __init__(self, fn: Callable, argsets: Sequence[tuple],
                 warmup: int = 2):
        self.fn = fn
        self.argsets = list(argsets)
        if not self.argsets:
            raise ValueError("DeviceTimer needs at least one argument set")
        self._fence = (torch.cuda.synchronize if _on_cuda(self.argsets)
                       else (lambda: None))
        for i in range(warmup):
            fn(*self.argsets[i % len(self.argsets)])
        self._fence()

    def measure(self, iters: int = 10) -> float:
        """Mean seconds a call over ``iters`` calls."""
        self._fence()
        t0 = time.perf_counter()
        for i in range(iters):
            self.fn(*self.argsets[i % len(self.argsets)])
        self._fence()
        return (time.perf_counter() - t0) / iters
