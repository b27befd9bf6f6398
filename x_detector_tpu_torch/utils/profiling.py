"""Profiling and timing utilities.

The port of ``x_detector_tpu/utils/profiling.py``:

  * :func:`trace` -- a context manager around ``torch.profiler`` (CPU and,
    where a card is present, CUDA activities) that writes a Chrome trace
    (``trace.json``, readable in Perfetto or ``chrome://tracing``) into
    ``logdir`` and hands back the profiler for ``key_averages()``;
  * :func:`span` -- the program's own ranges (``xd/<name>``) around its
    stages, recorded only while ``torch.profiler`` records;
  * :class:`DeviceTimer` -- the mean time a call of a function over
    distinct pre-staged argument sets, fenced by
    ``torch.cuda.synchronize()`` where the arguments live on the card (the
    card runs calls in order, so one fence after the loop covers them all)
    and by nothing on the CPU, where calls return when done;
  * :func:`kernel_device_ms` and :func:`device_ms` -- what the card spends
    a call of a function, kernel by kernel, from ``torch.profiler``'s
    device time: without the host's launch time, which a CUDA-event or
    host-clock time of short calls reads instead;
  * :func:`alternating_ms` -- two or more paths timed by host clock in
    alternating rounds, so that each round of each path sees the same
    state of a host that drifts between fast and slow;
  * :func:`cuda_ms` -- the mean device time of a call by CUDA events, and
    :func:`rounds_ms` / :func:`median_spread` -- rounds of calls timed by
    CUDA events on a card (the host clock on the CPU), their median and
    their spread, which the measurement tools report;
  * :func:`card_label` -- the card's name and power limit, which every
    measurement is printed beside.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Callable, Dict, Iterator, List, Sequence

import torch

TRACE_FILE = "trace.json"
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks a stage of the program: while
    ``torch.profiler`` records, a ``record_function`` range named
    ``xd/<name>``, on the profiler's clock, so that a trace ties each device
    operation to the span its launch lies in. Otherwise, and while
    ``torch.compile`` or ``torch.export`` traces (a graph gains no node), a
    shared null context: the check costs a fraction of a microsecond, where
    an idle ``record_function`` costs several."""
    if (torch.compiler.is_compiling()
            or not torch._C._autograd._profiler_enabled()):
        return _NO_SPAN
    return torch.profiler.record_function("xd/" + name)


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


def kernel_device_ms(fn: Callable[[], object], reps: int = 10,
                     tries: int = 3) -> dict:
    """{kernel name: mean device ms a call of ``fn()``} over ``reps`` calls
    after one warm-up call. A window that recorded some kernel fewer than
    ``reps`` times (the profiler drops some, rarely) is profiled again,
    ``tries`` times at most, after a pause that grows with each try, and
    then the fullest window counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best: dict = {}
    for attempt in range(tries):
        time.sleep(0.05 * attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [ev for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA]
        got = {ev.key: ev.device_time_total / 1e3 / reps for ev in kernels}
        if kernels and min(ev.count for ev in kernels) >= reps:
            return got
        if sum(got.values()) > sum(best.values()):
            best = got
    if best:
        return best
    raise AssertionError(f"the profiler recorded no kernel in {tries} "
                         f"windows")


def device_ms(fn: Callable[[], object], reps: int = 10, tries: int = 3,
              keep: str = "") -> float:
    """Mean device ms a call of ``fn()``: the sum of
    :func:`kernel_device_ms` over the kernels whose name holds ``keep``."""
    return sum(ms for name, ms in kernel_device_ms(fn, reps, tries).items()
               if keep in name)


def alternating_ms(sides: Dict[str, Callable[[], object]], rounds: int = 10,
                   batches: int = 3, device="cuda") -> dict:
    """Each of ``sides`` (name -> a call of one batch) ``batches`` times a
    round, the sides in turn for ``rounds`` rounds, host clock to a sync
    (on a CUDA ``device``): each side's median and best round in ms a
    batch, and its rounds."""
    sync = (lambda: torch.cuda.synchronize(device)) if (
        torch.device(device).type == "cuda") else (lambda: None)
    ms = {name: [] for name in sides}
    for _ in range(rounds):
        for name, fn in sides.items():
            sync()
            t0 = time.perf_counter()
            for _ in range(batches):
                fn()
            sync()
            ms[name].append((time.perf_counter() - t0) / batches * 1e3)
    return {name: {"median": sorted(v)[len(v) // 2], "best": min(v),
                   "rounds": v} for name, v in ms.items()}


def cuda_ms(fn: Callable[[], object], warmup: int = 3,
            reps: int = 20) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around ``reps``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rounds_ms(fn: Callable[[], object], device, rounds: int = 5,
              reps: int = 10, warmup: int = 2) -> List[float]:
    """The mean ms a call of ``fn()`` in each of ``rounds`` rounds of
    ``reps`` calls, after ``warmup`` calls: by CUDA events on a card
    (:func:`cuda_ms`), by the host clock on the CPU (a call returns when
    its work is done, :class:`DeviceTimer`)."""
    if torch.device(device).type == "cuda":
        return [cuda_ms(fn, warmup if i == 0 else 0, reps)
                for i in range(rounds)]
    timer = DeviceTimer(fn, [()], warmup)
    return [timer.measure(reps) * 1e3 for _ in range(rounds)]


def median_spread(ms: Sequence[float]) -> dict:
    """{"median_ms": the median of ``ms``, "spread_ms": ``ms`` sorted}."""
    ordered = sorted(ms)
    return {"median_ms": ordered[len(ordered) // 2], "spread_ms": ordered}


def card_label(device="cuda") -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    name CUDA gives the card where nvidia-smi is missing), or the device
    type for a device that is not a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return out[index].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(index)
