"""The traced window: ``torch.profiler`` over a fixed number of batches or
steps, its Chrome trace read back into host ranges, runtime calls and
device operations, and what the per-layer readers ask of it.

Device operations are tied to the host by their correlation id: an
operation belongs to a host range (an operator such as
``xdt::fused_sepconv``, or one of the benchmark's own ``bench/...``
ranges) when the runtime call that launched it lies inside that range on
the same thread.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
API_CATS = ("cuda_runtime", "cuda_driver")
# runtime and driver calls that make the host wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
              "cuCtxSynchronize", "cuEventSynchronize", "cuMemcpyDtoH_v2")
WINDOW = "bench/window"
BREAKDOWN_ENTRIES = 10
# kernel wrappers' launch counters (``ops.library.launch_counts``) are held
# against the kernels traced under the ``xdt`` operators, this one aside
NO_KERNEL_OPS = ("xdt::self_suppress",)


class Window:
    """One traced window, read from a Chrome trace's events."""

    def __init__(self, events: Iterable[dict], units: int, info: dict):
        self.units, self.info = units, info
        # (kernels traced, kernels launched) under the program's kernel
        # operators where the profiler lost some of them, else None
        self.lost: Optional[Tuple[int, int]] = None
        host: Dict[int, List[Tuple[float, float, str]]] = (
            collections.defaultdict(list))
        self.api: Dict[int, Tuple[int, float, str]] = {}
        self.api_calls: List[Tuple[int, float, str]] = []
        self.device: List[Tuple[float, float, str, str, int]] = []
        self.t0 = self.t1 = None
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, name = ev.get("cat", ""), ev.get("name", "")
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
            corr = (ev.get("args") or {}).get("correlation")
            if cat in HOST_CATS:
                host[ev["tid"]].append((ts, ts + dur, name))
                if name == WINDOW and cat == "user_annotation":
                    self.t0, self.t1 = ts, ts + dur
            elif cat in API_CATS:
                self.api_calls.append((ev["tid"], ts, name))
                if corr is not None:
                    self.api[corr] = (ev["tid"], ts, name)
            elif cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, name, cat, corr))
        if self.t0 is None:
            raise ValueError(f"the trace has no {WINDOW!r} range")
        self.host = {tid: _Nest(r) for tid, r in host.items()}
        self.device = [d for d in self.device if d[1] > self.t0
                       and d[0] < self.t1]
        self.device.sort()

    # -- the window ---------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _union(self) -> List[Tuple[float, float]]:
        spans: List[Tuple[float, float]] = []
        for s, e, *_ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if spans and s <= spans[-1][1]:
                spans[-1] = (spans[-1][0], max(spans[-1][1], e))
            else:
                spans.append((s, e))
        return spans

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in self._union()) * 1e-6

    # -- host ranges ----------------------------------------------------------
    def _enclosing(self, tid: int, ts: float) -> List[str]:
        """The names of the host ranges on ``tid`` that hold ``ts``,
        innermost first."""
        nest = self.host.get(tid)
        return nest.chain(ts) if nest else []

    def device_s_under(self, match: Callable[[str], bool]) -> float:
        """Device seconds of the operations launched inside a host range
        whose name ``match`` accepts."""
        total = 0.0
        for s, e, _, _, corr in self.device:
            launch = self.api.get(corr)
            if launch and any(match(n) for n in self._enclosing(*launch[:2])):
                total += e - s
        return total * 1e-6

    def device_s_by_name(self, match: Callable[[str], bool]) -> float:
        """Device seconds of the operations whose own name ``match``
        accepts."""
        return sum(e - s for s, e, name, _, _ in self.device
                   if match(name)) * 1e-6

    def kernels_under(self, match: Callable[[str], bool]) -> int:
        n = 0
        for _, _, _, cat, corr in self.device:
            launch = self.api.get(corr)
            if (cat == "kernel" and launch
                    and any(match(x) for x in self._enclosing(*launch[:2]))):
                n += 1
        return n

    # -- counts ---------------------------------------------------------------
    def launches(self) -> int:
        """Kernels launched from the window: distinct correlation ids of the
        traced kernels whose launch the window holds."""
        ids = {corr for _, _, _, cat, corr in self.device
               if cat == "kernel" and corr in self.api
               and self.t0 <= self.api[corr][1] <= self.t1}
        return len(ids)

    def syncs(self) -> int:
        """Runtime calls in the window that wait for the device."""
        return sum(1 for tid, ts, name in self.api_calls
                   if name in SYNC_CALLS and self.t0 <= ts <= self.t1)

    # -- the breakdown --------------------------------------------------------
    def breakdown(self) -> dict:
        by_name: Dict[str, float] = collections.defaultdict(float)
        for s, e, name, _, _ in self.device:
            by_name[name[:160]] += (e - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])
        gaps: Dict[str, float] = collections.defaultdict(float)
        main = self._main_tid()
        last = self.t0
        for s, e in self._union() + [(self.t1, self.t1)]:
            if s > last:
                gaps[self._host_doing(main, (last + s) / 2)] += (s - last) * 1e-6
            last = max(last, e)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, v] for n, v in ops[:BREAKDOWN_ENTRIES]],
                "idle_gaps": [[n, v] for n, v in idle[:BREAKDOWN_ENTRIES]]}

    def _main_tid(self):
        for tid, ranges in self.host.items():
            if WINDOW in ranges.names:
                return tid
        return None

    def _host_doing(self, tid, ts: float) -> str:
        """The innermost benchmark range at ``ts``, with the innermost
        operator inside it."""
        names = self._enclosing(tid, ts)
        bench = [n for n in names if n.startswith("bench/") and n != WINDOW]
        ops = [n for n in names if not n.startswith("bench/")]
        where = bench[0] if bench else WINDOW
        return where + (" > " + ops[0] if ops else "")


class _Nest:
    """One thread's host ranges, which nest: each range's parent, so that
    the ranges holding a time are a walk up from the last one begun."""

    def __init__(self, ranges: List[Tuple[float, float, str]]):
        ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in ranges]
        self.ends = [r[1] for r in ranges]
        self.names = [r[2] for r in ranges]
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (s, e, _) in enumerate(ranges):
            while stack and self.ends[stack[-1]] < e:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def chain(self, ts: float) -> List[str]:
        j = bisect.bisect_right(self.starts, ts) - 1
        out = []
        while j >= 0:
            if self.ends[j] >= ts:
                out.append(self.names[j])
            j = self.parent[j]
        return out


def _events(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def traced(run_unit: Callable[[int], None], units: int, info: dict,
           counters: Optional[Callable[[], int]] = None, tries: int = 3,
           agree: Callable[[bool], bool] = lambda whole: whole) -> Window:
    """Run ``run_unit(i)`` for ``units`` batches or steps under the
    profiler and read the trace. A window whose trace holds fewer kernels
    under the program's kernel operators than ``counters()`` (the
    program's launch counters) moved by is profiled again, ``tries``
    times at most; then the fullest is returned with ``lost`` set. Over
    several ranks ``agree`` makes the choice one for all (a window is
    whole where every rank's is), so that all profile again together."""
    from torch.profiler import ProfilerActivity, profile
    best = None
    for attempt in range(tries):
        time.sleep(0.05 * attempt)
        before = counters() if counters else 0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW):
                for i in range(units):
                    run_unit(i)
                torch.cuda.synchronize()
        made = (counters() - before) if counters else 0
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            window = Window(_events(path), units, info)
        finally:
            os.remove(path)
        got = window.kernels_under(
            lambda n: n.startswith("xdt::") and n not in NO_KERNEL_OPS)
        if agree(got >= made):
            return window
        if best is None or got - made > best[0] - best[1]:
            best = (got, made, window)
        print(f"trace: {got} kernels under the program's operators, "
              f"{made} launched; profiling again", flush=True)
    got, made, window = best
    window.lost = (got, made)
    return window
