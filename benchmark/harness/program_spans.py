"""The program's own spans in a traced window: the ``xd/<name>`` ranges
that the port's ``utils/profiling.span`` opens around its stages while the
profiler records, on the window's main thread, read against the device's
busy intervals (``Window``'s union of device operations).

Every reading is None where the window holds no such span (a program
without them, or a path that skips the stage), and None from a window
that lost kernels: a lost kernel shows as idle time that did not happen.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

PREFIX = "xd/"


def intervals(window, name: str) -> List[Tuple[float, float]]:
    """The span ``xd/<name>``'s intervals (us) on the window's main thread,
    in order. A stage's span opens once a call of the stage, so two of one
    name neither nest nor overlap."""
    nest = window.host.get(window._main_tid())
    if nest is None:
        return []
    return sorted((s, e) for s, e, n in zip(nest.starts, nest.ends,
                                            nest.names) if n == PREFIX + name)


def _readable(window, name: str) -> Optional[List[Tuple[float, float]]]:
    spans = intervals(window, name)
    return spans if spans and not window.lost else None


def idle_ms(window, name: str) -> Optional[float]:
    """ms a batch or step inside ``xd/<name>`` in which no operation ran
    on the device."""
    spans = _readable(window, name)
    if spans is None:
        return None
    union = window._union()
    ends = [e for _, e in union]
    idle = 0.0
    for s, e in spans:
        idle += e - s
        i = bisect.bisect_right(ends, s)     # the first busy run ending > s
        while i < len(union) and union[i][0] < e:
            idle -= min(union[i][1], e) - max(union[i][0], s)
            i += 1
    return idle * 1e-3 / window.units


def count(window, name: str) -> Optional[float]:
    """``xd/<name>`` ranges a batch or step."""
    spans = _readable(window, name)
    return None if spans is None else len(spans) / window.units


def device_ms_launched_in(window, name: str) -> Optional[float]:
    """Device ms a batch or step of the operations whose launch, on any
    thread (autograd's device thread too), lies inside an ``xd/<name>``
    range of the main thread."""
    spans = _readable(window, name)
    if spans is None:
        return None
    starts = [s for s, _ in spans]
    total = 0.0
    for s, e, _, _, corr in window.device:
        launch = window.api.get(corr)
        if launch is None:
            continue
        j = bisect.bisect_right(starts, launch[1]) - 1
        if j >= 0 and launch[1] <= spans[j][1]:
            total += e - s
    return total * 1e-3 / window.units
