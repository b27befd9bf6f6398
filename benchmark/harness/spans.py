"""The benchmark's own ranges around the program's modules: profiler
ranges (``bench/<name>``) opened and closed by forward pre- and post-hooks
that the benchmark registers on the program's model, for the traced window
only.

A configuration file names them under ``"spans"``: ``name: [start, end]``,
each end ``"<module>:pre"`` or ``"<module>:post"`` with the module's
dotted path in the model ("" for the model itself). A range may run from
one module's end to another's start, as the proposal stage between the
RPN and the thin map does.
"""

from __future__ import annotations

from typing import Dict, List

import torch


class Spans:
    def __init__(self, model: torch.nn.Module, spans: Dict[str, List[str]]):
        self.handles = []
        self.open: Dict[str, object] = {}
        for name, (start, end) in spans.items():
            self._hook(model, start, lambda n=name: self._begin(n))
            self._hook(model, end, lambda n=name: self._end(n))

    def _hook(self, model, where: str, fn) -> None:
        path, _, when = where.rpartition(":")
        module = model.get_submodule(path)
        if when == "pre":
            h = module.register_forward_pre_hook(lambda *a: fn())
        elif when == "post":
            h = module.register_forward_hook(lambda *a: fn())
        else:
            raise ValueError(f"span end {where!r}: expected <module>:pre or "
                             f"<module>:post")
        self.handles.append(h)

    def _begin(self, name: str) -> None:
        rf = torch.profiler.record_function("bench/" + name)
        rf.__enter__()
        self.open[name] = rf

    def _end(self, name: str) -> None:
        rf = self.open.pop(name, None)
        if rf is not None:
            rf.__exit__(None, None, None)

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        for name in list(self.open):
            self._end(name)
