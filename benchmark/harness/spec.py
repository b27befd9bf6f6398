"""What a cell is, found by name: its entry in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the limits of its comparison
(``limits/<workload>.json``) and the readers of its per-layer metrics
(``metrics/<metric>.py``). A cell, a configuration, a mix or a metric is
added as files and entries; no code names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent.parent          # benchmark/
ROOT = HERE.parent                                      # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    limits: dict            # limits/<workload>.json: number -> limit
    end_to_end: List[dict]  # BENCHMARK.json metrics this cell reports
    per_layer: List[dict]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[Path] = None,
              here: Path = HERE) -> Cell:
    """The cell ``name`` as ``BENCHMARK.json`` (``bench``, at the root by
    default) and the data files under ``here`` describe it."""
    spec = _json(bench or here.parent / "BENCHMARK.json")
    entry = [w for w in spec["workloads"] if w["name"] == name]
    if not entry:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(w['name'] for w in spec['workloads'])}")
    w = entry[0]
    cfg_entry = [c for c in spec["configs"] if c["name"] == w["config"]][0]
    config = _json(here.parent / cfg_entry["file"])
    config["name"] = cfg_entry["name"]
    traffic = _json(here / "traffic" / f"{w['traffic']}.json")
    traffic["name"] = w["traffic"]
    limits = _json(here / "limits" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    layer = [m for m in spec["per_layer"] if _reports(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, layer)


def metric_reader(name: str, here: Path = HERE) -> Callable:
    """``read(window)`` of ``metrics/<name>.py``: the metric's value from a
    traced window (``harness.trace.Window``), or None where the window
    holds nothing for it to read."""
    path = here / "metrics" / f"{name}.py"
    mod_name = "benchmark_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loop_module(kind: str):
    """The general loop that runs a kind of traffic (``loops/<kind>.py``)."""
    return importlib.import_module(f"benchmark.loops.{kind}")


def limits_line(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each compared number beside its limit, in the limits' order."""
    return {k: {"value": numbers.get(k), "limit": v}
            for k, v in limits.items()}
