"""One run of one cell: the checks before it, the loop, the metrics the
cell reports, the comparison's verdict, and the result line.

``run_cell`` is the whole run without the look for a chip, so that a test
can drive it on the CPU; ``main`` adds that look and the exit codes.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, List, Optional

import torch

from benchmark.harness import spec as spec_lib

FORBIDDEN = ("jax", "jaxlib", "flax", "x_detector_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every limited number present, finite and at most its limit."""
    for name, limit in limits.items():
        v = numbers.get(name)
        if v is None or not math.isfinite(v) or v > limit:
            return False
    return True


def device_info(chips: int, result: dict, device) -> dict:
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        info = {"platform": "gpu", "kind": kind, "count": chips}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": chips}
    info["memory_peak_bytes"] = int(result.get("memory_peak_bytes", 0))
    window = result.get("window")
    if window is not None:     # over several cards, the mean over them
        info["busy_s"] = result.get("busy_s", window.busy_s)
        info["window_s"] = result.get("window_s", window.window_s)
    return info


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device, started: float, cell=None) -> dict:
    """The result line's object (and the compared numbers beside their
    limits under ``checks``, last)."""
    cell = cell or spec_lib.load_cell(workload)
    loop = spec_lib.loop_module(cell.traffic["loop"])
    result = loop.run(cell, seed, seconds, traced, device, started)
    metrics = {}
    if traced:
        window = result["window"]
        for m in cell.per_layer:
            value = spec_lib.metric_reader(m["name"])(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": result["metrics"][m["name"]],
                                  "unit": m["unit"]}
    numbers = result["numbers"]
    out = {"correct": verdict(numbers, cell.limits),
           "attempted": result["attempted"], "failed": result["failed"],
           "metrics": metrics,
           "device": device_info(cell.chips, result, device)}
    if traced:
        window = result["window"]
        out["breakdown"] = window.breakdown()
        if window.lost:
            out["trace_lost_kernels"] = dict(zip(("traced", "launched"),
                                                 window.lost))
    out["loaded"] = sorted(set(result.get("loaded", ()))
                           | set(forbidden_modules()))
    out["numbers"] = numbers
    out["setup"] = result["setup"]
    out["checks"] = spec_lib.limits_line(numbers, cell.limits)
    return out


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(started: float, argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    cell = spec_lib.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), started, cell)
    return report(out)


def report(out: dict) -> int:
    """Print a run's numbers and result line, or refuse the run (exit 3,
    no result) where it, or any rank of it, loaded JAX or the JAX
    package."""
    found = sorted(set(out.pop("loaded")) | set(forbidden_modules()))
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark drives the "
              f"PyTorch port alone", file=sys.stderr)
        return 3
    phases = out.pop("setup")
    print("setup " + " ".join(f"{name} {t1 - t0:.3f}" for (_, t0), (name, t1)
                              in zip(phases, phases[1:])), file=sys.stderr)
    for name, value in out.pop("numbers").items():
        print(f"number {name} {value!r}", file=sys.stderr)
    if "trace_lost_kernels" in out:
        lost = out["trace_lost_kernels"]
        print(f"trace: the window lost kernels ({lost['traced']} traced, "
              f"{lost['launched']} launched); its rooflines are not "
              f"reported", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
