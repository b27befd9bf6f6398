"""Detection throughput for any preset and batch (images -> detections).

The port of the JAX package's ``tools/bench_detect.py``: the eval CLI's
surface, ``build_eval_fn`` on uniform float images in [0, 255) (no
``preprocess_for_eval``, as the JAX tool feeds them), from seeded weights in
bf16, the Xception-lite presets on kernel B2 as config 3 serves
(``profile_infer.path_config``). ``--iters`` distinct batches are staged on
the card first; after two warm-up batches, ROUNDS rounds each run
every batch once, fenced by a synchronize (``utils.profiling.DeviceTimer``).
One JSON line: images/s at the median round, the batch ms median and the
rounds' spread, and the launches a batch of kernels B2 and B1 (and K1-K3)
read from their operators.

  python -m x_detector_tpu_torch.tools.bench_detect --preset ssd_resnet50 \\
      --batch 8                                               # config 2
  python -m x_detector_tpu_torch.tools.bench_detect --preset \\
      lighthead_xception --batch 16                           # config 3
"""

from __future__ import annotations

import argparse
import itertools
from typing import Callable, Dict, List, Optional

import torch

from x_detector_tpu_torch.ops.library import launch_counts, launches_since
from x_detector_tpu_torch.profile_infer import PATHS, build_path, path_config
from x_detector_tpu_torch.tools import add_device_args
from x_detector_tpu_torch.tools.fast_nms_ab import (emit, resolve_harness,
                                                    smoke_shrink)
from x_detector_tpu_torch.utils.profiling import (DeviceTimer, alternating_ms,
                                                  median_spread)

ROUNDS = 3                         # --smoke: 1


def staged_images(n: int, batch: int, size: int, device, seed: int = 0
                  ) -> List[torch.Tensor]:
    """``n`` seeded batches of uniform float images in [0, 255) made on
    ``device``: staged before any timed window."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.rand((batch, size, size, 3), generator=gen,
                       device=device) * 255.0 for _ in range(n)]


def tool_config(preset: str, smoke: bool, image_size: Optional[int] = None,
                backbone_quant: Optional[str] = None):
    """``profile_infer.path_config`` of ``preset``, at the tests' size
    with ``smoke`` (``fast_nms_ab.smoke_shrink``)."""
    cfg = path_config(preset, backbone_quant, image_size)
    if smoke:
        cfg = smoke_shrink(cfg, cfg.model.family)
    return cfg


def timed_rounds(fn, argsets, rounds: int) -> List[float]:
    """ms a call of ``fn`` in each of ``rounds`` rounds over every one of
    ``argsets``, after two warm-up calls (``DeviceTimer``)."""
    timer = DeviceTimer(fn, argsets)
    return [timer.measure(len(argsets)) * 1e3 for _ in range(rounds)]


def alternating_rounds(fns: Dict[str, Callable], batches: List[tuple],
                       rounds: int, device) -> Dict[str, dict]:
    """Each of ``fns`` (name -> a function of a batch) over every one of
    ``batches`` a round, the functions in turn for ``rounds`` rounds
    (``utils.profiling.alternating_ms``: a host that drifts between fast
    and slow states shows each the same), after two warm-up calls each:
    {name: ``median_spread`` of its ms a call, and "launches", each
    kernel's launches a call, read over the warm-up calls}."""
    out, sides = {}, {}
    for name, fn in fns.items():
        before = launch_counts()
        for args in batches[:1] * 2:
            fn(*args)
        out[name] = {"launches": launches_since(before, 2)}
        cycle = itertools.cycle(batches)
        sides[name] = (lambda f, c: lambda: f(*next(c)))(fn, cycle)
    ms = alternating_ms(sides, rounds=rounds, batches=len(batches),
                        device=device)
    for name, r in ms.items():
        out[name].update(median_spread(r["rounds"]))
    return out


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--preset", default="ssd_resnet50", choices=sorted(PATHS))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--iters", type=int, default=10)
    add_device_args(p)
    args = p.parse_args(argv)
    device, dtype, label = resolve_harness(args)
    cfg = tool_config(args.preset, args.smoke, args.image_size)
    size = cfg.model.image_size
    _, detect = build_path(cfg, device, dtype=dtype)
    batches = [(x,) for x in staged_images(args.iters, args.batch, size,
                                           device)]
    before = launch_counts()
    rounds = 1 if args.smoke else ROUNDS
    ms = median_spread(timed_rounds(detect, batches, rounds))
    calls = 2 + rounds * args.iters
    return [emit({
        "preset": args.preset, "batch": args.batch, "image_size": size,
        "images_per_sec_per_chip": args.batch / ms["median_ms"] * 1e3,
        "batch_ms": ms["median_ms"], "spread_ms": ms["spread_ms"],
        "launches_per_batch": launches_since(before, calls),
        "device": label})]


if __name__ == "__main__":
    main()
