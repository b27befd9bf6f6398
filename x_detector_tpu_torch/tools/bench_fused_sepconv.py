"""Kernel B2 (the fused separable conv) against the unfused cuDNN route, per
stage and end to end, on one card.

The port of the JAX package's ``tools/bench_fused_sepconv.py``. Two tiers:

  1. each of Xception-lite's four stage shapes of config 3 at batch 16
     (800 px): ``fused_separable_conv`` (kernel B2 through its operator
     ``xdt::fused_sepconv``, bf16) against the unfused route it replaces,
     cuDNN's depthwise 3x3, then the 1x1 conv, the folded BatchNorm and the
     ReLU (``ops.fused_sepconv.unfused_cudnn``, several calls). Each side
     runs ``--passes`` rounds of ``--iters`` calls over as many distinct
     inputs, timed by CUDA events: the median and the rounds' spread, each
     beside the call's bound (``ops.fused_sepconv.bound_ms``: x and the
     output moved once, or the operations at the bf16 tensor rate);
  2. config 3 end to end (``lighthead_xception`` inference, uniform float
     images through ``build_eval_fn``) with ``backbone_fused_sepconv`` on
     and off, the same weights: ms a batch at the median of ``--passes``
     rounds over ``--iters`` batches staged on the card, the two paths in
     turn (``bench_detect.alternating_rounds``), and the launches a batch
     (B2 14 fused, 0 unfused).

  python -m x_detector_tpu_torch.tools.bench_fused_sepconv [--batch 16] \\
      [--iters 48] [--passes 3] [--skip-ops] [--skip-e2e]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
from typing import List, Optional

import torch

from x_detector_tpu_torch.inference import build_eval_fn, build_model
from x_detector_tpu_torch.ops import fused_sepconv as fs
from x_detector_tpu_torch.ops.library import launch_counts, launches_since
from x_detector_tpu_torch.profile_infer import build_path
from x_detector_tpu_torch.tools import add_device_args
from x_detector_tpu_torch.tools.bench_detect import (alternating_rounds,
                                                     staged_images,
                                                     tool_config)
from x_detector_tpu_torch.tools.fast_nms_ab import emit, resolve_harness
from x_detector_tpu_torch.utils.profiling import median_spread, rounds_ms

STAGES = [  # (name, H, W, C, Cout, dilation) at config 3's 800 px
    ("stage1", 200, 200, 128, 128, 1),
    ("stage2", 100, 100, 256, 256, 1),
    ("stage3", 50, 50, 512, 512, 1),
    ("stage4", 50, 50, 1024, 1024, 2),
]
SMOKE_STAGES = [("stage1", 8, 8, 16, 16, 1), ("stage4", 4, 4, 32, 32, 2)]


def cycling(calls):
    """A function of no arguments that makes the next of ``calls``."""
    it = itertools.cycle(calls)
    return lambda: next(it)()


def stage_rows(stages, batch: int, iters: int, passes: int, device,
               label: str) -> List[dict]:
    """Tier 1: B2 and the unfused route at each of ``stages``."""
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for name, h, w, c, cout, d in stages:
        wd = torch.randn((3, 3, c), generator=gen, device=device) * 0.1
        wp = torch.randn((c, cout), generator=gen, device=device) * 0.05
        scale = torch.ones(cout, device=device)
        bias = torch.zeros(cout, device=device)
        xs = [torch.randn((batch, h, w, c), generator=gen,
                          device=device).to(torch.bfloat16)
              for _ in range(iters)]
        ops = fs.prepare_weights(wd, wp, scale, bias)
        kw = dict(dilation=d, relu=True, residual=None)
        before = launch_counts()
        fused = median_spread(rounds_ms(cycling([functools.partial(
            fs.fused_separable_conv_prepared, x, ops, **kw) for x in xs]),
            device, passes, iters))
        launches = launches_since(before)["fused_sepconv"]
        unfused = median_spread(rounds_ms(cycling([
            fs.unfused_cudnn(x, wd, wp, scale, bias, **kw) for x in xs]),
            device, passes, iters))
        bound, by = fs.bound_ms(batch, h, w, c, cout, False)
        rows.append(emit({
            "stage": name, "shape": [batch, h, w, c], "cout": cout,
            "dilation": d, "unfused_ms": unfused["median_ms"],
            "unfused_spread_ms": unfused["spread_ms"],
            "fused_ms": fused["median_ms"],
            "fused_spread_ms": fused["spread_ms"],
            "speedup": unfused["median_ms"] / fused["median_ms"],
            "bound_ms": bound, "bound_by": by,
            "fused_share_of_bound": bound / fused["median_ms"],
            "unfused_share_of_bound": bound / unfused["median_ms"],
            "fused_launches": launches, "device": label}))
        del xs
    return rows


def e2e_row(args, device, dtype, label: str) -> dict:
    """Tier 2: config 3 with its separable blocks on B2 and unfused."""
    cfg = tool_config("lighthead_xception", args.smoke)
    model, fused = build_path(cfg, device, dtype=dtype)
    plain_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_fused_sepconv=False))
    plain = build_model(plain_cfg.model, device, seed=None, dtype=dtype)
    plain.load_state_dict(model.state_dict())
    detects = {"fused": fused,
               "unfused": build_eval_fn(plain, plain_cfg, device)}
    batch = cfg.train.batch_size if args.smoke else args.batch
    batches = [(x,) for x in staged_images(args.iters, batch,
                                           cfg.model.image_size, device)]
    out = alternating_rounds(detects, batches, args.passes, device)
    return emit({
        "preset": "lighthead_xception", "batch": batch,
        "unfused_ms": out["unfused"]["median_ms"],
        "fused_ms": out["fused"]["median_ms"],
        "speedup": out["unfused"]["median_ms"] / out["fused"]["median_ms"],
        "fused_images_per_sec_per_chip":
            batch / out["fused"]["median_ms"] * 1e3,
        "unfused_spread_ms": out["unfused"]["spread_ms"],
        "fused_spread_ms": out["fused"]["spread_ms"],
        "fused_launches_per_batch": out["fused"]["launches"],
        "unfused_launches_per_batch": out["unfused"]["launches"],
        "device": label})


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--iters", type=int, default=48)
    p.add_argument("--passes", type=int, default=3)
    p.add_argument("--skip-ops", action="store_true")
    p.add_argument("--skip-e2e", action="store_true")
    add_device_args(p)
    args = p.parse_args(argv)
    device, dtype, label = resolve_harness(args)
    rows = []
    if not args.skip_ops:
        rows += stage_rows(SMOKE_STAGES if args.smoke else STAGES,
                           1 if args.smoke else args.batch, args.iters,
                           args.passes, device, label)
    if not args.skip_e2e:
        rows.append(e2e_row(args, device, dtype, label))
    return rows


if __name__ == "__main__":
    main()
