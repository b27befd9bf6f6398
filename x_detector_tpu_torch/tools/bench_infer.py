"""Per-preset inference profile: cumulative stages with FLOPs, MFU and the
bandwidth floor, on one card.

The port of the JAX package's ``tools/bench_infer.py``. The surface is
``bench_detect``'s (uniform float images in [0, 255) through
``build_eval_fn``, seeded weights in bf16, Xception-lite on kernel B2 as
config 3 serves: ``profile_infer.path_config`` and ``build_path``), split
into cumulative stages, each timed alone:

  backbone      ``model.backbone`` only
  model         the whole forward (for Light-Head: the RPN, proposals and
                NMS, the thin map, PSROIAlign (B1) and the RoI head)
  +postprocess  the forward, then the family's decode and per-class NMS:
                ``build_eval_fn``'s function

Each stage runs over ``--iters`` distinct batches staged on the card a
round, the three stages in turn for ``--passes`` rounds, each round
fenced by a synchronize (``bench_detect.alternating_rounds``: the card's
host drifts between fast and slow states, and stages timed one after the
other can land in different ones): the median round and the rounds'
spread. ``utils.roofline.count`` counts each stage's
FLOPs (PyTorch's formulas and the kernels' own) and the bytes its operators
move, once on one batch: MFU is a stage's added FLOPs over its added time
against the H100's bf16 tensor peak (989 TFLOP/s); the bandwidth floor is
its added bytes at HBM's 3.35 TB/s. Elementwise work counts bytes, no
FLOPs. One JSON line a stage, the table's columns; the line
``tf_by_stage`` splits the whole path's FLOPs by the forward's parts, the
stages ``profile_infer`` times (``train/profile_step.FORWARD_PARTS`` and
``forward_parts``), the rest outside them (proposals, PSROIAlign, NMS);
and a last line with the JAX tool's summary keys and the launches a batch
of each kernel. ``--profile DIR`` traces three whole batches
(``utils.profiling.trace``, ``DIR/trace.json``). ``--backbone-quant int8``
calibrates the int8 backbone over ``--calib-batches`` batches of the same
images first.

  python -m x_detector_tpu_torch.tools.bench_infer --preset \\
      lighthead_resnet50 --batch 16 [--iters 8] [--passes 3] [--profile DIR]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from x_detector_tpu_torch.profile_infer import PATHS, build_path
from x_detector_tpu_torch.tools import add_device_args
from x_detector_tpu_torch.tools.bench_detect import (alternating_rounds,
                                                     staged_images,
                                                     tool_config)
from x_detector_tpu_torch.tools.fast_nms_ab import emit, resolve_harness
from x_detector_tpu_torch.train.profile_step import (FORWARD_PARTS,
                                                     forward_parts)
from x_detector_tpu_torch.utils import roofline
from x_detector_tpu_torch.utils.profiling import trace

CALIB_SEED = 700


def stage_fns(model, detect) -> dict:
    """Each stage's function of a batch (the eval function's
    ``inference_mode`` around the other two)."""
    def infer(fn):
        def run(x):
            with torch.inference_mode():
                return fn(x)
        return run
    return {"backbone": infer(model.backbone), "model": infer(model),
            "+postprocess": detect}


def flop_by_stage(model, cost: roofline.Cost) -> Dict[str, float]:
    """``cost``'s FLOPs by the forward's parts, named as ``profile_infer``
    names its stages, and "rest" for what no part holds."""
    parts = forward_parts(model) or {p: "forward " + p
                                     for p in FORWARD_PARTS}
    root = type(model).__name__
    out: Dict[str, float] = {}
    for sub, stage in parts.items():
        out[stage] = out.get(stage, 0.0) + cost.by_module.get(
            f"{root}.{sub}", 0.0)
    out["rest"] = cost.flop - sum(out.values())
    return out


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--preset", default="lighthead_resnet50",
                   choices=sorted(PATHS))
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--passes", type=int, default=3)
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler trace of 3 whole batches "
                        "to this directory")
    p.add_argument("--backbone-quant", default=None, choices=["int8"],
                   help="the int8 backbone, calibrated on the card over "
                        "--calib-batches batches of the timed images' "
                        "distribution (a throughput measurement: the "
                        "weights are random)")
    p.add_argument("--calib-batches", type=int, default=4)
    add_device_args(p)
    args = p.parse_args(argv)
    device, dtype, label = resolve_harness(args)
    cfg = tool_config(args.preset, args.smoke, args.image_size,
                      args.backbone_quant)
    size = cfg.model.image_size
    calib = [x for i in range(args.calib_batches if args.backbone_quant
                              else 0)
             for x in staged_images(1, args.batch, size, device,
                                    CALIB_SEED + i)]
    model, detect = build_path(cfg, device, calib, dtype)
    batches = [(x,) for x in staged_images(args.iters, args.batch, size,
                                           device)]
    fns = stage_fns(model, detect)
    costs = {name: roofline.count(fn, *batches[0])[1]
             for name, fn in fns.items()}
    timed = alternating_rounds(fns, batches, args.passes, device)
    rows, prev = [], {"median_ms": 0.0, "cost": roofline.Cost(0.0, 0.0, {})}
    for name in fns:
        ms, cost = timed[name], costs[name]
        d_ms = ms["median_ms"] - prev["median_ms"]
        d_flop = cost.flop - prev["cost"].flop
        d_bytes = cost.nbytes - prev["cost"].nbytes
        rows.append(emit({
            "stage": name, "ms": ms["median_ms"],
            "spread_ms": ms["spread_ms"], "delta_ms": d_ms,
            "tf": d_flop / 1e12,
            "mfu_pct": (100 * roofline.mfu(d_flop, d_ms) if d_ms > 0
                        else 0.0),
            "gb": d_bytes / 2**30,
            "bw_floor_ms": roofline.bandwidth_floor_ms(d_bytes),
            "device": label}))
        prev = dict(ms, cost=cost)
    cost = prev["cost"]
    rows.append(emit({"tf_by_stage": {
        k: v / 1e12 for k, v in flop_by_stage(model, cost).items()},
        "device": label}))
    if args.profile:
        with trace(args.profile):
            for i in range(3):
                detect(*batches[i % len(batches)])
    rows.append(emit({
        "preset": cfg.model.name, "batch": args.batch, "image_size": size,
        "backbone_quant": args.backbone_quant,
        "images_per_sec_per_chip": args.batch / prev["median_ms"] * 1e3,
        "full_ms": prev["median_ms"], "full_tf": cost.flop / 1e12,
        "mfu_pct": 100 * roofline.mfu(cost.flop, prev["median_ms"]),
        "bw_floor_ms": roofline.bandwidth_floor_ms(cost.nbytes),
        "launches_per_batch": prev["launches"], "device": label}))
    return rows


if __name__ == "__main__":
    main()
