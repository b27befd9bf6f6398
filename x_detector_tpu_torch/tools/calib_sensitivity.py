"""Calibration under outliers: amax against percentile activation ranges,
held-out mAP of the int8 backbone under each.

The port of the JAX package's ``tools/calib_sensitivity.py``. The int8
activation scale is a running statistic over calibration batches; the
abs-max is the most outlier-sensitive one. This probe:

  1. trains one model with the shared recipe (``fast_nms_ab``);
  2. replaces a small fraction of each calibration batch's pixels by
     extreme values (hot pixels, specular saturation) before whitening;
  3. calibrates twice over the same corrupted batches, amax and
     ``--percentile``;
  4. scores held-out mAP (clean images) of the int8 backbone under each
     set of ranges and of the float model, and reports each conv's scale
     inflation amax / percentile.

One JSON line of the inflation, then one a (precision, calibration).

  python -m x_detector_tpu_torch.tools.calib_sensitivity --family ssd
  python -m x_detector_tpu_torch.tools.calib_sensitivity --smoke \\
      --steps 2 --eval-batches 1 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, NamedTuple, Optional

import torch

from x_detector_tpu_torch.cli.train import position_generator
from x_detector_tpu_torch.tools import fast_nms_ab as ab
from x_detector_tpu_torch.tools import quant_ab


# the hot pixels' draws, keyed apart from every train stream (fast_nms_ab)
HOT_PIXEL_STREAM = 5


class HotPixels(NamedTuple):
    hot: torch.Tensor      # [B, H, W] bool: the pixels replaced
    sign: torch.Tensor     # [B, H, W] float: -1 or +1


def draw_hot_pixels(generator: torch.Generator, shape,
                    frac: float) -> HotPixels:
    """The random half of :func:`corrupt` for images of ``shape`` [B, H,
    W, 3]: each pixel hot with probability ``frac``, a sign each."""
    dev = generator.device
    u1 = torch.rand(tuple(shape[:-1]), generator=generator, device=dev)
    u2 = torch.rand(tuple(shape[:-1]), generator=generator, device=dev)
    return HotPixels(u1 < frac, torch.where(u2 < 0.5, -1.0, 1.0))


def corrupt(images: torch.Tensor, draws: HotPixels,
            magnitude: float) -> torch.Tensor:
    """``images`` (raw [0, 255]) with each hot pixel replaced by sign x
    ``magnitude`` x 255 in all three channels: before the whitening, so the
    spikes pass through the calibration pipeline's own preprocessing."""
    spike = (draws.sign * magnitude * 255.0)[..., None]
    return torch.where(draws.hot[..., None], spike.to(images.dtype), images)


def corrupted_images(cfg, device, num_batches: int, frac: float,
                     magnitude: float):
    """``quant_ab.calibration_images``' batches, each corrupted with hot
    pixels drawn from the generator keyed (CALIB_SEED, HOT_PIXEL_STREAM,
    batch)."""
    for i, images in enumerate(quant_ab.calibration_images(
            cfg, device, num_batches)):
        draws = draw_hot_pixels(position_generator(
            torch.device(device), quant_ab.CALIB_SEED, HOT_PIXEL_STREAM, i),
            images.shape, frac)
        yield corrupt(images, draws, magnitude)


def inflation(amax: dict, pct: dict) -> dict:
    """amax / percentile of each conv's range ("per_conv", by state-dict
    key), and their max, median and count."""
    per_conv = {k: float(amax[k]) / max(float(pct[k]), 1e-12) for k in amax}
    ratios = sorted(per_conv.values())
    return {"max": ratios[-1], "median": ratios[len(ratios) // 2],
            "convs": len(ratios), "per_conv": per_conv}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--family", default="ssd", choices=["lighthead", "ssd"])
    ab.add_harness_args(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--calib-batches", type=int, default=8)
    p.add_argument("--hot-frac", type=float, default=1e-4,
                   help="fraction of calibration pixels replaced by spikes")
    p.add_argument("--hot-magnitude", type=float, default=8.0,
                   help="spike amplitude in units of the raw [0, 255] range")
    p.add_argument("--percentile", type=float, default=99.9)
    args = p.parse_args(argv)
    device, dtype, label = ab.resolve_harness(args)

    cfg = ab.capstone_config(args.family, args.steps)
    if args.smoke:
        cfg = ab.smoke_shrink(cfg, args.family)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, seed=args.seed))
    print(f"[{args.family}] training {args.steps} synthetic steps...",
          flush=True)
    state, info = ab.train_synthetic(cfg, args.steps, device, dtype)

    pct_name = f"p{args.percentile:g}"
    arms = {name: quant_ab.calibrate(
        cfg, state.model, corrupted_images(
            cfg, device, args.calib_batches, args.hot_frac,
            args.hot_magnitude), dtype, percentile=pct)
        for name, pct in (("amax", 100.0), (pct_name, args.percentile))}
    infl = inflation(arms["amax"], arms[pct_name])
    rows = [ab.emit({"scale_inflation_amax_over_pct": infl})]

    common_keys = {"family": args.family, "preset": cfg.model.name,
                   "seed": args.seed, "steps": args.steps,
                   "hot_frac": args.hot_frac,
                   "hot_magnitude": args.hot_magnitude, "device": label,
                   "train_images_per_sec": info["train_images_per_sec"],
                   "train_loss": info["train_loss"]}
    detect = ab.make_detect_fn(cfg, state.model, "exact", dtype)
    rows.append(ab.emit({**common_keys,
                         "precision": quant_ab.FLOAT_NAMES[dtype],
                         "calibration": None,
                         "held_out_mAP": ab.eval_map(
                             cfg, detect, args.eval_batches, device)}))
    for name, ranges in arms.items():
        detect = quant_ab.make_int8_detect(cfg, state.model, ranges, dtype)
        rows.append(ab.emit({**common_keys, "precision": "int8",
                             "calibration": name,
                             "held_out_mAP": ab.eval_map(
                                 cfg, detect, args.eval_batches, device)}))
    return rows


if __name__ == "__main__":
    main()
