"""A/B: the bf16 against the int8 backbone on trained weights -- held-out
mAP and detection throughput -- for two seeds.

The port of the JAX package's ``tools/quant_ab.py``. Each family and seed
is trained with the shared recipe (``fast_nms_ab.train_synthetic``), its
backbone's activation ranges calibrated on the trained model
(``quant.calibrate_backbone`` over ``--calib-batches`` eval-preprocessed
synthetic batches from a stream of their own), then the same weights are
scored in bf16 and in int8 (``quant.build_detector``: kernels K1-K3) on
one held-out set and timed in alternating rounds. One JSON line a
(family, seed, precision).

Families: ``lighthead`` = config 3, ``lighthead_resnet50`` = config 1's
model, ``ssd`` = config 2; ``both`` = lighthead and ssd.

  python -m x_detector_tpu_torch.tools.quant_ab --family both --seeds 0,1
  python -m x_detector_tpu_torch.tools.quant_ab --smoke --steps 2 \\
      --eval-batches 1 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Iterator, List, Optional

import torch

from x_detector_tpu_torch import quant
from x_detector_tpu_torch.cli.train import position_generator
from x_detector_tpu_torch.data.augment import preprocess_for_eval
from x_detector_tpu_torch.data.synthetic import synthetic_batch_device
from x_detector_tpu_torch.tools import fast_nms_ab as ab

# the calibration stream: CALIB_STREAM of seed 777 (the JAX package's
# PRNGKey(777)), keyed apart from every train stream (fast_nms_ab)
CALIB_SEED, CALIB_STREAM = 777, 4
# the float arm's name by its precision (fast_nms_ab.harness_dtype)
FLOAT_NAMES = {torch.bfloat16: "bf16", torch.float32: "fp32"}


def int8_config(cfg):
    """``cfg`` with its backbone in int8."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_quant="int8"))


def calibration_images(cfg, device, num_batches: int,
                       seed: int = CALIB_SEED) -> Iterator[torch.Tensor]:
    """``num_batches`` raw synthetic image batches at the model's size from
    the generators keyed (``seed``, CALIB_STREAM, batch)."""
    for i in range(num_batches):
        yield synthetic_batch_device(
            position_generator(torch.device(device), seed, CALIB_STREAM, i),
            cfg.train.batch_size,
            cfg.model.image_size, cfg.data.max_gt_boxes)["image"]


def calibrate(cfg, model: torch.nn.Module, images, dtype: torch.dtype,
              percentile: float = 100.0) -> Dict[str, torch.Tensor]:
    """The activation ranges of ``model``'s (trained, float) weights in
    ``cfg``'s int8 detector, over ``images`` (raw batches, whitened here
    by ``preprocess_for_eval``): the abs-max, or the ``percentile``."""
    qcfg = int8_config(cfg)
    device = next(model.parameters()).device
    qmodel = quant.build_detector(qcfg.model, device, dtype)
    qmodel.load_state_dict(model.state_dict())
    return quant.calibrate_backbone(
        qcfg, qmodel, (preprocess_for_eval(x, cfg.data) for x in images),
        percentile=percentile)


def make_int8_detect(cfg, model: torch.nn.Module,
                     ranges: Dict[str, torch.Tensor], dtype: torch.dtype):
    """``fast_nms_ab.make_detect_fn``'s exact path of ``cfg``'s int8
    detector holding ``model``'s float weights and ``ranges``."""
    return ab.make_detect_fn(int8_config(cfg), model, "exact", dtype,
                             state_dict={**model.state_dict(), **ranges})


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--family", default="both",
                   choices=["lighthead", "lighthead_resnet50", "ssd",
                            "both"])
    ab.add_harness_args(p)
    p.add_argument("--seeds", default="0,1")
    p.add_argument("--calib-batches", type=int, default=8)
    p.add_argument("--rounds", type=int, default=10,
                   help="alternating rounds of the throughput")
    args = p.parse_args(argv)
    device, dtype, label = ab.resolve_harness(args)
    fams = ["lighthead", "ssd"] if args.family == "both" else [args.family]
    rows = []
    for fam in fams:
        cfg = ab.capstone_config(fam, args.steps)
        if args.smoke:
            cfg = ab.smoke_shrink(cfg, fam)
        for seed in (int(s) for s in args.seeds.split(",")):
            scfg = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, seed=seed))
            print(f"[{fam} seed {seed}] training {args.steps} synthetic "
                  "steps...", flush=True)
            state, info = ab.train_synthetic(scfg, args.steps, device, dtype)
            ranges = calibrate(scfg, state.model, calibration_images(
                scfg, device, args.calib_batches), dtype)
            print(f"[{fam} seed {seed}] calibrated {len(ranges)} conv "
                  "ranges", flush=True)
            detects = {
                FLOAT_NAMES[dtype]: ab.make_detect_fn(
                    scfg, state.model, "exact", dtype),
                "int8": make_int8_detect(scfg, state.model, ranges, dtype)}
            maps = {k: ab.eval_map(scfg, d, args.eval_batches, device)
                    for k, d in detects.items()}
            rates = ab.throughput(scfg, detects, device, rounds=args.rounds)
            for precision in detects:
                rows.append(ab.emit({
                    "family": fam, "preset": cfg.model.name, "seed": seed,
                    "precision": precision,
                    "held_out_mAP": maps[precision],
                    "ms_per_batch": rates[precision]["ms_per_batch"],
                    "images_per_sec": rates[precision]["images_per_sec"],
                    "device": label, "steps": args.steps,
                    "train_images_per_sec": info["train_images_per_sec"],
                    "train_loss": info["train_loss"]}))
            del state, detects
    return rows


if __name__ == "__main__":
    main()
