"""Config 3 trained on the synthetic stream, then scored on a held-out
stream: held-out mAP, per-class AP and the train rate.

The port of the JAX package's ``tools/train_synthetic_capstone.py``:
lighthead_xception at 800 px, batch 16, bf16, learning rate 2e-3 with 200
warm-up steps and decays (1, 0.3, 0.1) at 2/3 and 7/8 of the steps
(``fast_nms_ab.capstone_config``), fresh augmented batches made on the
device every step (``fast_nms_ab.train_synthetic``); then 10 held-out
batches through the exact detection path. ``--seed`` varies the init and
the train stream; the held-out stream stays fixed, so every run scores the
same images. ``--sampler`` picks the crop sampler (``DataConfig.
crop_sampler``). One JSON line.

  python -m x_detector_tpu_torch.tools.train_synthetic_capstone
  python -m x_detector_tpu_torch.tools.train_synthetic_capstone --smoke \\
      --steps 2 --eval-batches 1 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

from x_detector_tpu_torch.tools import fast_nms_ab as ab


def capstone_recipe(steps: int, seed: int = 0, lr: float = 2e-3,
                    sampler: Optional[str] = None):
    """``capstone_config("lighthead", steps)`` with the learning rate, the
    seed and (when given) the crop sampler."""
    cfg = ab.capstone_config("lighthead", steps)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, learning_rate=lr, seed=seed))
    if sampler is not None:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, crop_sampler=sampler))
    return cfg


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ab.add_harness_args(p, steps=12000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--sampler", default=None,
                   help="crop sampler (default: the preset's)")
    args = p.parse_args(argv)
    device, dtype, label = ab.resolve_harness(args)

    cfg = capstone_recipe(args.steps, args.seed, args.lr, args.sampler)
    if args.smoke:
        cfg = ab.smoke_shrink(cfg, "lighthead")
    print(f"[lighthead] training {args.steps} synthetic steps...",
          flush=True)
    state, info = ab.train_synthetic(cfg, args.steps, device, dtype,
                                     log_every=1000)
    detect = ab.make_detect_fn(cfg, state.model, "exact", dtype)
    res = ab.held_out_result(cfg, detect, args.eval_batches, device)
    return [ab.emit({
        "family": "lighthead", "preset": cfg.model.name, "seed": args.seed,
        "sampler": cfg.data.crop_sampler, "lr": cfg.train.learning_rate,
        "held_out_mAP": res["mAP"],
        "per_class_ap": {str(k): v for k, v in
                         sorted(res["per_class_ap"].items())},
        "device": label, "steps": args.steps,
        "train_images_per_sec": info["train_images_per_sec"],
        "train_loss": info["train_loss"]})]


if __name__ == "__main__":
    main()
