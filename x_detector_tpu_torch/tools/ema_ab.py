"""A/B: held-out mAP of SSD's raw parameters against its EMA shadow.

The port of the JAX package's ``tools/ema_ab.py``: config 2's model
(ssd_resnet50 at 512 px, batch 16, EMA decay 0.999) trained on the
synthetic stream without augmentation (the image minus ``pixel_means``
only; the SSD family matches anchors in its loss), learning rate 2e-3
with 200 warm-up steps and decays (1, 0.3, 0.1) at 0.7 and 0.9 of the
steps; then the raw parameters and the shadow (each in a model of its
own, its kernel operands prepared for the weights it holds) on one
held-out stream. One JSON line a weight set.

  python -m x_detector_tpu_torch.tools.ema_ab --steps 3000
  python -m x_detector_tpu_torch.tools.ema_ab --smoke --steps 2 \\
      --eval-batches 1 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional

from x_detector_tpu_torch.cli import common
from x_detector_tpu_torch.config import ssd_resnet50
from x_detector_tpu_torch.tools import fast_nms_ab as ab
from x_detector_tpu_torch.train.train_state import TrainState

# the held-out stream's seed (the JAX package's PRNGKey(987654))
EMA_HELD_OUT_SEED = 987654


def ema_config(steps: int, batch: int = 16, image_size: int = 512,
               ema_decay: float = 0.999):
    """The JAX package's EMA recipe on config 2's model."""
    cfg = ssd_resnet50(image_size=image_size)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=batch, learning_rate=2e-3, warmup_steps=200,
        ema_decay=ema_decay,
        lr_boundaries=(int(steps * 0.7), int(steps * 0.9)),
        lr_decays=(1.0, 0.3, 0.1)))


def weight_sets(state: TrainState) -> Dict[str, dict]:
    """{"raw": the model's state dict, "ema": it with the EMA shadow in
    place of the parameters}. With decay 0 the state keeps no shadow, and
    a shadow of decay 0 is the parameters: "ema" is then "raw"'s copy."""
    raw = dict(state.model.state_dict())
    ema = (common.eval_variables(state, use_ema=True)
           if state.ema_params is not None else dict(raw))
    return {"raw": raw, "ema": ema}


def score_weight_sets(cfg, state: TrainState, num_batches: int, device,
                      dtype, batches=None) -> Dict[str, float]:
    """Held-out mAP of each of ``weight_sets(state)`` on the exact path,
    over the stream EMA_HELD_OUT_SEED (or ``batches``)."""
    if batches is not None:
        batches = list(batches)
    return {name: ab.eval_map(
        cfg, ab.make_detect_fn(cfg, state.model, "exact", dtype,
                               state_dict=weights),
        num_batches, device, batches, seed=EMA_HELD_OUT_SEED)
        for name, weights in weight_sets(state).items()}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ab.add_harness_args(p)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--ema-decay", type=float, default=0.999)
    args = p.parse_args(argv)
    device, dtype, label = ab.resolve_harness(args)

    cfg = ema_config(args.steps, args.batch, args.image_size, args.ema_decay)
    if args.smoke:
        cfg = ab.smoke_shrink(cfg, "ssd")
    print(f"[ssd] training {args.steps} synthetic steps, EMA "
          f"{cfg.train.ema_decay}...", flush=True)
    state, info = ab.train_synthetic(cfg, args.steps, device, dtype,
                                     augment=False)
    maps = score_weight_sets(cfg, state, args.eval_batches, device, dtype)
    return [ab.emit({"family": "ssd", "preset": cfg.model.name,
                     "weights": name, "held_out_mAP": m,
                     "ema_decay": cfg.train.ema_decay, "seed": cfg.train.seed,
                     "device": label, "steps": args.steps,
                     "train_images_per_sec": info["train_images_per_sec"],
                     "train_loss": info["train_loss"]})
            for name, m in maps.items()]


if __name__ == "__main__":
    main()
