"""Overfit a fixed synthetic set: the end-to-end check that a detector
learns.

The body of ``tests/test_torch_overfit.py`` (the port of the JAX package's
``tests/test_integration_overfit.py``), at any width: the JAX test's 8
fixed class-coloured-rectangle images of 4 classes (``synthetic_batches``
seed 0 at 64 px, resized to the model's size, whitened as (x - 115) / 60),
SGD on that one batch, then the full detection
path (forward -> decode -> per-class NMS at score 0.3, 20 outputs -> VOC
evaluator) must recover every object: the JAX package's gates are a total
loss below 0.2 and a mAP above 0.95.

Detections are scored with batch statistics (the model in training mode,
as the JAX test applies it with ``train=True``): running averages need
thousands of steps to converge, and their lag is not what this checks.

  python -m x_detector_tpu_torch.tools.overfit --device cpu
  python -m x_detector_tpu_torch.tools.overfit --family lighthead --steps 300
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, Optional

import torch

from x_detector_tpu_torch.cli import common
from x_detector_tpu_torch.cli.train import STEP_STREAM, position_generator
from x_detector_tpu_torch.config import (DataConfig, lighthead_xception,
                                         ssd_resnet50)
from x_detector_tpu_torch.data.augment import crop_and_resize
from x_detector_tpu_torch.data.synthetic import synthetic_batches
from x_detector_tpu_torch.inference import postprocess
from x_detector_tpu_torch.train.trainer import (create_model_and_state,
                                                make_train_step)
from x_detector_tpu_torch.tools.fast_nms_ab import harness_dtype
from x_detector_tpu_torch.utils.metrics_voc import VOCEvaluator, add_batch

NUM_IMAGES, NUM_CLASSES = 8, 4
STEPS, LEARNING_RATE = 120, 1e-2
MAX_LOSS, MIN_MAP = 0.2, 0.95
# The JAX test draws its images at 64 px; every width trains on those
# images, resized. A draw at another size holds other objects (the noise is
# drawn first), and the 800 px draw hides one object wholly under another,
# which caps its mAP at 0.932, below the gate.
SOURCE_SIZE = 64
# the detection path that scores the fit (the JAX test's
# postprocess_detections(max_output=20, score_threshold=0.3))
MAX_OUTPUT, SCORE_THRESHOLD = 20, 0.3


# Config 3's Light-Head at 800 px diverges at the test's 1e-2 (the loss at
# 1e6-1e22 by step 10 and NaN by step 25 on an H100, bf16 and fp32 alike;
# also at 5e-3, and at 1e-2 after 100 warm-up steps): it takes the
# capstone recipe's 2e-3, with which it reaches mAP 1.0 by step 200.
FULL_WIDTH_LR = {"lighthead": 2e-3, "ssd": LEARNING_RATE}


def _recipe(cfg, learning_rate: float = LEARNING_RATE):
    """``cfg`` with the overfit's batch of 8, ``learning_rate``, no
    warm-up and no weight decay."""
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=NUM_IMAGES, learning_rate=learning_rate,
        warmup_steps=0, weight_decay=0.0))


def small_config():
    """The JAX test's model: ``tests/test_train.small_ssd_cfg`` (config 2
    on a (1, 1, 1, 1)-block ResNet of widths 16-64 at 64 px, 8 gt slots)
    with the overfit's recipe."""
    base = ssd_resnet50(image_size=64)
    return _recipe(dataclasses.replace(
        base, model=dataclasses.replace(base.model,
                                        backbone_stages=(1, 1, 1, 1),
                                        backbone_widths=(16, 32, 48, 64)),
        data=DataConfig(image_size=64, max_gt_boxes=8)))


def full_width_config(family: str):
    """Config 3's Light-Head model at 800 px ("lighthead") or config 2's
    SSD at 512 px ("ssd"), published widths, with the overfit's recipe at
    the family's FULL_WIDTH_LR."""
    presets = {"lighthead": lambda: lighthead_xception(800),
               "ssd": lambda: ssd_resnet50(512)}
    if family not in presets:
        raise ValueError(f"family {family!r}: expected 'lighthead' or "
                         f"'ssd'")
    return _recipe(presets[family](), FULL_WIDTH_LR[family])


def fixed_batch(cfg, device) -> dict:
    """The 8 fixed images (seed 0, 4 classes, drawn at SOURCE_SIZE) on
    ``device``, resized to the model's size by the eval path's bilinear
    ``crop_and_resize`` (the gt boxes are normalized: they stay) and
    whitened as the JAX test does."""
    raw = next(synthetic_batches(0, NUM_IMAGES, SOURCE_SIZE,
                                 cfg.data.max_gt_boxes,
                                 num_classes=NUM_CLASSES))
    batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    size = cfg.model.image_size
    if size != SOURCE_SIZE:
        full = torch.tensor([0.0, 0.0, 1.0, 1.0], device=device).expand(
            NUM_IMAGES, 4)
        batch["image"] = crop_and_resize(batch["image"], full, size)
    batch["image"] = (batch["image"] - 115.0) / 60.0
    return batch


def score(cfg, model: torch.nn.Module, batch: dict) -> dict:
    """VOC07 mAP of ``model`` in training mode (batch statistics) on
    ``batch``, through the family's postprocess at score 0.3, 20 outputs;
    the model's BatchNorm running statistics are left as they were."""
    mcfg = dataclasses.replace(cfg.model, nms=dataclasses.replace(
        cfg.model.nms, max_output=MAX_OUTPUT, score_threshold=SCORE_THRESHOLD,
        iou_threshold=0.45, approx_prefilter=False, fast_mode=False))
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    was_training = model.training
    try:
        model.train()
        with torch.no_grad():
            det = postprocess(model, model(batch["image"]), mcfg)
    finally:
        model.load_state_dict(stats, strict=False)
        model.train(was_training)
    ev = VOCEvaluator(num_classes=cfg.model.num_classes - 1)
    add_batch(ev, {k: batch[k].cpu().numpy()
                   for k in ("gt_boxes", "gt_labels", "gt_mask")},
              [t.cpu().numpy() for t in det])
    return ev.evaluate()


def train_dtype(cfg, device) -> torch.dtype:
    """The precision of an overfit run: fp32 for the test's model (the
    JAX test's), ``harness_dtype`` at full width (bf16 on a card)."""
    return (torch.float32 if cfg.model.image_size == SOURCE_SIZE
            else harness_dtype(device))


def overfit(cfg, device, steps: int = STEPS,
            dtype: torch.dtype = torch.float32, seed: int = 0) -> dict:
    """Train ``cfg``'s model (seed ``seed``) ``steps`` steps on
    ``fixed_batch``, the Light-Head RPN's draws from the generator of
    (seed, STEP_STREAM, step), then ``score`` it. Returns {"total_loss":
    the last step's, "mAP", "per_class_ap", "losses": every step's,
    "seconds": the steps after the first, "passed": both gates,
    "map_passed": the mAP gate}."""
    device = torch.device(device)
    batch = fixed_batch(cfg, device)
    state = create_model_and_state(cfg, device, seed=seed, dtype=dtype)
    step_fn = make_train_step(state.model, cfg)
    losses, t1 = [], None
    for i in range(steps):
        state, metrics = step_fn(state, batch, position_generator(
            device, seed, STEP_STREAM, i))
        losses.append(metrics["total_loss"].detach().float())
        if i == 0:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t1 = time.perf_counter()
    losses = torch.stack(losses).cpu().tolist()
    seconds = time.perf_counter() - t1 if t1 is not None else 0.0
    res = score(cfg, state.model, batch)
    return {"total_loss": losses[-1], "mAP": res["mAP"],
            "per_class_ap": res["per_class_ap"], "losses": losses,
            "seconds": seconds, "map_passed": res["mAP"] > MIN_MAP,
            "passed": losses[-1] < MAX_LOSS and res["mAP"] > MIN_MAP}


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--family", default=None, choices=["lighthead", "ssd"],
                   help="a full-width model (default: the test's)")
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; a run that finds no "
                        "card fails rather than use the CPU)")
    args = p.parse_args(argv)
    device = common.resolve_device(args)
    cfg = (full_width_config(args.family) if args.family
           else small_config())
    res = overfit(cfg, device, args.steps, train_dtype(cfg, device))
    print(json.dumps({"preset": cfg.model.name,
                      "image_size": cfg.model.image_size,
                      "steps": args.steps, "total_loss": res["total_loss"],
                      "mAP": res["mAP"], "passed": res["passed"]}),
          flush=True)
    return res


if __name__ == "__main__":
    main()
