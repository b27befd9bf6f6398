"""A/B: exact NMS against MaxpoolNMS on trained weights -- held-out mAP
and detection throughput -- and the recipe the accuracy harnesses share.

The port of the JAX package's ``tools/fast_nms_ab.py``. Each family is
trained on the synthetic stream (``train_synthetic``: fresh batches made
on the device every step, augmented on a 1.2x canvas), then the same
weights are scored on a held-out stream of their own with the exact NMS
path, the ``approx_prefilter`` path (in the port the exact top-k, so
bitwise the exact path) and MaxpoolNMS (``ops/maxpool_nms.py``), and the
three are timed against each other in alternating rounds. One JSON line a
(family, mode).

Families: ``lighthead`` = config 3 (lighthead_xception, batch 16 at 800
px; MaxpoolNMS replaces the RPN proposal NMS), ``ssd`` = config 2
(ssd_resnet50, batch 8 at 512 px; MaxpoolNMS replaces the per-class
NMS), ``xdet`` = xdet_xception (as ssd). Xception-lite models detect with
their separable blocks on kernel B2, as config 3 serves.

The held-out images come from ``torch.Generator`` streams on the device:
the card's held-out set is neither the CPU's nor the JAX package's, so a
mAP here stands beside the JAX package's as a result on another draw.

  python -m x_detector_tpu_torch.tools.fast_nms_ab --family both --steps 3000
  python -m x_detector_tpu_torch.tools.fast_nms_ab --smoke --steps 2 \\
      --eval-batches 1 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from x_detector_tpu_torch.cli import common
from x_detector_tpu_torch.cli.train import (AUGMENT_STREAM, STEP_STREAM,
                                            position_generator)
from x_detector_tpu_torch.config import (DataConfig, NMSConfig,
                                         ProposalConfig, lighthead_resnet50,
                                         lighthead_xception, ssd_resnet50,
                                         xdet_xception)
from x_detector_tpu_torch.data.augment import (preprocess_batch_for_train,
                                               preprocess_for_eval)
from x_detector_tpu_torch.data.synthetic import synthetic_batch_device
from x_detector_tpu_torch.inference import build_eval_fn, build_model
from x_detector_tpu_torch.tools import add_device_args
from x_detector_tpu_torch.train.train_state import TrainState
from x_detector_tpu_torch.train.trainer import (create_model_and_state,
                                                make_train_step)
from x_detector_tpu_torch.utils.metrics_voc import VOCEvaluator, add_batch
from x_detector_tpu_torch.utils.profiling import alternating_ms, card_label

MODES = ("exact", "approx", "maxpool")
FAMILIES = {"both": ["lighthead", "ssd"], "all": ["lighthead", "ssd", "xdet"]}
# Every generator is cli.train.position_generator's, keyed (seed, stream,
# index). A train step takes its images from stream DATA_STREAM of the
# run's seed, its augmentation's and the Light-Head RPN's draws from the
# CLI's streams (1 and 2); the other streams are never a train step's, so
# no seed's train draws meet them: the held-out set (HELD_OUT_STREAM of
# seed 123456, the JAX package's PRNGKey(123456)), the detection
# throughput's random images (THROUGHPUT_STREAM of seed 1000) and
# quant_ab's and calib_sensitivity's calibration streams.
DATA_STREAM, HELD_OUT_STREAM, THROUGHPUT_STREAM = 0, 3, 6
HELD_OUT_SEED, THROUGHPUT_SEED = 123456, 1000
CANVAS_SCALE = 1.2
LOG_EVERY = 500
# the steps whose mean loss a harness reports as its final train loss
LOSS_WINDOW = 100

Detect = Callable[[torch.Tensor], Tuple[torch.Tensor, ...]]


def capstone_config(fam: str, steps: int):
    """The synthetic training recipe of each family, the JAX package's
    field for field: ``lighthead`` = config 3 (Xception-lite, batch 16 at
    800 px), ``lighthead_resnet50`` = config 1's model at batch 16,
    ``ssd`` / ``xdet`` = config 2's geometry (512 px, the preset's batch);
    learning rate 2e-3, 200 warm-up steps, decays (1, 0.3, 0.1) at 2/3
    and 7/8 of ``steps`` (which must exceed 300: a boundary within the
    warm-up raises)."""
    sched = dict(learning_rate=2e-3, warmup_steps=200,
                 lr_boundaries=(steps * 2 // 3, steps * 7 // 8),
                 lr_decays=(1.0, 0.3, 0.1))
    if fam.startswith("lighthead"):
        cfg = (lighthead_resnet50 if fam == "lighthead_resnet50"
               else lighthead_xception)(image_size=800)
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=16, **sched))
    cfg = (ssd_resnet50 if fam == "ssd" else xdet_xception)(image_size=512)
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              **sched))


def smoke_shrink(cfg, fam: str):
    """A capstone config at the tests' size (64 px, thin backbones, batch
    2, no warm-up), as the JAX package shrinks it: the whole path of a
    harness on the CPU in minutes. Its numbers are no measurement."""
    tiny = dict(image_size=64, backbone_stages=(1, 1, 1, 1),
                backbone_widths=(16, 32, 48, 64))
    if fam.startswith("lighthead"):
        tiny.update(
            large_sep_mid=16, head_dim=64,
            backbone_widths=(32, 64, 96, 128),
            proposals=ProposalConfig(
                pre_nms_topk=128, post_nms_topk=32,
                pre_nms_topk_eval=128, post_nms_topk_eval=32,
                min_size=2.0),
            nms=NMSConfig(max_output=20))
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **tiny),
        data=DataConfig(image_size=64, max_gt_boxes=8),
        train=dataclasses.replace(cfg.train, batch_size=2, warmup_steps=0))


def train_batch(cfg, device, seed: int, step: int,
                augment: bool = True) -> Dict[str, torch.Tensor]:
    """Train step ``step``'s batch: ``synthetic_batch_device`` from the
    generator of (``seed``, DATA_STREAM, ``step``), on a 1.2x canvas then
    ``preprocess_batch_for_train`` with the generator of (``seed``,
    AUGMENT_STREAM, ``step``); without ``augment``, at the model's size
    and only whitened (the image minus ``pixel_means``)."""
    size = cfg.model.image_size
    raw = synthetic_batch_device(
        position_generator(device, seed, DATA_STREAM, step),
        cfg.train.batch_size, int(size * CANVAS_SCALE) if augment else size,
        cfg.data.max_gt_boxes)
    if not augment:
        means = raw["image"].new_tensor(cfg.data.pixel_means)
        return dict(raw, image=raw["image"] - means)
    return preprocess_batch_for_train(
        position_generator(device, seed, AUGMENT_STREAM, step), raw,
        cfg.data)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def train_synthetic(cfg, steps: int, device,
                    dtype: torch.dtype = torch.bfloat16,
                    augment: bool = True, log_every: int = LOG_EVERY,
                    log: Callable[[str], None] = print
                    ) -> Tuple[TrainState, dict]:
    """Train ``cfg``'s model from seed ``cfg.train.seed`` (its init and
    its stream) for ``steps`` steps on ``train_batch``'s batches, the
    Light-Head RPN's draws from the generator of (seed, STEP_STREAM,
    step). The loss is read on the host every ``log_every`` steps only;
    each step's ``total_loss`` stays on the device until the end. Returns
    the state and {"losses": every step's total loss, "train_loss": the
    mean of the last LOSS_WINDOW, "seconds": the time of the steps after
    the first, "train_images_per_sec": their rate}."""
    device = torch.device(device)
    seed = cfg.train.seed
    state = create_model_and_state(cfg, device, seed=seed, dtype=dtype)
    step_fn = make_train_step(state.model, cfg)
    losses: List[torch.Tensor] = []
    t0 = time.perf_counter()
    t1 = None
    for i in range(steps):
        batch = train_batch(cfg, device, seed, i, augment)
        state, metrics = step_fn(state, batch, position_generator(
            device, seed, STEP_STREAM, i))
        losses.append(metrics["total_loss"].detach().float())
        if i == 0:
            _sync(device)         # the first step builds and tunes: untimed
            t1 = time.perf_counter()
        if i % log_every == 0:
            log(f"  step {i}: loss {float(losses[-1]):.3f} "
                f"({time.perf_counter() - t0:.0f}s)")
    _sync(device)
    seconds = time.perf_counter() - t1 if t1 is not None else 0.0
    rate = ((steps - 1) * cfg.train.batch_size / seconds
            if steps > 1 and seconds > 0 else None)
    log(f"  trained {steps} steps in {time.perf_counter() - t0:.0f}s")
    losses = torch.stack(losses).cpu().tolist() if losses else []
    tail = losses[-LOSS_WINDOW:]
    return state, {"losses": losses,
                   "train_loss": sum(tail) / len(tail) if tail else None,
                   "seconds": seconds, "train_images_per_sec": rate}


def detect_config(cfg, mode: str):
    """``cfg`` as ``mode`` detects: "exact" (the preset's NMS, the exact
    prefilter), "approx" (``nms.approx_prefilter``), "maxpool" (MaxpoolNMS:
    ``proposals.fast_nms`` for Light-Head, ``nms.fast_mode`` for SSD); an
    Xception-lite backbone with its separable blocks fused (kernel B2, as
    config 3 serves; an int8 backbone does not take it)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    m = cfg.model
    if m.backbone == "xception_lite":
        m = dataclasses.replace(m, backbone_fused_sepconv=True)
    m = dataclasses.replace(m, nms=dataclasses.replace(
        m.nms, approx_prefilter=mode == "approx"))
    if mode == "maxpool":
        if m.family == "lighthead":
            m = dataclasses.replace(m, proposals=dataclasses.replace(
                m.proposals, fast_nms=True))
        else:
            m = dataclasses.replace(m, nms=dataclasses.replace(
                m.nms, fast_mode=True))
    return dataclasses.replace(cfg, model=m)


def make_detect_fn(cfg, model: torch.nn.Module, mode: str = "exact",
                   dtype: torch.dtype = torch.bfloat16,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Detect:
    """raw [0, 255] images [B, S, S, 3] on the device -> (boxes, scores,
    classes, valid): a new model of ``detect_config(cfg, mode)`` in
    ``dtype`` on ``model``'s device, holding ``state_dict`` (by default
    ``model``'s), through ``preprocess_for_eval`` and
    ``inference.build_eval_fn``, which prepares its kernel operands. The
    model is the function's ``model`` attribute."""
    dcfg = detect_config(cfg, mode)
    device = next(model.parameters()).device
    eval_model = build_model(dcfg.model, device, seed=None, dtype=dtype)
    eval_model.load_state_dict(model.state_dict() if state_dict is None
                               else state_dict)
    eval_fn = build_eval_fn(eval_model, dcfg, device)

    def detect(images: torch.Tensor):
        return eval_fn(preprocess_for_eval(images, dcfg.data))

    detect.model = eval_model
    return detect


def held_out_batch(cfg, device, index: int,
                   seed: int = HELD_OUT_SEED) -> Dict[str, torch.Tensor]:
    """Batch ``index`` of the held-out stream of ``seed``: raw images at
    the model's size, from the generator keyed (``seed``,
    HELD_OUT_STREAM, ``index``)."""
    gen = position_generator(torch.device(device), seed, HELD_OUT_STREAM,
                             index)
    return synthetic_batch_device(gen, cfg.train.batch_size,
                                  cfg.model.image_size, cfg.data.max_gt_boxes)


def held_out_result(cfg, detect: Detect, num_batches: int, device,
                    batches: Optional[Iterable[dict]] = None,
                    seed: int = HELD_OUT_SEED) -> dict:
    """The VOCEvaluator's result ({"mAP", "per_class_ap"}, VOC07 11-point)
    of ``detect`` over ``num_batches`` batches of the held-out stream
    ``seed``, or over ``batches`` (dicts of raw images and gt, numpy or
    torch) where given."""
    if batches is None:
        batches = (held_out_batch(cfg, device, bi, seed)
                   for bi in range(num_batches))
    ev = VOCEvaluator(num_classes=cfg.model.num_classes - 1)
    for bi, raw in enumerate(batches):
        det = detect(torch.as_tensor(raw["image"]).to(device))
        add_batch(ev, {k: torch.as_tensor(raw[k]).cpu().numpy()
                       for k in ("gt_boxes", "gt_labels", "gt_mask")},
                  [t.cpu().numpy() for t in det], bi)
    return ev.evaluate()


def eval_map(cfg, detect: Detect, num_batches: int, device,
             batches: Optional[Iterable[dict]] = None,
             seed: int = HELD_OUT_SEED) -> float:
    """Held-out mAP of ``detect`` (``held_out_result``'s)."""
    return held_out_result(cfg, detect, num_batches, device, batches,
                           seed)["mAP"]


def throughput(cfg, detects: Dict[str, Detect], device, iters: int = 8,
               rounds: int = 10) -> Dict[str, dict]:
    """Each of ``detects`` on ``iters`` batches of random [0, 255] images
    made on the device, the paths in alternating rounds of ``iters``
    batches (``utils.profiling.alternating_ms``) after a warm-up batch
    each: {name: {"ms_per_batch": median round, "best_ms": best round,
    "images_per_sec": at the median}}."""
    bsz, size = cfg.train.batch_size, cfg.model.image_size
    gen = position_generator(torch.device(device), THROUGHPUT_SEED,
                             THROUGHPUT_STREAM, 0)
    images = [torch.rand((bsz, size, size, 3), generator=gen,
                         device=device) * 255.0 for _ in range(iters)]
    sides = {}
    for name, detect in detects.items():
        detect(images[0])
        cycle = itertools.cycle(images)
        sides[name] = (lambda d, c: lambda: d(next(c)))(detect, cycle)
    ms = alternating_ms(sides, rounds=rounds, batches=iters, device=device)
    return {name: {"ms_per_batch": r["median"], "best_ms": r["best"],
                   "images_per_sec": bsz / r["median"] * 1e3}
            for name, r in ms.items()}


def add_harness_args(p: argparse.ArgumentParser, steps: int = 3000,
                     eval_batches: int = 10) -> None:
    """The flags every harness takes."""
    p.add_argument("--steps", type=int, default=steps)
    p.add_argument("--eval-batches", type=int, default=eval_batches)
    add_device_args(p)


def harness_dtype(device) -> torch.dtype:
    """The precision a harness trains and detects in: bf16 on a card, as
    the JAX package's harnesses run; fp32 on the CPU, where the tests hold
    the harnesses to the JAX package's in fp32 (chosen first for a CPU
    bf16 conv fault that ``models.layers.rounded_conv`` now repairs)."""
    return (torch.bfloat16 if torch.device(device).type == "cuda"
            else torch.float32)


def resolve_harness(args) -> Tuple[torch.device, torch.dtype, str]:
    """A harness's device (``common.resolve_device``: no card raises),
    its ``harness_dtype`` and the device's ``card_label``."""
    device = common.resolve_device(args)
    return device, harness_dtype(device), card_label(device)


def emit(row: dict) -> dict:
    print(json.dumps(row), flush=True)
    return row


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--family", default="both",
                   choices=["lighthead", "ssd", "xdet", "both", "all"])
    add_harness_args(p)
    p.add_argument("--rounds", type=int, default=10,
                   help="alternating rounds of the throughput")
    args = p.parse_args(argv)
    device, dtype, label = resolve_harness(args)
    rows = []
    for fam in FAMILIES.get(args.family, [args.family]):
        cfg = capstone_config(fam, args.steps)
        if args.smoke:
            cfg = smoke_shrink(cfg, fam)
        print(f"[{fam}] training {args.steps} synthetic steps...", flush=True)
        state, info = train_synthetic(cfg, args.steps, device, dtype)
        detects = {mode: make_detect_fn(cfg, state.model, mode, dtype)
                   for mode in MODES}
        maps = {mode: eval_map(cfg, d, args.eval_batches, device)
                for mode, d in detects.items()}
        rates = throughput(cfg, detects, device, rounds=args.rounds)
        for mode in MODES:
            rows.append(emit({
                "family": fam, "preset": cfg.model.name, "nms": mode,
                "held_out_mAP": maps[mode],
                "images_per_sec": rates[mode]["images_per_sec"],
                "ms_per_batch": rates[mode]["ms_per_batch"],
                "device": label, "steps": args.steps,
                "train_images_per_sec": info["train_images_per_sec"],
                "train_loss": info["train_loss"]}))
        del state, detects
    return rows


if __name__ == "__main__":
    main()
