"""Training CLI: either family, on one card (or the CPU when asked), over
the synthetic data stream, with checkpoints that resume.

The port of ``x_detector_tpu/cli/train.py``. Example (on the card)::

  python -m x_detector_tpu_torch.cli.train --preset ssd_resnet50 \\
      --steps 1000 --model-dir DIR [--resume]

Step ``position`` (the count of batches consumed, from 1) takes its
augmentation draws and its Light-Head RPN draws from generators seeded by
``(--seed, stream, position)``, so a run resumed at any position draws what
an uninterrupted run draws there.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
from typing import Dict

import numpy as np
import torch

from x_detector_tpu_torch.cli import common
from x_detector_tpu_torch.cli.evaluate import run_eval
from x_detector_tpu_torch.data.augment import preprocess_batch_for_train
from x_detector_tpu_torch.inference import build_eval_fn, build_model
from x_detector_tpu_torch.train.checkpoint import CheckpointManager
from x_detector_tpu_torch.train.train_state import TrainState
from x_detector_tpu_torch.train.trainer import (create_model_and_state,
                                                make_train_step)
from x_detector_tpu_torch.utils.logging import MetricsLogger

CANVAS_SCALE = 1.2      # host canvases are larger, so crops have context
AUGMENT_STREAM, STEP_STREAM = 1, 2


def position_generator(device: torch.device, seed: int, stream: int,
                       position: int) -> torch.Generator:
    """A generator on ``device`` seeded by a fixed function of ``(seed,
    stream, position)``: the counterpart of JAX's ``fold_in(PRNGKey(seed +
    stream), position)``."""
    mixed = np.random.SeedSequence((seed, stream, position)).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def main(argv=None) -> TrainState:
    """Train ``--steps`` updates in all (a resumed run continues to that
    count); returns the final state."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_common_args(p)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--num-devices", type=int, default=0,
                   help="data-parallel device count: not ported")
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--dtype", default="bfloat16", choices=sorted(
        common.DTYPES))
    p.add_argument("--resume", action="store_true")
    p.add_argument("--tensorboard", action="store_true",
                   help="TensorBoard event files: not written by the port")
    p.add_argument("--eval-every", type=int, default=0,
                   help="run VOC mAP eval every N steps (0 = off)")
    p.add_argument("--eval-batches", type=int, default=20)
    p.add_argument("--pretrained", default=None,
                   help="ImageNet backbone init: not ported")
    args = p.parse_args(argv)
    if args.num_devices > 1:
        raise NotImplementedError(
            "--num-devices > 1: data-parallel training is not ported yet "
            "(ROADMAP.md, Queue A item 5)")
    if args.pretrained:
        raise NotImplementedError(
            "--pretrained: loading ImageNet backbone weights "
            "(utils/pretrained.py) is not ported yet (ROADMAP.md, Queue A "
            "item 8)")
    if args.tensorboard:
        raise NotImplementedError(
            "--tensorboard: the port writes metrics.jsonl only (no "
            "TensorFlow to write event files with)")
    common.require_synthetic(args)
    device = common.resolve_device(args)
    cfg = common.resolve_config(args)
    state = create_model_and_state(cfg, device, seed=args.seed,
                                   dtype=common.DTYPES[args.dtype])
    step_fn = make_train_step(state.model, cfg)

    os.makedirs(args.model_dir, exist_ok=True)
    ckpt = CheckpointManager(os.path.join(args.model_dir, "ckpt"),
                             keep=cfg.train.keep_checkpoints)
    logger = MetricsLogger(os.path.join(args.model_dir, "metrics.jsonl"),
                           echo_every=args.log_every)

    position = 0
    if args.resume and ckpt.latest_step() is not None:
        state, data_state = ckpt.restore(state)
        position = int(data_state.get("position", 0))
        print(f"resumed from step {state.step} (data position {position})")

    it = common.batch_iterator(
        args, cfg, canvas_size=int(cfg.model.image_size * CANVAS_SCALE),
        start_batch=position)
    pin = device.type == "cuda"

    def fetch() -> Dict[str, torch.Tensor]:
        out = {k: torch.from_numpy(v) for k, v in next(it).items()}
        return {k: v.pin_memory() for k, v in out.items()} if pin else out

    # one thread makes the next numpy batch while the card steps
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    eval_model, eval_fn = None, None
    try:
        pending = pool.submit(fetch)
        step = state.step
        while step < args.steps:
            host = pending.result()
            pending = pool.submit(fetch)
            position += 1
            batch = {k: v.to(device, non_blocking=True)
                     for k, v in host.items()}
            batch = preprocess_batch_for_train(position_generator(
                device, args.seed, AUGMENT_STREAM, position), batch,
                cfg.data)
            state, metrics = step_fn(state, batch, position_generator(
                device, args.seed, STEP_STREAM, position))
            step += 1   # counted here: reading metrics would synchronise
            if step % args.log_every == 0 or step >= args.steps:
                logger.log(step, metrics)
            if args.eval_every and step % args.eval_every == 0:
                eval_model, eval_fn = periodic_eval(
                    args, cfg, state, eval_model, eval_fn, logger, step)
            if step % args.checkpoint_every == 0 or step >= args.steps:
                ckpt.save(step, state, data_state={"position": position})
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        ckpt.wait()
        ckpt.close()
        logger.close()
    print(f"done: {state.step} steps -> {args.model_dir}")
    return state


def periodic_eval(args, cfg, state: TrainState, eval_model, eval_fn,
                  logger: MetricsLogger, step: int):
    """mAP of the weights ``eval_variables`` picks (the EMA shadow when the
    state keeps one) in a second model, built at the first call and reused
    with its eval function; logs ``eval_mAP``. Returns both for reuse."""
    device = next(state.model.parameters()).device
    if eval_model is None:
        eval_model = build_model(cfg.model, device, seed=None,
                                 dtype=common.DTYPES[args.dtype])
        eval_fn = build_eval_fn(eval_model, cfg, device)
    eval_model.load_state_dict(common.eval_variables(state))
    res = run_eval(eval_model, cfg, common.batch_iterator(args, cfg),
                   args.eval_batches, eval_fn=eval_fn)
    logger.log(step, {"eval_mAP": res["mAP"]})
    return eval_model, eval_fn


if __name__ == "__main__":
    main()
