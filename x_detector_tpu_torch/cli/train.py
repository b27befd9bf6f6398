"""Training CLI: either family, on one card (or the CPU when asked) or
data-parallel over N, from TFRecord shards or synthetic data, with
checkpoints that resume.

The port of ``x_detector_tpu/cli/train.py``. Examples (on the card)::

  python -m x_detector_tpu_torch.cli.train --preset ssd_resnet50 \\
      --steps 1000 --model-dir DIR [--resume] [--data-dir SHARDS]
  python -m x_detector_tpu_torch.cli.train --preset lighthead_xception \\
      --num-devices 8 --batch-size 128 --grad-accum 2 --model-dir DIR
  python -m x_detector_tpu_torch.cli.train --preset lighthead_resnet50 \\
      --pretrained resnet50.pth --tensorboard --model-dir DIR

``--num-devices N`` (N > 1) runs the data-parallel step on N ranks, one a
card (``--device cpu``: N gloo ranks on the CPU): this process starts them
and waits, or, under torchrun with ``XDET_MULTIHOST=1``, each
process is one rank. ``--batch-size`` is the global batch: every rank
reads the same stream and keeps its rows. Rank 0 alone writes
``metrics.jsonl`` and the checkpoints; ``--resume`` restores every rank
from the same checkpoint and data position.

Step ``position`` (the count of batches consumed, from 1) takes its
augmentation draws and its Light-Head RPN draws from generators seeded by
``(--seed, stream, position)`` (and the rank, for the RPN draws of a
data-parallel run), so a run resumed at any position draws what an
uninterrupted run draws there.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from x_detector_tpu_torch.cli import common
from x_detector_tpu_torch.cli.evaluate import run_eval
from x_detector_tpu_torch.data.augment import preprocess_batch_for_train
from x_detector_tpu_torch.inference import build_eval_fn, build_model
from x_detector_tpu_torch.models.layers import prepare_for_inference
from x_detector_tpu_torch.parallel import mesh
from x_detector_tpu_torch.parallel.data_parallel import make_dp_train_step
from x_detector_tpu_torch.train.checkpoint import CheckpointManager
from x_detector_tpu_torch.train.train_state import TrainState
from x_detector_tpu_torch.train.trainer import (create_model_and_state,
                                                make_train_step)
from x_detector_tpu_torch.utils.logging import MetricsLogger
from x_detector_tpu_torch.utils.pretrained import load_pretrained_backbone

CANVAS_SCALE = 1.2      # host canvases are larger, so crops have context
AUGMENT_STREAM, STEP_STREAM = 1, 2
BATCH_KEYS = ("image", "gt_boxes", "gt_labels", "gt_mask", "difficult",
              "box_scale")
# how long a collective, or the other ranks' exit, may keep rank 0 waiting
SPAWN_TIMEOUT_S = mesh.GROUP_TIMEOUT_S


def position_generator(device: torch.device, seed: int, stream: int,
                       position: int, rank: Optional[int] = None
                       ) -> torch.Generator:
    """A generator on ``device`` seeded by a fixed function of ``(seed,
    stream, position)``, and of ``rank`` when given: the counterpart of
    JAX's ``fold_in(PRNGKey(seed + stream), position)`` (and of its
    ``fold_in(rng, axis_index)``)."""
    key = (seed, stream, position) + (() if rank is None else (rank,))
    mixed = np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def parse_args(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_common_args(p)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--num-devices", type=int, default=0,
                   help="data-parallel rank count, one device a rank (0 or "
                        "1: the single-device step)")
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--dtype", default="bfloat16", choices=sorted(
        common.DTYPES))
    p.add_argument("--resume", action="store_true")
    p.add_argument("--tensorboard", action="store_true",
                   help="also write TensorBoard event files (scalar "
                        "summaries) to <model-dir>/tb")
    p.add_argument("--eval-every", type=int, default=0,
                   help="run VOC mAP eval every N steps (0 = off)")
    p.add_argument("--eval-batches", type=int, default=20)
    p.add_argument("--pretrained", default=None,
                   help="ImageNet backbone init (reference T5 semantics): a "
                        "torchvision .pth/.pt state dict or a TF-slim "
                        "resnet_v1_50 checkpoint prefix; heads keep their "
                        "fresh init")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Optional[TrainState]:
    """Train ``--steps`` updates in all (a resumed run continues to that
    count); returns the final state (None where this process started the
    ranks of a data-parallel run: the checkpoint holds rank 0's)."""
    args = parse_args(argv)
    device_type = torch.device(args.device).type
    if mesh.maybe_initialize_distributed(device_type):     # torchrun's rank
        return train(args, torch.distributed.get_rank(),
                     torch.distributed.get_world_size())
    if args.num_devices > 1:
        mesh.require_devices(device_type, args.num_devices)
        return mesh.run_ranks(_train_rank, args.num_devices,
                              mesh.backend_for(device_type),
                              (argv,), timeout_s=SPAWN_TIMEOUT_S)
    return train(args, 0, 1)


def _train_rank(rank: int, world: int, argv: Optional[List[str]]) -> None:
    """One rank of ``run_ranks``."""
    train(parse_args(argv), rank, world)


def train(args, rank: int, world: int) -> TrainState:
    """The training loop of one rank of ``world`` (world 1: the
    single-device step, no process group)."""
    if world > 1:
        device = mesh.rank_device(torch.device(args.device).type,
                                  mesh.local_rank())
        if device.type == "cpu":     # ranks share the cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    else:
        device = common.resolve_device(args)
    cfg = common.resolve_config(args)
    if args.pretrained and cfg.model.backbone != "resnet50":
        raise SystemExit("--pretrained provides ResNet-50 ImageNet weights; "
                         f"preset backbone is {cfg.model.backbone!r}")
    state = create_model_and_state(cfg, device, seed=args.seed,
                                   dtype=common.DTYPES[args.dtype])
    if args.pretrained:
        graft_pretrained(state, args.pretrained,
                         cfg.model.backbone_stages or (3, 4, 6, 3))
        if rank == 0:
            print(f"grafted pretrained backbone from {args.pretrained}")
    step_fn = (make_dp_train_step(state.model, cfg) if world > 1
               else make_train_step(state.model, cfg))

    lead = rank == 0
    ckpt = CheckpointManager(os.path.join(args.model_dir, "ckpt"),
                             keep=cfg.train.keep_checkpoints)
    logger = MetricsLogger(
        os.path.join(args.model_dir, "metrics.jsonl"),
        echo_every=args.log_every,
        tensorboard_dir=(os.path.join(args.model_dir, "tb")
                         if args.tensorboard else None)) if lead else None

    position = 0
    if args.resume and ckpt.latest_step() is not None:
        state, data_state = ckpt.restore(state)
        position = int(data_state.get("position", 0))
        if lead:
            print(f"resumed from step {state.step} (data position "
                  f"{position})")
    if world > 1:
        mesh.replicate_state(state)

    it = common.batch_iterator(
        args, cfg, training=True,
        canvas_size=int(cfg.model.image_size * CANVAS_SCALE),
        start_batch=position, cuda_device=common.cuda_index(device))
    pin = device.type == "cuda"

    def fetch() -> Dict[str, torch.Tensor]:
        raw = next(it)
        if world > 1:          # every rank reads the global batch
            raw = mesh.shard_batch({k: raw[k] for k in BATCH_KEYS
                                    if k in raw}, rank, world)
        out = {k: torch.from_numpy(np.ascontiguousarray(raw[k]))
               for k in BATCH_KEYS if k in raw}
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
                cfg.data, shard=(rank, world))
            state, metrics = step_fn(state, batch, position_generator(
                device, args.seed, STEP_STREAM, position,
                rank if world > 1 else None))
            step += 1   # counted here: reading metrics would synchronise
            if not lead:
                continue
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
        if logger is not None:
            logger.close()
    if lead:
        print(f"done: {state.step} steps -> {args.model_dir}")
    return state


def graft_pretrained(state: TrainState, path: str, stage_sizes) -> None:
    """Graft a pretrained ResNet-50 (``utils.pretrained``) into the state's
    backbone in place, and re-seed the EMA shadow from the grafted weights
    so that it tracks them, not the discarded init."""
    load_pretrained_backbone(state.model, path, stage_sizes=stage_sizes)
    if state.ema_params is not None:
        state.ema_params = {n: p.detach().clone()
                            for n, p in state.model.named_parameters()}


def periodic_eval(args, cfg, state: TrainState, eval_model, eval_fn,
                  logger: MetricsLogger, step: int):
    """mAP of the weights ``eval_variables`` picks (the EMA shadow when the
    state keeps one) in a second model, built at the first call and reused
    with its eval function; logs ``eval_mAP``. Returns both for reuse. (In
    a data-parallel run rank 0 evaluates alone.)"""
    device = next(state.model.parameters()).device
    if eval_model is None:
        eval_model = build_model(cfg.model, device, seed=None,
                                 dtype=common.DTYPES[args.dtype])
        eval_fn = build_eval_fn(eval_model, cfg, device)
    eval_model.load_state_dict(common.eval_variables(state))
    prepare_for_inference(eval_model)       # the load dropped the operands
    res = run_eval(eval_model, cfg, common.batch_iterator(
        args, cfg, training=False, cuda_device=common.cuda_index(device)),
        args.eval_batches, eval_fn=eval_fn)
    logger.log(step, {"eval_mAP": res["mAP"]})
    return eval_model, eval_fn


if __name__ == "__main__":
    main()
