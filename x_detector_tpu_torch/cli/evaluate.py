"""Evaluation CLI: restore the newest checkpoint, run the detector over the
eval split (TFRecord shards or synthetic) and report VOC07 mAP (11-point by
default), on one device or data-parallel over N.

The port of ``x_detector_tpu/cli/evaluate.py``. Example (on the card)::

  python -m x_detector_tpu_torch.cli.evaluate --preset ssd_resnet50 \\
      --model-dir DIR --num-batches 50 [--data-dir SHARDS] [--num-devices N]
"""

from __future__ import annotations

import argparse
from typing import Callable, Iterator, List, Optional

import torch
import torch.distributed as dist

from x_detector_tpu_torch.cli import common
from x_detector_tpu_torch.data.augment import preprocess_for_eval
from x_detector_tpu_torch.inference import Model, build_eval_fn
from x_detector_tpu_torch.parallel import mesh
from x_detector_tpu_torch.train.checkpoint import CheckpointManager
from x_detector_tpu_torch.train.trainer import create_model_and_state
from x_detector_tpu_torch.utils.metrics_voc import VOCEvaluator

SPAWN_TIMEOUT_S = mesh.GROUP_TIMEOUT_S


def _gather_rows(outs, world: int):
    """Every rank's rows of each output, in rank order, on every rank."""
    gathered = []
    for t in outs:
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous())
        gathered.append(torch.cat(parts))
    return gathered


def run_eval(model: Model, cfg, batch_iter: Iterator, num_batches: int,
             eval_fn: Optional[Callable] = None,
             use_07_metric: bool = True, rank: int = 0,
             world: int = 1) -> Optional[dict]:
    """mAP of ``model`` (in eval mode, with the weights to evaluate) over up
    to ``num_batches`` numpy batches of ``batch_iter``, whitened on the
    model's device by ``preprocess_for_eval``. ``eval_fn`` is a
    ``build_eval_fn`` of ``model`` to reuse. Returns the VOCEvaluator's
    result.

    With ``world`` > 1 (a process group, every rank reading the same
    batches) each rank detects on its rows of each batch, zero-padded to a
    multiple of ``world``; the fixed-size detections are gathered and rank 0
    scores them (the other ranks return None)."""
    device = next(model.parameters()).device
    if eval_fn is None:
        eval_fn = build_eval_fn(model, cfg, device)
    ev = VOCEvaluator(num_classes=cfg.model.num_classes - 1,
                      use_07_metric=use_07_metric)
    for bi in range(num_batches):
        try:
            raw = next(batch_iter)
        except StopIteration:
            break
        images = torch.from_numpy(raw["image"])
        n_real = images.shape[0]
        if world > 1:
            pad = -n_real % world
            images = torch.cat([images, images.new_zeros(
                (pad,) + images.shape[1:])])
            images = images[mesh.shard_rows(images.shape[0], rank, world)]
        outs = eval_fn(preprocess_for_eval(images.to(device), cfg.data))
        if world > 1:
            outs = _gather_rows(outs, world)
        if rank:
            continue
        boxes, scores, classes, valid = (t.cpu().numpy() for t in outs)
        for i in range(n_real):
            if "image_id" in raw:
                iid = raw["image_id"][i]
                image_id = iid.decode() if isinstance(iid, bytes) else str(iid)
            else:
                image_id = f"b{bi}_i{i}"
            m = raw["gt_mask"][i]
            diff = raw["difficult"][i][m] if "difficult" in raw else None
            ev.add_ground_truth(image_id, raw["gt_boxes"][i][m],
                                raw["gt_labels"][i][m], diff)
            v = valid[i]
            ev.add_detections(image_id, boxes[i][v], scores[i][v],
                              classes[i][v])
    return None if rank else ev.evaluate()


def parse_args(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_common_args(p)
    p.add_argument("--num-batches", type=int, default=50,
                   help="eval batches (synthetic) / cap (TFRecord shards)")
    p.add_argument("--use-07-metric", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="11-point VOC07 AP (--no-use-07-metric selects "
                        "continuous AP)")
    p.add_argument("--dtype", default="bfloat16", choices=sorted(
        common.DTYPES))
    p.add_argument("--num-devices", type=int, default=0,
                   help="data-parallel eval over N ranks, one device a rank "
                        "(0 or 1: one device)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Returns ``run_eval``'s result with the restored ``step`` and whether
    the EMA shadow was evaluated (``ema``)."""
    args = parse_args(argv)
    device_type = torch.device(args.device).type
    if args.num_devices > 1:
        mesh.require_devices(device_type, args.num_devices)
        return mesh.run_ranks(_evaluate_rank, args.num_devices,
                              mesh.backend_for(device_type),
                              (argv,), timeout_s=SPAWN_TIMEOUT_S)
    return evaluate(args, 0, 1)


def _evaluate_rank(rank: int, world: int, argv: Optional[List[str]]):
    """One rank of ``run_ranks``."""
    return evaluate(parse_args(argv), rank, world)


def evaluate(args, rank: int, world: int) -> Optional[dict]:
    """Restore and evaluate on one rank of ``world``; rank 0 prints and
    returns the result."""
    lead = rank == 0
    device = (mesh.rank_device(torch.device(args.device).type,
                               mesh.local_rank()) if world > 1
              else common.resolve_device(args))
    cfg = common.resolve_config(args)
    state = create_model_and_state(cfg, device, seed=args.seed,
                                   dtype=common.DTYPES[args.dtype])
    ckpt = CheckpointManager(f"{args.model_dir}/ckpt")
    if ckpt.latest_step() is not None:
        state, _ = ckpt.restore(state)
        if lead:
            print(f"restored checkpoint at step {state.step}")
    elif lead:
        print("WARNING: no checkpoint found, evaluating random init")
    ckpt.close()
    use_ema = (state.ema_params is not None if args.use_ema is None
               else args.use_ema)
    state.model.load_state_dict(common.eval_variables(state, use_ema))
    if use_ema and lead:
        print("evaluating EMA shadow weights")
    model = state.model.eval()
    res = run_eval(model, cfg, common.batch_iterator(
        args, cfg, training=False, cuda_device=common.cuda_index(device)),
        args.num_batches, use_07_metric=args.use_07_metric, rank=rank,
        world=world)
    if not lead:
        return None
    print(f"mAP: {res['mAP']:.4f}")
    for cls, ap in sorted(res["per_class_ap"].items()):
        print(f"  class {cls:2d}: AP {ap:.4f}")
    return dict(res, step=state.step, ema=use_ema)


if __name__ == "__main__":
    main()
