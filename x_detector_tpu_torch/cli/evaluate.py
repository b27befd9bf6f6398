"""Evaluation CLI: restore the newest checkpoint, run the detector over the
synthetic eval stream and report VOC07 mAP (11-point by default).

The port of ``x_detector_tpu/cli/evaluate.py``. Example (on the card)::

  python -m x_detector_tpu_torch.cli.evaluate --preset ssd_resnet50 \\
      --model-dir DIR --num-batches 50
"""

from __future__ import annotations

import argparse
from typing import Callable, Iterator, Optional

import torch

from x_detector_tpu_torch.cli import common
from x_detector_tpu_torch.data.augment import preprocess_for_eval
from x_detector_tpu_torch.inference import Model, build_eval_fn
from x_detector_tpu_torch.train.checkpoint import CheckpointManager
from x_detector_tpu_torch.train.trainer import create_model_and_state
from x_detector_tpu_torch.utils.metrics_voc import VOCEvaluator


def run_eval(model: Model, cfg, batch_iter: Iterator, num_batches: int,
             eval_fn: Optional[Callable] = None,
             use_07_metric: bool = True) -> dict:
    """mAP of ``model`` (in eval mode, with the weights to evaluate) over up
    to ``num_batches`` numpy batches of ``batch_iter``, whitened on the
    model's device by ``preprocess_for_eval``. ``eval_fn`` is a
    ``build_eval_fn`` of ``model`` to reuse. Returns the VOCEvaluator's
    result."""
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
        images = torch.from_numpy(raw["image"]).to(device)
        boxes, scores, classes, valid = (t.cpu().numpy() for t in eval_fn(
            preprocess_for_eval(images, cfg.data)))
        for i in range(images.shape[0]):
            image_id = f"b{bi}_i{i}"
            m = raw["gt_mask"][i]
            diff = raw["difficult"][i][m] if "difficult" in raw else None
            ev.add_ground_truth(image_id, raw["gt_boxes"][i][m],
                                raw["gt_labels"][i][m], diff)
            v = valid[i]
            ev.add_detections(image_id, boxes[i][v], scores[i][v],
                              classes[i][v])
    return ev.evaluate()


def main(argv=None) -> dict:
    """Returns ``run_eval``'s result with the restored ``step`` and whether
    the EMA shadow was evaluated (``ema``)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_common_args(p)
    p.add_argument("--num-batches", type=int, default=50,
                   help="eval batches of the synthetic stream")
    p.add_argument("--use-07-metric", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="11-point VOC07 AP (--no-use-07-metric selects "
                        "continuous AP)")
    p.add_argument("--dtype", default="bfloat16", choices=sorted(
        common.DTYPES))
    p.add_argument("--num-devices", type=int, default=0,
                   help="data-parallel eval over N devices: not ported")
    args = p.parse_args(argv)
    if args.num_devices > 1:
        raise NotImplementedError(
            "--num-devices > 1: data-parallel evaluation is not ported yet "
            "(ROADMAP.md, Queue A item 5)")
    device = common.resolve_device(args)
    cfg = common.resolve_config(args)
    state = create_model_and_state(cfg, device, seed=args.seed,
                                   dtype=common.DTYPES[args.dtype])
    ckpt = CheckpointManager(f"{args.model_dir}/ckpt")
    if ckpt.latest_step() is not None:
        state, _ = ckpt.restore(state)
        print(f"restored checkpoint at step {state.step}")
    else:
        print("WARNING: no checkpoint found, evaluating random init")
    ckpt.close()
    use_ema = (state.ema_params is not None if args.use_ema is None
               else args.use_ema)
    state.model.load_state_dict(common.eval_variables(state, use_ema))
    if use_ema:
        print("evaluating EMA shadow weights")
    model = state.model.eval()
    res = run_eval(model, cfg, common.batch_iterator(args, cfg),
                   args.num_batches, use_07_metric=args.use_07_metric)
    print(f"mAP: {res['mAP']:.4f}")
    for cls, ap in sorted(res["per_class_ap"].items()):
        print(f"  class {cls:2d}: AP {ap:.4f}")
    return dict(res, step=state.step, ema=use_ema)


if __name__ == "__main__":
    main()
