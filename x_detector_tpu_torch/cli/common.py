"""Shared CLI plumbing: flags, preset resolution, the device, the weights
to evaluate, the data stream.

The port of ``x_detector_tpu/cli/common.py``, with the same flags and one
more, ``--device`` (``cuda`` by default; ``cpu`` only when asked).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from x_detector_tpu_torch.config import PRESETS, ExperimentConfig
from x_detector_tpu_torch.data.synthetic import synthetic_batches
from x_detector_tpu_torch.train.train_state import TrainState

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", default="lighthead_resnet50",
                   choices=sorted(PRESETS), help="experiment preset")
    p.add_argument("--image-size", type=int, default=None,
                   help="override the preset input size")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--data-dir", default=None,
                   help="directory of VOC TFRecord shards (not read by the "
                        "port yet; default: synthetic data)")
    p.add_argument("--model-dir",
                   default=os.path.join(tempfile.gettempdir(), "xdet_model"),
                   help="checkpoint/metrics directory")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--letterbox", default=None,
                   action=argparse.BooleanOptionalAction,
                   help="aspect-preserving canvas placement (default: the "
                        "preset's choice — on for lighthead presets; "
                        "--no-letterbox forces square squash)")
    p.add_argument("--use-ema", default=None,
                   action=argparse.BooleanOptionalAction,
                   help="evaluate the EMA shadow weights (default: auto — "
                        "use EMA whenever the checkpoint carries one; "
                        "--no-use-ema forces the raw params)")
    p.add_argument("--backbone-stages", default=None,
                   help="comma list overriding backbone depth (ResNet stage "
                        "sizes / Xception units per stage), e.g. 1,1,1,1 — "
                        "capacity sweeps and CI-sized smoke runs")
    p.add_argument("--backbone-widths", default=None,
                   help="comma list overriding backbone channel widths, "
                        "e.g. 16,32,48,64")
    p.add_argument("--grad-accum", type=int, default=None,
                   help="split each train batch into N sequential "
                        "microbatches with one optimizer update; batch size "
                        "must be divisible by N")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda; a run that "
                        "finds no card fails rather than use the CPU)")


def resolve_device(args) -> torch.device:
    """``--device`` as a torch device; a CUDA device with no card present
    raises."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "present (pass --device cpu to run on the CPU)")
    return device


def resolve_config(args) -> ExperimentConfig:
    cfg = PRESETS[args.preset](
        image_size=args.image_size) if args.image_size else \
        PRESETS[args.preset]()
    tcfg = {}
    if args.batch_size:
        tcfg["batch_size"] = args.batch_size
    if getattr(args, "grad_accum", None):
        tcfg["grad_accum_steps"] = args.grad_accum
    if tcfg:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **tcfg))
    if getattr(args, "letterbox", None) is not None:
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data,
                                          letterbox=args.letterbox))
    mcfg = {}
    if getattr(args, "backbone_stages", None):
        mcfg["backbone_stages"] = tuple(
            int(v) for v in args.backbone_stages.split(","))
    if getattr(args, "backbone_widths", None):
        mcfg["backbone_widths"] = tuple(
            int(v) for v in args.backbone_widths.split(","))
    if mcfg:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **mcfg))
    return cfg


def eval_variables(state: TrainState, use_ema: Optional[bool] = None
                   ) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` to evaluate, export or serve.

    ``use_ema=None`` (auto) puts the EMA shadow in place of the parameters
    whenever the state carries one: the averaged weights are the ones
    served. ``True`` requires a shadow; ``False`` keeps the raw parameters.
    The BatchNorm running stats are the model's either way (the shadow
    covers parameters only)."""
    if use_ema is None:
        use_ema = state.ema_params is not None
    variables = dict(state.model.state_dict())
    if use_ema:
        if state.ema_params is None:
            raise ValueError("--use-ema requested but the checkpoint carries "
                             "no EMA shadow (train with ema_decay > 0)")
        variables.update(state.ema_params)
    return variables


def require_synthetic(args) -> None:
    """``--data-dir`` raises: the record readers are not ported."""
    if args.data_dir:
        raise NotImplementedError(
            "--data-dir: the TFRecord / VOC / native-loader data sources "
            "are not ported yet (ROADMAP.md, Queue A item 4a); omit it to "
            "train and evaluate on synthetic data")


def batch_iterator(args, cfg: ExperimentConfig,
                   canvas_size: Optional[int] = None, start_batch: int = 0
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless synthetic numpy batches of ``canvas_size`` (default: the
    model's input size) from ``--seed``, resumed at batch ``start_batch``
    (``require_synthetic`` first; the JAX package's ``training`` switch
    between shuffled and ordered record streams has nothing to switch
    here)."""
    require_synthetic(args)
    it = synthetic_batches(args.seed, cfg.train.batch_size,
                           canvas_size or cfg.model.image_size,
                           cfg.data.max_gt_boxes)
    for _ in range(start_batch):  # synthetic generator: cheap skip
        next(it)
    return it
