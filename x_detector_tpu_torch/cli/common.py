"""Shared CLI plumbing: flags, preset resolution, the device, the weights
to evaluate, the data streams (TFRecord shards or synthetic).

The port of ``x_detector_tpu/cli/common.py``, with the same flags and one
more, ``--device`` (``cuda`` by default; ``cpu`` only when asked).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
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
                   help="directory of VOC TFRecord shards (cli.convert_voc "
                        "writes them; default: synthetic data)")
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


def cuda_index(device: torch.device) -> int:
    """The index of a CUDA device (the current one for a bare ``cuda``);
    0 for another device."""
    if device.type != "cuda":
        return 0
    return torch.cuda.current_device() if device.index is None else (
        device.index)


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


def restored_model(args, cfg: ExperimentConfig, device, dtype: torch.dtype,
                   what: str) -> torch.nn.Module:
    """The model of ``cfg`` on ``device`` with the newest checkpoint of
    ``--model-dir`` (its EMA shadow when it carries one, or as
    ``--use-ema`` says), in eval mode; random weights from ``--seed`` when
    there is no checkpoint. ``what`` names the use in the messages."""
    from x_detector_tpu_torch.train.checkpoint import CheckpointManager
    from x_detector_tpu_torch.train.trainer import create_model_and_state
    state = create_model_and_state(cfg, device, seed=args.seed, dtype=dtype)
    ckpt = CheckpointManager(f"{args.model_dir}/ckpt")
    if ckpt.latest_step() is not None:
        state, _ = ckpt.restore(state)
        print(f"{what} checkpoint at step {state.step}")
    else:
        print(f"WARNING: no checkpoint found, {what} random init")
    ckpt.close()
    use_ema = (state.ema_params is not None if args.use_ema is None
               else args.use_ema)
    state.model.load_state_dict(eval_variables(state, use_ema))
    if use_ema:
        print(f"{what} EMA shadow weights")
    return state.model.eval()


def batch_iterator(args, cfg: ExperimentConfig, training: bool,
                   canvas_size: Optional[int] = None, start_batch: int = 0,
                   cuda_device: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Numpy batches of ``cfg.train.batch_size`` canvases of
    ``canvas_size`` (default: the model's input size), resumed at batch
    ``start_batch`` in O(1): from the TFRecord shards of ``--data-dir``
    through the native loader (shuffled and repeating when ``training``,
    in order and once otherwise; nvJPEG, where it decodes, on
    ``cuda_device``), else endless synthetic batches from ``--seed``."""
    canvas = canvas_size or cfg.model.image_size
    if args.data_dir:
        from x_detector_tpu_torch.data.native_loader import NativeLoader
        shards = sorted(glob.glob(os.path.join(args.data_dir, "*.tfrecord")))
        if not shards:
            raise FileNotFoundError(f"no .tfrecord shards under "
                                    f"{args.data_dir}")
        return NativeLoader(shards, canvas_size=canvas,
                            max_gt=cfg.data.max_gt_boxes,
                            batch_size=cfg.train.batch_size,
                            shuffle=training, seed=args.seed,
                            repeat=training, letterbox=cfg.data.letterbox,
                            start_example=start_batch * cfg.train.batch_size,
                            cuda_device=cuda_device)
    it = synthetic_batches(args.seed, cfg.train.batch_size, canvas,
                           cfg.data.max_gt_boxes)
    for _ in range(start_batch):  # synthetic generator: cheap skip
        next(it)
    return it
