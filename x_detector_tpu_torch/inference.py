"""Inference entry point: preprocessed images -> final detections.

The port of ``build_eval_fn`` from ``x_detector_tpu/cli/evaluate.py``
(Light-Head branch). A caller builds the model, loads or initialises its
weights, then::

    model = build_model(cfg.model, device, seed=0)
    detect = build_eval_fn(model, cfg, device)
    boxes, scores, classes, valid = detect(preprocess_for_eval(images_u8,
                                                               cfg.data))
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from x_detector_tpu_torch.models.layers import init_flax_like
from x_detector_tpu_torch.models.lighthead import (LightHeadRCNN,
                                                   lighthead_postprocess)

Detections = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def build_model(model_cfg, device, seed: Optional[int] = 0,
                dtype: torch.dtype = torch.bfloat16) -> LightHeadRCNN:
    """A Light-Head model on ``device`` in eval mode. With an integer
    ``seed`` its weights are flax's default initialisation drawn from a CPU
    ``torch.Generator`` seeded with it; ``seed=None`` leaves them to be
    loaded."""
    if model_cfg.family != "lighthead":
        raise NotImplementedError(f"family {model_cfg.family!r} is ported in "
                                  "a later PR")
    model = LightHeadRCNN(model_cfg, dtype=dtype)
    if seed is not None:
        init_flax_like(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def build_eval_fn(model: LightHeadRCNN, cfg, device
                  ) -> Callable[[torch.Tensor], Detections]:
    """images [B, S, S, 3] (preprocessed, NHWC) -> (boxes [B, K, 4],
    scores [B, K], classes [B, K] int32, valid [B, K] bool) on ``device``,
    with K = ``cfg.model.nms.max_output``."""
    device = torch.device(device)
    if cfg.model.family != "lighthead":
        raise NotImplementedError(f"family {cfg.model.family!r} is ported "
                                  "in a later PR")
    param_device = next(model.parameters()).device
    if param_device.type != device.type or (
            device.index is not None and param_device != device):
        raise ValueError(f"model is on {param_device}, not on {device}")

    def detect(images: torch.Tensor) -> Detections:
        with torch.inference_mode():
            out = model(images.to(device, non_blocking=True))
            det = lighthead_postprocess(out, cfg.model)
        return det.boxes, det.scores, det.classes, det.valid

    return detect
