"""Inference entry point: preprocessed images -> final detections.

The port of ``build_eval_fn`` from ``x_detector_tpu/cli/evaluate.py``, for
both families: Light-Head R-CNN (``family="lighthead"``) and the SSD /
X-Det single-shot detectors (``family="ssd"``). A caller builds the model,
loads or initialises its weights, then::

    model = build_model(cfg.model, device, seed=0)
    detect = build_eval_fn(model, cfg, device)
    boxes, scores, classes, valid = detect(preprocess_for_eval(images_u8,
                                                               cfg.data))
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from x_detector_tpu_torch.models.detector import postprocess_detections
from x_detector_tpu_torch.models.layers import init_flax_like
from x_detector_tpu_torch.models.lighthead import (LightHeadRCNN,
                                                   lighthead_postprocess)
from x_detector_tpu_torch.models.ssd import SSDModel
from x_detector_tpu_torch.ops.nms import MulticlassNMSResult

Detections = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
Model = Union[LightHeadRCNN, SSDModel]
FAMILIES = {"lighthead": LightHeadRCNN, "ssd": SSDModel}


def _model_class(family: str):
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; the port has "
                         f"{sorted(FAMILIES)}")
    return FAMILIES[family]


def build_model(model_cfg, device, seed: Optional[int] = 0,
                dtype: torch.dtype = torch.bfloat16) -> Model:
    """The config's model (Light-Head or SSD) on ``device`` in eval mode.
    With an integer ``seed`` its weights are flax's default initialisation
    drawn from a CPU ``torch.Generator`` seeded with it; ``seed=None``
    leaves them to be loaded. With ``backbone_quant`` set its backbone convs
    are ``QuantConv`` (``quant.py``: calibrate, then serve in int8)."""
    model = _model_class(model_cfg.family)(model_cfg, dtype=dtype)
    if seed is not None:
        init_flax_like(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def build_eval_fn(model: Model, cfg, device
                  ) -> Callable[[torch.Tensor], Detections]:
    """images [B, S, S, 3] (preprocessed, NHWC) -> (boxes [B, K, 4],
    scores [B, K], classes [B, K] int32, valid [B, K] bool) on ``device``,
    with K = ``cfg.model.nms.max_output``. An SSD model decodes against its
    ``anchors`` buffer, which moved to the device with it."""
    device = torch.device(device)
    want = _model_class(cfg.model.family)
    if not isinstance(model, want):
        raise TypeError(f"family {cfg.model.family!r} needs a "
                        f"{want.__name__}, got {type(model).__name__}")
    param_device = next(model.parameters()).device
    if param_device.type != device.type or (
            device.index is not None and param_device != device):
        raise ValueError(f"model is on {param_device}, not on {device}")

    def detect(images: torch.Tensor) -> Detections:
        with torch.inference_mode():
            out = model(images.to(device, non_blocking=True))
            det = postprocess(model, out, cfg.model)
        return det.boxes, det.scores, det.classes, det.valid

    return detect


def postprocess(model: Model, out, model_cfg) -> MulticlassNMSResult:
    """The family's decode and per-class NMS of ``model``'s outputs."""
    if not isinstance(model, SSDModel):
        return lighthead_postprocess(out, model_cfg)
    cls_logits, box_codes = out
    ncfg = model_cfg.nms
    return postprocess_detections(
        box_codes, cls_logits, model.anchors, max_output=ncfg.max_output,
        iou_threshold=ncfg.iou_threshold,
        score_threshold=ncfg.score_threshold, fast_mode=ncfg.fast_mode,
        approx_prefilter=ncfg.approx_prefilter)
