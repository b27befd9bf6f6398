"""Inference entry point: preprocessed images -> final detections.

The port of ``build_eval_fn`` from ``x_detector_tpu/cli/evaluate.py``, for
both families: Light-Head R-CNN (``family="lighthead"``) and the SSD /
X-Det single-shot detectors (``family="ssd"``). A caller builds the model,
loads or initialises its weights, then::

    model = build_model(cfg.model, device, seed=0)
    detect = build_eval_fn(model, cfg, device)
    boxes, scores, classes, valid = detect(preprocess_for_eval(images_u8,
                                                               cfg.data))

:class:`ServingModule` is the same function as one module, the graph that
``cli/export.py`` exports (the JAX package's ``serving_fn``), with the
preprocessing and the letterbox unscaling inside on request.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
from torch import nn

from x_detector_tpu_torch.data.augment import preprocess_for_eval
from x_detector_tpu_torch.models.detector import postprocess_detections
from x_detector_tpu_torch.models.layers import (init_flax_like,
                                                prepare_for_inference)
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
    ``anchors`` buffer, which moved to the device with it. ``model`` must
    be in eval mode: its kernel operands are prepared here
    (``models.layers.prepare_for_inference``)."""
    device = torch.device(device)
    want = _model_class(cfg.model.family)
    if not isinstance(model, want):
        raise TypeError(f"family {cfg.model.family!r} needs a "
                        f"{want.__name__}, got {type(model).__name__}")
    param_device = next(model.parameters()).device
    if param_device.type != device.type or (
            device.index is not None and param_device != device):
        raise ValueError(f"model is on {param_device}, not on {device}")
    prepare_for_inference(model)

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


def unscale_boxes(boxes: torch.Tensor, box_scale: torch.Tensor
                  ) -> torch.Tensor:
    """Boxes on a letterboxed canvas [B, K, 4] -> normalized corners of the
    original images, ``clip(boxes / max(s, 1e-6), 0, 1)`` with ``s`` the
    content fraction [B, 2] = [fy, fx] of each canvas."""
    s = box_scale[:, None, [0, 1, 0, 1]]
    return torch.clamp(boxes / torch.clamp_min(s, 1e-6), 0.0, 1.0)


class ServingModule(nn.Module):
    """images -> (boxes, scores, classes, valid): the JAX package's export
    ``serving_fn`` (``x_detector_tpu/cli/export.py:196``) over ``model`` (in
    eval mode, prepared), in three variants:

      * pre-whitened images [B, S, S, 3] float32 (``raw_rgb=False``);
      * raw [0, 255] RGB at the model's size, whitened inside by
        ``preprocess_for_eval`` (``raw_rgb=True``);
      * with ``raw_rgb`` and a letterbox config (``cfg.data.letterbox``),
        also ``box_scale`` [B, 2] (``serving.letterbox_batch``), the boxes
        unscaled to the original images (:func:`unscale_boxes`).
    """

    def __init__(self, model: Model, cfg, raw_rgb: bool = False):
        super().__init__()
        self.model, self.cfg, self.raw_rgb = model, cfg, raw_rgb
        self.letterbox = bool(raw_rgb and cfg.data.letterbox)

    def forward(self, images: torch.Tensor,
                box_scale: Optional[torch.Tensor] = None) -> Detections:
        if self.letterbox != (box_scale is not None):
            raise ValueError(f"letterbox={self.letterbox}: box_scale is "
                             f"{'missing' if self.letterbox else 'unused'}")
        if self.raw_rgb:
            images = preprocess_for_eval(images, self.cfg.data)
        det = postprocess(self.model, self.model(images), self.cfg.model)
        boxes = det.boxes
        if self.letterbox:
            boxes = unscale_boxes(boxes, box_scale)
        return boxes, det.scores, det.classes, det.valid
