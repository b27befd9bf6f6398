"""Shared detection post-processing: decode -> clip -> batched NMS.

The port of ``x_detector_tpu/models/detector.py`` (exact per-class NMS).
"""

from __future__ import annotations

import torch

from x_detector_tpu_torch.ops import boxes as box_ops
from x_detector_tpu_torch.ops.nms import (MulticlassNMSResult,
                                          batched_multiclass_nms)


def postprocess_detections(box_codes: torch.Tensor,
                           class_logits: torch.Tensor,
                           anchors: torch.Tensor, max_output: int = 200,
                           iou_threshold: float = 0.45,
                           score_threshold: float = 0.01,
                           per_class_topk: int = 100,
                           fast_mode: bool = False,
                           approx_prefilter: bool = False
                           ) -> MulticlassNMSResult:
    """Softmax over classes, drop the background, decode the box codes
    ([B, N, 4] against ``anchors`` [N, 4], or per class [B, N, C, 4]), clip
    to the image, then exact per-class NMS and a global top-``max_output``.
    """
    if fast_mode:
        raise NotImplementedError(
            "NMSConfig.fast_mode (MaxpoolNMS) is not ported yet; set "
            "fast_mode=False for the exact per-class NMS")
    probs = torch.softmax(class_logits.float(), dim=-1)
    fg_probs = probs[..., 1:]                               # drop background
    if box_codes.dim() == 3:
        decoded = box_ops.decode(box_codes.float(), anchors[None, :, :])
    else:
        decoded = box_ops.decode(box_codes.float(), anchors[None, :, None, :])
    return batched_multiclass_nms(
        box_ops.clip_boxes(decoded), fg_probs, max_output=max_output,
        iou_threshold=iou_threshold, score_threshold=score_threshold,
        per_class_topk=per_class_topk, approx_prefilter=approx_prefilter)
