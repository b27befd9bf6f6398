"""Shared detection post-processing: decode -> clip -> batched NMS.

The port of ``x_detector_tpu/models/detector.py``: exact per-class NMS, or
MaxpoolNMS with ``fast_mode``.
"""

from __future__ import annotations

import torch

from x_detector_tpu_torch.ops import boxes as box_ops
from x_detector_tpu_torch.ops.maxpool_nms import ssd_maxpool_scores
from x_detector_tpu_torch.ops.nms import (MulticlassNMSResult,
                                          batched_multiclass_nms,
                                          topk_stable)


def postprocess_detections(box_codes: torch.Tensor,
                           class_logits: torch.Tensor,
                           anchors: torch.Tensor, max_output: int = 200,
                           iou_threshold: float = 0.45,
                           score_threshold: float = 0.01,
                           per_class_topk: int = 100,
                           fast_mode: bool = False, ssd_anchor_cfg=None,
                           image_size: int = 0,
                           approx_prefilter: bool = False
                           ) -> MulticlassNMSResult:
    """Softmax over classes, drop the background, decode the box codes
    ([B, N, 4] against ``anchors`` [N, 4], or per class [B, N, C, 4]), clip
    to the image, then exact per-class NMS and a global top-``max_output``.

    ``fast_mode`` (``NMSConfig.fast_mode``) replaces the per-class NMS by
    MaxpoolNMS: per-level local-max selection on the score maps
    (``ops/maxpool_nms.py``; ``ssd_anchor_cfg``, the ``SSDAnchorConfig`` of
    the grid at ``image_size``, is required), then one global top-
    ``max_output`` over all N x C (box, class) pairs of an image.
    """
    probs = torch.softmax(class_logits.float(), dim=-1)
    fg_probs = probs[..., 1:]                               # drop background
    if box_codes.dim() == 3:
        decoded = box_ops.decode(box_codes.float(), anchors[None, :, :])
    else:
        decoded = box_ops.decode(box_codes.float(), anchors[None, :, None, :])
    decoded = box_ops.clip_boxes(decoded)
    if not fast_mode:
        return batched_multiclass_nms(
            decoded, fg_probs, max_output=max_output,
            iou_threshold=iou_threshold, score_threshold=score_threshold,
            per_class_topk=per_class_topk, approx_prefilter=approx_prefilter)
    if ssd_anchor_cfg is None:
        # a silent exact-NMS fallback would report exact-path timings to a
        # caller who asked for the fast path
        raise ValueError("fast_mode=True requires ssd_anchor_cfg (the SSD "
                         "anchor grid geometry drives MaxpoolNMS window "
                         "sizes); got None")
    masked = ssd_maxpool_scores(fg_probs, ssd_anchor_cfg, image_size,
                                iou_threshold)
    b, _, num_classes = masked.shape
    top_s, top_i = topk_stable(masked.reshape(b, -1), max_output)
    if decoded.dim() == 4:                                  # [B, N, C, 4]
        flat = decoded.reshape(b, -1, 4)
        box_i = top_i
    else:
        flat, box_i = decoded, top_i // num_classes
    out_boxes = torch.gather(flat, 1, box_i[..., None].expand(-1, -1, 4))
    valid = top_s > score_threshold
    classes = (top_i % num_classes).to(torch.int32) + 1
    return MulticlassNMSResult(
        boxes=torch.where(valid[..., None], out_boxes, 0.0),
        scores=torch.where(valid, top_s, -1.0),
        classes=torch.where(valid, classes, torch.zeros_like(classes)),
        valid=valid)
