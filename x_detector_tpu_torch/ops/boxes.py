"""Box geometry on tensors: area, IoU, IoA, clipping, encode/decode, flip.

Corner format ``[ymin, xmin, ymax, xmax]`` throughout, normalized or in
pixels. A row of zeros is a valid degenerate box (area 0): it has IoU 0
with everything.
"""

from __future__ import annotations

import torch

from x_detector_tpu_torch.config import PRIOR_SCALING

EPS = 1e-8


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of corner boxes, clamped at 0. [..., 4] -> [...]."""
    return (boxes[..., 2:] - boxes[..., :2]).clamp_min(0.0).prod(dim=-1)


def intersection(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection areas. [..., A, 4] x [..., B, 4] -> [..., A, B].
    (Height and width go through one op each as a pair: fewer launches.)"""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    hw = (torch.minimum(a[..., 2:], b[..., 2:])
          - torch.maximum(a[..., :2], b[..., :2]))
    return hw.clamp_min(0.0).prod(dim=-1)


def iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. [..., A, 4] x [..., B, 4] -> [..., A, B]; leading dims
    broadcast, so a batch of box sets runs in one call."""
    inter = intersection(boxes_a, boxes_b)
    union = area(boxes_a)[..., :, None] + area(boxes_b)[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp_min(EPS),
                       torch.zeros_like(inter))


def ioa(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Intersection over the area of each b: the fraction of each b that
    each a covers. [..., A, 4] x [..., B, 4] -> [..., A, B]."""
    inter = intersection(boxes_a, boxes_b)
    area_b = area(boxes_b)[..., None, :]
    return torch.where(area_b > 0, inter / area_b.clamp_min(EPS),
                       torch.zeros_like(inter))


def clip_boxes(boxes: torch.Tensor, bound: float = 1.0) -> torch.Tensor:
    """Clip corner boxes into [0, bound] on both axes (every caller clips
    normalised boxes into the unit square), the bound a scalar: a bounds
    tensor made from a list on the card is a blocking copy, a host sync."""
    return boxes.clamp(0.0, bound)


def _center(boxes: torch.Tensor):
    """Corner boxes -> (cy, cx, h, w), each [...]."""
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    return boxes[..., 0] + h / 2.0, boxes[..., 1] + w / 2.0, h, w


def encode(boxes: torch.Tensor, anchors: torch.Tensor,
           prior_scaling=PRIOR_SCALING) -> torch.Tensor:
    """Corner gt boxes relative to corner anchors -> regression codes
    (t_cy, t_cx, t_h, t_w), the inverse of :func:`decode`. Broadcasts over
    leading dims."""
    g_cy, g_cx, g_h, g_w = _center(boxes)
    a_cy, a_cx, a_h, a_w = _center(anchors)
    a_h = a_h.clamp_min(EPS)
    a_w = a_w.clamp_min(EPS)
    return torch.stack([
        (g_cy - a_cy) / a_h / prior_scaling[0],
        (g_cx - a_cx) / a_w / prior_scaling[1],
        torch.log(g_h.clamp_min(EPS) / a_h) / prior_scaling[2],
        torch.log(g_w.clamp_min(EPS) / a_w) / prior_scaling[3]], dim=-1)


def decode(codes: torch.Tensor, anchors: torch.Tensor,
           prior_scaling=PRIOR_SCALING) -> torch.Tensor:
    """Regression codes -> corner boxes (inverse of the SSD/Faster-R-CNN
    encode). Log-space codes are clamped to +-10 so exp() cannot overflow."""
    a_cy, a_cx, a_h, a_w = _center(anchors)
    cy = codes[..., 0] * prior_scaling[0] * a_h + a_cy
    cx = codes[..., 1] * prior_scaling[1] * a_w + a_cx
    h = torch.exp((codes[..., 2] * prior_scaling[2]).clamp(-10.0, 10.0)) * a_h
    w = torch.exp((codes[..., 3] * prior_scaling[3]).clamp(-10.0, 10.0)) * a_w
    return torch.stack(
        [cy - h / 2.0, cx - w / 2.0, cy + h / 2.0, cx + w / 2.0], dim=-1)


def flip_boxes_horizontal(boxes: torch.Tensor,
                          xmax: float = 1.0) -> torch.Tensor:
    """Mirror corner boxes around the vertical axis of [0, xmax]."""
    return torch.stack([boxes[..., 0], xmax - boxes[..., 3], boxes[..., 2],
                        xmax - boxes[..., 1]], dim=-1)
