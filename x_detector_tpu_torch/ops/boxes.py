"""Box geometry on tensors: area, IoU, clipping, decode.

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


def clip_boxes(boxes: torch.Tensor, ymax: float = 1.0,
               xmax: float = 1.0) -> torch.Tensor:
    """Clip corner boxes into [0, ymax] x [0, xmax]."""
    hi = boxes.new_tensor([ymax, xmax, ymax, xmax])
    return torch.minimum(boxes.clamp_min(0.0), hi)


def decode(codes: torch.Tensor, anchors: torch.Tensor,
           prior_scaling=PRIOR_SCALING) -> torch.Tensor:
    """Regression codes -> corner boxes (inverse of the SSD/Faster-R-CNN
    encode). Log-space codes are clamped to +-10 so exp() cannot overflow."""
    a_h = anchors[..., 2] - anchors[..., 0]
    a_w = anchors[..., 3] - anchors[..., 1]
    a_cy = anchors[..., 0] + a_h / 2.0
    a_cx = anchors[..., 1] + a_w / 2.0
    cy = codes[..., 0] * prior_scaling[0] * a_h + a_cy
    cx = codes[..., 1] * prior_scaling[1] * a_w + a_cx
    h = torch.exp((codes[..., 2] * prior_scaling[2]).clamp(-10.0, 10.0)) * a_h
    w = torch.exp((codes[..., 3] * prior_scaling[3]).clamp(-10.0, 10.0)) * a_w
    return torch.stack(
        [cy - h / 2.0, cx - w / 2.0, cy + h / 2.0, cx + w / 2.0], dim=-1)
