"""RPN and SSD anchor grids (numpy; a copy of
``x_detector_tpu/ops/anchors.py``).

Anchors are normalized corner boxes ``[ymin, xmin, ymax, xmax]`` relative to
the square input image, unclipped, as one flat ``[num_anchors, 4]`` float32
array in ``(row, col, anchor)`` order: the order in which the RPN and SSD
heads flatten their NHWC outputs (SSD: level by level, stride 8 first).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def _grid_centers(feat_h: int, feat_w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Normalized cell-center coordinates of a feat_h x feat_w grid."""
    cy = (np.arange(feat_h, dtype=np.float32) + 0.5) / feat_h
    cx = (np.arange(feat_w, dtype=np.float32) + 0.5) / feat_w
    return np.meshgrid(cy, cx, indexing="ij")


def rpn_anchors(image_size: int, config) -> np.ndarray:
    """Dense RPN anchor grid, [H/stride * W/stride * A, 4] normalized corners.

    Scales are in pixels of the input image and are normalized by
    ``image_size``. The grid side uses ceil to match SAME-padded stride-2
    convolution output sizes.
    """
    feat = -(-image_size // config.stride)
    cy, cx = _grid_centers(feat, feat)           # [F, F] each
    shapes = []
    for s in config.scales:
        for r in config.ratios:
            shapes.append((s * math.sqrt(r) / image_size,
                           s / math.sqrt(r) / image_size))
    hw = np.array(shapes, dtype=np.float32)      # [A, 2]
    cy = cy[..., None]                           # [F, F, 1]
    cx = cx[..., None]
    h = hw[None, None, :, 0]
    w = hw[None, None, :, 1]
    boxes = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], axis=-1)
    return boxes.reshape(-1, 4)                  # [F*F*A, 4]


def ssd_anchors(image_size: int, config) -> np.ndarray:
    """Multi-layer SSD anchors, flat [sum_l F_l^2 * A, 4] normalized corners.

    Layer k gets scale ``s_k`` linearly interpolated from scale_min to
    scale_max; each cell emits one anchor per ratio at scale s_k plus an
    extra ratio-1 anchor at sqrt(s_k * s_{k+1}) (SSD paper section 2.2).
    """
    n = config.num_layers
    scales = [config.scale_min
              + (config.scale_max - config.scale_min) * k / max(n - 1, 1)
              for k in range(n)]
    scales.append(min(1.0, 2.0 * scales[-1] - (scales[-2] if n > 1
                                               else 0.0)))
    all_boxes = []
    for k, stride in enumerate(config.strides):
        feat = int(math.ceil(image_size / stride))
        cy, cx = _grid_centers(feat, feat)
        shapes = [(scales[k] * math.sqrt(r), scales[k] / math.sqrt(r))
                  for r in config.ratios]
        s_extra = math.sqrt(scales[k] * scales[k + 1])
        shapes.append((s_extra, s_extra))
        hw = np.array(shapes, dtype=np.float32)  # [A, 2]
        cyk = cy[..., None]
        cxk = cx[..., None]
        h = hw[None, None, :, 0]
        w = hw[None, None, :, 1]
        boxes = np.stack(
            [cyk - h / 2, cxk - w / 2, cyk + h / 2, cxk + w / 2], axis=-1)
        all_boxes.append(boxes.reshape(-1, 4))
    return np.concatenate(all_boxes, axis=0)


def ssd_layer_anchor_counts(image_size: int, config) -> List[int]:
    """Anchors per layer, in the order of :func:`ssd_anchors`."""
    return [int(math.ceil(image_size / s)) ** 2 * config.anchors_per_cell
            for s in config.strides]
