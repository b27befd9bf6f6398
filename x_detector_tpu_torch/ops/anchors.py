"""RPN anchor grid (numpy; a copy of ``x_detector_tpu/ops/anchors.py``).

Anchors are normalized corner boxes ``[ymin, xmin, ymax, xmax]`` relative to
the square input image, unclipped, as one flat ``[num_anchors, 4]`` float32
array in ``(row, col, anchor)`` order: the order in which the RPN head
flattens its NHWC outputs.
"""

from __future__ import annotations

import math
from typing import Tuple

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
