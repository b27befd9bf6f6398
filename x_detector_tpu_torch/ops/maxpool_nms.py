"""MaxpoolNMS: approximate NMS as local-max selection on anchor score maps.

The port of ``x_detector_tpu/ops/maxpool_nms.py`` (opt-in:
``ProposalConfig.fast_nms`` / ``NMSConfig.fast_mode``). A box survives iff
its score EQUALS the maximum of its own anchor channel within a window
matched to the anchor's footprint: one ``F.max_pool2d`` and a compare, no
sort and no sequential suppression. ``>=`` keeps every member of an
equal-score plateau (the trade for a branch-free compare: a saturated
plateau can flood the top-k that follows).

Two same-channel anchors of side ``S`` px whose centres are ``d`` px apart
have IoU ``(1 - d/S) / (1 + d/S)`` along one axis, so exact NMS at
threshold ``thr`` suppresses within ``d < S (1 - thr) / (1 + thr)``; the
window's radius in cells is that over the stride (:func:`_kernel_for`).
Channels (anchor shapes, and classes for SSD) never suppress each other.

Score maps are channel-last, as the anchor generators flatten them
(``[..., F, F, A]``, flat order row, col, anchor): they are permuted to
NCHW for the pool and back. Max pooling pads with -inf, as XLA's "SAME"
``reduce_window`` with a -inf init does, so a padded cell never wins.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def _kernel_for(anchor_px: float, stride: int, iou_threshold: float,
                feat: int) -> int:
    """Odd window side (cells) whose radius matches the NMS threshold:
    r = anchor_px * (1 - thr) / (1 + thr) / stride, k = 2 max(1, round(r))
    + 1, capped at the map (its largest odd side) but never below 3. On
    maps narrower than 3 cells the 3 exceeds the map, and the window then
    covers it whole: one survivor a channel (the global max)."""
    r = anchor_px * (1.0 - iou_threshold) / (1.0 + iou_threshold) / stride
    k = 2 * max(1, int(round(r))) + 1
    return max(3, min(k, feat if feat % 2 == 1 else feat - 1))


def local_max_mask(score_maps: torch.Tensor, kernel: int) -> torch.Tensor:
    """[..., H, W, C] -> bool mask, True where the score equals the
    ``kernel`` x ``kernel`` spatial max of its own channel (stride 1, "SAME":
    ``kernel`` is odd, so the pads are ``kernel // 2`` on every side)."""
    *lead, h, w, c = score_maps.shape
    maps = score_maps.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    pooled = F.max_pool2d(maps, kernel, stride=1, padding=kernel // 2)
    pooled = pooled.permute(0, 2, 3, 1).reshape(score_maps.shape)
    return score_maps >= pooled


def rpn_maxpool_scores(scores: torch.Tensor, cfg, image_size: int,
                       iou_threshold: float = 0.7) -> torch.Tensor:
    """Suppress a flat RPN score vector [..., F*F*A] (``cfg`` an
    ``AnchorConfig``) by per-scale local max: the scores that are not a
    local max of their channel become 0 (the proposal stage's dead score),
    in ``anchors.rpn_anchors``' flat layout."""
    feat = -(-image_size // cfg.stride)
    n_ratios = len(cfg.ratios)
    lead = scores.shape[:-1]
    maps = scores.reshape(*lead, feat, feat, cfg.num_anchors)
    parts = []
    for si, scale in enumerate(cfg.scales):
        k = _kernel_for(scale, cfg.stride, iou_threshold, feat)
        group = maps[..., si * n_ratios:(si + 1) * n_ratios]
        parts.append(torch.where(local_max_mask(group, k), group, 0.0))
    return torch.cat(parts, dim=-1).reshape(*lead,
                                            feat * feat * cfg.num_anchors)


def ssd_layer_kernels(image_size: int, cfg, iou_threshold: float
                      ) -> Tuple[Tuple[int, int], ...]:
    """(feat side, window) a level of the SSD pyramid (``cfg`` an
    ``SSDAnchorConfig``), in ``anchors.ssd_anchors``' level order and scale
    schedule."""
    n = cfg.num_layers
    scales = [cfg.scale_min + (cfg.scale_max - cfg.scale_min) * k
              / max(n - 1, 1) for k in range(n)]
    out = []
    for k, stride in enumerate(cfg.strides):
        feat = int(math.ceil(image_size / stride))
        out.append((feat, _kernel_for(scales[k] * image_size, stride,
                                      iou_threshold, feat)))
    return tuple(out)


def ssd_maxpool_scores(class_scores: torch.Tensor, cfg, image_size: int,
                       iou_threshold: float = 0.45) -> torch.Tensor:
    """Suppress SSD per-class scores [..., N, C] by per-level local max: N
    splits into the pyramid's [F_l, F_l, A] grids, and each (anchor shape,
    class) channel keeps only its local maxima within the level's window
    (the rest become 0)."""
    a_per_cell = cfg.anchors_per_cell
    num_classes = class_scores.shape[-1]
    lead = class_scores.shape[:-2]
    parts = []
    start = 0
    for feat, kernel in ssd_layer_kernels(image_size, cfg, iou_threshold):
        count = feat * feat * a_per_cell
        layer = class_scores[..., start:start + count, :].reshape(
            *lead, feat, feat, a_per_cell * num_classes)
        layer = torch.where(local_max_mask(layer, kernel), layer, 0.0)
        parts.append(layer.reshape(*lead, count, num_classes))
        start += count
    if start != class_scores.shape[-2]:
        raise ValueError(f"pyramid cells {start} != scores "
                         f"{class_scores.shape[-2]}")
    return torch.cat(parts, dim=-2)
