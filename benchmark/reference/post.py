"""Plain PyTorch reference of the detectors' non-network stages: anchor
grids, box decoding, the proposal stage, PSROIAlign, exact greedy NMS and
the per-class detection tail.

Frozen from the port's plain code (its ``ops/anchors``, ``ops/boxes``,
``ops/nms``, ``ops/psroi_align.psroi_align_reference``,
``models/lighthead.generate_proposals`` / ``lighthead_postprocess`` and
``models/detector.postprocess_detections``, exact paths only), importing
none of it: the suppression fixpoint is a plain loop here, never an
operator. Corner boxes ``[ymin, xmin, ymax, xmax]`` in [0, 1].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

PRIOR_SCALING = (0.1, 0.1, 0.2, 0.2)
EPS = 1e-8
TILE = 128


class Detections(NamedTuple):
    boxes: torch.Tensor    # [B, K, 4]
    scores: torch.Tensor   # [B, K], -1 on invalid slots
    classes: torch.Tensor  # [B, K] int32, 0 on invalid slots
    valid: torch.Tensor    # [B, K] bool


# ---- anchors ---------------------------------------------------------------

def _centers(n: int):
    c = (np.arange(n, dtype=np.float32) + 0.5) / n
    return np.meshgrid(c, c, indexing="ij")


def _grid(feat: int, hw: np.ndarray) -> np.ndarray:
    cy, cx = _centers(feat)
    cy, cx = cy[..., None], cx[..., None]
    h, w = hw[None, None, :, 0], hw[None, None, :, 1]
    return np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2],
                    axis=-1).reshape(-1, 4)


def rpn_anchors(image_size: int, a: dict) -> np.ndarray:
    feat = -(-image_size // a["stride"])
    hw = np.array([(s * math.sqrt(r) / image_size,
                    s / math.sqrt(r) / image_size)
                   for s in a["scales"] for r in a["ratios"]], np.float32)
    return _grid(feat, hw)


def ssd_anchors(image_size: int, a: dict) -> np.ndarray:
    n = len(a["strides"])
    scales = [a["scale_min"] + (a["scale_max"] - a["scale_min"]) * k
              / max(n - 1, 1) for k in range(n)]
    scales.append(min(1.0, 2.0 * scales[-1] - (scales[-2] if n > 1
                                               else 0.0)))
    out = []
    for k, stride in enumerate(a["strides"]):
        shapes = [(scales[k] * math.sqrt(r), scales[k] / math.sqrt(r))
                  for r in a["ratios"]]
        extra = math.sqrt(scales[k] * scales[k + 1])
        shapes.append((extra, extra))
        out.append(_grid(int(math.ceil(image_size / stride)),
                         np.array(shapes, np.float32)))
    return np.concatenate(out, axis=0)


# ---- boxes -----------------------------------------------------------------

def area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2:] - b[..., :2]).clamp_min(0.0).prod(dim=-1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU, [..., A, 4] x [..., B, 4] -> [..., A, B]."""
    x, y = a[..., :, None, :], b[..., None, :, :]
    hw = (torch.minimum(x[..., 2:], y[..., 2:])
          - torch.maximum(x[..., :2], y[..., :2]))
    inter = hw.clamp_min(0.0).prod(dim=-1)
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp_min(EPS),
                       torch.zeros_like(inter))


def clip(b: torch.Tensor) -> torch.Tensor:
    return torch.minimum(b.clamp_min(0.0), b.new_tensor([1.0] * 4))


def _center(b: torch.Tensor):
    h = b[..., 2] - b[..., 0]
    w = b[..., 3] - b[..., 1]
    return b[..., 0] + h / 2.0, b[..., 1] + w / 2.0, h, w


def decode(codes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    a_cy, a_cx, a_h, a_w = _center(anchors)
    p = PRIOR_SCALING
    cy = codes[..., 0] * p[0] * a_h + a_cy
    cx = codes[..., 1] * p[1] * a_w + a_cx
    h = torch.exp((codes[..., 2] * p[2]).clamp(-10.0, 10.0)) * a_h
    w = torch.exp((codes[..., 3] * p[3]).clamp(-10.0, 10.0)) * a_w
    return torch.stack([cy - h / 2.0, cx - w / 2.0, cy + h / 2.0,
                        cx + w / 2.0], dim=-1)


def encode(boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    g_cy, g_cx, g_h, g_w = _center(boxes)
    a_cy, a_cx, a_h, a_w = _center(anchors)
    a_h, a_w = a_h.clamp_min(EPS), a_w.clamp_min(EPS)
    p = PRIOR_SCALING
    return torch.stack([
        (g_cy - a_cy) / a_h / p[0], (g_cx - a_cx) / a_w / p[1],
        torch.log(g_h.clamp_min(EPS) / a_h) / p[2],
        torch.log(g_w.clamp_min(EPS) / a_w) / p[3]], dim=-1)


# ---- exact greedy NMS --------------------------------------------------------

def topk_stable(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _suppressed(mask: torch.Tensor) -> torch.Tensor:
    """mask [R, T, T] (row j suppresses column t, j < t) -> the greedy
    suppressed flags [R, T]: the fixpoint of S[t] = any_j(~S[j] & m[j, t])
    (flag t is final after t steps)."""
    s = mask.any(dim=1)
    for _ in range(mask.shape[-1]):
        prev, s = s, (mask & ~s[:, :, None]).any(dim=1)
        if torch.equal(s, prev):
            break
    return s


def nms_padded(boxes, scores, max_output, iou_threshold, score_threshold,
               presorted=False):
    """Greedy NMS over rows [R, N, 4] / [R, N] -> (boxes, scores, valid)
    [R, max_output], survivors in descending score, ties to the lower
    index; -1 and zero boxes on empty slots."""
    rows, n = scores.shape
    n_pad = -(-n // TILE) * TILE
    keep = scores > score_threshold
    boxes = torch.where(keep[..., None], boxes, 0.0).float()
    scores = torch.where(keep, scores, -1.0).float()
    if n_pad > n:
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, n_pad - n))
        scores = torch.nn.functional.pad(scores, (0, n_pad - n), value=-1.0)
    if not presorted:
        scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
        boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    tri = torch.ones(TILE, TILE, dtype=torch.bool,
                     device=boxes.device).triu(1)
    for start in range(0, n_pad, TILE):
        tile = boxes[:, start:start + TILE]
        over = iou(tile, boxes[:, :start + TILE]) > iou_threshold
        prev = over[..., :start].any(dim=-1)
        sup = _suppressed(over[..., start:] & tri & ~prev[..., None]) | prev
        boxes[:, start:start + TILE] = torch.where(sup[..., None], 0.0, tile)
    alive = (area(boxes) > 0) & (scores > score_threshold)
    k = min(max_output, n_pad)
    out_s, idx = topk_stable(torch.where(alive, scores, -1.0), k)
    out_b = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    if k < max_output:
        out_b = torch.nn.functional.pad(out_b, (0, 0, 0, max_output - k))
        out_s = torch.nn.functional.pad(out_s, (0, max_output - k),
                                        value=-1.0)
    valid = out_s > score_threshold
    return torch.where(valid[..., None], out_b, 0.0), out_s, valid


def multiclass_nms(boxes, class_scores, max_output, iou_threshold,
                   score_threshold, per_class_topk=100,
                   nms_candidates=256) -> Detections:
    """Per (image, class) row: the best ``nms_candidates`` boxes, greedy
    NMS, ``per_class_topk`` survivors; then each image's best
    ``max_output`` over its classes."""
    b, n, c = class_scores.shape
    rb = boxes[:, :, None, :].expand(b, n, c, 4).permute(0, 2, 1, 3).reshape(
        b * c, n, 4)
    rs = class_scores.permute(0, 2, 1).reshape(b * c, n)
    presorted = n > nms_candidates
    if presorted:
        rs, idx = topk_stable(rs, nms_candidates)
        rb = torch.gather(rb, 1, idx[..., None].expand(-1, -1, 4))
    ob, os_, _ = nms_padded(rb, rs, per_class_topk, iou_threshold,
                            score_threshold, presorted)
    flat_b = ob.reshape(b, c * per_class_topk, 4)
    flat_s = os_.reshape(b, c * per_class_topk)
    ids = torch.arange(1, c + 1, dtype=torch.int32,
                       device=flat_s.device).repeat_interleave(per_class_topk)
    k = min(max_output, flat_s.shape[1])
    top_s, top_i = topk_stable(flat_s, k)
    if k < max_output:
        top_s = torch.nn.functional.pad(top_s, (0, max_output - k),
                                        value=-1.0)
        top_i = torch.nn.functional.pad(top_i, (0, max_output - k))
    valid = top_s > score_threshold
    return Detections(
        torch.gather(flat_b, 1, top_i[..., None].expand(-1, -1, 4)),
        torch.where(valid, top_s, -1.0),
        torch.where(valid, ids[top_i], torch.zeros((), dtype=torch.int32,
                                                   device=valid.device)),
        valid)


# ---- Light-Head stages -------------------------------------------------------

def proposals(rpn_cls, rpn_loc, anchors, cfg: dict, training: bool = False):
    """The exact proposal stage: softmax objectness, decode and clip, the
    min-size filter, the top pre-NMS scores, greedy NMS -> (boxes [B, R, 4],
    scores [B, R], valid [B, R])."""
    pc = cfg["proposals"]
    scores = torch.softmax(rpn_cls, dim=-1)[..., 1]
    boxes = clip(decode(rpn_loc, anchors[None]))
    min_sz = pc["min_size"] / float(cfg["image_size"])
    ok = (((boxes[..., 2] - boxes[..., 0]) >= min_sz)
          & ((boxes[..., 3] - boxes[..., 1]) >= min_sz))
    scores = torch.where(ok, scores, 0.0)
    k_pre = min(pc["pre_nms_topk" if training else "pre_nms_topk_eval"],
                scores.shape[1])
    k_post = pc["post_nms_topk" if training else "post_nms_topk_eval"]
    top_s, top_i = topk_stable(scores, k_pre)
    top_b = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
    return nms_padded(top_b, top_s, k_post, pc["nms_threshold"], 0.0,
                      presorted=True)


def _sample_coords(rois, grid, samples, extent, axis0, axis1):
    lo = rois[..., axis0][..., None, None]
    hi = rois[..., axis1][..., None, None]
    span = (hi - lo) / grid
    cell = torch.arange(grid, dtype=rois.dtype, device=rois.device)[:, None]
    sub = (torch.arange(samples, dtype=rois.dtype, device=rois.device)
           + 0.5) / samples
    return ((lo + (cell + sub) * span) * extent - 0.5).clamp(0.0, extent - 1.0)


def psroi_align(features: torch.Tensor, rois: torch.Tensor, grid: int = 7,
                samples: int = 2) -> torch.Tensor:
    """Position-sensitive RoIAlign: [B, H, W, k*k*C] x [B, R, 4] ->
    [B, R, k, k, C] fp32; bin (i, j) reads channel group i*k + j, S x S
    bilinear samples a bin, averaged. Differentiable in the features."""
    b, h, w, kkc = features.shape
    c = kkc // (grid * grid)
    feat = features.float().reshape(b, h * w * grid * grid, c)
    rois = rois.float()
    ys = _sample_coords(rois, grid, samples, h, 0, 2)
    xs = _sample_coords(rois, grid, samples, w, 1, 3)
    y0, x0 = ys.floor().clamp(0, h - 1), xs.floor().clamp(0, w - 1)
    y1, x1 = (y0 + 1).clamp(0, h - 1), (x0 + 1).clamp(0, w - 1)
    fy = (ys - y0)[:, :, :, :, None, None]
    fx = (xs - x0)[:, :, None, None, :, :]
    ar = torch.arange(grid, device=features.device)
    group = ar[:, None, None, None] * grid + ar[None, None, :, None]
    bidx = torch.arange(b, device=features.device)[:, None, None, None, None,
                                                    None]

    def tap(yi, xi):
        pix = (yi.long()[:, :, :, :, None, None] * w
               + xi.long()[:, :, None, None, :, :])
        return feat[bidx, pix * (grid * grid) + group]

    acc = (((1 - fy) * (1 - fx))[..., None] * tap(y0, x0)
           + ((1 - fy) * fx)[..., None] * tap(y0, x1)
           + (fy * (1 - fx))[..., None] * tap(y1, x0)
           + (fy * fx)[..., None] * tap(y1, x1))
    return acc.mean(dim=(3, 5))


def lighthead_detections(roi_cls, roi_box, props, prop_valid,
                         cfg: dict) -> Detections:
    """Class-agnostic box codes decoded against their proposals, then the
    per-class NMS tail."""
    probs = torch.softmax(roi_cls, dim=-1)
    fg = probs[..., 1:] * prop_valid[..., None]
    boxes = clip(decode(roi_box, props))
    n = cfg["nms"]
    return multiclass_nms(boxes, fg, n["max_output"], n["iou_threshold"],
                          n["score_threshold"])


def ssd_detections(cls_logits, box_codes, anchors, cfg: dict) -> Detections:
    """Softmax, the background dropped, codes decoded against the anchors,
    then the per-class NMS tail (its candidates by an exact top-k)."""
    fg = torch.softmax(cls_logits.float(), dim=-1)[..., 1:]
    boxes = clip(decode(box_codes.float(), anchors[None]))
    n = cfg["nms"]
    return multiclass_nms(boxes, fg, n["max_output"], n["iou_threshold"],
                          n["score_threshold"])
