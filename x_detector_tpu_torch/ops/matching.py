"""Ground truth -> anchor and proposal matching (training targets).

The port of ``x_detector_tpu/ops/matching.py``, batched: every function
takes leading batch dims on its box sets. Gt boxes come padded to a fixed
count with a validity mask; padded columns get IoU -1, so they never match.
``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does, so ties
(padded columns included) resolve alike.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from x_detector_tpu_torch.ops import boxes as box_ops


class MatchResult(NamedTuple):
    """Per-anchor match state, each [..., A] (``reg_targets`` [..., A, 4])."""
    matched_gt: torch.Tensor    # int64 index of the assigned gt (valid if fg)
    matched_iou: torch.Tensor   # IoU with the assigned gt
    fg_mask: torch.Tensor       # bool, positive anchors
    bg_mask: torch.Tensor       # bool, negative anchors (neither: ignored)
    labels: torch.Tensor        # int32 class target (0 = background)
    reg_targets: torch.Tensor   # encoded regression targets (fg only)


def match_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_labels: torch.Tensor, gt_mask: torch.Tensor,
                  pos_iou: float, neg_iou: float,
                  force_match: bool = True) -> MatchResult:
    """Threshold matching with optional forced best-anchor-per-gt.

    ``anchors`` [..., A, 4]; ``gt_boxes`` [..., G, 4], ``gt_labels`` and
    ``gt_mask`` [..., G]. Each anchor takes its highest-IoU valid gt: fg at
    IoU >= ``pos_iou``, bg below ``neg_iou``, else ignored. With
    ``force_match`` every valid gt's best anchor is made fg and assigned to
    it; where gts share a best anchor the one of highest IoU wins.
    """
    iou = box_ops.iou(anchors, gt_boxes)                       # [..., A, G]
    iou = torch.where(gt_mask[..., None, :], iou, -1.0)
    matched_gt = iou.argmax(dim=-1)          # first maximum, as jnp.argmax
    matched_iou = iou.amax(dim=-1)
    fg = matched_iou >= pos_iou
    bg = matched_iou < neg_iou      # with no valid gt, all is background
    if force_match:
        best_anchor = iou.argmax(dim=-2)                       # [..., G]
        anchor_ids = torch.arange(iou.shape[-2], device=iou.device)
        claims = ((best_anchor[..., None, :] == anchor_ids[:, None])
                  & gt_mask[..., None, :])                     # [..., A, G]
        claim_iou = torch.where(claims, iou, -torch.inf)
        forced = claims.any(dim=-1)
        matched_gt = torch.where(forced, claim_iou.argmax(dim=-1), matched_gt)
        fg = fg | forced
        bg = bg & ~forced
        matched_iou = torch.where(forced, claim_iou.amax(dim=-1),
                                  matched_iou)
    labels = torch.where(fg, torch.gather(gt_labels, -1, matched_gt), 0
                         ).to(torch.int32)
    idx = matched_gt[..., None].expand(*matched_gt.shape, 4)
    matched_boxes = torch.gather(gt_boxes, -2, idx)
    reg = box_ops.encode(matched_boxes, anchors)
    reg = torch.where(fg[..., None], reg, 0.0)
    return MatchResult(matched_gt, matched_iou, fg, bg, labels, reg)


def match_proposals(proposals: torch.Tensor, proposal_mask: torch.Tensor,
                    gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                    gt_mask: torch.Tensor, fg_iou: float = 0.5,
                    bg_iou_hi: float = 0.5,
                    bg_iou_lo: float = 0.0) -> MatchResult:
    """Second-stage (RoI head) targets: valid proposals at IoU >= ``fg_iou``
    are fg with that gt's class; valid ones whose best IoU lies in
    ``[bg_iou_lo, bg_iou_hi)`` are bg; the rest (padding, the dead zone) are
    ignored. An image without valid gt puts its proposals at IoU 0."""
    res = match_anchors(proposals, gt_boxes, gt_labels, gt_mask,
                        pos_iou=fg_iou, neg_iou=fg_iou, force_match=False)
    fg = res.fg_mask & proposal_mask
    band = res.matched_iou.clamp_min(0.0)
    bg = (band < bg_iou_hi) & (band >= bg_iou_lo) & proposal_mask & ~fg
    labels = torch.where(fg, res.labels, 0).to(torch.int32)
    reg = torch.where(fg[..., None], res.reg_targets, 0.0)
    return MatchResult(res.matched_gt, res.matched_iou, fg, bg, labels, reg)
