"""Detection losses: CE, modified smooth-L1, RPN sampling, OHEM, SSD
hard-negative mining.

The port of ``x_detector_tpu/train/losses.py``, batched: each function takes
a leading batch of images and returns per-image losses ``[B]``. Every
"select a subset" is a mask over a fixed-size axis, as in the JAX package.

RPN sampling is split in two: :func:`draw_rpn_priorities` draws the uniform
priorities from a ``torch.Generator``, and :func:`sample_rpn_minibatch`
applies them, so a test can feed both packages the same draws.
``ssd_loss`` draws nothing.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

Metrics = Dict[str, torch.Tensor]


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              sigma: float = 1.0) -> torch.Tensor:
    """Modified smooth-L1 (Fast R-CNN form), summed over the last dim:
    0.5 (sigma x)^2 where |x| < 1/sigma^2, else |x| - 0.5/sigma^2."""
    diff = pred - target
    abs_diff = diff.abs()
    cutoff = 1.0 / (sigma * sigma)
    loss = torch.where(abs_diff < cutoff, 0.5 * (sigma * diff).square(),
                       abs_diff - 0.5 * cutoff)
    return loss.sum(dim=-1)


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross-entropy with integer labels."""
    logp = F.log_softmax(logits, dim=-1)
    classes = torch.arange(logits.shape[-1], device=labels.device)
    onehot = labels[..., None] == classes
    return -torch.where(onehot, logp, 0.0).sum(dim=-1)


def _rank_of(values: torch.Tensor) -> torch.Tensor:
    """rank[..., i] = position of element i in a stable descending sort of
    the last dim (ties keep index order, as ``jnp.argsort`` does)."""
    order = torch.sort(-values, dim=-1, stable=True).indices
    ranks = torch.arange(values.shape[-1], device=values.device
                         ).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ranks)


class RPNPriorities(NamedTuple):
    """Uniform [0, 1) priorities of every anchor, [B, A] each."""
    fg: torch.Tensor
    bg: torch.Tensor


def draw_rpn_priorities(generator: torch.Generator, batch: int,
                        num_anchors: int) -> RPNPriorities:
    """The draw half of RPN sampling, on the generator's device."""
    shape = (batch, num_anchors)
    return RPNPriorities(
        torch.rand(shape, generator=generator, device=generator.device),
        torch.rand(shape, generator=generator, device=generator.device))


def sample_rpn_minibatch(priorities: RPNPriorities, fg_mask: torch.Tensor,
                         bg_mask: torch.Tensor, batch_size: int = 256,
                         fg_fraction: float = 0.5) -> torch.Tensor:
    """The apply half: [B, A] float {0, 1} minibatch weights. Up to
    ``batch_size * fg_fraction`` positives, the rest negatives, each chosen
    by a k-th-value threshold on the priorities (masked anchors at -1)."""
    max_fg = int(batch_size * fg_fraction)
    num_anchors = fg_mask.shape[-1]
    fg_prio = torch.where(fg_mask, priorities.fg, -1.0)
    fg_kth = torch.topk(fg_prio, min(max_fg, num_anchors), dim=-1
                        ).values[..., -1:]
    fg_sel = fg_mask & (fg_prio >= fg_kth)
    num_fg = fg_sel.sum(dim=-1, keepdim=True)

    bg_prio = torch.where(bg_mask, priorities.bg, -1.0)
    k_bg = min(batch_size, num_anchors)
    bg_top = torch.topk(bg_prio, k_bg, dim=-1).values      # descending
    num_bg = (batch_size - num_fg).clamp(1, k_bg)          # >= 1 slot read
    bg_kth = torch.gather(bg_top, -1, num_bg - 1)
    bg_sel = bg_mask & (bg_prio >= bg_kth) & (num_fg < batch_size)
    return (fg_sel | bg_sel).float()


def rpn_loss(priorities: RPNPriorities, rpn_cls: torch.Tensor,
             rpn_loc: torch.Tensor, fg_mask: torch.Tensor,
             bg_mask: torch.Tensor, reg_targets: torch.Tensor,
             batch_size: int = 256, fg_fraction: float = 0.5,
             sigma: float = 3.0) -> Tuple[torch.Tensor, Metrics]:
    """Per-image RPN loss [B]: softmax CE over the sampled minibatch plus
    smooth-L1 (sigma 3) over its positives. rpn_cls [B, A, 2],
    rpn_loc [B, A, 4]."""
    weights = sample_rpn_minibatch(priorities, fg_mask, bg_mask, batch_size,
                                   fg_fraction)
    cls_losses = softmax_ce(rpn_cls, fg_mask.long())
    cls_loss = ((cls_losses * weights).sum(dim=-1)
                / weights.sum(dim=-1).clamp_min(1.0))
    loc_losses = smooth_l1(rpn_loc, reg_targets, sigma=sigma)
    fg_w = weights * fg_mask.float()
    fg_n = fg_w.sum(dim=-1)
    loc_loss = (loc_losses * fg_w).sum(dim=-1) / fg_n.clamp_min(1.0)
    return cls_loss + loc_loss, {"rpn_cls_loss": cls_loss,
                                 "rpn_loc_loss": loc_loss, "rpn_num_fg": fg_n}


def roi_loss_ohem(roi_cls: torch.Tensor, roi_box: torch.Tensor,
                  labels: torch.Tensor, reg_targets: torch.Tensor,
                  fg_mask: torch.Tensor, valid_mask: torch.Tensor,
                  ohem_topk: int = 256, sigma: float = 1.0
                  ) -> Tuple[torch.Tensor, Metrics, torch.Tensor]:
    """Per-image RoI-head loss [B] with OHEM: per-roi CE + fg smooth-L1,
    and only the ``ohem_topk`` highest-loss rois of ``valid_mask`` count.

    roi_cls [B, R, C]; roi_box [B, R, 4] (class-agnostic) or [B, R, C, 4]
    (the slice at the target class is trained). Returns the losses, the
    metrics and the OHEM keep mask [B, R]."""
    cls_losses = softmax_ce(roi_cls, labels)
    if roi_box.dim() == roi_cls.dim() + 1:     # per-class regression
        onehot = labels[..., None] == torch.arange(roi_box.shape[-2],
                                                   device=labels.device)
        roi_box = torch.where(onehot[..., None], roi_box, 0.0).sum(dim=-2)
    loc_losses = torch.where(fg_mask, smooth_l1(roi_box, reg_targets,
                                                sigma=sigma), 0.0)
    per_roi = torch.where(valid_mask, cls_losses + loc_losses, 0.0)
    k = min(ohem_topk, per_roi.shape[-1])
    # hard selection: no gradient through the ranking
    rank = _rank_of(torch.where(valid_mask, per_roi, -torch.inf).detach())
    keep = valid_mask & (rank < k)
    denom = keep.sum(dim=-1).float().clamp_min(1.0)
    total = (per_roi * keep).sum(dim=-1) / denom
    return total, {
        "roi_cls_loss": (cls_losses * keep).sum(dim=-1) / denom,
        "roi_loc_loss": (loc_losses * keep).sum(dim=-1) / denom,
        "roi_num_fg": (fg_mask & keep).sum(dim=-1).float()}, keep


def ssd_loss(cls_logits: torch.Tensor, box_codes: torch.Tensor,
             labels: torch.Tensor, reg_targets: torch.Tensor,
             fg_mask: torch.Tensor, neg_pos_ratio: float = 3.0,
             sigma: float = 1.0) -> Tuple[torch.Tensor, Metrics]:
    """Per-image SSD multibox loss [B] with hard-negative mining.

    cls_logits [B, A, C], box_codes [B, A, 4]; every anchor that is not fg
    is a negative (force-matched SSD targets have no ignore zone). The
    ``int32(neg_pos_ratio * num_fg)`` negatives of highest CE (capped at the
    negatives there are; ties in index order, as JAX's stable rank) count
    in the class loss; smooth-L1 (``sigma``) on fg only; both over
    ``max(num_fg, 1)``."""
    cls_losses = softmax_ce(cls_logits, labels)
    num_fg = fg_mask.sum(dim=-1)
    # hard selection: no gradient through the ranking
    rank = _rank_of(torch.where(fg_mask, -torch.inf, cls_losses.detach()))
    num_neg = torch.minimum((neg_pos_ratio * num_fg).to(torch.int32),
                            (~fg_mask).sum(dim=-1))
    hard_neg = ~fg_mask & (rank < num_neg[..., None])
    weights = (fg_mask | hard_neg).float()
    denom = num_fg.float().clamp_min(1.0)
    cls_loss = (cls_losses * weights).sum(dim=-1) / denom
    loc_losses = smooth_l1(box_codes, reg_targets, sigma=sigma)
    loc_loss = (loc_losses * fg_mask).sum(dim=-1) / denom
    return cls_loss + loc_loss, {"ssd_cls_loss": cls_loss,
                                 "ssd_loc_loss": loc_loss,
                                 "ssd_num_fg": num_fg.float()}
