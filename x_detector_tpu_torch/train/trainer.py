"""The training step of both families: forward -> target assignment ->
losses -> backward -> SGD-momentum update (and the EMA shadow's update).

The port of ``x_detector_tpu/train/trainer.py``: Light-Head R-CNN
(``family="lighthead"``) and the SSD / X-Det single-shot detectors
(``family="ssd"``). Batches are dicts of fixed-shape tensors on the model's
device:

  image      [B, S, S, 3]   float32, whitened (NHWC)
  gt_boxes   [B, G, 4]      normalized corners, zero-padded
  gt_labels  [B, G]         int32 class ids (0 on padding)
  gt_mask    [B, G]         bool
  difficult  [B, G]         bool, optional: excluded from the targets

A caller builds the state and the step, then feeds batches::

    state = create_model_and_state(cfg, device, seed=0)
    step = make_train_step(state.model, cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    state, metrics = step(state, batch, gen)

The Light-Head step draws its RPN sampling priorities from ``gen``; the SSD
step draws nothing.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from x_detector_tpu_torch.inference import build_model
from x_detector_tpu_torch.models.layers import BatchNorm2D
from x_detector_tpu_torch.models.lighthead import LightHeadRCNN
from x_detector_tpu_torch.models.ssd import SSDModel
from x_detector_tpu_torch.ops import matching
from x_detector_tpu_torch.train import losses as loss_lib
from x_detector_tpu_torch.train.schedule import make_optimizer
from x_detector_tpu_torch.train.train_state import TrainState

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


def _train_gt_mask(batch: Batch, cfg) -> torch.Tensor:
    """The gt rows that make targets: difficult objects are left out unless
    ``cfg.data.include_difficult``."""
    mask = batch["gt_mask"]
    if not cfg.data.include_difficult and "difficult" in batch:
        mask = mask & ~batch["difficult"]
    return mask


def make_ssd_loss_fn(model: SSDModel, cfg):
    """loss_fn(batch, draws=None) -> (loss, metrics, aux), the per-image
    means. The model runs in training mode; every image's anchors (the
    model's ``anchors`` buffer) are matched at ``ssd_match_iou`` with
    forced matches, then ``ssd_loss`` mines the hard negatives. ``aux`` is
    empty."""
    tcfg = cfg.train

    def loss_fn(batch: Batch, draws=None
                ) -> Tuple[torch.Tensor, Metrics, Dict[str, torch.Tensor]]:
        del draws  # the SSD loss is deterministic given the batch
        model.train()
        cls_logits, box_codes = model(batch["image"])
        m = matching.match_anchors(
            model.anchors, batch["gt_boxes"], batch["gt_labels"],
            _train_gt_mask(batch, cfg), pos_iou=tcfg.ssd_match_iou,
            neg_iou=tcfg.ssd_match_iou, force_match=True)
        total, metrics = loss_lib.ssd_loss(
            cls_logits, box_codes, m.labels, m.reg_targets, m.fg_mask,
            neg_pos_ratio=tcfg.neg_pos_ratio)
        return total.mean(), {k: v.detach().mean()
                              for k, v in metrics.items()}, {}

    return loss_fn


def make_lighthead_loss_fn(model: LightHeadRCNN, cfg):
    """loss_fn(batch, priorities) -> (loss, metrics, aux). The model runs in
    training mode (its BatchNorm running stats move); ``priorities`` are the
    RPN sampling draws (``losses.draw_rpn_priorities``). ``aux`` holds the
    proposals, their validity and the OHEM keep mask."""
    tcfg = cfg.train

    def loss_fn(batch: Batch, priorities: loss_lib.RPNPriorities
                ) -> Tuple[torch.Tensor, Metrics, Dict[str, torch.Tensor]]:
        model.train()
        out = model(batch["image"])
        gt_mask = _train_gt_mask(batch, cfg)
        gt_boxes, gt_labels = batch["gt_boxes"], batch["gt_labels"]

        m = matching.match_anchors(model.anchors, gt_boxes, gt_labels,
                                   gt_mask, pos_iou=tcfg.rpn_pos_iou,
                                   neg_iou=tcfg.rpn_neg_iou, force_match=True)
        rpn_total, rpn_metrics = loss_lib.rpn_loss(
            priorities, out["rpn_cls"], out["rpn_loc"], m.fg_mask, m.bg_mask,
            m.reg_targets, batch_size=tcfg.rpn_batch_size,
            fg_fraction=tcfg.rpn_fg_fraction)

        # RoI targets over the (detached) proposals; the dead zone and rois
        # below the background band are left out of the loss
        mp = matching.match_proposals(
            out["proposals"].detach(), out["proposal_valid"], gt_boxes,
            gt_labels, gt_mask, fg_iou=tcfg.roi_fg_iou,
            bg_iou_hi=tcfg.roi_bg_iou_hi, bg_iou_lo=tcfg.roi_bg_iou_lo)
        roi_total, roi_metrics, keep = loss_lib.roi_loss_ohem(
            out["roi_cls"], out["roi_box"], mp.labels, mp.reg_targets,
            mp.fg_mask, mp.fg_mask | mp.bg_mask, ohem_topk=tcfg.ohem_topk)

        total = rpn_total.mean() + roi_total.mean()
        metrics = {k: v.detach().mean()
                   for k, v in {**rpn_metrics, **roi_metrics}.items()}
        aux = {"proposals": out["proposals"],
               "proposal_valid": out["proposal_valid"], "ohem_keep": keep}
        return total, metrics, aux

    return loss_fn


def make_loss_fn(model: torch.nn.Module, cfg):
    """The family's loss_fn(batch, draws) -> (loss, metrics, aux)."""
    if cfg.model.family == "ssd":
        return make_ssd_loss_fn(model, cfg)
    if cfg.model.family == "lighthead":
        return make_lighthead_loss_fn(model, cfg)
    raise ValueError(f"unknown family {cfg.model.family!r}")


def make_grad_fn(model: torch.nn.Module, loss_fn, accum: int = 1):
    """grad_fn(batch, draws) -> metrics (with ``total_loss``). ``draws`` are
    the loss's random draws, per image on the leading axis (the Light-Head's
    ``RPNPriorities``), or None (SSD). Leaves the gradients in the
    parameters' ``.grad`` (zeros where a parameter got none) and the new
    BatchNorm running stats in the model.

    ``accum > 1`` splits the batch into ``accum`` microbatches in order and
    averages their gradients, BN statistics and metrics, one update per
    call, as the JAX package does: each microbatch's BN update starts from
    the step-initial running stats, and the updates are averaged."""

    def run(batch, draws):
        total, metrics, _ = loss_fn(batch, draws)
        total.backward()
        return dict(metrics, total_loss=total.detach())

    def grad_fn(batch: Batch, draws=None) -> Metrics:
        model.zero_grad(set_to_none=True)
        if accum <= 1:
            metrics = run(batch, draws)
        else:
            bsz = batch["image"].shape[0]
            if bsz % accum:
                raise ValueError(f"batch size {bsz} not divisible by "
                                 f"grad_accum_steps={accum}")
            mb = bsz // accum
            bns = [m for m in model.modules() if isinstance(m, BatchNorm2D)]
            start = [(bn.running_mean.clone(), bn.running_var.clone())
                     for bn in bns]
            new_stats, all_metrics = [], []
            for i in range(accum):
                for bn, (mean, var) in zip(bns, start):
                    bn.running_mean.copy_(mean)
                    bn.running_var.copy_(var)
                part = slice(i * mb, (i + 1) * mb)
                all_metrics.append(run(
                    {k: v[part] for k, v in batch.items()},
                    None if draws is None else
                    type(draws)(*(d[part] for d in draws))))
                new_stats.append([(bn.running_mean.clone(),
                                   bn.running_var.clone()) for bn in bns])
            with torch.no_grad():
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.mul_(1.0 / accum)
                for n, bn in enumerate(bns):
                    bn.running_mean.copy_(torch.stack(
                        [s[n][0] for s in new_stats]).mean(dim=0))
                    bn.running_var.copy_(torch.stack(
                        [s[n][1] for s in new_stats]).mean(dim=0))
            metrics = {k: torch.stack([m[k] for m in all_metrics]).mean(0)
                       for k in all_metrics[0]}
        for p in model.parameters():        # JAX's grads are never absent
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return metrics

    return grad_fn


def create_model_and_state(cfg, device, seed: Optional[int] = 0,
                           dtype: torch.dtype = torch.bfloat16) -> TrainState:
    """The family's model (Light-Head or SSD) on ``device`` in training
    mode, its optimizer and schedule, and the EMA shadow if
    ``cfg.train.ema_decay`` > 0. ``seed`` as for ``inference.build_model``
    (None: load the weights, then make the state with ``TrainState.create``
    so that a shadow copies them)."""
    model = build_model(cfg.model, device, seed=seed, dtype=dtype).train()
    optimizer, schedule = make_optimizer(model, cfg.train)
    return TrainState.create(model, optimizer, schedule,
                             ema_decay=cfg.train.ema_decay)


def make_train_step(model: torch.nn.Module, cfg,
                    sync: Optional[Callable[[Metrics], Metrics]] = None
                    ) -> Callable[..., Tuple[TrainState, Metrics]]:
    """train_step(state, batch, generator=None, priorities=None) -> (state,
    metrics): for Light-Head draws the RPN sampling priorities from
    ``generator`` (or takes the ``priorities`` given; the SSD step draws
    nothing and needs no generator), computes the gradients
    (``cfg.train.grad_accum_steps`` microbatches), passes the metrics
    through ``sync`` (the data-parallel average, which also averages the
    gradients and BatchNorm stats in place) and applies the gradients.
    ``model`` is ``state.model``."""
    grad_fn = make_grad_fn(model, make_loss_fn(model, cfg),
                           cfg.train.grad_accum_steps)
    draws_rpn = cfg.model.family == "lighthead"
    num_anchors = model.anchors.shape[0]

    def train_step(state: TrainState, batch: Batch,
                   generator: Optional[torch.Generator] = None,
                   priorities: Optional[loss_lib.RPNPriorities] = None
                   ) -> Tuple[TrainState, Metrics]:
        if draws_rpn and priorities is None:
            priorities = loss_lib.draw_rpn_priorities(
                generator, batch["image"].shape[0], num_anchors)
        metrics = grad_fn(batch, priorities)
        if sync is not None:
            metrics = sync(metrics)
        return state.apply_gradients(), metrics

    return train_step
