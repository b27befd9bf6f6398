"""Plain PyTorch reference of the Light-Head training step: augmentation,
the forward in training mode, anchor and proposal targets, the RPN and
OHEM losses, the backward (autograd through a gather PSROIAlign) and
SGD-momentum with weight decay on kernels and a linear warm-up.

Frozen from the port's plain code (``data/augment``, ``ops/matching``,
``train/losses``, ``train/schedule``, ``train/trainer``), importing none
of it. Every random value is drawn here, by the same calls in the same
order on a generator seeded alike, so the program and the reference see
the same crops, colours, flips and RPN samples.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import nets, post
from benchmark.reference.nets import identity

# ---- draws -------------------------------------------------------------------


def _uniform(gen, shape, lo, hi):
    u = torch.rand(shape, generator=gen, device=gen.device)
    return (u * (hi - lo) + lo).clamp_min(lo)


class Draws(NamedTuple):
    aspect: torch.Tensor
    area: torch.Tensor
    y: torch.Tensor
    x: torch.Tensor
    brightness: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor
    contrast: torch.Tensor
    contrast_last: torch.Tensor
    flip: torch.Tensor


def draw_augment(gen, batch: int, d: dict) -> Draws:
    """The crop trials, the colour factors and the flip, in the program's
    order of draws."""
    n = d["crop_attempts"]
    aspect = _uniform(gen, (batch, n), *d["aspect_ratio_range"])
    area = _uniform(gen, (batch, n), 0.0, 1.0)
    y = _uniform(gen, (batch, n), 0.0, 1.0)
    x = _uniform(gen, (batch, n), 0.0, 1.0)
    bright = _uniform(gen, (batch,), -d["brightness_max_delta"],
                      d["brightness_max_delta"])
    sat = _uniform(gen, (batch,), *d["saturation_range"])
    hue = _uniform(gen, (batch,), -d["hue_max_delta"],
                   d["hue_max_delta"]) * 2.0 * math.pi
    contrast = _uniform(gen, (batch,), *d["contrast_range"])
    last = _uniform(gen, (batch,), 0.0, 1.0) < 0.5
    flip = _uniform(gen, (batch,), 0.0, 1.0) < 0.5
    return Draws(aspect, area, y, x, bright, sat, hue, contrast, last, flip)


def draw_rpn(gen, batch: int, anchors: int):
    """The RPN sampling priorities (fg, bg), [B, A] each."""
    shape = (batch, anchors)
    return (torch.rand(shape, generator=gen, device=gen.device),
            torch.rand(shape, generator=gen, device=gen.device))


# ---- augmentation ------------------------------------------------------------

def ioa(a, b):
    x, y = a[..., :, None, :], b[..., None, :, :]
    hw = (torch.minimum(x[..., 2:], y[..., 2:])
          - torch.maximum(x[..., :2], y[..., :2]))
    inter = hw.clamp_min(0.0).prod(dim=-1)
    area_b = post.area(b)[..., None, :]
    return torch.where(area_b > 0, inter / area_b.clamp_min(post.EPS),
                       torch.zeros_like(inter))


def crop_window(dr: Draws, gt_boxes, gt_mask, d: dict):
    """TF's distorted-box sampler over a fixed number of trials (the whole
    canvas): the first trial whose size fits and that covers enough of a
    gt box, else the canvas."""
    aspect = dr.aspect
    one = torch.ones_like(aspect[:, :1])
    h_lo = torch.sqrt(d["area_range"][0] * one / aspect)
    h_hi = torch.sqrt(d["area_range"][1] * one / aspect)
    h_hi = torch.minimum(h_hi, torch.minimum(one, one / aspect))
    fits = h_lo <= h_hi * (1.0 + 1e-6)
    h = h_lo + dr.area * (h_hi - h_lo).clamp_min(0.0)
    w = torch.minimum(h * aspect, one)
    h = torch.minimum(h, one)
    y0, x0 = dr.y * (one - h), dr.x * (one - w)
    crops = torch.stack([y0, x0, y0 + h, x0 + w], dim=-1)
    covered = torch.where(gt_mask[:, None, :], ioa(crops, gt_boxes), 0.0)
    ok = torch.where(gt_mask.any(dim=-1, keepdim=True),
                     (covered >= d["min_object_covered"]).any(dim=-1), True)
    valid = fits & ok
    first = valid.to(torch.uint8).argmax(dim=-1)
    chosen = torch.gather(crops, 1, first[:, None, None].expand(-1, 1, 4))
    whole = torch.cat([torch.zeros_like(one), torch.zeros_like(one), one,
                       one], dim=-1)
    return torch.where(valid.any(dim=-1, keepdim=True), chosen[:, 0], whole)


def _resize_weights(lo, hi, out: int, extent: int):
    ar = torch.arange(out, dtype=torch.float32, device=lo.device)
    coords = lo[:, None] + (ar + 0.5) / out * (hi - lo)[:, None]
    px = (coords * extent - 0.5).clamp(0.0, extent - 1.0)
    pix = torch.arange(extent, dtype=torch.float32, device=lo.device)
    return (1.0 - (pix - px[..., None]).abs()).clamp_min(0.0)


_RGB2YIQ = np.array([[0.299, 0.587, 0.114], [0.596, -0.274, -0.322],
                     [0.211, -0.523, 0.312]], np.float32)
_YIQ2RGB = np.linalg.inv(_RGB2YIQ).astype(np.float32)


def _color(dr: Draws, img):
    def per(v):
        return v[:, None, None, None]

    def contrast(t):
        mean = t.mean(dim=(1, 2), keepdim=True)
        return (t - mean) * per(dr.contrast) + mean

    y = img + per(dr.brightness)
    last = per(dr.contrast_last)
    t = torch.where(last, y, contrast(y))
    gray = (t * t.new_tensor((0.299, 0.587, 0.114))).sum(-1, keepdim=True)
    t = gray + (t - gray) * per(dr.saturation)
    yiq = t @ t.new_tensor(_RGB2YIQ).T
    c = per(torch.cos(dr.hue))[..., 0]
    s = per(torch.sin(dr.hue))[..., 0]
    rot = torch.stack([yiq[..., 0], yiq[..., 1] * c - yiq[..., 2] * s,
                       yiq[..., 1] * s + yiq[..., 2] * c], dim=-1)
    u = rot @ t.new_tensor(_YIQ2RGB).T
    return torch.where(last, contrast(u), u).clamp(0.0, 1.0)


def augment(dr: Draws, raw: Dict[str, torch.Tensor], d: dict, size: int):
    """Canvases [B, H, W, 3] in [0, 255] -> whitened crops at ``size`` with
    their gt boxes in the crop's frame (and mirrored with the image)."""
    gt_boxes, gt_mask = raw["gt_boxes"], raw["gt_mask"]
    crop = crop_window(dr, gt_boxes, gt_mask, d)
    cy0, cx0, cy1, cx1 = (crop[:, n:n + 1] for n in range(4))
    ch, cw = (cy1 - cy0).clamp_min(1e-8), (cx1 - cx0).clamp_min(1e-8)
    keep = gt_mask & (ioa(crop[:, None, :], gt_boxes)[:, 0]
                      >= d["box_keep_coverage"])
    boxes = post.clip(torch.stack([
        (gt_boxes[..., 0] - cy0) / ch, (gt_boxes[..., 1] - cx0) / cw,
        (gt_boxes[..., 2] - cy0) / ch, (gt_boxes[..., 3] - cx0) / cw], -1))
    boxes = torch.where(keep[..., None], boxes, 0.0)
    _, h, w, _ = raw["image"].shape
    wy = _resize_weights(crop[:, 0], crop[:, 2], size, h)
    wx = _resize_weights(crop[:, 1], crop[:, 3], size, w)
    img = torch.einsum("bqw,bpwc->bpqc", wx,
                       torch.einsum("bph,bhwc->bpwc", wy, raw["image"]))
    img = _color(dr, img / 255.0) * 255.0
    flip = dr.flip
    img = torch.where(flip[:, None, None, None], img.flip(2), img)
    mirrored = torch.stack([boxes[..., 0], 1.0 - boxes[..., 3],
                            boxes[..., 2], 1.0 - boxes[..., 1]], dim=-1)
    boxes = torch.where(flip[:, None, None], mirrored, boxes)
    boxes = torch.where(keep[..., None], boxes, 0.0)
    img = img - img.new_tensor(d["pixel_means"])
    return img, boxes, torch.where(keep, raw["gt_labels"], 0), keep


# ---- targets -------------------------------------------------------------------

def match(anchors, gt_boxes, gt_labels, gt_mask, pos_iou, neg_iou, force):
    """(fg, bg, labels, regression targets, matched IoU) per anchor."""
    iou = torch.where(gt_mask[..., None, :], post.iou(anchors, gt_boxes), -1.0)
    gt = iou.argmax(dim=-1)
    best = iou.amax(dim=-1)
    fg, bg = best >= pos_iou, best < neg_iou
    if force:
        best_anchor = iou.argmax(dim=-2)
        ids = torch.arange(iou.shape[-2], device=iou.device)
        claims = (best_anchor[..., None, :] == ids[:, None]) & gt_mask[
            ..., None, :]
        claim_iou = torch.where(claims, iou, -torch.inf)
        forced = claims.any(dim=-1)
        gt = torch.where(forced, claim_iou.argmax(dim=-1), gt)
        fg, bg = fg | forced, bg & ~forced
        best = torch.where(forced, claim_iou.amax(dim=-1), best)
    labels = torch.where(fg, torch.gather(gt_labels, -1, gt), 0)
    boxes = torch.gather(gt_boxes, -2, gt[..., None].expand(*gt.shape, 4))
    reg = torch.where(fg[..., None], post.encode(boxes, anchors), 0.0)
    return fg, bg, labels, reg, best


# ---- losses --------------------------------------------------------------------

def smooth_l1(pred, target, sigma):
    diff = pred - target
    a = diff.abs()
    cut = 1.0 / (sigma * sigma)
    return torch.where(a < cut, 0.5 * (sigma * diff).square(),
                       a - 0.5 * cut).sum(dim=-1)


def softmax_ce(logits, labels):
    logp = F.log_softmax(logits, dim=-1)
    onehot = labels[..., None] == torch.arange(logits.shape[-1],
                                               device=labels.device)
    return -torch.where(onehot, logp, 0.0).sum(dim=-1)


def _rank(values):
    order = torch.sort(-values, dim=-1, stable=True).indices
    ranks = torch.arange(values.shape[-1], device=values.device
                         ).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ranks)


def rpn_loss(prio, rpn_cls, rpn_loc, fg, bg, reg, t: dict):
    batch, frac = t["rpn_batch_size"], t["rpn_fg_fraction"]
    max_fg, a = int(batch * frac), fg.shape[-1]
    fg_p = torch.where(fg, prio[0], -1.0)
    fg_kth = torch.topk(fg_p, min(max_fg, a), dim=-1).values[..., -1:]
    fg_sel = fg & (fg_p >= fg_kth)
    num_fg = fg_sel.sum(dim=-1, keepdim=True)
    bg_p = torch.where(bg, prio[1], -1.0)
    k_bg = min(batch, a)
    bg_top = torch.topk(bg_p, k_bg, dim=-1).values
    num_bg = (batch - num_fg).clamp(1, k_bg)
    bg_kth = torch.gather(bg_top, -1, num_bg - 1)
    bg_sel = bg & (bg_p >= bg_kth) & (num_fg < batch)
    w = (fg_sel | bg_sel).float()
    cls = (softmax_ce(rpn_cls, fg.long()) * w).sum(-1) / w.sum(-1).clamp_min(
        1.0)
    fg_w = w * fg.float()
    loc = (smooth_l1(rpn_loc, reg, 3.0) * fg_w).sum(-1) / fg_w.sum(
        -1).clamp_min(1.0)
    return cls + loc


def roi_loss(roi_cls, roi_box, labels, reg, fg, valid, topk):
    cls = softmax_ce(roi_cls, labels)
    loc = torch.where(fg, smooth_l1(roi_box, reg, 1.0), 0.0)
    per = torch.where(valid, cls + loc, 0.0)
    k = min(topk, per.shape[-1])
    keep = valid & (_rank(torch.where(valid, per, -torch.inf).detach()) < k)
    return (per * keep).sum(-1) / keep.sum(-1).float().clamp_min(1.0)


# ---- the step ------------------------------------------------------------------

def lr_at(step: int, t: dict) -> float:
    """The warm-up's linear ramp from 0.1 x the base rate, then the base
    rate (the steps compared lie before any decay boundary)."""
    base, warm = t["learning_rate"], t["warmup_steps"]
    if step >= warm:
        return base
    frac = 1.0 - step / warm
    return (base * 0.1 - base) * frac + base


class StepPlan(NamedTuple):
    """How a step splits its batch: ``micro`` images a microbatch (the
    whole batch by default); ``rpn_seeds``, one generator seed a rank for
    the RPN samples of its rows (None: drawn after the augmentation from
    the step's generator); ``only``, the leading microbatches whose
    gradients count (None: all; a fault otherwise); ``rows``, the leading
    images of a microbatch whose loss counts (None: all; a fault)."""
    micro: Optional[int] = None
    rpn_seeds: Optional[Callable] = None
    only: Optional[int] = None
    rows: Optional[int] = None


def _microbatch(cfg, net, anchors, img, gt, prio, props, rows, low):
    """One microbatch's loss and its (RPN outputs, proposals)."""
    t = cfg["train"]
    gt_boxes, gt_labels, gt_mask = gt
    feats = nets.backbone(net, img, cfg)
    rc, rl = nets.rpn_head(net, feats["c4"])
    if props is None:
        w = low or torch.float32
        pb, _, pv = post.proposals(rc.detach().to(w), rl.detach().to(w),
                                   anchors.to(w), cfg, training=True)
        pb = pb.float()
    else:
        pb, pv = props
    thin = nets.thin_map(net, feats["c5"]).permute(0, 2, 3, 1)
    pooled = post.psroi_align(thin.contiguous(), pb, grid=cfg["roi_grid"])
    hc, hb = nets.roi_head(net, pooled * pv[..., None, None, None])
    fg, bg, _, reg, _ = match(anchors, gt_boxes, gt_labels, gt_mask,
                              t["rpn_pos_iou"], t["rpn_neg_iou"], True)
    rpn = rpn_loss(prio, rc, rl, fg, bg, reg, t)
    pfg, _, plab, preg, piou = match(pb, gt_boxes, gt_labels, gt_mask,
                                     t["roi_fg_iou"], t["roi_fg_iou"], False)
    pfg = pfg & pv
    band = piou.clamp_min(0.0)
    pbg = (band < t["roi_bg_iou_hi"]) & (band >= t["roi_bg_iou_lo"]) & pv & (
        ~pfg)
    roi = roi_loss(hc, hb, torch.where(pfg, plab, 0),
                   torch.where(pfg[..., None], preg, 0.0), pfg, pfg | pbg,
                   t["ohem_topk"])
    loss = rpn[:rows].mean() + roi[:rows].mean()
    return loss, (rc.detach(), rl.detach(), pb, pv)


def loss_and_grads(cfg: dict, params, raw, gen_seed: int, device,
                   cast: Callable = identity, props=None,
                   plan: StepPlan = StepPlan(), low=None):
    """One step's (loss, gradients by name, each microbatch's RPN outputs
    and proposals) from ``params`` (float32 leaves), a raw batch and the
    step's generator seed: the mean loss and gradient over the
    microbatches. With ``props``, one (boxes, valid) a microbatch, the RoI
    targets and pooling take those proposals (the program's own), else the
    reference's. With ``low`` the proposal stage runs in that dtype (the
    control's)."""
    d = dict(cfg["data"], pixel_means=cfg["pixel_means"])
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    b = raw["image"].shape[0]
    dr = draw_augment(gen, b, d)
    img, gt_boxes, gt_labels, gt_mask = augment(dr, raw, d,
                                                cfg["image_size"])
    anchors = torch.from_numpy(post.rpn_anchors(
        cfg["image_size"], cfg["anchors"])).to(device)
    a = anchors.shape[0]
    if plan.rpn_seeds is None:
        prio = draw_rpn(gen, b, a)
    else:
        seeds = plan.rpn_seeds
        parts = [draw_rpn(torch.Generator(device=device).manual_seed(s),
                          b // len(seeds), a) for s in seeds]
        prio = tuple(torch.cat([p[j] for p in parts]) for j in range(2))
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()
              if not k.endswith(("running_mean", "running_var"))}
    net = nets.Net({**params, **leaves}, cast=cast, train=True)
    micro = plan.micro or b
    n = plan.only or b // micro
    total, stages = 0.0, []
    for m in range(b // micro):
        rows = slice(m * micro, (m + 1) * micro)
        loss, stage = _microbatch(
            cfg, net, anchors, img[rows],
            (gt_boxes[rows], gt_labels[rows], gt_mask[rows]),
            (prio[0][rows], prio[1][rows]),
            None if props is None else props[m], plan.rows, low)
        if m < n:          # past ``only``: run, but leave out of the step
            (loss / n).backward()
            total += float(loss.detach()) / n
        del loss
        stages.append(stage)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    return total, grads, stages


class SGD:
    """SGD with momentum; weight decay on kernels, added before the
    momentum trace (torch's and optax's order)."""

    def __init__(self, cfg: dict, kinds: Dict[str, str]):
        self.t, self.kinds = cfg["train"], kinds
        self.trace: Dict[str, torch.Tensor] = {}

    def step(self, params, grads, step: int) -> Dict[str, torch.Tensor]:
        lr, mu, wd = (lr_at(step, self.t), self.t["momentum"],
                      self.t["weight_decay"])
        out = dict(params)
        for k, g in grads.items():
            d_p = g + wd * params[k] if self.kinds[k] == "kernel" else g
            tr = self.trace.get(k)
            tr = d_p.clone() if tr is None else tr * mu + d_p
            self.trace[k] = tr
            out[k] = params[k] - lr * tr
        return out


def follow(cfg: dict, params, raws, seeds, device, steps: int = 3,
           cast: Callable = identity, props_of: Optional[Callable] = None,
           plan_of: Callable = lambda i: StepPlan(), low=None):
    """``steps`` reference steps from ``params``: (losses, the first
    step's gradient as SGD takes it (with the decay), its raw gradient, the
    last parameters, every microbatch's RPN outputs and proposals in step
    order)."""
    kinds = {n: k for n, _, k in nets.param_spec(cfg)}
    sgd = SGD(cfg, kinds)
    p = dict(params)
    losses, first, stages = [], None, []
    for i in range(steps):
        props = props_of(i) if props_of else None
        loss, grads, got = loss_and_grads(cfg, p, raws[i], seeds[i], device,
                                          cast, props, plan_of(i), low)
        p = sgd.step(p, grads, i)
        if i == 0:
            first = {k: v.clone() for k, v in sgd.trace.items()}
            raw_grads = grads
        losses.append(loss)
        stages += got
        del grads
    return losses, first, raw_grads, p, stages
