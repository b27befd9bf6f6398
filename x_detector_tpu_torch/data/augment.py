"""Device-side train augmentation and eval preprocessing.

The port of ``x_detector_tpu/data/augment.py``, batched over images (the
JAX package vmaps one image's function): a distorted-box crop sampled as
TF's ``sample_distorted_bounding_box`` samples it, a bilinear crop+resize as
two dense contractions, colour distortion in one of two orders, a random
horizontal flip with box mirroring, and the mean subtraction.

Each random function comes in two halves: a draw half (``draw_*``) that
takes a ``torch.Generator`` and returns the random values, and an apply half
that takes them as tensors. A test can then feed the JAX package's own
draws to the apply half; the draw halves are held to their distributions.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from x_detector_tpu_torch.ops import boxes as box_ops
from x_detector_tpu_torch.utils import profiling

Batch = Dict[str, torch.Tensor]


def _uniform(generator: torch.Generator, shape, lo: float,
             hi: float) -> torch.Tensor:
    """U[lo, hi) as ``jax.random.uniform`` forms it from U[0, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u * (hi - lo) + lo).clamp_min(lo)


# ---------------------------------------------------------------------------
# Crop sampling
# ---------------------------------------------------------------------------

class CropDraws(NamedTuple):
    """``cfg.crop_attempts`` trials per image, each [B, n]."""
    aspect: torch.Tensor   # aspect ratio w/h, U[aspect_ratio_range)
    area: torch.Tensor     # "tf": height fraction U[0, 1); "r1": U[area_range)
    y: torch.Tensor        # U[0, 1): offset as a fraction of the free height
    x: torch.Tensor        # U[0, 1): the same for the width


def draw_crop(generator: torch.Generator, batch: int, cfg) -> CropDraws:
    n = cfg.crop_attempts
    aspect = _uniform(generator, (batch, n), *cfg.aspect_ratio_range)
    if cfg.crop_sampler == "r1":
        area = _uniform(generator, (batch, n), *cfg.area_range)
    else:
        area = _uniform(generator, (batch, n), 0.0, 1.0)
    return CropDraws(aspect, area, _uniform(generator, (batch, n), 0.0, 1.0),
                     _uniform(generator, (batch, n), 0.0, 1.0))


def sample_distorted_box(draws: CropDraws, gt_boxes: torch.Tensor,
                         gt_mask: torch.Tensor, cfg,
                         box_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """One crop window [B, 4] (canvas-normalized corners) per image.

    TF ``sample_distorted_bounding_box`` with a fixed number of trials: a
    trial is valid iff its aspect and area fit and it covers at least
    ``cfg.min_object_covered`` of some valid gt box; the first valid trial
    wins, else the whole content region. ``box_scale`` [B, 2] = (fy, fx),
    the letterbox content fraction of the canvas (None: the whole canvas);
    crops stay inside it and areas are taken relative to it.
    """
    if box_scale is None:
        fy = fx = torch.ones_like(draws.aspect[:, :1])
    else:
        fy, fx = box_scale[:, 0:1].float(), box_scale[:, 1:2].float()
    aspect = draws.aspect
    content = fy * fx
    if cfg.crop_sampler == "r1":      # area uniform, oversize trials fail
        h = torch.sqrt(draws.area * content / aspect)
        w = torch.sqrt(draws.area * content * aspect)
        fits = (h <= fy) & (w <= fx)
        h = torch.minimum(h, fy)
        w = torch.minimum(w, fx)
    else:                             # TF: height uniform in its bounds
        h_lo = torch.sqrt(cfg.area_range[0] * content / aspect)
        h_hi = torch.sqrt(cfg.area_range[1] * content / aspect)
        h_hi = torch.minimum(h_hi, torch.minimum(fy, fx / aspect))
        fits = h_lo <= h_hi * (1.0 + 1e-6)
        h = h_lo + draws.area * (h_hi - h_lo).clamp_min(0.0)
        w = torch.minimum(h * aspect, fx)
        h = torch.minimum(h, fy)
    y0 = draws.y * (fy - h)
    x0 = draws.x * (fx - w)
    crops = torch.stack([y0, x0, y0 + h, x0 + w], dim=-1)       # [B, n, 4]

    cover = box_ops.ioa(crops, gt_boxes)                        # [B, n, G]
    covered = torch.where(gt_mask[:, None, :], cover, 0.0)
    ok_cover = torch.where(gt_mask.any(dim=-1, keepdim=True),
                           (covered >= cfg.min_object_covered).any(dim=-1),
                           True)      # no gt: every geometric trial is valid
    valid = fits & ok_cover
    first = valid.to(torch.uint8).argmax(dim=-1)   # first valid (0 if none)
    chosen = torch.gather(crops, 1, first[:, None, None].expand(-1, 1, 4))
    fallback = torch.cat([torch.zeros_like(fy), torch.zeros_like(fx), fy, fx],
                         dim=-1)
    return torch.where(valid.any(dim=-1, keepdim=True), chosen[:, 0],
                       fallback)


def transform_boxes_to_crop(gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                            crop: torch.Tensor,
                            min_center_coverage: float = 0.25
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gt boxes [B, G, 4] in the frame of ``crop`` [B, 4], clipped to it; a
    box survives iff the crop covers at least ``min_center_coverage`` of
    it. Returns (boxes, keep mask)."""
    cy0, cx0, cy1, cx1 = (crop[:, n:n + 1] for n in range(4))
    ch = (cy1 - cy0).clamp_min(1e-8)
    cw = (cx1 - cx0).clamp_min(1e-8)
    cover = box_ops.ioa(crop[:, None, :], gt_boxes)[:, 0]       # [B, G]
    keep = gt_mask & (cover >= min_center_coverage)
    shifted = torch.stack([
        (gt_boxes[..., 0] - cy0) / ch, (gt_boxes[..., 1] - cx0) / cw,
        (gt_boxes[..., 2] - cy0) / ch, (gt_boxes[..., 3] - cx0) / cw], dim=-1)
    shifted = box_ops.clip_boxes(shifted)
    return torch.where(keep[..., None], shifted, 0.0), keep


# ---------------------------------------------------------------------------
# Crop + resize (separable interpolation)
# ---------------------------------------------------------------------------

def _resize_weights(lo: torch.Tensor, hi: torch.Tensor, out: int,
                    extent: int) -> torch.Tensor:
    """[B, out, extent] triangular weights sampling the normalized span
    [lo, hi) of each image at ``out`` pixel centres."""
    ar = torch.arange(out, dtype=torch.float32, device=lo.device)
    coords = lo[:, None] + (ar + 0.5) / out * (hi - lo)[:, None]
    px = (coords * extent - 0.5).clamp(0.0, extent - 1.0)
    pix = torch.arange(extent, dtype=torch.float32, device=lo.device)
    return (1.0 - (pix - px[..., None]).abs()).clamp_min(0.0)


def crop_and_resize(images: torch.Tensor, crops: torch.Tensor,
                    out_size: int) -> torch.Tensor:
    """Bilinear crop+resize [B, H, W, C] -> [B, out, out, C] float32 by two
    contractions, rows then columns."""
    _, h, w, _ = images.shape
    wy = _resize_weights(crops[:, 0], crops[:, 2], out_size, h)  # [B, o, H]
    wx = _resize_weights(crops[:, 1], crops[:, 3], out_size, w)  # [B, o, W]
    tmp = torch.einsum("bph,bhwc->bpwc", wy, images.float())
    return torch.einsum("bqw,bpwc->bpqc", wx, tmp)


# ---------------------------------------------------------------------------
# Colour distortion (values in [0, 1]; per-image factors [B])
# ---------------------------------------------------------------------------

_RGB2YIQ_NP = np.array([[0.299, 0.587, 0.114],
                        [0.596, -0.274, -0.322],
                        [0.211, -0.523, 0.312]], np.float32)
# the inverse in float64 of the float32 matrix, so adjust_hue(img, 0) == img
_YIQ2RGB_NP = np.linalg.inv(_RGB2YIQ_NP).astype(np.float32)
_GRAY = (0.299, 0.587, 0.114)


def _per_image(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None, None]


def adjust_brightness(img: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    return img + _per_image(delta)


def adjust_contrast(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    mean = img.mean(dim=(1, 2), keepdim=True)
    return (img - mean) * _per_image(factor) + mean


def adjust_saturation(img: torch.Tensor,
                      factor: torch.Tensor) -> torch.Tensor:
    gray = (img * img.new_tensor(_GRAY)).sum(dim=-1, keepdim=True)
    return gray + (img - gray) * _per_image(factor)


def adjust_hue(img: torch.Tensor, delta_rad: torch.Tensor) -> torch.Tensor:
    """Rotate the I/Q plane of YIQ space by ``delta_rad``."""
    yiq = img @ img.new_tensor(_RGB2YIQ_NP).T
    c = _per_image(torch.cos(delta_rad))[..., 0]
    s = _per_image(torch.sin(delta_rad))[..., 0]
    rot = torch.stack([yiq[..., 0],
                       yiq[..., 1] * c - yiq[..., 2] * s,
                       yiq[..., 1] * s + yiq[..., 2] * c], dim=-1)
    return rot @ img.new_tensor(_YIQ2RGB_NP).T


class ColorDraws(NamedTuple):
    brightness: torch.Tensor      # [B] additive delta
    saturation: torch.Tensor      # [B] factor
    hue: torch.Tensor             # [B] rotation in radians
    contrast: torch.Tensor        # [B] factor
    contrast_last: torch.Tensor   # [B] bool: order B,S,H,C (else B,C,S,H)


def draw_color(generator: torch.Generator, batch: int, cfg) -> ColorDraws:
    return ColorDraws(
        _uniform(generator, (batch,), -cfg.brightness_max_delta,
                 cfg.brightness_max_delta),
        _uniform(generator, (batch,), *cfg.saturation_range),
        _uniform(generator, (batch,), -cfg.hue_max_delta,
                 cfg.hue_max_delta) * 2.0 * math.pi,
        _uniform(generator, (batch,), *cfg.contrast_range),
        _uniform(generator, (batch,), 0.0, 1.0) < 0.5)


def distort_color(draws: ColorDraws, img: torch.Tensor) -> torch.Tensor:
    """Brightness, then contrast before or after a saturation -> hue core
    (TF's two ``apply_with_random_selector`` orders), clipped to [0, 1]."""
    y = adjust_brightness(img, draws.brightness)
    last = _per_image(draws.contrast_last)
    t = torch.where(last, y, adjust_contrast(y, draws.contrast))
    u = adjust_hue(adjust_saturation(t, draws.saturation), draws.hue)
    out = torch.where(last, adjust_contrast(u, draws.contrast), u)
    return out.clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# Whole pipelines
# ---------------------------------------------------------------------------

class AugmentDraws(NamedTuple):
    crop: CropDraws
    color: ColorDraws
    flip: torch.Tensor            # [B] bool


def draw_augment(generator: torch.Generator, batch: int,
                 cfg) -> AugmentDraws:
    """Every random value of :func:`preprocess_for_train` for ``batch``
    images, on the generator's device."""
    return AugmentDraws(draw_crop(generator, batch, cfg),
                        draw_color(generator, batch, cfg),
                        _uniform(generator, (batch,), 0.0, 1.0) < 0.5)


def preprocess_for_train(draws: AugmentDraws, images: torch.Tensor,
                         gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                         gt_mask: torch.Tensor, cfg,
                         box_scale: Optional[torch.Tensor] = None) -> Batch:
    """Canvas images [B, H, W, 3] float RGB in [0, 255] -> augmented
    examples at ``cfg.image_size``, whitened, with the gt boxes, labels and
    mask moved into the crop frame (and mirrored with the image)."""
    crop = sample_distorted_box(draws.crop, gt_boxes, gt_mask, cfg, box_scale)
    boxes, mask = transform_boxes_to_crop(
        gt_boxes, gt_mask, crop, min_center_coverage=cfg.box_keep_coverage)
    img = crop_and_resize(images, crop, cfg.image_size)
    img = distort_color(draws.color, img / 255.0) * 255.0
    img = torch.where(_per_image(draws.flip), img.flip(2), img)
    boxes = torch.where(draws.flip[:, None, None],
                        box_ops.flip_boxes_horizontal(boxes), boxes)
    boxes = torch.where(mask[..., None], boxes, 0.0)
    img = img - img.new_tensor(cfg.pixel_means)
    return {"image": img, "gt_boxes": boxes,
            "gt_labels": torch.where(mask, gt_labels, 0), "gt_mask": mask}


def _take_rows(draws, rows: slice):
    """``draws`` (nested named tuples of tensors, batch-leading) at
    ``rows``."""
    if isinstance(draws, torch.Tensor):
        return draws[rows]
    return type(draws)(*(_take_rows(d, rows) for d in draws))


def preprocess_batch_for_train(generator: torch.Generator, batch: Batch,
                               cfg, shard: Tuple[int, int] = (0, 1)) -> Batch:
    """Train preprocessing of a batch of canvases with draws from
    ``generator``. A ``box_scale`` entry confines the crops to the letterbox
    content; a ``difficult`` entry passes through (gt rows keep their
    slots). With ``shard = (rank, world)``, ``batch`` is the rank's rows of
    a global batch ``world`` times its size: the draws are the global
    batch's, and the rank applies its rows of them, so the ranks together
    augment as one device augments the whole batch."""
    rank, world = shard
    b = batch["image"].shape[0]
    with profiling.span("augment"):
        draws = _take_rows(draw_augment(generator, b * world, cfg),
                           slice(rank * b, (rank + 1) * b))
        out = preprocess_for_train(draws, batch["image"], batch["gt_boxes"],
                                   batch["gt_labels"], batch["gt_mask"], cfg,
                                   batch.get("box_scale"))
    if "difficult" in batch:
        out["difficult"] = batch["difficult"]
    return out


def preprocess_for_eval(images: torch.Tensor, cfg) -> torch.Tensor:
    """Resize to the square eval size and whiten: [..., H, W, 3] uint8 or
    float -> [..., S, S, 3] float32 minus ``cfg.pixel_means`` (RGB), on the
    images' device, with S = ``cfg.image_size`` (``cfg`` is a DataConfig).
    Images of another size than S x S go through the full-image bilinear
    ``crop_and_resize``; canvas-size images skip it."""
    s = cfg.image_size
    if tuple(images.shape[-3:-1]) != (s, s):
        lead, (h, w, c) = images.shape[:-3], images.shape[-3:]
        flat = images.reshape(-1, h, w, c)
        full = torch.tensor([0.0, 0.0, 1.0, 1.0], device=images.device
                            ).expand(flat.shape[0], 4)
        images = crop_and_resize(flat, full, s).reshape(*lead, s, s, c)
    means = torch.tensor(cfg.pixel_means, dtype=torch.float32,
                         device=images.device)
    return images.float() - means
