"""Synthetic detection data: class-coloured rectangles on noise.

The port of ``x_detector_tpu/data/synthetic.py``: the same batch schema as
the real pipeline, raw RGB in [0, 255] before whitening.

  image [B, S, S, 3] float32, gt_boxes [B, G, 4] normalized corners
  (zero-padded), gt_labels [B, G] int32 (0 on padding), gt_mask [B, G] bool
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

# 20 visually distinct class colours (r, g, b)
_CLASS_COLORS = np.array([
    [220, 20, 60], [0, 128, 0], [0, 0, 205], [255, 215, 0], [255, 105, 180],
    [0, 206, 209], [255, 140, 0], [128, 0, 128], [154, 205, 50], [70, 130, 180],
    [210, 105, 30], [0, 255, 127], [219, 112, 147], [100, 149, 237],
    [189, 183, 107], [205, 92, 92], [60, 179, 113], [186, 85, 211],
    [244, 164, 96], [176, 196, 222]], np.float32)


def synthetic_example(rng: np.random.Generator, image_size: int,
                      max_gt: int, max_objects: int = 6,
                      num_classes: int = 20) -> Dict[str, np.ndarray]:
    img = rng.uniform(0, 60, (image_size, image_size, 3)).astype(np.float32)
    n = int(rng.integers(1, max_objects + 1))
    boxes = np.zeros((max_gt, 4), np.float32)
    labels = np.zeros((max_gt,), np.int32)
    mask = np.zeros((max_gt,), bool)
    for i in range(min(n, max_gt)):
        cls = int(rng.integers(0, num_classes))
        h = rng.uniform(0.15, 0.5)
        w = rng.uniform(0.15, 0.5)
        cy = rng.uniform(h / 2, 1 - h / 2)
        cx = rng.uniform(w / 2, 1 - w / 2)
        y0, x0 = cy - h / 2, cx - w / 2
        y1, x1 = cy + h / 2, cx + w / 2
        py0, px0 = int(y0 * image_size), int(x0 * image_size)
        py1 = max(int(y1 * image_size), py0 + 2)
        px1 = max(int(x1 * image_size), px0 + 2)
        img[py0:py1, px0:px1] = _CLASS_COLORS[cls] + rng.normal(
            0, 8, (py1 - py0, px1 - px0, 3)).astype(np.float32)
        boxes[i] = [y0, x0, y1, x1]
        labels[i] = cls + 1  # 0 is background
        mask[i] = True
    np.clip(img, 0, 255, out=img)
    return {"image": img, "gt_boxes": boxes, "gt_labels": labels,
            "gt_mask": mask}


def synthetic_batches(seed: int, batch_size: int, image_size: int,
                      max_gt: int = 100, num_classes: int = 20
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless numpy batches (host side; the JAX package's generator)."""
    rng = np.random.default_rng(seed)
    while True:
        exs = [synthetic_example(rng, image_size, max_gt,
                                 num_classes=num_classes)
               for _ in range(batch_size)]
        yield {k: np.stack([e[k] for e in exs]) for k in exs[0]}


def synthetic_batch_device(generator: torch.Generator, batch_size: int,
                           image_size: int, max_gt: int = 100,
                           num_classes: int = 20,
                           max_objects: int = 6) -> Dict[str, torch.Tensor]:
    """One synthetic batch made on the generator's device, with no host
    work: 1 to ``max_objects`` class-coloured boxes per image (the same
    task family as :func:`synthetic_example`)."""
    dev = generator.device
    b, s, g = batch_size, image_size, max_gt

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    img = uniform(b, s, s, 3) * 60.0
    n = torch.randint(1, max_objects + 1, (b,), generator=generator,
                      device=dev)
    mask = torch.arange(g, device=dev)[None, :] < n.clamp(max=g)[:, None]
    h = uniform(b, g) * 0.35 + 0.15
    w = uniform(b, g) * 0.35 + 0.15
    cy = uniform(b, g) * (1 - h) + h / 2
    cx = uniform(b, g) * (1 - w) + w / 2
    boxes = torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2],
                        dim=-1)
    labels = torch.randint(1, num_classes + 1, (b, g), generator=generator,
                           device=dev)
    boxes = torch.where(mask[..., None], boxes, 0.0)
    labels = torch.where(mask, labels, 0).to(torch.int32)

    centres = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    yy, xx = centres[None, :, None], centres[None, None, :]
    noise = torch.randn((b, s, s, 3), generator=generator, device=dev) * 8.0
    palette = torch.from_numpy(_CLASS_COLORS[:num_classes]).to(dev)
    for i in range(min(max_objects, g)):
        box = boxes[:, i, :, None, None]                        # [B, 4, 1, 1]
        inside = ((yy >= box[:, 0]) & (yy < box[:, 2]) & (xx >= box[:, 1])
                  & (xx < box[:, 3]) & mask[:, i, None, None])  # [B, S, S]
        color = palette[(labels[:, i].long() - 1).clamp_min(0)]  # [B, 3]
        img = torch.where(inside[..., None], color[:, None, None, :] + noise,
                          img)
    return {"image": img.clamp(0.0, 255.0), "gt_boxes": boxes,
            "gt_labels": labels, "gt_mask": mask}
