"""The benchmark's traffic images: class-coloured boxes on noise, made on
the generator's device.

A frozen copy of the port's ``data/synthetic.synthetic_batch_device``
(the JAX package's synthetic task family), so that a change to the
program cannot change what the benchmark feeds it.

  image [B, S, S, 3] float32 in [0, 255], gt_boxes [B, G, 4] normalized
  corners (zero-padded), gt_labels [B, G] int32 (0 on padding), gt_mask
  [B, G] bool
"""

from __future__ import annotations

from typing import Dict

import torch

CLASS_COLORS = (
    (220, 20, 60), (0, 128, 0), (0, 0, 205), (255, 215, 0), (255, 105, 180),
    (0, 206, 209), (255, 140, 0), (128, 0, 128), (154, 205, 50),
    (70, 130, 180), (210, 105, 30), (0, 255, 127), (219, 112, 147),
    (100, 149, 237), (189, 183, 107), (205, 92, 92), (60, 179, 113),
    (186, 85, 211), (244, 164, 96), (176, 196, 222))


def batch(generator: torch.Generator, batch_size: int, image_size: int,
          max_gt: int = 100, num_classes: int = 20,
          max_objects: int = 6) -> Dict[str, torch.Tensor]:
    """One batch, 1 to ``max_objects`` boxes an image, on the generator's
    device."""
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
    palette = torch.tensor(CLASS_COLORS[:num_classes], dtype=torch.float32,
                           device=dev)
    for i in range(min(max_objects, g)):
        box = boxes[:, i, :, None, None]
        inside = ((yy >= box[:, 0]) & (yy < box[:, 2]) & (xx >= box[:, 1])
                  & (xx < box[:, 3]) & mask[:, i, None, None])
        color = palette[(labels[:, i].long() - 1).clamp_min(0)]
        img = torch.where(inside[..., None], color[:, None, None, :] + noise,
                          img)
    return {"image": img.clamp(0.0, 255.0), "gt_boxes": boxes,
            "gt_labels": labels, "gt_mask": mask}


def images_u8(generator: torch.Generator, batch_size: int,
              image_size: int) -> torch.Tensor:
    """A batch's images as the uint8 pixels a client sends."""
    img = batch(generator, batch_size, image_size)["image"]
    return img.round().to(torch.uint8)
