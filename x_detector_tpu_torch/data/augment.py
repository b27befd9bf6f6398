"""Eval-time preprocessing (the port of ``preprocess_for_eval`` from
``x_detector_tpu/data/augment.py``; training augmentation comes later)."""

from __future__ import annotations

import torch


def preprocess_for_eval(images: torch.Tensor, cfg) -> torch.Tensor:
    """Whiten canvas-size images: [..., S, S, 3] uint8 or float -> float32
    minus ``cfg.pixel_means`` (RGB), on the images' device. ``cfg`` is a
    DataConfig; S must be ``cfg.image_size``."""
    if tuple(images.shape[-3:-1]) != (cfg.image_size, cfg.image_size):
        raise NotImplementedError(
            f"images of {tuple(images.shape[-3:-1])} need a resize to "
            f"{cfg.image_size}: crop_and_resize is ported with training")
    means = torch.tensor(cfg.pixel_means, dtype=torch.float32,
                         device=images.device)
    return images.float() - means
