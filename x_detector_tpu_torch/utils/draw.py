"""Draw detection boxes onto images: the port of
``x_detector_tpu/utils/draw.py``.

PIL-based; used by the predict CLI.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from x_detector_tpu_torch.config import VOC_CLASSES

_PALETTE = [
    (230, 25, 75), (60, 180, 75), (0, 130, 200), (255, 225, 25),
    (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
    (210, 245, 60), (250, 190, 190), (0, 128, 128), (230, 190, 255),
    (170, 110, 40), (255, 250, 200), (128, 0, 0), (170, 255, 195),
    (128, 128, 0), (255, 215, 180), (0, 0, 128), (128, 128, 128),
]


def draw_detections(image: np.ndarray, boxes: np.ndarray,
                    scores: np.ndarray, classes: np.ndarray,
                    valid: Optional[np.ndarray] = None,
                    class_names: Sequence[str] = VOC_CLASSES,
                    score_threshold: float = 0.0) -> np.ndarray:
    """image uint8/float [H, W, 3]; boxes normalized corners. Returns uint8."""
    from PIL import Image, ImageDraw

    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    pil = Image.fromarray(img)
    d = ImageDraw.Draw(pil)
    h, w = img.shape[:2]
    n = len(boxes)
    for i in range(n):
        if valid is not None and not valid[i]:
            continue
        if scores[i] < score_threshold:
            continue
        cls = int(classes[i])
        color = _PALETTE[(cls - 1) % len(_PALETTE)]
        y0, x0, y1, x1 = boxes[i]
        rect = [x0 * w, y0 * h, x1 * w, y1 * h]
        d.rectangle(rect, outline=color, width=2)
        name = (class_names[cls] if 0 <= cls < len(class_names)
                else str(cls))
        d.text((rect[0] + 2, rect[1] + 2), f"{name}:{scores[i]:.2f}",
               fill=color)
    return np.asarray(pil)
