"""Writes ``voc_mini/``: a VOCdevkit of six small synthetic JPEGs (colour
rectangles on smooth gradients; one greyscale, one without chroma
subsampling) with their XML annotations and ``trainval.txt``, and
``voc_mini_pixels.npz``, the RGB pixels libjpeg decodes from each (PIL's
decoder), for machines whose loader decodes with another library.

    python -m x_detector_tpu_torch.data.testdata.make_voc_mini

Needs PIL; the files it wrote are committed, so readers of the tree do
not. ``write_voc_tree`` makes a VOCdevkit of photo-sized images on the spot
(500 x 375, 4:2:0, as VOC2007's photos are) to time the loader on.
"""

from __future__ import annotations

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# (height, width, JPEG mode, quality, chroma subsampling: 2 = 4:2:0, 0 =
# 4:4:4)
IMAGES = [(72, 96, "RGB", 85, 2), (96, 72, "RGB", 85, 2),
          (90, 120, "RGB", 75, 2), (80, 80, "L", 85, 2),
          (84, 112, "RGB", 95, 0), (112, 64, "RGB", 85, 2)]
CLASSES = ("dog", "cat", "person", "car", "bicycle", "bird")


def write_annotation(base: str, image_id: str, h: int, w: int,
                     objects) -> None:
    """``Annotations/<image_id>.xml`` with ``objects``: (class, x0, y0, x1,
    y1, difficult)."""
    xml = "".join(
        f"<object><name>{c}</name><difficult>{d}</difficult><bndbox>"
        f"<xmin>{x0}</xmin><ymin>{y0}</ymin><xmax>{x1}</xmax>"
        f"<ymax>{y1}</ymax></bndbox></object>"
        for c, x0, y0, x1, y1, d in objects)
    with open(os.path.join(base, "Annotations", f"{image_id}.xml"),
              "w") as f:
        f.write(f"<annotation><filename>{image_id}.jpg</filename><size>"
                f"<width>{w}</width><height>{h}</height><depth>3</depth>"
                f"</size>{xml}</annotation>\n")


def make_dirs(root: str) -> str:
    base = os.path.join(root, "VOC2007")
    for d in ("Annotations", "JPEGImages", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    return base


def random_objects(rng, h: int, w: int):
    """1-3 boxes of at least 8 px inside an h x w image."""
    objects = []
    for _ in range(int(rng.integers(1, 4))):
        x0, y0 = int(rng.integers(1, w // 2)), int(rng.integers(1, h // 2))
        x1 = int(rng.integers(x0 + 8, w))
        y1 = int(rng.integers(y0 + 8, h))
        objects.append((CLASSES[int(rng.integers(0, len(CLASSES)))],
                        x0, y0, x1, y1, int(rng.integers(0, 2))))
    return objects


def photo(rng, h: int, w: int) -> np.ndarray:
    """h x w x 3 uint8 with a photograph's spread of detail: random fields
    at 48, 8 and 2 px scales, bilinearly upsampled, plus pixel noise. At
    500 x 375 and quality 90 with 4:2:0 chroma PIL writes ~79 KB."""
    from PIL import Image
    img = np.full((h, w, 3), 128.0, np.float32)
    for cell, amp in ((48, 45), (8, 18), (2, 16)):
        small = rng.normal(128, amp, (h // cell + 2, w // cell + 2, 3))
        up = Image.fromarray(small.clip(0, 255).astype(np.uint8)).resize(
            (w, h), Image.BILINEAR)
        img += np.asarray(up, np.float32) - 128
    img += rng.normal(0, 8, (h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_voc_tree(root: str, count: int, hw=(375, 500), quality: int = 90,
                   seed: int = 0) -> None:
    """A VOCdevkit under ``root`` of ``count`` photo-like JPEGs of ``hw``
    (4:2:0 chroma) with 1-3 annotated boxes each, all in ``trainval``."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    base = make_dirs(root)
    h, w = hw
    ids = [f"{i:06d}" for i in range(count)]
    for image_id in ids:
        Image.fromarray(photo(rng, h, w)).save(
            os.path.join(base, "JPEGImages", f"{image_id}.jpg"),
            quality=quality, subsampling=2)
        write_annotation(base, image_id, h, w, random_objects(rng, h, w))
    with open(os.path.join(base, "ImageSets", "Main", "trainval.txt"),
              "w") as f:
        f.write("\n".join(ids) + "\n")


def main() -> None:
    from PIL import Image
    rng = np.random.default_rng(2026)
    base = make_dirs(os.path.join(HERE, "voc_mini"))
    ids, pixels = [], {}
    for i, (h, w, mode, quality, subsampling) in enumerate(IMAGES):
        image_id = f"{i:06d}"
        ids.append(image_id)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.stack([40 + 120 * yy / h, 60 + 100 * xx / w,
                        90 + 40 * np.sin(xx / 7.0) * np.cos(yy / 9.0)], -1)
        objects = []
        for _ in range(int(rng.integers(1, 4))):
            x0, y0 = int(rng.integers(1, w // 2)), int(rng.integers(1, h // 2))
            x1 = int(rng.integers(x0 + 8, w))
            y1 = int(rng.integers(y0 + 8, h))
            img[y0 - 1:y1, x0 - 1:x1] = rng.uniform(20, 235, 3)
            objects.append((CLASSES[int(rng.integers(0, len(CLASSES)))],
                            x0, y0, x1, y1, int(rng.integers(0, 2))))
        pil = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
        if mode == "L":
            pil = pil.convert("L")
        path = os.path.join(base, "JPEGImages", f"{image_id}.jpg")
        pil.save(path, quality=quality, subsampling=subsampling)
        pixels[image_id] = np.asarray(Image.open(path).convert("RGB"))
        write_annotation(base, image_id, h, w, objects)
    with open(os.path.join(base, "ImageSets", "Main", "trainval.txt"),
              "w") as f:
        f.write("\n".join(ids) + "\n")
    np.savez_compressed(os.path.join(HERE, "voc_mini_pixels.npz"), **pixels)


if __name__ == "__main__":
    main()
