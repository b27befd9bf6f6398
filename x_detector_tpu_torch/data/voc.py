"""Pascal VOC on-disk format: XML annotation parsing and the label map.

The port of ``x_detector_tpu/data/voc.py`` (a copy: the port imports nothing
of the JAX package). Parses ``Annotations/*.xml`` (name, bndbox
xmin/ymin/xmax/ymax, difficult) into normalized corner boxes with the fixed
20-class map, background 0. Standard library and numpy only.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List

import numpy as np

from x_detector_tpu_torch.config import VOC_CLASSES

VOC_LABEL_MAP: Dict[str, int] = {name: i for i, name in enumerate(VOC_CLASSES)}


def parse_annotation(xml_path: str) -> Dict[str, object]:
    """One VOC XML as normalized [ymin, xmin, ymax, xmax] boxes, labels and
    difficult flags (objects of other classes are left out)."""
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    width = float(size.find("width").text)
    height = float(size.find("height").text)
    boxes: List[List[float]] = []
    labels: List[int] = []
    difficult: List[bool] = []
    for obj in root.findall("object"):
        name = obj.find("name").text.strip().lower()
        if name not in VOC_LABEL_MAP:
            continue
        bb = obj.find("bndbox")
        # VOC pixel coords are 1-based inclusive
        xmin = (float(bb.find("xmin").text) - 1.0) / width
        ymin = (float(bb.find("ymin").text) - 1.0) / height
        xmax = (float(bb.find("xmax").text) - 1.0) / width
        ymax = (float(bb.find("ymax").text) - 1.0) / height
        boxes.append([max(ymin, 0.0), max(xmin, 0.0),
                      min(ymax, 1.0), min(xmax, 1.0)])
        labels.append(VOC_LABEL_MAP[name])
        d = obj.find("difficult")
        difficult.append(bool(int(d.text)) if d is not None else False)
    return {
        "filename": root.find("filename").text,
        "width": int(width), "height": int(height),
        "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
        "labels": np.asarray(labels, np.int32),
        "difficult": np.asarray(difficult, bool),
    }


def list_split(voc_root: str, year: str, split: str) -> List[str]:
    """Image ids of a split, e.g. (VOCdevkit, '2007', 'trainval')."""
    path = os.path.join(voc_root, f"VOC{year}", "ImageSets", "Main",
                        f"{split}.txt")
    with open(path) as f:
        return [line.split()[0] for line in f if line.strip()]


def example_paths(voc_root: str, year: str, image_id: str) -> Dict[str, str]:
    base = os.path.join(voc_root, f"VOC{year}")
    return {
        "image": os.path.join(base, "JPEGImages", f"{image_id}.jpg"),
        "annotation": os.path.join(base, "Annotations", f"{image_id}.xml"),
    }


# Canonical VOC split sizes, for sanity checks only.
CANONICAL_SPLIT_SIZES = {
    ("2007", "trainval"): 5011,
    ("2007", "test"): 4952,
    ("2012", "trainval"): 11540,
}
