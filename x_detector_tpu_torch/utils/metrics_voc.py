"""Pascal VOC detection mAP (Girshick-derived ``voc_eval`` semantics).

Rebuilds SURVEY.md §2.6 E1: per class, match detections to ground truth at
IoU >= 0.5 greedily in score order; each gt matches at most one detection
(extra matches are false positives); *difficult* gt are excluded from the
denominator and matches to them count neither way.  AP via the VOC07
11-point metric (``use_07_metric=True``) or the continuous
every-point-interpolation metric.

Pure numpy, host-side: a copy of ``x_detector_tpu/utils/metrics_voc.py``,
kept here so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import collections
import warnings
from typing import Dict, List, Tuple

import numpy as np


def voc_ap(recall: np.ndarray, precision: np.ndarray,
           use_07_metric: bool = True) -> float:
    """AP from a PR curve (points sorted by ascending recall)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = precision[recall >= t].max() if (recall >= t).any() else 0.0
            ap += p / 11.0
        return float(ap)
    # continuous: precision envelope, sum over recall steps
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())


def _iou_one_to_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    if boxes.size == 0:
        return np.zeros((0,), np.float32)
    iy = np.maximum(0.0, np.minimum(box[2], boxes[:, 2]) -
                    np.maximum(box[0], boxes[:, 0]))
    ix = np.maximum(0.0, np.minimum(box[3], boxes[:, 3]) -
                    np.maximum(box[1], boxes[:, 1]))
    inter = iy * ix
    a = max(0.0, box[2] - box[0]) * max(0.0, box[3] - box[1])
    b = (np.maximum(0.0, boxes[:, 2] - boxes[:, 0]) *
         np.maximum(0.0, boxes[:, 3] - boxes[:, 1]))
    union = a + b - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def add_batch(ev: "VOCEvaluator", raw, detections,
              batch_index: int = 0) -> None:
    """Register a batch with ``ev``: each image's ground truth (``raw``'s
    numpy ``gt_boxes``, ``gt_labels`` and ``gt_mask``, and ``difficult``
    where present) and its valid detections (``detections``: numpy boxes,
    scores, classes and valid, with at least as many rows as ``raw``),
    under ``raw``'s ``image_id`` where present, else "b{batch_index}_i{i}".
    """
    boxes, scores, classes, valid = detections
    for i in range(len(raw["gt_mask"])):
        if "image_id" in raw:
            iid = raw["image_id"][i]
            image_id = iid.decode() if isinstance(iid, bytes) else str(iid)
        else:
            image_id = f"b{batch_index}_i{i}"
        m = raw["gt_mask"][i]
        diff = raw["difficult"][i][m] if "difficult" in raw else None
        ev.add_ground_truth(image_id, raw["gt_boxes"][i][m],
                            raw["gt_labels"][i][m], diff)
        v = valid[i]
        ev.add_detections(image_id, boxes[i][v], scores[i][v], classes[i][v])


class VOCEvaluator:
    """Accumulates per-image gt + detections; computes per-class AP / mAP.

    Ground truth:  add_ground_truth(image_id, boxes [G,4], labels [G],
                   difficult [G] bool)
    Detections:    add_detections(image_id, boxes [D,4], scores [D],
                   labels [D])
    Boxes are corner-format in any consistent coordinate system.
    Class label 0 is background and ignored.
    """

    def __init__(self, num_classes: int, iou_threshold: float = 0.5,
                 use_07_metric: bool = True):
        self.num_classes = num_classes          # real classes, 1..num_classes
        self.iou_threshold = iou_threshold
        self.use_07_metric = use_07_metric
        self._gt: Dict[Tuple[str, int], Dict[str, np.ndarray]] = {}
        self._gt_images: set = set()
        self._det_images: set = set()
        self._dets: Dict[int, List[Tuple[str, float, np.ndarray]]] = (
            collections.defaultdict(list))
        self._npos = np.zeros(num_classes + 1, np.int64)

    def add_ground_truth(self, image_id: str, boxes, labels,
                         difficult=None) -> None:
        if image_id in self._gt_images:
            # Re-registering an image would overwrite the (image, class) gt
            # entry yet increment the recall denominator again, silently
            # depressing mAP (e.g. an eval loop over a repeating iterator).
            warnings.warn(f"duplicate ground truth for image {image_id!r} "
                          "ignored (already registered)")
            return
        self._gt_images.add(image_id)
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        labels = np.asarray(labels, np.int64).reshape(-1)
        difficult = (np.zeros(len(labels), bool) if difficult is None
                     else np.asarray(difficult, bool).reshape(-1))
        for cls in np.unique(labels):
            if cls == 0:
                continue
            sel = labels == cls
            self._gt[(image_id, int(cls))] = {
                "boxes": boxes[sel], "difficult": difficult[sel]}
            self._npos[int(cls)] += int((~difficult[sel]).sum())

    def add_detections(self, image_id: str, boxes, scores, labels) -> None:
        if image_id in self._det_images:
            # Re-appending an image's detections double-counts them as
            # false positives (each duplicate overlaps an already-matched
            # gt), silently depressing precision; but dropping a SECOND
            # call would silently lose data from a per-class registration
            # loop.  Neither silence is safe -> raise.  Pass every class's
            # detections for an image in ONE call.
            raise ValueError(
                f"detections for image {image_id!r} already registered; "
                "pass all of an image's detections (all classes) in one "
                "add_detections call")
        self._det_images.add(image_id)
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        scores = np.asarray(scores, np.float32).reshape(-1)
        labels = np.asarray(labels, np.int64).reshape(-1)
        for b, s, l in zip(boxes, scores, labels):
            if l == 0 or s < 0:
                continue
            self._dets[int(l)].append((image_id, float(s), b))

    def evaluate(self) -> Dict[str, object]:
        aps: Dict[int, float] = {}
        for cls in range(1, self.num_classes + 1):
            dets = sorted(self._dets.get(cls, []), key=lambda d: -d[1])
            npos = self._npos[cls]
            if npos == 0 and not dets:
                continue
            tp = np.zeros(len(dets))
            fp = np.zeros(len(dets))
            # fresh matched flags per evaluate() call
            matched: Dict[str, np.ndarray] = {}
            for i, (img_id, _score, box) in enumerate(dets):
                gt = self._gt.get((img_id, cls))
                if gt is None or len(gt["boxes"]) == 0:
                    fp[i] = 1
                    continue
                ious = _iou_one_to_many(box, gt["boxes"])
                j = int(np.argmax(ious))
                if ious[j] >= self.iou_threshold:
                    if gt["difficult"][j]:
                        continue            # neither tp nor fp
                    m = matched.setdefault(img_id,
                                           np.zeros(len(gt["boxes"]), bool))
                    if not m[j]:
                        tp[i] = 1
                        m[j] = True
                    else:
                        fp[i] = 1           # duplicate detection
                else:
                    fp[i] = 1
            ctp = np.cumsum(tp)
            cfp = np.cumsum(fp)
            recall = ctp / max(npos, 1)
            precision = ctp / np.maximum(ctp + cfp, 1e-9)
            aps[cls] = voc_ap(recall, precision, self.use_07_metric)
        mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
        return {"mAP": mean_ap, "per_class_ap": aps}
