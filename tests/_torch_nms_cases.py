"""Inputs and a sequential oracle for ``xdt::nms_suppress``, shared by the
CPU tests (``test_torch_nms.py``) and the card tests
(``test_torch_cuda_kernels.py``). Imports neither JAX nor the port.

Every input is what ``ops/nms.nms_padded`` hands the operator: boxes
[R, N, 4] fp32 ``[ymin, xmin, ymax, xmax]``, each row in descending score
order, its invalid boxes zero.
"""

import numpy as np

F32 = np.float32


def cluttered_rows(rng, rows, n, invalid=0.2, clusters=8):
    """[rows, n, 4] fp32: boxes around a few centres per row, so that many
    overlap near every threshold, in a random (score) order, a share
    ``invalid`` of them zero."""
    centers = rng.uniform(0.1, 0.9, (rows, clusters, 2))
    which = rng.integers(0, clusters, (rows, n))
    c = np.take_along_axis(centers, which[..., None], axis=1)
    c = c + rng.normal(0, 0.03, (rows, n, 2))
    hw = rng.uniform(0.05, 0.25, (rows, n, 2))
    boxes = np.concatenate([c - hw / 2, c + hw / 2], -1).astype(F32)
    boxes[rng.uniform(size=(rows, n)) < invalid] = 0.0
    return boxes


def edge_rows(thr, per_side=12, apart=False, seed=0):
    """Rows of one pair (box a, then box b nested in it) whose fp32 IoU is
    the fp32 threshold itself or one ulp either side of it, ``per_side``
    rows each: a decision on them moves with any change of the IoU's
    rounding or of the threshold's precision. With ``apart`` the pair sits
    at 10 and 100 of 130 slots (other blocks of the kernel's mask, zero
    boxes between), else at 0 and 1 of 2."""
    rng = np.random.default_rng(seed)
    t = F32(thr)
    n = 200_000
    a = np.zeros((n, 4), F32)
    a[:, 2] = rng.uniform(0.5, 1.0, n)
    a[:, 3] = rng.uniform(0.5, 1.0, n)
    b = a.copy()
    width = (a[:, 3] * t).astype(F32)
    b[:, 3] = (width.view(np.int32)
               + rng.integers(-3, 4, n).astype(np.int32)).view(F32)
    v = iou_matrix(np.stack([a, b], 1))[:, 0, 1]
    picked = []
    for target in (np.nextafter(t, F32(0)), t, np.nextafter(t, F32(2))):
        hit = np.nonzero(v == target)[0]
        assert len(hit) >= per_side, (thr, target, len(hit))
        picked.extend(hit[:per_side])
    picked = np.asarray(picked)
    slots, (i, j) = (130, (10, 100)) if apart else (2, (0, 1))
    rows = np.zeros((len(picked), slots, 4), F32)
    rows[:, i], rows[:, j] = a[picked], b[picked]
    return rows


def iou_matrix(boxes):
    """[..., N, 4] -> [..., N, N] fp32 IoU with ``ops/boxes.iou``'s
    operations in its order, each rounded to fp32 by numpy."""
    a, b = boxes[..., :, None, :], boxes[..., None, :, :]
    zero = F32(0)
    with np.errstate(all="ignore"):       # NaN and infinite coordinates
        h = np.maximum(np.minimum(a[..., 2], b[..., 2])
                       - np.maximum(a[..., 0], b[..., 0]), zero)
        w = np.maximum(np.minimum(a[..., 3], b[..., 3])
                       - np.maximum(a[..., 1], b[..., 1]), zero)
        inter = h * w
        area = (np.maximum(boxes[..., 2] - boxes[..., 0], zero)
                * np.maximum(boxes[..., 3] - boxes[..., 1], zero))
        union = (area[..., :, None] + area[..., None, :]) - inter
        return np.where(union > 0, inter / np.maximum(union, F32(1e-8)),
                        zero).astype(F32)


def greedy_flags(boxes, thr):
    """Sequential greedy NMS of each row, box by box: t is suppressed when
    a kept box before it has IoU above the fp32 threshold. [R, N] bool."""
    over = iou_matrix(boxes) > F32(thr)
    rows, n = boxes.shape[:2]
    flags = np.zeros((rows, n), bool)
    for t in range(1, n):
        flags[:, t] = (over[:, :t, t] & ~flags[:, :t]).any(axis=1)
    return flags
