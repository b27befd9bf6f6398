"""Exact greedy non-max suppression, batched over rows, in plain PyTorch.

The port of ``x_detector_tpu/ops/nms.py`` (static small-pool branch). Every
function takes a leading batch of independent rows (images, or image x class
pairs) and runs them together:

  1. Boxes below the score floor are zeroed and scored -1: a zero-area box
     has IoU 0 with everything, so it can neither suppress nor survive.
  2. Tiles of ``TILE`` score-sorted boxes are walked in order. A tile is
     suppressed against the surviving earlier boxes (suppressed ones were
     zeroed, so they drop out), then against itself by the Gauss-Jacobi
     fixpoint of ``S[t] = any_{j<t}(~S[j] & IoU[j,t] > thr)``. The recurrence
     has a unique solution, so the fixpoint is exact sequential greedy NMS.
     The fixpoint runs for all rows at once until no row changes: one host
     sync per few iterations, not one per row. It is the operator
     ``xdt::self_suppress`` (``ops/library.py``), so that an exported
     program runs the same host-checked loop as eager code.
  3. Survivors keep their scores, the rest get -1, and a stable descending
     sort keeps the first ``max_output``. Ties go to the lower index, as
     ``lax.top_k`` breaks them (``torch.topk`` gives no tie order on CUDA).

Contracts kept from the JAX package: scores are non-negative and -1 marks an
invalid slot; invalid boxes are zero; class ids are 1-based and 0 when
invalid.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from x_detector_tpu_torch.ops import boxes as box_ops

TILE = 128
CHECK_EVERY = 4   # Jacobi steps between host checks for the fixpoint


class NMSResult(NamedTuple):
    boxes: torch.Tensor    # [..., K, 4]
    scores: torch.Tensor   # [..., K] (-1 for invalid slots)
    valid: torch.Tensor    # [..., K] bool


class MulticlassNMSResult(NamedTuple):
    boxes: torch.Tensor    # [B, K, 4]
    scores: torch.Tensor   # [B, K]
    classes: torch.Tensor  # [B, K] int32 (1-based class ids; 0 on invalid)
    valid: torch.Tensor    # [B, K] bool


def topk_stable(x: torch.Tensor, k: int):
    """Descending top-k along the last dim, ties toward the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def self_suppress(mask: torch.Tensor) -> torch.Tensor:
    """mask [R, T, T] bool, True where row j suppresses column t (j < t).
    Returns the exact greedy suppressed flags [R, T]: the implementation of
    ``xdt::self_suppress`` on every device.

    Jacobi steps run in groups of ``CHECK_EVERY`` between host checks for a
    fixpoint: steps past the fixpoint leave it unchanged, and T steps always
    reach it (flag t is final after t steps), so only the number of host
    syncs changes. Each call adds one to ``self_suppress.calls`` (on every
    device: it is no kernel, but a host-synced stage worth counting)."""
    self_suppress.calls += 1
    s = mask.any(dim=1)
    for _ in range(0, mask.shape[-1], CHECK_EVERY):
        for _ in range(CHECK_EVERY):
            prev, s = s, (mask & ~s[:, :, None]).any(dim=1)
        if torch.equal(s, prev):
            break
    return s


self_suppress.calls = 0


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, max_output: int,
               iou_threshold: float = 0.5, score_threshold: float = 0.0,
               presorted: bool = False) -> NMSResult:
    """Exact greedy NMS over rows: [R, N, 4] / [R, N] -> [R, max_output].

    A single set ([N, 4] / [N]) is accepted too. ``presorted=True`` promises
    that each row's scores are already descending.
    """
    single = scores.dim() == 1
    if single:
        boxes, scores = boxes[None], scores[None]
    rows, n = scores.shape
    n_pad = -(-n // TILE) * TILE
    keep = scores > score_threshold
    boxes = torch.where(keep[..., None], boxes, 0.0).float()
    scores = torch.where(keep, scores, -1.0).float()
    if n_pad > n:
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, n_pad - n))
        scores = torch.nn.functional.pad(scores, (0, n_pad - n), value=-1.0)
    if not presorted:
        scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
        boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))

    tri = torch.ones(TILE, TILE, dtype=torch.bool,
                     device=boxes.device).triu(1)     # j < t
    for start in range(0, n_pad, TILE):
        tile = boxes[:, start:start + TILE]
        # One IoU against the earlier survivors and the tile itself. A box
        # that an earlier survivor suppresses is zeroed, so it has IoU 0 with
        # everything: masking its row is the same as recomputing the IoU.
        over = box_ops.iou(tile, boxes[:, :start + TILE]) > iou_threshold
        prev = over[..., :start].any(dim=-1)
        mask = over[..., start:] & tri & ~prev[..., None]
        sup = torch.ops.xdt.self_suppress.default(mask) | prev
        boxes[:, start:start + TILE] = torch.where(sup[..., None], 0.0, tile)

    alive = (box_ops.area(boxes) > 0) & (scores > score_threshold)
    masked = torch.where(alive, scores, -1.0)
    k = min(max_output, n_pad)
    out_scores, top_idx = topk_stable(masked, k)
    out_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    if k < max_output:
        out_boxes = torch.nn.functional.pad(out_boxes,
                                            (0, 0, 0, max_output - k))
        out_scores = torch.nn.functional.pad(out_scores, (0, max_output - k),
                                             value=-1.0)
    valid = out_scores > score_threshold
    out_boxes = torch.where(valid[..., None], out_boxes, 0.0)
    if single:
        return NMSResult(out_boxes[0], out_scores[0], valid[0])
    return NMSResult(out_boxes, out_scores, valid)


def batched_multiclass_nms(boxes: torch.Tensor, class_scores: torch.Tensor,
                           max_output: int, iou_threshold: float = 0.45,
                           score_threshold: float = 0.01,
                           per_class_topk: int = 100,
                           nms_candidates: int = 256,
                           approx_prefilter: bool = False
                           ) -> MulticlassNMSResult:
    """Per-class NMS then a global top-k merge, for a batch of images.

    ``boxes``: [B, N, 4] shared by all classes, or [B, N, C, 4] per class;
    ``class_scores``: [B, N, C] probabilities of the C real classes. Each
    class keeps its ``nms_candidates`` best boxes before suppression. All
    B x C (image, class) rows go through one batched ``nms_padded``.

    ``approx_prefilter`` asks the JAX package for ``lax.approx_max_k`` in
    place of ``lax.top_k`` when it draws the candidates. XLA lowers
    ``approx_max_k`` to an exact top-k on every backend but the TPU, so the
    exact stable top-k taken here either way is what the reference itself
    computes off the TPU.
    """
    del approx_prefilter
    b, n, c = class_scores.shape
    if boxes.dim() == 3:
        boxes = boxes[:, :, None, :].expand(b, n, c, 4)
    row_boxes = boxes.permute(0, 2, 1, 3).reshape(b * c, n, 4)
    row_scores = class_scores.permute(0, 2, 1).reshape(b * c, n)
    presorted = n > nms_candidates
    if presorted:
        row_scores, idx = topk_stable(row_scores, nms_candidates)
        row_boxes = torch.gather(row_boxes, 1,
                                 idx[..., None].expand(-1, -1, 4))
    res = nms_padded(row_boxes, row_scores, per_class_topk, iou_threshold,
                     score_threshold, presorted=presorted)
    flat_boxes = res.boxes.reshape(b, c * per_class_topk, 4)
    flat_scores = res.scores.reshape(b, c * per_class_topk)
    cls_ids = torch.arange(1, c + 1, dtype=torch.int32,
                           device=flat_scores.device
                           ).repeat_interleave(per_class_topk)
    k = min(max_output, flat_scores.shape[1])
    top_scores, top_idx = topk_stable(flat_scores, k)
    if k < max_output:
        top_scores = torch.nn.functional.pad(top_scores, (0, max_output - k),
                                             value=-1.0)
        top_idx = torch.nn.functional.pad(top_idx, (0, max_output - k))
    valid = top_scores > score_threshold
    return MulticlassNMSResult(
        boxes=torch.gather(flat_boxes, 1,
                           top_idx[..., None].expand(-1, -1, 4)),
        scores=torch.where(valid, top_scores, -1.0),
        classes=torch.where(valid, cls_ids[top_idx],
                            torch.zeros((), dtype=torch.int32,
                                        device=valid.device)),
        valid=valid,
    )


def multiclass_nms(boxes: torch.Tensor, class_scores: torch.Tensor,
                   max_output: int, **kwargs) -> MulticlassNMSResult:
    """One image: [N, 4] or [N, C, 4] boxes, [N, C] scores -> [max_output]."""
    res = batched_multiclass_nms(boxes[None], class_scores[None], max_output,
                                 **kwargs)
    return MulticlassNMSResult(*(t[0] for t in res))
