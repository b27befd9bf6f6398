"""Exact greedy non-max suppression, batched over rows, in plain PyTorch.

The port of ``x_detector_tpu/ops/nms.py`` (static small-pool branch). Every
function takes a leading batch of independent rows (images, or image x class
pairs) and runs them together:

  1. Boxes below the score floor are zeroed and scored -1: a zero-area box
     has IoU 0 with everything, so it can neither suppress nor survive.
  2. The suppressed flags of the score-sorted boxes come from one operator,
     ``xdt::nms_suppress`` (``ops/library.py``): exact sequential greedy
     NMS, a box suppressed when a kept box before it has IoU above the
     threshold. Its CPU implementation is the plain version
     (:func:`suppress_plain`): tiles of ``TILE`` boxes walked in order, a
     tile suppressed against the surviving earlier boxes (suppressed ones
     were zeroed, so they drop out), then against itself by the
     Gauss-Jacobi fixpoint of ``S[t] = any_{j<t}(~S[j] & IoU[j,t] > thr)``,
     whose unique solution is sequential greedy NMS. The fixpoint runs for
     all rows at once until no row changes, one host sync per few
     iterations (the operator ``xdt::self_suppress``). Its CUDA
     implementation (:func:`suppress_cuda`, ``csrc/nms.cu``) is a bitmask
     IoU kernel and a greedy scan on the card: no host sync, ``KERNELS``
     launches.
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

from x_detector_tpu_torch import _build
from x_detector_tpu_torch.ops import boxes as box_ops
from x_detector_tpu_torch.utils import profiling, roofline

TILE = 128
CHECK_EVERY = 4   # Jacobi steps between host checks for the fixpoint
WORD = 64         # boxes a word of the CUDA implementation's bit mask
MAX_BOXES = WORD * 32 * 8   # a row's words must fit the scan's registers
KERNELS = 2       # launches a call of the CUDA implementation: mask, scan
# fp32 operations of one pair's IoU and decision in the mask kernel: min,
# max, subtract and clamp on each axis, the product, the union's add and
# subtract, its max with EPS, the division and the comparison
IOU_OPS = 14


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
    syncs changes. Each call adds one to ``self_suppress.calls`` and each
    host check one to ``self_suppress.checks`` (on every device: it is no
    kernel, but a host-synced stage worth counting); a check is the span
    ``xd/nms.host_check`` while the profiler records."""
    self_suppress.calls += 1
    s = mask.any(dim=1)
    for _ in range(0, mask.shape[-1], CHECK_EVERY):
        for _ in range(CHECK_EVERY):
            prev, s = s, (mask & ~s[:, :, None]).any(dim=1)
        self_suppress.checks += 1
        with profiling.span("nms.host_check"):
            if torch.equal(s, prev):
                break
    return s


self_suppress.calls = 0
self_suppress.checks = 0


def suppress_plain(boxes: torch.Tensor,
                   iou_threshold: float) -> torch.Tensor:
    """boxes [R, N, 4] fp32, each row in descending score order with its
    invalid boxes zero -> the exact greedy suppressed flags [R, N] bool: the
    CPU implementation of ``xdt::nms_suppress``.

    Tiles of ``TILE`` boxes in order (the last may be shorter). One IoU of
    the tile against the earlier survivors and itself: a box that an
    earlier survivor suppresses is zeroed, so it has IoU 0 with everything,
    and masking its row is the same as recomputing the IoU. Then the
    tile's own fixpoint, ``xdt::self_suppress``, with its host checks."""
    boxes = boxes.clone()
    flags = torch.zeros(boxes.shape[:2], dtype=torch.bool,
                        device=boxes.device)
    tri = torch.ones(TILE, TILE, dtype=torch.bool,
                     device=boxes.device).triu(1)     # j < t
    for start in range(0, boxes.shape[1], TILE):
        tile = boxes[:, start:start + TILE]
        t = tile.shape[1]
        over = box_ops.iou(tile, boxes[:, :start + t]) > iou_threshold
        prev = over[..., :start].any(dim=-1)
        mask = over[..., start:] & tri[:t, :t] & ~prev[..., None]
        sup = torch.ops.xdt.self_suppress.default(mask) | prev
        boxes[:, start:start + t] = torch.where(sup[..., None], 0.0, tile)
        flags[:, start:start + t] = sup
    return flags


def suppress_cuda(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """``xdt::nms_suppress`` on a CUDA tensor: checks what the kernels take
    (raising on anything else: there is no fallback), then the mask and
    scan kernels of ``csrc/nms.cu`` on the current stream, with the
    threshold in fp32, as PyTorch compares an fp32 IoU with a Python
    float. The scratch (the mask, ``R * N * ceil(N / 64) * 8`` bytes, and a
    word of live rows a block) is freed on return; the caching allocator
    keeps it for the next call on the stream. No host sync. Adds
    ``KERNELS`` to ``nms_suppress.launches``, one a kernel launched, as
    the benchmark's trace counts kernels under the operator."""
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_suppress: boxes on {boxes.device}; the CUDA "
                         "implementation needs a CUDA tensor")
    if boxes.dtype != torch.float32:
        raise TypeError(f"nms_suppress: boxes must be fp32, got "
                        f"{boxes.dtype}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"nms_suppress: boxes must be [R, N, 4], got "
                         f"{tuple(boxes.shape)}")
    if not boxes.is_contiguous():
        raise ValueError("nms_suppress: boxes must be contiguous")
    rows, n = boxes.shape[:2]
    if n > MAX_BOXES:
        raise ValueError(f"nms_suppress: {n} boxes a row; the kernel takes "
                         f"at most {MAX_BOXES}")
    flags = torch.empty((rows, n), dtype=torch.bool, device=boxes.device)
    if flags.numel() == 0:
        return flags
    words = -(-n // WORD)
    scratch = torch.empty(rows * (n + 1) * words, dtype=torch.int64,
                          device=boxes.device)
    _build.launch("xdt_nms_suppress", "nms_suppress", boxes,
                  boxes.data_ptr(), scratch.data_ptr(), flags.data_ptr(),
                  rows, n, iou_threshold)
    nms_suppress.launches += KERNELS
    return flags


def bound_ms(boxes: torch.Tensor):
    """``roofline.bound_ms``'s (least ms, what binds) of exact NMS over
    ``boxes`` [R, N, 4]: the boxes read and the flags written, against the
    IoU of every pair of a row, ``R * N (N - 1) / 2`` pairs of ``IOU_OPS``
    fp32 operations, each one instruction, at half the fp32 peak
    (which counts an fma as two). The mask is the design's scratch, not
    the function's work, and is not counted."""
    rows, n = boxes.shape[:2]
    ops = rows * n * (n - 1) / 2 * IOU_OPS
    return roofline.bound_ms(ops, boxes.numel() * 4 + rows * n,
                             roofline.FP32_FLOP_PER_S / 2)


def nms_suppress(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """The exact greedy suppressed flags [R, N] of score-sorted boxes
    [R, N, 4] (invalid boxes zero): ``xdt::nms_suppress``, the plain
    version on the CPU, the kernels on the card. ``launches`` counts the
    CUDA implementation's kernels, ``KERNELS`` a call."""
    return torch.ops.xdt.nms_suppress.default(boxes, float(iou_threshold))


nms_suppress.launches = 0


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
    keep = scores > score_threshold
    boxes = torch.where(keep[..., None], boxes, 0.0).float()
    scores = torch.where(keep, scores, -1.0).float()
    if not presorted:
        scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
        boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))

    boxes = boxes.contiguous()
    sup = nms_suppress(boxes, iou_threshold)
    boxes = torch.where(sup[..., None], 0.0, boxes)

    alive = (box_ops.area(boxes) > 0) & (scores > score_threshold)
    masked = torch.where(alive, scores, -1.0)
    k = min(max_output, n)
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
