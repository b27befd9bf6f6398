"""Light-Head R-CNN (two-stage detector), inference and training.

The port of ``x_detector_tpu/models/lighthead.py``:
  backbone C4 -> RPN head (objectness 2A + box codes 4A per cell)
  backbone C5 -> large-separable "thin feature map" (k=15, 490 channels)
  RPN -> static proposal stage: decode, clip, min-size, top-K, exact NMS
         (or MaxpoolNMS with ``fast_nms``), padded to a fixed proposal count
  PSROIAlign(thin map, proposals, 7x7x10) -> flatten 490 -> FC 2048
      -> sibling FCs: class logits + box codes.
Public tensors keep the JAX layouts: NHWC images, [B, R, 4] normalized
boxes, pooled [B, R, k, k, C]. ``module.training`` plays JAX's ``train``:
BatchNorm uses batch statistics and the proposal stage its training budgets.
Proposals are made from detached RPN outputs, so the RPN trains only through
its own losses.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from x_detector_tpu_torch.models.layers import ConvBN, conv2d
from x_detector_tpu_torch.models.ssd import make_backbone
from x_detector_tpu_torch.ops import anchors as anchor_lib
from x_detector_tpu_torch.ops import boxes as box_ops
from x_detector_tpu_torch.ops import nms as nms_lib
from x_detector_tpu_torch.ops.maxpool_nms import rpn_maxpool_scores
from x_detector_tpu_torch.ops.psroi_align import batched_psroi_align


class LargeSeparableConv(nn.Module):
    """Thin-feature-map producer: (k x 1 then 1 x k) + (1 x k then k x 1),
    SAME, with biases, then relu(a + b)."""

    def __init__(self, in_features: int, mid: int = 256, out: int = 490,
                 k: int = 15, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.col_a = nn.Conv2d(in_features, mid, (k, 1))
        self.col_b = nn.Conv2d(mid, out, (1, k))
        self.row_a = nn.Conv2d(in_features, mid, (1, k))
        self.row_b = nn.Conv2d(mid, out, (k, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = lambda m, t: conv2d(t, m, "SAME", self.dtype)
        a = conv(self.col_b, conv(self.col_a, x))
        b = conv(self.row_b, conv(self.row_a, x))
        return F.relu(a + b)


class RPNHead(nn.Module):
    """3x3 intermediate conv (bias, ReLU) + sibling 1x1 cls/loc convs."""

    def __init__(self, in_features: int, num_anchors: int, mid: int = 512,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv = ConvBN(in_features, mid, (3, 3), use_bn=False,
                           dtype=dtype)
        self.cls = nn.Conv2d(mid, num_anchors * 2, 1)
        self.loc = nn.Conv2d(mid, num_anchors * 4, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b = x.shape[0]
        h = self.conv(x)
        # flatten in NHWC order (row, col, anchor), the order of rpn_anchors
        cls = conv2d(h, self.cls, "SAME", self.dtype).permute(0, 2, 3, 1)
        loc = conv2d(h, self.loc, "SAME", self.dtype).permute(0, 2, 3, 1)
        return (cls.reshape(b, -1, 2).float(), loc.reshape(b, -1, 4).float())


def generate_proposals(rpn_cls: torch.Tensor, rpn_loc: torch.Tensor,
                       anchors: torch.Tensor, cfg, image_size: int,
                       training: bool = False, anchor_cfg=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static proposal stage: (boxes [B,R,4], scores [B,R], valid [B,R])
    with R = ``cfg.post_nms_topk`` (training) or ``cfg.post_nms_topk_eval``
    from the top ``pre_nms_topk`` (or ``pre_nms_topk_eval``) scores, by
    exact greedy NMS.

    With ``cfg.fast_nms`` the NMS is MaxpoolNMS (``ops/maxpool_nms.py``,
    which needs ``anchor_cfg``, the grid's ``AnchorConfig``): per-scale
    local-max selection on the objectness maps, then one top-R of what
    survives; a slot whose score is 0 is invalid and its box zero."""
    scores = torch.softmax(rpn_cls, dim=-1)[..., 1]             # [B, A]
    boxes = box_ops.clip_boxes(box_ops.decode(rpn_loc, anchors[None]))
    min_sz = cfg.min_size / float(image_size)
    wh_ok = (((boxes[..., 2] - boxes[..., 0]) >= min_sz)
             & ((boxes[..., 3] - boxes[..., 1]) >= min_sz))
    scores = torch.where(wh_ok, scores, 0.0)
    k_pre = min(cfg.pre_nms_topk if training else cfg.pre_nms_topk_eval,
                scores.shape[1])
    k_post = cfg.post_nms_topk if training else cfg.post_nms_topk_eval
    if cfg.fast_nms:
        if anchor_cfg is None:
            # a silent exact-NMS fallback would report exact-path timings
            # to a caller who asked for the fast path
            raise ValueError("ProposalConfig.fast_nms=True requires "
                             "anchor_cfg (grid geometry drives MaxpoolNMS "
                             "windows); got None")
        masked = rpn_maxpool_scores(scores, anchor_cfg, image_size,
                                    cfg.nms_threshold)
        top_s, top_i = nms_lib.topk_stable(masked, k_post)
        valid = top_s > 0.0
        top_b = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
        return torch.where(valid[..., None], top_b, 0.0), top_s, valid
    top_s, top_i = nms_lib.topk_stable(scores, k_pre)
    top_b = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
    res = nms_lib.nms_padded(top_b, top_s, k_post,
                             iou_threshold=cfg.nms_threshold,
                             score_threshold=0.0, presorted=True)
    return res.boxes, res.scores, res.valid


class RoIHead(nn.Module):
    """Flatten pooled k x k x C in (i, j, c) order -> FC -> cls + box."""

    def __init__(self, in_features: int, num_classes: int,
                 head_dim: int = 2048, class_agnostic: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes, self.class_agnostic = num_classes, class_agnostic
        self.dtype = dtype
        self.fc = nn.Linear(in_features, head_dim)
        self.cls = nn.Linear(head_dim, num_classes)
        self.box = nn.Linear(head_dim,
                             4 if class_agnostic else 4 * num_classes)

    def forward(self, pooled: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, r = pooled.shape[:2]
        dense = lambda m, t: F.linear(t, m.weight.to(self.dtype),
                                      m.bias.to(self.dtype))
        flat = pooled.reshape(b, r, -1).to(self.dtype)
        h = F.relu(dense(self.fc, flat))
        cls = dense(self.cls, h)
        box = dense(self.box, h)
        if not self.class_agnostic:
            box = box.reshape(b, r, self.num_classes, 4)
        return cls.float(), box.float()


class LightHeadRCNN(nn.Module):
    """The whole two-stage pipeline; returns the same dict of outputs as
    the JAX model's ``apply(..., train=self.training)``."""

    def __init__(self, config, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cfg = self.config = config
        self.backbone = make_backbone(cfg, dilate_c5=True, dtype=dtype)
        widths = self.backbone.feature_widths
        c4_width, c5_width = widths["c4"], widths["c5"]
        self.rpn = RPNHead(c4_width, cfg.anchors.num_anchors, mid=cfg.rpn_mid,
                           dtype=dtype)
        self.thin_map = LargeSeparableConv(c5_width, mid=cfg.large_sep_mid,
                                           out=cfg.thin_channels,
                                           k=cfg.large_sep_kernel, dtype=dtype)
        self.roi_head = RoIHead(cfg.thin_channels, cfg.num_classes,
                                head_dim=cfg.head_dim,
                                class_agnostic=cfg.class_agnostic_box,
                                dtype=dtype)
        self.register_buffer("anchors", torch.from_numpy(
            anchor_lib.rpn_anchors(cfg.image_size, cfg.anchors)),
            persistent=False)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``images``: preprocessed [B, S, S, 3] float, NHWC."""
        cfg = self.config
        feats = self.backbone(images)
        rpn_cls, rpn_loc = self.rpn(feats["c4"])
        if rpn_cls.shape[1] != self.anchors.shape[0]:
            raise ValueError(f"RPN grid {rpn_cls.shape[1]} != anchors "
                             f"{self.anchors.shape[0]}")
        props, prop_scores, prop_valid = generate_proposals(
            rpn_cls.detach(), rpn_loc.detach(), self.anchors, cfg.proposals,
            cfg.image_size, training=self.training, anchor_cfg=cfg.anchors)
        thin = self.thin_map(feats["c5"])                  # [B, 490, h, w]
        # The kernel reads the bf16 map and widens it to fp32 on load: the
        # same values as casting the map to fp32 first, without the copy.
        pooled = batched_psroi_align(
            thin.permute(0, 2, 3, 1).contiguous(), props.contiguous(),
            grid=cfg.roi_grid)
        pooled = pooled * prop_valid[..., None, None, None]
        roi_cls, roi_box = self.roi_head(pooled)
        return {
            "rpn_cls": rpn_cls, "rpn_loc": rpn_loc,
            "proposals": props, "proposal_scores": prop_scores,
            "proposal_valid": prop_valid,
            "roi_cls": roi_cls, "roi_box": roi_box,
        }


def lighthead_postprocess(outputs: Dict[str, torch.Tensor],
                          config) -> nms_lib.MulticlassNMSResult:
    """Decode ROI-head boxes against their proposals, then per-class NMS."""
    probs = torch.softmax(outputs["roi_cls"], dim=-1)
    fg_probs = probs[..., 1:] * outputs["proposal_valid"][..., None]
    roi_box = outputs["roi_box"]
    if roi_box.dim() == 4:   # [B, R, C, 4] per-class: drop the background
        decoded = box_ops.decode(roi_box[:, :, 1:, :],
                                 outputs["proposals"][:, :, None, :])
    else:                    # [B, R, 4] class-agnostic
        decoded = box_ops.decode(roi_box, outputs["proposals"])
    decoded = box_ops.clip_boxes(decoded)
    ncfg = config.nms
    return nms_lib.batched_multiclass_nms(
        decoded, fg_probs, max_output=ncfg.max_output,
        iou_threshold=ncfg.iou_threshold,
        score_threshold=ncfg.score_threshold,
        approx_prefilter=ncfg.approx_prefilter)
