"""SSD-style single-shot detector (the SSD / X-Det family), inference, and
the backbone factory both families share.

The port of ``x_detector_tpu/models/ssd.py``: backbone c3/c4/c5 at strides
8, 16 and 32 (c5 undilated), extra stride-2 blocks for strides 64 and 128,
optionally the X-Det top-down fusion (1x1 laterals, nearest 2x upsampling,
3x3 fuse convs), then per level a 3x3 ConvBN and sibling 3x3 class / box
convs. Outputs are flattened NHWC (row, col, anchor) level by level, the
order of ``ops.anchors.ssd_anchors``. Module names are flax's, so
``utils.convert`` maps the JAX tree unchanged.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from x_detector_tpu_torch.models.layers import ConvBN, conv2d
from x_detector_tpu_torch.models.resnet import ResNetV1
from x_detector_tpu_torch.models.xception import XceptionLite
from x_detector_tpu_torch.ops import anchors as anchor_lib

EXTRA_MID, EXTRA_OUT = 256, 512     # extra{i}a and extra{i}b widths
FPN_WIDTH = 256                     # lateral and fuse widths
HEAD_MID = 256                      # head/inter{i} width


def make_backbone(cfg, dilate_c5: bool, dtype: torch.dtype = torch.bfloat16
                  ) -> Union[ResNetV1, XceptionLite]:
    """Backbone module for a ModelConfig, honoring ``backbone_stages``
    (ResNet's ``stage_sizes``, Xception's ``units_per_stage``),
    ``backbone_widths`` and ``backbone_fused_sepconv`` (None = the family
    defaults). ``backbone_remat_stages`` asks for a recompute in the
    backward: inference ignores it, as the JAX package does, and the train
    step refuses it (``train.trainer.check_no_remat``). Both backbones
    expose ``feature_widths``, the channels of c3, c4 and c5."""
    kw = {}
    if cfg.backbone_stages is not None:
        kw["stage_sizes" if cfg.backbone == "resnet50"
           else "units_per_stage"] = tuple(cfg.backbone_stages)
    if cfg.backbone_widths is not None:
        kw["widths"] = tuple(cfg.backbone_widths)
    if cfg.backbone == "resnet50":
        if cfg.backbone_fused_sepconv:
            raise ValueError(
                "backbone_fused_sepconv applies to xception_lite only "
                "(ResNet has no separable convs); refusing to ignore it")
        return ResNetV1(dilate_c5=dilate_c5, quant=cfg.backbone_quant,
                        dtype=dtype, **kw)
    if cfg.backbone != "xception_lite":
        raise ValueError(f"unknown backbone {cfg.backbone!r}")
    return XceptionLite(dilate_c5=dilate_c5,
                        fused_sepconv=cfg.backbone_fused_sepconv,
                        quant=cfg.backbone_quant, dtype=dtype, **kw)


class SSDHead(nn.Module):
    """Per level: ``inter{i}`` (3x3 ConvBN), then sibling SAME 3x3 convs
    with biases, ``cls{i}`` (A x classes) and ``loc{i}`` (A x 4)."""

    def __init__(self, in_widths: List[int], num_classes: int,
                 anchors_per_cell: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        for i, cin in enumerate(in_widths):
            self.add_module(f"inter{i}", ConvBN(cin, HEAD_MID, (3, 3),
                                                dtype=dtype))
            self.add_module(f"cls{i}", nn.Conv2d(
                HEAD_MID, anchors_per_cell * num_classes, 3))
            self.add_module(f"loc{i}", nn.Conv2d(
                HEAD_MID, anchors_per_cell * 4, 3))

    def forward(self, feats: List[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cls_out, loc_out = [], []
        for i, f in enumerate(feats):
            h = getattr(self, f"inter{i}")(f)
            b = f.shape[0]
            for name, width, out in (("cls", self.num_classes, cls_out),
                                     ("loc", 4, loc_out)):
                y = conv2d(h, getattr(self, f"{name}{i}"), "SAME", self.dtype)
                out.append(y.permute(0, 2, 3, 1).reshape(b, -1, width))
        return torch.cat(cls_out, dim=1), torch.cat(loc_out, dim=1)


class SSDModel(nn.Module):
    """Backbone + extra layers + (with ``fpn_fusion``, the X-Det variant)
    top-down fusion + SSD head. ``forward`` returns fp32 (class_logits
    [B, N, C+1], box_codes [B, N, 4]) in the order of the ``anchors``
    buffer, ``build_ssd_anchors(config)``."""

    def __init__(self, config, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cfg = self.config = config
        self.backbone = make_backbone(cfg, dilate_c5=False, dtype=dtype)
        widths = self.backbone.feature_widths
        level_widths = [widths["c3"], widths["c4"], widths["c5"]]
        self.num_extras = len(cfg.ssd_anchors.strides) - 3
        cin = widths["c5"]
        for i in range(self.num_extras):
            self.add_module(f"extra{i}a", ConvBN(cin, EXTRA_MID, (1, 1),
                                                 dtype=dtype))
            self.add_module(f"extra{i}b", ConvBN(
                EXTRA_MID, EXTRA_OUT, (3, 3), strides=(2, 2), dtype=dtype))
            level_widths.append(EXTRA_OUT)
            cin = EXTRA_OUT
        self.levels = len(level_widths)
        if cfg.fpn_fusion:
            for i, w in enumerate(level_widths):
                self.add_module(f"lateral{i}", ConvBN(w, FPN_WIDTH, (1, 1),
                                                      dtype=dtype))
            for i in range(self.levels):
                self.add_module(f"fuse{i}", ConvBN(FPN_WIDTH, FPN_WIDTH,
                                                   (3, 3), dtype=dtype))
            level_widths = [FPN_WIDTH] * self.levels
        self.head = SSDHead(level_widths, cfg.num_classes,
                            cfg.ssd_anchors.anchors_per_cell, dtype=dtype)
        self.register_buffer("anchors", torch.from_numpy(
            build_ssd_anchors(cfg)), persistent=False)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``images``: preprocessed [B, S, S, 3] float, NHWC."""
        feats = self.backbone(images)
        pyramid = [feats["c3"], feats["c4"], feats["c5"]]
        x = feats["c5"]
        for i in range(self.num_extras):
            x = getattr(self, f"extra{i}b")(getattr(self, f"extra{i}a")(x))
            pyramid.append(x)
        if self.config.fpn_fusion:
            laterals = [getattr(self, f"lateral{i}")(f)
                        for i, f in enumerate(pyramid)]
            for i in range(self.levels - 2, -1, -1):
                th, tw = laterals[i].shape[2:]
                up = F.interpolate(laterals[i + 1], scale_factor=2,
                                   mode="nearest")[:, :, :th, :tw]
                laterals[i] = laterals[i] + up
            pyramid = [getattr(self, f"fuse{i}")(f)
                       for i, f in enumerate(laterals)]
        cls_logits, box_codes = self.head(pyramid)
        if cls_logits.shape[1] != self.anchors.shape[0]:
            raise ValueError(f"head anchors {cls_logits.shape[1]} != grid "
                             f"{self.anchors.shape[0]}")
        return cls_logits.float(), box_codes.float()


def build_ssd_anchors(config) -> np.ndarray:
    """[N, 4] anchors of a ModelConfig's SSD grid."""
    return anchor_lib.ssd_anchors(config.image_size, config.ssd_anchors)
