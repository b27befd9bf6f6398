"""Backbone factory (the port of ``make_backbone`` from
``x_detector_tpu/models/ssd.py``; the SSD head itself is ported later)."""

from __future__ import annotations

import torch

from x_detector_tpu_torch.models.xception import XceptionLite


def make_backbone(cfg, dilate_c5: bool,
                  dtype: torch.dtype = torch.bfloat16) -> XceptionLite:
    """Backbone module for a ModelConfig, honoring ``backbone_stages``,
    ``backbone_widths`` and ``backbone_fused_sepconv`` (None = the family
    defaults). ``backbone_remat_stages`` only changes training and has no
    effect here."""
    if cfg.backbone == "resnet50":
        if cfg.backbone_fused_sepconv:
            raise ValueError(
                "backbone_fused_sepconv applies to xception_lite only "
                "(ResNet has no separable convs); refusing to ignore it")
        raise NotImplementedError("the ResNet-50 backbone is ported in a "
                                  "later PR")
    if cfg.backbone != "xception_lite":
        raise ValueError(f"unknown backbone {cfg.backbone!r}")
    kw = {}
    if cfg.backbone_stages is not None:
        kw["units_per_stage"] = tuple(cfg.backbone_stages)
    if cfg.backbone_widths is not None:
        kw["widths"] = tuple(cfg.backbone_widths)
    return XceptionLite(dilate_c5=dilate_c5,
                        fused_sepconv=cfg.backbone_fused_sepconv,
                        quant=cfg.backbone_quant, dtype=dtype, **kw)
