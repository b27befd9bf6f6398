"""Xception-lite backbone (Light-Head R-CNN's small body), inference.

The port of ``x_detector_tpu/models/xception.py``: a channel-folded stride-4
stem, then four stages of residual separable units; stage 4 is dilated
(d=2) at stride 16 when ``dilate_c5``.

Returns {"c3": stride 8, "c4": stride 16, "c5": stride 16 dilated (or 32)},
NCHW in channels_last memory.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from x_detector_tpu_torch.models.layers import ConvBN, SeparableConvBN


class XceptionStage(nn.Module):
    """Stride-2 (or dilated) stage of residual separable-conv units."""

    def __init__(self, in_features: int, features: int, num_units: int = 2,
                 entry_stride: Tuple[int, int] = (2, 2),
                 dilation: Tuple[int, int] = (1, 1), fused: bool = False,
                 quant=None, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_units = num_units
        cin = in_features
        for unit in range(num_units):
            stride = tuple(entry_stride) if unit == 0 else (1, 1)
            if stride != (1, 1) or cin != features:
                self.add_module(f"proj{unit}", ConvBN(
                    cin, features, (1, 1), strides=stride, relu=False,
                    quant=quant, dtype=dtype))
            self.add_module(f"sep{unit}a", SeparableConvBN(
                cin, features, strides=stride, dilation=dilation,
                fused=fused, quant=quant, dtype=dtype))
            self.add_module(f"sep{unit}b", SeparableConvBN(
                features, features, dilation=dilation, relu=False,
                fused=fused, quant=quant, dtype=dtype))
            cin = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for unit in range(self.num_units):
            proj = getattr(self, f"proj{unit}", None)
            shortcut = x if proj is None else proj(x)
            y = getattr(self, f"sep{unit}a")(x)
            x = getattr(self, f"sep{unit}b")(y, residual=shortcut)
        return x


class XceptionLite(nn.Module):
    """Fast small backbone for Light-Head R-CNN (BASELINE config 3)."""

    def __init__(self, widths: Tuple[int, ...] = (128, 256, 512, 1024),
                 units_per_stage: Tuple[int, ...] = (2, 2, 2, 2),
                 dilate_c5: bool = True, fused_sepconv: bool = False,
                 quant=None, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.feature_widths = {"c3": widths[1], "c4": widths[2],
                               "c5": widths[3]}
        # Stem: [B,H,W,3] -> [B,H,W/4,12] (channels ordered (w mod 4, rgb)),
        # then a (12,3) conv at stride (4,1): the 12x12/stride-4 stem.
        self.stem = ConvBN(12, widths[0], (12, 3), strides=(4, 1),
                           padding=((4, 4), (1, 1)), quant=quant, dtype=dtype)
        common = dict(fused=fused_sepconv, quant=quant, dtype=dtype)
        self.stage1 = XceptionStage(widths[0], widths[0], units_per_stage[0],
                                    entry_stride=(1, 1), **common)
        self.stage2 = XceptionStage(widths[0], widths[1], units_per_stage[1],
                                    **common)
        self.stage3 = XceptionStage(widths[1], widths[2], units_per_stage[2],
                                    **common)
        if dilate_c5:
            self.stage4 = XceptionStage(widths[2], widths[3],
                                        units_per_stage[3],
                                        entry_stride=(1, 1), dilation=(2, 2),
                                        **common)
        else:
            self.stage4 = XceptionStage(widths[2], widths[3],
                                        units_per_stage[3], **common)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``images``: [B, H, W, 3] NHWC, sides divisible by 4."""
        b, h, w, _ = images.shape
        if h % 4 or w % 4:
            raise ValueError(f"XceptionLite requires image sides divisible "
                             f"by 4; got {h}x{w}")
        x = images.reshape(b, h, w // 4, 12).to(self.dtype).permute(0, 3, 1, 2)
        x = self.stem(x)                                   # s4
        x = self.stage1(x)
        c3 = self.stage2(x)                                # s8
        c4 = self.stage3(c3)                               # s16
        c5 = self.stage4(c4)
        return {"c3": c3, "c4": c4, "c5": c5}
