"""Xception-lite backbone (Light-Head R-CNN's small body).

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

from x_detector_tpu_torch.models.layers import (ConvBN, SeparableConvBN,
                                                remat)


class XceptionStage(nn.Module):
    """Stride-2 (or dilated) stage of residual separable-conv units."""

    def __init__(self, in_features: int, features: int, num_units: int = 2,
                 entry_stride: Tuple[int, int] = (2, 2),
                 dilation: Tuple[int, int] = (1, 1), dense: bool = False,
                 fused: bool = False, quant=None,
                 dtype: torch.dtype = torch.bfloat16):
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
                dense=dense, fused=fused, quant=quant, dtype=dtype))
            self.add_module(f"sep{unit}b", SeparableConvBN(
                features, features, dilation=dilation, relu=False,
                dense=dense, fused=fused, quant=quant, dtype=dtype))
            cin = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for unit in range(self.num_units):
            proj = getattr(self, f"proj{unit}", None)
            shortcut = x if proj is None else proj(x)
            y = getattr(self, f"sep{unit}a")(x)
            x = getattr(self, f"sep{unit}b")(y, residual=shortcut)
        return x


class XceptionLite(nn.Module):
    """Fast small backbone for Light-Head R-CNN (BASELINE config 3).

    ``dense_stages=N`` builds stage 1 (N >= 1) and stage 2 (N >= 2) of
    dense 3x3 blocks in place of separable ones (``SeparableConvBN(dense=
    True)``; no fused kernel there). ``remat_stages=N`` recomputes stages
    1..N in the backward of a training forward (``layers.remat``) instead
    of saving their activations; inference ignores it."""

    def __init__(self, widths: Tuple[int, ...] = (128, 256, 512, 1024),
                 units_per_stage: Tuple[int, ...] = (2, 2, 2, 2),
                 dilate_c5: bool = True, dense_stages: int = 0,
                 fused_sepconv: bool = False, remat_stages: int = 0,
                 quant=None, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype, self.remat_stages = dtype, remat_stages
        self.feature_widths = {"c3": widths[1], "c4": widths[2],
                               "c5": widths[3]}
        # Stem: [B,H,W,3] -> [B,H,W/4,12] (channels ordered (w mod 4, rgb)),
        # then a (12,3) conv at stride (4,1): the 12x12/stride-4 stem.
        self.stem = ConvBN(12, widths[0], (12, 3), strides=(4, 1),
                           padding=((4, 4), (1, 1)), quant=quant, dtype=dtype)
        common = dict(fused=fused_sepconv, quant=quant, dtype=dtype)
        self.stage1 = XceptionStage(widths[0], widths[0], units_per_stage[0],
                                    entry_stride=(1, 1),
                                    dense=dense_stages >= 1, **common)
        self.stage2 = XceptionStage(widths[0], widths[1], units_per_stage[1],
                                    dense=dense_stages >= 2, **common)
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

    def _stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        stage = getattr(self, f"stage{i}")
        if (i <= self.remat_stages and self.training
                and torch.is_grad_enabled()):
            return remat(stage, x)
        return stage(x)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``images``: [B, H, W, 3] NHWC, sides divisible by 4."""
        b, h, w, _ = images.shape
        if h % 4 or w % 4:
            raise ValueError(f"XceptionLite requires image sides divisible "
                             f"by 4; got {h}x{w}")
        x = images.reshape(b, h, w // 4, 12).to(self.dtype).permute(0, 3, 1, 2)
        x = self.stem(x)                                   # s4
        x = self._stage(1, x)
        c3 = self._stage(2, x)                             # s8
        c4 = self._stage(3, c3)                            # s16
        c5 = self._stage(4, c4)
        return {"c3": c3, "c4": c4, "c5": c5}
