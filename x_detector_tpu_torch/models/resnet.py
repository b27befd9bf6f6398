"""ResNet v1 backbone (ResNet-50 by default), inference and training.

The port of ``x_detector_tpu/models/resnet.py``: a 7x7/2 stem, a 3x3/2 max
pool, then bottleneck stages [3, 4, 6, 3] whose blocks output 4 x their
width. The last stage runs at stride 16 with dilation 2 when ``dilate_c5``
(the two-stage detectors' thin map stays at stride 16), else at stride 32
(SSD). The stem and the 3x3s pad symmetrically ("EXPLICIT"), as slim and
torchvision do; the 1x1 projections at stride 2 pad nothing either way.

Returns {"c3": stride 8, "c4": stride 16, "c5": stride 16 dilated (or 32)},
NCHW in channels_last memory. Block names are flax's (``stage{s}_block{b}``
holding ``proj`` and ``ConvBN_0..2``), so ``utils.convert`` maps the JAX
tree unchanged.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from x_detector_tpu_torch.models.layers import ConvBN, max_pool

STEM_WIDTH = 64


class Bottleneck(nn.Module):
    """v1 bottleneck: 1x1 -> 3x3 (stride and dilation here) -> 1x1 at 4x
    the width, plus a 1x1 projection of the shortcut when the width or the
    stride changes."""

    def __init__(self, in_features: int, features: int,
                 strides: Tuple[int, int] = (1, 1),
                 dilation: Tuple[int, int] = (1, 1), quant=None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        out = features * 4
        common = dict(quant=quant, dtype=dtype)
        if in_features != out or tuple(strides) != (1, 1):
            self.proj = ConvBN(in_features, out, (1, 1), strides=strides,
                               relu=False, **common)
        else:
            self.proj = None
        self.ConvBN_0 = ConvBN(in_features, features, (1, 1), **common)
        self.ConvBN_1 = ConvBN(features, features, (3, 3), strides=strides,
                               dilation=dilation, padding="EXPLICIT", **common)
        self.ConvBN_2 = ConvBN(features, out, (1, 1), relu=False, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.proj is None else self.proj(x)
        y = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        return F.relu(y + shortcut)


class ResNetV1(nn.Module):
    """ResNet v1 feature extractor; ``stage_sizes`` and ``widths`` default
    to ResNet-50 (``ModelConfig.backbone_stages`` / ``backbone_widths``
    shrink them for tests)."""

    def __init__(self, stage_sizes: Tuple[int, ...] = (3, 4, 6, 3),
                 widths: Tuple[int, ...] = (64, 128, 256, 512),
                 dilate_c5: bool = True, quant=None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stage_sizes = tuple(stage_sizes)
        # what c3, c4 and c5 carry: each block outputs 4 x its width
        self.feature_widths = {"c3": 4 * widths[1], "c4": 4 * widths[2],
                               "c5": 4 * widths[3]}
        self.stem = ConvBN(3, STEM_WIDTH, (7, 7), strides=(2, 2),
                           padding="EXPLICIT", quant=quant, dtype=dtype)
        cin = STEM_WIDTH
        last = len(self.stage_sizes) - 1
        for stage, (n_blocks, width) in enumerate(zip(self.stage_sizes,
                                                      widths)):
            if stage == 0:
                stride, dilation = (1, 1), (1, 1)
            elif stage == last and dilate_c5:
                stride, dilation = (1, 1), (2, 2)
            else:
                stride, dilation = (2, 2), (1, 1)
            for block in range(n_blocks):
                self.add_module(f"stage{stage + 1}_block{block}", Bottleneck(
                    cin, width, strides=stride if block == 0 else (1, 1),
                    dilation=dilation, quant=quant, dtype=dtype))
                cin = width * 4

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``images``: [B, H, W, 3] NHWC."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = max_pool(self.stem(x), 3, 2, explicit_pad=True)       # s4
        feats = {}
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                x = getattr(self, f"stage{stage + 1}_block{block}")(x)
            if stage >= 1:
                feats[f"c{stage + 2}"] = x      # stage 2 -> c3, ... 4 -> c5
        return feats


def resnet50(dilate_c5: bool = True,
             dtype: torch.dtype = torch.bfloat16) -> ResNetV1:
    return ResNetV1(stage_sizes=(3, 4, 6, 3), dilate_c5=dilate_c5,
                    dtype=dtype)
