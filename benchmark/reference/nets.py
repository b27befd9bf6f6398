"""Plain PyTorch reference of the benchmark's detectors: Light-Head R-CNN
on Xception-lite and SSD on ResNet-50, as functions of a flat parameter
dict.

Written from the architectures the configuration files describe (and
frozen from the port's plain code, which it imports nothing of): NCHW
float tensors, every conv and dense product in float32 (the caller turns
TF32 off), BatchNorm from the running statistics at inference and from
the batch's in training. No kernel, no fusion, no cache. The parameter
names are those of the program's state dict, so one seeded dict of
tensors loads into both (``param_spec``).

``cast`` is applied to both operands of every conv and dense product: the
identity for the reference, ``precision.fp8`` for the control.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.99
EXTRA_MID, EXTRA_OUT, HEAD_MID = 256, 512, 256
RESNET_STEM = 64
Params = Dict[str, torch.Tensor]
Spec = List[Tuple[str, Tuple[int, ...], str]]


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


# ---- the parameter list ----------------------------------------------------

def _conv(spec: Spec, name: str, cout: int, cin: int, kh: int, kw: int,
          bias: bool) -> None:
    spec.append((name + ".weight", (cout, cin, kh, kw), "kernel"))
    if bias:
        spec.append((name + ".bias", (cout,), "bias"))


def _bn(spec: Spec, name: str, c: int) -> None:
    for part in ("weight", "bias", "running_mean", "running_var"):
        spec.append((f"{name}.{part}", (c,), "bn_" + part))


def _conv_bn(spec: Spec, name: str, cout: int, cin: int, kh: int, kw: int,
             use_bn: bool = True) -> None:
    _conv(spec, name + ".Conv_0", cout, cin, kh, kw, bias=not use_bn)
    if use_bn:
        _bn(spec, name + ".bn", cout)


def _sep(spec: Spec, name: str, cin: int, cout: int) -> None:
    _conv(spec, name + ".Conv_0", cin, 1, 3, 3, bias=False)
    _conv(spec, name + ".Conv_1", cout, cin, 1, 1, bias=False)
    _bn(spec, name + ".bn", cout)


def xception_stages(cfg: dict) -> list:
    """Per stage (name, cin, features, units, entry stride, dilation)."""
    w, u = cfg["backbone_widths"], cfg["backbone_units"]
    dil = 2 if cfg.get("dilate_c5", True) else 1
    return [("stage1", w[0], w[0], u[0], 1, 1),
            ("stage2", w[0], w[1], u[1], 2, 1),
            ("stage3", w[1], w[2], u[2], 2, 1),
            ("stage4", w[2], w[3], u[3], 1 if dil == 2 else 2, dil)]


def _xception_spec(spec: Spec, cfg: dict) -> None:
    _conv_bn(spec, "backbone.stem", cfg["backbone_widths"][0], 12, 12, 3)
    for stage, cin, feat, units, stride, _ in xception_stages(cfg):
        for unit in range(units):
            s = stride if unit == 0 else 1
            if s != 1 or cin != feat:
                _conv_bn(spec, f"backbone.{stage}.proj{unit}", feat, cin, 1, 1)
            _sep(spec, f"backbone.{stage}.sep{unit}a", cin, feat)
            _sep(spec, f"backbone.{stage}.sep{unit}b", feat, feat)
            cin = feat


def resnet_blocks(cfg: dict) -> list:
    """Per block (name, cin, width, stride, dilation), and the stage ends."""
    blocks, cin = [], RESNET_STEM
    sizes, widths = cfg["backbone_units"], cfg["backbone_widths"]
    last = len(sizes) - 1
    for stage, (n, width) in enumerate(zip(sizes, widths)):
        if stage == 0:
            stride, dil = 1, 1
        elif stage == last and cfg.get("dilate_c5", False):
            stride, dil = 1, 2
        else:
            stride, dil = 2, 1
        for b in range(n):
            blocks.append((f"stage{stage + 1}_block{b}", cin, width,
                           stride if b == 0 else 1, dil, stage))
            cin = width * 4
    return blocks


def _resnet_spec(spec: Spec, cfg: dict) -> None:
    _conv_bn(spec, "backbone.stem", RESNET_STEM, 3, 7, 7)
    for name, cin, width, stride, _, _ in resnet_blocks(cfg):
        out = width * 4
        if cin != out or stride != 1:
            _conv_bn(spec, f"backbone.{name}.proj", out, cin, 1, 1)
        _conv_bn(spec, f"backbone.{name}.ConvBN_0", width, cin, 1, 1)
        _conv_bn(spec, f"backbone.{name}.ConvBN_1", width, width, 3, 3)
        _conv_bn(spec, f"backbone.{name}.ConvBN_2", out, width, 1, 1)


def feature_widths(cfg: dict) -> Dict[str, int]:
    w = cfg["backbone_widths"]
    if cfg["backbone"] == "resnet50":
        return {"c3": 4 * w[1], "c4": 4 * w[2], "c5": 4 * w[3]}
    return {"c3": w[1], "c4": w[2], "c5": w[3]}


def num_anchors(cfg: dict) -> int:
    a = cfg["anchors"]
    return len(a["scales"]) * len(a["ratios"])


def param_spec(cfg: dict) -> Spec:
    """Every tensor of the model's state dict: (name, shape, kind), in a
    fixed order; kind is kernel, bias or bn_<part>."""
    spec: Spec = []
    (_resnet_spec if cfg["backbone"] == "resnet50" else _xception_spec)(
        spec, cfg)
    fw = feature_widths(cfg)
    nc = cfg["num_classes"]
    if cfg["family"] == "lighthead":
        mid, a = cfg["rpn_mid"], num_anchors(cfg)
        _conv_bn(spec, "rpn.conv", mid, fw["c4"], 3, 3, use_bn=False)
        _conv(spec, "rpn.cls", 2 * a, mid, 1, 1, True)
        _conv(spec, "rpn.loc", 4 * a, mid, 1, 1, True)
        k, m, out = (cfg["large_sep_kernel"], cfg["large_sep_mid"],
                     cfg["thin_channels"])
        _conv(spec, "thin_map.col_a", m, fw["c5"], k, 1, True)
        _conv(spec, "thin_map.col_b", out, m, 1, k, True)
        _conv(spec, "thin_map.row_a", m, fw["c5"], 1, k, True)
        _conv(spec, "thin_map.row_b", out, m, k, 1, True)
        hd = cfg["head_dim"]
        spec.append(("roi_head.fc.weight", (hd, out), "kernel"))
        spec.append(("roi_head.fc.bias", (hd,), "bias"))
        spec.append(("roi_head.cls.weight", (nc, hd), "kernel"))
        spec.append(("roi_head.cls.bias", (nc,), "bias"))
        spec.append(("roi_head.box.weight", (4, hd), "kernel"))
        spec.append(("roi_head.box.bias", (4,), "bias"))
        return spec
    widths = [fw["c3"], fw["c4"], fw["c5"]]
    cin = fw["c5"]
    for i in range(len(cfg["ssd_anchors"]["strides"]) - 3):
        _conv_bn(spec, f"extra{i}a", EXTRA_MID, cin, 1, 1)
        _conv_bn(spec, f"extra{i}b", EXTRA_OUT, EXTRA_MID, 3, 3)
        widths.append(EXTRA_OUT)
        cin = EXTRA_OUT
    per_cell = len(cfg["ssd_anchors"]["ratios"]) + 1
    for i, w in enumerate(widths):
        _conv_bn(spec, f"head.inter{i}", HEAD_MID, w, 3, 3)
        _conv(spec, f"head.cls{i}", per_cell * nc, HEAD_MID, 3, 3, True)
        _conv(spec, f"head.loc{i}", per_cell * 4, HEAD_MID, 3, 3, True)
    return spec


# ---- layers ----------------------------------------------------------------

def same_pads(size, kernel, stride, dilation):
    """XLA "SAME": the odd pixel of padding goes after."""
    pads = []
    for n, k, s, d in zip(size, kernel, stride, dilation):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


class Net:
    """The functional layers over ``params``; ``train`` selects batch
    statistics for BatchNorm (whose running stats then move in
    ``self.stats``, never in ``params``)."""

    def __init__(self, params: Params, cast: Callable = identity,
                 train: bool = False):
        self.p, self.cast, self.train = params, cast, train
        self.stats: Params = {}

    def conv(self, name: str, x: torch.Tensor, stride=1, pads="SAME",
             dilation=1, groups=1) -> torch.Tensor:
        w = self.p[name + ".weight"]
        b = self.p.get(name + ".bias")
        stride = tuple(stride) if isinstance(stride, tuple) else (stride,) * 2
        dilation = (dilation,) * 2
        if pads == "SAME":
            pads = same_pads(x.shape[2:], w.shape[2:], stride, dilation)
        (t, bt), (l, r) = pads
        if t == bt and l == r:
            padding = (t, l)
        else:
            x, padding = F.pad(x, (l, r, t, bt)), 0
        return F.conv2d(self.cast(x), self.cast(w), b, stride, padding,
                        dilation, groups)

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        if self.train:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            m = BN_MOMENTUM
            with torch.no_grad():
                self.stats[name + ".running_mean"] = (
                    m * self.p[name + ".running_mean"] + (1 - m) * mean)
                self.stats[name + ".running_var"] = (
                    m * self.p[name + ".running_var"] + (1 - m) * var)
        else:
            mean = self.p[name + ".running_mean"]
            var = self.p[name + ".running_var"]
        inv = w * torch.rsqrt(var + BN_EPS)
        return x * inv[None, :, None, None] + (b - mean * inv)[None, :, None,
                                                                 None]

    def conv_bn(self, name: str, x: torch.Tensor, stride=1, pads="SAME",
                dilation=1, relu=True, use_bn=True) -> torch.Tensor:
        y = self.conv(name + ".Conv_0", x, stride, pads, dilation)
        if use_bn:
            y = self.bn(name + ".bn", y)
        return F.relu(y) if relu else y

    def sep(self, name: str, x: torch.Tensor, stride=1, dilation=1,
            relu=True, residual=None) -> torch.Tensor:
        y = self.conv(name + ".Conv_0", x, stride, "SAME", dilation,
                      groups=x.shape[1])
        y = self.bn(name + ".bn", self.conv(name + ".Conv_1", y))
        if residual is not None:
            return F.relu(y + residual)
        return F.relu(y) if relu else y

    def dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.cast(x), self.cast(self.p[name + ".weight"]),
                        self.p[name + ".bias"])


# ---- backbones -------------------------------------------------------------

def xception(net: Net, images: torch.Tensor, cfg: dict) -> Dict[str,
                                                                 torch.Tensor]:
    """[B, H, W, 3] -> {"c3", "c4", "c5"} NCHW: the channel-folded
    12 x 3 / (4, 1) stem, then four stages of residual separable units."""
    b, h, w, _ = images.shape
    x = images.reshape(b, h, w // 4, 12).permute(0, 3, 1, 2)
    x = net.conv_bn("backbone.stem", x, stride=(4, 1), pads=((4, 4), (1, 1)))
    feats = {}
    for stage, cin, feat, units, stride, dil in xception_stages(cfg):
        for unit in range(units):
            s = stride if unit == 0 else 1
            pre = f"backbone.{stage}"
            if s != 1 or cin != feat:
                shortcut = net.conv_bn(f"{pre}.proj{unit}", x, stride=s,
                                       relu=False)
            else:
                shortcut = x
            y = net.sep(f"{pre}.sep{unit}a", x, stride=s, dilation=dil)
            x = net.sep(f"{pre}.sep{unit}b", y, dilation=dil, relu=False,
                        residual=shortcut)
            cin = feat
        feats[stage] = x
    return {"c3": feats["stage2"], "c4": feats["stage3"],
            "c5": feats["stage4"]}


def resnet(net: Net, images: torch.Tensor, cfg: dict) -> Dict[str,
                                                               torch.Tensor]:
    """[B, H, W, 3] -> {"c3", "c4", "c5"}: 7 x 7 / 2 stem, 3 x 3 / 2 max
    pool, v1 bottlenecks."""
    x = net.conv_bn("backbone.stem", images.permute(0, 3, 1, 2), stride=2,
                    pads=((3, 3), (3, 3)))
    x = F.max_pool2d(x, 3, 2, padding=1)
    feats = {}
    for name, cin, width, stride, dil, stage in resnet_blocks(cfg):
        pre = f"backbone.{name}"
        shortcut = (net.conv_bn(pre + ".proj", x, stride=stride, relu=False)
                    if cin != width * 4 or stride != 1 else x)
        y = net.conv_bn(pre + ".ConvBN_0", x)
        y = net.conv_bn(pre + ".ConvBN_1", y, stride=stride,
                        pads=((dil, dil), (dil, dil)), dilation=dil)
        y = net.conv_bn(pre + ".ConvBN_2", y, relu=False)
        x = F.relu(y + shortcut)
        if stage >= 1:
            feats[f"c{stage + 2}"] = x
    return feats


def backbone(net: Net, images: torch.Tensor, cfg: dict):
    fn = resnet if cfg["backbone"] == "resnet50" else xception
    return fn(net, images, cfg)


# ---- heads -----------------------------------------------------------------

def rpn_head(net: Net, c4: torch.Tensor):
    """c4 -> (objectness [B, A, 2], box codes [B, A, 4]) in (row, col,
    anchor) order."""
    b = c4.shape[0]
    h = net.conv_bn("rpn.conv", c4, use_bn=False)
    cls = net.conv("rpn.cls", h).permute(0, 2, 3, 1).reshape(b, -1, 2)
    loc = net.conv("rpn.loc", h).permute(0, 2, 3, 1).reshape(b, -1, 4)
    return cls, loc


def thin_map(net: Net, c5: torch.Tensor) -> torch.Tensor:
    """relu((k x 1 then 1 x k) + (1 x k then k x 1)), SAME, biases."""
    a = net.conv("thin_map.col_b", net.conv("thin_map.col_a", c5))
    b = net.conv("thin_map.row_b", net.conv("thin_map.row_a", c5))
    return F.relu(a + b)


def roi_head(net: Net, pooled: torch.Tensor):
    """pooled [B, R, k, k, C] -> (class logits [B, R, classes], box codes
    [B, R, 4])."""
    b, r = pooled.shape[:2]
    h = F.relu(net.dense("roi_head.fc", pooled.reshape(b, r, -1)))
    return net.dense("roi_head.cls", h), net.dense("roi_head.box", h)


def ssd_heads(net: Net, feats: Dict[str, torch.Tensor], cfg: dict):
    """Backbone features -> extras -> per level (class logits, box codes),
    flattened NHWC level by level."""
    pyramid = [feats["c3"], feats["c4"], feats["c5"]]
    x = feats["c5"]
    for i in range(len(cfg["ssd_anchors"]["strides"]) - 3):
        x = net.conv_bn(f"extra{i}b", net.conv_bn(f"extra{i}a", x), stride=2)
        pyramid.append(x)
    cls_out, loc_out = [], []
    nc = cfg["num_classes"]
    for i, f in enumerate(pyramid):
        h = net.conv_bn(f"head.inter{i}", f)
        b = f.shape[0]
        cls_out.append(net.conv(f"head.cls{i}", h).permute(0, 2, 3, 1)
                       .reshape(b, -1, nc))
        loc_out.append(net.conv(f"head.loc{i}", h).permute(0, 2, 3, 1)
                       .reshape(b, -1, 4))
    return torch.cat(cls_out, dim=1), torch.cat(loc_out, dim=1)


def preprocess_eval(images_u8: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Canvas-size uint8 [B, S, S, 3] -> float32 minus the pixel means."""
    s = cfg["image_size"]
    if tuple(images_u8.shape[1:3]) != (s, s):
        raise ValueError(f"the reference takes {s} x {s} canvases, got "
                         f"{tuple(images_u8.shape)}")
    means = torch.tensor(cfg["pixel_means"], dtype=torch.float32,
                         device=images_u8.device)
    return images_u8.float() - means


def fan_in(shape: Tuple[int, ...]) -> int:
    """A conv kernel's [O, I, kh, kw] or a dense [O, I] fan-in."""
    return math.prod(shape[1:])
