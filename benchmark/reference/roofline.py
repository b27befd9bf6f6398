"""The benchmark's yardstick for work: the H100's data-sheet peaks, the
least time a kernel's work could take, the hand kernels' operations and
bytes, and the FLOPs of a whole batch or step counted on the plain
reference at the cell's shapes.

Frozen from the port's ``utils/roofline.py`` (peaks, ``bound_ms``, the
grouped-conv backward formula) and its kernels' ``work`` functions
(``ops/fused_sepconv.work``, ``ops/psroi_align.work``). The FLOPs are
counted on ``nets`` (meta tensors, no device work), so a kernel the
program fuses or removes leaves the count unchanged.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.reference import nets

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12


def bound_ms(flop: float, nbytes: float, flop_per_s: float) -> float:
    """The least ms: the larger of the bytes at HBM's rate and the
    operations at ``flop_per_s``."""
    return max(nbytes / HBM_BYTES_PER_S, flop / flop_per_s) * 1e3


def sepconv_work(b: int, h: int, w: int, cin: int, cout: int,
                 residual: bool) -> Tuple[float, float]:
    """B2 (``xdt::fused_sepconv``), one call: 2 P Cin (9 + Cout) operations;
    bf16 x, out and residual, bf16 wp, fp32 taps, scale and bias, each
    moved once."""
    p = b * h * w
    flop = 2.0 * p * cin * (9 + cout)
    nbytes = (p * (cin + cout + (cout if residual else 0)) * 2
              + cin * cout * 2 + 9 * cin * 4 + 2 * cout * 4)
    return flop, nbytes


def psroi_work(b: int, r: int, kkc: int, map_bytes: int,
               samples: int = 2) -> Tuple[float, float]:
    """B1's forward or backward (``xdt::psroi_align_fwd`` / ``_bwd``): per
    fp32 bin, samples^2 bilinear points of 4 multiply-adds; the map read or
    written once, the fp32 bins and the rois once."""
    bins = b * r * kkc
    return (bins * samples * samples * 4 * 2.0,
            map_bytes + b * r * 16 + bins * 4)


def sepconv_calls(cfg: dict, batch: int) -> List[Tuple[int, ...]]:
    """(B, H, W, Cin, Cout, residual) of every stride-1 separable block of
    an Xception-lite forward: the calls the fused route takes."""
    size = cfg["image_size"] // 4
    calls = []
    for _, cin, feat, units, stride, _ in nets.xception_stages(cfg):
        for unit in range(units):
            s = stride if unit == 0 else 1
            if s == 2:
                size = -(-size // 2)
            else:
                calls.append((batch, size, size, cin, feat, False))
            calls.append((batch, size, size, feat, feat, True))
            cin = feat
    return calls


def sepconv_bound_ms(cfg: dict, batch: int) -> float:
    return sum(bound_ms(*sepconv_work(*c), BF16_TENSOR_FLOP_PER_S)
               for c in sepconv_calls(cfg, batch))


def psroi_bwd_bound_ms(cfg: dict, batch: int, rois: int,
                       grad_bytes: int = 2) -> float:
    """B1's backward at a step: the map's gradient in the compute dtype."""
    side = -(-cfg["image_size"] // 16)
    kkc = cfg["thin_channels"]
    return bound_ms(*psroi_work(batch, rois, kkc,
                                batch * side * side * kkc * grad_bytes),
                    FP32_FLOP_PER_S)


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, bias, stride,
                        padding, dilation, transposed, output_padding,
                        groups, output_mask, out_shape=None, **kw) -> int:
    """A conv's backward: each gradient asked for costs the forward's
    2 N Cout Ho Wo (Cin / groups) kh kw (the counter's own formula leaves
    the groups out)."""
    per = 2 * math.prod(grad_out_shape) * math.prod(w_shape[1:])
    return per * (int(output_mask[0]) + int(output_mask[1]))


def _meta_params(cfg: dict, grad: bool) -> Dict[str, torch.Tensor]:
    return {n: torch.empty(s, device="meta", requires_grad=grad and
                           k in ("kernel", "bias", "bn_weight", "bn_bias"))
            for n, s, k in nets.param_spec(cfg)}


def _network(net, cfg: dict, batch: int, rois: int):
    s = cfg["image_size"]
    x = torch.empty(batch, s, s, 3, device="meta")
    feats = nets.backbone(net, x, cfg)
    if cfg["family"] == "ssd":
        return list(nets.ssd_heads(net, feats, cfg))
    rc, rl = nets.rpn_head(net, feats["c4"])
    thin = nets.thin_map(net, feats["c5"])
    k = cfg["roi_grid"]
    c = cfg["thin_channels"] // (k * k)
    # the pooled bins stand in for PSROIAlign (a gather: no products)
    pooled = torch.empty(batch, rois, k, k, c, device="meta") + (
        thin.sum() * 0)
    hc, hb = nets.roi_head(net, pooled)
    return [rc, rl, hc, hb]


def count_flops(cfg: dict, batch: int, rois: int, train: bool) -> float:
    """Product FLOPs of the reference's forward (and with ``train`` its
    backward) at these shapes; elementwise work counts none."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flop})
    net = nets.Net(_meta_params(cfg, train), train=train)
    with counter:
        if train:
            outs = _network(net, cfg, batch, rois)
            sum(o.float().sum() for o in outs).backward()
        else:
            with torch.no_grad():
                _network(net, cfg, batch, rois)
    return float(counter.get_total_flops())
