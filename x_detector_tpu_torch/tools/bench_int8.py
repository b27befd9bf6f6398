"""The int8 conv chain against cuDNN's bf16 conv at the backbones' dominant
shapes, on one card.

The port of the JAX package's ``tools/bench_int8.py``: at seven shapes of
config 3's Xception-lite (its pointwise 1x1 and depthwise 3x3 convs) and
config 1's ResNet-50 (its dense 3x3s), batch 16, SAME padding, stride 1,
a chain of CHAIN convs, each feeding the next, timed whole and reported a
conv:

  bf16  cuDNN's conv (``F.conv2d``, channels_last, bf16, ``groups`` the
        feature groups), as the JAX tool's bf16 chain;
  int8  the port's int8 path a conv: kernel K3 quantizes the input at a
        fixed scale (saturating, as the JAX chain's shift back into int8
        did), then K1 (dense) or K2 (depthwise, groups = C) convolves it
        to bf16 at per-channel scales: the next conv's input.

Each chain runs ROUNDS times, timed by CUDA events: the median and
the spread. K1's and K2's calls alone are timed the same way beside their
bounds (``ops.int8_conv.conv_bound_ms`` / ``depthwise_bound_ms``, bf16
out: the input pixels read, the weights and the output moved once, or the
operations at the int8 tensor rate / the fp32 rate). Every kernel is
reached through its ``xdt`` operator, which counts its launches.

  python -m x_detector_tpu_torch.tools.bench_int8
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch
import torch.nn.functional as F

from x_detector_tpu_torch.ops import int8_conv as q8
from x_detector_tpu_torch.ops.library import launch_counts, launches_since
from x_detector_tpu_torch.tools import add_device_args
from x_detector_tpu_torch.tools.fast_nms_ab import emit, resolve_harness
from x_detector_tpu_torch.utils.profiling import median_spread, rounds_ms

CHAIN, SMOKE_CHAIN = 30, 2
ROUNDS = 3                         # --smoke: 1
# (name, batch, H, W, Cin, Cout, kernel, feature groups)
SHAPES = [
    ("xc stage1 1x1 200x200x128", 16, 200, 200, 128, 128, (1, 1), 1),
    ("xc stage2 1x1 100x100x256", 16, 100, 100, 256, 256, (1, 1), 1),
    ("xc stage4 1x1 50x50x1024", 16, 50, 50, 1024, 1024, (1, 1), 1),
    ("xc stage1 dw3x3 200x200x128", 16, 200, 200, 128, 128, (3, 3), 128),
    ("xc stage4 dw3x3 50x50x1024", 16, 50, 50, 1024, 1024, (3, 3), 1024),
    ("r50 C3 3x3 100x100x128", 16, 100, 100, 128, 128, (3, 3), 1),
    ("r50 C5(dilated) 3x3 50x50x512", 16, 50, 50, 512, 512, (3, 3), 1),
]
SMOKE_SHAPES = [
    ("1x1 8x8x16", 1, 8, 8, 16, 16, (1, 1), 1),
    ("dw3x3 8x8x16", 1, 8, 8, 16, 16, (3, 3), 16),
    ("3x3 8x8x16", 1, 8, 8, 16, 16, (3, 3), 1),
]


def shape_row(name, b, h, w, cin, cout, kern, groups, chain, rounds,
              device) -> dict:
    """One shape's chains, K1's or K2's call alone and its bound."""
    gen = torch.Generator(device=device).manual_seed(0)
    dw = groups > 1
    pad = (kern[0] // 2, kern[1] // 2)
    x = torch.randn((b, h, w, cin), generator=gen,
                    device=device).to(torch.bfloat16)
    wb = (torch.randn((cout, cin // groups, *kern), generator=gen,
                      device=device) * 0.05).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    wq = torch.randint(-4, 4, (cout, *kern, cin // groups), generator=gen,
                       dtype=torch.int8, device=device)
    weight = q8.prepare_weight(wq, dw)
    scale = torch.full((cout,), 1e-2, device=device)
    sx = q8.activation_scale(x.abs().amax().float())
    pads = ((pad[0], pad[0]), (pad[1], pad[1]))
    if dw:
        conv = lambda xq: q8.int8_depthwise_conv2d(xq, weight, scale,
                                                   stride=1, dilation=1,
                                                   pads=pads)
    else:
        conv = lambda xq: q8.int8_conv2d(xq, weight, scale, stride=(1, 1),
                                         dilation=(1, 1), pads=pads)
    xc = x.permute(0, 3, 1, 2)

    def chain_bf16():
        y = xc
        for _ in range(chain):
            y = F.conv2d(y, wb, None, 1, pad, 1, groups)
        return y

    def chain_int8():
        y = x
        for _ in range(chain):
            y = conv(q8.quantize_activation(y, sx))
        return y

    xq = q8.quantize_activation(x, sx)
    before = launch_counts()
    bf16 = median_spread(rounds_ms(chain_bf16, device, rounds, 1))
    int8 = median_spread(rounds_ms(chain_int8, device, rounds, 1))
    alone = median_spread(rounds_ms(lambda: conv(xq), device, rounds, 10))
    geometry = q8.conv_geometry(kern, (1, 1), (1, 1), pads)
    bound, by = (q8.depthwise_bound_ms(b, h, w, cin, geometry, 2) if dw else
                 q8.conv_bound_ms(b, h, w, cin, cout, geometry, 2))
    flop = 2.0 * b * h * w * kern[0] * kern[1] * (cin // groups) * cout
    bf16_ms, int8_ms = bf16["median_ms"] / chain, int8["median_ms"] / chain
    return {"shape": name, "batch": b, "kernel": list(kern),
            "feature_groups": groups, "chain": chain,
            "bf16_ms": bf16_ms, "int8_ms": int8_ms,
            "speedup": bf16_ms / int8_ms,
            "bf16_tflops": flop / (bf16_ms * 1e-3) / 1e12,
            "bf16_chain_spread_ms": bf16["spread_ms"],
            "int8_chain_spread_ms": int8["spread_ms"],
            "int8_kernel": "K2" if dw else "K1",
            "kernel_ms": alone["median_ms"],
            "kernel_spread_ms": alone["spread_ms"],
            "bound_ms": bound, "bound_by": by,
            "share_of_bound": bound / alone["median_ms"],
            "launches": launches_since(before)}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_args(p)
    args = p.parse_args(argv)
    device, _, label = resolve_harness(args)
    shapes, chain, rounds = ((SMOKE_SHAPES, SMOKE_CHAIN, 1) if args.smoke
                             else (SHAPES, CHAIN, ROUNDS))
    return [emit(dict(shape_row(*s, chain, rounds, device),
                      device=label)) for s in shapes]


if __name__ == "__main__":
    main()
