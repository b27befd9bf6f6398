"""cuDNN's depthwise 3x3 in bf16 at Xception-lite's four stage shapes,
forward and backward four ways, on one card.

The port of the JAX package's ``tools/bench_depthwise.py``, which asked
what XLA charged for config 4's depthwise backward. No kernel of the port
runs here (the train step's depthwise convs are cuDNN's; B2 serves
inference only): it measures the library, at [16, 200, 200, 128],
[16, 100, 100, 256], [16, 50, 50, 512] and [16, 50, 50, 1024] (dilation 2)
in bf16, channels_last, four ways:

  fwd       the forward conv (``groups`` = C, SAME padding)
  full_bwd  the forward and both gradients (``torch.autograd.grad``)
  dx_flip   the data gradient as the forward of the flipped kernel: at
            stride 1 the same function (:func:`dx_flipped`)
  dw_only   the filter gradient alone (``torch.nn.grad.conv2d_weight``,
            grouped; the JAX tool could only estimate it as full_bwd less
            dx_flip)

each in ROUNDS rounds of REPS calls timed by CUDA events: the
median and the spread; then each way's total over the four shapes.

  python -m x_detector_tpu_torch.tools.bench_depthwise
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from x_detector_tpu_torch.tools import add_device_args
from x_detector_tpu_torch.tools.fast_nms_ab import emit, resolve_harness
from x_detector_tpu_torch.utils.profiling import median_spread, rounds_ms

SHAPES = [  # (B, H, W, C, dilation): Xception-lite's stages at 800 px
    (16, 200, 200, 128, 1),
    (16, 100, 100, 256, 1),
    (16, 50, 50, 512, 1),
    (16, 50, 50, 1024, 2),
]
SMOKE_SHAPES = [(1, 8, 8, 16, 1), (1, 8, 8, 32, 2)]
ROUNDS, REPS = 3, 20               # --smoke: 1, 1


def depthwise(x: torch.Tensor, w: torch.Tensor, dilation: int):
    """The depthwise 3x3 of ``x`` [B, C, H, W] with ``w`` [C, 1, 3, 3],
    stride 1, SAME padding."""
    return F.conv2d(x, w, padding=dilation, dilation=dilation,
                    groups=x.shape[1])


def dx_flipped(dy: torch.Tensor, w: torch.Tensor, dilation: int):
    """The depthwise conv's data gradient as the forward of the kernel
    flipped in both spatial axes (stride 1)."""
    return depthwise(dy, torch.flip(w, (2, 3)), dilation)


def ways(x, w, dy, dilation: int) -> Dict[str, Callable]:
    """Each way's call of no arguments."""
    def full_bwd():
        xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
        return torch.autograd.grad(depthwise(xg, wg, dilation), (xg, wg), dy)
    return {"fwd": lambda: depthwise(x, w, dilation),
            "full_bwd": full_bwd,
            "dx_flip": lambda: dx_flipped(dy, w, dilation),
            "dw_only": lambda: torch.nn.grad.conv2d_weight(
                x, w.shape, dy, padding=dilation, dilation=dilation,
                groups=x.shape[1])}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_args(p)
    args = p.parse_args(argv)
    device, _, label = resolve_harness(args)
    gen = torch.Generator(device=device).manual_seed(0)
    rows, tot = [], {}
    rounds, reps = (1, 1) if args.smoke else (ROUNDS, REPS)
    for b, h, w_, c, dil in SMOKE_SHAPES if args.smoke else SHAPES:
        make = lambda *s: torch.randn(s, generator=gen, device=device).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        x, w, dy = make(b, c, h, w_), make(c, 1, 3, 3), make(b, c, h, w_)
        row = {"shape": [b, h, w_, c], "dilation": dil}
        for name, fn in ways(x, w, dy, dil).items():
            ms = median_spread(rounds_ms(fn, device, rounds, reps))
            row[f"{name}_ms"] = ms["median_ms"]
            row[f"{name}_spread_ms"] = ms["spread_ms"]
            tot[name] = tot.get(name, 0.0) + ms["median_ms"]
        rows.append(emit(dict(row, device=label)))
    rows.append(emit({"totals_ms": tot, "device": label}))
    return rows


if __name__ == "__main__":
    main()
