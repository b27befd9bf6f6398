"""Kernel B1's forward (PSROIAlign) against its plain version, fp32 and bf16
maps, at config 3's shapes, on one card.

The port of the JAX package's ``tools/bench_psroi.py`` (which raced XLA's
separable einsum against the Pallas kernel): [16, 50, 50, 490] maps (7 x 7
bins x 10 channels) and 1000 uniform random rois an image. Each side runs
ROUNDS rounds of REPS calls timed by CUDA events
(``utils.profiling.rounds_ms``; near 0.05 ms the events read the wrapper's
host time as well as the card's): the median and the rounds' spread, and
for the kernel its bound (``ops.psroi_align.bound_ms``: the map and the fp32
bins moved once, or 4 multiply-adds a sample point at the fp32 rate) and
the bound's share of its time. The kernel is reached through its operator
``xdt::psroi_align_fwd``, which counts its launches; the plain version is
``psroi_align_reference`` on the same tensors.

  python -m x_detector_tpu_torch.tools.bench_psroi
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from x_detector_tpu_torch.ops import psroi_align as pa
from x_detector_tpu_torch.ops.library import launch_counts, launches_since
from x_detector_tpu_torch.tools import add_device_args
from x_detector_tpu_torch.tools.fast_nms_ab import emit, resolve_harness
from x_detector_tpu_torch.utils.profiling import median_spread, rounds_ms

B, H, W, K, C, R = 16, 50, 50, 7, 10, 1000
SMOKE = (1, 8, 8, 7, 2, 4)         # (B, H, W, K, C, R) of --smoke
ROUNDS, REPS = 5, 20               # --smoke: 1, 1


def uniform_rois(gen, b: int, r: int, device) -> torch.Tensor:
    """[b, r, 4] rois of two uniform corners each, ordered (ymin, xmin,
    ymax, xmax), as the JAX tool draws them."""
    pts = torch.rand((b, r, 2, 2), generator=gen, device=device)
    lo, hi = pts.min(dim=2).values, pts.max(dim=2).values
    return torch.cat([lo, hi], dim=-1).contiguous()


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_args(p)
    args = p.parse_args(argv)
    device, _, label = resolve_harness(args)
    b, h, w, k, c, r = SMOKE if args.smoke else (B, H, W, K, C, R)
    rounds, reps = (1, 1) if args.smoke else (ROUNDS, REPS)
    gen = torch.Generator(device=device).manual_seed(0)
    rois = uniform_rois(gen, b, r, device)
    rows, ms = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        feat = torch.randn((b, h, w, k * k * c), generator=gen,
                           device=device).to(dtype)
        name = str(dtype).split(".")[-1]
        before = launch_counts()
        for side, fn in (
                ("kernel", lambda: pa.batched_psroi_align(feat, rois, k)),
                ("plain", lambda: pa.psroi_align_reference(feat, rois, k))):
            t = median_spread(rounds_ms(fn, device, rounds, reps))
            ms[side, name] = t["median_ms"]
            row = {"side": side, "dtype": name,
                   "shape": [b, h, w, k * k * c], "rois": r,
                   "ms": t["median_ms"], "spread_ms": t["spread_ms"]}
            if side == "kernel":
                bound, by = pa.bound_ms(feat, rois)
                row.update(bound_ms=bound, bound_by=by,
                           share_of_bound=bound / t["median_ms"],
                           launches=launches_since(before)["psroi_align"])
            rows.append(emit(dict(row, device=label)))
    rows.append(emit({"kernel_bf16_vs_plain_bf16":
                      ms["plain", "bfloat16"] / ms["kernel", "bfloat16"],
                      "device": label}))
    return rows


if __name__ == "__main__":
    main()
