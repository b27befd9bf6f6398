"""Kernel K1's "tma" route under other launch plans, and its host cost, on
one card.

    python -m x_detector_tpu_torch.int8_conv_variants

Two readings, after the card's name and power limit:
  * the host's microseconds a call of K1 at a tiny shape (1 x 8 x 8 x 64,
    1x1 to 64 channels: the host's work sets the rate) on the "tma" route
    and on the first design (the "mma" route), each called as
    ``conv_cuda`` calls it (``run_plan``), in alternating rounds of 200
    calls to a sync: the median round of each;
  * at config 2's and config 3's call shapes with fewer than 264 tiles of
    128 channels (where a split of K or another tile width can change the
    time), the plan's choice and every other width (64, 128, 256 channels
    a tile) and split count (1, 2, 3, 4, 6, 8 slices, a split's units
    within one wave: the kernel's clusters run a unit a block) by the
    profiler's device time, each held bit for bit to the plain version
    first.
"""

from __future__ import annotations

import subprocess
import time

import torch

from x_detector_tpu_torch.ops import int8_conv as q8
from x_detector_tpu_torch.utils.profiling import device_ms

# (B, H, W, Cin, Cout, kernel, stride, pads) of configs 2 and 3 (dilation 1)
SHAPES = [
    (8, 16, 16, 512, 512, (3, 3), (1, 1), ((1, 1), (1, 1))),
    (8, 16, 16, 512, 2048, (1, 1), (1, 1), ((0, 0), (0, 0))),
    (8, 16, 16, 2048, 512, (1, 1), (1, 1), ((0, 0), (0, 0))),
    (8, 32, 32, 256, 256, (3, 3), (1, 1), ((1, 1), (1, 1))),
    (8, 32, 32, 256, 1024, (1, 1), (1, 1), ((0, 0), (0, 0))),
    (8, 32, 32, 512, 512, (3, 3), (2, 2), ((1, 1), (1, 1))),
    (8, 32, 32, 1024, 256, (1, 1), (1, 1), ((0, 0), (0, 0))),
    (8, 32, 32, 1024, 512, (1, 1), (1, 1), ((0, 0), (0, 0))),
    (8, 64, 64, 256, 256, (3, 3), (2, 2), ((1, 1), (1, 1))),
]
WIDTHS, SPLITS = (64, 128, 256), (1, 2, 3, 4, 6, 8)
ROUNDS, CALLS, REPS = 10, 200, 10


def operands(b, h, w, cin, cout, k, seed: int = 0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xq = torch.randint(-127, 128, (b, h, w, cin), generator=gen,
                       dtype=torch.int8, device="cuda")
    wq = torch.randint(-127, 128, (cout, *k, cin), generator=gen,
                       dtype=torch.int8, device="cuda")
    scale = torch.rand(cout, generator=gen, device="cuda") * 1e-3
    return xq, wq, scale


def host_us() -> dict:
    """Host microseconds a tiny K1 call on each route (median round)."""
    xq, wq, scale = operands(1, 8, 8, 64, 64, (1, 1))
    kernel = q8.prepare_weight(wq, False).kernel
    g = q8.conv_geometry((1, 1), (1, 1), (1, 1), ((0, 0), (0, 0)))
    plans = {"tma": q8.plan_conv(xq.shape, 64, g, xq.data_ptr(),
                                 q8.sm_count(0)),
             "mma": q8.plan_mma(64, 64, xq.data_ptr())}
    assert plans["tma"].route == "tma"
    calls = {route: (lambda p=p: q8.run_plan(
        p, xq, kernel, scale, g, q8.conv_output(xq, 64, g, torch.bfloat16)))
        for route, p in plans.items()}
    rounds = {route: [] for route in calls}
    for _ in range(ROUNDS):
        for route, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
            rounds[route].append((time.perf_counter() - t0) / CALLS * 1e6)
    return {route: sorted(v)[len(v) // 2] for route, v in rounds.items()}


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    us = host_us()
    print("host us a tiny K1 call (median of alternating rounds): " +
          ", ".join(f"{r} {v:.2f}" for r, v in us.items()), flush=True)
    sm = q8.sm_count(0)
    for b, h, w, cin, cout, k, s, pads in SHAPES:
        g = q8.conv_geometry(k, s, (1, 1), pads)
        xq, wq, scale = operands(b, h, w, cin, cout, k)
        kernel = q8.prepare_weight(wq, False).kernel
        ref = q8.int8_conv2d_reference(xq, wq, scale, stride=s,
                                       dilation=(1, 1), pads=pads,
                                       out_dtype=torch.bfloat16)
        plan = q8.plan_conv(xq.shape, cout, g, xq.data_ptr(), sm)
        times = {}
        for bn in WIDTHS:
            for splits in SPLITS:
                p = q8.with_width(plan, cout, bn, splits)
                if splits > p.chunks or (splits > 1
                                         and p.tiles * splits > sm):
                    continue
                fn = lambda p=p: q8.run_plan(p, xq, kernel, scale, g,
                                             q8.conv_output(
                                                 xq, cout, g, torch.bfloat16))
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise AssertionError(f"bn {bn}, {splits} slices: differs "
                                         f"from the plain version")
                times[(bn, splits)] = device_ms(fn, REPS) * 1e3
        best = min(times, key=times.get)
        print(f"[{b},{h},{w},{cin}] -> {cout} {k[0]}x{k[1]} s{s[0]}: plan "
              f"bn {plan.bn} x {plan.splits} slices ({plan.tiles} tiles, "
              f"{plan.chunks} chunks) {times[(plan.bn, plan.splits)]:.1f} "
              f"us; best bn {best[0]} x {best[1]} {times[best]:.1f} us; all "
              "(bn/slices us): " + ", ".join(
                  f"{bn}/{sp} {t:.1f}" for (bn, sp), t in times.items()),
              flush=True)


if __name__ == "__main__":
    main()
