"""Kernel K2's "tma" route under other launch plans, on one card.

    python -m x_detector_tpu_torch.int8_dwconv_variants

After the card's name and power limit, at each of config 3's depthwise
call shapes (batch 16, 800 px) and in both modes (dequantizing to bf16;
quantizing on the store to int8 at a next conv's scale): the plan's
choice and the tiles of 4 to 14 warps, one block an SM, that pad the map
least. Each plan is held bit for bit to the plain version, then timed by
the profiler's device time (by CUDA events where the profiler records no
kernel, marked "events"); last, each mode's batch sum under the rule's
plans and under the best plan of each shape.
"""

from __future__ import annotations

import subprocess

import torch

from x_detector_tpu_torch.ops import int8_conv as q8
from x_detector_tpu_torch.utils.profiling import device_ms

# config 3's depthwise calls a batch: (B, H, W, C, stride, dilation, pads,
# calls)
SHAPES = [
    (16, 200, 200, 128, 1, 1, ((1, 1), (1, 1)), 4),
    (16, 200, 200, 128, 2, 1, ((0, 1), (0, 1)), 1),
    (16, 100, 100, 256, 1, 1, ((1, 1), (1, 1)), 3),
    (16, 100, 100, 256, 2, 1, ((0, 1), (0, 1)), 1),
    (16, 50, 50, 512, 1, 1, ((1, 1), (1, 1)), 3),
    (16, 50, 50, 512, 1, 2, ((2, 2), (2, 2)), 1),
    (16, 50, 50, 1024, 1, 2, ((2, 2), (2, 2)), 3),
]
ALTERNATIVES = 3       # tiles that pad the map least


def candidates(x_shape, geometry, out_bytes: int, sm: int) -> list:
    """(label, plan): the rule's, then the ALTERNATIVES other tiles of 4 to
    DW_MAX_WARPS warps whose ring fits that pad the map least (the fewest
    output pixels computed past its edge), more warps first."""
    rule = q8.plan_depthwise(x_shape, geometry, sm_count=sm,
                             out_bytes=out_bytes)
    tiles = []
    for warps in range(4, q8.DW_MAX_WARPS + 1):
        for rr in (r for r in range(1, warps + 1) if warps % r == 0):
            qw = warps // rr
            if (qw, rr) == (rule.qw, rule.rr):
                continue
            try:
                plan = q8.dw_plan_with(x_shape, geometry, qw, rr, out_bytes,
                                       sm)
            except ValueError:
                continue
            if max(plan.box) <= 256:
                tiles.append(((plan.units * plan.th * plan.tw, -warps),
                              (qw, rr), plan))
    return [("rule", rule)] + [
        (f"{qw}x{rr} warps", plan)
        for _, (qw, rr), plan in sorted(tiles, key=lambda t: t[0])[
            :ALTERNATIVES]]


def timed(fn) -> tuple:
    """(ms, how): the profiler's device time, or CUDA events."""
    try:
        return device_ms(fn, tries=6), "device"
    except AssertionError:
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 20, "events"


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    sm = q8.sm_count(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sums = {}
    for b, h, w, c, s, d, pads, n in SHAPES:
        xq = torch.randint(-127, 128, (b, h, w, c), generator=gen,
                           dtype=torch.int8, device="cuda")
        wq = torch.randint(-127, 128, (c, 3, 3, 1), generator=gen,
                           dtype=torch.int8, device="cuda")
        scale = torch.rand(c, generator=gen, device="cuda") * 1e-3
        weight = q8.prepare_weight(wq, True)
        g = q8.conv_geometry((3, 3), (s, s), (d, d), pads)
        kw = dict(stride=s, dilation=d, pads=pads)
        ref = q8.int8_depthwise_conv2d_reference(
            xq, wq, scale, out_dtype=torch.bfloat16, **kw)
        sx = q8.activation_scale(ref.abs().amax().float() * 0.9)
        refs = {"dequant": ref, "quantize": q8.quantize_activation_reference(
            ref, sx)}
        for mode, out_dtype in (("dequant", torch.bfloat16),
                                ("quantize", torch.int8)):
            rows = []
            for label, plan in candidates(xq.shape, g,
                                          1 if mode == "quantize" else 2,
                                          sm):
                sx_out = sx if mode == "quantize" else None
                run = lambda: q8.run_dw_plan(
                    plan, xq, weight.kernel, scale, sx_out, g,
                    q8.conv_output(xq, c, g, out_dtype), torch.bfloat16)
                got = run()
                torch.cuda.synchronize()
                if not torch.equal(got, refs[mode]):
                    raise AssertionError(f"{mode} {label} at {xq.shape}: "
                                         f"differs from the plain version")
                ms, how = timed(run)
                rows.append((ms, label, how, plan))
            rule_ms = rows[0][0]
            best = min(rows, key=lambda r: r[0])
            sums.setdefault(mode, [0.0, 0.0])
            sums[mode][0] += n * rule_ms
            sums[mode][1] += n * best[0]
            print(f"[{b},{h},{w},{c}] s{s} d{d} {mode} (x{n} a batch): " +
                  "; ".join(f"{label} {p.th}x{p.tw} tiles, {p.stages} "
                            f"stages, grid {p.grid}: {ms:.4f} ms"
                            + ("" if how == "device" else " (events)")
                            for ms, label, how, p in rows)
                  + f"; best {best[1]} ({rule_ms / best[0]:.3f}x the "
                    f"rule's)", flush=True)
    for mode, (rule_ms, best_ms) in sums.items():
        print(f"config 3's batch, {mode}: the rule's plans {rule_ms:.4f} "
              f"ms, each shape's best {best_ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
