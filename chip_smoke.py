#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases; each raises on failure and the script then exits non-zero:
  1. device  -- a CUDA card must be present; prints nvidia-smi's name and
                power limit.
  2. build   -- compiles x_detector_tpu_torch/csrc/*.cu with nvcc.
  3. kernels -- each kernel against its plain PyTorch version on the card,
                at the shapes its main paths give it (configs 3 and 1 and
                xdet_xception for the forward kernels, config 4 for
                PSROIAlign's backward, which must also give the same bits
                twice), with the tolerance stated; both timed with CUDA
                events, beside each kernel's bound (utils/roofline.py) and,
                for B2 at config 3's shapes, its first design (the "wmma"
                route) and the unfused cuDNN pair as yardsticks.
                B1's forward runs at config 3's R = 512, config 4's R =
                1000 and config 1's B = 1 (held to the plain version run on
                the CPU), each also timed by the profiler's device time of the
                kernel ("device_ms", "r1000_device_ms"): near 0.05 ms the
                events measure the wrapper's host time as much as the card.
                B1's backward takes a dense gradient and one shaped like a
                train step's (256 non-zero rows per image); "ms" is
                the dense time, "ohem_shaped_ms" the other.
  4. slice   -- config 3 (Light-Head R-CNN + Xception-lite at 800 px, with
                the fused separable conv) from seeded uint8 images through
                build_eval_fn, batches of 16: launch counts, detection
                invariants, batch time; then the same weights at 128 px on
                the card (bf16, kernels) against the CPU (fp32, plain
                versions).
  5. config1 -- config 1 (Light-Head R-CNN + ResNet-50 at 800 px), one
                image at a time: seeded uint8 375 x 500 images resized on
                the card by preprocess_for_eval, then build_eval_fn; B1's
                forward once per image, B2 never.
  6. ssd     -- config 2 (SSD + ResNet-50 at 512 px, approx_prefilter as the
                preset sets it), batches of 8: no kernel launches; the
                anchor count and the valid detections.
  7. xdet    -- xdet_xception at 512 px with the fused separable conv,
                batches of 8: B2 13 times a batch on the "tma" route, B1
                never. Phases 5-7 each print launch counts, batch time,
                images/s and peak memory, then hold the same weights at
                128 px on the card (bf16, kernels) against the CPU (fp32,
                plain versions): config 1 on the RPN outputs, the SSD models
                on cls_logits and box_codes.
  8. train   -- config 4 (the same model as config 3, training, batch 16 at
                800 px):
                synthetic batches made on the card on a 960 px canvas ->
                preprocess_batch_for_train -> the train step, one warm-up
                and TRAIN_STEPS timed steps: launch counts, finite losses,
                changed parameters, step time, images/s, peak memory; then
                one step at 128 px on the card (bf16, kernels) from the same
                weights, batch and RPN draws as the CPU (fp32, plain
                versions; and bf16, as a control): PSROIAlign's backward in
                that step against the plain backward of its inputs, the
                loss, and the thin map's gradients and updates.
  9. train_ssd -- config 2 (SSD + ResNet-50 training, batch 8 at 512 px,
                EMA 0.99): synthetic batches made on the card on 614 px
                canvases -> preprocess_batch_for_train -> the step, one
                warm-up and TRAIN_STEPS timed steps: no kernel launches,
                finite losses, positives matched, changed parameters, a
                shadow that moved and is d * e + (1 - d) * p of its inputs;
                step time, images/s, peak memory; then one step at 128 px
                from the same weights and batch on the card (bf16) against
                the CPU (fp32; and bf16, as a control): the loss and the SSD
                head's gradients and updates.
 10. train_xdet -- the same for xdet_xception (no shadow; trained unfused,
                so B2 never launches).
 11. cli     -- the train and evaluate CLIs in this process, into a
                temporary directory: config 2 for 4 steps with a checkpoint
                every 2, the checkpoint reloaded bit for bit (step and data
                position 4), --resume to 6 steps, metrics.jsonl holding
                steps 1-6; cli.evaluate on that directory (the EMA shadow, a
                finite mAP in [0, 1]); then lighthead_xception (config 4's
                model) for 2 steps: B1's forward and backward once a step.
The line before the last is one JSON object with the kernels' results; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import subprocess
import sys
import tempfile
import time

import torch

from x_detector_tpu_torch.utils import roofline

SEED = 0
BATCH = 16
SLICE_BATCHES = 3          # timed batches, after one warm-up batch
TRAIN_STEPS = 3            # timed train steps, after one warm-up step
CANVAS_SCALE = 1.2         # raw train canvases: 960 px for 800 px inputs
WARMUP, REPS = 3, 20       # kernel timing

# Kernel B2's calls per batch of config 3 at 800 px, B=16:
# (H, W, Cin, Cout, dilation, calls without residual, calls with residual)
B2_SHAPES = [
    (200, 200, 128, 128, 1, 2, 2),      # stage1 sep0a/b, sep1a/b
    (100, 100, 256, 256, 1, 1, 2),      # stage2 sep0b, sep1a/b
    (50, 50, 512, 512, 1, 1, 2),        # stage3 sep0b, sep1a/b
    (50, 50, 512, 1024, 2, 1, 0),       # stage4 sep0a
    (50, 50, 1024, 1024, 2, 1, 2),      # stage4 sep0b, sep1a/b
]
# ... and per batch of xdet_xception at 512 px, B=8, the SSD presets' batch
# (stage 4 at stride 32, not dilated: 13 calls, not 14)
SSD_BATCH = 8
XDET_B2_SHAPES = [
    (128, 128, 128, 128, 1, 2, 2),      # stage1 sep0a/b, sep1a/b
    (64, 64, 256, 256, 1, 1, 2),        # stage2 sep0b, sep1a/b
    (32, 32, 512, 512, 1, 1, 2),        # stage3 sep0b, sep1a/b
    (16, 16, 1024, 1024, 1, 1, 2),      # stage4 sep0b, sep1a/b
]
CONFIG1_IMAGES = 3         # timed images of config 1, after one warm-up
CONFIG1_RAW_HW = (375, 500)  # a VOC-sized image, resized to 800 px
# bf16 output: the kernel and the plain version round the same fp32 values,
# but sum in other orders, so a tap or an output may land one bf16 step
# (2^-8 relative) apart. Held to 1e-2 of the output's scale.
B2_REL_TOL = 1e-2
# PSROIAlign reads the same bf16 features in both versions and sums 16
# fp32 products: only the fp32 summation order differs.
B1_REL_TOL = 1e-5
# PSROIAlign's backward: both versions sum the same fp32 products in other
# orders (1e-5 of the scale) and round once to bf16 on store, where a sum
# that lands by a rounding boundary may go one bf16 step (2^-7 of the
# value) the other way.
B1_BWD_REL_TOL = 1e-5
BF16_STEP = 2.0 ** -7
# The 128 px slices, bf16 with kernels on the card vs fp32 plain on the CPU,
# through ~40-60 layers of random weights: bf16 keeps 8 significant bits.
SLICE_REL_TOL = 1e-1
# One train step at 128 px, card (bf16, kernels) against CPU (fp32, plain
# versions) from the same weights, batch and RPN draws. bf16 rounds, and
# may flip a discrete choice (a proposal, an OHEM pick) that the loss then
# averages; the control, the CPU in bf16 against the CPU in fp32, shows how
# far that alone goes. Limits: total_loss relative, and the gradient and
# update of each thin-map parameter (reached only through PSROIAlign's
# backward) over the leaf's largest value.
TRAIN_LOSS_REL_TOL = 2e-2
TRAIN_LEAF_REL_TOL = 3e-1
# The EMA shadow after a step against d * e + (1 - d) * p of the step's
# inputs, recomputed: the two products and the sum round, fused or not, so
# within four fp32 ulps of the shadow's largest value.
EMA_ULPS = 4
CLI_STEPS, CLI_RESUME_STEPS = 4, 6


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, warmup: int = WARMUP, reps: int = REPS) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_rel_err(got: torch.Tensor, ref: torch.Tensor):
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    return err, scale


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    return smi


def phase_build() -> float:
    from x_detector_tpu_torch import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    log(f"build: {lib} in {seconds:.1f} s")
    # ptxas's summary per kernel: registers, shared memory, spills
    for line in (lib.parent / _build.LOG_NAME).read_text().splitlines():
        if "Compiling entry function" in line:
            log("  " + line.split("entry function ")[-1].split(" for ")[0])
        elif "Used" in line or "spill" in line:
            log("    " + line.split("info    : ")[-1].strip())
    return seconds


def phase_kernels() -> list:
    from x_detector_tpu_torch.ops import psroi_align as pa
    from x_detector_tpu_torch.psroi_bwd_variants import ohem_shaped
    from x_detector_tpu_torch.psroi_fwd_variants import (
        device_ms as fwd_device_ms)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)

    b2 = time_b2(B2_SHAPES, BATCH, randn, yardsticks=True)
    log(f"B2 per batch of config 3 (14 calls): kernel {b2['ms']:.4f} ms, "
        f"first design (wmma route) {b2['wmma_ms']:.4f} ms, plain "
        f"{b2['plain_ms']:.4f} ms, unfused cuDNN yardstick "
        f"{b2['cudnn_ms']:.4f} ms, bound {b2['bound_ms']:.4f} ms "
        f"({b2['bound_ms'] / b2['ms']:.1%} of it)")
    # B1's forward at config 3 (512 proposals per image) and config 4
    # (1000 training proposals per image; its backward follows): held to
    # the plain version on the card, and, for the record, on the CPU, where
    # the plain version divides as the kernel does (on the card PyTorch
    # multiplies by the divisor's fp32 reciprocal); timed by CUDA events
    # around the wrapper and by the profiler's device time of the kernel
    grid, c, size = 7, 10, 50
    feat = randn(BATCH, size, size, grid * grid * c).to(torch.bfloat16)
    b1 = {}
    for r in (512, 1000):
        rois = config_rois(gen, BATCH, r, dev)
        got = pa.batched_psroi_align(feat, rois, grid)
        ref = pa.psroi_align_reference(feat, rois, grid)
        torch.cuda.synchronize()
        err, sc = max_rel_err(got, ref)
        if not err <= B1_REL_TOL * sc:
            raise AssertionError(f"B1 psroi_align at R={r}: max abs err "
                                 f"{err:.3g} > {B1_REL_TOL} x scale {sc:.3g}")
        cpu_err, _ = max_rel_err(got.cpu(), pa.psroi_align_reference(
            feat.cpu(), rois.cpu(), grid))
        fwd = lambda: pa.batched_psroi_align(feat, rois, grid)
        b1[r] = {"err": err, "cpu_err": cpu_err, "ms": cuda_ms(fwd),
                 "device_ms": fwd_device_ms(fwd),
                 "plain_ms": cuda_ms(lambda: pa.psroi_align_reference(
                     feat, rois, grid)),
                 "bound": psroi_bound(feat, rois)}
        ms, bound = b1[r]["device_ms"], b1[r]["bound"]
        log(f"B1 psroi_align [{BATCH},{size},{size},{grid * grid * c}] bf16 "
            f"x [{BATCH},{r},4]: max abs err {err:.3g} (scale {sc:.3g}; "
            f"{cpu_err:.3g} against the plain version on the CPU); kernel "
            f"{ms:.4f} ms device time ({b1[r]['ms']:.4f} ms by events "
            f"around the wrapper), bound {bound[0]:.4f} ms ({bound[1]}), "
            f"{bound[0] / ms:.1%} of it; plain {b1[r]['plain_ms']:.4f} ms; "
            f"x1 per {'batch' if r == 512 else 'train step'}")
    # B1's backward twice: a dense gradient, and one shaped like a train
    # step's, where OHEM leaves ohem_topk = 256 non-zero rows per image
    g = randn(BATCH, r, grid, grid, c)
    bwd_err, bwd_ms = 0.0, {}
    for tag, grad in (("dense", g), ("OHEM-shaped", ohem_shaped(gen, g)[0])):
        bwd = lambda: pa.psroi_align_backward(grad, rois, size, size,
                                              torch.bfloat16, grid)
        got, again = bwd(), bwd()
        ref = pa.psroi_align_backward_reference(grad, rois, size, size,
                                                torch.bfloat16, grid)
        torch.cuda.synchronize()
        err, sc = max_rel_err(got, ref)
        over = ((got.float() - ref.float()).abs()
                > B1_BWD_REL_TOL * sc + BF16_STEP * ref.float().abs())
        if over.any():
            raise AssertionError(
                f"B1 psroi_align_backward ({tag}): {int(over.sum())} "
                f"elements beyond {B1_BWD_REL_TOL} x scale {sc:.3g} + one "
                f"bf16 step; max abs err {err:.3g}")
        if not torch.equal(got, again):
            raise AssertionError(f"B1 psroi_align_backward ({tag}): two runs"
                                 " on the same inputs differ")
        bwd_err = max(bwd_err, err)
        bwd_ms[tag] = cuda_ms(bwd)
        log(f"B1 psroi_align_backward ({tag}) [{BATCH},{r},{grid},{grid},"
            f"{c}] fp32 -> [{BATCH},{size},{size},{grid * grid * c}] bf16: "
            f"max abs err {err:.3g} (scale {sc:.3g}), bitwise equal on a "
            f"second run; kernel {bwd_ms[tag]:.4f} ms")
        del got, again, ref
    bwd_plain_ms = cuda_ms(lambda: pa.psroi_align_backward_reference(
        g, rois, size, size, torch.bfloat16, grid))
    bwd_bound = psroi_bound(feat, rois)
    log(f"B1 psroi_align_backward, dense: kernel {bwd_ms['dense']:.4f} ms, "
        f"bound {bwd_bound[0]:.4f} ms ({bwd_bound[1]}), "
        f"{bwd_bound[0] / bwd_ms['dense']:.1%} of it; plain "
        f"{bwd_plain_ms:.4f} ms; OHEM-shaped {bwd_ms['OHEM-shaped']:.4f} "
        f"ms; x1 per step")
    # the shapes this slice added, after the earlier ones, whose inputs
    # stay those of the earlier runs
    xdet = time_b2(XDET_B2_SHAPES, SSD_BATCH, randn, yardsticks=False)
    log(f"B2 per batch of xdet_xception (13 calls): kernel "
        f"{xdet['ms']:.4f} ms, plain {xdet['plain_ms']:.4f} ms, bound "
        f"{xdet['bound_ms']:.4f} ms ({xdet['bound_ms'] / xdet['ms']:.1%} "
        f"of it)")
    # B1's forward at config 1: one image, 512 proposals, held to the plain
    # version run on the CPU
    feat1 = randn(1, size, size, grid * grid * c).to(torch.bfloat16)
    rois1 = config_rois(gen, 1, 512, dev)
    fwd1 = lambda: pa.batched_psroi_align(feat1, rois1, grid)
    got = fwd1()
    err, sc = max_rel_err(got.cpu(), pa.psroi_align_reference(
        feat1.cpu(), rois1.cpu(), grid))
    if not err <= B1_REL_TOL * sc:
        raise AssertionError(f"B1 psroi_align at config 1 (B=1, R=512): max "
                             f"abs err {err:.3g} against the plain version "
                             f"on the CPU > {B1_REL_TOL} x scale {sc:.3g}")
    c1 = {"err": err, "ms": cuda_ms(fwd1), "device_ms": fwd_device_ms(fwd1),
          "plain_ms": cuda_ms(lambda: pa.psroi_align_reference(
              feat1, rois1, grid)),
          "bound": psroi_bound(feat1, rois1)}
    log(f"B1 psroi_align [1,{size},{size},{grid * grid * c}] bf16 x [1,512,4]"
        f" (config 1): max abs err {err:.3g} against the plain version on "
        f"the CPU (scale {sc:.3g}); kernel {c1['device_ms']:.4f} ms device "
        f"time ({c1['ms']:.4f} ms by events around the wrapper), bound "
        f"{c1['bound'][0]:.4f} ms ({c1['bound'][1]}), "
        f"{c1['bound'][0] / c1['device_ms']:.1%} of it; plain "
        f"{c1['plain_ms']:.4f} ms; x1 per image")
    del got
    return [
        {"name": "fused_sepconv", "route": "cuda",
         "source": "x_detector_tpu_torch/csrc/fused_sepconv.cu",
         "replaces": "x_detector_tpu/ops/pallas/fused_sepconv.py:120",
         "max_abs_err": b2["err"], "ms": b2["ms"],
         "plain_ms": b2["plain_ms"], "bound_ms": b2["bound_ms"],
         "bound_by": b2["by"], "library_ms": None,
         "previous_design_ms": b2["wmma_ms"],
         "unfused_cudnn_yardstick_ms": b2["cudnn_ms"],
         "xdet_ms": xdet["ms"], "xdet_plain_ms": xdet["plain_ms"],
         "xdet_bound_ms": xdet["bound_ms"], "xdet_bound_by": xdet["by"],
         "xdet_max_abs_err": xdet["err"]},
        {"name": "psroi_align", "route": "cuda",
         "source": "x_detector_tpu_torch/csrc/psroi_align.cu",
         "replaces": "x_detector_tpu/ops/pallas/psroi_align_kernel.py:72",
         "max_abs_err": max(b1[512]["err"], b1[1000]["err"]),
         "ms": b1[512]["ms"], "plain_ms": b1[512]["plain_ms"],
         "bound_ms": b1[512]["bound"][0], "bound_by": b1[512]["bound"][1],
         "library_ms": None, "device_ms": b1[512]["device_ms"],
         "r1000_ms": b1[1000]["ms"],
         "r1000_device_ms": b1[1000]["device_ms"],
         "r1000_bound_ms": b1[1000]["bound"][0],
         "r1000_plain_ms": b1[1000]["plain_ms"],
         "max_abs_err_cpu_plain": max(b1[512]["cpu_err"],
                                      b1[1000]["cpu_err"], c1["err"]),
         "config1_ms": c1["ms"], "config1_device_ms": c1["device_ms"],
         "config1_bound_ms": c1["bound"][0],
         "config1_plain_ms": c1["plain_ms"]},
        {"name": "psroi_align_backward", "route": "cuda",
         "source": "x_detector_tpu_torch/csrc/psroi_align.cu",
         "replaces": "x_detector_tpu/ops/pallas/psroi_align_kernel.py:169",
         "max_abs_err": bwd_err, "ms": bwd_ms["dense"],
         "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound[0],
         "bound_by": bwd_bound[1], "library_ms": None,
         "ohem_shaped_ms": bwd_ms["OHEM-shaped"]},
    ]


def time_b2(shapes, batch: int, randn, yardsticks: bool) -> dict:
    """Kernel B2 at each of ``shapes`` (H, W, Cin, Cout, d, calls without
    residual, calls with it) and ``batch``: held to the plain version within
    B2_REL_TOL of the output's scale on the "tma" route (and, with
    ``yardsticks``, on the "wmma" route), then timed beside its bound, the
    plain version and, with ``yardsticks``, the first design and the
    unfused cuDNN pair. Returns the per-batch sums, weighted by the calls,
    the worst error, and "by": the resource behind the larger part of the
    summed bound, since the shapes mix bytes-bound and operations-bound
    calls."""
    from x_detector_tpu_torch.ops import fused_sepconv as fs
    tot = dict.fromkeys(("ms", "wmma_ms", "plain_ms", "cudnn_ms",
                         "bound_ms", "bytes_bound_ms", "err"), 0.0)
    for h, w, cin, cout, d, n_plain, n_res in shapes:
        x = randn(batch, h, w, cin).to(torch.bfloat16)
        wd = randn(3, 3, cin) / 3.0
        wp = randn(cin, cout) / cin ** 0.5
        scale = 1.0 + 0.1 * randn(cout)
        bias = 0.1 * randn(cout)
        res = randn(batch, h, w, cout).to(torch.bfloat16)
        routes = fs.ROUTES if yardsticks else ("tma",)
        ops = {route: fs.prepare_weights(wd, wp, scale, bias, route=route)
               for route in routes}
        for residual, calls in ((None, n_plain), (res, n_res)):
            if not calls:
                continue
            kw = dict(dilation=d, relu=True, residual=residual)
            tag = (f"B2 fused_sepconv [{batch},{h},{w}] {cin}->{cout} d={d} "
                   f"residual={residual is not None}")
            before = dict(fs.fused_separable_conv.route_launches)
            got = fs.fused_separable_conv(x, wd, wp, scale, bias, **kw)
            if fs.fused_separable_conv.route_launches["tma"] != (
                    before["tma"] + 1):
                raise AssertionError(f"{tag}: did not take the tma route")
            ref = fs.reference_separable_conv(x, wd, wp, scale, bias, **kw)
            outs = {"tma": got}
            if yardsticks:
                outs["wmma"] = fs.fused_separable_conv_prepared(
                    x, ops["wmma"], **kw)
            torch.cuda.synchronize()
            errs = {route: max_rel_err(out, ref) for route, out in
                    outs.items()}
            err, sc = errs["tma"]
            worst = max(e for e, _ in errs.values())
            if not worst <= B2_REL_TOL * sc:
                raise AssertionError(f"{tag}: max abs err by route "
                                     f"{ {k: v[0] for k, v in errs.items()} }"
                                     f" > {B2_REL_TOL} x scale {sc:.3g}")
            t = {"ms": cuda_ms(lambda: fs.fused_separable_conv_prepared(
                     x, ops["tma"], **kw)),
                 "plain_ms": cuda_ms(lambda: fs.reference_separable_conv(
                     x, wd, wp, scale, bias, **kw))}
            if yardsticks:
                t["wmma_ms"] = cuda_ms(
                    lambda: fs.fused_separable_conv_prepared(
                        x, ops["wmma"], **kw))
                t["cudnn_ms"] = cuda_ms(unfused_cudnn(x, wd, wp, scale, bias,
                                                      **kw))
            bound, by = fs.bound_ms(batch, h, w, cin, cout,
                                    residual is not None)
            flop = 2.0 * batch * h * w * cin * (9 + cout)
            extra = (f"; first design (wmma route) {t['wmma_ms']:.4f} ms "
                     f"(max abs err {errs['wmma'][0]:.3g}); yardstick, "
                     f"unfused cuDNN pair + epilogue (several calls, not "
                     f"used by the port) {t['cudnn_ms']:.4f} ms"
                     if yardsticks else "")
            log(f"{tag}: max abs err {err:.3g} (scale {sc:.3g}); kernel "
                f"{t['ms']:.4f} ms ({flop / t['ms'] / 1e9:.1f} TFLOP/s), "
                f"bound {bound:.4f} ms ({by}), {bound / t['ms']:.1%} of it; "
                f"plain {t['plain_ms']:.4f} ms{extra}; x{calls} per batch")
            for key, v in dict(t, bound_ms=bound).items():
                tot[key] += calls * v
            if by == "bytes":
                tot["bytes_bound_ms"] += calls * bound
            tot["err"] = max(tot["err"], err)
            del got, ref, outs
    tot["by"] = ("bytes" if tot["bytes_bound_ms"] * 2 >= tot["bound_ms"]
                 else "operations")
    return tot


def psroi_bound(feat, rois, samples: int = 2):
    """roofline.bound_ms's pair for PSROIAlign at these shapes, forward or
    backward: per fp32 bin, samples^2 bilinear points of 4 fp32
    multiply-adds; the map (in or out) and the fp32 bins (out or in) each
    move once, and the rois are read once."""
    bins = rois.shape[0] * rois.shape[1] * feat.shape[-1]
    return roofline.bound_ms(
        bins * samples * samples * 4 * 2.0,
        feat.numel() * feat.element_size() + rois.numel() * 4 + bins * 4,
        roofline.FP32_FLOP_PER_S)


def unfused_cudnn(x, wd, wp, scale, bias, *, dilation, relu, residual):
    """The yardstick for B2: the model's unfused route at one shape, bf16
    channels_last depthwise F.conv2d, then the 1x1 F.conv2d, then the
    folded BN, the residual and the ReLU: several calls, which the port
    does not take on this route. Returns a function of no arguments."""
    import torch.nn.functional as F
    cin, cout = wp.shape
    d = int(dilation)
    xc = x.permute(0, 3, 1, 2)                      # channels_last NCHW
    wdc = wd.permute(2, 0, 1)[:, None].to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    wpc = wp.t()[:, :, None, None].to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    sc = scale.to(torch.bfloat16)[None, :, None, None]
    bi = bias.to(torch.bfloat16)[None, :, None, None]
    res = None if residual is None else residual.permute(0, 3, 1, 2)

    def run():
        y = F.conv2d(F.conv2d(xc, wdc, padding=d, dilation=d, groups=cin),
                     wpc) * sc + bi
        if res is not None:
            y = y + res
        return F.relu(y) if relu else y
    return run


def config_rois(gen, batch: int, r: int, dev) -> torch.Tensor:
    """[batch, r, 4] random normalized rois, the first six of each image
    the edge and zero-area cases."""
    lo = torch.rand(batch, r, 2, generator=gen, device=dev) * 0.8
    hw = torch.rand(batch, r, 2, generator=gen, device=dev) * 0.5
    rois = torch.cat([lo, (lo + hw).clamp(max=1.0)], dim=-1)
    edge = torch.tensor([[0.0, 0.0, 1.0, 1.0], [0.9, 0.9, 1.0, 1.0],
                         [0.0, 0.5, 0.0, 0.5], [0.3, 0.3, 0.3, 0.3],
                         [0.999, 0.0, 1.0, 0.001], [0.0, 0.0, 0.0, 0.0]],
                        device=dev)
    rois[:, :edge.shape[0]] = edge          # edge and zero-area rois
    return rois.contiguous()


def slice_model(model_cfg, device, seed: int = SEED):
    """The config's model with seeded random weights and BatchNorm
    statistics moved off their initial values, so the folded affine is not
    identity."""
    from x_detector_tpu_torch.inference import build_model
    from x_detector_tpu_torch.models.layers import BatchNorm2D
    model = build_model(model_cfg, "cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2D):
                n = m.weight.shape[0]
                m.weight.add_(0.1 * torch.randn(n, generator=gen))
                m.bias.add_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.add_(0.1 * torch.randn(n, generator=gen))
                m.running_var.mul_(1.0 + 0.5 * torch.rand(n, generator=gen))
    return model.to(device)


def check_detections(boxes, scores, classes, valid, batch: int,
                     max_output: int) -> None:
    """Shapes, finiteness and the NMS output contract."""
    if boxes.shape != (batch, max_output, 4) or scores.shape != (
            batch, max_output) or classes.shape != scores.shape or (
            valid.shape != scores.shape):
        raise AssertionError(f"detection shapes {tuple(boxes.shape)} "
                             f"{tuple(scores.shape)} {tuple(classes.shape)}")
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        raise AssertionError("non-finite detections")
    if (scores[:, 1:] > scores[:, :-1]).any():
        raise AssertionError("scores not descending")
    if not torch.equal(valid, classes > 0):
        raise AssertionError("valid != (class > 0)")
    if (boxes < 0).any() or (boxes > 1).any():
        raise AssertionError("boxes outside [0, 1]")


def run_slice(cfg, device, batches: int = SLICE_BATCHES,
              batch_size: int = BATCH, seed: int = SEED,
              raw_hw=None) -> dict:
    """Drive an inference path: seeded uint8 images (``raw_hw`` high and
    wide, the canvas by default) -> preprocess_for_eval -> build_eval_fn,
    one warm-up batch then ``batches`` timed ones. Returns every kernel's
    launch count over all of them (and B2's by route), what the model
    should give (B2 a fused block a batch, B1's forward one a batch for
    Light-Head, B1's backward none), the timed seconds per batch, the
    anchor count and the detections of the last batch."""
    from x_detector_tpu_torch.data.augment import preprocess_for_eval
    from x_detector_tpu_torch.inference import build_eval_fn
    from x_detector_tpu_torch.ops import fused_sepconv as fs
    device = torch.device(device)
    model = slice_model(cfg.model, device, seed)
    detect = build_eval_fn(model, cfg, device)
    size = cfg.model.image_size
    h, w = raw_hw or (size, size)
    gen = torch.Generator(device=device).manual_seed(seed)
    images = [torch.randint(0, 256, (batch_size, h, w, 3), generator=gen,
                            dtype=torch.uint8, device=device)
              for _ in range(batches + 1)]
    sync = (lambda: torch.cuda.synchronize(device)) if (
        device.type == "cuda") else (lambda: None)
    counters = kernel_counters()
    sync()
    fs.reset_launches()
    for fn in counters.values():
        fn.launches = 0
    seconds = []
    for u8 in images:
        t0 = time.perf_counter()
        det = detect(preprocess_for_eval(u8, cfg.data))
        sync()
        seconds.append(time.perf_counter() - t0)
        check_detections(*det, batch_size, cfg.model.nms.max_output)
    launches = {name: fn.launches for name, fn in counters.items()}
    n = len(images)
    return {"launches": launches, "batches": n,
            "routes": dict(fs.fused_separable_conv.route_launches),
            "expected": {"fused_sepconv": fused_blocks(model) * n,
                         "psroi_align": n if cfg.model.family == "lighthead"
                         else 0,
                         "psroi_align_backward": 0},
            "seconds": seconds[1:], "anchors": model.anchors.shape[0],
            "detections": det}


def check_slice(tag: str, res: dict, per_batch: dict) -> None:
    """Fails unless the model gives ``per_batch`` launches of each kernel a
    batch, the path launched exactly that many, and every B2 launch took
    the "tma" route."""
    want = {name: v * res["batches"] for name, v in per_batch.items()}
    if res["expected"] != want:
        raise AssertionError(f"{tag} should launch {per_batch} a batch; the "
                             f"model gives {res['expected']} over "
                             f"{res['batches']} batches")
    if res["launches"] != want:
        raise AssertionError(f"{tag}: launches {res['launches']} on the main"
                             f" path, expected {want}")
    if res["routes"] != {"tma": want["fused_sepconv"], "wmma": 0}:
        raise AssertionError(f"{tag}: every B2 call must take the tma route;"
                             f" the routes were {res['routes']}")


def report_slice(tag: str, res: dict, batch: int) -> None:
    secs = res["seconds"]
    mean = sum(secs) / len(secs)
    n_valid = int(res["detections"][3].sum().item())
    log(f"{tag}, batch {batch}: launches {res['launches']} (B2 by route "
        f"{res['routes']}) over {res['batches']} batches; batch times "
        f"{[round(t * 1e3, 2) for t in secs]} ms, mean {mean * 1e3:.2f} ms = "
        f"{batch / mean:.1f} images/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{res['anchors']} anchors; {n_valid} valid detections in the last "
        f"batch")


def named_outputs(out) -> dict:
    """A model's outputs by name: Light-Head's dict, SSD's pair."""
    if isinstance(out, dict):
        return out
    return dict(zip(("cls_logits", "box_codes"), out))


def slice_reference_check(model_cfg, device, keys) -> float:
    """The same seeded weights at 128 px: bf16 with kernels on ``device``
    against fp32 plain versions on the CPU, on the outputs ``keys`` (for
    Light-Head the RPN's, before any discrete NMS choice; for SSD the raw
    head outputs)."""
    from x_detector_tpu_torch.inference import build_model
    cfg = dataclasses.replace(model_cfg, image_size=128)
    gpu = slice_model(cfg, device).eval()
    cpu = build_model(cfg, "cpu", seed=None, dtype=torch.float32)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randint(0, 256, (2, 128, 128, 3), generator=gen
                      ).float() - 120.0
    with torch.inference_mode():
        got = named_outputs(gpu(x.to(device)))
        ref = named_outputs(cpu(x))
    worst = 0.0
    for key in keys:
        err, sc = max_rel_err(got[key].cpu(), ref[key])
        log(f"{model_cfg.name} 128px {key}: card bf16 vs CPU fp32 max abs "
            f"err {err:.3g} (scale {sc:.3g})")
        if not err <= SLICE_REL_TOL * sc:
            raise AssertionError(f"{model_cfg.name} 128px {key}: {err:.3g} >"
                                 f" {SLICE_REL_TOL} x scale {sc:.3g}")
        worst = max(worst, err / sc)
    return worst


def fused_blocks(model) -> int:
    """B2 launches per forward of ``model`` in its current mode."""
    from x_detector_tpu_torch.models.layers import SeparableConvBN
    return sum(1 for m in model.modules()
               if isinstance(m, SeparableConvBN) and m.takes_fused_route)


def kernel_counters():
    from x_detector_tpu_torch.ops import psroi_align as pa
    from x_detector_tpu_torch.ops.fused_sepconv import fused_separable_conv
    return {"fused_sepconv": fused_separable_conv,
            "psroi_align": pa.batched_psroi_align,
            "psroi_align_backward": pa.psroi_align_backward}


def train_config(image_size: int = 800, batch_size: int = BATCH):
    """Config 4: the lighthead_xception preset training at batch 16 with no
    warmup (``tools/bench_train.py``'s configuration)."""
    from x_detector_tpu_torch.config import lighthead_xception
    cfg = lighthead_xception(image_size)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=batch_size, warmup_steps=0))


def run_train(cfg, device, steps: int = TRAIN_STEPS,
              seed: int = SEED) -> dict:
    """Drive the training path of either family: synthetic batches made on
    ``device`` on a 1.2x canvas -> preprocess_batch_for_train -> the train
    step, one warm-up step then ``steps`` timed ones. Returns the kernels'
    launch counts over all of them, what they should be, the timed seconds
    per step, the losses, how many parameter tensors moved, those that got
    a gradient in the last step and did not move ("stuck") and, with an
    EMA shadow, how many of its tensors moved and its largest gap to
    d * e + (1 - d) * p of the last step's inputs (with the scale). (An
    SSD step's loss reaches only the anchors it mines, so a level without
    one gives its head a zero gradient.)
    Expected: per microbatch, one forward (for Light-Head one PSROIAlign,
    and the fused blocks the model in training mode takes) and, for
    Light-Head, one backward of PSROIAlign."""
    from x_detector_tpu_torch.data.augment import preprocess_batch_for_train
    from x_detector_tpu_torch.data.synthetic import synthetic_batch_device
    from x_detector_tpu_torch.train.trainer import (create_model_and_state,
                                                    make_train_step)
    device = torch.device(device)
    state = create_model_and_state(cfg, device, seed=seed)
    step = make_train_step(state.model, cfg)
    before = [p.detach().clone() for p in state.model.parameters()]
    gen = torch.Generator(device=device).manual_seed(seed)
    canvas = int(cfg.data.image_size * CANVAS_SCALE)
    batch_size = cfg.train.batch_size
    sync = (lambda: torch.cuda.synchronize(device)) if (
        device.type == "cuda") else (lambda: None)
    counters = kernel_counters()
    sync()
    for fn in counters.values():
        fn.launches = 0
    seconds, losses, ema_in = [], [], None
    for i in range(steps + 1):
        if i == steps and state.ema_params is not None:
            ema_in = {n: e.clone() for n, e in state.ema_params.items()}
        t0 = time.perf_counter()
        raw = synthetic_batch_device(gen, batch_size, canvas,
                                     cfg.data.max_gt_boxes)
        batch = preprocess_batch_for_train(gen, raw, cfg.data)
        state, metrics = step(state, batch, gen)
        sync()
        seconds.append(time.perf_counter() - t0)
        losses.append({k: v.item() for k, v in metrics.items()})
    launches = {name: fn.launches for name, fn in counters.items()}
    params = list(state.model.named_parameters())
    moved = [not torch.equal(b, p.detach()) for b, (_, p) in
             zip(before, params)]
    forwards = (steps + 1) * cfg.train.grad_accum_steps
    b1 = forwards if cfg.model.family == "lighthead" else 0
    res = {"launches": launches,
           "expected": {"fused_sepconv": forwards * fused_blocks(state.model),
                        "psroi_align": b1, "psroi_align_backward": b1},
           "seconds": seconds[1:], "losses": losses,
           "moved": sum(moved), "params": len(moved),
           "stuck": [n for m, (n, p) in zip(moved, params)
                     if not m and bool(p.grad.any())]}
    if ema_in is not None:
        d, gap, scale = state.ema_decay, 0.0, 0.0
        with torch.no_grad():
            for (name, p), b in zip(params, before):
                e = state.ema_params[name]
                want = d * ema_in[name] + (1.0 - d) * p
                gap = max(gap, (e - want).abs().max().item())
                scale = max(scale, want.abs().max().item())
        res["ema"] = {"moved": sum(not torch.equal(state.ema_params[n], b)
                                   for (n, _), b in zip(params, before)),
                      "gap": gap, "scale": scale}
    return res


def check_train(tag: str, res: dict, per_step: dict) -> None:
    """Fails unless the model gives ``per_step`` launches of each kernel a
    step and the path launched exactly that many, the losses are finite,
    every parameter tensor with a gradient in the last step moved and,
    with an EMA shadow, as many shadow tensors moved as parameters and the
    shadow equals d * e + (1 - d) * p within EMA_ULPS ulps."""
    n_steps = len(res["seconds"]) + 1
    want = {name: v * n_steps for name, v in per_step.items()}
    if res["expected"] != want:
        raise AssertionError(f"{tag} should launch {per_step} a step; the "
                             f"model gives {res['expected']}")
    if res["launches"] != want:
        raise AssertionError(f"{tag}: launches {res['launches']} on the "
                             f"train path, expected {want}")
    for m in res["losses"]:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{tag}: non-finite train metrics {m}")
    if res["stuck"] or not res["moved"]:
        raise AssertionError(f"{tag}: {res['moved']} of {res['params']} "
                             f"parameter tensors changed; these got a "
                             f"gradient and did not: {res['stuck'][:5]}")
    ema = res.get("ema")
    if ema is not None:
        limit = EMA_ULPS * torch.finfo(torch.float32).eps * ema["scale"]
        if ema["moved"] < res["moved"] or not ema["gap"] <= limit:
            raise AssertionError(
                f"{tag}: EMA shadow moved in {ema['moved']} tensors, the "
                f"parameters in {res['moved']}; gap to d * e + (1 - d) * p "
                f"{ema['gap']:.3g} > {limit:.3g}")


def report_train(tag: str, res: dict, batch: int, peak: int) -> None:
    secs = res["seconds"]
    mean = sum(secs) / len(secs)
    total = [round(m["total_loss"], 4) for m in res["losses"]]
    extra = ""
    if "ssd_num_fg" in res["losses"][-1]:
        extra = (f"; ssd_num_fg {[m['ssd_num_fg'] for m in res['losses']]}")
    if "ema" in res:
        extra += (f"; EMA shadow: gap to d * e + (1 - d) * p "
                  f"{res['ema']['gap']:.3g} (scale {res['ema']['scale']:.3g})")
    log(f"{tag}: launches {res['launches']} over {len(secs) + 1} steps; "
        f"{res['moved']} of {res['params']} parameter tensors moved; "
        f"step times {[round(t * 1e3, 2) for t in secs]} ms, mean "
        f"{mean * 1e3:.2f} ms = {batch / mean:.1f} images/s; peak memory "
        f"{peak / 2**30:.2f} GiB; total_loss {total}{extra}")


def train_step_capture(cfg, device, dtype, batch, priorities) -> dict:
    """One train step of ``cfg``'s seeded model on ``device`` in ``dtype``.
    Returns the metrics, each thin-map parameter's gradient and update, and
    what PSROIAlign's backward took and gave in that step: the proposals,
    autograd's upstream gradient (the pooled features' gradient times the
    proposal mask) and the thin map's gradient, [B, H, W, k*k*C]."""
    from x_detector_tpu_torch.train import losses as loss_lib
    from x_detector_tpu_torch.train.trainer import (create_model_and_state,
                                                    make_train_step)
    state = create_model_and_state(cfg, device, seed=SEED, dtype=dtype)
    model, cap = state.model, {}

    def on_thin(mod, inp, out):
        out.register_hook(
            lambda g: cap.__setitem__("dfeat", g.permute(0, 2, 3, 1)))

    def on_head(mod, inp):
        inp[0].register_hook(lambda g: cap.__setitem__("dpooled", g))

    def on_model(mod, inp, out):
        cap["rois"] = out["proposals"].detach()
        cap["valid"] = out["proposal_valid"]

    handles = [model.thin_map.register_forward_hook(on_thin),
               model.roi_head.register_forward_pre_hook(on_head),
               model.register_forward_hook(on_model)]
    before = {n: p.detach().clone()
              for n, p in model.thin_map.named_parameters()}
    try:
        _, metrics = make_train_step(model, cfg)(
            state, {k: v.to(device) for k, v in batch.items()},
            priorities=loss_lib.RPNPriorities(
                *(p.to(device) for p in priorities)))
    finally:
        for h in handles:
            h.remove()
    leaves = {n: (p.grad.cpu(), (p.detach() - before[n]).cpu())
              for n, p in model.thin_map.named_parameters()}
    upstream = cap.pop("dpooled") * cap.pop("valid")[..., None, None, None]
    return dict(cap, upstream=upstream, leaves=leaves,
                metrics={k: v.item() for k, v in metrics.items()})


def train_reference_check(device) -> dict:
    """Config 4's model at 128 px, batch 2: one train step on ``device``
    (bf16, kernels) against the CPU in fp32 (plain versions) and, as the
    control, the CPU in bf16, from the same weights, batch and RPN draws.
    Holds (1) the thin map's gradient that PSROIAlign's backward gave on
    ``device`` against the plain backward of what it took there; (2) the
    loss and (3) the thin-map parameters' gradients and updates against
    the fp32 CPU step. Returns the readings."""
    from x_detector_tpu_torch.data.augment import preprocess_batch_for_train
    from x_detector_tpu_torch.data.synthetic import synthetic_batch_device
    from x_detector_tpu_torch.ops import anchors as anchor_lib
    from x_detector_tpu_torch.ops import psroi_align as pa
    from x_detector_tpu_torch.train import losses as loss_lib
    cfg = train_config(128, batch_size=2)
    gen = torch.Generator().manual_seed(SEED)
    raw = synthetic_batch_device(gen, 2, int(128 * CANVAS_SCALE),
                                 cfg.data.max_gt_boxes)
    batch = preprocess_batch_for_train(gen, raw, cfg.data)
    pri = loss_lib.draw_rpn_priorities(gen, 2, anchor_lib.rpn_anchors(
        cfg.model.image_size, cfg.model.anchors).shape[0])
    got = train_step_capture(cfg, device, torch.bfloat16, batch, pri)
    ref = train_step_capture(cfg, "cpu", torch.float32, batch, pri)
    ctl = train_step_capture(cfg, "cpu", torch.bfloat16, batch, pri)

    dfeat = got["dfeat"]
    want = pa.psroi_align_backward_reference(
        got["upstream"], got["rois"], dfeat.shape[1], dfeat.shape[2],
        torch.float32, cfg.model.roi_grid)
    err = (dfeat.float() - want).abs()
    scale = want.abs().max().item()
    over = err > B1_BWD_REL_TOL * scale + BF16_STEP * want.abs()
    if over.any() or not scale > 0:
        raise AssertionError(
            f"train 128px: PSROIAlign's backward in the step, "
            f"{int(over.sum())} elements beyond {B1_BWD_REL_TOL} x scale "
            f"{scale:.3g} + one bf16 step of the plain backward")
    readings = {"bwd_err": err.max().item() / scale}
    log(f"train 128px: PSROIAlign backward in the step vs plain on its "
        f"inputs: max abs err {err.max().item():.3g} (scale {scale:.3g})")

    readings.update(hold_step("train 128px", "thin-map", got, ref, ctl))
    return readings


def step_gaps(run: dict, ref: dict):
    """A captured train step against the reference capture: the total_loss
    gap relative to the loss, and the worst gradient and update gap of the
    captured leaves over each leaf's largest value (0 where both are all
    zero, inf where only the reference is)."""
    loss = abs(run["metrics"]["total_loss"]
               - ref["metrics"]["total_loss"]) / abs(
        ref["metrics"]["total_loss"])
    leaf = [0.0, 0.0]
    for name, pair in ref["leaves"].items():
        for i, (a, b) in enumerate(zip(run["leaves"][name], pair)):
            err = (a.float() - b).abs().max().item()
            scale = b.abs().max().item()
            leaf[i] = max(leaf[i], err / scale if scale else (
                0.0 if err == 0 else math.inf))
    return loss, leaf[0], leaf[1]


def log_gaps(tag: str, what: str, leaves: str, run: dict, ref: dict):
    loss, grad, update = step_gaps(run, ref)
    log(f"{tag}, {what} vs CPU fp32: total_loss gap {loss:.3g}; {leaves} "
        f"leaves, worst gap of the leaf's largest value: gradient "
        f"{grad:.3g}, update {update:.3g}; " + ", ".join(
            f"{k} {v:.5g} / {ref['metrics'][k]:.5g}"
            for k, v in run["metrics"].items()))
    return loss, grad, update


def hold_step(tag: str, leaves: str, got: dict, ref: dict,
              ctl: dict) -> dict:
    """One 128 px train step's readings, the card's (``got``) and the
    control's (``ctl``) against the CPU in fp32 (``ref``): the loss gap and
    the captured ``leaves``' gradient and update gaps (``step_gaps``).
    Fails beyond TRAIN_LOSS_REL_TOL or TRAIN_LEAF_REL_TOL on the card."""
    readings = {}
    for what, run in (("card bf16", got), ("control: CPU bf16", ctl)):
        key = "" if run is got else "control_"
        readings.update(zip((key + "loss", key + "leaf_grad",
                             key + "leaf_update"),
                            log_gaps(tag, what, leaves, run, ref)))
    if not readings["loss"] <= TRAIN_LOSS_REL_TOL:
        raise AssertionError(f"{tag} total_loss: relative gap "
                             f"{readings['loss']:.3g} > {TRAIN_LOSS_REL_TOL}")
    worst = max(readings["leaf_grad"], readings["leaf_update"])
    if not worst <= TRAIN_LEAF_REL_TOL:
        raise AssertionError(f"{tag} {leaves} gradient or update: gap "
                             f"{worst:.3g} > {TRAIN_LEAF_REL_TOL}")
    return readings


def ssd_train_config(preset: str, image_size: int = 512,
                     batch_size: int = SSD_BATCH):
    """An SSD preset (config 2 or xdet_xception) training at
    ``image_size`` and ``batch_size`` with no warmup, as config 4 runs
    here (``train_config``); the rest as published."""
    from x_detector_tpu_torch.config import PRESETS
    cfg = PRESETS[preset](image_size)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=batch_size, warmup_steps=0))


def ssd_step_capture(cfg, device, dtype, batch) -> dict:
    """One train step of ``cfg``'s seeded SSD model on ``device`` in
    ``dtype``: the metrics and each SSD head parameter's gradient and
    update."""
    from x_detector_tpu_torch.train.trainer import (create_model_and_state,
                                                    make_train_step)
    state = create_model_and_state(cfg, device, seed=SEED, dtype=dtype)
    head = state.model.head
    before = {n: p.detach().clone() for n, p in head.named_parameters()}
    _, metrics = make_train_step(state.model, cfg)(
        state, {k: v.to(device) for k, v in batch.items()})
    return {"leaves": {n: (p.grad.cpu(), (p.detach() - before[n]).cpu())
                       for n, p in head.named_parameters()},
            "metrics": {k: v.item() for k, v in metrics.items()}}


def ssd_train_reference_check(cfg, device) -> dict:
    """``cfg`` (an SSD preset at 128 px, batch 2): one train step from the
    same seeded weights and batch on ``device`` and on the CPU in fp32.
    The loss is held to TRAIN_LOSS_REL_TOL with ``device`` in bf16 (beside
    the control, the CPU in bf16). The SSD head's gradients and updates
    are held to TRAIN_LEAF_REL_TOL with ``device`` in fp32: in bf16 the
    few anchors a random-weight step mines at 128 px change (the control
    moves head leaves by up to their whole size, and levels that mined
    nothing in fp32 get a gradient), which the loss, a sum over the mined
    anchors' losses, barely shows. Returns the readings."""
    from x_detector_tpu_torch.data.augment import preprocess_batch_for_train
    from x_detector_tpu_torch.data.synthetic import synthetic_batch_device
    size, batch_size = cfg.model.image_size, cfg.train.batch_size
    gen = torch.Generator().manual_seed(SEED)
    raw = synthetic_batch_device(gen, batch_size, int(size * CANVAS_SCALE),
                                 cfg.data.max_gt_boxes)
    batch = preprocess_batch_for_train(gen, raw, cfg.data)
    tag = f"{cfg.model.name} train {size}px"
    ref = ssd_step_capture(cfg, "cpu", torch.float32, batch)
    readings = {}
    for key, what, run in (
            ("bf16_", "card bf16", ssd_step_capture(cfg, device,
                                                    torch.bfloat16, batch)),
            ("control_", "control: CPU bf16", ssd_step_capture(
                cfg, "cpu", torch.bfloat16, batch)),
            ("", "card fp32", ssd_step_capture(cfg, device, torch.float32,
                                               batch))):
        readings.update(zip((key + "loss", key + "leaf_grad",
                             key + "leaf_update"),
                            log_gaps(tag, what, "SSD head", run, ref)))
    if not readings["bf16_loss"] <= TRAIN_LOSS_REL_TOL:
        raise AssertionError(f"{tag} total_loss, card bf16: relative gap "
                             f"{readings['bf16_loss']:.3g} > "
                             f"{TRAIN_LOSS_REL_TOL}")
    worst = max(readings["leaf_grad"], readings["leaf_update"])
    if not worst <= TRAIN_LEAF_REL_TOL:
        raise AssertionError(f"{tag} SSD head gradient or update, card "
                             f"fp32: gap {worst:.3g} > {TRAIN_LEAF_REL_TOL}")
    return readings


def run_cli(device, extra=()) -> dict:
    """The train and evaluate CLIs, in this process, into a temporary
    directory, each called with ``--device device`` and ``extra``: config 2
    for CLI_STEPS steps (a checkpoint every 2), the newest checkpoint
    reloaded into a fresh state and held bit for bit to the state the run
    ended with (step and data position CLI_STEPS), then --resume to
    CLI_RESUME_STEPS; cli.evaluate on that directory; then
    lighthead_xception for 2 steps with the kernels' counters reset just
    before it. Fails on any mismatch; returns the Light-Head run's launch
    counts and what they should be, the evaluation's result and the
    SSD run's metrics.jsonl wall times (from each run's start)."""
    import argparse
    from x_detector_tpu_torch.cli import common, evaluate, train
    from x_detector_tpu_torch.train.checkpoint import CheckpointManager
    from x_detector_tpu_torch.train.trainer import create_model_and_state
    device = torch.device(device)
    common_args = ["--device", str(device), *extra]
    with tempfile.TemporaryDirectory() as tmp:
        ssd = ["--preset", "ssd_resnet50", "--model-dir", f"{tmp}/ssd",
               *common_args]
        state = train.main(ssd + ["--steps", str(CLI_STEPS),
                                  "--checkpoint-every", "2", "--log-every",
                                  "1"])
        parser = argparse.ArgumentParser()
        common.add_common_args(parser)
        cfg = common.resolve_config(parser.parse_known_args(ssd)[0])
        fresh = create_model_and_state(cfg, device, seed=SEED + 1)
        fresh, data_state = CheckpointManager(f"{tmp}/ssd/ckpt").restore(
            fresh)
        if fresh.step != CLI_STEPS or data_state != {"position": CLI_STEPS}:
            raise AssertionError(f"cli: restored step {fresh.step}, data "
                                 f"state {data_state}; expected {CLI_STEPS}")
        saved = {**state.model.state_dict(), **{
            "ema." + k: v for k, v in state.ema_params.items()}}
        loaded = {**fresh.model.state_dict(), **{
            "ema." + k: v for k, v in fresh.ema_params.items()}}
        differ = [k for k in saved if not torch.equal(saved[k], loaded[k])]
        if differ or set(saved) != set(loaded):
            raise AssertionError(f"cli: reloaded tensors differ from the "
                                 f"saved ones: {differ[:5]}")
        del state, fresh
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            state = train.main(ssd + ["--steps", str(CLI_RESUME_STEPS),
                                      "--resume", "--log-every", "1"])
        log(out.getvalue().strip())
        if f"resumed from step {CLI_STEPS} (data position {CLI_STEPS})" \
                not in out.getvalue() or state.step != CLI_RESUME_STEPS:
            raise AssertionError("cli: --resume did not continue from step "
                                 f"{CLI_STEPS}")
        with open(f"{tmp}/ssd/metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        if [r["step"] for r in recs] != list(range(1, CLI_RESUME_STEPS + 1)):
            raise AssertionError(f"cli: metrics.jsonl holds steps "
                                 f"{[r['step'] for r in recs]}")
        del state
        res = evaluate.main(ssd + ["--num-batches", "2"])
        if not (res["ema"] and res["step"] == CLI_RESUME_STEPS
                and 0.0 <= res["mAP"] <= 1.0):
            raise AssertionError(f"cli: evaluate gave step {res['step']}, "
                                 f"EMA {res['ema']}, mAP {res['mAP']}")
        counters = kernel_counters()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        for fn in counters.values():
            fn.launches = 0
        train.main(["--preset", "lighthead_xception", "--model-dir",
                    f"{tmp}/lighthead", "--steps", "2", *common_args])
        launches = {name: fn.launches for name, fn in counters.items()}
    return {"launches": launches, "evaluate": res,
            "expected": {"fused_sepconv": 0, "psroi_align": 2,
                         "psroi_align_backward": 2},
            "wall_s": [r["wall_time_s"] for r in recs]}




def fused(cfg):
    """``cfg`` with the backbone's stride-1 separable blocks on kernel B2,
    as config 3 runs it."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_fused_sepconv=True))


def main() -> int:
    smi = phase_device()
    from x_detector_tpu_torch.config import (lighthead_resnet50,
                                             lighthead_xception,
                                             ssd_resnet50, xdet_xception)
    phase_build()
    kernels = phase_kernels()

    paths = {}
    # config 3, the first main path: B2 14 times and B1's forward once a
    # batch
    cfg = fused(lighthead_xception(800))
    torch.cuda.reset_peak_memory_stats()
    paths["slice"] = res = run_slice(cfg, "cuda")
    check_slice("config 3", res, {"fused_sepconv": 14, "psroi_align": 1,
                                  "psroi_align_backward": 0})
    report_slice("slice: config 3 at 800 px, fused sepconv", res, BATCH)
    slice_reference_check(cfg.model, "cuda", ("rpn_cls", "rpn_loc"))
    torch.cuda.synchronize()

    # config 1: one VOC-sized image at a time, resized to 800 px on the
    # card; B1's forward once an image, B2 never
    cfg = lighthead_resnet50(800)
    torch.cuda.reset_peak_memory_stats()
    paths["config1"] = res = run_slice(cfg, "cuda", batches=CONFIG1_IMAGES,
                                       batch_size=1, raw_hw=CONFIG1_RAW_HW)
    check_slice("config 1", res, {"fused_sepconv": 0, "psroi_align": 1,
                                  "psroi_align_backward": 0})
    report_slice(f"config1: Light-Head + ResNet-50 at 800 px from "
                 f"{CONFIG1_RAW_HW[0]} x {CONFIG1_RAW_HW[1]} uint8 images",
                 res, 1)
    slice_reference_check(cfg.model, "cuda", ("rpn_cls", "rpn_loc"))
    torch.cuda.synchronize()

    # config 2 (SSD + ResNet-50) and xdet_xception with the fused separable
    # conv: no kernel, and B2 13 times a batch
    for path, cfg, per_batch in (
            ("ssd", ssd_resnet50(512), {"fused_sepconv": 0, "psroi_align": 0,
                                        "psroi_align_backward": 0}),
            ("xdet", fused(xdet_xception(512)), {"fused_sepconv": 13,
                                                 "psroi_align": 0,
                                                 "psroi_align_backward": 0})):
        torch.cuda.reset_peak_memory_stats()
        paths[path] = res = run_slice(cfg, "cuda", batch_size=SSD_BATCH)
        check_slice(cfg.model.name, res, per_batch)
        report_slice(f"{path}: {cfg.model.name} at 512 px, approx_prefilter="
                     f"{cfg.model.nms.approx_prefilter} (the exact top-k)",
                     res, SSD_BATCH)
        slice_reference_check(cfg.model, "cuda", ("cls_logits", "box_codes"))
        torch.cuda.synchronize()

    cfg = train_config()
    torch.cuda.reset_peak_memory_stats()
    paths["train"] = res = run_train(cfg, "cuda")
    check_train("config 4", res, {"fused_sepconv": 0, "psroi_align": 1,
                                  "psroi_align_backward": 1})
    if res["moved"] != res["params"]:
        raise AssertionError(f"config 4: only {res['moved']} of "
                             f"{res['params']} parameter tensors changed")
    report_train(f"train: config 4, batch {BATCH} at 800 px from "
                 f"{int(800 * CANVAS_SCALE)} px canvases", res, BATCH,
                 torch.cuda.max_memory_allocated())
    train_reference_check("cuda")
    torch.cuda.synchronize()

    # config 2's step (with its EMA shadow) and xdet_xception's (unfused):
    # no kernel of the port on either
    for path, preset in (("train_ssd", "ssd_resnet50"),
                         ("train_xdet", "xdet_xception")):
        cfg = ssd_train_config(preset)
        torch.cuda.reset_peak_memory_stats()
        paths[path] = res = run_train(cfg, "cuda")
        check_train(preset, res, {"fused_sepconv": 0, "psroi_align": 0,
                                  "psroi_align_backward": 0})
        if not all(m["ssd_num_fg"] > 0 for m in res["losses"]):
            raise AssertionError(f"{preset}: a step matched no anchor")
        if ("ema" in res) != (cfg.train.ema_decay > 0):
            raise AssertionError(f"{preset}: EMA shadow present "
                                 f"{'ema' in res}, preset decay "
                                 f"{cfg.train.ema_decay}")
        report_train(f"{path}: {preset}, batch {SSD_BATCH} at 512 px from "
                     f"{int(512 * CANVAS_SCALE)} px canvases", res,
                     SSD_BATCH, torch.cuda.max_memory_allocated())
        ssd_train_reference_check(ssd_train_config(preset, 128, 2), "cuda")
        torch.cuda.synchronize()

    # the CLIs: config 2 trained, checkpointed, resumed and evaluated; a
    # Light-Head run through B1's forward and backward
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    paths["cli"] = res = run_cli("cuda")
    if res["launches"] != res["expected"]:
        raise AssertionError(f"cli: the Light-Head run launched "
                             f"{res['launches']}, expected "
                             f"{res['expected']}")
    log(f"cli: config 2 trained {CLI_STEPS} steps, reloaded bit for bit, "
        f"resumed to {CLI_RESUME_STEPS} (metrics.jsonl wall_time_s "
        f"{res['wall_s']}); evaluate on the EMA shadow: mAP "
        f"{res['evaluate']['mAP']:.4f}; Light-Head 2 steps: launches "
        f"{res['launches']}; {time.perf_counter() - t0:.1f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    for k in kernels:
        by_path = {path: run["launches"][k["name"]]
                   for path, run in paths.items()}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
