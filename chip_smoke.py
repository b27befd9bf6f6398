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
                The int8 kernels run at every call shape of config 2's and
                config 3's backbones (read by hooks on one calibrate-mode
                pass): K3 then K1 or K2, each bitwise equal to its plain
                version, timed beside its bound, the plain version and, as
                yardsticks the port never calls, cuDNN's bf16 conv of the
                shape and torch._int_mm on the 1x1 stride-1 shapes. K1 runs
                on the route its shape's plan takes ("tma",
                csrc/int8_conv_tma.cu, or the first design, "mma", for the
                stems) and, in the same call, on the first design through
                the same wrapper and operator (first_design_planned), both
                held bitwise; the bounds count the input pixels some tap
                reads. K2 runs on its route ("tma", csrc/int8_dwconv_tma.cu,
                at every config 3 shape) dequantizing and quantizing on its
                store at a next conv's scale (held to the plain versions
                composed; its bound counts 1 byte an output), against K2
                dequantizing then K3 and against the first design ("simt",
                first_depthwise_design), all held bitwise. Every kernel and
                yardstick is also timed by the profiler's device time,
                which the small calls of config 2 need (CUDA events around
                wrapper calls read the host).
                N1, exact NMS's kernels (xdt::nms_suppress), at the shapes
                config 3 gives them: the proposal stage's 16 rows of 1000
                (serving) and 6000 (training) boxes and the serving tail's
                16 x 20 rows of 256, a fifth of the boxes zero; the flags
                bitwise the plain version's (the tile loop) on the same
                boxes, both timed by events and the kernels by the
                profiler's device time (mask and scan apart), beside the
                bound from the boxes read, the flags written and the IoU of
                every pair (ops.nms.bound_ms).
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
  7b. fast   -- MaxpoolNMS (ops/maxpool_nms.py): config 3 with
                proposals.fast_nms and config 2 with nms.fast_mode, each
                beside its exact path on the same weights and images
                (run_fast): launches (config 3: B2 14 and B1's forward 1 a
                batch), exact NMS (chip_smoke.exact_suppressions: the
                launches of xdt::nms_suppress's kernels) never in config 3's
                proposal stage (the model's forward) and never at all in
                config 2's tail, where the exact paths ran it; both paths'
                batch ms in alternating rounds; config 3's fast batch under
                utils.profiling.trace (the trace must name B2's and B1's
                kernels) and timed by utils.profiling.DeviceTimer; its
                128 px card-vs-CPU check.
  7c. dense  -- config 3's fused model with Xception-lite's stage 1 dense
                (XceptionLite(dense_stages=1), built by dense_backbone): B2
                10 times a batch, B1's forward once; its batch ms against
                the separable model's in alternating rounds; the 128 px
                check of the dense model.
  8. int8    -- config 2, then config 3 (with its fused flag, which an
                int8 backbone does not take), in int8 at full width: the
                seeded weights calibrated on the card
                (quant.calibrate_backbone over INT8_CALIB_BATCHES batches
                of seeded uint8 images through preprocess_for_eval; every
                range positive), then build_eval_fn on the float paths'
                images: launches (config 2: K1 53 and K3 53 a batch;
                config 3: K1 20, K2 16, K3 20 and B1's forward 1, each
                separable block's K2 quantizing on its store for the
                pointwise conv; B2 never), K1's by route (the stem on
                "mma", the other 52 / 19 on "tma"), K2's by route (all
                "tma") and mode, the detection invariants, batch time,
                images/s and peak memory beside the bf16 path's (phases 6
                and 4), and batch ms in alternating rounds of the bf16
                path, the int8 path, the int8 path with the first design's
                K1 on every call and, on config 3, the int8 path with PR
                10's K2 and a K3 before every pointwise conv (the last two
                sides' detections held bitwise to the int8 path's);
                the prequantized model's outputs and detections against
                the in-graph model's, bit for bit; at 128 px, the card
                (bf16, kernels) against the CPU (bf16, plain versions)
                with the card's ranges, within INT8_CONTROL_FACTOR times
                the same comparison's gap for the float model.
  8b. serve  -- export and serving (cli/export.py, serving.py): config 3
                (fused, raw RGB, letterbox) exported on the card as a
                container of buckets 1 (baked) and 16 (the weights as
                inputs), loaded through serving.load_container alone; at
                each bucket the same letterboxed batch (serving.letterbox_
                batch of seeded 375 x 500 images) through the container and
                through the eager path (preprocess_for_eval, build_eval_fn,
                the unscale): all four outputs bit for bit, and B2 14 times,
                B1's forward once and its backward never a batch on each;
                each bucket's export seconds, the loaded against the eager
                median batch ms, and at bucket 1 the baked program against
                one taking the weights as inputs. Then int8 config 2
                (calibrated over INT8_CALIB_BATCHES seeded batches,
                prequantized, pre-whitened inputs) as a container of bucket
                8: bit for bit against the eager prequantized model, K1 53,
                K3 53 and K2 0 a batch. Then cli.predict --artifact on a
                photo-sized JPEG (make_voc_mini.write_voc_tree): its PNG.
                First, the operator boundary's host cost a call
                (dispatch_cost: K3 and K1 through xdt against their CUDA
                implementations called directly); after the int8
                container, its cost to int8 config 2's eager batch
                (boundary_in_model, the same comparison in the model).
 9. train   -- config 4 (the same model as config 3, training, batch 16 at
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
 10. train_ssd -- config 2 (SSD + ResNet-50 training, batch 8 at 512 px,
                EMA 0.99): synthetic batches made on the card on 614 px
                canvases -> preprocess_batch_for_train -> the step, one
                warm-up and TRAIN_STEPS timed steps: no kernel launches,
                finite losses, positives matched, changed parameters, a
                shadow that moved and is d * e + (1 - d) * p of its inputs;
                step time, images/s, peak memory; then one step at 128 px
                from the same weights and batch on the card (bf16) against
                the CPU (fp32; and bf16, as a control): the loss and the SSD
                head's gradients and updates.
 11. train_xdet -- the same for xdet_xception (no shadow; trained unfused,
                so B2 never launches).
 11b. train_act8 -- config 4's step with backbone_quant="act8" (QuantConv's
                training probe): K3 once a backbone conv (36) a step, B1
                once each way, every parameter moved, step ms against the
                bf16 step's; then at the stage-1 shape [16, 128, 200, 200]
                the act8 depthwise and pointwise convs against the plain
                conv under cuDNN deterministic (act8_grad_check): output
                and dL/dx bitwise, 0 < dL/dk relative RMS < 0.02.
 11c. train_remat -- 3 steps of config 4, then of config 2 (ResNet, EMA),
                with backbone_remat_stages=2 against 3 without, from the
                same seed, batches and draws, under
                torch.use_deterministic_algorithms(True, warn_only=True)
                and cuDNN deterministic (run_remat_pair): every tensor of
                the train state bitwise equal; each side's peak memory and
                step ms; the ops warned as having no deterministic version.
 11d. dense_train -- config 4's step with dense_stages=1: B1 once each way.
 12. cli     -- the train and evaluate CLIs in this process, into a
                temporary directory: config 2 for 4 steps with a checkpoint
                every 2, the checkpoint reloaded bit for bit (step and data
                position 4), --resume to 6 steps, metrics.jsonl holding
                steps 1-6; cli.evaluate on that directory (the EMA shadow, a
                finite mAP in [0, 1]); then lighthead_xception (config 4's
                model) for 2 steps: B1's forward and backward once a step.
 12b. cli_rest -- cli.train --pretrained --tensorboard on
                lighthead_resnet50 (run_cli_rest): a .pth under
                torchvision's names and ResNet-50's shapes, of seeded values
                (torchvision_resnet50_state), grafted bit for bit, 2 steps
                (B1 once each way a step); the event file read back by
                utils.logging.read_events, CRCs checked, holding every
                scalar of metrics.jsonl.
 13. dp      -- config 5, data-parallel Light-Head training: (a) at its
                global batch of 128 on this card, world 1 over a real NCCL
                group, 16 microbatches of 8 at 800 px, one warm-up and
                DP_STEPS timed steps (B1's forward and backward 16 times
                each a step; step ms, images/s, peak memory), then the
                flattened all-reduce timed alone; (b) two gloo ranks on
                this card (NCCL takes one rank a card), 8 images each, 2
                steps: their train states (parameters, BatchNorm stats,
                momentum, step) bitwise equal to each other and to this
                card's grad_accum_steps = 2 step on the same 16 images and
                RPN draws; (c) cli.train --num-devices 2 on one card raises,
                naming the visible count.
 14. data    -- the native loader built from the port's C++ (the decoder it
                found printed); the committed mini VOCdevkit through
                cli.convert_voc; cli.inspect_data over those shards (a PNG
                an image id); its JPEGs decoded against the pixels
                libjpeg gives (the committed .npz); a resumed stream
                bitwise equal to the uninterrupted one; DATA_PHOTOS
                photo-sized JPEGs (500 x 375, 4:2:0) made with PIL through
                cli.convert_voc: the loader's images/s on this host with a
                worker thread a core and with one, then cli.train
                --data-dir (config 4's model, DATA_STEPS steps: B1 once a
                step each way) and cli.evaluate --data-dir (a finite mAP
                in [0, 1]) over them.
 15. learn   -- tools/overfit.py: the JAX test's 8 fixed images (4 classes,
                64 px, resized to the model's size) overfit at the test's
                size (the thin SSD, 120 steps, fp32: the last loss below
                0.2, the mAP above 0.95), then at full width in bf16,
                config 3's Light-Head at 800 px and config 2's SSD at 512
                px, batch 8, LEARN_OVERFIT_STEPS steps (the mAP above
                0.95); B1 once a Light-Head step each way. Then the short
                capstone (tools/fast_nms_ab.train_synthetic): the first
                LEARN_STEPS steps of config 3's 3000-step recipe at batch
                16 (train images/s; B1 once a step each way; the loss's
                mean falls from the first LEARN_LOSS_WINDOW steps to the
                last), then held-out mAP on LEARN_EVAL_BATCHES batches,
                exact, approx (bitwise the exact detections), MaxpoolNMS
                (B2 14 and B1's forward 1 a batch each) and int8
                calibrated on the trained model (K1 20, K2 16, K3 20 a
                batch).
 16. tools   -- the last tools, each path a fresh process of its own, each
                phase timed (phase_tools): rehearse (tools.rehearse_config5
                --full-width: config 5's model at its global batch of 128,
                world 1 x 16 microbatches of 8, REHEARSE_STEPS steps, a
                checkpoint every REHEARSE_CKPT_EVERY, run B killed after
                step 2: runs A and C bitwise equal in every tensor of the
                train state; each child's B1 16 times a step each way; its
                step seconds and the ops warned as nondeterministic);
                multihost (cli.train --preset lighthead_xception --steps 2
                under torch.distributed.run --standalone with
                XDET_MULTIHOST=1 over NCCL, world 1, and world 2 where two
                cards are visible, each rank through counted_cli_train: rc
                0, the checkpoint at step 2 and data position 2,
                metrics.jsonl steps [1, 2], B1 twice each way a rank; at
                world 1 the first-step loss equal to the same CLI run
                plainly, and how far apart the final states are);
                voc_pipeline (tools.rehearse_voc_pipeline with
                lighthead_xception at 800 px, photo-sized JPEGs decoded by
                nvJPEG, --fused-sepconv on export: every stage passes; the
                reloaded program B2 14 times and B1's forward once on its
                batch; seconds by stage); parity1 (config 1 trained
                PARITY1_STEPS steps by cli.train, tools.config1_parity's
                record on the card, fp32 with TF32 off, B1's forward once
                and B2 never, then on the CPU with --compare against it:
                PARITY OK).
 17. bench   -- the eleven measurement tools (x_detector_tpu_torch/tools/
                bench_*.py), each in this process through its main() at its
                preset widths with few iterations, each a path of its own
                on the kernels line (phase_bench): bench_cpu_config1 (config
                1 at 800 px on this machine's CPU, --iters 3: no launch);
                bench_detect and bench_infer on config 3 (B2 14 and B1 1 a
                batch), bench_infer on config 1 (batch 1: B1 1) and config
                2 (none); bench_train (config 4: B1 once each way a step);
                bench_serving eager at buckets 1, 4, 8 and 16 and from a
                container of buckets 4 and 8 (B2 14 and B1 1 a batch on
                both); bench_preproc, bench_nms_tail, bench_psroi (B1 runs),
                bench_fused_sepconv (B2 14 fused, 0 unfused, B1 1 a batch
                end to end), bench_int8 (K1, K2 and K3 run) and
                bench_depthwise (no kernel). Every row of a card tool names
                the card's name and power limit; a tool that fails fails
                the run.
The line before the last is one JSON object with the kernels' results; the
last line is {"ok": true, "device": {...}}. ``chip_smoke.py
--counted-cli-train ARGS`` runs cli.train ARGS and prints its launch
counts: the multihost phase's torchrun ranks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

import torch

from x_detector_tpu_torch.config import (lighthead_resnet50,
                                         lighthead_xception)
from x_detector_tpu_torch.ops import nms as nms_ops
from x_detector_tpu_torch.ops.fused_sepconv import unfused_cudnn
from x_detector_tpu_torch.train.train_state import (snapshot_differs,
                                                    train_snapshot)
from x_detector_tpu_torch.utils.profiling import (alternating_ms, card_label,
                                                  cuda_ms)

SEED = 0
BATCH = 16
SLICE_BATCHES = 3          # timed batches, after one warm-up batch
TRAIN_STEPS = 3            # timed train steps, after one warm-up step
CANVAS_SCALE = 1.2         # raw train canvases: 960 px for 800 px inputs

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
# The int8 paths: calibrated over this many seeded batches. Their 128 px
# check holds the card (bf16, kernels) to the CPU (bf16, plain versions):
# the int8 convs are bitwise equal there, but the rest (heads, BatchNorm's
# rsqrt) rounds differently, and a gap that moves an input across a
# rounding boundary of the int8 grid moves the output by one grid step.
# The control is the same comparison for the float model; the int8 gap
# must stay within INT8_CONTROL_FACTOR times the control's.
INT8_CALIB_BATCHES = 2
INT8_CONTROL_FACTOR = 4.0
# serve: config 3's container buckets, bucket 1 baked; counted batches a
# bucket and path after a warm-up; config 2's int8 container bucket
SERVE_BUCKETS, SERVE_BAKED, SERVE_BATCHES = (1, 16), (1,), 3
SERVE_INT8_BUCKET = 8
SERVE_RAW_HW = (375, 500)
# Paths compared by host clock run in alternating rounds of a few batches
# each: the host drifts between fast and slow states within one process,
# and a round of each side sees the same state. Each side's median and
# best round are reported (utils.profiling.alternating_ms, whose defaults
# these are).
ROUNDS, ROUND_BATCHES = 10, 3
# int8 against int8 with the first design's K1: config 2's batch is
# host-bound, so the difference is near the rounds' spread
INT8_ROUNDS = 30
# the operator boundary's host cost: alternating rounds of calls of K3 and
# K1 on tiny tensors, through the operator and its CUDA implementation
DISPATCH_ROUNDS, DISPATCH_CALLS = 10, 200
CLI_STEPS, CLI_RESUME_STEPS = 4, 6
# config 5 on one card (config.config5()): world 1 x grad_accum_steps 16 x
# 8 images = 128; the gloo pair: 8 images a rank
DP_MICROBATCH, DP_STEPS = 8, 2
DP_PAIR_STEPS, DP_PAIR_TIMEOUT_S = 2, 300
# rehearse: tools.rehearse_config5 at config 5's full width and global
# batch on this card (world 1 x 16 microbatches of DP_MICROBATCH), a
# checkpoint every 2 steps, so run B is killed after step 2
REHEARSE_STEPS, REHEARSE_CKPT_EVERY, REHEARSE_TIMEOUT_S = 6, 2, 600
MULTIHOST_TIMEOUT_S = 300
# parity1: config 1 trained this many steps on the card (cli.train's
# defaults: batch 8, bf16, warm-up 500) before its record is taken on the
# card and on the CPU
PARITY1_STEPS, PARITY1_TIMEOUT_S = 50, 300
DATA_STEPS, DATA_RATE_BATCHES, DATA_CANVAS = 3, 10, 960
# photo-sized JPEGs made here with PIL (500 x 375, 4:2:0, ~79 KB, as VOC's
# photos are sized and sampled) for the loader's rate and the CLIs
DATA_PHOTOS = 48
# learn: tools/overfit.py's 8 fixed images at the test's size (its 120
# steps in fp32; JAX's gates, the last loss below 0.2 and the mAP above
# 0.95) and at full width in bf16 (the mAP gate), config 3's Light-Head at
# 800 px and config 2's SSD at 512 px, batch 8. Steps from the first card
# calls (H100): the SSD reached mAP 1.0 by step 100 (loss 0.13; 0.047 by
# 150), the Light-Head 0.98 by 150 and 1.0 by 200 (loss 0.23; 0.16 by 250)
LEARN_OVERFIT_STEPS = {"small": 120, "lighthead": 300, "ssd": 150}
# the short capstone: the first LEARN_STEPS steps of config 3's 3000-step
# recipe (tools/fast_nms_ab.capstone_config; a shorter recipe puts its lr
# boundaries inside the 200 warm-up steps, which the schedule refuses),
# scored on LEARN_EVAL_BATCHES held-out batches, int8 calibrated on
# LEARN_CALIB_BATCHES; the loss must fall from the mean of the first
# LEARN_LOSS_WINDOW steps to the mean of the last
LEARN_STEPS, LEARN_RECIPE_STEPS = 200, 3000
LEARN_EVAL_BATCHES, LEARN_CALIB_BATCHES = 2, 2
LEARN_LOSS_WINDOW = 20
# The loader's decoder against the pixels libjpeg decodes, (max, mean) abs
# difference in 8-bit levels. libjpeg must give its own bits. nvJPEG runs
# another IDCT (the JPEG standard lets a sample round 1 level either way);
# its planes are then upsampled and converted by the loader as libjpeg
# does it, so the colour conversion's gains (up to 1.77 for blue) scale
# the IDCT's levels: a few, at any chroma sampling.
PIXEL_TOL = {"libjpeg": (0, 0.0), "nvjpeg": (4, 1.0)}
# Two gloo ranks against the card's accumulation of 2: bitwise, every
# tensor of the train state. Each rank's shard is one microbatch of the
# accumulation, run by the same kernels with cuDNN in deterministic mode
# (B1's kernels are deterministic by design), a two-term sum commutes and
# the halving is exact.


def log(*args) -> None:
    print(*args, flush=True)


def max_rel_err(got: torch.Tensor, ref: torch.Tensor):
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    return err, scale


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = card_label()
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
    from x_detector_tpu_torch.utils.profiling import device_ms
    fwd_device_ms = lambda fn: device_ms(fn, 50, keep="psroi")
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
                 "bound": pa.bound_ms(feat, rois)}
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
    bwd_bound = pa.bound_ms(feat, rois)
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
          "bound": pa.bound_ms(feat1, rois1)}
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


def nms_rows(gen, rows: int, n: int, dev, invalid: float = 0.2,
             clusters: int = 8) -> torch.Tensor:
    """[rows, n, 4] fp32 boxes as ``nms_padded`` hands them to
    ``xdt::nms_suppress``: around ``clusters`` centres a row, so that many
    overlap, in a random (score) order, a share ``invalid`` of them zero."""
    centres = torch.rand(rows, clusters, 2, generator=gen, device=dev)
    which = torch.randint(0, clusters, (rows, n), generator=gen, device=dev)
    c = torch.gather(centres * 0.8 + 0.1, 1,
                     which[..., None].expand(-1, -1, 2))
    c = c + torch.randn(rows, n, 2, generator=gen, device=dev) * 0.03
    hw = torch.rand(rows, n, 2, generator=gen, device=dev) * 0.2 + 0.05
    boxes = torch.cat([c - hw / 2, c + hw / 2], dim=-1)
    drop = torch.rand(rows, n, generator=gen, device=dev) < invalid
    return torch.where(drop[..., None], 0.0, boxes).contiguous()


def nms_shapes(model_cfg, batch: int = BATCH) -> dict:
    """Exact NMS's (rows, boxes a row, IoU threshold) in ``model_cfg``'s
    Light-Head: the proposal stage's in serving and in training, and the
    serving tail's (an image x class a row, ``batched_multiclass_nms``'s
    default of 256 candidates)."""
    import inspect
    p = model_cfg.proposals
    tail = inspect.signature(nms_ops.batched_multiclass_nms).parameters[
        "nms_candidates"].default
    return {"serve": (batch, p.pre_nms_topk_eval, p.nms_threshold),
            "train": (batch, p.pre_nms_topk, p.nms_threshold),
            "tail": (batch * (model_cfg.num_classes - 1), tail,
                     model_cfg.nms.iou_threshold)}


def phase_nms_kernels(device="cuda", shapes=None, reps: int = 20) -> dict:
    """N1, exact NMS's kernels, at ``shapes`` (by default config 3's,
    ``nms_shapes``): on the same seeded boxes the operator's flags must
    equal the plain version's (``suppress_plain``, the tile loop, on the
    same device) bit for bit, and each call add ``nms_ops.KERNELS`` to
    the launches. Each shape's CUDA-event ms of the operator and of the
    plain version, the profiler's device ms of the mask and scan kernels
    (on a card), the bound (``nms_ops.bound_ms``) and the share of boxes
    suppressed."""
    from x_detector_tpu_torch.utils.profiling import kernel_device_ms
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for tag, (rows, n, thr) in (shapes or nms_shapes(
            lighthead_xception().model)).items():
        boxes = nms_rows(gen, rows, n, dev)
        before = nms_ops.nms_suppress.launches
        got = nms_ops.nms_suppress(boxes, thr)
        made = nms_ops.nms_suppress.launches - before
        want = nms_ops.suppress_plain(boxes, thr)
        if not torch.equal(got, want):
            raise AssertionError(
                f"N1 nms_suppress {tag} [{rows},{n},4] at {thr}: "
                f"{int((got != want).sum())} flags differ from the plain "
                f"version's")
        if made != (nms_ops.KERNELS if cuda else 0):
            raise AssertionError(f"N1 nms_suppress {tag}: a call added "
                                 f"{made} launches")
        call = lambda: nms_ops.nms_suppress(boxes, thr)
        ms = cuda_ms(call, reps=reps) if cuda else None
        device_ms = ({k: v for k, v in kernel_device_ms(call, reps).items()
                      if "nms_" in k} if cuda else {})
        bound = nms_ops.bound_ms(boxes)
        out[tag] = {
            "shape": [rows, n], "threshold": thr, "ms": ms,
            "plain_ms": (cuda_ms(lambda: nms_ops.suppress_plain(boxes, thr),
                                 warmup=1, reps=5) if cuda else None),
            "mask_device_ms": sum(v for k, v in device_ms.items()
                                  if "mask" in k),
            "scan_device_ms": sum(v for k, v in device_ms.items()
                                  if "scan" in k),
            "device_ms": sum(device_ms.values()),
            "bound_ms": bound[0], "bound_by": bound[1],
            "suppressed": float(want.float().mean()),
            "invalid": float((boxes.abs().sum(-1) == 0).float().mean())}
        t = out[tag]
        log(f"N1 nms_suppress {tag} [{rows},{n},4] fp32 at IoU {thr}: flags "
            f"bitwise the plain version's ({t['suppressed']:.1%} "
            f"suppressed, {t['invalid']:.1%} of the boxes zero); kernels "
            f"{t['device_ms']:.4f} ms device time (mask "
            f"{t['mask_device_ms']:.4f}, scan {t['scan_device_ms']:.4f}; "
            f"{t['ms'] or 0.0:.4f} ms by events around the wrapper), bound "
            f"{bound[0]:.4f} ms ({bound[1]}), "
            f"{bound[0] / max(t['device_ms'], 1e-9):.1%} of it; plain "
            f"{t['plain_ms'] or 0.0:.4f} ms")
    return out


def n1_kernel_line(n1: dict) -> dict:
    """The kernels line's entry of N1: the serving proposal stage's shape
    in the fields every entry has, the training stage's and the serving
    tail's under their tags."""
    s = n1["serve"]
    row = {"name": "nms_suppress", "route": "cuda",
           "source": "x_detector_tpu_torch/csrc/nms.cu",
           "replaces": "x_detector_tpu/ops/nms.py:186", "max_abs_err": 0.0,
           "ms": s["ms"], "plain_ms": s["plain_ms"],
           "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
           "library_ms": None, "device_ms": s["device_ms"],
           "mask_device_ms": s["mask_device_ms"],
           "scan_device_ms": s["scan_device_ms"], "shape": s["shape"]}
    for tag in ("train", "tail"):
        row.update({f"{tag}_{k}": v for k, v in n1[tag].items()
                    if k not in ("threshold", "suppressed", "invalid")})
    return row


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


def dense_backbone(model, model_cfg, dense_stages: int) -> None:
    """Put in ``model.backbone`` the config's Xception-lite built with
    ``dense_stages`` (a constructor argument of the backbone, as in the JAX
    package; no ModelConfig field), its weights left to be set."""
    from x_detector_tpu_torch.models.lighthead import LightHeadRCNN
    from x_detector_tpu_torch.models.xception import XceptionLite
    kw = {}
    if model_cfg.backbone_stages is not None:
        kw["units_per_stage"] = tuple(model_cfg.backbone_stages)
    if model_cfg.backbone_widths is not None:
        kw["widths"] = tuple(model_cfg.backbone_widths)
    model.backbone = XceptionLite(
        dilate_c5=isinstance(model, LightHeadRCNN), dense_stages=dense_stages,
        fused_sepconv=model_cfg.backbone_fused_sepconv,
        remat_stages=model_cfg.backbone_remat_stages,
        quant=model_cfg.backbone_quant, dtype=model.backbone.dtype, **kw)


def slice_model(model_cfg, device, seed: int = SEED, dense_stages: int = 0,
                dtype: torch.dtype = torch.bfloat16):
    """The config's model with seeded random weights and BatchNorm
    statistics moved off their initial values, so the folded affine is not
    identity; with ``dense_stages``, its Xception-lite's first stages dense
    (``dense_backbone``)."""
    from x_detector_tpu_torch.inference import build_model
    from x_detector_tpu_torch.models.layers import BatchNorm2D, init_flax_like
    model = build_model(model_cfg, "cpu", seed=seed, dtype=dtype)
    if dense_stages:
        dense_backbone(model, model_cfg, dense_stages)
        init_flax_like(model, torch.Generator().manual_seed(seed))
        model.eval()
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
              raw_hw=None, model=None, keep_path: bool = False) -> dict:
    """Drive an inference path: seeded uint8 images (``raw_hw`` high and
    wide, the canvas by default) -> preprocess_for_eval -> build_eval_fn,
    one warm-up batch then ``batches`` timed ones, on ``model`` (by default
    ``slice_model``'s). Returns every kernel's launch count over all of
    them (and B2's by route; with ``backbone_quant`` also the int8
    kernels', and K1's by route, ``int8_routes``; and ``suppress``, exact
    NMS's suppressions, ``suppress_counts``), what the model should give (B2
    a fused block a batch, B1's forward one a batch for Light-Head, B1's
    backward none, exact NMS's kernels ``nms_launches``; K1 a dense
    QuantConv, K2 a depthwise one, K3 each), the timed seconds per batch,
    the anchor count and the detections of the last batch; with
    ``keep_path`` also the path (``detect``, uint8 images to detections)
    and those images (``u8``)."""
    from x_detector_tpu_torch.data.augment import preprocess_for_eval
    from x_detector_tpu_torch.inference import build_eval_fn
    from x_detector_tpu_torch.ops import fused_sepconv as fs
    device = torch.device(device)
    if model is None:
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
    counters = path_counters(cfg.model.backbone_quant is not None)
    reset_counters(counters, device)
    if cfg.model.backbone_quant is not None:
        from x_detector_tpu_torch.ops import int8_conv as q8
    seconds = []
    with suppress_counts(model) as suppress:
        for u8 in images:
            t0 = time.perf_counter()
            det = detect(preprocess_for_eval(u8, cfg.data))
            sync()
            seconds.append(time.perf_counter() - t0)
            check_detections(*det, batch_size, cfg.model.nms.max_output)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    n = len(images)
    expected = {"fused_sepconv": fused_blocks(model) * n,
                "psroi_align": n if cfg.model.family == "lighthead" else 0,
                "psroi_align_backward": 0,
                "nms_suppress": nms_launches(cfg.model) * n}
    if cfg.model.backbone_quant is not None:
        expected.update({k: v * n for k, v in int8_calls(model).items()})
    return {"launches": launches, "batches": n, "suppress": suppress,
            "routes": dict(fs.fused_separable_conv.route_launches),
            **({"int8_routes": dict(q8.int8_conv2d.route_launches),
                "dw_routes": dict(q8.int8_depthwise_conv2d.route_launches),
                "dw_modes": dict(q8.int8_depthwise_conv2d.mode_launches)}
               if cfg.model.backbone_quant is not None else {}),
            "expected": expected,
            "seconds": seconds[1:], "anchors": model.anchors.shape[0],
            "detections": det, "peak": peak, **({
                "detect": lambda u8: detect(preprocess_for_eval(u8,
                                                                cfg.data)),
                "u8": images[-1]} if keep_path else {})}


def exact_suppressions() -> int:
    """Exact NMS's work so far in this process: the calls of the plain
    version's host-checked fixpoint (``xdt::self_suppress``, the CPU) and
    the launches of ``xdt::nms_suppress``'s kernels (the card)."""
    from x_detector_tpu_torch.ops import nms
    return nms.self_suppress.calls + nms.nms_suppress.launches


@contextlib.contextmanager
def suppress_counts(model):
    """Within: exact NMS's suppressions (``exact_suppressions``) counted,
    into the dict yielded, as "all" and as "forward", those made inside
    ``model``'s forward (for Light-Head, the proposal stage's; the rest are
    the final per-class NMS's)."""
    counts = {"all": 0, "forward": 0}
    start = {}

    def pre(module, args):
        start["calls"] = exact_suppressions()

    def post(module, args, out):
        counts["forward"] += exact_suppressions() - start["calls"]

    hooks = (model.register_forward_pre_hook(pre),
             model.register_forward_hook(post))
    before = exact_suppressions()
    try:
        yield counts
    finally:
        counts["all"] = exact_suppressions() - before
        for h in hooks:
            h.remove()


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
        f"{res['peak'] / 2**30:.2f} GiB; "
        f"{res['anchors']} anchors; {n_valid} valid detections in the last "
        f"batch")


def named_outputs(out) -> dict:
    """A model's outputs by name: Light-Head's dict, SSD's pair."""
    if isinstance(out, dict):
        return out
    return dict(zip(("cls_logits", "box_codes"), out))


def slice_reference_check(model_cfg, device, keys,
                          dense_stages: int = 0) -> float:
    """The same seeded weights at 128 px: bf16 with kernels on ``device``
    against fp32 plain versions on the CPU, on the outputs ``keys`` (for
    Light-Head the RPN's, before any discrete NMS choice; for SSD the raw
    head outputs); ``dense_stages`` as for ``slice_model``."""
    from x_detector_tpu_torch.inference import build_model
    from x_detector_tpu_torch.models.layers import prepare_for_inference
    cfg = dataclasses.replace(model_cfg, image_size=128)
    gpu = prepare_for_inference(slice_model(
        cfg, device, dense_stages=dense_stages).eval())
    cpu = build_model(cfg, "cpu", seed=None, dtype=torch.float32)
    if dense_stages:
        dense_backbone(cpu, cfg, dense_stages)
        cpu.eval()
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    prepare_for_inference(cpu)
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
    """B2's, B1's and exact NMS's wrappers
    (``ops.library.kernel_wrappers``)."""
    from x_detector_tpu_torch.ops.library import kernel_wrappers
    wrappers = kernel_wrappers()
    return {k: wrappers[k] for k in ("fused_sepconv", "psroi_align",
                                     "psroi_align_backward", "nms_suppress")}


def nms_launches(model_cfg, train: bool = False) -> int:
    """Exact NMS's kernel launches (``xdt::nms_suppress``, ``nms_ops.
    KERNELS`` a call) in a forward of ``model_cfg``'s model in training
    mode (``train``), or in a forward and its detections: Light-Head's
    proposal stage unless ``proposals.fast_nms``; then the per-class tail,
    which Light-Head always runs exactly and SSD unless ``nms.fast_mode``."""
    lighthead = model_cfg.family == "lighthead"
    calls = int(lighthead and not model_cfg.proposals.fast_nms)
    if not train:
        calls += int(lighthead or not model_cfg.nms.fast_mode)
    return nms_ops.KERNELS * calls


def int8_counters():
    """The int8 kernels' wrappers, read on the int8 paths."""
    from x_detector_tpu_torch.ops.library import kernel_wrappers
    wrappers = kernel_wrappers()
    return {k: wrappers[k] for k in ("int8_conv", "int8_dwconv",
                                     "quantize_s8")}


def path_counters(int8: bool = True) -> dict:
    """The wrappers a path reads: B2's, B1's and exact NMS's, and with
    ``int8`` K1-K3's."""
    return {**kernel_counters(), **(int8_counters() if int8 else {})}


def reset_counters(counters, device=None) -> None:
    """After a sync on ``device`` (a card), every count of ``counters``
    and B2's and the int8 kernels' counts by route and mode back to 0."""
    from x_detector_tpu_torch.ops import fused_sepconv as fs
    from x_detector_tpu_torch.ops import int8_conv as q8
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    fs.reset_launches()
    q8.reset_launches()
    for fn in counters.values():
        fn.launches = 0


def quantizing_blocks(model) -> int:
    """The separable blocks of ``model`` whose depthwise conv (K2)
    quantizes its output for the pointwise conv (``quantizes_on_store``):
    one K3 launch fewer each a forward."""
    from x_detector_tpu_torch.models.layers import SeparableConvBN
    return sum(1 for m in model.modules()
               if isinstance(m, SeparableConvBN) and m.quantizes_on_store)


def int8_calls(model) -> dict:
    """The int8 kernels' launches per forward of an int8 ``model``: K1 a
    dense QuantConv, K2 a depthwise one, K3 before each but the pointwise
    convs whose input K2 quantized (``quantizing_blocks``)."""
    from x_detector_tpu_torch import quant
    convs = quant.quant_convs(model).values()
    dense = sum(1 for m in convs if not m.depthwise)
    return {"int8_conv": dense, "int8_dwconv": len(convs) - dense,
            "quantize_s8": len(convs) - quantizing_blocks(model)}


def train_config(image_size: int = 800, batch_size: int = BATCH):
    """Config 4: the lighthead_xception preset training at batch 16 with no
    warmup (``tools/bench_train.py``'s configuration)."""
    from x_detector_tpu_torch.config import lighthead_xception
    cfg = lighthead_xception(image_size)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=batch_size, warmup_steps=0))


def train_state(cfg, device, seed: int = SEED, dense_stages: int = 0):
    """``create_model_and_state``'s state for ``cfg``; with
    ``dense_stages``, of the model whose Xception-lite has that many dense
    stages (``dense_backbone``), seeded the same way."""
    from x_detector_tpu_torch.models.layers import init_flax_like
    from x_detector_tpu_torch.train.schedule import make_optimizer
    from x_detector_tpu_torch.train.train_state import TrainState
    from x_detector_tpu_torch.train.trainer import create_model_and_state
    if not dense_stages:
        return create_model_and_state(cfg, device, seed=seed)
    from x_detector_tpu_torch.inference import build_model
    model = build_model(cfg.model, "cpu", seed=None)
    dense_backbone(model, cfg.model, dense_stages)
    init_flax_like(model, torch.Generator().manual_seed(seed))
    model = model.to(device).train()
    optimizer, schedule = make_optimizer(model, cfg.train)
    return TrainState.create(model, optimizer, schedule,
                             ema_decay=cfg.train.ema_decay)


def run_train(cfg, device, steps: int = TRAIN_STEPS, seed: int = SEED,
              dense_stages: int = 0) -> dict:
    """Drive the training path of either family: synthetic batches made on
    ``device`` on a 1.2x canvas -> preprocess_batch_for_train -> the train
    step, one warm-up step then ``steps`` timed ones. Returns the kernels'
    launch counts over all of them, what they should be, the timed seconds
    per step, the losses, how many parameter tensors moved, those that got
    a gradient in the last step and did not move ("stuck") and, with an
    EMA shadow, how many of its tensors moved and its largest gap to
    d * e + (1 - d) * p of the last step's inputs (with the scale). (An
    SSD step's loss reaches only the anchors it mines, so a level without
    one gives its head a zero gradient.) With ``backbone_quant`` the int8
    kernels are counted too; ``dense_stages`` as for ``train_state``.
    Expected launches: ``step_readings``."""
    from x_detector_tpu_torch.data.augment import preprocess_batch_for_train
    from x_detector_tpu_torch.data.synthetic import synthetic_batch_device
    from x_detector_tpu_torch.train.trainer import make_train_step
    device = torch.device(device)
    state = train_state(cfg, device, seed, dense_stages)
    step = make_train_step(state.model, cfg)
    before = [p.detach().clone() for p in state.model.parameters()]
    gen = torch.Generator(device=device).manual_seed(seed)
    canvas = int(cfg.data.image_size * CANVAS_SCALE)
    batch_size = cfg.train.batch_size
    sync = (lambda: torch.cuda.synchronize(device)) if (
        device.type == "cuda") else (lambda: None)
    counters = path_counters(cfg.model.backbone_quant is not None)
    reset_counters(counters, device)
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
    res = step_readings(cfg, state, before, steps, counters)
    res.update(seconds=seconds[1:], losses=losses)
    params = list(state.model.named_parameters())
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


def step_readings(cfg, state, before, steps: int, counters) -> dict:
    """After one warm-up and ``steps`` steps from parameters ``before``:
    the kernels' launches (``counters``, zeroed before the first step),
    what they should be (per microbatch, one forward, for Light-Head one
    PSROIAlign each way and its proposal stage's exact NMS, the fused
    blocks the model in training mode takes and, with ``backbone_quant`` "act8", K3 once a backbone conv),
    how many parameter tensors moved, and those that got a gradient in the
    last step and did not ("stuck")."""
    from x_detector_tpu_torch import quant
    params = list(state.model.named_parameters())
    moved = [not torch.equal(b, p.detach()) for b, (_, p) in
             zip(before, params)]
    forwards = (steps + 1) * cfg.train.grad_accum_steps
    b1 = forwards if cfg.model.family == "lighthead" else 0
    expected = {"fused_sepconv": forwards * fused_blocks(state.model),
                "psroi_align": b1, "psroi_align_backward": b1,
                "nms_suppress": forwards * nms_launches(cfg.model,
                                                        train=True)}
    if cfg.model.backbone_quant is not None:
        expected.update(int8_conv=0, int8_dwconv=0, quantize_s8=forwards * len(
            quant.quant_convs(state.model)))
    return {"launches": {name: fn.launches for name, fn in counters.items()},
            "expected": expected,
            "moved": sum(moved), "params": len(moved),
            "stuck": [n for m, (n, p) in zip(moved, params)
                      if not m and bool(p.grad.any())]}


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
        reset_counters(counters, device)
        train.main(["--preset", "lighthead_xception", "--model-dir",
                    f"{tmp}/lighthead", "--steps", "2", *common_args])
        launches = {name: fn.launches for name, fn in counters.items()}
    return {"launches": launches, "evaluate": res,
            "expected": {"fused_sepconv": 0, "psroi_align": 2,
                         "psroi_align_backward": 2,
                         "nms_suppress": 2 * nms_launches(
                             lighthead_xception().model, train=True)},
            "wall_s": [r["wall_time_s"] for r in recs]}



# ---------------------------------------------------------------------------
# dp: config 5 (data-parallel Light-Head training)
# ---------------------------------------------------------------------------

def run_dp(cfg, device, steps: int = DP_STEPS) -> dict:
    """(a) The data-parallel step at world 1 over a real process group
    (NCCL on a card, gloo on the CPU), driven by ``dp_scaling.run_steps``
    (one warm-up, ``steps`` timed); then the flattened all-reduce of the
    step's gradients, BatchNorm stats and metrics, timed alone. Returns
    ``run_train``'s readings with "allreduce_ms" and "allreduce_bytes"."""
    import torch.distributed as dist
    from x_detector_tpu_torch import dp_scaling
    from x_detector_tpu_torch.parallel import mesh
    device = torch.device(device)
    mesh.init_group(mesh.backend_for(device.type))
    try:
        counters = kernel_counters()
        reset_counters(counters, device)
        run = dp_scaling.run_steps(cfg, device, steps, seed=SEED)
        state = run.pop("state")
        res = step_readings(cfg, state, run["before"], steps, counters)
        res.update(seconds=run["seconds"], losses=run["losses"])
        res["allreduce_ms"] = dp_scaling.allreduce_ms(
            state.model, run["metrics"], device)
        res["allreduce_bytes"] = 4 * (
            sum(p.numel() for p in state.model.parameters())
            + sum(b.numel() for n, b in state.model.named_buffers()
                  if n.endswith(("running_mean", "running_var")))
            + len(run["metrics"]))
        del state, run
    finally:
        dist.destroy_process_group()
    return res


def dp_pair_batch(cfg, device, step: int):
    """The global batch and RPN draws of a two-rank step: made from a
    generator seeded by the step, so that every process makes the same."""
    from x_detector_tpu_torch.data.augment import preprocess_batch_for_train
    from x_detector_tpu_torch.data.synthetic import synthetic_batch_device
    from x_detector_tpu_torch.ops import anchors as anchor_lib
    from x_detector_tpu_torch.train import losses as loss_lib
    gen = torch.Generator(device=device).manual_seed(SEED + 100 + step)
    size, b = cfg.model.image_size, cfg.train.batch_size
    raw = synthetic_batch_device(gen, b, int(size * CANVAS_SCALE),
                                 cfg.data.max_gt_boxes)
    batch = preprocess_batch_for_train(gen, raw, cfg.data)
    pri = loss_lib.draw_rpn_priorities(gen, b, anchor_lib.rpn_anchors(
        size, cfg.model.anchors).shape[0])
    return batch, pri


def _dp_pair_rank(rank, world, cfg, device, steps, out_dir):
    """One of two gloo ranks that share one device: ``steps`` DP steps of
    its rows of ``dp_pair_batch``; saves its ``train_snapshot``. (This
    torch's gloo takes CUDA tensors: it copies them through the host
    itself.)"""
    from x_detector_tpu_torch.parallel.data_parallel import (
        make_dp_train_step)
    from x_detector_tpu_torch.parallel.mesh import shard_rows
    from x_detector_tpu_torch.train import losses as loss_lib
    from x_detector_tpu_torch.train.trainer import create_model_and_state
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cudnn.deterministic = True
    else:
        torch.set_num_threads(1)
    state = create_model_and_state(cfg, device, seed=SEED)
    step = make_dp_train_step(state.model, cfg)
    rows = shard_rows(cfg.train.batch_size, rank, world)
    for i in range(steps):
        batch, pri = dp_pair_batch(cfg, device, i)
        state, _ = step(state, {k: v[rows] for k, v in batch.items()},
                        priorities=loss_lib.RPNPriorities(
                            *(d[rows] for d in pri)))
    torch.save(train_snapshot(state), f"{out_dir}/rank{rank}.pt")


def run_dp_pair(cfg, device, steps: int = DP_PAIR_STEPS) -> dict:
    """(b) Two gloo ranks on one device (NCCL refuses two ranks on one
    card), ``cfg.train.batch_size / 2`` images each, ``steps`` steps; then,
    in this process, the single-device step with ``grad_accum_steps = 2``
    on the same global batches and draws. Fails unless the two ranks and
    the accumulation end with bitwise equal train states (``train_snapshot``:
    parameters, BatchNorm running stats, momentum, step). Returns the count
    of tensors compared, by kind."""
    from x_detector_tpu_torch.parallel import mesh
    from x_detector_tpu_torch.train import losses as loss_lib
    from x_detector_tpu_torch.train.trainer import (create_model_and_state,
                                                    make_train_step)
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        mesh.run_ranks(_dp_pair_rank, 2, "gloo", (
            cfg, str(device), steps, tmp), timeout_s=DP_PAIR_TIMEOUT_S)
        ranks = [torch.load(f"{tmp}/rank{r}.pt") for r in range(2)]
    differ = snapshot_differs(ranks[0], ranks[1])
    if differ:
        raise AssertionError(f"dp pair: the two ranks' train states differ "
                             f"after {steps} steps in {len(differ)} tensors: "
                             f"{differ[:5]}")
    acc = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, grad_accum_steps=2))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        state = create_model_and_state(acc, device, seed=SEED)
        step = make_train_step(state.model, acc)
        for i in range(steps):
            batch, pri = dp_pair_batch(acc, device, i)
            state, _ = step(state, batch, priorities=loss_lib.RPNPriorities(
                *pri))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    want = train_snapshot(state)
    del state
    differ = snapshot_differs(want, ranks[0])
    if differ:
        raise AssertionError(f"dp pair: the ranks' train state differs from "
                             f"the accumulation of 2 after {steps} steps in "
                             f"{len(differ)} tensors: {differ[:5]}")
    kinds = {}
    for k in want:
        kind = ("running stats" if k.endswith(("running_mean", "running_var"))
                else k.split(".")[0])
        kinds[kind] = kinds.get(kind, 0) + 1
    return kinds


def check_cli_refuses_two_ranks(device) -> str:
    """(c) ``cli.train --num-devices 2`` on ``device`` with fewer than 2
    cards visible raises, naming the count; returns the message."""
    from x_detector_tpu_torch.cli import train
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with tempfile.TemporaryDirectory() as tmp:
        try:
            train.main(["--preset", "lighthead_xception", "--num-devices",
                        "2", "--device", str(device), "--steps", "1",
                        "--model-dir", tmp])
        except RuntimeError as e:
            if f"{visible} visible" not in str(e):
                raise AssertionError(f"cli --num-devices 2 raised without "
                                     f"the visible count {visible}: {e}")
            return str(e)
    raise AssertionError("cli --num-devices 2 ran with fewer than 2 cards")


# ---------------------------------------------------------------------------
# data: VOC shards through the native loader into the CLIs
# ---------------------------------------------------------------------------

def loader_rate(shards, threads: int, canvas: int, batches: int,
                cuda_device: int = 0) -> float:
    """The native loader's images/s over ``shards`` with ``threads``
    workers: batches of 16 on letterboxed ``canvas`` px canvases, timed
    over ``batches`` after 3 of warm-up."""
    from x_detector_tpu_torch.data.native_loader import NativeLoader
    loader = NativeLoader(shards, canvas_size=canvas, max_gt=100,
                          batch_size=BATCH, shuffle=True, seed=SEED,
                          num_threads=threads, letterbox=True,
                          cuda_device=cuda_device)
    try:
        for _ in range(3):
            next(loader)
        t0 = time.perf_counter()
        for _ in range(batches):
            next(loader)
        return batches * BATCH / (time.perf_counter() - t0)
    finally:
        loader.close()


def want_ids(testdata: str) -> list:
    """The image ids of the committed mini VOC tree (its pixels' .npz)."""
    import os
    import numpy as np
    return sorted(np.load(os.path.join(testdata,
                                       "voc_mini_pixels.npz")).files)


def run_data(device, extra=(), steps: int = DATA_STEPS,
             rate_batches: int = DATA_RATE_BATCHES,
             canvas: int = DATA_CANVAS, photos: int = DATA_PHOTOS) -> dict:
    """The committed mini VOCdevkit -> ``cli.convert_voc`` -> shards;
    ``cli.inspect_data`` over them through the loader (a PNG an image, named
    by its id); each
    JPEG decoded by the loader against the pixels libjpeg decodes (the
    committed ``.npz``); a resumed stream against the uninterrupted one,
    bitwise. Then ``photos`` photo-sized JPEGs made here (PIL,
    ``make_voc_mini.write_voc_tree``) -> shards: the loader's images/s on
    this host (``canvas`` px canvases, batches of 16) with a thread a core
    and with one; ``cli.train --data-dir`` over them (config 4's model,
    ``steps`` steps, the kernels' counters reset just before) and
    ``cli.evaluate --data-dir``, each with ``--device device`` and
    ``extra``. Returns the readings and the train run's launches."""
    import os
    import shutil
    import numpy as np
    from x_detector_tpu_torch.cli import (convert_voc, evaluate,
                                          inspect_data, train)
    from x_detector_tpu_torch.data import native_loader
    from x_detector_tpu_torch.data.native_loader import NativeLoader
    from x_detector_tpu_torch.data.testdata import make_voc_mini
    here = os.path.dirname(os.path.abspath(__file__))
    testdata = os.path.join(here, "x_detector_tpu_torch", "data", "testdata")
    device = torch.device(device)
    cuda_device = torch.cuda.current_device() if device.type == "cuda" else 0
    out = {"decoder": native_loader.decoder()}
    limit = PIXEL_TOL[out["decoder"]]
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(testdata, "voc_mini"), f"{tmp}/voc")
        with contextlib.redirect_stdout(io.StringIO()):
            shards = convert_voc.main(["--voc-root", f"{tmp}/voc",
                                       "--output-dir", f"{tmp}/shards",
                                       "--shard-size", "4"])
        with contextlib.redirect_stdout(io.StringIO()):
            out["inspected"] = inspect_data.main([
                "--data-dir", f"{tmp}/shards", "--num-images",
                str(len(make_voc_mini.IMAGES)), "--output-dir",
                f"{tmp}/inspect", "--device", str(device)])
        pngs = sorted(os.listdir(f"{tmp}/inspect"))
        if out["inspected"] != len(make_voc_mini.IMAGES) or pngs != sorted(
                f"{i}.png" for i in want_ids(testdata)):
            raise AssertionError(f"data: cli.inspect_data wrote {pngs}")
        want = np.load(os.path.join(testdata, "voc_mini_pixels.npz"))
        out["pixels"] = {}
        for image_id, (_, _, mode, _, subsampling) in zip(
                sorted(want.files), make_voc_mini.IMAGES):
            path = f"{tmp}/voc/VOC2007/JPEGImages/{image_id}.jpg"
            with open(path, "rb") as f:
                got = native_loader.decode_jpeg(f.read(), cuda_device)
            if got.shape != want[image_id].shape:
                raise AssertionError(f"data: {image_id} decoded to "
                                     f"{got.shape}, libjpeg's "
                                     f"{want[image_id].shape}")
            diff = np.abs(got.astype(np.int16) - want[image_id])
            chroma = "420" if mode == "RGB" and subsampling == 2 else "full"
            out["pixels"][image_id] = (chroma, int(diff.max()),
                                       float(diff.mean()))
            if diff.max() > limit[0] or diff.mean() > limit[1]:
                raise AssertionError(
                    f"data: {image_id} ({chroma} chroma): {out['decoder']} "
                    f"pixels differ from libjpeg's by up to {diff.max()} "
                    f"(mean {diff.mean():.3g}); limits {limit}")
        kw = dict(canvas_size=canvas, max_gt=100, batch_size=BATCH,
                  shuffle=True, seed=SEED, num_threads=2,
                  letterbox=True, cuda_device=cuda_device)
        loaders = [NativeLoader(shards, **kw),
                   NativeLoader(shards, start_example=BATCH, **kw)]
        first = [next(loaders[0]) for _ in range(3)]
        for a, b in zip(first[1:], [next(loaders[1]) for _ in range(2)]):
            for k in a:
                if not np.array_equal(np.asarray(a[k]), np.asarray(b[k])):
                    raise AssertionError(f"data: the stream resumed at "
                                         f"{BATCH} differs in {k}")
        for loader in loaders:
            loader.close()

        t0 = time.perf_counter()
        make_voc_mini.write_voc_tree(f"{tmp}/photos", photos, seed=SEED)
        with contextlib.redirect_stdout(io.StringIO()):
            shards = convert_voc.main(["--voc-root", f"{tmp}/photos",
                                       "--output-dir", f"{tmp}/photo_shards"])
        out["photos_s"] = time.perf_counter() - t0
        jpegs = [f"{tmp}/photos/VOC2007/JPEGImages/{i:06d}.jpg"
                 for i in range(photos)]
        out["photo_kb"] = sum(map(os.path.getsize, jpegs)) / photos / 1e3
        cores = os.cpu_count() or 1
        out.update(cores=cores, rate_canvas=canvas, images_per_s={
            threads: loader_rate(shards, threads, canvas, rate_batches,
                                 cuda_device)
            for threads in sorted({cores, 1}, reverse=True)})

        common_args = ["--preset", "lighthead_xception", "--data-dir",
                       f"{tmp}/photo_shards", "--model-dir", f"{tmp}/model",
                       "--device", str(device), "--batch-size", str(BATCH),
                       *extra]
        counters = kernel_counters()
        reset_counters(counters, device)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            state = train.main(common_args + ["--steps", str(steps),
                                              "--log-every", "1"])
        out["train_s"] = time.perf_counter() - t0
        out["launches"] = {name: fn.launches for name, fn in counters.items()}
        out["expected"] = {"fused_sepconv": 0, "psroi_align": steps,
                           "psroi_align_backward": steps,
                           "nms_suppress": steps * nms_launches(
                               lighthead_xception().model, train=True)}
        with open(f"{tmp}/model/metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        out["losses"] = [r["total_loss"] for r in recs]
        out["wall_s"] = [r["wall_time_s"] for r in recs]
        if state.step != steps or len(out["losses"]) != steps or not all(
                math.isfinite(v) for v in out["losses"]):
            raise AssertionError(f"data: cli.train --data-dir ended at step "
                                 f"{state.step}, losses {out['losses']}")
        del state
        with contextlib.redirect_stdout(io.StringIO()):
            res = evaluate.main(common_args + ["--num-batches", "3"])
        if not (res["step"] == steps and 0.0 <= res["mAP"] <= 1.0):
            raise AssertionError(f"data: cli.evaluate --data-dir gave step "
                                 f"{res['step']}, mAP {res['mAP']}")
        out["mAP"] = res["mAP"]
    return out


def int8_model(cfg, device, batch_size: int = BATCH, seed: int = SEED):
    """slice_model's seeded weights in ``cfg``'s model built with
    ``backbone_quant="int8"``, calibrated by quant.calibrate_backbone over
    INT8_CALIB_BATCHES batches of seeded uint8 images through
    preprocess_for_eval (every range must come out positive). Returns the
    int8 config, the model and the ranges."""
    from x_detector_tpu_torch import quant
    from x_detector_tpu_torch.data.augment import preprocess_for_eval
    device = torch.device(device)
    qcfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_quant="int8"))
    model = slice_model(qcfg.model, device, seed)
    size = cfg.model.image_size
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    calib = [preprocess_for_eval(torch.randint(
        0, 256, (batch_size, size, size, 3), generator=gen,
        dtype=torch.uint8, device=device), cfg.data)
        for _ in range(INT8_CALIB_BATCHES)]
    ranges = quant.calibrate_backbone(qcfg, model, calib)
    low = {k: float(v) for k, v in ranges.items() if not float(v) > 0.0}
    if low:
        raise AssertionError(f"{cfg.model.name}: uncalibrated ranges {low}")
    return qcfg, model, ranges


def run_int8(cfg, device, batches: int = SLICE_BATCHES,
             batch_size: int = BATCH, seed: int = SEED,
             keep_path: bool = False):
    """The int8 serving path of ``cfg``: ``int8_model``, then ``run_slice``
    on it (the same images as the float path's). Returns run_slice's
    readings with the ranges, and the model."""
    qcfg, model, ranges = int8_model(cfg, device, batch_size, seed)
    res = run_slice(qcfg, device, batches, batch_size, seed, model=model,
                    keep_path=keep_path)
    res["ranges"] = ranges
    return res, model


def check_prequantized(model, cfg, device, seed: int = SEED) -> int:
    """The int8 model's raw outputs and detections on one batch, before
    and after quant.prequantize: equal bit for bit (the weights are
    quantized by the one formula either way). Returns the tensors held."""
    from x_detector_tpu_torch import quant
    from x_detector_tpu_torch.data.augment import preprocess_for_eval
    from x_detector_tpu_torch.inference import build_eval_fn
    size = cfg.model.image_size
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    x = preprocess_for_eval(torch.randint(
        0, 256, (2, size, size, 3), generator=gen, dtype=torch.uint8,
        device=device), cfg.data)
    qcfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_quant="int8"))
    runs = []
    for step in ("in-graph", "prequantized"):
        if step == "prequantized":
            quant.prequantize(model)
        with torch.inference_mode():
            out = named_outputs(model(x))
        runs.append({**out, **dict(zip(
            ("boxes", "scores", "classes", "valid"),
            build_eval_fn(model, qcfg, device)(x)))})
    for key, a in runs[0].items():
        if not torch.equal(a, runs[1][key]):
            raise AssertionError(
                f"{cfg.model.name} int8: {key} of the prequantized model "
                f"differs from the in-graph model's by up to "
                f"{(a.float() - runs[1][key].float()).abs().max():.3g}")
    return len(runs[0])


def int8_reference_check(model_cfg, device, keys, ranges) -> dict:
    """The int8 model at 128 px, the same seeded weights and the ranges
    the card calibrated (``ranges``), on the card (bf16, kernels) and on
    the CPU (bf16, plain versions), on the outputs ``keys``; the control is
    the same comparison for the float model. Fails unless each output's
    gap over its scale is within INT8_CONTROL_FACTOR times the control's
    largest."""
    from x_detector_tpu_torch.inference import build_model
    from x_detector_tpu_torch.models.layers import prepare_for_inference
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randint(0, 256, (2, 128, 128, 3), generator=gen
                      ).float() - 120.0
    gaps = {}
    for quant in ("int8", None):
        cfg = dataclasses.replace(model_cfg, image_size=128,
                                  backbone_quant=quant)
        card = slice_model(cfg, device).eval()
        if quant:
            card.load_state_dict(ranges, strict=False)
        cpu = build_model(cfg, "cpu", seed=None, dtype=torch.bfloat16)
        cpu.load_state_dict({k: v.cpu() for k, v in
                             card.state_dict().items()})
        prepare_for_inference(card)
        prepare_for_inference(cpu)
        with torch.inference_mode():
            got = named_outputs(card(x.to(device)))
            ref = named_outputs(cpu(x))
        for key in keys:
            err, sc = max_rel_err(got[key].cpu(), ref[key])
            gaps[(quant or "bf16", key)] = err / sc
    control = max(v for (q, _), v in gaps.items() if q == "bf16")
    for key in keys:
        log(f"{model_cfg.name} int8 128px {key}: card vs CPU (bf16 both) "
            f"{gaps[('int8', key)]:.3g} of the scale; float control "
            f"{gaps[('bf16', key)]:.3g}")
        if not gaps[("int8", key)] <= INT8_CONTROL_FACTOR * control:
            raise AssertionError(
                f"{model_cfg.name} int8 128px {key}: card vs CPU gap "
                f"{gaps[('int8', key)]:.3g} of the scale > "
                f"{INT8_CONTROL_FACTOR} x the float control {control:.3g}")
    return {f"{q}_{k}": v for (q, k), v in gaps.items()}


def int8_conv_calls(cfg, device, batch: int):
    """Every QuantConv call of ``cfg``'s int8 backbone at its full size and
    ``batch``, counted by shape: (B, H, W, Cin, Cout, kernel, stride,
    dilation, pads, depthwise) -> calls a batch; and, by the same keys, the
    calls whose input K2 quantizes on its store (the pointwise convs of
    ``quantizes_on_store`` blocks), which run no K3. Read by forward hooks
    on one calibrate-mode pass (the float path's convs, no int8 kernel) of
    a zero batch."""
    from collections import Counter
    from x_detector_tpu_torch import quant
    from x_detector_tpu_torch.inference import build_model
    from x_detector_tpu_torch.models.layers import SeparableConvBN, same_pads
    model = build_model(dataclasses.replace(
        cfg.model, backbone_quant="int8"), device, seed=None)
    quantized = {id(m.Conv_1) for m in model.modules()
                 if isinstance(m, SeparableConvBN) and m.quantizes_on_store}
    convs = quant.quant_convs(model).values()
    for m in convs:
        m.mode = "calibrate"
    calls, fused = Counter(), Counter()

    def record(m, args):
        b, cin, h, w = args[0].shape
        pads = m.pads if m.pads != "SAME" else same_pads(
            (h, w), m.kernel_size, m.stride, m.dilation)
        key = (b, h, w, cin, m.out_channels, m.kernel_size, m.stride,
               m.dilation, tuple(map(tuple, pads)), m.depthwise)
        calls[key] += 1
        fused[key] += id(m) in quantized

    hooks = [m.register_forward_pre_hook(record) for m in convs]
    size = cfg.model.image_size
    with torch.no_grad():
        model.backbone(torch.zeros(batch, size, size, 3, device=device))
    for h in hooks:
        h.remove()
    return calls, +fused


# The int8 kernel phase's calls whose device time the profiler could not
# give (a window that records no kernel, again and again: it happens now
# and then on the card's machine): {"kernel", "call", "events_ms"}, the
# time by CUDA events kept apart. Their device times are None, and so is
# every per-batch device sum that holds one; each kernel's entry on the
# kernels line lists its own.
DEVICE_MISSING = []


def int8_device_ms(fn, kernel: str, tag: str):
    """``utils.profiling.device_ms(fn)``, or None where the profiler records
    no kernel: then ``fn``'s CUDA-event time is kept in DEVICE_MISSING under
    the ``kernel``'s entry name and the call's ``tag``, and logged."""
    from x_detector_tpu_torch.utils.profiling import device_ms
    try:
        return device_ms(fn, tries=6)
    except AssertionError as err:
        ms = cuda_ms(fn)
        DEVICE_MISSING.append({"kernel": kernel, "call": tag,
                               "events_ms": ms})
        log(f"{kernel} {tag}: {err}; no device time (CUDA events "
            f"{ms:.4f} ms, kept apart)")
        return None


def add_ms(row: dict, field: str, v, n=1) -> None:
    """``row[field] += n * v``; None (not measured) wins."""
    row[field] = None if row[field] is None or v is None else (
        row[field] + n * v)


def ms_text(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def share_text(bound: float, v) -> str:
    return "not measured" if v is None else f"{bound / v:.1%}"


def time_int8(calls, randn, fused) -> dict:
    """K3, then K1 or K2, at each call shape of ``calls`` (one config's
    batch): each held to its plain version bit for bit, then timed beside
    its bound, the plain version and, as yardsticks the port never calls,
    cuDNN's bf16 conv of the same shape and, on the 1x1 stride-1 shapes,
    torch._int_mm (the int32 product alone). K1 runs on the route its
    shape's plan takes and, in the same call, on the first design (the
    "mma" route, through the same wrapper and operator with every plan
    the first design's: ``first_design_planned``), also held bitwise. K2
    runs on its route ("tma" at every call shape of config 3) in both
    modes, dequantizing (bf16) and quantizing on its store at a next
    conv's scale (the separable blocks' path), the latter held to the two
    plain versions composed and timed against K2 dequantizing then K3,
    and on the first design ("simt", ``first_depthwise_design``). Every
    kernel and yardstick is timed both by CUDA events around wrapper calls
    ("ms") and by the profiler's device time ("device_ms", None where the
    profiler gave nothing: ``int8_device_ms``). Returns per-batch sums,
    weighted by the calls, by kernel; K1's and K2's also by route; K3's
    over the calls that run it, those of ``calls`` less ``fused`` (the
    calls whose input K2 quantizes on its store, as
    ``int8_conv_calls`` gives them)."""
    import torch.nn.functional as F
    from x_detector_tpu_torch.ops import int8_conv as q8
    tot = {name: dict.fromkeys(("ms", "plain_ms", "bound_ms", "cudnn_ms",
                                "bytes_bound_ms", "err", "calls",
                                "device_ms", "cudnn_device_ms"), 0.0)
           for name in ("int8_conv", "int8_dwconv", "quantize_s8")}
    k1 = tot["int8_conv"]
    k1.update(dict.fromkeys(("mma_ms", "mma_device_ms"), 0.0),
              routes={r: dict.fromkeys(("calls", "ms", "device_ms",
                                        "mma_ms", "mma_device_ms",
                                        "bound_ms"), 0.0)
                      for r in ("tma", "mma")})
    k2 = tot["int8_dwconv"]
    k2.update(dict.fromkeys(("simt_ms", "simt_device_ms", "q_ms",
                             "q_device_ms", "q_plain_ms", "q_bound_ms",
                             "pair_ms", "pair_device_ms"), 0.0),
              routes={r: dict.fromkeys(("calls", "device_ms", "q_device_ms",
                                        "bound_ms", "q_bound_ms"), 0.0)
                      for r in ("tma", "simt")},
              shapes=[])
    tot["int_mm"] = dict.fromkeys(("ms", "device_ms", "kernel_ms",
                                   "kernel_device_ms", "mma_ms",
                                   "mma_device_ms", "calls"), 0.0)
    for (b, h, w, cin, cout, k, s, d, pads, dw), n in sorted(calls.items()):
        x = (randn(b, h, w, cin) * 2.0).to(torch.bfloat16)
        sx = q8.activation_scale(x.abs().amax().float() * 0.9)
        xq = q8.quantize_activation(x, sx)
        gen = torch.Generator(device=x.device).manual_seed(b * h * cin + cout)
        wq = torch.randint(-127, 128, (cout, *k, 1 if dw else cin),
                           generator=gen, dtype=torch.int8, device=x.device)
        scale = torch.rand(cout, generator=gen, device=x.device) * 1e-3
        weight = q8.prepare_weight(wq, dw)
        geometry = q8.conv_geometry(k, s, d, pads)
        if dw:
            name, kw = "int8_dwconv", dict(stride=s[0], dilation=d[0],
                                           pads=pads)
            kern = lambda: q8.int8_depthwise_conv2d(xq, weight, scale, **kw)
            plain = lambda: q8.int8_depthwise_conv2d_reference(
                xq, wq, scale, out_dtype=torch.bfloat16, **kw)
        else:
            name, kw = "int8_conv", dict(stride=s, dilation=d, pads=pads)
            kern = lambda: q8.int8_conv2d(xq, weight, scale, **kw)
            plain = lambda: q8.int8_conv2d_reference(
                xq, wq, scale, out_dtype=torch.bfloat16, **kw)
            plan = q8.plan_conv(xq.shape, cout, geometry, xq.data_ptr(),
                                q8.sm_count(xq.get_device()))
        tag = (f"[{b},{h},{w},{cin}] -> {cout} {k[0]}x{k[1]} s{s} d{d} "
               f"pads {pads}")
        got_q = xq
        ref_q = q8.quantize_activation_reference(x, sx)
        got, ref = kern(), plain()
        held = [("quantize_s8", got_q, ref_q), (name, got, ref)]
        if dw:
            # the next conv's scale: the output's range, as calibration
            # gives it
            sx_next = q8.activation_scale(ref.abs().amax().float() * 0.9)
            quantizing = lambda: q8.int8_depthwise_conv2d_quantized(
                xq, weight, scale, sx_next, **kw)
            pair = lambda: q8.quantize_activation(kern(), sx_next)
            ref_fused = q8.quantize_activation_reference(ref, sx_next)
            dplan = q8.plan_depthwise(
                xq.shape, geometry, (xq.data_ptr(), weight.kernel.data_ptr(),
                                     weight.kernel.data_ptr() + 9 * cin,
                                     scale.data_ptr(), got.data_ptr()),
                q8.sm_count(xq.get_device()))
            before = dict(q8.int8_depthwise_conv2d.mode_launches)
            held.append(("int8_dwconv quantizing on its store",
                         quantizing(), ref_fused))
            held.append(("K2 then K3", pair(), ref_fused))
            if q8.int8_depthwise_conv2d.mode_launches["quantize"] != (
                    before["quantize"] + 1):
                raise AssertionError(f"int8_dwconv {tag}: the quantizing "
                                     f"mode was not launched")
            with first_depthwise_design():
                before = q8.int8_depthwise_conv2d.route_launches["simt"]
                held.append(("int8_dwconv (first design, simt route)",
                             kern(), ref))
                if q8.int8_depthwise_conv2d.route_launches["simt"] != (
                        before + 1):
                    raise AssertionError(f"int8_dwconv {tag}: the first "
                                         f"design was not launched")
        else:
            with first_design_planned():
                before = q8.int8_conv2d.route_launches["mma"]
                held.append(("int8_conv (first design, mma route)", kern(),
                             ref))
                if q8.int8_conv2d.route_launches["mma"] != before + 1:
                    raise AssertionError(f"int8_conv {tag}: the first "
                                         f"design was not launched")
        torch.cuda.synchronize()
        for what, g, r in held:
            if not torch.equal(g, r):
                raise AssertionError(
                    f"{what} {tag}: differs from its plain version by up to "
                    f"{(g.float() - r.float()).abs().max():.3g}")
        (top, bottom), (left, right) = pads
        xc = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom)
                   ).contiguous(memory_format=torch.channels_last)
        wc = wq.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        cudnn = lambda: F.conv2d(xc, wc, None, s, 0, d, cin if dw else 1)
        if dw:
            bound = q8.depthwise_bound_ms(b, h, w, cin, geometry, 2)
        else:
            bound = q8.conv_bound_ms(b, h, w, cin, cout, geometry, 2)
        # cuDNN's depthwise is timed by events only: once the profiler had
        # traced it, it once recorded no kernel at all in later windows on
        # the H100 machine; its calls are long enough for events
        t = {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, 1, 2),
             "cudnn_ms": cuda_ms(cudnn),
             "device_ms": int8_device_ms(kern, name, tag)}
        if not dw:
            t["cudnn_device_ms"] = int8_device_ms(cudnn, name,
                                                  f"cuDNN {tag}")
        quantize = lambda: q8.quantize_activation(x, sx)
        tq = {"ms": cuda_ms(quantize),
              "plain_ms": cuda_ms(lambda: q8.quantize_activation_reference(
                  x, sx), 1, 5),
              "device_ms": int8_device_ms(quantize, "quantize_s8", tag)}
        bound_q = q8.quantize_bound_ms(x.numel(), 2)
        extra = ""
        if dw:
            bound_fused = q8.depthwise_bound_ms(b, h, w, cin, geometry, 1)
            with first_depthwise_design():
                t.update(simt_ms=cuda_ms(kern), simt_device_ms=int8_device_ms(
                    kern, name, f"(simt) {tag}"))
            t.update(q_ms=cuda_ms(quantizing),
                     q_device_ms=int8_device_ms(quantizing, name,
                                                f"(q) {tag}"),
                     q_plain_ms=cuda_ms(lambda: q8.dwconv_q_plain(
                         xq, weight.kernel, scale, sx_next, geometry,
                         torch.bfloat16), 1, 2),
                     pair_ms=cuda_ms(pair),
                     pair_device_ms=int8_device_ms(pair, name,
                                                   f"(K2 + K3) {tag}"))
            r = k2["routes"][dplan.route]
            for field in ("device_ms", "q_device_ms"):
                add_ms(r, field, t[field], n)
            r["bound_ms"] += n * bound[0]
            r["q_bound_ms"] += n * bound_fused[0]
            r["calls"] += n
            k2["q_bound_ms"] += n * bound_fused[0]
            k2["shapes"].append({
                "shape": [b, h, w, cin], "stride": s[0], "dilation": d[0],
                "calls": n, "route": dplan.route,
                "tile": [dplan.th, dplan.tw], "warps": dplan.qw * dplan.rr,
                "stages": dplan.stages, "device_ms": t["device_ms"],
                "q_device_ms": t["q_device_ms"],
                "pair_device_ms": t["pair_device_ms"],
                "simt_device_ms": t["simt_device_ms"],
                "cudnn_ms": t["cudnn_ms"],
                "bound_ms": bound[0], "q_bound_ms": bound_fused[0]})
            extra = (f"; route {dplan.route} ({dplan.th} x {dplan.tw} tiles "
                     f"of {dplan.qw * dplan.rr} warps, {dplan.stages} "
                     f"stages, {dplan.units} units): device "
                     f"{ms_text(t['device_ms'])} ms "
                     f"({share_text(bound[0], t['device_ms'])} of the "
                     f"bound); quantizing on its store "
                     f"{t['q_ms']:.4f} ms, device "
                     f"{ms_text(t['q_device_ms'])} ms (bound "
                     f"{bound_fused[0]:.4f} ms at 1 byte out, "
                     f"{share_text(bound_fused[0], t['q_device_ms'])}), K2 "
                     f"then K3 {t['pair_ms']:.4f} ms, device "
                     f"{ms_text(t['pair_device_ms'])} ms; first design "
                     f"(simt route) {t['simt_ms']:.4f} ms, device "
                     f"{ms_text(t['simt_device_ms'])} ms; cuDNN bf16 "
                     f"depthwise {t['cudnn_ms']:.4f} ms by events")
        else:
            with first_design_planned():
                t.update(mma_ms=cuda_ms(kern), mma_device_ms=int8_device_ms(
                    kern, name, f"(mma) {tag}"))
            r = k1["routes"][plan.route]
            for field in ("ms", "device_ms", "mma_ms", "mma_device_ms"):
                add_ms(r, field, t[field], n)
            r["bound_ms"] += n * bound[0]
            r["calls"] += n
            how = (f"{plan.form} form, {plan.th} x {plan.tw} tiles, "
                   if plan.form == "conv" else f"{plan.form} form, ") + (
                f"bn {plan.bn}, {plan.tiles} tiles x {plan.splits} "
                f"slices of {plan.chunks} K chunks, {plan.stages} stages"
                if plan.route == "tma" else f"bn {plan.bn}, vec {plan.vec}")
            extra = (f"; route {plan.route} ({how}): device "
                     f"{ms_text(t['device_ms'])} ms "
                     f"({share_text(bound[0], t['device_ms'])} of the "
                     f"bound); first design (mma route) "
                     f"{t['mma_ms']:.4f} ms, device "
                     f"{ms_text(t['mma_device_ms'])} ms; cuDNN device "
                     f"{ms_text(t['cudnn_device_ms'])} ms")
        if not dw and k == (1, 1) and s == (1, 1) and b * h * w > 16:
            a2, b2 = xq.reshape(-1, cin), wq.reshape(cout, cin).t()
            int_mm = lambda: torch._int_mm(a2, b2)
            try:
                mm = {"ms": cuda_ms(int_mm),
                      "device_ms": int8_device_ms(int_mm, name,
                                                  f"_int_mm {tag}")}
            except RuntimeError as err:      # a yardstick only
                extra += f"; torch._int_mm refused the shape: {err}"
            else:
                mm.update(kernel_ms=t["ms"], kernel_device_ms=t["device_ms"],
                          mma_ms=t["mma_ms"],
                          mma_device_ms=t["mma_device_ms"], calls=1)
                for field, v in mm.items():
                    add_ms(tot["int_mm"], field, v, n)
                extra += (f"; torch._int_mm (the int32 product alone) "
                          f"{mm['ms']:.4f} ms, device "
                          f"{ms_text(mm['device_ms'])}")
        n3 = n - fused[(b, h, w, cin, cout, k, s, d, pads, dw)]
        log(f"{name} {tag}: bitwise equal to the plain version; kernel "
            f"{t['ms']:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}), "
            f"{bound[0] / t['ms']:.1%} of it; plain {t['plain_ms']:.4f} ms; "
            f"cuDNN bf16 conv (yardstick) {t['cudnn_ms']:.4f} ms by "
            f"events{extra}; quantize_s8 {tq['ms']:.4f} ms, device "
            f"{ms_text(tq['device_ms'])} ms (bound {bound_q[0]:.4f}); x{n} "
            f"per batch, K3 x{n3}")
        for key, (row, tb, m) in (("int8", (t, bound, n)),
                                  ("q", (tq, bound_q, n3))):
            agg = tot[name if key == "int8" else "quantize_s8"]
            for field, v in row.items():
                add_ms(agg, field, v, m)
            agg["bound_ms"] += m * tb[0]
            agg["bytes_bound_ms"] += m * tb[0] * (tb[1] == "bytes")
            agg["calls"] += m
        del x, xq, got, ref, got_q, ref_q, xc, held
    for name in ("int8_conv", "int8_dwconv", "quantize_s8"):
        agg = tot[name]
        agg["by"] = ("bytes" if agg["bytes_bound_ms"] * 2 >= agg["bound_ms"]
                     else "operations")
    return tot


def phase_int8_kernels() -> dict:
    """K1, K2 and K3 at every call shape of config 2 (batch 8, 512 px) and
    config 3 (batch 16, 800 px), per ``time_int8``. Returns each config's
    sums."""
    from x_detector_tpu_torch.config import lighthead_xception, ssd_resnet50
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    out = {}
    for tag, cfg, batch in (("config2", ssd_resnet50(512), SSD_BATCH),
                            ("config3", lighthead_xception(800), BATCH)):
        calls, fused = int8_conv_calls(cfg, dev, batch)
        out[tag] = time_int8(calls, randn, fused)
        report_int8_kernels(tag, out[tag])
    return out


def report_int8_kernels(tag: str, tot: dict) -> None:
    """``time_int8``'s per-batch sums of one config, logged."""
    for name in ("int8_conv", "int8_dwconv", "quantize_s8"):
        t = tot[name]
        if not t["calls"]:
            continue
        log(f"{name} per batch of {tag} ({int(t['calls'])} calls): kernel"
            f" {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['by']}), {t['bound_ms'] / t['ms']:.1%} of it; plain "
            f"{t['plain_ms']:.4f} ms" + (
                f"; cuDNN bf16 convs (yardstick) {t['cudnn_ms']:.4f} ms by "
                f"events" if name != "quantize_s8" else ""))
    k1 = tot["int8_conv"]
    log(f"int8_conv per batch of {tag}, device time: kernel "
        f"{ms_text(k1['device_ms'])} ms "
        f"({share_text(k1['bound_ms'], k1['device_ms'])} of the bound), "
        f"first design (mma route) {k1['mma_ms']:.4f} ms by events, "
        f"{ms_text(k1['mma_device_ms'])} ms device; cuDNN bf16 convs "
        f"{ms_text(k1['cudnn_device_ms'])} ms device")
    for route, r in k1["routes"].items():
        if r["calls"]:
            log(f"int8_conv per batch of {tag}, the {int(r['calls'])} "
                f"calls planned on route {route}: {r['ms']:.4f} ms "
                f"({ms_text(r['device_ms'])} device), first design "
                f"{r['mma_ms']:.4f} ms ({ms_text(r['mma_device_ms'])} "
                f"device), bound {r['bound_ms']:.4f} ms")
    k2, k3 = tot["int8_dwconv"], tot["quantize_s8"]
    if k2["calls"]:
        log(f"int8_dwconv per batch of {tag}, device time: dequantizing "
            f"{ms_text(k2['device_ms'])} ms "
            f"({share_text(k2['bound_ms'], k2['device_ms'])} of its "
            f"{k2['bound_ms']:.4f} ms bound); quantizing on its store "
            f"{ms_text(k2['q_device_ms'])} ms "
            f"({share_text(k2['q_bound_ms'], k2['q_device_ms'])} of its "
            f"{k2['q_bound_ms']:.4f} ms bound at 1 byte out; "
            f"{k2['q_ms']:.4f} ms by events); K2 dequantizing then K3 "
            f"{ms_text(k2['pair_device_ms'])} ms ({k2['pair_ms']:.4f} by "
            f"events); first design (simt route) "
            f"{ms_text(k2['simt_device_ms'])} ms ({k2['simt_ms']:.4f} by "
            f"events); cuDNN bf16 depthwise {k2['cudnn_ms']:.4f} ms by "
            f"events (not device time)")
        for route, r in k2["routes"].items():
            if r["calls"]:
                log(f"int8_dwconv per batch of {tag}, the "
                    f"{int(r['calls'])} calls planned on route {route}: "
                    f"dequantizing {ms_text(r['device_ms'])} ms device "
                    f"(bound {r['bound_ms']:.4f}), quantizing "
                    f"{ms_text(r['q_device_ms'])} ms (bound "
                    f"{r['q_bound_ms']:.4f})")
    log(f"quantize_s8 per batch of {tag}, device time: "
        f"{ms_text(k3['device_ms'])} ms "
        f"({share_text(k3['bound_ms'], k3['device_ms'])} of its "
        f"{k3['bound_ms']:.4f} ms bound) over the {int(k3['calls'])} calls "
        f"that run it (a pointwise conv whose input K2 quantized runs "
        f"none)")
    mm = tot["int_mm"]
    if mm["calls"]:
        log(f"{tag}: the {int(mm['calls'])} 1x1 stride-1 calls: K1 "
            f"{mm['kernel_ms']:.4f} ms ({ms_text(mm['kernel_device_ms'])} "
            f"device), first design {mm['mma_ms']:.4f} ms "
            f"({ms_text(mm['mma_device_ms'])} device), torch._int_mm (the "
            f"int32 product alone, yardstick) {mm['ms']:.4f} ms "
            f"({ms_text(mm['device_ms'])} device)")


def int8_kernel_lines(int8: dict) -> list:
    """The kernels line's entries of K1 (config 2's batch), K2 (config 3's)
    and K3 (config 2's), each with the other config's sums; K1's with its
    route split, the first design's times and the device times. K2's
    "ms", "plain_ms", "bound_ms" and "device_ms" are the dequantizing
    kernel's (bf16 out), as in the entries before K2 had a second mode
    ("function" says so); the "quantize_*" fields are the mode the main
    path runs, quantizing on its store (its bound at 1 byte out); then K2
    dequantizing then K3, the first design, cuDNN's bf16 depthwise by
    events, the route split and each call shape's readings. K3's
    config 3 sums are over the calls that run it. Each entry lists the
    calls of its kernel whose device time the profiler did not give
    ("device_missing", their CUDA-event times apart); a device sum that
    holds one is null."""
    site = "x_detector_tpu/models/layers.py:180"
    rows = []
    for name, main, other in (("int8_conv", "config2", "config3"),
                              ("int8_dwconv", "config3", None),
                              ("quantize_s8", "config2", "config3")):
        t = int8[main][name]
        row = {"name": name, "route": "cuda",
               "source": "x_detector_tpu_torch/csrc/int8_conv.cu",
               "replaces": site, "max_abs_err": 0.0, "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["by"], "library_ms": None,
               "shapes_of": main, "calls_per_batch": int(t["calls"])}
        if name != "quantize_s8":
            row["cudnn_bf16_yardstick_ms"] = t["cudnn_ms"]
        if other:
            o = int8[other][name]
            row.update({f"{other}_ms": o["ms"],
                        f"{other}_plain_ms": o["plain_ms"],
                        f"{other}_bound_ms": o["bound_ms"],
                        f"{other}_calls_per_batch": int(o["calls"])})
            if name == "int8_conv":
                row[f"{other}_cudnn_bf16_yardstick_ms"] = o["cudnn_ms"]
        if name == "int8_conv":
            row["source"] = "x_detector_tpu_torch/csrc/int8_conv_tma.cu"
            row["mma_route_source"] = "x_detector_tpu_torch/csrc/int8_conv.cu"
            for tag in int8:
                k1 = int8[tag][name]
                pre = "" if tag == main else f"{tag}_"
                row.update({
                    f"{pre}device_ms": k1["device_ms"],
                    f"{pre}previous_design_ms": k1["mma_ms"],
                    f"{pre}previous_design_device_ms": k1["mma_device_ms"],
                    f"{pre}cudnn_bf16_yardstick_device_ms":
                        k1["cudnn_device_ms"],
                    f"{pre}routes": {r: {f: (int(v) if f == "calls" else v)
                                         for f, v in d.items()}
                                     for r, d in k1["routes"].items()}})
            row["int_mm_yardstick"] = {
                tag: {f: (int(v) if f == "calls" else v)
                      for f, v in int8[tag]["int_mm"].items()}
                for tag in int8}
        elif name == "int8_dwconv":
            row.update({
                "source": "x_detector_tpu_torch/csrc/int8_dwconv_tma.cu",
                "simt_route_source": "x_detector_tpu_torch/csrc/int8_conv.cu",
                "function": "K2 dequantizing to bf16 (ms, plain_ms, "
                            "bound_ms, device_ms); the main path's mode, "
                            "quantizing on its store: quantize_*",
                "device_ms": t["device_ms"], "bound_out_bytes": 2,
                "quantize_ms": t["q_ms"],
                "quantize_device_ms": t["q_device_ms"],
                "quantize_plain_ms": t["q_plain_ms"],
                "quantize_bound_ms": t["q_bound_ms"],
                "quantize_bound_out_bytes": 1,
                "with_separate_quantize_device_ms": t["pair_device_ms"],
                "with_separate_quantize_ms": t["pair_ms"],
                "previous_design_ms": t["simt_ms"],
                "previous_design_device_ms": t["simt_device_ms"],
                "cudnn_bf16_yardstick_timed_by": "events",
                "routes": {r: {f: (int(v) if f == "calls" else v)
                               for f, v in d.items()}
                           for r, d in t["routes"].items()},
                "shapes": t["shapes"]})
        else:
            row.update({f"{tag}_device_ms" if tag != main else "device_ms":
                        int8[tag][name]["device_ms"] for tag in int8})
        row["device_missing"] = [
            {k: v for k, v in m.items() if k != "kernel"}
            for m in DEVICE_MISSING if m["kernel"] == name]
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# serve: export, reload and serve (cli/export.py, serving.py, cli.predict)
# ---------------------------------------------------------------------------

def timed_batches(fn, inputs, batches: int, counters, device) -> dict:
    """``fn(*inputs)`` once to warm up and ``batches`` times timed (host
    clock to a sync): the first run's outputs, the launches a run of each
    kernel in ``counters`` and the median ms."""
    sync = (lambda: torch.cuda.synchronize(device)) if (
        torch.device(device).type == "cuda") else (lambda: None)
    reset_counters(counters, device)
    seconds, first = [], None
    for _ in range(batches + 1):
        t0 = time.perf_counter()
        out = fn(*inputs)
        sync()
        seconds.append(time.perf_counter() - t0)
        first = out if first is None else first
    runs = batches + 1
    launches = {name: fn_.launches for name, fn_ in counters.items()}
    per_run = {name: v / runs for name, v in launches.items()}
    ms = sorted(seconds[1:])[len(seconds[1:]) // 2] * 1e3
    return {"out": first, "launches": launches, "per_batch": per_run,
            "ms": ms}


def hold_bitwise(tag: str, got, want,
                 what: str = "of the loaded program differs from eager's"
                 ) -> None:
    names = ("boxes", "scores", "classes", "valid")
    for name, a, b in zip(names, got, want):
        if a.shape != b.shape or not torch.equal(a, b):
            diff = ((a.float() - b.float()).abs().max().item()
                    if a.shape == b.shape else "shapes differ")
            raise AssertionError(f"{tag}: {name} {what}: {diff}")


def letterboxed(batch: int, size: int, hw, seed: int, device):
    """``batch`` seeded uint8 RGB images of ``hw`` letterboxed onto
    ``size`` canvases by serving.letterbox_batch, on ``device``."""
    import numpy as np
    from x_detector_tpu_torch import serving
    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
              for _ in range(batch)]
    canvas, scale = serving.letterbox_batch(images, size)
    return (torch.from_numpy(canvas).to(device),
            torch.from_numpy(scale).to(device))


def run_serve(cfg, device, directory: str, buckets=SERVE_BUCKETS,
              baked=SERVE_BAKED, batches: int = SERVE_BATCHES,
              raw_hw=SERVE_RAW_HW, seed: int = SEED,
              rounds: int = ROUNDS) -> dict:
    """``cfg``'s model (slice_model's weights) exported on ``device`` as a
    raw-RGB container of ``buckets`` (``baked`` embedding the weights)
    into ``directory`` and loaded by serving.load_container, and at the
    smallest bucket also a program taking the weights as inputs (saved
    and loaded by serving.load). At each bucket a letterboxed batch
    through each program and through the eager path (preprocess_for_eval,
    build_eval_fn, the unscale): held bit for bit, each path's launches a
    batch counted over ``batches`` batches after a warm-up, then the paths
    timed in ``rounds`` alternating rounds (``alternating_ms``). Returns
    the readings."""
    from x_detector_tpu_torch import serving
    from x_detector_tpu_torch.cli.export import (export_container,
                                                 export_program)
    from x_detector_tpu_torch.data.augment import preprocess_for_eval
    from x_detector_tpu_torch.inference import (ServingModule, build_eval_fn,
                                                unscale_boxes)
    model = slice_model(cfg.model, device, seed).eval()
    detect = build_eval_fn(model, cfg, device)
    module = ServingModule(model, cfg, raw_rgb=True)
    export_s = export_container(module, directory, buckets, baked, device,
                                {"preset": cfg.model.name, "quant": "none"})
    cont = serving.load_container(directory)
    b = min(buckets)
    path = f"{directory}/shared-b{b}.pt2"
    t0 = time.perf_counter()
    torch.export.save(export_program(module, b, device, cont.weights,
                                     baked=False), path)
    shared_export_s = time.perf_counter() - t0
    shared = serving.load(path)
    counters = kernel_counters()
    size = cfg.model.image_size

    def eager(canvas, scale):
        b, s, c, v = detect(preprocess_for_eval(canvas, cfg.data))
        return unscale_boxes(b, scale), s, c, v

    def with_weights(*inputs):
        with torch.inference_mode():
            return shared(cont.weights, *inputs)

    out = {"export_s": export_s, "shared_export_s": shared_export_s,
           "buckets": {}, "launches": dict.fromkeys(counters, 0)}
    for b in buckets:
        inputs = letterboxed(b, size, raw_hw, seed + b, device)
        paths = {"eager": eager, "loaded": cont.detect}
        if b == min(buckets):
            paths["shared"] = with_weights
        runs = {name: timed_batches(fn, inputs, batches, counters, device)
                for name, fn in paths.items()}
        for name in paths:
            if name != "eager":
                hold_bitwise(f"serve bucket {b}, {name}", runs[name]["out"],
                             runs["eager"]["out"])
        check_detections(*runs["loaded"]["out"], b,
                         cfg.model.nms.max_output)
        for name, v in runs["loaded"]["launches"].items():
            out["launches"][name] += v
        runs["ms"] = alternating_ms(
            {name: functools.partial(fn, *inputs)
             for name, fn in paths.items()}, rounds, device=device)
        out["buckets"][b] = runs
    out["weights_mb"] = sum(t.numel() * t.element_size()
                            for t in cont.weights.values()) / 2**20
    return out


def run_serve_int8(cfg, device, directory: str,
                   bucket: int = SERVE_INT8_BUCKET,
                   batches: int = SERVE_BATCHES, seed: int = SEED,
                   rounds: int = ROUNDS) -> dict:
    """``cfg``'s int8 model (``int8_model``), prequantized, exported on
    ``device`` as a container of ``bucket`` taking pre-whitened images (the
    weights as inputs), loaded, and held bit for bit against the eager
    prequantized model through build_eval_fn, with each path's launches a
    batch, then both timed in ``rounds`` alternating rounds."""
    from x_detector_tpu_torch import quant, serving
    from x_detector_tpu_torch.cli.export import export_container
    from x_detector_tpu_torch.data.augment import preprocess_for_eval
    from x_detector_tpu_torch.inference import ServingModule, build_eval_fn
    qcfg, model, _ = int8_model(cfg, device, bucket, seed)
    quant.prequantize(model)
    detect = build_eval_fn(model, qcfg, device)
    export_s = export_container(ServingModule(model, qcfg), directory,
                                (bucket,), (), device,
                                {"preset": qcfg.model.name, "quant": "int8"})
    cont = serving.load_container(directory)
    stored = {str(t.dtype) for t in cont.weights.values()}
    if "torch.int8" not in stored:
        raise AssertionError(f"int8 container stores no int8 tensor: "
                             f"{stored}")
    size = cfg.model.image_size
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    x = preprocess_for_eval(torch.randint(
        0, 256, (bucket, size, size, 3), generator=gen, dtype=torch.uint8,
        device=device), cfg.data)
    counters = path_counters()
    want = timed_batches(detect, (x,), batches, counters, device)
    got = timed_batches(cont.detect, (x,), batches, counters, device)
    hold_bitwise("serve int8", got["out"], want["out"])
    check_detections(*got["out"], bucket, cfg.model.nms.max_output)
    ms = alternating_ms({"eager": lambda: detect(x),
                         "loaded": lambda: cont.detect(x)}, rounds,
                        device=device)
    return {"export_s": export_s, "eager": want, "loaded": got, "ms": ms,
            "launches": got["launches"], "stored": sorted(stored),
            "detect": detect, "x": x}


# K1's plan for a shape were it the first design's: every call on the "mma"
# route, cached as the rule's plans are
@functools.lru_cache(maxsize=None)
def _first_design_plan(x_shape, cout, geometry, x_align, sms):
    from x_detector_tpu_torch.ops import int8_conv as q8
    return q8.plan_mma(x_shape[3], cout, x_align)


@contextlib.contextmanager
def first_design_planned():
    """Within: K1's plan (``ops/int8_conv._plan``) is the first design's
    (the "mma" route) for every shape, so that a wrapper
    call or a model runs that kernel on the same host path, wrapper and
    operator as the rule's route."""
    from x_detector_tpu_torch.ops import int8_conv as q8
    rule = q8._plan
    q8._plan = _first_design_plan
    try:
        yield
    finally:
        q8._plan = rule


def int8_rounds(path: str, res: dict, cfg, batch: int, per_batch: dict,
                k1_routes: dict, k2_modes: dict, device="cuda",
                rounds: int = INT8_ROUNDS) -> dict:
    """The int8 path of ``res`` (``run_int8(..., keep_path=True)``) and
    the bf16 path on the same weights and images in alternating rounds
    (the host drifts between states within one process), with the int8
    path with the first design's K1 on every call and, where the model has
    depthwise convs, with the first design's K2 and a K3 before every
    pointwise conv
    (the same wrappers, operators and model: before and after each
    redesign by one method). Each of those two sides launches as
    expected, and gives the int8 path's detections bit for bit. Returns
    ``alternating_ms``'s readings."""
    from x_detector_tpu_torch.ops import int8_conv as q8
    flt = run_slice(cfg, device, batches=0, batch_size=batch,
                    keep_path=True)
    detect, flt_detect, u8 = (res.pop("detect"), flt.pop("detect"),
                              res.pop("u8"))

    def first_design_detect():
        with first_design_planned():
            return detect(u8)

    def held(side, want, got_launches, run):
        q8.reset_launches()
        pairs = list(zip(detect(u8), run()))
        got = got_launches()
        if got != want:
            raise AssertionError(f"{path}: launches on the int8 path then "
                                 f"with {side}: {got}, expected {want}")
        for i, (a, b) in enumerate(pairs):
            if not torch.equal(a, b):
                raise AssertionError(f"{path}: detections[{i}] with {side} "
                                     f"differ")

    held("the first design's K1",
         {"tma": k1_routes["tma"],
          "mma": k1_routes["mma"] + per_batch["int8_conv"]},
         lambda: q8.int8_conv2d.route_launches, first_design_detect)
    sides = {"bf16": lambda: flt_detect(u8), "int8": lambda: detect(u8),
             "int8_first_design": first_design_detect}
    dw = per_batch["int8_dwconv"]
    if dw:
        def first_dw_detect():
            with first_depthwise_design():
                return detect(u8)

        held("the first design's K2 and a separate K3",
             {"routes": {"tma": dw, "simt": dw},
              "modes": {"quantize": k2_modes["quantize"],
                        "dequant": k2_modes["dequant"] + dw},
              "quantize_s8": 2 * per_batch["quantize_s8"]
              + k2_modes["quantize"]},
             lambda: {"routes": q8.int8_depthwise_conv2d.route_launches,
                      "modes": q8.int8_depthwise_conv2d.mode_launches,
                      "quantize_s8": q8.quantize_activation.launches},
             first_dw_detect)
        sides["int8_first_dw"] = first_dw_detect
    ms = alternating_ms(sides, rounds=rounds, device=device)

    def ratio(side):
        paired = sorted(a / b for a, b in zip(ms[side]["rounds"],
                                              ms["int8"]["rounds"]))
        return (f"{ms[side]['median'] / ms['int8']['median']:.3f}x "
                f"(round by round: median {paired[len(paired) // 2]:.3f}"
                f"x, {paired[0]:.3f}-{paired[-1]:.3f}x)")

    log(f"{path}: K1 routes a batch {k1_routes}, K2 modes {k2_modes}; "
        f"ms a batch {rounds_text(ms)}: bf16 / int8 "
        f"{ms['bf16']['median'] / ms['int8']['median']:.3f}x; int8 "
        f"with the first design's K1 / with the new route "
        f"{ratio('int8_first_design')}; bf16 / int8 with the first design "
        f"{ms['bf16']['median'] / ms['int8_first_design']['median']:.3f}x"
        + (f"; int8 with the first design's K2 and a separate K3 / with "
           f"the new K2 "
           f"quantizing on its store {ratio('int8_first_dw')}; bf16 / int8 "
           f"with them "
           f"{ms['bf16']['median'] / ms['int8_first_dw']['median']:.3f}x"
           if dw else ""))
    return ms


# K2's plan for a shape were it the first design's: every call on the
# "simt" route, cached as the rule's plans are
@functools.lru_cache(maxsize=None)
def _first_depthwise_plan(x_shape, geometry, aligns, sms, out_bytes):
    from x_detector_tpu_torch.ops import int8_conv as q8
    return q8.DepthwisePlan("simt", vec=q8.depthwise_vec(
        x_shape[3], aligns[0], aligns[1]))


@contextlib.contextmanager
def first_depthwise_design():
    """Within: K2 as its first design ran it, through the same wrappers,
    operators and model: its plan (``ops/int8_conv._plan_dw``) the first
    design's (the "simt" route) for every shape, and no separable block
    quantizing on K2's store (``ops/int8_conv.fuses_quantize`` false), so
    K3 runs before every pointwise conv."""
    from x_detector_tpu_torch.ops import int8_conv as q8
    rule, fuses = q8._plan_dw, q8.fuses_quantize
    q8._plan_dw = _first_depthwise_plan
    q8.fuses_quantize = lambda c, stride, dilation: False
    try:
        yield
    finally:
        q8._plan_dw, q8.fuses_quantize = rule, fuses


@contextlib.contextmanager
def operators_bypassed():
    """Within: every ``xdt`` operator that a wrapper calls
    (``torch.ops.xdt.<name>.default``) is its CUDA implementation, called
    directly, without the dispatcher."""
    from x_detector_tpu_torch.ops import library
    ns = torch.ops.xdt
    packets = {name: getattr(ns, name) for name in library.OPERATORS}
    try:
        for name, fn in library.CUDA_IMPLEMENTATIONS.items():
            setattr(ns, name, types.SimpleNamespace(default=fn))
        yield
    finally:
        for name, packet in packets.items():
            setattr(ns, name, packet)


def boundary_in_model(detect, *inputs) -> dict:
    """A path's eager batch (``detect(*inputs)``, on the card) through the
    ``xdt`` operators, against the same path with every operator's CUDA
    implementation called directly (``operators_bypassed``), in
    alternating rounds: each side's median and best round in ms a batch.
    The difference is what the operator boundary costs the path."""
    def bypassed():
        with operators_bypassed():
            detect(*inputs)

    return alternating_ms({"operators": lambda: detect(*inputs),
                           "direct": bypassed})


def rounds_text(ms: dict) -> str:
    """alternating_ms's readings as one phrase."""
    rounds = len(next(iter(ms.values()))["rounds"])
    return "; ".join(f"{side} {v['median']:.3f} (best {v['best']:.3f})"
                     for side, v in ms.items()) + (
        f" (median of {rounds} alternating rounds of {ROUND_BATCHES})")


def report_boundary(tag: str, res: dict, *inputs) -> None:
    """Logs ``boundary_in_model`` of a phase's eager path (``res["detect"]``
    on ``inputs``, by default the phase's last images) and drops the path,
    so its model is freed."""
    cost = boundary_in_model(res.pop("detect"), *(inputs or (res.pop(
        "u8"),)))
    extra = cost["operators"]["median"] - cost["direct"]["median"]
    log(f"{tag}: the eager batch through the xdt operators against every "
        f"operator's CUDA implementation called directly, ms a batch "
        f"{rounds_text(cost)}: +{extra:.3f} ms "
        f"({extra / cost['direct']['median'] * 100:.1f}%)")


def dispatch_cost(rounds: int = DISPATCH_ROUNDS,
                  calls: int = DISPATCH_CALLS) -> dict:
    """Host microseconds a call of K3 and K1 on tiny tensors (the host's
    work sets the rate) in alternating rounds of ``calls`` calls, host
    clock to a sync, each side's median round: through the public wrapper
    (shape checks and the operator), through the operator alone as
    ``QuantConv`` calls it (its checks run once an input shape), and
    through the operator's CUDA implementation called directly (the same
    launch, no dispatcher). The operator less the direct call is what the
    boundary costs a call in the model."""
    from x_detector_tpu_torch.ops import int8_conv as q8
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    x = torch.randn(1, 8, 8, 64, generator=gen, device=dev).bfloat16()
    sx = torch.tensor(0.05, device=dev)
    xq = q8.quantize_activation(x, sx)
    weight = q8.prepare_weight(torch.randint(
        -127, 128, (64, 1, 1, 64), generator=gen, dtype=torch.int8,
        device=dev), False)
    scale = torch.rand(64, generator=gen, device=dev)
    geometry = q8.conv_geometry((1, 1), (1, 1), (1, 1), ((0, 0), (0, 0)))
    pairs = {
        "quantize_s8": {
            "operator": lambda: q8.quantize_activation(x, sx),
            "direct": lambda: q8.quantize_cuda(x, sx)},
        "int8_conv": {
            "wrapper": lambda: q8.int8_conv2d(xq, weight, scale),
            "operator": lambda: torch.ops.xdt.int8_conv.default(
                xq, weight.kernel, scale, geometry, torch.bfloat16),
            "direct": lambda: q8.conv_cuda(xq, weight.kernel, scale,
                                           geometry, torch.bfloat16)}}
    out = {}
    with torch.inference_mode():
        for name, sides in pairs.items():
            ms = alternating_ms(sides, rounds, calls)
            out[name] = {side: v["median"] * 1e3 for side, v in ms.items()}
    return out


def run_predict_artifact(directory: str, device, work: str) -> dict:
    """cli.predict --artifact on a photo-sized JPEG that
    make_voc_mini.write_voc_tree writes: the PNG it must write, and its
    detections."""
    import glob
    import os
    from x_detector_tpu_torch.cli import predict
    from x_detector_tpu_torch.data.testdata.make_voc_mini import (
        write_voc_tree)
    write_voc_tree(f"{work}/voc", 1, hw=SERVE_RAW_HW)
    jpeg, = glob.glob(f"{work}/voc/**/*.jpg", recursive=True)
    png = f"{work}/predicted.png"
    with contextlib.redirect_stdout(io.StringIO()):
        boxes, scores, classes, valid = predict.main([
            "--artifact", directory, "--device", str(device), "--input",
            jpeg, "--output", png])
    if not os.path.getsize(png) > 0:
        raise AssertionError(f"cli.predict --artifact wrote no {png}")
    return {"png_bytes": os.path.getsize(png), "valid": int(valid.sum())}


# ---------------------------------------------------------------------------
# The last modules: MaxpoolNMS, act8, remat, dense stages, the rest of the
# CLIs
# ---------------------------------------------------------------------------

def maxpool_nms(cfg):
    """``cfg`` with MaxpoolNMS on: the proposal stage's (``fast_nms``, read
    by Light-Head) and the SSD tail's (``fast_mode``, read by SSD)."""
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, proposals=dataclasses.replace(m.proposals, fast_nms=True),
        nms=dataclasses.replace(m.nms, fast_mode=True)))


def trace_kernels(logdir: str) -> list:
    """The names of the device kernels in ``utils.profiling.trace``'s
    Chrome trace in ``logdir``."""
    import os
    from x_detector_tpu_torch.utils import profiling
    with open(os.path.join(logdir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    return sorted({e["name"] for e in events if e.get("cat") == "kernel"})


def run_fast(cfg, device, batches: int = SLICE_BATCHES,
             batch_size: int = BATCH, rounds: int = ROUNDS,
             profile: bool = False) -> dict:
    """``cfg``'s exact path and its MaxpoolNMS path (``maxpool_nms``), each
    through ``run_slice`` on the same seeded weights and images; the fast
    path's readings (its ``suppress`` counts, exact NMS's suppressions in
    the forward and in all) with the exact path's counts and both
    paths' batch ms in alternating rounds. With ``profile``, one fast batch
    under ``utils.profiling.trace`` (the device kernels it names) and the
    fast batch timed by ``utils.profiling.DeviceTimer``."""
    from x_detector_tpu_torch.utils import profiling
    exact = run_slice(cfg, device, batches, batch_size, keep_path=True)
    res = run_slice(maxpool_nms(cfg), device, batches, batch_size,
                    keep_path=True)
    u8 = res["u8"]
    fast_fn, exact_fn = res.pop("detect"), exact.pop("detect")
    res["exact_suppress"] = exact["suppress"]
    res["ms"] = alternating_ms({"exact": lambda: exact_fn(u8),
                                "fast": lambda: fast_fn(u8)},
                               rounds=rounds, device=device)
    del exact, exact_fn
    if profile:
        with tempfile.TemporaryDirectory() as logdir:
            with profiling.trace(logdir):
                fast_fn(u8)
            res["trace_kernels"] = trace_kernels(logdir)
        timer = profiling.DeviceTimer(fast_fn, [(u8,), (u8.roll(1, 0),)],
                                      warmup=1)
        res["timer_ms"] = timer.measure(batches) * 1e3
    return res


def check_fast(tag: str, res: dict, family: str) -> None:
    """MaxpoolNMS took exact NMS (the plain version's fixpoint, or the
    kernels) out of the proposal stage (Light-Head) or out of the whole
    tail (SSD), where the exact path ran it."""
    stage = "forward" if family == "lighthead" else "all"
    if res["suppress"][stage] != 0 or res["exact_suppress"][stage] == 0:
        raise AssertionError(
            f"{tag}: exact NMS (fixpoint or kernels) ran "
            f"{res['suppress'][stage]} times in "
            f"the fast path's {'proposal stage' if stage == 'forward' else 'tail'}"
            f" (the exact path's: {res['exact_suppress'][stage]}); expected "
            f"0 (and the exact path's > 0)")


def act8_grad_check(device, shape=(16, 128, 200, 200),
                    seed: int = SEED) -> dict:
    """At one stage-1 input shape (NCHW), the act8 QuantConv against the
    plain conv of the same module (``layers.conv2d``), for the depthwise
    3x3 and the pointwise 1x1 of a separable block, in bf16 with cuDNN
    deterministic: the outputs and dL/dx bitwise equal (act8's dL/dx reads
    no activation), dL/dk's relative RMS gap (float64) in (0, 0.02), the
    JAX package's bound (its test_act8_exact_dx_quantized_dk)."""
    from x_detector_tpu_torch.models.layers import (QuantConv, conv2d,
                                                    init_flax_like)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=gen, device=device).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for name, kernel, groups in (("depthwise", (3, 3), c),
                                     ("pointwise", (1, 1), 1)):
            conv = QuantConv(c, c, kernel, groups=groups, mode="act8")
            init_flax_like(conv, torch.Generator().manual_seed(seed))
            conv.to(device)
            g = torch.randn(shape, generator=gen, device=device)
            grads = {}
            for side, fn in (("act8", conv),
                             ("plain", lambda t: conv2d(t, conv, "SAME",
                                                        torch.bfloat16))):
                conv.weight.grad = None
                xi = x.clone().requires_grad_()
                y = fn(xi)
                (y.float() * g).sum().backward()
                grads[side] = (y.detach(), xi.grad, conv.weight.grad.clone())
            (ya, dxa, dka), (yp, dxp, dkp) = grads["act8"], grads["plain"]
            a, b = dka.double(), dkp.double()
            rms = ((a - b).pow(2).mean().sqrt()
                   / b.pow(2).mean().sqrt().clamp_min(1e-12)).item()
            out[name] = {"y_equal": torch.equal(ya, yp),
                         "dx_equal": torch.equal(dxa, dxp), "dk_rms": rms}
            if not (out[name]["y_equal"] and out[name]["dx_equal"]
                    and 0.0 < rms < 0.02):
                raise AssertionError(f"act8 {name} conv at {shape}: "
                                     f"{out[name]}; expected the output and "
                                     f"dL/dx bitwise, 0 < dL/dk rms < 0.02")
    finally:
        torch.backends.cudnn.deterministic = prev
    return out


def with_remat(cfg, stages: int):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_remat_stages=stages))


def run_remat_pair(cfg, device, stages: int = 2, steps: int = 3,
                   seed: int = SEED) -> dict:
    """``steps`` train steps of ``cfg`` without remat and with
    ``backbone_remat_stages = stages``, from the same seed on the same
    batches and draws, with ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` and cuDNN deterministic: the two train states
    (``train_snapshot``: parameters, BatchNorm running stats, momentum,
    EMA shadow, step) must be bitwise equal. Returns each side's peak
    memory and mean step ms after the first (host clock to a sync, both
    under the deterministic settings), the remat run's launches and what
    they should be (B1 once a step each way for Light-Head: it is in the
    head, never in a recomputed stage), and the warnings of ops with no
    deterministic version."""
    import warnings
    from x_detector_tpu_torch.data.augment import preprocess_batch_for_train
    from x_detector_tpu_torch.data.synthetic import synthetic_batch_device
    from x_detector_tpu_torch.train.trainer import (create_model_and_state,
                                                    make_train_step)
    device = torch.device(device)
    cuda = device.type == "cuda"
    counters = kernel_counters()
    snaps, peaks, step_ms = {}, {}, {}
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for n in (0, stages):
                c = with_remat(cfg, n)
                if cuda:
                    torch.cuda.synchronize(device)
                    torch.cuda.reset_peak_memory_stats(device)
                for fn in counters.values():
                    fn.launches = 0
                state = create_model_and_state(c, device, seed=seed)
                step = make_train_step(state.model, c)
                gen = torch.Generator(device=device).manual_seed(seed)
                canvas = int(c.data.image_size * CANVAS_SCALE)
                seconds = []
                for _ in range(steps):
                    t0 = time.perf_counter()
                    raw = synthetic_batch_device(gen, c.train.batch_size,
                                                 canvas, c.data.max_gt_boxes)
                    batch = preprocess_batch_for_train(gen, raw, c.data)
                    state, metrics = step(state, batch, gen)
                    sync()
                    seconds.append(time.perf_counter() - t0)
                timed = seconds[1:] or seconds
                step_ms[n] = sum(timed) / len(timed) * 1e3
                if cuda:
                    torch.cuda.synchronize(device)
                    peaks[n] = torch.cuda.max_memory_allocated(device)
                launches = {k: fn.launches for k, fn in counters.items()}
                snaps[n] = train_snapshot(state)
                del state, step
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic = prev[2]
    differ = snapshot_differs(snaps[0], snaps[stages])
    if differ:
        raise AssertionError(f"remat {stages}: the train state after "
                             f"{steps} steps differs from the one without "
                             f"remat in {len(differ)} tensors: {differ[:5]}")
    b1 = steps if cfg.model.family == "lighthead" else 0
    return {"peak": peaks, "step_ms": step_ms, "tensors": len(snaps[0]),
            "launches": launches,
            "expected": {"fused_sepconv": 0, "psroi_align": b1,
                         "psroi_align_backward": b1,
                         "nms_suppress": steps * nms_launches(
                             cfg.model, train=True)},
            "nondeterministic": sorted({str(w.message).split(".")[0]
                                        for w in caught
                                        if "deterministic" in str(
                                            w.message)})}


def torchvision_resnet50_state(seed: int = SEED,
                               stage_sizes=(3, 4, 6, 3),
                               widths=(64, 128, 256, 512)) -> dict:
    """A state dict under torchvision's ``resnet50()`` names and shapes (the
    public ResNet-50's by default; the stem 64 wide, each block's output 4x
    its width, a downsample on each stage's first block, the 1000-way fc)
    with seeded random values: no weights are on disk or fetched."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = torch.randn(cout, cin, k, k, generator=gen) * (
            (k * k * cin) ** -0.5)

    def bn(name, c):
        sd[f"{name}.weight"] = 1.0 + 0.1 * torch.randn(c, generator=gen)
        sd[f"{name}.bias"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{name}.running_mean"] = 0.1 * torch.randn(c, generator=gen)
        sd[f"{name}.running_var"] = 0.5 + torch.rand(c, generator=gen)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for s, (n, w) in enumerate(zip(stage_sizes, widths)):
        for b in range(n):
            t = f"layer{s + 1}.{b}"
            conv(f"{t}.conv1", w, cin, 1)
            bn(f"{t}.bn1", w)
            conv(f"{t}.conv2", w, w, 3)
            bn(f"{t}.bn2", w)
            conv(f"{t}.conv3", 4 * w, w, 1)
            bn(f"{t}.bn3", 4 * w)
            if b == 0:
                conv(f"{t}.downsample.0", 4 * w, cin, 1)
                bn(f"{t}.downsample.1", 4 * w)
            cin = 4 * w
    sd["fc.weight"] = torch.randn(1000, cin, generator=gen) * cin ** -0.5
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def run_cli_rest(device, extra=(), steps: int = 2, batch_size: int = 4,
                 stage_sizes=(3, 4, 6, 3), widths=(64, 128, 256, 512)
                 ) -> dict:
    """``cli.train --pretrained --tensorboard`` on lighthead_resnet50, in
    this process, from a ``.pth`` written here
    (``torchvision_resnet50_state``), ``steps`` steps of ``batch_size``
    with ``--device device`` and ``extra``, the kernels' counters reset
    just before: the backbone right after the graft bitwise equal to the
    file's tensors (``utils.pretrained.torch_resnet50_to_port``), the steps
    taken and the backbone moved; the event file in ``<model-dir>/tb``
    read back by ``utils.logging.read_events`` (CRCs checked) holding every
    scalar of ``metrics.jsonl`` (float32). Returns the readings and the
    run's launches."""
    import glob
    from x_detector_tpu_torch.cli import train
    from x_detector_tpu_torch.utils.logging import read_events
    from x_detector_tpu_torch.utils.pretrained import torch_resnet50_to_port
    device = torch.device(device)
    sd = torchvision_resnet50_state(SEED, stage_sizes, widths)
    want = torch_resnet50_to_port(sd, stage_sizes)
    grafted = {}
    graft = train.graft_pretrained

    def spy(state, path, sizes):
        graft(state, path, sizes)
        grafted.update({k: v.detach().cpu().clone() for k, v in
                        state.model.backbone.state_dict().items()})

    counters = kernel_counters()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(sd, f"{tmp}/resnet50.pth")
        reset_counters(counters, device)
        train.graft_pretrained = spy
        try:
            with contextlib.redirect_stdout(io.StringIO()) as out:
                state = train.main([
                    "--preset", "lighthead_resnet50", "--pretrained",
                    f"{tmp}/resnet50.pth", "--tensorboard", "--steps",
                    str(steps), "--log-every", "1", "--batch-size",
                    str(batch_size), "--model-dir", f"{tmp}/model",
                    "--device", str(device), *extra])
        finally:
            train.graft_pretrained = graft
        launches = {name: fn.launches for name, fn in counters.items()}
        differ = [k for k in want if not torch.equal(grafted[k], want[k])]
        if differ or "grafted pretrained backbone" not in out.getvalue():
            raise AssertionError(f"cli_rest: the grafted backbone differs "
                                 f"from the file in {differ[:5]}")
        after = state.model.backbone.state_dict()
        if state.step != steps or all(torch.equal(after[k].cpu(), want[k])
                                      for k in want):
            raise AssertionError(f"cli_rest: {state.step} steps, backbone "
                                 f"moved: no")
        with open(f"{tmp}/model/metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        files = glob.glob(f"{tmp}/model/tb/events.out.tfevents.*")
        if len(files) != 1:
            raise AssertionError(f"cli_rest: event files {files}")
        events = list(read_events(files[0]))
        got = {(e["step"], tag, value) for e in events
               for tag, plugin, value in e.get("values", ())}
        logged = {(r["step"], k, float(torch.tensor(v, dtype=torch.float32)))
                  for r in recs for k, v in r.items()
                  if k != "step" and isinstance(v, float)}
        if events[0].get("file_version") != "brain.Event:2" or (
                logged - got) or len(recs) != steps:
            raise AssertionError(f"cli_rest: event file lacks "
                                 f"{sorted(logged - got)[:5]} of "
                                 f"metrics.jsonl's {len(logged)} scalars")
    return {"launches": launches, "tensors": len(want), "scalars": len(got),
            "events": len(events),
            "losses": [r["total_loss"] for r in recs],
            "expected": {"fused_sepconv": 0, "psroi_align": steps,
                         "psroi_align_backward": steps,
                         "nms_suppress": steps * nms_launches(
                             lighthead_resnet50().model, train=True)}}


def run_overfit(cfg, device, steps: int, dtype) -> dict:
    """``tools/overfit.overfit`` of ``cfg`` for ``steps`` steps in ``dtype``,
    the kernels' counters zeroed just before: its readings, the launches
    and what they should be (for Light-Head B1's forward once a step and
    once more for the scoring forward, its backward once a step; exact
    NMS's kernels in each step and in the scoring forward and its
    detections; nothing else: the train route takes no B2)."""
    from x_detector_tpu_torch.tools import overfit
    counters = path_counters()
    reset_counters(counters, device)
    res = overfit.overfit(cfg, device, steps, dtype)
    res["launches"] = {name: fn.launches for name, fn in counters.items()}
    b1 = int(cfg.model.family == "lighthead")
    res["expected"] = {**dict.fromkeys(counters, 0),
                       "psroi_align": (steps + 1) * b1,
                       "psroi_align_backward": steps * b1,
                       "nms_suppress": steps * nms_launches(
                           cfg.model, train=True) + nms_launches(cfg.model)}
    return res


def check_overfit(tag: str, res: dict, loss_gate: bool = True) -> None:
    """The launches the run should give and JAX's gates: the mAP above
    0.95 and, with ``loss_gate``, the last loss below 0.2."""
    from x_detector_tpu_torch.tools import overfit
    if res["launches"] != res["expected"]:
        raise AssertionError(f"{tag}: launches {res['launches']}, expected "
                             f"{res['expected']}")
    if not res["passed" if loss_gate else "map_passed"]:
        raise AssertionError(
            f"{tag}: did not overfit: loss {res['total_loss']:.4g} (gate < "
            f"{overfit.MAX_LOSS}), mAP {res['mAP']:.4f} (gate > "
            f"{overfit.MIN_MAP})")


def run_capstone(cfg, device, steps: int = LEARN_STEPS,
                 eval_batches: int = LEARN_EVAL_BATCHES,
                 calib_batches: int = LEARN_CALIB_BATCHES,
                 dtype=torch.bfloat16) -> dict:
    """The short capstone: ``tools/fast_nms_ab.train_synthetic`` of ``cfg``
    for ``steps`` steps, then the held-out mAP of the same weights on
    ``eval_batches`` batches in the modes "exact", "approx" and "maxpool"
    (bf16) and in int8 (calibrated by ``tools/quant_ab.calibrate`` over
    ``calib_batches`` batches of the calibration stream). The counters are
    zeroed just before the training and just before each evaluation.
    Returns the train readings and launches, and per side its mAP,
    launches, what they should be (B2 a fused block and B1's forward once
    a batch, exact NMS's kernels as the side's config runs them; K1 a
    dense QuantConv, K2 a depthwise one, K3 each but the
    pointwise convs whose input K2 quantized) and its detections of each
    batch (read after the counts)."""
    from x_detector_tpu_torch.tools import fast_nms_ab as ab
    from x_detector_tpu_torch.tools import quant_ab
    counters = path_counters()
    reset_counters(counters, device)
    state, info = ab.train_synthetic(cfg, steps, device, dtype,
                                     log_every=max(steps // 4, 1), log=log)
    b1 = int(cfg.model.family == "lighthead")
    res = {"train": info,
           "train_launches": {n: fn.launches for n, fn in counters.items()},
           "train_expected": {**dict.fromkeys(counters, 0),
                              "psroi_align": steps * b1,
                              "psroi_align_backward": steps * b1,
                              "nms_suppress": steps * nms_launches(
                                  cfg.model, train=True)},
           "eval": {}}
    batches = [ab.held_out_batch(cfg, device, bi)
               for bi in range(eval_batches)]
    ranges = quant_ab.calibrate(cfg, state.model, quant_ab.calibration_images(
        cfg, device, calib_batches), dtype)
    detects = {mode: ab.make_detect_fn(cfg, state.model, mode, dtype)
               for mode in ab.MODES}
    detects["int8"] = quant_ab.make_int8_detect(cfg, state.model, ranges,
                                                dtype)
    for name, detect in detects.items():
        reset_counters(counters, device)
        m = ab.eval_map(cfg, detect, eval_batches, device, batches)
        launches = {n: fn.launches for n, fn in counters.items()}
        per_batch = {**dict.fromkeys(counters, 0),
                     "fused_sepconv": fused_blocks(detect.model),
                     "psroi_align": b1,
                     "nms_suppress": nms_launches(ab.detect_config(
                         cfg, "exact" if name == "int8" else name).model)}
        if name == "int8":
            per_batch.update(int8_calls(detect.model))
        res["eval"][name] = {
            "mAP": m, "launches": launches, "per_batch": per_batch,
            "expected": {k: v * eval_batches for k, v in per_batch.items()},
            "detections": [tuple(t.cpu() for t in detect(b["image"]))
                           for b in batches]}
    res["ranges"] = ranges
    return res


def check_capstone(res: dict, per_batch: dict) -> None:
    """The short capstone's gates: the train and evaluation launches as
    expected, each side's per batch as ``per_batch`` says (name -> counts
    a batch); every loss finite and the mean of the last LEARN_LOSS_WINDOW
    below the mean of the first; every range positive; "approx"'s
    detections bitwise "exact"'s (the port's approx_prefilter is the exact
    top-k)."""
    if res["train_launches"] != res["train_expected"]:
        raise AssertionError(f"learn: train launches "
                             f"{res['train_launches']}, expected "
                             f"{res['train_expected']}")
    for name, side in res["eval"].items():
        want = {**dict.fromkeys(side["per_batch"], 0), **per_batch[name]}
        if side["per_batch"] != want:
            raise AssertionError(f"learn: {name} should launch {want} a "
                                 f"batch; the model gives "
                                 f"{side['per_batch']}")
        if side["launches"] != side["expected"]:
            raise AssertionError(f"learn: {name} launched "
                                 f"{side['launches']}, expected "
                                 f"{side['expected']}")
    losses = res["train"]["losses"]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"learn: non-finite losses {losses}")
    w = LEARN_LOSS_WINDOW
    first, last = (sum(v) / len(v) for v in (losses[:w], losses[-w:]))
    if not last < first:
        raise AssertionError(f"learn: the loss did not fall: mean of the "
                             f"first {w} steps {first:.4f}, of the last "
                             f"{last:.4f}")
    low = [k for k, v in res["ranges"].items() if not float(v) > 0.0]
    if low:
        raise AssertionError(f"learn: uncalibrated ranges {low[:5]}")
    for bi, (a, e) in enumerate(zip(res["eval"]["approx"]["detections"],
                                    res["eval"]["exact"]["detections"])):
        hold_bitwise(f"learn: batch {bi}", a, e,
                     what="of the approx path differs from the exact's")


def phase_learn(device="cuda") -> dict:
    """The learn phase: ``run_overfit`` at each LEARN_OVERFIT_STEPS size,
    then ``run_capstone`` of config 3's recipe; each checked. Returns the
    launches of each path for the kernels' line."""
    from x_detector_tpu_torch.tools import fast_nms_ab as ab
    from x_detector_tpu_torch.tools import overfit
    paths = {}
    for size, cfg in (("small", overfit.small_config()),
                      ("lighthead", overfit.full_width_config("lighthead")),
                      ("ssd", overfit.full_width_config("ssd"))):
        steps = LEARN_OVERFIT_STEPS[size]
        dtype = overfit.train_dtype(cfg, device)
        torch.cuda.reset_peak_memory_stats()
        res = run_overfit(cfg, device, steps, dtype)
        paths[f"learn_overfit_{size}"] = {"launches": res["launches"]}
        marks = [i for i in (0, 9, 29, 59, 119, 199, 299) if i < steps]
        by_step = ", ".join(f"{i + 1}: {res['losses'][i]:.4f}"
                            for i in marks)
        gates = (f"loss < {overfit.MAX_LOSS}, " if size == "small"
                 else "") + f"mAP > {overfit.MIN_MAP}"
        log(f"learn: overfit {cfg.model.name} at {cfg.model.image_size} px "
            f"({str(dtype)[6:]}), {overfit.NUM_IMAGES} fixed images, "
            f"{steps} steps in {res['seconds']:.1f} s after the first "
            f"({res['seconds'] / max(steps - 1, 1) * 1e3:.2f} ms a step): "
            f"loss by step {{{by_step}, {steps}: {res['total_loss']:.4f}}}, "
            f"mAP {res['mAP']:.4f} "
            f"(gates: {gates}; lr {cfg.train.learning_rate:g}); "
            f"launches {res['launches']}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check_overfit(f"learn: overfit {size}", res,
                      loss_gate=size == "small")
    cfg = ab.capstone_config("lighthead", LEARN_RECIPE_STEPS)
    torch.cuda.reset_peak_memory_stats()
    res = run_capstone(cfg, device)
    paths["learn_train"] = {"launches": res["train_launches"]}
    paths.update({f"learn_{name}": {"launches": side["launches"]}
                  for name, side in res["eval"].items()})
    losses, w = res["train"]["losses"], LEARN_LOSS_WINDOW
    log(f"learn: capstone, config 3's recipe ({LEARN_RECIPE_STEPS} steps), "
        f"its first {LEARN_STEPS} steps at batch {cfg.train.batch_size}, "
        f"{cfg.model.image_size} px, bf16: "
        f"{res['train']['train_images_per_sec']:.1f} train images/s; loss "
        f"mean of the first {w} {sum(losses[:w]) / w:.4f}, of the last "
        f"{sum(losses[-w:]) / w:.4f}; held-out mAP on "
        f"{LEARN_EVAL_BATCHES} batches: " + ", ".join(
            f"{name} {side['mAP']:.4f}" for name, side in res["eval"].items())
        + f" (int8 calibrated on {LEARN_CALIB_BATCHES} batches, "
        f"{len(res['ranges'])} ranges); launches a batch " + "; ".join(
            f"{name} " + str({k: v for k, v in side["per_batch"].items()
                              if v}) for name, side in res["eval"].items())
        + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # exact NMS twice a batch (proposals, tail); MaxpoolNMS leaves the tail
    bf16 = {"fused_sepconv": 14, "psroi_align": 1, "nms_suppress": 4}
    check_capstone(res, {"exact": bf16, "approx": bf16,
                         "maxpool": {**bf16, "nms_suppress": 2},
                         "int8": {"int8_conv": 20, "int8_dwconv": 16,
                                  "quantize_s8": 20, "psroi_align": 1,
                                  "nms_suppress": 4}})
    return paths


# ---------------------------------------------------------------------------
# The last tools: rehearse, multihost, voc_pipeline, parity1
# ---------------------------------------------------------------------------

def repo_run(argv, env_extra=None,
             timeout=None) -> subprocess.CompletedProcess:
    """``python argv`` from this checkout's root, with the root on
    PYTHONPATH (and ``env_extra``), its output captured."""
    from x_detector_tpu_torch.tools import REPO, repo_env
    return subprocess.run([sys.executable, *argv], cwd=REPO,
                          env=repo_env(**(env_extra or {})),
                          capture_output=True, text=True, timeout=timeout)


def failed_run(tag: str, proc) -> AssertionError:
    return AssertionError(f"{tag}: rc {proc.returncode}\n"
                          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")


def run_rehearse(steps: int = REHEARSE_STEPS,
                 ckpt_every: int = REHEARSE_CKPT_EVERY) -> dict:
    """``tools.rehearse_config5 --full-width`` at config 5's global batch
    of 128 on this card (world 1 x DP_MICROBATCH x 16 microbatches): runs
    A, B (killed) and C, each a fresh process. Fails unless the verdict is
    bitwise and each child launched B1's forward and backward once a
    microbatch. Returns the verdict, the children's launches and step
    seconds (rank 0's lines) and the ops warned as nondeterministic."""
    from x_detector_tpu_torch.ops.library import read_launch_lines
    accum = 128 // DP_MICROBATCH
    proc = repo_run(["-m", "x_detector_tpu_torch.tools.rehearse_config5",
                     "--full-width", "--per-device-batch",
                     str(DP_MICROBATCH), "--grad-accum", str(accum),
                     "--steps", str(steps), "--ckpt-every", str(ckpt_every)],
                    timeout=REHEARSE_TIMEOUT_S)
    if proc.returncode != 0:
        raise failed_run("rehearse", proc)
    verdict = json.loads([line for line in proc.stdout.splitlines()
                          if line.startswith("{")][-1])
    kill_at = ckpt_every * max(1, steps // (2 * ckpt_every))
    children = {"A": steps, "B": kill_at, "C": steps - kill_at}
    launches = dict(zip(children, read_launch_lines(proc.stdout)))
    if not verdict["bitwise_identical"] or verdict["global_batch"] != 128:
        raise AssertionError(f"rehearse: verdict {verdict}")
    for run, n in children.items():
        got = launches.get(run, {})
        if (got.get("psroi_align"), got.get("psroi_align_backward")) != (
                accum * n, accum * n):
            raise AssertionError(f"rehearse: run {run} ({n} steps) launched "
                                 f"{got}, expected B1 {accum} a step each "
                                 f"way")
    step_s = [float(line.split(", ")[-1][:-2]) for line in
              proc.stdout.splitlines() if line.startswith("step ")]
    warned = [line.split(": ", 1)[1] for line in proc.stdout.splitlines()
              if line.startswith("nondeterministic ops warned")]
    total = {k: sum(r.get(k, 0) for r in launches.values())
             for k in launches["A"]}
    return {"verdict": verdict, "launches": total, "by_child": launches,
            "step_s": step_s, "warned": warned}


def counted_cli_train(argv) -> int:
    """``cli.train.main(argv)`` in this process (one of torchrun's ranks in
    the multihost phase), then its kernels' launch counts."""
    from x_detector_tpu_torch.cli import train
    from x_detector_tpu_torch.ops.library import launch_line
    train.main(argv)
    print(launch_line(), flush=True)
    return 0


def run_multihost(world: int, steps: int = 2) -> dict:
    """``cli.train --preset lighthead_xception --steps 2`` under
    ``torch.distributed.run --standalone`` with ``XDET_MULTIHOST=1`` (NCCL,
    ``world`` ranks, one a card; world 1 on one card), through
    ``counted_cli_train``; then, for world 1, the same CLI run plainly in a
    fresh process of its own (so that both start from PyTorch's default
    settings). Fails unless torchrun's run exits 0 with a checkpoint at
    step 2 and data position 2, metrics.jsonl steps [1, 2], and B1 once
    a step each way on every rank; for world 1, unless its first-step loss
    equals the plain run's. Returns the launches, the losses and the
    largest gap between the two runs' final checkpoints."""
    from x_detector_tpu_torch.ops.library import read_launch_lines
    with tempfile.TemporaryDirectory() as tmp:
        cli = ["--preset", "lighthead_xception", "--steps", str(steps),
               "--log-every", "1", "--checkpoint-every", str(steps)]
        proc = repo_run(["-m", "torch.distributed.run", "--standalone",
                         "--nproc-per-node", str(world),
                         os.path.abspath(__file__), "--counted-cli-train",
                         *cli, "--model-dir", f"{tmp}/torchrun"],
                        env_extra={"XDET_MULTIHOST": "1"},
                        timeout=MULTIHOST_TIMEOUT_S)
        if proc.returncode != 0:
            raise failed_run(f"multihost world {world}", proc)
        ranks = read_launch_lines(proc.stdout)
        want = {"psroi_align": steps, "psroi_align_backward": steps}
        if len(ranks) != world or any(
                {k: r[k] for k in want} != want for r in ranks):
            raise AssertionError(f"multihost world {world}: launches by rank "
                                 f"{ranks}, expected {want} each")
        ckpt = torch.load(f"{tmp}/torchrun/ckpt/ckpt-{steps}.pt",
                          weights_only=True)
        with open(f"{tmp}/torchrun/metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        if (ckpt["step"], ckpt["data_state"]) != (steps, {"position": steps}
                                                  ) or [r["step"] for r in
                                                        recs] != [1, 2]:
            raise AssertionError(f"multihost world {world}: checkpoint step "
                                 f"{ckpt['step']} {ckpt['data_state']}, "
                                 f"metrics steps {[r['step'] for r in recs]}")
        res = {"launches": {k: sum(r[k] for r in ranks) for k in ranks[0]},
               "losses": [r["total_loss"] for r in recs]}
        if world != 1:
            return res
        plain = f"{tmp}/plain"
        proc = repo_run([os.path.abspath(__file__), "--counted-cli-train",
                         *cli, "--model-dir", plain],
                        timeout=MULTIHOST_TIMEOUT_S)
        if proc.returncode != 0:
            raise failed_run("multihost: the plain run", proc)
        with open(f"{plain}/metrics.jsonl") as f:
            res["plain_losses"] = [json.loads(line)["total_loss"]
                                   for line in f]
        if res["plain_losses"][0] != res["losses"][0]:
            raise AssertionError(f"multihost: torchrun's first-step loss "
                                 f"{res['losses'][0]!r} differs from the "
                                 f"plain run's {res['plain_losses'][0]!r}")
        other = torch.load(f"{plain}/ckpt/ckpt-{steps}.pt",
                           weights_only=True)["model"]
        res["state_gap"] = max(
            (a.float() - b.float()).abs().max().item()
            for k, a in ckpt["model"].items()
            for b in [other[k]] if a.is_floating_point())
        res["state_differs"] = sum(not torch.equal(a, other[k])
                                   for k, a in ckpt["model"].items())
        res["state_tensors"] = len(ckpt["model"])
    return res


def run_voc_pipeline() -> dict:
    """``tools.rehearse_voc_pipeline`` on this card with lighthead_xception
    at 800 px (batch 2), photo-sized JPEGs (nvJPEG decodes them here) and
    ``--fused-sepconv`` on export. Fails unless every stage passes and the
    reloaded program launched B2 14 times and B1's forward once on its
    batch of 1. Returns each stage's seconds and the reload's launches."""
    import re
    from x_detector_tpu_torch.ops.library import read_launch_lines
    from x_detector_tpu_torch.tools import rehearse_voc_pipeline as voc
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(out):
        rc = voc.main(["--preset", "lighthead_xception", "--image-size",
                       "800", "--fused-sepconv", "--workdir", tmp])
    text = out.getvalue()
    if rc != 0:
        raise AssertionError(f"voc_pipeline: rc {rc}\n{text[-4000:]}")
    launches = read_launch_lines(text)[-1]
    want = {"fused_sepconv": 14, "psroi_align": 1, "psroi_align_backward": 0}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"voc_pipeline: the reloaded program launched "
                             f"{launches}, expected {want}")
    stages = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^--- (\w+) passed in ([\d.]+) s$", text, re.M)}
    return {"launches": launches, "stages": stages}


def run_parity1(steps: int = PARITY1_STEPS) -> dict:
    """Config 1's parity record (``tools.config1_parity``) on this card (in
    this process, TF32 off) and on the CPU (a fresh process, ``--compare``
    against the card's), both from one checkpoint of ``cli.train --preset
    lighthead_resnet50 --steps`` ``steps`` on the card. Fails unless the CPU
    run prints PARITY OK and exits 0, and the card's record launched B1's
    forward once, exact NMS's kernels twice each (proposals, tail) and B2
    never. Returns the launches, the detection count
    and the compare's lines."""
    from x_detector_tpu_torch.cli import train
    from x_detector_tpu_torch.tools import config1_parity as c1
    counters = kernel_counters()
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            train.main(["--preset", "lighthead_resnet50", "--steps",
                        str(steps), "--model-dir", tmp, "--log-every",
                        str(steps)])
        train_s = time.perf_counter() - t0
        reset_counters(counters, "cuda")
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = c1.main(["--checkpoint-dir", tmp, "--out",
                              f"{tmp}/card.json"])
            torch.cuda.synchronize()
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = tf32
        launches = {name: fn.launches for name, fn in counters.items()}
        with open(f"{tmp}/card.json") as f:
            card = json.load(f)
        t0 = time.perf_counter()
        proc = repo_run(["-m", "x_detector_tpu_torch.tools.config1_parity",
                         "--device", "cpu", "--checkpoint-dir", tmp,
                         "--out", f"{tmp}/cpu.json", "--compare",
                         f"{tmp}/card.json"], timeout=PARITY1_TIMEOUT_S)
        cpu_s = time.perf_counter() - t0
    want = {"fused_sepconv": 0, "psroi_align": 1, "psroi_align_backward": 0,
            "nms_suppress": nms_launches(lighthead_resnet50().model)}
    lines = [line for line in proc.stdout.splitlines()
             if not line.startswith("wrote ")]
    if rc != 0 or proc.returncode != 0 or "PARITY OK" not in proc.stdout:
        raise failed_run("parity1: the CPU record against the card's", proc)
    if launches != want:
        raise AssertionError(f"parity1: the card's record launched "
                             f"{launches}, expected {want}")
    return {"launches": launches, "detections": len(card["scores"]),
            "compare": lines, "train_s": train_s, "cpu_s": cpu_s}


def phase_tools() -> dict:
    """The last tools' phases, each timed: ``rehearse``, ``multihost``
    (world 1, and world 2 where two cards are visible), ``voc_pipeline``
    and ``parity1``. Returns the launches of each path for the kernels'
    line."""
    paths = {}
    t0 = time.perf_counter()
    res = run_rehearse()
    paths["rehearse"] = res
    a_steps = res["step_s"][:REHEARSE_STEPS]
    log(f"rehearse: tools.rehearse_config5 --full-width, world 1 x "
        f"{128 // DP_MICROBATCH} microbatches of {DP_MICROBATCH} = global "
        f"batch 128 at 800 px: {json.dumps(res['verdict'])}; launches by "
        f"run {res['by_child']}; run A's step seconds "
        f"{[round(s, 3) for s in a_steps]} (deterministic algorithms, "
        f"synced; median after the first "
        f"{sorted(a_steps[1:])[len(a_steps[1:]) // 2]:.3f}); ops warned as "
        f"having no deterministic version, by run: {res['warned']}; "
        f"{time.perf_counter() - t0:.1f} s")
    for world in (1, 2):
        if torch.cuda.device_count() < world:
            log(f"multihost: world {world} skipped: "
                f"{torch.cuda.device_count()} card visible")
            continue
        t0 = time.perf_counter()
        res = run_multihost(world)
        paths[f"multihost_world{world}"] = res
        plain = ("" if world != 1 else
                 f"; the plain run's losses {res['plain_losses']} (first "
                 f"step equal); final states: {res['state_differs']} of "
                 f"{res['state_tensors']} tensors differ, by at most "
                 f"{res['state_gap']:.3g}")
        log(f"multihost: cli.train --preset lighthead_xception --steps 2 "
            f"under torch.distributed.run --standalone, XDET_MULTIHOST=1, "
            f"NCCL, world {world}: checkpoint at step 2 (data position 2), "
            f"metrics.jsonl steps [1, 2], losses {res['losses']}, launches "
            f"{res['launches']}{plain}; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res = run_voc_pipeline()
    paths["voc_pipeline"] = res
    log(f"voc_pipeline: tools.rehearse_voc_pipeline --preset "
        f"lighthead_xception --image-size 800 --fused-sepconv (12 "
        f"photo-sized JPEGs, batch 2): every stage passed; seconds by stage "
        f"{res['stages']}; the reloaded program's launches on a batch of 1 "
        f"{res['launches']}; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res = run_parity1()
    paths["parity1"] = res
    log(f"parity1: config 1 trained {PARITY1_STEPS} steps on the card "
        f"({res['train_s']:.1f} s), its record of the synthetic 600 x 800 "
        f"image on the card (fp32, TF32 off; launches {res['launches']}; "
        f"{res['detections']} detections) and on the CPU "
        f"({res['cpu_s']:.1f} s, a fresh process): " + " | ".join(
            res["compare"]) + f"; {time.perf_counter() - t0:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# bench: the measurement tools, each in this process at its preset widths
# ---------------------------------------------------------------------------

def run_tool(name: str, argv) -> dict:
    """``tools.<name>.main(argv)`` in this process, the kernels' counts set
    to 0 just before: its JSON rows, every kernel's launches over the run
    and its seconds."""
    import importlib
    module = importlib.import_module(f"x_detector_tpu_torch.tools.{name}")
    counters = path_counters()
    reset_counters(counters, "cuda")
    t0 = time.perf_counter()
    rows = module.main(list(argv))
    torch.cuda.synchronize()
    return {"rows": rows, "seconds": time.perf_counter() - t0,
            "launches": {k: fn.launches for k, fn in counters.items()}}


def check_rows(tag: str, rows, smi: str) -> None:
    """Fails unless ``tag`` printed rows and each names the card
    (nvidia-smi's name and power limit)."""
    if not rows or any(row.get("device") != smi for row in rows):
        raise AssertionError(f"{tag}: rows without the card's name and "
                             f"power ({smi!r}): {rows}")


def check_per_batch(tag: str, got: dict, want: dict) -> None:
    """Fails unless the launches a batch (or step) ``got`` are ``want``'s,
    every other kernel's 0."""
    full = {k: float(want.get(k, 0)) for k in got}
    if got != full:
        raise AssertionError(f"{tag}: launches a batch {got}, expected "
                             f"{full}")


# exact NMS's two kernels twice a Light-Head batch (the proposal stage and
# the tail), once an SSD batch (its tail) and once a Light-Head train step
# (proposals)
B3_PER_BATCH = {"fused_sepconv": 14, "psroi_align": 1, "nms_suppress": 4}
# path -> (tool, its arguments, what it must launch): None nothing, a set
# those kernels, a dict those launches a batch (a step) in the tool's rows
BENCH_RUNS = {
    # config 1 on this machine's CPU: 800 px, fp32 and bf16
    "bench_cpu_config1": ("bench_cpu_config1", ["--iters", "3"], None),
    "bench_detect": ("bench_detect", [
        "--preset", "lighthead_xception", "--batch", "16", "--iters", "4"],
        B3_PER_BATCH),
    # per-stage FLOPs and MFU: configs 3, 1 (one image) and 2
    "bench_infer_config3": ("bench_infer", [
        "--preset", "lighthead_xception", "--batch", "16", "--iters", "4",
        "--passes", "5"], B3_PER_BATCH),
    "bench_infer_config1": ("bench_infer", [
        "--preset", "lighthead_resnet50", "--batch", "1", "--iters", "4",
        "--passes", "5"], {"psroi_align": 1, "nms_suppress": 4}),
    "bench_infer_config2": ("bench_infer", [
        "--preset", "ssd_resnet50", "--batch", "8", "--iters", "4",
        "--passes", "5"], {"nms_suppress": 2}),
    "bench_train": ("bench_train", ["--steps", "5"],
                    {"psroi_align": 1, "psroi_align_backward": 1,
                     "nms_suppress": 2}),
    # eager at every bucket; a container of the buckets serve does not
    # export
    "bench_serving": ("bench_serving", ["--batches", "1,4,8,16"],
                      B3_PER_BATCH),
    "bench_serving_container": ("bench_serving", [
        "--batches", "4,8", "--container"], B3_PER_BATCH),
    "bench_preproc": ("bench_preproc", ["--iters", "4"], None),
    "bench_nms_tail": ("bench_nms_tail", [], {"nms_suppress"}),
    "bench_psroi": ("bench_psroi", [], {"psroi_align"}),
    # fused: B2 and B1 a batch as config 3; unfused: B1 alone
    "bench_fused_sepconv": ("bench_fused_sepconv", [
        "--iters", "4", "--passes", "3"], B3_PER_BATCH),
    "bench_int8": ("bench_int8", [],
                   {"int8_conv", "int8_dwconv", "quantize_s8"}),
    "bench_depthwise": ("bench_depthwise", [], None),
}


def check_bench(path: str, name: str, res: dict, want) -> None:
    """Fails unless ``path``'s run of tool ``name`` launched what ``want``
    says (``BENCH_RUNS``): nothing, each kernel of a set, or a dict's
    launches a batch (a step) in each row that counts them."""
    rows, launched = res["rows"], res["launches"]
    if want is None:
        if any(launched.values()):
            raise AssertionError(f"{path}: launched {launched}")
    elif isinstance(want, set):
        if not all(launched[k] > 0 for k in want):
            raise AssertionError(f"{path}: launches {launched}, expected "
                                 f"each of {sorted(want)}")
    elif name == "bench_fused_sepconv":
        check_per_batch(path, rows[-1]["fused_launches_per_batch"], want)
        check_per_batch(path, rows[-1]["unfused_launches_per_batch"],
                        dict(want, fused_sepconv=0))
    else:
        keys = ("launches_per_batch", "launches_per_step",
                "container_launches_per_batch")
        held = [row[k] for row in rows for k in keys if k in row]
        if not held or ("container" in path) != any(
                "container_launches_per_batch" in row for row in rows):
            raise AssertionError(f"{path}: no launch counts in {rows}")
        for got in held:
            check_per_batch(path, got, want)


def phase_bench(smi: str, runs=None) -> dict:
    """The eleven measurement tools (``tools/bench_*``), each run in this
    process (``run_tool``) as ``runs`` (``BENCH_RUNS``) says: at its
    preset widths with few iterations, each a path of the kernels line,
    each timed, each row of a card tool naming the card (``smi``), its
    launches checked (``check_bench``); a tool that raises fails the run.
    Returns the paths' readings."""
    paths, t_all = {}, time.perf_counter()
    for path, (name, argv, want) in (runs or BENCH_RUNS).items():
        paths[path] = res = run_tool(name, argv)
        if name == "bench_cpu_config1":
            if any(row["threads"] < 1 or not row["host"].startswith(
                    "nproc=") or not math.isfinite(row["latency_ms"])
                   for row in res["rows"]):
                raise AssertionError(f"{path}: {res['rows']}")
        else:
            check_rows(path, res["rows"], smi)
        check_bench(path, name, res, want)
        log(f"bench: {path} ({res['seconds']:.1f} s): launches "
            f"{res['launches']}")
    log(f"bench: the eleven tools in {time.perf_counter() - t_all:.1f} s")
    return paths


def fused(cfg):
    """``cfg`` with the backbone's stride-1 separable blocks on kernel B2,
    as config 3 runs it."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_fused_sepconv=True))


def main() -> int:
    smi = phase_device()
    from x_detector_tpu_torch.config import (config5, ssd_resnet50,
                                             xdet_xception)
    phase_build()
    kernels = phase_kernels()
    kernels.append(n1_kernel_line(phase_nms_kernels()))
    kernels += int8_kernel_lines(phase_int8_kernels())

    paths = {}
    # config 3, the first main path: B2 14 times and B1's forward once a
    # batch
    cfg = fused(lighthead_xception(800))
    torch.cuda.reset_peak_memory_stats()
    paths["slice"] = res = run_slice(cfg, "cuda", keep_path=True)
    check_slice("config 3", res, {"fused_sepconv": 14, "psroi_align": 1,
                                  "psroi_align_backward": 0,
                                  "nms_suppress": 4})
    report_slice("slice: config 3 at 800 px, fused sepconv", res, BATCH)
    report_boundary("slice: config 3", res)
    slice_reference_check(cfg.model, "cuda", ("rpn_cls", "rpn_loc"))
    torch.cuda.synchronize()

    # config 1: one VOC-sized image at a time, resized to 800 px on the
    # card; B1's forward once an image, B2 never
    cfg = lighthead_resnet50(800)
    torch.cuda.reset_peak_memory_stats()
    paths["config1"] = res = run_slice(cfg, "cuda", batches=CONFIG1_IMAGES,
                                       batch_size=1, raw_hw=CONFIG1_RAW_HW,
                                       keep_path=True)
    check_slice("config 1", res, {"fused_sepconv": 0, "psroi_align": 1,
                                  "psroi_align_backward": 0,
                                  "nms_suppress": 4})
    report_slice(f"config1: Light-Head + ResNet-50 at 800 px from "
                 f"{CONFIG1_RAW_HW[0]} x {CONFIG1_RAW_HW[1]} uint8 images",
                 res, 1)
    report_boundary("config1", res)
    slice_reference_check(cfg.model, "cuda", ("rpn_cls", "rpn_loc"))
    torch.cuda.synchronize()

    # config 2 (SSD + ResNet-50) and xdet_xception with the fused separable
    # conv: exact NMS's kernels once (the tail), and B2 never or 13 times
    # a batch
    for path, cfg, per_batch in (
            ("ssd", ssd_resnet50(512), {"fused_sepconv": 0, "psroi_align": 0,
                                        "psroi_align_backward": 0,
                                        "nms_suppress": 2}),
            ("xdet", fused(xdet_xception(512)), {"fused_sepconv": 13,
                                                 "psroi_align": 0,
                                                 "psroi_align_backward": 0,
                                                 "nms_suppress": 2})):
        torch.cuda.reset_peak_memory_stats()
        paths[path] = res = run_slice(cfg, "cuda", batch_size=SSD_BATCH)
        check_slice(cfg.model.name, res, per_batch)
        report_slice(f"{path}: {cfg.model.name} at 512 px, approx_prefilter="
                     f"{cfg.model.nms.approx_prefilter} (the exact top-k)",
                     res, SSD_BATCH)
        slice_reference_check(cfg.model, "cuda", ("cls_logits", "box_codes"))
        torch.cuda.synchronize()

    # fast: MaxpoolNMS on config 3's proposal stage (B2 14 and B1 1 a
    # batch, exact NMS never in the forward) and on config 2's tail (exact
    # NMS never), beside each exact path in alternating rounds
    no_kernels = {"fused_sepconv": 0, "psroi_align": 0,
                  "psroi_align_backward": 0, "nms_suppress": 0}
    for path, cfg, batch, family, per_batch in (
            ("fast", fused(lighthead_xception(800)), BATCH, "lighthead",
             {"fused_sepconv": 14, "psroi_align": 1,
              "psroi_align_backward": 0, "nms_suppress": 2}),
            ("fast_config2", ssd_resnet50(512), SSD_BATCH, "ssd",
             no_kernels)):
        torch.cuda.reset_peak_memory_stats()
        paths[path] = res = run_fast(cfg, "cuda", batch_size=batch,
                                     profile=family == "lighthead")
        check_slice(path, res, per_batch)
        check_fast(path, res, family)
        report_slice(f"{path}: {cfg.model.name} with MaxpoolNMS", res, batch)
        log(f"{path}: exact NMS calls over {res['batches']} batches, in "
            f"the forward / in all: exact path {res['exact_suppress']}, "
            f"MaxpoolNMS {res['suppress']}; ms a batch "
            f"{rounds_text(res['ms'])}: fast / exact "
            f"{res['ms']['fast']['median'] / res['ms']['exact']['median']:.3f}")
        if family == "lighthead":
            named = res["trace_kernels"]
            for want in ("sepconv_tma_kernel", "psroi_align_fwd_kernel"):
                if not any(want in k for k in named):
                    raise AssertionError(f"fast: the profiler's trace names "
                                         f"no {want}: {named[:20]}")
            log(f"fast: utils.profiling.trace of one batch names "
                f"{len(named)} device kernels, B2's and B1's among them; "
                f"utils.profiling.DeviceTimer: {res['timer_ms']:.3f} ms a "
                f"batch")
            slice_reference_check(maxpool_nms(cfg).model, "cuda",
                                  ("rpn_cls", "rpn_loc"))
        torch.cuda.synchronize()

    # dense: config 3's fused model with Xception-lite's stage 1 dense
    # (dense_stages=1): B2 10 times a batch (stage 1's four blocks dense)
    cfg = fused(lighthead_xception(800))
    torch.cuda.reset_peak_memory_stats()
    paths["dense"] = res = run_slice(
        cfg, "cuda", model=slice_model(cfg.model, "cuda", dense_stages=1),
        keep_path=True)
    check_slice("dense", res, {"fused_sepconv": 10, "psroi_align": 1,
                               "psroi_align_backward": 0,
                               "nms_suppress": 4})
    report_slice("dense: config 3 at 800 px, fused, dense_stages=1", res,
                 BATCH)
    separable = run_slice(cfg, "cuda", batches=0, keep_path=True)
    dense_fn, sep_fn, u8 = res.pop("detect"), separable.pop("detect"), res[
        "u8"]
    ms = alternating_ms({"separable": lambda: sep_fn(u8),
                         "dense": lambda: dense_fn(u8)})
    log(f"dense: ms a batch {rounds_text(ms)}: dense / separable "
        f"{ms['dense']['median'] / ms['separable']['median']:.3f}")
    del dense_fn, sep_fn, separable
    slice_reference_check(cfg.model, "cuda", ("rpn_cls", "rpn_loc"),
                          dense_stages=1)
    torch.cuda.synchronize()

    # int8: config 2, then config 3, at full width: calibrated on the card,
    # served through build_eval_fn, beside the float paths above (the same
    # weights and images); the prequantized model against the in-graph
    # one; the 128 px check against the CPU
    # K1's routes a batch: the stem (Cin 3 or 12) on the first design,
    # every other dense conv on the "tma" route; K2's: every call on the
    # "tma" route, quantizing on its store for the pointwise conv, so K3
    # runs before every conv but those 16
    for path, cfg, float_path, batch, per_batch, k1_routes, k2_modes, keys in (
            ("int8_config2", ssd_resnet50(512), "ssd", SSD_BATCH,
             {"int8_conv": 53, "int8_dwconv": 0, "quantize_s8": 53,
              "psroi_align": 0, "nms_suppress": 2}, {"tma": 52, "mma": 1},
             {"dequant": 0, "quantize": 0}, ("cls_logits", "box_codes")),
            ("int8_config3", fused(lighthead_xception(800)), "slice", BATCH,
             {"int8_conv": 20, "int8_dwconv": 16, "quantize_s8": 20,
              "psroi_align": 1, "nms_suppress": 4}, {"tma": 19, "mma": 1},
             {"dequant": 0, "quantize": 16}, ("rpn_cls", "rpn_loc"))):
        torch.cuda.reset_peak_memory_stats()
        res, model = run_int8(cfg, "cuda", batch_size=batch, keep_path=True)
        paths[path] = res
        check_slice(path, res, {"fused_sepconv": 0,
                                "psroi_align_backward": 0, **per_batch})
        k2_routes = {"tma": per_batch["int8_dwconv"], "simt": 0}
        for what, got, want in (("K1's routes", res["int8_routes"],
                                 k1_routes),
                                ("K2's routes", res["dw_routes"], k2_routes),
                                ("K2's modes", res["dw_modes"], k2_modes)):
            if got != {r: v * res["batches"] for r, v in want.items()}:
                raise AssertionError(f"{path}: {what} {got} over "
                                     f"{res['batches']} batches, expected "
                                     f"{want} a batch")
        low = min(map(float, res["ranges"].values()))
        report_slice(f"{path}: {cfg.model.name} int8 (calibrated over "
                     f"{INT8_CALIB_BATCHES} batches, {len(res['ranges'])} "
                     f"ranges, min {low:.4g})", res, batch)
        ref = paths[float_path]
        int8_ms, float_ms = (sorted(r["seconds"])[len(r["seconds"]) // 2]
                             * 1e3 for r in (res, ref))
        log(f"{path}: int8 median {int8_ms:.2f} ms a batch "
            f"({batch / int8_ms * 1e3:.1f} images/s, peak "
            f"{res['peak'] / 2**30:.2f} GiB) against the bf16 model's "
            f"{float_ms:.2f} ms ({batch / float_ms * 1e3:.1f} images/s, peak "
            f"{ref['peak'] / 2**30:.2f} GiB; phase {float_path}): "
            f"{float_ms / int8_ms:.3f}x")
        res["alternating_ms"] = int8_rounds(path, res, cfg, batch,
                                            per_batch, k1_routes, k2_modes)
        held = check_prequantized(model, cfg, "cuda")
        log(f"{path}: prequantized model's outputs and detections equal the "
            f"in-graph model's bit for bit ({held} tensors)")
        del model
        int8_reference_check(cfg.model, "cuda", keys, res["ranges"])
        torch.cuda.synchronize()

    # serve: config 3 exported as a container and served from it, bit for
    # bit with eager at buckets 1 and 16; int8 config 2 the same way;
    # cli.predict --artifact
    disp = dispatch_cost()
    log("serve: the operator boundary's host cost, us a call of a tiny "
        "call (median of alternating rounds): " + "; ".join(
            f"{name}: " + ", ".join(f"{side} {us:.2f}"
                                    for side, us in d.items())
            + f" (the operator +{d['operator'] - d['direct']:.2f})"
            for name, d in disp.items()))
    with tempfile.TemporaryDirectory() as work:
        cfg = fused(lighthead_xception(800))
        res = run_serve(cfg, "cuda", f"{work}/config3")
        paths["serve"] = res
        per_batch = {"fused_sepconv": 14, "psroi_align": 1,
                     "psroi_align_backward": 0, "nms_suppress": 4}
        for b, r in res["buckets"].items():
            for side in r["ms"]:
                if r[side]["per_batch"] != per_batch:
                    raise AssertionError(f"serve bucket {b}: {side} launched "
                                         f"{r[side]['per_batch']} a batch, "
                                         f"expected {per_batch}")
            held = ", ".join(side for side in r["ms"] if side != "eager")
            log(f"serve: config 3 bucket {b}"
                f"{' (baked)' if b in SERVE_BAKED else ''}: exported in "
                f"{res['export_s'][b]:.1f} s; {held} bit for bit equal to "
                f"eager (4 outputs), launches a batch {per_batch} on each; "
                f"ms a batch {rounds_text(r['ms'])}")
        log(f"serve: config 3 bucket {min(SERVE_BUCKETS)}: the program "
            f"taking the weights as inputs (\"shared\") exported in "
            f"{res['shared_export_s']:.1f} s; stored weights "
            f"{res['weights_mb']:.1f} MiB")
        pred = run_predict_artifact(f"{work}/config3", "cuda", work)
        log(f"serve: cli.predict --artifact wrote its PNG "
            f"({pred['png_bytes']} bytes, {pred['valid']} valid detections "
            f"of a {SERVE_RAW_HW[0]} x {SERVE_RAW_HW[1]} JPEG)")
        res = run_serve_int8(ssd_resnet50(512), "cuda", f"{work}/int8")
        paths["serve_int8"] = res
        per_batch = {"fused_sepconv": 0, "psroi_align": 0,
                     "psroi_align_backward": 0, "nms_suppress": 2,
                     "int8_conv": 53,
                     "int8_dwconv": 0, "quantize_s8": 53}
        for side in ("eager", "loaded"):
            if res[side]["per_batch"] != per_batch:
                raise AssertionError(f"serve int8: {side} launched "
                                     f"{res[side]['per_batch']} a batch, "
                                     f"expected {per_batch}")
        log(f"serve: int8 config 2 bucket {SERVE_INT8_BUCKET} (weights as "
            f"inputs, stored {res['stored']}): exported in "
            f"{res['export_s'][SERVE_INT8_BUCKET]:.1f} s; loaded bit for bit "
            f"equal to the eager prequantized model, K1 53 / K3 53 / K2 0 a "
            f"batch on both; ms a batch {rounds_text(res['ms'])}")
        report_boundary("serve: int8 config 2", res, res.pop("x"))
    torch.cuda.synchronize()

    cfg = train_config()
    torch.cuda.reset_peak_memory_stats()
    paths["train"] = res = run_train(cfg, "cuda")
    check_train("config 4", res, {"fused_sepconv": 0, "psroi_align": 1,
                                  "psroi_align_backward": 1,
                                  "nms_suppress": 2})
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
                                  "psroi_align_backward": 0,
                                  "nms_suppress": 0})
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

    # train_act8: config 4's step with backbone_quant="act8": K3 once a
    # backbone conv (36) a step; then act8 against the plain conv at a
    # stage-1 shape
    cfg = train_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_quant="act8"))
    torch.cuda.reset_peak_memory_stats()
    paths["train_act8"] = res = run_train(cfg, "cuda")
    check_train("config 4 act8", res, {
        "fused_sepconv": 0, "psroi_align": 1, "psroi_align_backward": 1,
        "nms_suppress": 2, "int8_conv": 0, "int8_dwconv": 0, "quantize_s8": 36})
    if res["moved"] != res["params"]:
        raise AssertionError(f"config 4 act8: only {res['moved']} of "
                             f"{res['params']} parameter tensors changed")
    report_train(f"train_act8: config 4 with backbone_quant=act8, batch "
                 f"{BATCH} at 800 px", res, BATCH,
                 torch.cuda.max_memory_allocated())
    act8_ms, bf16_ms = (sum(r["seconds"]) / len(r["seconds"]) * 1e3
                        for r in (res, paths["train"]))
    log(f"train_act8: mean step {act8_ms:.2f} ms against the bf16 step's "
        f"{bf16_ms:.2f} (phase train): {act8_ms / bf16_ms:.3f}x")
    grads = act8_grad_check("cuda")
    log(f"train_act8: at [16, 128, 200, 200] (cuDNN deterministic), the act8"
        f" conv against the plain one: " + "; ".join(
            f"{name}: output and dL/dx bitwise {g['y_equal'] and g['dx_equal']}"
            f", dL/dk rel RMS {g['dk_rms']:.4g}" for name, g in grads.items()))
    torch.cuda.synchronize()

    # train_remat: 2 steps with backbone_remat_stages=2 against 2 without,
    # config 4 and config 2 (ResNet, EMA): the train states bitwise equal
    for path, cfg in (("train_remat", train_config()),
                      ("train_remat_config2",
                       ssd_train_config("ssd_resnet50"))):
        paths[path] = res = run_remat_pair(cfg, "cuda")
        if res["launches"] != res["expected"]:
            raise AssertionError(f"{path}: launches {res['launches']}, "
                                 f"expected {res['expected']}")
        peak = {n: round(v / 2**30, 3) for n, v in res["peak"].items()}
        ms = {n: round(v, 2) for n, v in res["step_ms"].items()}
        log(f"{path}: {cfg.model.name}, batch {cfg.train.batch_size} at "
            f"{cfg.model.image_size} px, 3 steps with "
            f"backbone_remat_stages=2 bitwise equal to 3 without "
            f"({res['tensors']} tensors: parameters, BatchNorm stats, "
            f"momentum, EMA, step); peak memory GiB by remat stages {peak}; "
            f"mean step ms after the first (deterministic algorithms) "
            f"{ms}: {ms[2] / ms[0]:.3f}x; launches {res['launches']}; ops "
            f"warned as having no deterministic version: "
            f"{res['nondeterministic']}")
        torch.cuda.synchronize()

    # dense_train: config 4's step with dense_stages=1
    torch.cuda.reset_peak_memory_stats()
    paths["dense_train"] = res = run_train(train_config(), "cuda",
                                           dense_stages=1)
    check_train("config 4 dense", res, {"fused_sepconv": 0,
                                        "psroi_align": 1,
                                        "psroi_align_backward": 1,
                                        "nms_suppress": 2})
    report_train(f"dense_train: config 4 with dense_stages=1, batch {BATCH} "
                 f"at 800 px", res, BATCH, torch.cuda.max_memory_allocated())
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

    # cli_rest: cli.train --pretrained --tensorboard on lighthead_resnet50
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    paths["cli_rest"] = res = run_cli_rest("cuda")
    if res["launches"] != res["expected"]:
        raise AssertionError(f"cli_rest: launches {res['launches']}, "
                             f"expected {res['expected']}")
    log(f"cli_rest: cli.train --pretrained (a torchvision-named ResNet-50 "
        f".pth of seeded values, {res['tensors']} tensors grafted bit for "
        f"bit) --tensorboard on lighthead_resnet50, 2 steps of 4 at 800 "
        f"px: losses {[round(v, 4) for v in res['losses']]}, launches "
        f"{res['launches']}; the event file read back with CRCs ({res['events']}"
        f" events) holds all {res['scalars']} scalars of metrics.jsonl; "
        f"{time.perf_counter() - t0:.1f} s")

    # dp: config 5, data-parallel Light-Head training at a global batch of
    # 128 (world 1 over NCCL, 16 microbatches of 8); B1's forward and
    # backward 16 times each a step
    torch.cuda.reset_peak_memory_stats()
    cfg = config5()
    paths["dp"] = res = run_dp(cfg, "cuda")
    accum = cfg.train.grad_accum_steps
    check_train("config 5", res, {"fused_sepconv": 0, "psroi_align": accum,
                                  "psroi_align_backward": accum,
                                  "nms_suppress": 2 * accum})
    if res["moved"] != res["params"]:
        raise AssertionError(f"config 5: only {res['moved']} of "
                             f"{res['params']} parameter tensors changed")
    report_train(f"dp: config 5, world 1 (NCCL) x {accum} microbatches "
                 f"of {cfg.train.batch_size // accum} = global batch "
                 f"{cfg.train.batch_size} at 800 px", res,
                 cfg.train.batch_size, torch.cuda.max_memory_allocated())
    log(f"dp: B1's forward and backward a step: "
        f"{res['launches']['psroi_align'] // (DP_STEPS + 1)} and "
        f"{res['launches']['psroi_align_backward'] // (DP_STEPS + 1)} "
        f"(one a microbatch)")
    log(f"dp: flattened all-reduce of the gradients, BatchNorm stats and "
        f"metrics ({res['allreduce_bytes'] / 2**20:.1f} MiB fp32, world 1): "
        f"{res['allreduce_ms']:.4f} ms")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pair = run_dp_pair(config5(2, global_batch=2 * DP_MICROBATCH,
                               microbatch=DP_MICROBATCH), "cuda")
    log(f"dp: two gloo ranks on this card, {DP_MICROBATCH} images each at "
        f"800 px, {DP_PAIR_STEPS} steps (gloo on CUDA tensors): the two "
        f"ranks' train states and this card's grad_accum_steps = 2 step's "
        f"on the same 16 images and draws bitwise equal ({pair} tensors); "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"dp: cli.train --num-devices 2 on this card raised: "
        f"{check_cli_refuses_two_ranks('cuda')}")

    # data: the committed VOC images -> cli.convert_voc -> the native loader
    # -> cli.train / cli.evaluate --data-dir (config 4's model)
    torch.cuda.reset_peak_memory_stats()
    paths["data"] = res = run_data("cuda")
    if res["launches"] != res["expected"]:
        raise AssertionError(f"data: cli.train --data-dir launched "
                             f"{res['launches']}, expected {res['expected']}")
    pixels = {k: (c, m, round(a, 4)) for k, (c, m, a) in
              res["pixels"].items()}
    rates = {t: round(r, 1) for t, r in res["images_per_s"].items()}
    log(f"data: cli.inspect_data over the converted shards wrote "
        f"{res['inspected']} PNGs, one an image id")
    log(f"data: decoder {res['decoder']}; pixels against libjpeg's (image: "
        f"chroma, max abs diff, mean; limits {PIXEL_TOL[res['decoder']]}): "
        f"{pixels}; resumed stream bitwise; {DATA_PHOTOS} photo-sized "
        f"JPEGs (500 x 375, 4:2:0, {res['photo_kb']:.1f} KB on average) "
        f"made and converted in {res['photos_s']:.1f} s; loader images/s "
        f"by worker threads on {res['cores']} cores ({res['rate_canvas']} "
        f"px canvases, batches of {BATCH}): {rates}; cli.train --data-dir "
        f"{DATA_STEPS} steps in {res['train_s']:.1f} s (wall_time_s "
        f"{res['wall_s']}), losses {[round(v, 4) for v in res['losses']]}"
        f", launches {res['launches']}; cli.evaluate --data-dir mAP "
        f"{res['mAP']:.4f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # learn: overfit 8 fixed images at the test's size and at full width,
    # then the short capstone: config 3 trained, scored exact, approx,
    # MaxpoolNMS and int8 on the same held-out batches
    paths.update(phase_learn())

    # the last tools: config 5's crash-and-resume rehearsal, the torchrun
    # path, the VOC pipeline rehearsal and config 1's parity record
    paths.update(phase_tools())

    # the measurement tools, each at its preset widths
    paths.update(phase_bench(smi))

    for k in kernels:
        by_path = {path: run["launches"][k["name"]]
                   for path, run in paths.items()
                   if k["name"] in run["launches"]}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        if k["name"] == "int8_dwconv":
            for key in ("dw_routes", "dw_modes"):
                k[f"launches_by_{key[3:-1]}"] = {
                    r: sum(run.get(key, {}).get(r, 0)
                           for run in paths.values())
                    for r in next(run[key] for run in paths.values()
                                  if key in run)}
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--counted-cli-train"]:
        sys.exit(counted_cli_train(sys.argv[2:]))
    sys.exit(main())
