"""Preprocessing throughput (BASELINE's metric: preprocessing images/s per
host), the input pipeline's two halves apart.

The port of the JAX package's ``tools/bench_preproc.py``:

  1. host: the native loader (``data/native_loader.NativeLoader``: record
     read and CRC, JPEG decode (nvJPEG on the card's machine, libjpeg
     elsewhere), resize onto the canvas) over ``--images`` generated
     records, with ``--threads`` workers (at most one a core): images/s
     over ``--iters`` batches after one;
  2. device: the augmentation (``preprocess_batch_for_train``: crop sample,
     crop and resize, colour jitter, flip, whitening) on 3 batches of
     uniform [0, 255) canvases staged on the card, ROUNDS rounds of
     ``--iters`` calls fenced by a synchronize (``DeviceTimer``): images/s
     at the median round, and the rounds' spread.

The records are a generated VOCdevkit (``data/testdata/make_voc_mini.
write_voc_tree``: photo-like 500 x 375 4:2:0 JPEGs, as VOC's photos are;
the JAX tool decoded 60-120 px noise images) converted by the port's
writer (``data.tfrecord.convert_voc_to_tfrecords``), as
``tools/rehearse_voc_pipeline.py`` makes them. Needs PIL to write them.

  python -m x_detector_tpu_torch.tools.bench_preproc [--batch 64] \\
      [--canvas 640]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List, Optional

import torch

from x_detector_tpu_torch.cli import common
from x_detector_tpu_torch.config import DataConfig
from x_detector_tpu_torch.data.augment import preprocess_batch_for_train
from x_detector_tpu_torch.tools import add_device_args
from x_detector_tpu_torch.tools.bench_detect import timed_rounds
from x_detector_tpu_torch.tools.fast_nms_ab import emit, resolve_harness
from x_detector_tpu_torch.utils.profiling import median_spread

MAX_GT, SHARD_SIZE, DEVICE_BATCHES, ROUNDS = 100, 16, 3, 3
# --smoke: (images, batch, canvas, out size, iters), 1 round
SMOKE = (4, 2, 96, 64, 2)


def host_rate(images: int, canvas: int, batch: int, iters: int,
              threads: int, cuda_device: int) -> float:
    """The native loader's images/s over ``images`` generated records."""
    from x_detector_tpu_torch.data import tfrecord
    from x_detector_tpu_torch.data.native_loader import NativeLoader
    from x_detector_tpu_torch.data.testdata.make_voc_mini import (
        write_voc_tree)
    with tempfile.TemporaryDirectory() as tmp:
        write_voc_tree(tmp, images)
        paths = tfrecord.convert_voc_to_tfrecords(
            tmp, [("2007", "trainval")], os.path.join(tmp, "rec"),
            shard_size=SHARD_SIZE)
        loader = NativeLoader(paths, canvas_size=canvas, max_gt=MAX_GT,
                              batch_size=batch, shuffle=True, repeat=True,
                              num_threads=threads, cuda_device=cuda_device)
        try:
            next(loader)
            t0 = time.perf_counter()
            n = sum(next(loader)["image"].shape[0] for _ in range(iters))
            return n / (time.perf_counter() - t0)
        finally:
            loader.close()


def device_batches(batch: int, canvas: int, device) -> List[dict]:
    """DEVICE_BATCHES raw batches on ``device``: seeded uniform canvases,
    one ground-truth box each."""
    gen = torch.Generator(device=device).manual_seed(0)
    boxes = torch.zeros(batch, MAX_GT, 4, device=device)
    boxes[:, 0] = torch.tensor([0.2, 0.2, 0.7, 0.7], device=device)
    labels = torch.zeros(batch, MAX_GT, dtype=torch.int32, device=device)
    labels[:, 0] = 1
    return [{"image": torch.rand((batch, canvas, canvas, 3), generator=gen,
                                 device=device) * 255.0,
             "gt_boxes": boxes, "gt_labels": labels, "gt_mask": labels > 0}
            for _ in range(DEVICE_BATCHES)]


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--canvas", type=int, default=640)
    p.add_argument("--out-size", type=int, default=512)
    p.add_argument("--images", type=int, default=64)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--threads", type=int, default=8)
    add_device_args(p)
    args = p.parse_args(argv)
    if args.smoke:
        (args.images, args.batch, args.canvas, args.out_size,
         args.iters) = SMOKE
    device, _, label = resolve_harness(args)
    cuda_device = common.cuda_index(device)
    threads = max(1, min(args.threads, os.cpu_count() or 1))
    rows = [emit({
        "stage": "host loader", "canvas": args.canvas, "threads": threads,
        "cores": os.cpu_count(),
        "imgs_per_sec_per_host": host_rate(args.images, args.canvas,
                                           args.batch, args.iters, threads,
                                           cuda_device),
        "device": label})]
    cfg = DataConfig(image_size=args.out_size, max_gt_boxes=MAX_GT)
    gen = torch.Generator(device=device).manual_seed(1)
    raws = [(r,) for r in device_batches(args.batch, args.canvas, device)]
    ms = median_spread(timed_rounds(
        lambda raw: preprocess_batch_for_train(gen, raw, cfg),
        [raws[i % len(raws)] for i in range(args.iters)],
        1 if args.smoke else ROUNDS))
    rows.append(emit({
        "stage": "device augmentation", "canvas": args.canvas,
        "out_size": args.out_size, "batch": args.batch,
        "imgs_per_sec": args.batch / ms["median_ms"] * 1e3,
        "batch_ms": ms["median_ms"], "spread_ms": ms["spread_ms"],
        "device": label}))
    return rows


if __name__ == "__main__":
    main()
