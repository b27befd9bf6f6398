"""BASELINE config 1's judged surface: one 800 px image on the CPU.

The port of the JAX package's ``tools/bench_cpu_config1.py``. BASELINE
config 1 is CPU inference of Light-Head R-CNN + ResNet-50 (batch 1, 800
px). This times the function the JAX tool times, ``lighthead_postprocess(
model(x))`` on one uniform float image in [0, 255) (no
``preprocess_for_eval``), from seeded weights, in fp32 and bf16, on the CPU
only: one first call (its seconds stand where the JAX tool prints its
``compile_s``: the port compiles nothing, the first call pays the
allocator and the kernels' first use), then ``--iters`` timed calls; the
median and the sorted spread. On the CPU a call returns when its work is
done, so the host clock needs no fence.

The bf16 line times the port's CPU bf16 path: every bf16 conv there runs
through ``models.layers.rounded_conv``, an fp32 conv on the bf16-rounded
operands, rounded back (PyTorch's own CPU bf16 conv read uninitialised
memory on some shapes), so it is not a native bf16 conv's time.

Every line names the host's cores (``nproc``) and PyTorch's threads.

  python -m x_detector_tpu_torch.tools.bench_cpu_config1 [--iters 5] \\
      [--image-size 800] [--dtypes float32,bfloat16]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, List, Optional

import torch

from x_detector_tpu_torch.config import lighthead_resnet50
from x_detector_tpu_torch.inference import build_model
from x_detector_tpu_torch.models.lighthead import lighthead_postprocess
from x_detector_tpu_torch.tools.fast_nms_ab import emit
from x_detector_tpu_torch.utils.profiling import median_spread

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
IMAGE_SEED = 1


def detect_fn(cfg, model) -> Callable[[torch.Tensor], tuple]:
    """The timed function: images [B, S, S, 3] -> (boxes, scores, classes,
    valid) of ``lighthead_postprocess(model(images))``."""
    def detect(images: torch.Tensor):
        with torch.inference_mode():
            det = lighthead_postprocess(model(images), cfg.model)
        return det.boxes, det.scores, det.classes, det.valid
    return detect


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--image-size", type=int, default=800)
    p.add_argument("--dtypes", default="float32,bfloat16")
    args = p.parse_args(argv)
    cfg = lighthead_resnet50(image_size=args.image_size)
    size = cfg.model.image_size
    rows = []
    for name in args.dtypes.split(","):
        model = build_model(cfg.model, "cpu", seed=0, dtype=DTYPES[name])
        device = next(model.parameters()).device
        if device.type != "cpu":
            raise RuntimeError(f"config 1's surface is the CPU; the model "
                               f"is on {device}")
        detect = detect_fn(cfg, model)
        gen = torch.Generator().manual_seed(IMAGE_SEED)
        img = torch.rand((1, size, size, 3), generator=gen) * 255.0
        t0 = time.perf_counter()
        detect(img)
        first_s = time.perf_counter() - t0
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            detect(img)
            times.append((time.perf_counter() - t0) * 1e3)
        ms = median_spread(times)
        rows.append(emit({
            "metric": "config1_cpu_batch1_latency_ms",
            "preset": "lighthead_resnet50", "image_size": size,
            "dtype": name, "latency_ms": ms["median_ms"],
            "images_per_sec": 1e3 / ms["median_ms"],
            "spread_ms": ms["spread_ms"], "first_call_s": first_s,
            "host": f"nproc={os.cpu_count()}",
            "threads": torch.get_num_threads()}))
        del model
    return rows


if __name__ == "__main__":
    main()
