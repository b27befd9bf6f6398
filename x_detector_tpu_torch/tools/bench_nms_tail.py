"""Config 2's postprocess tail alone (decode, per-class NMS or MaxpoolNMS,
the global top-k) on realistic random logits, on one card.

The port of the JAX package's ``tools/bench_nms_tail.py``: ``ssd_resnet50``
at batch 8 and 512 px, its anchors, softmax of N(0, 2) logits with the
background raised by 5 (most anchors fall below the 0.01 score floor, a
few hundred an image survive: the regime NMS sees after training) and
N(0, 0.3) box codes, ITERS distinct batches staged on the card in bf16.
Each variant runs ``models.detector.postprocess_detections`` over them in
ROUNDS rounds fenced by a synchronize (``DeviceTimer``): ms a batch
at the median round, the rounds' spread, and the tail's images/s.

  exact           the preset's ``batched_multiclass_nms`` path
  maxpool         MaxpoolNMS (``nms.fast_mode``: local maxima per level,
                  one global top-k)
  exact+approx,   the JAX tool's variants with ``lax.approx_max_k`` for the
  maxpool+approx  two sorts. The port takes an exact stable top-k for
                  ``approx_prefilter`` (a decision of the port: XLA lowers
                  ``approx_max_k`` to an exact top-k on every backend but
                  the TPU), so these rows run the exact top-k, are bitwise
                  the rows above, and say so.

  python -m x_detector_tpu_torch.tools.bench_nms_tail [--batch 8] \\
      [--image-size 512]
"""

from __future__ import annotations

import argparse
import functools
from typing import Callable, Dict, List, Optional

import torch

from x_detector_tpu_torch.config import ssd_resnet50
from x_detector_tpu_torch.models.detector import postprocess_detections
from x_detector_tpu_torch.models.ssd import build_ssd_anchors
from x_detector_tpu_torch.tools import add_device_args
from x_detector_tpu_torch.tools.bench_detect import timed_rounds
from x_detector_tpu_torch.tools.fast_nms_ab import (emit, resolve_harness,
                                                    smoke_shrink)
from x_detector_tpu_torch.utils.profiling import median_spread

ITERS, SMOKE_ITERS = 8, 2
ROUNDS = 3                         # --smoke: 1
APPROX = ("the exact stable top-k: the port runs approx_prefilter as an "
          "exact top-k (lax.approx_max_k is TPU-only; XLA lowers it to an "
          "exact top-k elsewhere), so this row is the one without +approx")


def variants(cfg, anchors: torch.Tensor) -> Dict[str, Callable]:
    """Each variant's tail: (box codes [B, N, 4], logits [B, N, C]) ->
    ``MulticlassNMSResult``."""
    ncfg = cfg.model.nms
    exact = functools.partial(
        postprocess_detections, anchors=anchors,
        max_output=ncfg.max_output, iou_threshold=ncfg.iou_threshold,
        score_threshold=ncfg.score_threshold)
    maxpool = functools.partial(exact, fast_mode=True,
                                ssd_anchor_cfg=cfg.model.ssd_anchors,
                                image_size=cfg.model.image_size)
    return {"exact": exact, "maxpool": maxpool,
            "exact+approx": functools.partial(exact, approx_prefilter=True),
            "maxpool+approx": functools.partial(maxpool,
                                                approx_prefilter=True)}


def tail_batches(n: int, batch: int, anchors: int, classes: int, device,
                 seed: int = 0) -> List[tuple]:
    """``n`` (codes, logits) pairs of the tail's statistics, bf16, made
    on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(n):
        logits = torch.randn((batch, anchors, classes), generator=gen,
                             device=device) * 2.0
        logits[..., 0] += 5.0
        codes = torch.randn((batch, anchors, 4), generator=gen,
                            device=device) * 0.3
        out.append((codes.to(torch.bfloat16), logits.to(torch.bfloat16)))
    return out


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--image-size", type=int, default=512)
    add_device_args(p)
    args = p.parse_args(argv)
    device, _, label = resolve_harness(args)
    cfg = ssd_resnet50(image_size=args.image_size)
    if args.smoke:
        cfg = smoke_shrink(cfg, "ssd")
    batch = cfg.train.batch_size if args.smoke else args.batch
    anchors = torch.from_numpy(build_ssd_anchors(cfg.model)).to(device)
    n, c = anchors.shape[0], cfg.model.num_classes
    staged = tail_batches(SMOKE_ITERS if args.smoke else ITERS, batch, n, c,
                          device)
    rows = []
    for name, fn in variants(cfg, anchors).items():
        ms = median_spread(timed_rounds(fn, staged,
                                        1 if args.smoke else ROUNDS))
        rows.append(emit({
            "variant": name, "batch": batch,
            "image_size": cfg.model.image_size, "anchors": n, "classes": c,
            "ms_per_batch": ms["median_ms"], "spread_ms": ms["spread_ms"],
            "images_per_sec_tail_only": batch / ms["median_ms"] * 1e3,
            **({"top_k": APPROX} if name.endswith("+approx") else {}),
            "device": label}))
    return rows


if __name__ == "__main__":
    main()
