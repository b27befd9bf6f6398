"""Predict CLI: one image in, an annotated image out.

The port of ``x_detector_tpu/cli/predict.py``. Example (on the card)::

  python -m x_detector_tpu_torch.cli.predict --preset lighthead_xception \\
      --model-dir DIR --input dog.jpg --output out.png

With ``--artifact DIR`` the detections come from an exported container
(``cli/export.py --container --raw-rgb``) instead of a live checkpoint: the
container describes its input (size, letterbox geometry, quantization) in
its ``meta.json``, so no preset or model code runs, as in a serving
process::

  python -m x_detector_tpu_torch.cli.predict --artifact CONTAINER \\
      --input dog.jpg --output out.png
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from x_detector_tpu_torch import serving
from x_detector_tpu_torch.cli import common
from x_detector_tpu_torch.utils.draw import draw_detections


def parse_args(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_common_args(p)
    p.add_argument("--input", required=True, help="input image (jpg/png)")
    p.add_argument("--output", default="detections.png")
    p.add_argument("--score-threshold", type=float, default=0.3)
    p.add_argument("--dtype", default="bfloat16",
                   choices=sorted(common.DTYPES))
    p.add_argument("--artifact", default=None,
                   help="container directory (export --container --raw-rgb)"
                        ": detect with it instead of a checkpoint; no model "
                        "code runs and the preset is ignored")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    """Returns row 0's (boxes, scores, classes, valid) as numpy arrays."""
    args = parse_args(argv)
    from PIL import Image
    pil = Image.open(args.input).convert("RGB")
    img = np.asarray(pil, np.float32)
    if args.artifact:
        det = detect_from_artifact(args.artifact, pil, args.device)
    else:
        det = detect_from_checkpoint(args, img)
    emit(args, img, *det)
    return det


def detect_from_checkpoint(args, img: np.ndarray):
    """Detections of one image by the preset's model, restored from
    ``--model-dir``: letterboxed as the data pipelines place it (with a
    letterbox preset), detected, the boxes unscaled to the image."""
    import torch

    from x_detector_tpu_torch.data.augment import preprocess_for_eval
    from x_detector_tpu_torch.inference import build_eval_fn, unscale_boxes
    cfg = common.resolve_config(args)
    device = common.resolve_device(args)
    box_scale = np.ones(2, np.float32)
    if cfg.data.letterbox:
        img, box_scale = serving.letterbox_image(img, cfg.model.image_size)
    model = common.restored_model(args, cfg, device,
                                  common.DTYPES[args.dtype], "predicting with")
    detect = build_eval_fn(model, cfg, device)
    images = torch.from_numpy(img)[None].to(device)
    boxes, scores, classes, valid = detect(preprocess_for_eval(images,
                                                               cfg.data))
    boxes = unscale_boxes(boxes, torch.from_numpy(box_scale)[None].to(device))
    return tuple(t[0].cpu().numpy() for t in (boxes, scores, classes, valid))


def detect_from_artifact(directory: str, pil, device: str):
    """Detections of one PIL image by a raw-RGB container on ``device``,
    padded to its smallest bucket: the path a serving process runs, with
    no preset or model code."""
    cont = serving.load_container(directory, device)
    if not cont.meta.get("raw_rgb"):
        raise SystemExit(
            "--artifact needs a container exported with --raw-rgb (raw "
            "[0,255] RGB inputs, the preprocessing inside); this one takes "
            "whitened inputs: export again with --raw-rgb, or use "
            "--model-dir for the live-checkpoint path")
    size = int(cont.meta["image_size"])
    img = np.asarray(pil, np.float32)
    if cont.meta.get("letterbox"):
        canvas, scale, _ = serving.bucketed_letterbox_batch(
            [img], size, cont.buckets)
        out = cont.detect(canvas, scale)    # boxes unscaled in the graph
    else:
        from PIL import Image
        resized = np.asarray(pil.resize((size, size), Image.BILINEAR),
                             np.float32)
        batch = np.zeros((serving.pick_bucket(1, cont.buckets), size, size,
                          3), np.float32)
        batch[0] = resized
        out = cont.detect(batch)
    return tuple(t[0].cpu().numpy() for t in out)


def emit(args, img: np.ndarray, boxes, scores, classes, valid) -> None:
    """Print one image's detections at or above the threshold and draw
    them into ``--output``."""
    keep = valid & (scores >= args.score_threshold)
    print(f"{int(keep.sum())} detections >= {args.score_threshold}")
    for b, s, c in zip(boxes[keep], scores[keep], classes[keep]):
        print(f"  class {int(c):2d} score {s:.3f} box {np.round(b, 3)}")
    from PIL import Image
    Image.fromarray(draw_detections(
        img, boxes, scores, classes, valid,
        score_threshold=args.score_threshold)).save(args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
