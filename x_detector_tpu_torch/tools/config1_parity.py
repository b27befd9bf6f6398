"""Config 1's parity record: Light-Head R-CNN on ResNet-50, one 800 px
image, fp32 -- its detections as canonical JSON, and a diff against
another record.

The port of the JAX package's ``tools/config1_parity.py``. Given weights
(``--checkpoint-dir``: a model directory whose ``ckpt/`` the port's
``CheckpointManager`` restores; random init from seed 0 otherwise) and an
image (``--image``; the JAX tool's synthetic 600 x 800 image of
``default_rng(0)`` otherwise), it writes one record with the JAX tool's
keys and rounding (``config``, ``image``, ``boxes``, ``scores``,
``classes``; 5 decimals), the valid detections in the postprocess's order.
``--compare REF`` applies the JAX tool's rules: a count mismatch, then per
detection a box beyond ``--box-tol``, a score beyond ``--score-tol`` or
another class; ``PARITY OK`` exits 0, ``PARITY FAILED`` 1. It also prints
how far apart the two records' lowest kept scores are (the cut) and the
smallest gap between two kept scores.

On the card (the default) the fp32 convs and matmuls run with TF32 off
(``torch.backends.cudnn.allow_tf32`` and ``cuda.matmul.allow_tf32``
False): the record is full fp32 on either device. Random-init scores sit
near 1/21 and the 200-detection cap cuts through near-ties, so compare
records from trained weights (``cli.train --preset lighthead_resnet50``).

  python -m x_detector_tpu_torch.tools.config1_parity --image dog.jpg \\
      --checkpoint-dir DIR --out run.json
  python -m x_detector_tpu_torch.tools.config1_parity --device cpu \\
      --checkpoint-dir DIR --compare run.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from x_detector_tpu_torch.config import lighthead_resnet50
from x_detector_tpu_torch.data.augment import preprocess_for_eval
from x_detector_tpu_torch.inference import build_eval_fn
from x_detector_tpu_torch.train.checkpoint import CheckpointManager
from x_detector_tpu_torch.train.trainer import create_model_and_state

SYNTHETIC = "synthetic_seed0_600x800"


def synthetic_image() -> np.ndarray:
    """The JAX tool's default image: 600 x 800 RGB of default_rng(0)."""
    rng = np.random.default_rng(0)
    return rng.uniform(0, 255, (600, 800, 3)).astype(np.float32)


def fp32_exact(device: torch.device) -> str:
    """Turn TF32 off for fp32 convs and matmuls on a card; says which
    setting runs."""
    if device.type != "cuda":
        return "cpu: fp32"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda: fp32 with TF32 off (cudnn.allow_tf32 and matmul.allow_tf32)"


def config1_model(cfg, device, checkpoint_dir: Optional[str] = None):
    """Config ``cfg``'s model in fp32 on ``device``, eval mode: seed 0's
    weights, or the parameters and BatchNorm stats of the newest
    checkpoint under ``checkpoint_dir/ckpt`` (not an EMA shadow: the JAX
    tool reads ``state.params``)."""
    state = create_model_and_state(cfg, device, seed=0, dtype=torch.float32)
    if checkpoint_dir:
        state, _ = CheckpointManager(os.path.join(checkpoint_dir,
                                                  "ckpt")).restore(state)
        print(f"restored step {state.step}", file=sys.stderr)
    return state.model.eval()


def detection_record(model, cfg, image: np.ndarray, device,
                     image_name: str = SYNTHETIC,
                     config_name: Optional[str] = None) -> dict:
    """One image ([H, W, 3] float32 RGB) through ``preprocess_for_eval``,
    the model and ``lighthead_postprocess`` (``build_eval_fn``): the valid
    detections as the JAX tool's record, rounded to 5 decimals."""
    device = torch.device(device)
    detect = build_eval_fn(model, cfg, device)
    inp = preprocess_for_eval(torch.from_numpy(image).to(device),
                              cfg.data)[None]
    boxes, scores, classes, valid = (t[0].cpu().numpy()
                                     for t in detect(inp))
    return {
        "config": config_name or (f"{cfg.model.name}_"
                                  f"{cfg.model.image_size}px_{device.type}"),
        "image": image_name,
        "boxes": boxes[valid].round(5).tolist(),
        "scores": scores[valid].round(5).tolist(),
        "classes": classes[valid].tolist(),
    }


def compare(record: dict, ref: dict, box_tol: float = 0.01,
            score_tol: float = 0.02) -> bool:
    """The JAX tool's rules; prints each mismatch and the verdict."""
    ok = True
    if len(ref["scores"]) != len(record["scores"]):
        print(f"DETECTION COUNT MISMATCH: {len(record['scores'])} vs "
              f"{len(ref['scores'])}")
        ok = False
    n = min(len(ref["scores"]), len(record["scores"]))
    for i in range(n):
        db = np.abs(np.asarray(record["boxes"][i]) -
                    np.asarray(ref["boxes"][i])).max()
        ds = abs(record["scores"][i] - ref["scores"][i])
        if (db > box_tol or ds > score_tol or
                record["classes"][i] != ref["classes"][i]):
            print(f"det {i}: box_d={db:.4f} score_d={ds:.4f} "
                  f"cls {record['classes'][i]} vs {ref['classes'][i]}")
            ok = False
    if n:
        low, ref_low = min(record["scores"]), min(ref["scores"])
        gaps = np.diff(np.sort(record["scores"]))
        print(f"lowest kept score (the cut): {low:.5f} vs {ref_low:.5f}, "
              f"apart {abs(low - ref_low):.2e}; the smallest gap between "
              f"two kept scores {gaps.min() if gaps.size else 0.0:.2e}")
    print("PARITY OK" if ok else "PARITY FAILED")
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--image", help="input image; synthetic if omitted")
    p.add_argument("--checkpoint-dir", default=None,
                   help="model dir with ckpt/ (random init if omitted)")
    p.add_argument("--out", default="config1_outputs.json")
    p.add_argument("--compare", default=None,
                   help="reference JSON to diff against")
    p.add_argument("--box-tol", type=float, default=0.01)
    p.add_argument("--score-tol", type=float, default=0.02)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is present "
                         "(pass --device cpu to run on the CPU)")
    print(fp32_exact(device), file=sys.stderr)
    cfg = lighthead_resnet50(image_size=800)
    model = config1_model(cfg, device, args.checkpoint_dir)
    if args.image:
        from PIL import Image
        img = np.asarray(Image.open(args.image).convert("RGB"), np.float32)
    else:
        img = synthetic_image()
    record = detection_record(model, cfg, img, device,
                              args.image or SYNTHETIC)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {len(record['scores'])} detections -> {args.out}")

    if args.compare:
        with open(args.compare) as f:
            ref = json.load(f)
        return 0 if compare(record, ref, args.box_tol, args.score_tol) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
