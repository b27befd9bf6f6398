"""The real-data pipeline rehearsed end to end on a generated VOCdevkit.

The port of the JAX package's ``tools/rehearse_voc_pipeline.py``: every
CLI a VOC user touches, chained as subprocesses, each stage a fresh
process:

  1. generate   a VOCdevkit of photo-sized JPEGs (500 x 375, 4:2:0;
                ``data/testdata/make_voc_mini.write_voc_tree``)
  2. convert    ``cli.convert_voc`` -> TFRecord shards
  3. train      ``cli.train --data-dir`` (the native loader), a checkpoint
                every 2 steps, a periodic eval at the last step
  4. resume     ``cli.train --resume`` for 2 more steps
  5. evaluate   ``cli.evaluate`` (prints ``mAP:``)
  6. predict    ``cli.predict`` on one of the JPEGs
  7. export     ``cli.export`` of a raw-RGB letterbox program of batch 1
                (``--fused-sepconv``: B2 in the backbone)
  8. reload     the program loaded in a fresh process that imports no
                model code (``serving.load``; the ``xdt`` operators
                registered by ``serving``'s import) and run on a zero image

It exits non-zero at the first broken stage, naming it. Each stage prints
its last lines and its seconds; the reload prints its kernels' launch
counts (``ops.library.launch_line``).

The shape flags ``--preset``, ``--image-size``, ``--batch-size``,
``--backbone-stages``, ``--backbone-widths`` and ``--device`` go to every
CLI (the defaults are the JAX tool's: ``ssd_resnet50``, 64 px, batch 2);
the CLIs train, evaluate and export in their default dtype (bf16).

  python -m x_detector_tpu_torch.tools.rehearse_voc_pipeline \\
      --device cpu --backbone-stages 1,1,1,1 --backbone-widths 8,16,24,32
  python -m x_detector_tpu_torch.tools.rehearse_voc_pipeline \\
      --preset lighthead_xception --image-size 800 --fused-sepconv
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

from x_detector_tpu_torch.tools import REPO, repo_env

TAIL_LINES = 4


class StageFailed(RuntimeError):
    """A stage of the pipeline exited non-zero or broke a check."""


def run(desc: str, argv: List[str]) -> str:
    """``python -m argv`` in a fresh process; prints its last lines and
    seconds and returns its output. Raises StageFailed naming ``desc``
    when it exits non-zero."""
    print(f"--- {desc}: {' '.join(argv)}", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m"] + argv, cwd=REPO,
                          env=repo_env(), capture_output=True, text=True)
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-TAIL_LINES:]
    print("\n".join(tail), flush=True)
    if proc.returncode != 0:
        raise StageFailed(desc)
    print(f"--- {desc} passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return proc.stdout


def check(desc: str, ok: bool, what: str) -> None:
    if not ok:
        print(what, flush=True)
        raise StageFailed(desc)


def reload_and_run(path: str, device: str, image_size: int) -> None:
    """Stage 8's process: ``serving.load`` the program, run it on one zero
    image with box_scale 1 on ``device``, and check the outputs' shapes;
    no model module may be imported."""
    import torch

    from x_detector_tpu_torch import serving
    from x_detector_tpu_torch.ops.library import launch_line
    program = serving.load(path)
    img = torch.zeros(1, image_size, image_size, 3, device=device)
    scale = torch.ones(1, 2, device=device)
    boxes, scores, classes, valid = program(img, scale)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    models = sorted(m for m in sys.modules
                    if m.startswith("x_detector_tpu_torch.models"))
    if boxes.shape[0] != 1 or boxes.shape[2] != 4 or models:
        raise SystemExit(f"reload: boxes {tuple(boxes.shape)}, model "
                         f"modules imported {models}")
    print(f"artifact reload OK: boxes {tuple(boxes.shape)}, "
          f"{int(valid.sum())} valid, no model code imported")
    print(launch_line(), flush=True)


def pipeline(args) -> str:
    """Stages 1-8 in ``args.workdir`` (a temporary directory if None);
    returns the work directory. Raises StageFailed at the first broken
    stage."""
    work = args.workdir or tempfile.mkdtemp(prefix="voc_rehearsal_")
    os.makedirs(work, exist_ok=True)
    voc = os.path.join(work, "VOCdevkit")
    t0 = time.perf_counter()
    print(f"--- generate: {args.images} photo-sized JPEGs", flush=True)
    try:
        from x_detector_tpu_torch.data.testdata.make_voc_mini import (
            write_voc_tree)
        write_voc_tree(voc, args.images)
    except Exception as e:      # PIL missing, a directory not writable
        print(f"{type(e).__name__}: {e}", flush=True)
        raise StageFailed("generate") from e
    print(f"generated VOCdevkit with {args.images} images -> {work}")
    print(f"--- generate passed in {time.perf_counter() - t0:.1f} s",
          flush=True)

    rec = os.path.join(work, "records")
    run("convert", ["x_detector_tpu_torch.cli.convert_voc",
                    "--voc-root", voc, "--splits", "2007:trainval",
                    "--output-dir", rec])
    check("convert", bool(glob.glob(f"{rec}/*.tfrecord")),
          "no records written")

    model_dir = os.path.join(work, "model")
    shape = ["--preset", args.preset, "--image-size", str(args.image_size),
             "--batch-size", str(args.batch_size), "--device", args.device]
    for flag in ("backbone_stages", "backbone_widths"):
        if getattr(args, flag):
            shape += ["--" + flag.replace("_", "-"), getattr(args, flag)]
    common = [*shape, "--data-dir", rec, "--model-dir", model_dir]
    run("train", ["x_detector_tpu_torch.cli.train", *common,
                  "--steps", str(args.steps), "--checkpoint-every", "2",
                  "--log-every", "2", "--eval-every", str(args.steps),
                  "--eval-batches", "2"])
    out = run("resume", ["x_detector_tpu_torch.cli.train", *common,
                         "--steps", str(args.steps + 2),
                         "--checkpoint-every", "2", "--log-every", "2",
                         "--resume"])
    check("resume", f"resumed from step {args.steps}" in out,
          f"resume did not continue from step {args.steps}")
    out = run("evaluate", ["x_detector_tpu_torch.cli.evaluate", *common,
                           "--num-batches", "3"])
    check("evaluate", "mAP:" in out, "evaluate printed no mAP")

    jpg = sorted(glob.glob(os.path.join(voc, "VOC2007", "JPEGImages",
                                        "*.jpg")))[0]
    png = os.path.join(work, "pred.png")
    run("predict", ["x_detector_tpu_torch.cli.predict", *common,
                    "--input", jpg, "--output", png,
                    "--score-threshold", "0.0"])
    check("predict", os.path.exists(png), "predict wrote no PNG")

    artifact = os.path.join(work, "det.pt2")
    run("export", ["x_detector_tpu_torch.cli.export", *common,
                   "--output", artifact, "--batch", "1", "--raw-rgb",
                   "--letterbox"]
        + (["--fused-sepconv"] if args.fused_sepconv else []))
    run("reload", ["x_detector_tpu_torch.tools.rehearse_voc_pipeline",
                   "--reload", artifact, "--device", args.device,
                   "--image-size", str(args.image_size)])
    print(f"REHEARSAL PASSED ({work})", flush=True)
    return work


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", default=None)
    p.add_argument("--images", type=int, default=12)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--preset", default="ssd_resnet50")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--backbone-stages", default=None)
    p.add_argument("--backbone-widths", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fused-sepconv", action="store_true",
                   help="export with the backbone on kernel B2")
    p.add_argument("--reload", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.reload:
        reload_and_run(args.reload, args.device, args.image_size)
        return 0
    try:
        pipeline(args)
    except StageFailed as e:
        print(f"FAILED at stage: {e}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
