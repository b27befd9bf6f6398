"""Dataset inspection CLI: read a few examples from a directory of TFRecord
shards (or the synthetic stream), draw their ground-truth boxes and write
annotated PNGs, the check that conversion and reading are right.

The port of ``x_detector_tpu/cli/inspect_data.py``. Example::

  python -m x_detector_tpu_torch.cli.inspect_data --data-dir SHARDS \\
      --num-images 4 --output-dir OUT

Shards are read through the native loader (``common.batch_iterator``: in
order, once); ``--device`` is where nvJPEG decodes, where the loader has
it (``cuda`` by default, as in the other CLIs; ``cpu`` when asked).
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

import numpy as np

from x_detector_tpu_torch.cli import common
from x_detector_tpu_torch.utils.draw import draw_detections


def main(argv: Optional[List[str]] = None) -> int:
    """Writes ``--num-images`` PNGs (``<image_id>.png``, or
    ``synthetic_<n>.png``) and returns how many."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_common_args(p)
    p.add_argument("--num-images", type=int, default=4)
    p.add_argument("--output-dir",
                   default=os.path.join(tempfile.gettempdir(),
                                        "xdet_inspect"))
    p.add_argument("--canvas", type=int, default=512)
    args = p.parse_args(argv)

    device = common.resolve_device(args)
    cfg = common.resolve_config(args)
    it = common.batch_iterator(args, cfg, training=False,
                               canvas_size=args.canvas,
                               cuda_device=common.cuda_index(device))
    os.makedirs(args.output_dir, exist_ok=True)

    from PIL import Image
    written = 0
    while written < args.num_images:
        batch = next(it)
        for i in range(batch["image"].shape[0]):
            if written >= args.num_images:
                break
            mask = np.asarray(batch["gt_mask"][i])
            boxes = np.asarray(batch["gt_boxes"][i])[mask]
            labels = np.asarray(batch["gt_labels"][i])[mask]
            vis = draw_detections(np.asarray(batch["image"][i]), boxes,
                                  np.ones(len(boxes)), labels,
                                  score_threshold=-1.0)
            if "image_id" in batch:
                image_id = batch["image_id"][i]
                name = (image_id.decode() if isinstance(image_id, bytes)
                        else str(image_id))
            else:
                name = f"synthetic_{written}"
            out = os.path.join(args.output_dir, f"{name}.png")
            Image.fromarray(vis).save(out)
            print(f"{out}: {len(boxes)} gt boxes, "
                  f"classes {sorted(set(labels.tolist()))}")
            written += 1
    print(f"wrote {written} annotated images to {args.output_dir}")
    return written


if __name__ == "__main__":
    main()
