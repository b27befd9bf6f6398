"""Offline VOC -> TFRecord converter CLI, with no TensorFlow.

The port of ``x_detector_tpu/cli/convert_voc.py``. Example::

  python -m x_detector_tpu_torch.cli.convert_voc --voc-root VOCdevkit \\
      --splits 2007:trainval 2012:trainval --output-dir records
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from x_detector_tpu_torch.data.tfrecord import convert_voc_to_tfrecords


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Writes the shards; returns their paths."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--voc-root", required=True,
                   help="VOCdevkit directory (contains VOC2007/, VOC2012/)")
    p.add_argument("--splits", nargs="+", default=["2007:trainval"],
                   help="year:split pairs, e.g. 2007:trainval 2007:test")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--shard-size", type=int, default=500)
    p.add_argument("--prefix", default="voc")
    args = p.parse_args(argv)
    years_splits = [tuple(s.split(":")) for s in args.splits]
    paths = convert_voc_to_tfrecords(args.voc_root, years_splits,
                                     args.output_dir,
                                     shard_size=args.shard_size,
                                     prefix=args.prefix)
    print(f"wrote {len(paths)} shards to {args.output_dir}")
    return paths


if __name__ == "__main__":
    main()
