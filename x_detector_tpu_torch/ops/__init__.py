"""Geometry, NMS, matching and the hand kernels' wrappers. Importing the
package registers the kernels' operators (``ops/library.py``)."""

from x_detector_tpu_torch.ops import library  # noqa: F401
