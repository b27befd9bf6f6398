"""Serving-side helpers: load exported programs and containers, letterbox
client inputs.

The port of ``x_detector_tpu/serving.py``. The export CLI
(``cli/export.py``) freezes the images -> (boxes, scores, classes, valid)
pipeline into ``torch.export`` programs. This module is the consumer half
and imports no model code: a serving process needs torch, numpy and PIL,
and the port's operators. It imports ``ops.library`` because an exported
graph holds the hand kernels as ``xdt::*`` operator nodes (B1, B2 and the
int8 kernels, each launched through its operator on the card), and
``torch.export.load`` can rebuild a graph only from registered
operators::

    from x_detector_tpu_torch import serving
    cont = serving.load_container("/path/container")     # on its device
    canvas, box_scale, n = serving.bucketed_letterbox_batch(
        list_of_rgb_arrays, cont.meta["image_size"], cont.buckets)
    boxes, scores, classes, valid = cont.detect(canvas, box_scale)

An exported graph is pinned to the device type it was traced on (its
tensor-metadata asserts name the device), so a container records its
``device`` and serves only there. ``letterbox_batch`` reproduces the data
pipeline's placement (uniform scale, top-left, half-up rounding), so a
letterbox program returns boxes in the original images' normalized
coordinates.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from x_detector_tpu_torch.ops import library  # noqa: F401  (xdt::* ops)

META = "meta.json"
WEIGHTS = "weights.pt"


def graph_file(batch: int) -> str:
    return f"graph-b{batch}.pt2"


def load(path: str) -> torch.nn.Module:
    """An exported program (``torch.export.save``) as a callable module:
    ``load(path)(*inputs) -> (boxes, scores, classes, valid)``."""
    return torch.export.load(path).module()


# ---------------------------------------------------------------------------
# Shared-weights container
#
#   container/
#     meta.json        {"buckets": [...], "baked": [...], "device": ..., ...}
#     weights.pt       torch.save of the tensors the shared graphs read
#     graph-b{B}.pt2   torch.export program of batch B: a shared bucket takes
#                      (weights, images[, box_scale]) and holds no weights,
#                      a baked one takes (images[, box_scale]) and holds them
#
# The weights are stored once, however many shared buckets read them; a
# baked bucket holds its own copy (JAX measured its weights-as-inputs graphs
# at 0.60x of baked ones at batch 1 on the TPU, whence the option).
# ---------------------------------------------------------------------------

def save_container(directory: str, weights: Dict[str, torch.Tensor],
                   graphs: dict, meta: dict, baked=()) -> None:
    """Write the container: ``graphs`` maps batch -> ExportedProgram;
    buckets in ``baked`` hold their weights, every other graph takes
    ``weights`` (the tensors it reads, by name) as its first input."""
    if not graphs:
        # a container with no graphs cannot serve anything: refuse it when
        # it is written, not at its first detect()
        raise ValueError("save_container called with no graphs: a container "
                         "needs at least one bucket")
    os.makedirs(directory, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in weights.items()},
               os.path.join(directory, WEIGHTS))
    for batch, program in graphs.items():
        torch.export.save(program, os.path.join(directory,
                                                graph_file(batch)))
    with open(os.path.join(directory, META), "w") as f:
        json.dump(dict(meta, buckets=sorted(graphs), baked=sorted(baked)), f)


class DetectorContainer:
    """A reloaded container on its device: the weights loaded once, onto
    the device, and one program per bucket. ``detect(images[, box_scale])``
    dispatches on the batch, which must equal a bucket (the programs'
    shapes are static): pad requests to a bucket first, e.g. with
    :func:`bucketed_letterbox_batch`. Inputs may be numpy arrays or
    tensors; the outputs are tensors on the device."""

    def __init__(self, directory: str, device: Optional[str] = None):
        with open(os.path.join(directory, META)) as f:
            self.meta = json.load(f)
        traced = self.meta["device"]
        self.device = torch.device(device or traced)
        if self.device.type != torch.device(traced).type:
            raise ValueError(f"{directory}: its graphs were traced on "
                             f"{traced} and are pinned to it; asked to serve "
                             f"on {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{directory} serves on {traced}, and no CUDA "
                               f"device is present")
        self.buckets = self.meta["buckets"]
        self.baked = set(self.meta.get("baked", []))
        self.weights = None
        if not set(self.buckets) <= self.baked:
            # read by every request: load them onto the device once
            self.weights = torch.load(os.path.join(directory, WEIGHTS),
                                      map_location=self.device,
                                      weights_only=True)
        self._programs = {b: load(os.path.join(directory, graph_file(b)))
                          for b in self.buckets}

    def detect(self, images, *extra):
        b = images.shape[0]
        if b not in self._programs:
            raise ValueError(f"no graph for batch {b}; buckets "
                             f"{self.buckets} (pad via "
                             "bucketed_letterbox_batch first)")
        inputs = [torch.as_tensor(x, device=self.device)
                  for x in (images, *extra)]
        with torch.inference_mode():
            if b in self.baked:
                return self._programs[b](*inputs)
            return self._programs[b](self.weights, *inputs)


def load_container(directory: str, device: Optional[str] = None
                   ) -> DetectorContainer:
    return DetectorContainer(directory, device)


def letterbox_image(image: np.ndarray, size: int) -> Tuple[np.ndarray,
                                                           np.ndarray]:
    """[H, W, 3] uint8/float RGB -> ([size, size, 3] float32 canvas,
    [2] float32 box_scale = [fy, fx])."""
    from PIL import Image
    arr = np.asarray(image)
    h0, w0 = arr.shape[:2]
    s = size / max(h0, w0)
    # half-up rounding and bilinear: the data pipelines' placement and
    # pixels (native loader, cli.predict)
    h1 = max(1, min(size, int(h0 * s + 0.5)))
    w1 = max(1, min(size, int(w0 * s + 0.5)))
    pil = Image.fromarray(arr.astype(np.uint8))
    resized = np.asarray(pil.resize((w1, h1), Image.BILINEAR), np.float32)
    canvas = np.zeros((size, size, 3), np.float32)
    canvas[:h1, :w1] = resized
    return canvas, np.array([h1 / size, w1 / size], np.float32)


def letterbox_batch(images: Sequence[np.ndarray], size: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """List of RGB arrays -> ([B, size, size, 3], [B, 2]) program inputs."""
    canvases: List[np.ndarray] = []
    scales: List[np.ndarray] = []
    for im in images:
        c, s = letterbox_image(im, size)
        canvases.append(c)
        scales.append(s)
    return np.stack(canvases), np.stack(scales)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest exported batch that fits ``n`` requests; the largest if
    none does (the caller splits the burst)."""
    fitting = [b for b in buckets if b >= n]
    return min(fitting) if fitting else max(buckets)


def bucketed_letterbox_batch(
        images: Sequence[np.ndarray], size: int,
        buckets: Sequence[int]) -> Tuple[np.ndarray, np.ndarray, int]:
    """Letterbox a request burst and zero-pad it to its bucket's batch.

    Returns ``(canvas [B, size, size, 3], box_scale [B, 2], n_real)`` with
    ``B = pick_bucket(len(images), buckets)``; rows >= ``n_real`` are zero
    canvases (box_scale 1) whose detections the caller discards. A burst
    larger than every bucket raises: split it first.
    """
    n = len(images)
    b = pick_bucket(n, buckets)
    if n > b:
        raise ValueError(f"burst of {n} exceeds largest bucket {b}: "
                         "split the request first")
    canvas, scale = letterbox_batch(images, size)
    if n < b:
        canvas = np.concatenate(
            [canvas, np.zeros((b - n, size, size, 3), np.float32)])
        scale = np.concatenate([scale, np.ones((b - n, 2), np.float32)])
    return canvas, scale, n
