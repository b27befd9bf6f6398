"""Structured metrics logging: per-step JSON lines, stderr echoes and,
optionally, TensorBoard event files.

The port of ``x_detector_tpu/utils/logging.py``. Metric values may be
tensors on the card: they become floats only when a record is written,
which synchronises with the device, so a caller logs only at log steps.

The JAX package writes its events with TensorFlow's summary writer; the
port writes the same records itself (:class:`EventWriter`), since the
card's machine has no TensorFlow. An event file is a TFRecord file (masked
CRC32C on the length and on the data, ``data/tfrecord.frame_record``) of
``tensorflow.Event`` protobufs, encoded by hand:

  Event    wall_time (1, double) | step (2, int64) | file_version (3,
           "brain.Event:2", the first record) | summary (5)
  Summary  value (1): tag (1) | tensor (8) | metadata (9) -> plugin_data
           (1) -> plugin_name (1)
  scalar   plugin "scalars": a DT_FLOAT (1) tensor of shape [] whose
           tensor_content (4) holds the float32
  image    plugin "images": a DT_STRING (7) tensor of shape [3] whose
           string_val (8) are the width, the height and the PNG bytes

as ``tf.summary.scalar`` and ``tf.summary.image`` write them, so
TensorBoard reads them as the JAX package's. :func:`read_events` reads
them back, CRCs checked.
"""

from __future__ import annotations

import io
import json
import os
import socket
import struct
import sys
import time
from typing import Any, Dict, Iterator, List, Optional, TextIO

import numpy as np

# the package's hand protobuf encoder and TFRecord framing
from x_detector_tpu_torch.data.tfrecord import (_field, _fields, _varint,
                                                frame_record, read_records)

FILE_VERSION = "brain.Event:2"
DT_FLOAT, DT_STRING = 1, 7


def _summary_value(tag: str, plugin: str, tensor: bytes) -> bytes:
    metadata = _field(1, _field(1, plugin.encode()))
    return _field(1, _field(1, tag.encode()) + _field(8, tensor)
                  + _field(9, metadata))


def _scalar_tensor(value: float) -> bytes:
    return (_varint(1 << 3) + _varint(DT_FLOAT) + _field(2, b"")
            + _field(4, struct.pack("<f", value)))


def _image_tensor(image: np.ndarray) -> bytes:
    from PIL import Image
    png = io.BytesIO()
    Image.fromarray(image[..., 0] if image.shape[-1] == 1 else image
                    ).save(png, format="PNG")
    h, w = image.shape[:2]
    shape = _field(2, _field(2, _varint(1 << 3) + _varint(3)))
    return (_varint(1 << 3) + _varint(DT_STRING) + shape
            + b"".join(_field(8, v) for v in (str(w).encode(),
                                              str(h).encode(),
                                              png.getvalue())))


class EventWriter:
    """One TensorBoard event file in ``logdir``
    (``events.out.tfevents.<seconds>.<host>.<pid>.0.v2``), opened with the
    file-version record; each write is flushed."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(now)}.{socket.gethostname()}"
                    f".{os.getpid()}.0.v2")
        self._file = open(self.path, "wb")
        self._write(_field(3, FILE_VERSION.encode()), now)

    def _write(self, body: bytes, wall_time: Optional[float] = None,
               step: int = 0) -> None:
        wall = time.time() if wall_time is None else wall_time
        event = _varint(1 << 3 | 1) + struct.pack("<d", wall)
        if step:
            event += _varint(2 << 3) + _varint(step)
        self._file.write(frame_record(event + body))
        self._file.flush()

    def scalar(self, step: int, tag: str, value: float) -> None:
        """One event holding one scalar summary (as TensorFlow writes one
        event a ``tf.summary.scalar``)."""
        self._write(_field(5, _summary_value(tag, "scalars",
                                             _scalar_tensor(value))),
                    step=step)

    def image(self, step: int, tag: str, image: np.ndarray) -> None:
        """One event holding an image summary of ``image`` (HWC uint8, C
        1, 3 or 4)."""
        self._write(_field(5, _summary_value(tag, "images",
                                             _image_tensor(image))),
                    step=step)

    def close(self) -> None:
        self._file.close()


def _tensor_value(tensor: bytes):
    dtype, content, strings = None, b"", []
    for number, _, value in _fields(tensor):
        if number == 1:
            dtype = value
        elif number == 4:
            content = bytes(value)
        elif number == 8:
            strings.append(bytes(value))
    if dtype == DT_FLOAT:
        return struct.unpack("<f", content)[0]
    if dtype == DT_STRING:
        return strings
    raise ValueError(f"summary tensor of dtype {dtype}: not a scalar or an "
                     f"image")


def read_events(path: str) -> Iterator[Dict[str, Any]]:
    """The events of one file, CRCs checked (``tfrecord.read_records``):
    ``{"wall_time", "step", "file_version"}`` or ``{"wall_time", "step",
    "values": [(tag, plugin, value)]}``, a scalar's value a float, an
    image's ``[width, height, png]`` bytes."""
    for record in read_records(path):
        event: Dict[str, Any] = {"wall_time": 0.0, "step": 0}
        for number, _, value in _fields(record):
            if number == 1:
                event["wall_time"] = struct.unpack("<d", value)[0]
            elif number == 2:
                event["step"] = value
            elif number == 3:
                event["file_version"] = bytes(value).decode()
            elif number == 5:
                values: List = event.setdefault("values", [])
                for _, _, entry in _fields(value):
                    tag = plugin = tensor = None
                    for vnum, _, v in _fields(entry):
                        if vnum == 1:
                            tag = bytes(v).decode()
                        elif vnum == 8:
                            tensor = v
                        elif vnum == 9:
                            for _, _, data in _fields(v):
                                for pnum, _, name in _fields(data):
                                    if pnum == 1:
                                        plugin = bytes(name).decode()
                    values.append((tag, plugin, _tensor_value(tensor)))
        yield event


class MetricsLogger:
    """Appends one JSON object a record to ``path`` (a resumed run adds to
    the file) and echoes to stderr at steps that are multiples of
    ``echo_every``. With ``tensorboard_dir`` it also writes a TensorBoard
    event file there: every float of a record (the metrics and
    ``wall_time_s``) as a scalar, and :meth:`log_image`'s images."""

    def __init__(self, path: Optional[str] = None, echo: bool = True,
                 echo_every: int = 50,
                 tensorboard_dir: Optional[str] = None):
        self._file: Optional[TextIO] = open(path, "a") if path else None
        self._echo = echo
        self._echo_every = max(echo_every, 1)
        self._t0 = time.monotonic()
        self._tb = EventWriter(tensorboard_dir) if tensorboard_dir else None

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        rec = {"step": step,
               "wall_time_s": round(time.monotonic() - self._t0, 3)}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        if self._file is not None:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if isinstance(v, float) and k != "step":
                    self._tb.scalar(step, k, v)
        if self._echo and step % self._echo_every == 0:
            parts = " ".join(f"{k}={rec[k]:.4g}" if isinstance(rec[k], float)
                             else f"{k}={rec[k]}" for k in sorted(rec))
            print(f"[step {step}] {parts}", file=sys.stderr)

    def log_image(self, step: int, tag: str, image) -> None:
        """One HWC image summary, uint8 or clipped to [0, 255] and cast
        (nothing without ``tensorboard_dir``)."""
        if self._tb is None:
            return
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        self._tb.image(step, tag, img)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
        if self._tb is not None:
            self._tb.close()
