"""Structured metrics logging: per-step JSON lines and stderr echoes.

The port of ``x_detector_tpu/utils/logging.py``. Metric values may be
tensors on the card: they become floats only when a record is written,
which synchronises with the device, so a caller logs only at log steps.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional, TextIO


class MetricsLogger:
    """Appends one JSON object a record to ``path`` (a resumed run adds to
    the file) and echoes to stderr at steps that are multiples of
    ``echo_every``. TensorBoard event files are not written:
    ``tensorboard_dir`` raises, since the card's machine has no TensorFlow
    to write them with."""

    def __init__(self, path: Optional[str] = None, echo: bool = True,
                 echo_every: int = 50,
                 tensorboard_dir: Optional[str] = None):
        if tensorboard_dir:
            raise NotImplementedError(
                "TensorBoard event files: the port writes metrics.jsonl "
                "only (no TensorFlow to write events with)")
        self._file: Optional[TextIO] = open(path, "a") if path else None
        self._echo = echo
        self._echo_every = max(echo_every, 1)
        self._t0 = time.monotonic()

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        rec = {"step": step,
               "wall_time_s": round(time.monotonic() - self._t0, 3)}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        if self._file is not None:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if self._echo and step % self._echo_every == 0:
            parts = " ".join(f"{k}={rec[k]:.4g}" if isinstance(rec[k], float)
                             else f"{k}={rec[k]}" for k in sorted(rec))
            print(f"[step {step}] {parts}", file=sys.stderr)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
