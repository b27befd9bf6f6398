"""Checkpoints of a TrainState, with the data position, that resume.

The port of ``x_detector_tpu/train/checkpoint.py``. A checkpoint is one
file ``ckpt-{step}.pt`` written with ``torch.save`` and read with
``torch.load(weights_only=True)``. It holds:

  step        the update count
  model       ``model.state_dict()``: parameters and BatchNorm running stats
              (the anchor grids are non-persistent buffers, rebuilt from the
              config, so a checkpoint loads into a model of another image
              size)
  optimizer   ``optimizer.state_dict()``: SGD's momentum buffers
  ema         the EMA shadow by parameter name, or None
  data_state  ``{"position": int}``, the batches the run consumed

beside a ``meta-{step}.json`` sidecar ``{"has_ema": bool}`` that tools can
read without loading the tensors. Tensors are named by the port's module
names, which follow flax's; this is not an Orbax checkpoint and the JAX
package's checkpoints are not read.
"""

from __future__ import annotations

import json
import os
import re
import warnings
from typing import List, Optional, Tuple

import torch

from x_detector_tpu_torch.train.train_state import TrainState

_CKPT = re.compile(r"ckpt-(\d+)\.pt")
_META = re.compile(r"meta-(\d+)\.json(\.tmp)?")


def _atomic_write(path: str, write) -> None:
    """``write(file)`` into a temporary file, then ``os.replace``: a crash
    leaves the old file or the new one, never a torn one."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


class CheckpointManager:
    """Saves every checkpoint synchronously (the call returns when the file
    is in place; ``wait`` and ``close`` have nothing to wait for) and keeps
    the newest ``keep``."""

    def __init__(self, directory: str, keep: int = 5):
        self._dir = os.path.abspath(directory)
        self._keep = max(int(keep), 1)
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"ckpt-{step}.pt")

    def _meta_path(self, step: int) -> str:
        return os.path.join(self._dir, f"meta-{step}.json")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self._dir):
            m = _CKPT.fullmatch(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             data_state: Optional[dict] = None) -> None:
        payload = {
            "step": int(state.step),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "ema": state.ema_params,
            "data_state": dict(data_state or {"position": 0}),
        }
        _atomic_write(self._path(step), lambda f: torch.save(payload, f))
        _atomic_write(self._meta_path(step), lambda f: f.write(json.dumps(
            {"has_ema": state.ema_params is not None}).encode()))
        steps = self.all_steps()
        for old in steps[:-self._keep]:
            os.remove(self._path(old))
        live = set(steps[-self._keep:])
        for name in os.listdir(self._dir):
            # sidecars of removed checkpoints, and temporary files a crash
            # between a write and its os.replace left behind
            m = _META.fullmatch(name)
            if name.endswith(".tmp") or (m and int(m.group(1)) not in live):
                os.remove(os.path.join(self._dir, name))

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> Tuple[TrainState, dict]:
        """Load the checkpoint at ``step`` (the newest by default) into
        ``state``, in place; returns it and the data state.

        EMA drift is reconciled as the JAX package does: a shadow in the
        checkpoint is adopted by a state made with ``ema_decay=0`` (and
        stays frozen), and a state that expects a shadow the checkpoint
        lacks re-seeds it from the restored parameters, each with a
        warning. The optimizer's momentum buffers are restored and its
        hyperparameters (the weight-decay groups, the lr that
        ``apply_gradients`` sets from the schedule) stay the state's own."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self._dir}")
        path = self._path(step)
        payload = torch.load(path, map_location="cpu", weights_only=True)
        try:
            state.model.load_state_dict(payload["model"])
        except RuntimeError as e:
            raise ValueError(f"{path} does not fit this model (another "
                             f"preset or width?): {e}") from e
        saved = payload["optimizer"]
        current = state.optimizer.state_dict()
        state.optimizer.load_state_dict(
            {"state": saved["state"], "param_groups": [
                dict(group, params=s["params"]) for group, s in
                zip(current["param_groups"], saved["param_groups"])]})
        state.step = int(payload["step"])
        device = next(state.model.parameters()).device
        ema = payload["ema"]
        if ema is not None and state.ema_params is None:
            warnings.warn(
                "checkpoint carries an EMA shadow but this state was created "
                "with ema_decay=0: adopting the shadow (it will NOT update "
                "if training continues)")
        elif state.ema_params is not None and ema is None:
            warnings.warn(
                "state expects an EMA shadow but the checkpoint has none: "
                "re-initializing the shadow from the restored params")
            ema = {n: p.detach() for n, p in
                   state.model.named_parameters()}
        state.ema_params = None if ema is None else {
            n: t.to(device, copy=True) for n, t in ema.items()}
        return state, dict(payload["data_state"])

    def wait(self) -> None:
        """Nothing to wait for: ``save`` is synchronous."""

    def close(self) -> None:
        """Nothing to release: no file stays open between calls."""
