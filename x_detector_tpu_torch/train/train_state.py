"""Train state: the step count, the model (its parameters and BatchNorm
running statistics), the optimizer and an optional EMA shadow.

The port of ``x_detector_tpu/train/train_state.py``. The JAX state is one
immutable pytree; here the model and the optimizer hold their tensors and
``apply_gradients`` updates them in place, from the gradients that the
backward left in ``.grad``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from x_detector_tpu_torch.train.schedule import Schedule
from x_detector_tpu_torch.utils import profiling


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None  # EMA shadow
    ema_decay: float = 0.0

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer,
               schedule: Schedule, ema_decay: float = 0.0) -> "TrainState":
        """Decay 0 means no shadow; a shadow starts as a copy of the
        parameters."""
        ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
               if ema_decay > 0 else None)
        return cls(model, optimizer, schedule, 0, ema, ema_decay)

    def apply_gradients(self) -> "TrainState":
        """One optimizer update at ``schedule(step)``, then the EMA update
        ``d * e + (1 - d) * p``; the step count goes up by one."""
        with profiling.span("optimizer"):
            lr = self.schedule(self.step)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
            if self.ema_params is not None and self.ema_decay > 0:
                d = self.ema_decay
                with torch.no_grad():
                    for name, p in self.model.named_parameters():
                        self.ema_params[name].mul_(d).add_(p, alpha=1.0 - d)
        self.step += 1
        return self


def train_snapshot(state: TrainState) -> Dict[str, torch.Tensor]:
    """Every tensor a train state carries, on the CPU, by name: parameters
    and BatchNorm running stats (``model.``), SGD's momentum buffers
    (``momentum.<index>``), the EMA shadow (``ema.``), and the step."""
    out = {"model." + k: v.detach().cpu().clone()
           for k, v in state.model.state_dict().items()}
    for i, s in state.optimizer.state_dict()["state"].items():
        out[f"momentum.{i}"] = s["momentum_buffer"].cpu().clone()
    for k, v in (state.ema_params or {}).items():
        out["ema." + k] = v.detach().cpu().clone()
    out["step"] = torch.tensor(state.step)
    return out


def snapshot_differs(a: Dict[str, torch.Tensor],
                     b: Dict[str, torch.Tensor]) -> List[str]:
    """Names whose tensors are not bitwise equal (or present in one)."""
    return sorted(set(a) ^ set(b)) + [k for k in a if k in b and not
                                      torch.equal(a[k], b[k])]
