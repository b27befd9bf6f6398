"""Learning-rate schedule (piecewise-constant decay after a linear warmup)
and the SGD-momentum optimizer with weight decay on kernels only.

The port of ``x_detector_tpu/train/schedule.py``. optax's chain of
``add_decayed_weights`` then ``sgd(momentum)`` is torch's SGD with the same
momentum and ``weight_decay`` (g + wd * p, then the momentum trace, then
p -= lr * trace); the decay goes in a param group of conv and dense kernels.
The schedule is read at the step count before the update, as optax reads
it: step 0 uses ``schedule(0)``.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
from torch import nn

Schedule = Callable[[int], float]


def piecewise_with_warmup(base_lr: float, boundaries: Sequence[int],
                          decays: Sequence[float],
                          warmup_steps: int = 0) -> Schedule:
    """step -> lr. ``base_lr * decays[i] / decays[0]`` from boundary i on;
    a linear ramp from ``0.1 * base_lr`` over the first ``warmup_steps``.
    Boundaries count from step 0, as the JAX package's do (it shifts them
    by the warmup when it joins the two schedules)."""
    if len(decays) != len(boundaries) + 1:
        raise ValueError(f"{len(decays)} decays for {len(boundaries)} "
                         "boundaries: need one more decay than boundaries")
    if not all(int(b) > warmup_steps for b in boundaries):
        raise ValueError(f"lr boundaries {tuple(boundaries)} must all exceed "
                         f"warmup_steps={warmup_steps}")
    scales = sorted((int(b) - max(warmup_steps, 0), decays[i + 1] / decays[i])
                    for i, b in enumerate(boundaries))

    def piecewise(count: int) -> float:
        lr = base_lr
        for threshold, scale in scales:
            if count >= threshold:
                lr = lr * scale
        return lr

    if warmup_steps <= 0:
        return piecewise
    start = base_lr * 0.1

    def schedule(step: int) -> float:
        if step >= warmup_steps:
            return piecewise(step - warmup_steps)
        frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
        return (start - base_lr) * frac + base_lr

    return schedule


def decay_groups(model: nn.Module
                 ) -> Tuple[List[nn.Parameter], List[nn.Parameter]]:
    """(conv and dense kernels, every other parameter). Chosen by module
    type: BatchNorm's scale is named ``weight`` too and is not decayed."""
    kernels, others = [], []
    for module in model.modules():
        for name, param in module.named_parameters(recurse=False):
            is_kernel = (isinstance(module, (nn.Conv2d, nn.Linear))
                         and name == "weight")
            (kernels if is_kernel else others).append(param)
    return kernels, others


def make_optimizer(model: nn.Module, cfg) -> Tuple[torch.optim.SGD,
                                                   Schedule]:
    """SGD with momentum ``cfg.momentum`` and weight decay
    ``cfg.weight_decay`` on kernels only, and its lr schedule. ``cfg`` is
    a TrainConfig; the caller sets each group's lr from the schedule before
    every step (``TrainState.apply_gradients`` does)."""
    kernels, others = decay_groups(model)
    optimizer = torch.optim.SGD(
        [{"params": kernels, "weight_decay": cfg.weight_decay},
         {"params": others, "weight_decay": 0.0}],
        lr=cfg.learning_rate, momentum=cfg.momentum)
    schedule = piecewise_with_warmup(cfg.learning_rate, cfg.lr_boundaries,
                                     cfg.lr_decays, cfg.warmup_steps)
    return optimizer, schedule
