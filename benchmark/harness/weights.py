"""The cell's weights, made by the benchmark from ``--seed`` on the device:
one normal draw from a ``torch.Generator`` on the card for every tensor
of the model's state dict (``reference.nets.param_spec``), in float32,
the type the program keeps its parameters in.

Kernels are lecun-normal (variance 1 / fan-in, cut at two sigma, the
flax default the program's own initialiser draws); biases and BatchNorm's
affine and running statistics are drawn near their defaults, so that the
folded BatchNorm and every bias carry a value of their own.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.nets import Spec, fan_in

TRUNC_STD = 0.87962566103423978   # std of a unit normal cut at two sigma


def make(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        v = draw[at:at + n].view(shape)
        at += n
        if kind == "kernel":
            t = v.clamp(-2.0, 2.0) * (math.sqrt(1.0 / fan_in(shape))
                                      / TRUNC_STD)
        elif kind == "bias":
            t = v * 0.02
        elif kind == "bn_weight":
            t = 1.0 + 0.1 * v
        elif kind in ("bn_bias", "bn_running_mean"):
            t = 0.1 * v
        elif kind == "bn_running_var":
            t = 1.0 + 0.2 * v.abs()
        else:
            raise ValueError(f"{name}: unknown kind {kind!r}")
        out[name] = t.contiguous()
    return out
