"""The least time one NVIDIA H100 SXM could take for a kernel's work, and
what a whole function computes and moves.

Peaks from NVIDIA's data sheet (dense, at the 700 W power limit): a kernel's
bound is the larger of the bytes it must move (each input read once, each
output written once) over the HBM rate and its operations over the peak rate
for their type.

:func:`count` is the port's counterpart of XLA's ``cost_analysis``: the
FLOPs of one call of a function, from ``torch.utils.flop_counter``'s
formulas (convolutions, matrix products, attention; a grouped conv's
backward by :func:`_conv_backward_flop`, which counts its groups) and the
kernels' own (``ops.library.flop_formulas``); elementwise work counts no
FLOPs. And the
bytes its operators read and write, each operator's tensor inputs and
outputs summed once per call, views and allocations free: what XLA's
"bytes accessed" approximates for an unfused program. :func:`mfu` and
:func:`bandwidth_floor_ms` turn them into a share of the bf16 tensor peak
and the least time at HBM's rate.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOP_PER_S = 989e12
INT8_TENSOR_OPS_PER_S = 1979e12
FP32_FLOP_PER_S = 67e12


def bound_ms(flop: float, nbytes: float, flop_per_s: float):
    """(least ms, "bytes" or "operations": whichever binds)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flop / flop_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


class Cost(NamedTuple):
    """What one call computes and moves: ``flop`` (tensor-op FLOPs,
    :func:`count`), ``nbytes`` (bytes its operators read and write) and
    ``by_module``, the FLOPs inside each module's forward by its dotted
    name from the outermost module called ("LightHeadRCNN.backbone")."""
    flop: float
    nbytes: float
    by_module: dict


# operators that move no data: views are counted where they are read
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "resize_", "set_"}


class _BytesMoved(TorchDispatchMode):
    """Sums the bytes of every operator's tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func.overloadpacket.__name__ in _FREE):
            leaves = tree_flatten((args, kwargs, out))[0]
            self.nbytes += sum(t.numel() * t.element_size() for t in leaves
                               if isinstance(t, torch.Tensor))
        return out


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, bias, stride,
                        padding, dilation, transposed, output_padding,
                        groups, output_mask, out_shape=None,
                        **kwargs) -> int:
    """A convolution's backward: each gradient asked for (``output_mask``:
    input, weight) costs the forward's 2 N Cout Ho Wo (Cin / groups) kh kw.
    ``torch.utils.flop_counter``'s own formula leaves the groups out, which
    counts a depthwise conv's backward C times over; it stays for a
    transposed conv."""
    if transposed:
        from torch.utils import flop_counter
        return flop_counter.conv_backward_flop.__wrapped__(
            grad_out_shape, x_shape, w_shape, bias, stride, padding,
            dilation, transposed, output_padding, groups, output_mask,
            out_shape)
    per = 2
    for d in (*grad_out_shape, *w_shape[1:]):
        per *= d
    return per * (int(output_mask[0]) + int(output_mask[1]))


def count(fn: Callable, *args, **kwargs) -> Tuple[object, Cost]:
    """``fn(*args, **kwargs)``'s result and :class:`Cost`."""
    from torch.utils.flop_counter import FlopCounterMode

    from x_detector_tpu_torch.ops.library import flop_formulas
    flops = FlopCounterMode(display=False, custom_mapping={
        **flop_formulas(),
        torch.ops.aten.convolution_backward: _conv_backward_flop})
    moved = _BytesMoved()
    with flops, moved:
        out = fn(*args, **kwargs)
    by_module = {name: float(sum(ops.values())) for name, ops in
                 flops.get_flop_counts().items() if name != "Global"}
    return out, Cost(float(flops.get_total_flops()), float(moved.nbytes),
                     by_module)


def mfu(flop: float, ms: float) -> float:
    """The share of the bf16 tensor-core peak that ``flop`` in ``ms``
    reaches (the JAX package's tools report theirs against the TPU's bf16
    peak the same way)."""
    return flop / (ms * 1e-3) / BF16_TENSOR_FLOP_PER_S


def bandwidth_floor_ms(nbytes: float) -> float:
    """The least ms ``nbytes`` take at HBM's rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3
