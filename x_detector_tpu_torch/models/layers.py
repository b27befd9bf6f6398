"""Conv building blocks, inference and training (NCHW in channels_last
memory).

Tensors between blocks are NCHW tensors in ``torch.channels_last`` memory
format, which is NHWC in memory, so the fused kernel reads them without a
copy. Numerics follow the JAX package: fp32 parameters rounded to the
compute ``dtype`` at use (bf16 on the card), and BatchNorm applied as one
per-channel ``x * inv + bias`` in the compute dtype, from the running stats
at inference and from the batch's in training (``module.training``).

Module and parameter names mirror the flax tree (``Conv_0``, ``Conv_1``,
``bn``) so that ``utils.convert.from_jax_variables`` maps one onto the other
by name.

Post-training int8 quantization (the JAX package's ``QuantConv``): with
``quant`` set, ``ConvBN`` and ``SeparableConvBN`` hold :class:`QuantConv`
in place of their ``nn.Conv2d``; its mode is that of
``ModelConfig.backbone_quant`` ("calibrate", "calibrate:p<pct>", "int8" or
the training probe "act8", ``config.check_backbone_quant``).

Backbone remat (``remat``): a stage run under ``torch.utils.checkpoint``
recomputes its forward in the backward, with BatchNorm's running-stat
update off during the recompute.

Inference operands: :func:`prepare_for_inference` (a model in ``eval()``
mode) computes the fused route's and the int8 convs' kernel operands once
into buffers that the forward then reads; an exported program reads them
as it reads the weights. They are non-persistent (never in a state dict or
checkpoint: they follow from the weights) and are dropped by ``train()``,
``load_state_dict`` and ``QuantConv.set_int8_weight``. An eval-mode
forward of a fused block or an int8 conv without them raises: it never
makes its operands itself, so it never makes them on every call. Only an
int8 conv in training mode makes its operands in each forward.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from x_detector_tpu_torch.config import (calibration_percentile,
                                         check_backbone_quant)
from x_detector_tpu_torch.ops import int8_conv
from x_detector_tpu_torch.ops.fused_sepconv import (
    SepConvWeights, fused_separable_conv_prepared, prepare_weights, route_for)

Pads = Tuple[Tuple[int, int], Tuple[int, int]]

# Running-stat momentum of BatchNorm, the JAX package's default
# (x_detector_tpu/models/layers.py:205).
_BN_MOMENTUM = 0.99
# the dtypes whose CPU convs run in fp32 (rounded_conv)
_CPU_WIDENED = (torch.bfloat16, torch.float16)


def same_pads(size: Sequence[int], kernel: Sequence[int],
              stride: Sequence[int], dilation: Sequence[int]) -> Pads:
    """XLA "SAME" padding per spatial dim: the odd pixel goes after, so a
    stride-2 3x3 on an even size pads (0, 1), not torch's symmetric 1."""
    pads = []
    for n, k, s, d in zip(size, kernel, stride, dilation):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _conv_padding(x: torch.Tensor, conv: nn.Conv2d,
                  pads: Union[str, Pads]):
    """(input, ``F.conv2d`` padding) for ``pads`` ("SAME" or ((top, bottom),
    (left, right))): symmetric pads go to the conv, asymmetric ones are
    applied to the input here."""
    if pads == "SAME":
        pads = same_pads(x.shape[2:], conv.kernel_size, conv.stride,
                         conv.dilation)
    (top, bottom), (left, right) = pads
    if top == bottom and left == right:
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom)), 0


def conv2d(x: torch.Tensor, conv: nn.Conv2d, pads: Union[str, Pads],
           dtype: torch.dtype) -> torch.Tensor:
    """``conv``'s parameters applied in ``dtype`` with explicit padding:
    ``pads`` is "SAME" or ((top, bottom), (left, right))."""
    x, padding = _conv_padding(x, conv, pads)
    bias = None if conv.bias is None else conv.bias.to(dtype)
    y = rounded_conv(x.to(dtype), conv.weight.to(dtype), bias, conv.stride,
                     padding, conv.dilation, conv.groups)
    return y.contiguous(memory_format=torch.channels_last)


def rounded_conv(x: torch.Tensor, w: torch.Tensor, bias, stride, padding,
                 dilation, groups) -> torch.Tensor:
    """``F.conv2d`` of operands already rounded to their dtype. On the CPU
    a bf16 or fp16 conv runs in fp32 on those values and rounds its result
    back (and so does its backward, through the casts): only the
    accumulation changes, and oneDNN accumulates bf16 in fp32 anyway.
    PyTorch's CPU bf16 conv backward reads uninitialised memory on a 1 x 1
    input with a 3 x 3 stride-2 kernel (the 64 px SSD's last extras); a
    card runs the conv in its dtype."""
    if x.device.type != "cpu" or x.dtype not in _CPU_WIDENED:
        return F.conv2d(x, w, bias, stride, padding, dilation, groups)
    y = F.conv2d(x.float(), w.float(), None if bias is None else
                 bias.float(), stride, padding, dilation, groups)
    return y.to(x.dtype)


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2,
             explicit_pad: bool = False) -> torch.Tensor:
    """Max pooling of an NCHW tensor: ``explicit_pad`` pads (window-1)//2 on
    every side, otherwise XLA "SAME" (``same_pads``). Padding is -inf, so
    it never wins a max."""
    if explicit_pad:
        p = (window - 1) // 2
        pads = ((p, p), (p, p))
    else:
        pads = same_pads(x.shape[2:], (window,) * 2, (stride,) * 2, (1, 1))
    (top, bottom), (left, right) = pads
    if top == bottom and left == right:     # torch pads with -inf itself
        padding = (top, left)
    else:
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
        padding = 0
    y = F.max_pool2d(x, window, stride, padding)
    return y.contiguous(memory_format=torch.channels_last)


# set while a checkpointed forward is recomputed in the backward
_RECOMPUTE = threading.local()


@contextlib.contextmanager
def _recomputing():
    prev = getattr(_RECOMPUTE, "active", False)
    _RECOMPUTE.active = True
    try:
        yield
    finally:
        _RECOMPUTE.active = prev


def remat(fn, *args):
    """``fn(*args)`` whose activations are not saved but recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant): the JAX package's
    ``nn.remat``. The recompute runs with the running-stat update of every
    :class:`BatchNorm2D` off, so the statistics move once a forward, as
    without the recompute; it sees the same input, so it uses the same
    batch statistics."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputing()))


class BatchNorm2D(nn.Module):
    """BatchNorm with eps 1e-5 as one ``x * inv + bias`` in the input's
    dtype. At inference ``inv`` and ``bias`` fold the running stats. In
    training they fold the batch's fp32 statistics over (N, H, W):
    E[x], E[x^2] and the biased variance max(E[x^2] - E[x]^2, 0), with the
    gradient flowing through both; the running stats move to
    ``m * running + (1 - m) * batch`` with m = ``_BN_MOMENTUM``.
    (``F.batch_norm`` would update with the unbiased variance.) A forward
    recomputed by :func:`remat` leaves the running stats alone."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 per-channel (scale, bias) of the inference affine."""
        inv = self.weight * torch.rsqrt(self.running_var + self.epsilon)
        return inv, self.bias - self.running_mean * inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            if not getattr(_RECOMPUTE, "active", False):
                with torch.no_grad():
                    m = _BN_MOMENTUM
                    self.running_mean.copy_(m * self.running_mean
                                            + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var
                                           + (1 - m) * var)
            inv = self.weight * torch.rsqrt(var + self.epsilon)
            bias = self.bias - mean * inv
        else:
            inv, bias = self.folded()
        return (x * inv.to(x.dtype)[None, :, None, None]
                + bias.to(x.dtype)[None, :, None, None])


# The prepared operands' buffers (prepare_for_inference)
INT8_OPERANDS = ("int8_sx", "int8_scale", "int8_kernel")
FUSED_OPERANDS = ("fused_wd", "fused_wp", "fused_scale", "fused_bias")


def _check_eval(module: nn.Module) -> None:
    if module.training:
        raise ValueError(f"{type(module).__name__}: prepare_for_inference "
                         f"needs the module in eval() mode")


def _unprepared(module: nn.Module) -> ValueError:
    return ValueError(
        f"{type(module).__name__}: an eval-mode forward reads the operands "
        f"that models.layers.prepare_for_inference(model) makes; call it "
        f"after eval() and after changing the weights (build_eval_fn, "
        f"quant and cli.export do)")


def prepare_for_inference(model: nn.Module) -> nn.Module:
    """Hold every kernel operand that ``model``'s forward would make from
    its weights (the fused separable blocks' and the int8 convs') in
    buffers, for inference: ``model`` must be in ``eval()`` mode. Call it
    again after changing weights in place in eval mode; ``train()`` and
    ``load_state_dict`` drop the operands themselves."""
    _check_eval(model)
    for m in model.modules():
        if isinstance(m, (QuantConv, SeparableConvBN)):
            m.prepare_for_inference()
    return model


# calibrate:p<pct> estimates the percentile on at most this many elements
# of |x|, a strided subsample (x_detector_tpu/models/layers.py:141-148)
PERCENTILE_SAMPLE = 1 << 20


def observe(x: torch.Tensor, percentile: Optional[float]) -> torch.Tensor:
    """Calibration's fp32 statistic of one conv input ``x`` (NCHW): max|x|
    or, with ``percentile``, the linearly interpolated percentile of |x|
    over the JAX package's subsample: |x| raveled in NHWC order, every
    ``n // 2^20``-th of its first ``2^20 * (n // 2^20)`` elements when n
    exceeds 2^20. The interpolation is ``jnp.percentile``'s, op for op in
    fp32: q = pct / 100, i = q (n - 1), v[floor i] (1 - f) + v[ceil i] f."""
    if percentile is None:
        return x.abs().amax().float()          # a max is exact in any dtype
    flat = x.permute(0, 2, 3, 1).reshape(-1)    # NHWC order, as JAX ravels
    if flat.numel() > PERCENTILE_SAMPLE:
        stride = flat.numel() // PERCENTILE_SAMPLE
        flat = flat[:stride * PERCENTILE_SAMPLE:stride]
    values = torch.sort(flat.float().abs()).values
    n = values.numel()
    pos = np.float32(percentile) / np.float32(100.0) * np.float32(n - 1)
    low, high = np.floor(pos), np.ceil(pos)
    f = pos - low
    low, high = (int(min(max(v, 0), n - 1)) for v in (low, high))
    return (values[low] * float(np.float32(1.0) - f)
            + values[high] * float(f))


# act8's activation scale: s = max|x| / 127 + ACT8_EPS
# (x_detector_tpu/models/layers.py:60)
ACT8_EPS = 1e-12


def act8_scale(x: torch.Tensor) -> torch.Tensor:
    """act8's fp32 scale of ``x``, ``max|x| / 127 + 1e-12``, on ``x``'s
    device, the division rounded as IEEE division (``int8_conv.ieee_div``:
    the card would otherwise multiply by the reciprocal)."""
    amax = x.detach().abs().amax().float()    # a max is exact in any dtype
    return int8_conv.ieee_div(amax, float(int8_conv.QMAX)) + ACT8_EPS


class _Act8Conv(torch.autograd.Function):
    """``F.conv2d(x, w)`` (no bias) whose backward reads an int8 copy of
    ``x``: the forward saves ``xq = clip(round(x / s), -127, 127)`` (K3,
    ``int8_conv.quantize_activation``, NHWC) with ``s`` = :func:`act8_scale`,
    and the weight. The conv is bilinear, so dL/dx needs only the gradient
    and the weight and is exact; dL/dw reads ``xa = dtype(float(xq) * s)``,
    the only approximation. Both come from one ``convolution_backward``, the
    call the plain conv's backward makes (dL/dx reads ``x``'s shape only)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        y = rounded_conv(x, w, None, stride, padding, dilation, groups)
        s = act8_scale(x)
        xq = int8_conv.quantize_activation(
            x.detach().permute(0, 2, 3, 1).contiguous(), s)
        ctx.save_for_backward(xq, s, w)
        ctx.geometry = (stride, padding, dilation, groups, x.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        xq, s, w = ctx.saved_tensors
        stride, padding, dilation, groups, dtype = ctx.geometry
        xa = (xq.float() * s).to(dtype).permute(0, 3, 1, 2)
        pad = (padding, padding) if isinstance(padding, int) else padding
        # in fp32 on the CPU, as rounded_conv's backward
        wide = g.device.type == "cpu" and dtype in _CPU_WIDENED
        if wide:
            g, xa, w = g.float(), xa.float(), w.float()
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g, xa, w, None, stride, pad, dilation, False, [0, 0], groups,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        if wide:
            dx, dw = (None if t is None else t.to(dtype) for t in (dx, dw))
        return dx, dw, None, None, None, None


class QuantConv(nn.Conv2d):
    """The JAX package's ``QuantConv``: an ``nn.Conv2d`` (its parameters and
    state-dict keys, so a float checkpoint loads unchanged) with the buffer
    ``act_amax`` (fp32 scalar, zeros until calibrated), which a state dict
    may lack. ``pads`` is "SAME" or ((top, bottom), (left, right)).

    "calibrate" / "calibrate:p<pct>": the float path's conv
    (:func:`conv2d`, so the output is the same bits), recording
    ``act_amax = max(act_amax, observe(x))``.

    "int8": ``x`` to int8 at ``sx = max(act_amax, 1e-6) / 127``, the weight
    per output channel at ``sw`` (``ops.int8_conv.quantize_weight``), an
    int8 conv with int32 sums, ``dtype(float(acc) * (sx * sw))``, then the
    bias in ``dtype``. :meth:`prepare_for_inference` makes the kernels'
    operands (``int8_sx``, ``int8_scale`` = sx * sw and ``int8_kernel``)
    once, and an eval-mode forward reads them (raising without them); in
    training mode each forward makes its own. The launch geometry and the
    operands' shape checks run once an input shape. A prequantized module
    (``quant.prequantize``) holds an int8 ``weight`` (no gradient) and a
    buffer ``w_scale`` [Cout], and skips the weight quantization.

    "act8" (a training probe): the float conv in ``dtype`` whose backward
    reads an int8 copy of its input (:class:`_Act8Conv`, K3 once a forward
    that records a gradient), then the bias in ``dtype``. As in the JAX
    package it has no ``act_amax`` (no range to calibrate), and any
    ``groups``, stride and dilation take it."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int], strides: Tuple[int, int] = (1, 1),
                 dilation: Tuple[int, int] = (1, 1), groups: int = 1,
                 bias: bool = False, *, pads: Union[str, Pads] = "SAME",
                 mode: str = "calibrate",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, features, kernel, strides,
                         dilation=dilation, groups=groups, bias=bias)
        if check_backbone_quant(mode) is None:
            raise ValueError("QuantConv needs a mode")
        if groups != 1 and mode == "int8" and not (
                groups == in_features == features
                and self.kernel_size == (3, 3)
                and len(set(self.stride)) == len(set(self.dilation)) == 1):
            raise ValueError("int8 grouped convs: the depthwise 3x3 with "
                             "square stride and dilation only")
        self.mode, self.pads, self.dtype = mode, pads, dtype
        # the int8 operators' checked geometry (int8_conv.conv_geometry) by
        # input shape (C, H, W)
        self._geometry = {}
        if mode != "act8":
            self.register_buffer("act_amax", torch.zeros(()))
        for name in INT8_OPERANDS:
            self.register_buffer(name, None, persistent=False)

    @property
    def depthwise(self) -> bool:
        return self.groups > 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "int8":
            return self._forward_int8(x)
        if self.mode == "act8":
            return self._forward_act8(x)
        with torch.no_grad():
            obs = observe(x, calibration_percentile(self.mode))
            self.act_amax.copy_(torch.maximum(self.act_amax, obs))
        return conv2d(x, self, self.pads, self.dtype)

    def _forward_act8(self, x: torch.Tensor) -> torch.Tensor:
        x, padding = _conv_padding(x.to(self.dtype), self, self.pads)
        w = self.weight.to(self.dtype)
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            y = _Act8Conv.apply(x, w, self.stride, padding, self.dilation,
                                self.groups)
        else:             # nothing saved for a backward: the plain conv
            y = rounded_conv(x, w, None, self.stride, padding,
                             self.dilation, self.groups)
        y = y.contiguous(memory_format=torch.channels_last)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[None, :, None, None]
        return y

    def int8_operands(self):
        """(sx, sx * sw [Cout], ``Int8Weight``) from the weight (or the int8
        weight and ``w_scale``) and ``act_amax``."""
        w_scale = self._buffers.get("w_scale")
        if self.weight.dtype == torch.int8:
            if w_scale is None:
                raise ValueError("an int8 weight needs its w_scale "
                                 "(quant.prequantize stores both)")
            wq, sw = self.weight, w_scale
        else:
            wq, sw = int8_conv.quantize_weight(self.weight)
        sx = int8_conv.activation_scale(self.act_amax)
        return sx, sx * sw, int8_conv.prepare_weight(
            wq.permute(0, 2, 3, 1), depthwise=self.depthwise)

    def prepare_for_inference(self) -> None:
        """Hold the int8 operands in buffers (int8 mode, ``eval()`` only)."""
        _check_eval(self)
        self.release_prepared()
        if self.mode == "int8":
            with torch.no_grad():
                sx, scale, weight = self.int8_operands()
            self.int8_sx, self.int8_scale = sx, scale
            self.int8_kernel = weight.kernel

    def release_prepared(self) -> None:
        for name in INT8_OPERANDS:
            setattr(self, name, None)

    def train(self, mode: bool = True):
        if mode:
            self.release_prepared()
        return super().train(mode)

    def forward_operands(self):
        """(sx, sx * sw, the weight operand) that an int8 forward reads:
        the prepared buffers in eval mode (raising without them), made
        anew in training mode."""
        if self.training:
            with torch.no_grad():
                sx, scale, weight = self.int8_operands()
            return sx, scale, weight.kernel
        if self.int8_kernel is None:
            raise _unprepared(self)
        return self.int8_sx, self.int8_scale, self.int8_kernel

    def _forward_int8(self, x: Optional[torch.Tensor], *,
                      xq: Optional[torch.Tensor] = None, operands=None,
                      sx_out: Optional[torch.Tensor] = None):
        """The int8 conv of NCHW ``x``, quantized here (K3), or of ``xq``,
        the int8 NHWC input already quantized at this conv's sx (no K3);
        ``operands`` as :meth:`forward_operands` gives them. With
        ``sx_out`` (a depthwise conv without a bias) the output in
        ``dtype`` is quantized at that scale on K2's store: int8 NHWC."""
        sx, scale, kernel = operands or self.forward_operands()
        if xq is None:
            xq = int8_conv.quantize_activation(
                x.permute(0, 2, 3, 1).contiguous(), sx)
        shape = (xq.shape[3], xq.shape[1], xq.shape[2])
        geometry = self._geometry.get(shape)
        if geometry is None:
            geometry = self._geometry[shape] = self._check_launch(
                xq.shape, kernel, scale)
        # the operator itself: its operands' shapes were checked with the
        # geometry, once for this input shape
        if sx_out is not None:
            return torch.ops.xdt.int8_dwconv_q.default(
                xq, kernel, scale, sx_out, geometry, self.dtype)
        op = torch.ops.xdt.int8_dwconv if self.depthwise else (
            torch.ops.xdt.int8_conv)
        y = op.default(xq, kernel, scale, geometry, self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y.permute(0, 3, 1, 2)              # channels_last NCHW view

    def _check_launch(self, xq_shape, kernel, scale) -> list:
        """The geometry of a call on an input of ``xq_shape`` (NHWC), its
        operands' shapes checked."""
        pads = self.pads
        if pads == "SAME":
            pads = same_pads(xq_shape[1:3], self.kernel_size, self.stride,
                             self.dilation)
        geometry = int8_conv.conv_geometry(self.kernel_size, self.stride,
                                           self.dilation, pads)
        int8_conv.check_operand_shapes(type(self).__name__, xq_shape, kernel,
                                       scale, geometry, self.depthwise)
        return geometry

    def set_int8_weight(self, wq: torch.Tensor, w_scale: torch.Tensor):
        """Hold int8 ``wq`` (OIHW) and its per-channel ``w_scale``."""
        self.release_prepared()
        self.weight = nn.Parameter(wq, requires_grad=False)
        self.register_buffer("w_scale", w_scale)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        # take the stored weight's type: int8 with its w_scale (a
        # prequantized checkpoint) or float without one
        self.release_prepared()
        weight = state_dict.get(prefix + "weight")
        if weight is not None:
            device = self.weight.device
            if weight.dtype == torch.int8:
                self.set_int8_weight(
                    torch.empty(weight.shape, dtype=torch.int8,
                                device=device),
                    torch.empty(weight.shape[0], device=device))
            elif self.weight.dtype == torch.int8:
                self.weight = nn.Parameter(torch.empty(weight.shape,
                                                       device=device))
                del self._buffers["w_scale"]
        super()._load_from_state_dict(state_dict, prefix, local_metadata,
                                      strict, missing_keys, unexpected_keys,
                                      error_msgs)
        if prefix + "act_amax" in missing_keys:   # a float checkpoint
            missing_keys.remove(prefix + "act_amax")


class ConvBN(nn.Module):
    """Conv -> BatchNorm -> (optional) ReLU. ``use_bn=False`` gives the conv
    a bias instead. ``padding`` is "SAME", "EXPLICIT" (symmetric
    (k-1)//2 * d) or explicit ((top, bottom), (left, right)) pairs."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1),
                 dilation: Tuple[int, int] = (1, 1), relu: bool = True,
                 use_bn: bool = True, padding: Union[str, Pads] = "SAME",
                 quant=None, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if padding == "EXPLICIT":
            padding = tuple(((k - 1) // 2 * d, (k - 1) // 2 * d)
                            for k, d in zip(kernel, dilation))
        self.padding, self.relu, self.dtype = padding, relu, dtype
        self.quant = check_backbone_quant(quant)
        if self.quant is None:
            self.Conv_0 = nn.Conv2d(in_features, features, kernel, strides,
                                    dilation=dilation, bias=not use_bn)
        else:
            self.Conv_0 = QuantConv(in_features, features, kernel, strides,
                                    dilation, bias=not use_bn, pads=padding,
                                    mode=quant, dtype=dtype)
        self.bn = BatchNorm2D(features) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant is None:
            x = conv2d(x, self.Conv_0, self.padding, self.dtype)
        else:
            x = self.Conv_0(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class SeparableConvBN(nn.Module):
    """Depthwise 3x3 -> pointwise 1x1 -> one BatchNorm -> ReLU.

    ``dense=True`` swaps the pair for one dense 3x3 ``Conv_0`` (a
    :class:`QuantConv` with ``quant``) with the same interface, the JAX
    package's choice for early high-resolution stages; a dense block never
    takes the fused kernel.

    ``fused=True`` routes stride-1 calls at inference through the fused
    kernel (``ops/fused_sepconv.py``); training, stride-2 and quantized
    calls keep the two convs (with ``quant``, two :class:`QuantConv`).
    With both int8 (:attr:`quantizes_on_store`), the depthwise conv's
    kernel (K2) quantizes its output at the pointwise conv's scale, which
    then reads that int8 map without a quantize pass of its own (K3). The
    parameters are the same either way; the fused route's operands (taps,
    ``wp`` in the compute dtype and the route's layout, the folded BN) are
    held in buffers by :meth:`prepare_for_inference`, which the fused
    route reads (raising without them).
    ``forward(x, residual)`` is the
    Xception unit's epilogue ``relu(bn(x) + residual)`` (the module then has
    ``relu=False``).
    """

    def __init__(self, in_features: int, features: int,
                 strides: Tuple[int, int] = (1, 1),
                 dilation: Tuple[int, int] = (1, 1), relu: bool = True,
                 dense: bool = False, fused: bool = False, quant=None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if dilation[0] != dilation[1]:
            raise ValueError(f"square dilation only, got {dilation}")
        self.strides, self.dilation = tuple(strides), tuple(dilation)
        self.relu, self.fused, self.dtype = relu, fused, dtype
        self.dense = dense
        self.quant = check_backbone_quant(quant)
        if dense:                  # one dense 3x3 in place of the pair
            self.Conv_0 = (nn.Conv2d(in_features, features, 3, strides,
                                     dilation=dilation, bias=False)
                           if self.quant is None else
                           QuantConv(in_features, features, (3, 3), strides,
                                     dilation, mode=quant, dtype=dtype))
            self.Conv_1 = None
        elif self.quant is None:
            self.Conv_0 = nn.Conv2d(in_features, in_features, 3, strides,
                                    dilation=dilation, groups=in_features,
                                    bias=False)
            self.Conv_1 = nn.Conv2d(in_features, features, 1, bias=False)
        else:
            self.Conv_0 = QuantConv(in_features, in_features, (3, 3), strides,
                                    dilation, groups=in_features,
                                    mode=quant, dtype=dtype)
            self.Conv_1 = QuantConv(in_features, features, (1, 1),
                                    mode=quant, dtype=dtype)
        self.bn = BatchNorm2D(features)
        self.route = route_for(in_features, features)
        for name in FUSED_OPERANDS:
            self.register_buffer(name, None, persistent=False)

    def fused_weights(self) -> SepConvWeights:
        """The fused route's prepared operands (:meth:`prepare_for_inference`);
        raises without them."""
        if self.fused_wp is None:
            raise _unprepared(self)
        return SepConvWeights(self.fused_wd, self.fused_wp, self.fused_scale,
                              self.fused_bias, self.route)

    def prepare_for_inference(self) -> None:
        """Hold the fused route's operands in buffers (``eval()`` only),
        made from the parameters and BatchNorm statistics."""
        _check_eval(self)
        self.release_prepared()
        if self.takes_fused_route:
            with torch.no_grad():
                scale, bias = self.bn.folded()
                operands = prepare_weights(
                    self.Conv_0.weight[:, 0].permute(1, 2, 0),
                    self.Conv_1.weight[:, :, 0, 0].t(), scale, bias,
                    route=self.route, dtype=self.dtype)
            for name, t in zip(FUSED_OPERANDS, operands):
                setattr(self, name, t.clone())   # no view of a parameter

    def release_prepared(self) -> None:
        for name in FUSED_OPERANDS:
            setattr(self, name, None)

    def train(self, mode: bool = True):
        if mode:
            self.release_prepared()
        return super().train(mode)

    def _load_from_state_dict(self, *args, **kwargs):
        self.release_prepared()
        super()._load_from_state_dict(*args, **kwargs)

    @property
    def takes_fused_route(self) -> bool:
        """Whether ``forward`` now launches the fused kernel."""
        return (self.fused and not self.training and self.quant is None
                and not self.dense and self.strides == (1, 1))

    @property
    def quantizes_on_store(self) -> bool:
        """Whether ``forward`` runs the int8 pair as K2 quantizing its
        output at ``Conv_1``'s sx, then ``Conv_1`` on that int8 map: both
        convs int8 (not calibrating), the depthwise one without a bias and
        of the shapes K2's "tma" route takes
        (``ops.int8_conv.fuses_quantize``). Nothing lies between the two
        convs, so the bits are those of the two calls."""
        return (self.quant is not None and self.Conv_1 is not None
                and self.Conv_0.mode == "int8"
                and self.Conv_1.mode == "int8" and self.Conv_0.bias is None
                and int8_conv.fuses_quantize(self.Conv_0.in_channels,
                                             self.strides[0],
                                             self.dilation[0]))

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if residual is not None and self.relu:
            raise ValueError("the residual epilogue owns the ReLU: build the "
                             "module with relu=False")
        if self.takes_fused_route:
            out = fused_separable_conv_prepared(
                x.to(self.dtype).permute(0, 2, 3, 1).contiguous(),
                self.fused_weights(), dilation=self.dilation[0],
                relu=self.relu or residual is not None,
                residual=None if residual is None else
                residual.to(self.dtype).permute(0, 2, 3, 1).contiguous())
            return out.permute(0, 3, 1, 2)          # channels_last NCHW view
        if self.quantizes_on_store:
            operands = self.Conv_1.forward_operands()
            xq = self.Conv_0._forward_int8(x, sx_out=operands[0])
            x = self.Conv_1._forward_int8(None, xq=xq, operands=operands)
        elif self.quant is not None:
            x = self.Conv_0(x)
            if self.Conv_1 is not None:
                x = self.Conv_1(x)
        else:
            x = conv2d(x, self.Conv_0, "SAME", self.dtype)
            if self.Conv_1 is not None:
                x = conv2d(x, self.Conv_1, "SAME", self.dtype)
        x = self.bn(x)
        if residual is not None:
            return F.relu(x + residual)
        return F.relu(x) if self.relu else x


def init_flax_like(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's default initialisation, in place: lecun-normal conv and dense
    kernels (truncated normal at +-2 sigma, variance 1/fan_in), zero biases,
    BatchNorm scale 1 and bias 0, running mean 0 and variance 1. Modules are
    visited in registration order, so one generator seed gives one model."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm2D):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
