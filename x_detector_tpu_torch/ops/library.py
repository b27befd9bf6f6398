"""The port's kernels as PyTorch operators, in one ``torch.library``
namespace, ``xdt``.

Every hand kernel is reached only through its operator:

  ==========================  ==========================================
  ``xdt::psroi_align_fwd``    B1's forward (``ops/psroi_align.py``)
  ``xdt::psroi_align_bwd``    B1's backward, the forward's gradient
  ``xdt::fused_sepconv``      B2 (``ops/fused_sepconv.py``)
  ``xdt::int8_conv``          K1 (``ops/int8_conv.py``)
  ``xdt::int8_dwconv``        K2
  ``xdt::int8_dwconv_q``      K2 quantizing its output as K3 does
  ``xdt::quantize_s8``        K3
  ``xdt::nms_suppress``       exact greedy NMS's suppressed flags
                              (``ops/nms.py``: on the CPU the plain tile
                              loop, on the card ``csrc/nms.cu``'s mask and
                              scan kernels, no host sync)
  ``xdt::self_suppress``      NMS's host-checked fixpoint of one tile, which
                              the plain tile loop calls (plain PyTorch on
                              both devices, no kernel)
  ==========================  ==========================================

Each operator has a fake implementation (output shapes and dtypes, which
``torch.export`` traces through), a CPU implementation (the plain version),
a CUDA one (the kernel's launch, which counts it) and, for a kernel that
adds to the reference's FLOPs (all but NMS's), a FLOP formula
(:func:`flop_formulas`, for ``utils/roofline.count``). The
dispatcher picks the implementation from the tensors' device: a CUDA
tensor always reaches the kernel, which launches or raises, and nothing
falls back to the plain version. A graph exported from the model holds one
opaque node per call, so a program loaded with ``torch.export.load``
launches the same kernels as eager code; the loading process must have
imported this module first (``serving.py`` does).

The package's ``ops/__init__.py`` imports this module, so the operators are
registered whenever any module of ``ops`` is.
"""

from __future__ import annotations

import json

import torch

from x_detector_tpu_torch.ops import fused_sepconv, int8_conv, nms
from x_detector_tpu_torch.ops import psroi_align

NAMESPACE = "xdt"
_LIB = torch.library.Library(NAMESPACE, "DEF")
# each operator's CUDA implementation by name, for measuring what the
# dispatcher costs a call (chip_smoke.py)
CUDA_IMPLEMENTATIONS = {}


def _define(schema: str, fake, cpu, cuda) -> None:
    name = schema.split("(")[0]
    CUDA_IMPLEMENTATIONS[name] = cuda
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)


# ---- B1 ---------------------------------------------------------------------

def _psroi_fwd_fake(features, rois, grid, samples):
    c = features.shape[-1] // (grid * grid)
    return features.new_empty((features.shape[0], rois.shape[1], grid, grid,
                               c), dtype=torch.float32)


def _psroi_bwd_fake(grad, rois, height, width, dtype, grid, samples):
    return grad.new_empty((rois.shape[0], height, width,
                           grid * grid * grad.shape[-1]), dtype=dtype)


_define("psroi_align_fwd(Tensor features, Tensor rois, int grid, "
        "int samples) -> Tensor", _psroi_fwd_fake,
        psroi_align.psroi_align_reference, psroi_align.forward_cuda)
_define("psroi_align_bwd(Tensor grad, Tensor rois, int height, int width, "
        "ScalarType dtype, int grid, int samples) -> Tensor",
        _psroi_bwd_fake, psroi_align.psroi_align_backward_reference,
        psroi_align.backward_cuda)


def _psroi_setup(ctx, inputs, output):
    features, rois, grid, samples = inputs
    ctx.save_for_backward(rois)
    ctx.geometry = (features.shape[1], features.shape[2], features.dtype,
                    grid, samples)


def _psroi_backward(ctx, grad):
    rois, = ctx.saved_tensors
    # through the public wrapper, which calls xdt::psroi_align_bwd
    dfeat = psroi_align.psroi_align_backward(grad, rois, *ctx.geometry)
    return dfeat, None, None, None


# the port of the JAX package's custom_vjp: the gradient flows to the
# features only
torch.library.register_autograd(f"{NAMESPACE}::psroi_align_fwd",
                                _psroi_backward, setup_context=_psroi_setup,
                                lib=_LIB)


# ---- B2 ---------------------------------------------------------------------

def _sepconv_fake(x, wd, wp, scale, bias, residual, dilation, relu, route):
    cout = wp.shape[0] if route == "tma" else wp.shape[1]
    return x.new_empty((*x.shape[:3], cout))


_define("fused_sepconv(Tensor x, Tensor wd, Tensor wp, Tensor scale, "
        "Tensor bias, Tensor? residual, int dilation, bool relu, str route)"
        " -> Tensor", _sepconv_fake, fused_sepconv.plain_prepared,
        fused_sepconv.launch_cuda)


# ---- K1-K3 ------------------------------------------------------------------

def _conv_fake(xq, kernel, scale, geometry, out_dtype):
    return int8_conv.conv_output(xq, kernel.shape[0], geometry, out_dtype)


def _dwconv_fake(xq, kernel, scale, geometry, out_dtype):
    int8_conv.check_dw_operand_shapes("int8_dwconv", xq.shape[3], kernel,
                                      scale)
    return int8_conv.conv_output(xq, xq.shape[3], geometry, out_dtype)


def _dwconv_q_fake(xq, kernel, scale, sx_out, geometry, dtype):
    int8_conv.check_dw_operand_shapes("int8_dwconv_q", xq.shape[3], kernel,
                                      scale)
    return int8_conv.conv_output(xq, xq.shape[3], geometry, torch.int8)


def _quantize_fake(x, sx):
    return x.new_empty(x.shape, dtype=torch.int8)


def _quantize_plain(x, sx):
    return int8_conv.quantize_activation_reference(x, sx).contiguous()


# one int[] of geometry (int8_conv.conv_geometry): each list argument costs
# the dispatcher a conversion on every call
_define("int8_conv(Tensor xq, Tensor kernel, Tensor scale, int[10] geometry, "
        "ScalarType out_dtype) -> Tensor", _conv_fake, int8_conv.conv_plain,
        int8_conv.conv_cuda)
_define("int8_dwconv(Tensor xq, Tensor kernel, Tensor scale, "
        "int[10] geometry, ScalarType out_dtype) -> Tensor", _dwconv_fake,
        int8_conv.dwconv_plain, int8_conv.dwconv_cuda)
# K2 with K3 on its store: an operator of its own, since its output is
# int8 whatever the module dtype (``dtype``, which the value is rounded to
# before it is quantized), and xdt::int8_dwconv's schema and graphs stay
# as they were
_define("int8_dwconv_q(Tensor xq, Tensor kernel, Tensor scale, "
        "Tensor sx_out, int[10] geometry, ScalarType dtype) -> Tensor",
        _dwconv_q_fake, int8_conv.dwconv_q_plain, int8_conv.dwconv_q_cuda)
_define("quantize_s8(Tensor x, Tensor sx) -> Tensor", _quantize_fake,
        _quantize_plain, int8_conv.quantize_cuda)


# ---- NMS --------------------------------------------------------------------

def _nms_suppress_fake(boxes, iou_threshold):
    return boxes.new_empty(boxes.shape[:2], dtype=torch.bool)


def _self_suppress_fake(mask):
    return mask.new_empty(mask.shape[:2], dtype=torch.bool)


_define("nms_suppress(Tensor boxes, float iou_threshold) -> Tensor",
        _nms_suppress_fake, nms.suppress_plain, nms.suppress_cuda)
# kept registered for programs exported before xdt::nms_suppress, whose
# graphs name it; the plain tile loop calls it on the CPU
_define("self_suppress(Tensor mask) -> Tensor", _self_suppress_fake,
        nms.self_suppress, nms.self_suppress)

OPERATORS = ("psroi_align_fwd", "psroi_align_bwd", "fused_sepconv",
             "int8_conv", "int8_dwconv", "int8_dwconv_q", "quantize_s8",
             "nms_suppress", "self_suppress")
# the operators with no FLOP formula: NMS compares boxes and adds no FLOPs
# to a model's count
NO_FLOP_OPERATORS = ("nms_suppress", "self_suppress")


# ---- FLOP formulas ----------------------------------------------------------

# Each kernel's operations, the counts its bound takes (fused_sepconv.work,
# psroi_align.work, int8_conv.conv_work / depthwise_work / quantize_work),
# as torch.utils.flop_counter.FlopCounterMode takes them: a formula gets
# the operator's arguments with every tensor replaced by its shape, and the
# output's shape (utils/roofline.count registers them). NMS's operators
# (``NO_FLOP_OPERATORS``) count none.

def _sepconv_flop(x, *args, out_shape, **kwargs) -> int:
    return int(fused_sepconv.work(*x, out_shape[-1], False)[0])


def _psroi_fwd_flop(features, rois, grid, samples, *, out_shape,
                    **kwargs) -> int:
    return int(psroi_align.work(rois[0], rois[1], features[-1], 0,
                                samples)[0])


def _psroi_bwd_flop(grad, rois, height, width, dtype, grid, samples, *,
                    out_shape, **kwargs) -> int:
    return int(psroi_align.work(rois[0], rois[1], out_shape[-1], 0,
                                samples)[0])


def _conv_flop(xq, kernel, scale, geometry, out_dtype, *, out_shape,
               **kwargs) -> int:
    return int(int8_conv.conv_work(*xq, out_shape[-1], geometry, 0)[0])


def _dwconv_flop(xq, kernel, scale, *args, out_shape, **kwargs) -> int:
    geometry = args[-2]           # int8_dwconv's and int8_dwconv_q's
    return int(int8_conv.depthwise_work(*xq, geometry, 0)[0])


def _quantize_flop(x, sx, *, out_shape, **kwargs) -> int:
    n = 1
    for d in x:
        n *= d
    return int(int8_conv.quantize_work(n, 0)[0])


# each kernel's operator (its OpOverloadPacket, as the dispatcher names
# it) -> its formula
_FLOP_FORMULAS = {
    getattr(getattr(torch.ops, NAMESPACE), name): formula
    for name, formula in (("fused_sepconv", _sepconv_flop),
                          ("psroi_align_fwd", _psroi_fwd_flop),
                          ("psroi_align_bwd", _psroi_bwd_flop),
                          ("int8_conv", _conv_flop),
                          ("int8_dwconv", _dwconv_flop),
                          ("int8_dwconv_q", _dwconv_flop),
                          ("quantize_s8", _quantize_flop))}


def flop_formulas() -> dict:
    """{operator: FLOP formula} for ``FlopCounterMode(custom_mapping=)``:
    every kernel's operator."""
    return dict(_FLOP_FORMULAS)


# ---- launch counts ----------------------------------------------------------

# the line a process prints its kernels' launch counts on (launch_line), for
# a parent that drove it as a subprocess
LAUNCHES_PREFIX = "kernel launches: "


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches, by
    the names ``chip_smoke.py``'s kernels line gives them."""
    return {"fused_sepconv": fused_sepconv.fused_separable_conv,
            "psroi_align": psroi_align.batched_psroi_align,
            "psroi_align_backward": psroi_align.psroi_align_backward,
            "int8_conv": int8_conv.int8_conv2d,
            "int8_dwconv": int8_conv.int8_depthwise_conv2d,
            "quantize_s8": int8_conv.quantize_activation,
            "nms_suppress": nms.nms_suppress}


def launch_counts() -> dict:
    """Each kernel wrapper's launch count in this process."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def launches_since(before: dict, calls: int = 1) -> dict:
    """Each kernel wrapper's launches since ``before`` (a
    :func:`launch_counts`), over ``calls`` calls: a measurement reads its
    own window's launches without resetting the counts that a caller may
    be reading."""
    return {name: (v - before[name]) / calls
            for name, v in launch_counts().items()}


def launch_line() -> str:
    """``LAUNCHES_PREFIX`` and :func:`launch_counts` as JSON."""
    return LAUNCHES_PREFIX + json.dumps(launch_counts())


def read_launch_lines(text: str) -> list:
    """The launch counts of every :func:`launch_line` in ``text``."""
    return [json.loads(line[len(LAUNCHES_PREFIX):])
            for line in text.splitlines()
            if line.startswith(LAUNCHES_PREFIX)]
