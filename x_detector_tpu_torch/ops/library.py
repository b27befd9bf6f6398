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
  ``xdt::self_suppress``      NMS's host-checked fixpoint (``ops/nms.py``;
                              plain PyTorch on both devices, no kernel)
  ==========================  ==========================================

Each operator has a fake implementation (output shapes and dtypes, which
``torch.export`` traces through), a CPU implementation (the plain version)
and a CUDA one (the kernel's launch, which counts it). The dispatcher picks
the implementation from the tensors' device: a CUDA tensor always reaches
the kernel, which launches or raises, and nothing falls back to the plain
version. A graph exported from the model holds one opaque node per call, so
a program loaded with ``torch.export.load`` launches the same kernels as
eager code; the loading process must have imported this module first
(``serving.py`` does).

The package's ``ops/__init__.py`` imports this module, so the operators are
registered whenever any module of ``ops`` is.
"""

from __future__ import annotations

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

def _self_suppress_fake(mask):
    return mask.new_empty(mask.shape[:2], dtype=torch.bool)


_define("self_suppress(Tensor mask) -> Tensor", _self_suppress_fake,
        nms.self_suppress, nms.self_suppress)

OPERATORS = ("psroi_align_fwd", "psroi_align_bwd", "fused_sepconv",
             "int8_conv", "int8_dwconv", "int8_dwconv_q", "quantize_s8",
             "self_suppress")
