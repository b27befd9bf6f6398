"""Fused depthwise-separable conv: dw3x3 -> 1x1 -> folded BN [+ residual]
-> ReLU, in one pass over the activation (inference, stride 1).

``fused_separable_conv`` launches the CUDA kernel ``csrc/fused_sepconv.cu``
on CUDA tensors and runs the plain version ``reference_separable_conv`` on
CPU tensors. Both follow one rounding order, that of the JAX package's fused
kernel: the 9 taps accumulate in fp32 and are rounded to ``x.dtype``; the
pointwise product accumulates in fp32 over ``x.dtype`` operands; the affine,
the residual and the ReLU apply in fp32; one rounding to ``x.dtype`` on
store.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from x_detector_tpu_torch import _build


def reference_separable_conv(x, wd, wp, scale, bias, *, dilation=1,
                             relu=True, residual=None):
    """Plain version. ``x`` [B, H, W, Cin]; ``wd`` [3, 3, Cin] fp32
    depthwise taps; ``wp`` [Cin, Cout]; ``scale``/``bias`` [Cout] fp32 folded
    BN affine; ``residual`` optional [B, H, W, Cout]. Returns
    [B, H, W, Cout] in ``x.dtype``."""
    cin = x.shape[-1]
    d = int(dilation)
    taps = F.conv2d(x.float().permute(0, 3, 1, 2),
                    wd.float().permute(2, 0, 1)[:, None], padding=d,
                    dilation=d, groups=cin)                 # fp32 taps
    t = taps.permute(0, 2, 3, 1).to(x.dtype).float()
    y = t @ wp.to(x.dtype).float()                          # fp32 accumulate
    y = y * scale.float() + bias.float()
    if residual is not None:
        y = y + residual.to(x.dtype).float()
    if relu:
        y = y.clamp_min(0.0)
    return y.to(x.dtype)


def fused_separable_conv(x, wd, wp, scale, bias, *, dilation=1, relu=True,
                         residual=None):
    """relu((dw3x3(x; SAME, dilation) @ wp) * scale + bias [+ residual]).

    Shapes and dtypes as in :func:`reference_separable_conv`. On a CUDA
    device the kernel takes bf16 ``x`` (and ``residual``) and fp32
    ``wd``/``wp``/``scale``/``bias``, all contiguous; ``wp`` is rounded to
    bf16 here, as the plain version rounds it.
    """
    if x.device.type == "cpu":
        return reference_separable_conv(x, wd, wp, scale, bias,
                                        dilation=dilation, relu=relu,
                                        residual=residual)
    b, h, w, cin = x.shape
    cout = wp.shape[-1]
    tensors = {"x": x, "wd": wd, "wp": wp, "scale": scale, "bias": bias}
    if residual is not None:
        tensors["residual"] = residual
    for name, t in tensors.items():
        if t.device != x.device or x.device.type != "cuda":
            raise ValueError(f"fused_separable_conv: {name} on {t.device}, "
                             f"x on {x.device}; need one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"fused_separable_conv: {name} not contiguous")
        want = (torch.bfloat16 if name in ("x", "residual")
                else torch.float32)
        if t.dtype != want:
            raise TypeError(f"fused_separable_conv: {name} is {t.dtype}, "
                            f"the kernel takes {want}")
    shapes = {"wd": (3, 3, cin), "wp": (cin, cout), "scale": (cout,),
              "bias": (cout,), "residual": (b, h, w, cout)}
    for name, t in tensors.items():
        if name != "x" and tuple(t.shape) != shapes[name]:
            raise ValueError(f"fused_separable_conv: {name} has shape "
                             f"{tuple(t.shape)}, expected {shapes[name]}")
    if x.dim() != 4 or int(dilation) < 1:
        raise ValueError(f"x must be [B, H, W, C] and dilation >= 1; got "
                         f"{tuple(x.shape)}, {dilation}")
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    wp16 = wp.to(x.dtype)          # the kernel's pointwise operand type
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.xdt_fused_sepconv_bf16(
            x.data_ptr(), wd.data_ptr(), wp16.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), residual.data_ptr() if residual is not None
            else None, out.data_ptr(), b, h, w, cin, cout, int(dilation),
            int(bool(relu)), stream)
    _build.check(err, "fused_sepconv")
    fused_separable_conv.launches += 1
    return out


fused_separable_conv.launches = 0
