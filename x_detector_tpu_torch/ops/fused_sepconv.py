"""Fused depthwise-separable conv: dw3x3 -> 1x1 -> folded BN [+ residual]
-> ReLU, in one pass over the activation (inference, stride 1).

``fused_separable_conv`` calls the operator ``xdt::fused_sepconv``
(``ops/library.py``): on CUDA tensors its implementation
(:func:`launch_cuda`) launches a CUDA kernel, on CPU tensors it runs the
plain version ``reference_separable_conv``. Both follow one
rounding order, that of the JAX package's fused kernel: the 9 taps
accumulate in fp32 and are rounded to ``x.dtype``; the pointwise product
accumulates in fp32 over ``x.dtype`` operands; the affine, the residual and
the ReLU apply in fp32; one rounding to ``x.dtype`` on store.

Two kernels, two routes, chosen by the channel counts alone:
  - ``"tma"`` (``csrc/fused_sepconv.cu``): Cin and Cout multiples of 8, as
    every call of the model's backbone has. TMA halo tiles, a depthwise ->
    wgmma pipeline, a persistent grid; :func:`plan_launch` chooses its
    geometry here, on the host.
  - ``"wmma"`` (``csrc/fused_sepconv_wmma.cu``): the first design, for
    other channel counts (and Cin <= 1088).
Each route counts its launches in ``fused_separable_conv.route_launches``;
``fused_separable_conv.launches`` counts both.

:func:`prepare_weights` turns the layer's parameters into the operator's
operands (``wp`` in the compute dtype, transposed for the ``"tma"``
route); the model holds them as buffers (``models/layers.py``,
``SeparableConvBN.prepare_for_inference``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from x_detector_tpu_torch import _build
from x_detector_tpu_torch.utils import roofline

# The "tma" kernel's fixed geometry; it mirrors csrc/fused_sepconv.cu.
KC = 64                  # input channels per chunk
BN = 128                 # output channels per accumulator (and wp slice)
ROWS = 128               # pixel rows of a unit: the tile holds at most 128
A_BYTES = ROWS * KC * 2
WP_BYTES = BN * KC * 2
SLAB_BYTES = ROWS * 128
STAGING_BYTES = (BN // 64) * SLAB_BYTES
BAR_BYTES = 256
MAX_STAGES = 4           # ring stages wanted (the kernel takes up to 8)
SMEM_LIMIT = 232448      # dynamic shared memory a block may use (sm_90)
ROUTES = ("tma", "wmma")


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


def route_for(cin: int, cout: int) -> str:
    """The kernel that takes these channel counts on the card."""
    return "tma" if cin % 8 == 0 and cout % 8 == 0 else "wmma"


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def smem_bytes(th: int, tw: int, dilation: int, stages: int,
               bn: int = BN) -> int:
    """Dynamic shared memory of the "tma" kernel (its ``Layout``): two A
    buffers, the staging tile, ``stages`` x (halo box + the wp slices of
    ``bn`` channels), the mbarriers and 1024 bytes to align the base."""
    halo = (th + 2 * dilation) * (tw + 2 * dilation) * KC * 2
    stage = _round_up(halo, 1024) + bn // BN * WP_BYTES
    return 2 * A_BYTES + STAGING_BYTES + stages * stage + BAR_BYTES + 1024


@dataclasses.dataclass(frozen=True)
class Plan:
    """Launch geometry of the "tma" kernel for one call shape."""
    th: int                # output tile: th x tw pixels of one image
    tw: int
    stages: int            # ring stages (halo box + wp slices each)
    smem_bytes: int
    bn: int                # output channels per unit: 128 or 256
    grid: int              # persistent CTAs
    tiles_h: int
    tiles_w: int
    tiles_n: int           # bn-wide slices of Cout
    units: int             # B x tiles_h x tiles_w x tiles_n

    def unit(self, u: int):
        """(b, h0, w0, n0) of work unit ``u``, as the kernel decodes it:
        the Cout slices of one tile are consecutive units."""
        n, u = u % self.tiles_n, u // self.tiles_n
        w, u = u % self.tiles_w, u // self.tiles_w
        h, b = u % self.tiles_h, u // self.tiles_h
        return b, h * self.th, w * self.tw, n * self.bn


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def plan_launch(b: int, h: int, w: int, cin: int, cout: int, dilation: int,
                sm_count: int) -> Plan:
    """256 output channels a unit where Cout has 4, 6, ... 128-channel
    slices (each tile's depthwise then serves twice as many channels; at
    Cout = 256 the shallower ring this leaves measured slower than
    computing the depthwise twice), else 128; the tile with the fewest work
    units (dead pixels cost as much as live ones), then the smallest halo
    box; as many ring stages as fit, up to ``MAX_STAGES``; one persistent
    CTA per SM."""
    d = int(dilation)
    slices = _ceil(cout, BN)
    bn = 2 * BN if slices >= 4 and slices % 2 == 0 else BN
    best = None
    for tw in range(1, min(w, ROWS) + 1):
        th = min(ROWS // tw, h)
        if tw + 2 * d > 256 or th + 2 * d > 256:
            continue
        base = smem_bytes(th, tw, d, 0, bn)
        stages = min(MAX_STAGES, (SMEM_LIMIT - base)
                     // (smem_bytes(th, tw, d, 1, bn) - base))
        if stages < 2:
            continue
        key = (_ceil(h, th) * _ceil(w, tw), (th + 2 * d) * (tw + 2 * d), -tw)
        if best is None or key < best[0]:
            best = (key, th, tw, stages)
    if best is None:
        raise ValueError(f"fused_separable_conv: no tile of the tma kernel "
                         f"fits H={h}, W={w}, dilation={d}")
    _, th, tw, stages = best
    tiles = (_ceil(h, th), _ceil(w, tw), _ceil(cout, bn))
    units = b * tiles[0] * tiles[1] * tiles[2]
    return Plan(th, tw, stages, smem_bytes(th, tw, d, stages, bn), bn,
                min(units, sm_count), *tiles, units)


def work(b: int, h: int, w: int, cin: int, cout: int, residual: bool):
    """(operations, bytes) of one call: 2 P Cin (9 + Cout) operations (the
    depthwise's 9 multiply-adds and the pointwise product's Cout an input
    channel and pixel); bf16 x, out and residual, bf16 wp and fp32
    wd/scale/bias, each moved once."""
    p = b * h * w
    flop = 2.0 * p * cin * (9 + cout)
    nbytes = (p * (cin + cout + (cout if residual else 0)) * 2
              + cin * cout * 2 + 9 * cin * 4 + 2 * cout * 4)
    return flop, nbytes


def bound_ms(b: int, h: int, w: int, cin: int, cout: int,
             residual: bool):
    """(least ms on one H100, what binds it) for one call: :func:`work`'s
    operations at the bf16 tensor-core rate, its bytes at HBM's."""
    return roofline.bound_ms(*work(b, h, w, cin, cout, residual),
                             roofline.BF16_TENSOR_FLOP_PER_S)


def unfused_cudnn(x, wd, wp, scale, bias, *, dilation, relu, residual):
    """The yardstick for B2: the model's unfused route at one shape, bf16
    channels_last depthwise F.conv2d, then the 1x1 F.conv2d, then the
    folded BN, the residual and the ReLU: several calls, which the port
    does not take on this route. Returns a function of no arguments."""
    cin, cout = wp.shape
    d = int(dilation)
    xc = x.permute(0, 3, 1, 2)                      # channels_last NCHW
    wdc = wd.permute(2, 0, 1)[:, None].to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    wpc = wp.t()[:, :, None, None].to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    sc = scale.to(torch.bfloat16)[None, :, None, None]
    bi = bias.to(torch.bfloat16)[None, :, None, None]
    res = None if residual is None else residual.permute(0, 3, 1, 2)

    def run():
        y = F.conv2d(F.conv2d(xc, wdc, padding=d, dilation=d, groups=cin),
                     wpc) * sc + bi
        if res is not None:
            y = y + res
        return F.relu(y) if relu else y
    return run


class SepConvWeights(NamedTuple):
    """One layer's operands: ``wd`` [3, 3, Cin], ``scale`` and ``bias``
    [Cout], all fp32, and ``wp`` in the compute dtype laid out for its
    route: [Cout, Cin] for "tma", [Cin, Cout] for "wmma"."""
    wd: torch.Tensor
    wp: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor
    route: str


def prepare_weights(wd, wp, scale, bias, *, route=None,
                    dtype: torch.dtype = torch.bfloat16) -> SepConvWeights:
    """The operands of :func:`fused_separable_conv_prepared` from ``wp``
    [Cin, Cout], rounded to ``dtype`` (the activations' dtype: bf16 for
    the kernel), each contiguous. ``route`` None picks :func:`route_for`;
    "wmma" may be asked for any shape."""
    route = route or route_for(*wp.shape)
    if route not in ROUTES:
        raise ValueError(f"route {route!r} is not one of {ROUTES}")
    if route == "tma" and route_for(*wp.shape) != "tma":
        raise ValueError(f"the tma route takes Cin and Cout that are "
                         f"multiples of 8, not {tuple(wp.shape)}")
    wp = (wp.t() if route == "tma" else wp).to(dtype).contiguous()
    return SepConvWeights(wd.float().contiguous(), wp,
                          scale.float().contiguous(),
                          bias.float().contiguous(), route)


def plain_prepared(x, wd, wp, scale, bias, residual, dilation: int,
                   relu: bool, route: str):
    """``xdt::fused_sepconv`` on CPU tensors: the plain version on
    :func:`prepare_weights`'s operands."""
    if route == "tma":
        wp = wp.t().contiguous()
    return reference_separable_conv(x, wd, wp, scale, bias,
                                    dilation=dilation, relu=relu,
                                    residual=residual)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_separable_conv(x, wd, wp, scale, bias, *, dilation=1, relu=True,
                         residual=None):
    """relu((dw3x3(x; SAME, dilation) @ wp) * scale + bias [+ residual]).

    Shapes and dtypes as in :func:`reference_separable_conv`. On a CUDA
    device the kernel takes bf16 ``x`` (and ``residual``) and fp32
    ``wd``/``wp``/``scale``/``bias``; ``wp`` is rounded to ``x.dtype`` here,
    as the plain version rounds it.
    """
    return fused_separable_conv_prepared(
        x, prepare_weights(wd, wp, scale, bias, dtype=x.dtype),
        dilation=dilation, relu=relu, residual=residual)


def fused_separable_conv_prepared(x, weights: SepConvWeights, *, dilation=1,
                                  relu=True, residual=None):
    """:func:`fused_separable_conv` on operands from
    :func:`prepare_weights`: the operator ``xdt::fused_sepconv``."""
    wd, wp, scale, bias, route = weights
    b, h, w, cin = x.shape
    cout = wp.shape[0] if route == "tma" else wp.shape[1]
    shapes = {"wd": (3, 3, cin), "scale": (cout,), "bias": (cout,),
              "residual": (b, h, w, cout),
              "wp": (cout, cin) if route == "tma" else (cin, cout)}
    for name, t in (("wd", wd), ("wp", wp), ("scale", scale), ("bias", bias),
                    ("residual", residual)):
        if t is not None and tuple(t.shape) != shapes[name]:
            raise ValueError(f"fused_separable_conv: {name} has shape "
                             f"{tuple(t.shape)}, expected {shapes[name]}")
    if x.dim() != 4 or int(dilation) < 1:
        raise ValueError(f"x must be [B, H, W, C] and dilation >= 1; got "
                         f"{tuple(x.shape)}, {dilation}")
    return torch.ops.xdt.fused_sepconv.default(
        x, wd, wp, scale, bias, residual, int(dilation), bool(relu), route)


def launch_cuda(x, wd, wp, scale, bias, residual, dilation: int, relu: bool,
                route: str):
    """``xdt::fused_sepconv`` on CUDA tensors: checks what the kernels
    take, plans the "tma" route's launch (:func:`plan_launch`) and launches
    the route's kernel."""
    b, h, w, cin = x.shape
    cout = wp.shape[0] if route == "tma" else wp.shape[1]
    tensors = {"x": x, "wd": wd, "wp": wp, "scale": scale, "bias": bias}
    if residual is not None:
        tensors["residual"] = residual
    if x.device.type != "cuda":
        raise ValueError(f"fused_separable_conv: x on {x.device}; the "
                         f"kernels take CUDA tensors")
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"fused_separable_conv: {name} on {t.device}, "
                             f"x on {x.device}; need one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"fused_separable_conv: {name} not contiguous")
        want = (torch.bfloat16 if name in ("x", "residual", "wp")
                else torch.float32)
        if t.dtype != want:
            raise TypeError(f"fused_separable_conv: {name} is {t.dtype}, "
                            f"the kernel takes {want}")
    if route == "tma" and any(t.data_ptr() % 16 for t in tensors.values()):
        raise ValueError("fused_separable_conv: the tma route needs 16-byte "
                         "aligned operands")
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    res_ptr = residual.data_ptr() if residual is not None else None
    ptrs = (x.data_ptr(), wd.data_ptr(), wp.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), res_ptr, out.data_ptr())
    dims = (b, h, w, cin, cout, dilation, int(relu))
    what = f"fused_sepconv ({route})"
    if route == "tma":
        p = plan_launch(b, h, w, cin, cout, dilation,
                        _sm_count(x.device.index or 0))
        _build.launch("xdt_fused_sepconv_tma", what, x, *ptrs, *dims, p.th,
                      p.tw, p.stages, p.smem_bytes, p.bn, p.grid)
    else:
        _build.launch("xdt_fused_sepconv_wmma", what, x, *ptrs, *dims)
    fused_separable_conv.launches += 1
    fused_separable_conv.route_launches[route] += 1
    return out


def reset_launches() -> None:
    fused_separable_conv.launches = 0
    fused_separable_conv.route_launches = dict.fromkeys(ROUTES, 0)


reset_launches()
