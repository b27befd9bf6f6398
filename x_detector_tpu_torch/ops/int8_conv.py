"""int8 convolutions of the post-training-quantized backbone.

The port of QuantConv's int8 arithmetic (``x_detector_tpu/models/
layers.py:155-185``): an int8 ``lax.conv_general_dilated`` with int32
accumulation there, three kernels of ``csrc/int8_conv.cu`` here:

  * :func:`quantize_activation` (K3): ``clip(round(x / sx), -127, 127)``
    to int8, rounding half to even, dividing (never multiplying by
    ``1 / sx``);
  * :func:`int8_conv2d` (K1): a dense conv of int8 NHWC activations and
    OHWI weights, any kernel, stride, dilation and explicit pads, summed
    in int32 and dequantized as ``dtype(float(acc) * scale[cout])``; two
    routes, chosen by :func:`plan_conv` from the call's shape: "tma"
    (``csrc/int8_conv_tma.cu``, wgmma on TMA-loaded tiles, split-K) for
    every call whose Cin is a multiple of 16 and whose ``xq`` is 16-byte
    aligned, "mma" (``csrc/int8_conv.cu``, the first design) for the rest
    (the stems: Cin 3 and 12);
  * :func:`int8_depthwise_conv2d` (K2): the depthwise 3x3, the same
    epilogue; two routes, chosen by :func:`plan_depthwise` from the
    call's shape: "tma" (``csrc/int8_dwconv_tma.cu``, TMA-loaded halo
    boxes, dp4a, TMA-stored runs) for every call whose C is a multiple of
    16, whose stride and dilation are 1 or 2 and whose operands are
    16-byte aligned, "simt" (``csrc/int8_conv.cu``, the first design) for
    the rest; and :func:`int8_depthwise_conv2d_quantized`, K2 with K3's
    quantize on its store (the separable blocks' pointwise input), on the
    "tma" route only.

Each calls its operator (``xdt::quantize_s8``, ``xdt::int8_conv``,
``xdt::int8_dwconv``, ``xdt::int8_dwconv_q``; ``ops/library.py``), which
launches the kernel on CUDA tensors (or raises on what the kernel does not
take: :func:`quantize_cuda`, :func:`conv_cuda`, :func:`dwconv_cuda`,
:func:`dwconv_q_cuda`) and runs the plain version on CPU tensors. The
plain versions sum the same integers exactly in float64 (|sum| <= 127^2 *
4608 for ResNet's 3x3 x 512, far under 2^53) and round
as the kernels do, so a kernel equals its plain version bit for bit at
every shape. Each wrapper counts its launches in ``<wrapper>.launches``;
``int8_conv2d.route_launches`` counts K1's by route,
``int8_depthwise_conv2d.route_launches`` and ``.mode_launches`` K2's by
route and by mode ("dequant", "quantize"; both wrappers count into
``int8_depthwise_conv2d``, the one kernel).

:func:`quantize_weight` is the per-output-channel weight quantization, run
by ``models.layers.QuantConv`` when it prepares its operands and by
``quant.prequantize``; :func:`prepare_weight` lays the int8 weight out as
the operators take it, on every device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from x_detector_tpu_torch import _build
from x_detector_tpu_torch.utils import roofline

Pads = Tuple[Tuple[int, int], Tuple[int, int]]

QMAX = 127
ACT_EPS = 1e-6           # sx = max(act_amax, ACT_EPS) / 127
WEIGHT_EPS = 1e-8        # sw = max(max|k|, WEIGHT_EPS) / 127
# K1's bytes of K a pipeline stage (csrc/int8_conv.cu): Kp pads K to it
KBK = 64
# the depthwise weight operand's rows (prepare_weight): 9 + 12
DW_KERNEL_ROWS = 21
_INT_MAX = 2 ** 31 - 1
# K1's "tma" route (csrc/int8_conv_tma.cu): bytes of K a chunk, output rows
# a tile, ring stages at most, shared memory a block may take, and the
# shared memory besides the ring (staging tiles, mbarriers and row table,
# alignment slack)
TMA_KC = 128
TMA_BM = 128
TMA_MAX_STAGES = 8
TMA_SMEM_LIMIT = 232448
TMA_FIXED_SMEM = 2 * TMA_BM * 128 + 2048 + 1024
TMA_MAX_SPLITS = 8       # a split tile's cluster: at most 8 blocks
SM_COUNT = 132           # an H100 SXM's SMs: the plan's default
# K2's "tma" route (csrc/int8_dwconv_tma.cu): channels a unit, output
# columns a lane's run, consumer warps a block at most, ring stages at
# most, bytes a box stage keeps past the box, mbarrier bytes; a run's
# output rows are 8 / stride
DW_CB = 128
DW_QUAD = 4
DW_MAX_WARPS = 14
DW_MAX_STAGES = 4
DW_BOX_SLACK = 512
DW_BAR_BYTES = 1024


def ieee_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded as IEEE division. On the card PyTorch divides a
    tensor by a Python number as a multiply by its fp32 reciprocal, which
    rounds other values; a divisor tensor on ``a``'s device does not."""
    return a / torch.full_like(a, b)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 weights: ``w`` [Cout, ...] fp32 ->
    (``clip(round(w / sw), -127, 127)`` int8 of ``w``'s shape, ``sw``
    [Cout] fp32 with ``sw = max(max|w| over the rest, 1e-8) / 127``)."""
    w = w.float()
    amax = w.abs().amax(dim=tuple(range(1, w.dim())))
    sw = ieee_div(amax.clamp_min(WEIGHT_EPS), float(QMAX))
    wq = torch.round(w / sw.reshape(-1, *([1] * (w.dim() - 1))))
    return wq.clamp_(-QMAX, QMAX).to(torch.int8), sw


def activation_scale(act_amax: torch.Tensor) -> torch.Tensor:
    """sx = max(act_amax, 1e-6) / 127, fp32, on ``act_amax``'s device."""
    return ieee_div(act_amax.float().clamp_min(ACT_EPS), float(QMAX))


# ---- K3: the activation quantizer -------------------------------------------

def quantize_activation_reference(x: torch.Tensor,
                                  sx: torch.Tensor) -> torch.Tensor:
    """Plain version: int8 ``clip(round(x / sx), -127, 127)`` of a bf16 or
    fp32 ``x``, ``sx`` a one-element fp32 tensor on ``x``'s device."""
    q = torch.round(x.float() / sx.reshape(()))
    return q.clamp_(-QMAX, QMAX).to(torch.int8)


def quantize_activation(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """int8 of ``x``'s shape: the operator ``xdt::quantize_s8``. On the
    card ``x`` is contiguous bf16 or fp32 and ``sx`` a one-element fp32
    tensor on the same device, read there (no host sync)."""
    if sx.numel() != 1:
        raise ValueError(f"quantize_activation: sx must be one value, got "
                         f"{tuple(sx.shape)}")
    return torch.ops.xdt.quantize_s8.default(x, sx)


def quantize_cuda(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """``xdt::quantize_s8`` on CUDA tensors: K3."""
    _same_cuda_device("quantize_activation", x, sx=sx)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quantize_activation: x is {x.dtype}; the kernel "
                        f"takes bf16 or fp32")
    if sx.dtype != torch.float32 or sx.numel() != 1:
        raise ValueError(f"quantize_activation: sx must be one fp32 value, "
                         f"got {sx.dtype} {tuple(sx.shape)}")
    if not x.is_contiguous():
        raise ValueError("quantize_activation: x not contiguous")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    n = x.numel()
    if n == 0:
        return q
    if n > _INT_MAX:
        raise ValueError(f"quantize_activation: {n} elements, the kernel "
                         f"takes < 2^31")
    vec = 8 if x.data_ptr() % 16 == 0 and q.data_ptr() % 8 == 0 else 1
    _build.launch("xdt_quantize_s8", "quantize_activation", x, x.data_ptr(),
                  sx.data_ptr(), q.data_ptr(), int(x.dtype == torch.bfloat16),
                  n, vec)
    quantize_activation.launches += 1
    return q


# ---- the weights ------------------------------------------------------------

class Int8Weight(NamedTuple):
    """One conv's int8 weight as the operators take it on every device:
    ``kernel`` [Cout, Kp] for the dense conv (OHWI flattened, K =
    kh*kw*Cin padded with zeros to a multiple of 64) or [21, C] for the
    depthwise 3x3 (:func:`prepare_weight`); ``ksize`` (kh, kw)."""
    kernel: torch.Tensor
    ksize: Tuple[int, int]
    depthwise: bool


def prepare_weight(wq: torch.Tensor, depthwise: bool) -> Int8Weight:
    """``wq`` int8 OHWI ([C, 3, 3, 1] for a depthwise 3x3) -> the operands
    of :func:`int8_conv2d` / :func:`int8_depthwise_conv2d`."""
    if wq.dtype != torch.int8 or wq.dim() != 4:
        raise ValueError(f"wq must be int8 [Cout, kh, kw, Cin], got "
                         f"{wq.dtype} {tuple(wq.shape)}")
    if depthwise and tuple(wq.shape[1:]) != (3, 3, 1):
        raise ValueError(f"the depthwise kernel takes a 3x3 of one channel a "
                         f"group: [C, 3, 3, 1], got {tuple(wq.shape)}")
    if depthwise:
        taps = wq[:, :, :, 0]                                # [C, 3, 3]
        # rows 0-8: the taps by tap, channels fastest (the "simt" route);
        # rows 9-20: channel c's tap row i as the word (w_i0, w_i1, w_i2,
        # 0) at byte 12c + 4i (the "tma" route's registers)
        rows = F.pad(taps, (0, 1)).reshape(-1)
        kernel = torch.cat([taps.permute(1, 2, 0).reshape(-1), rows]
                           ).reshape(DW_KERNEL_ROWS, -1)
    else:
        k = wq[0].numel()
        kernel = F.pad(wq.reshape(wq.shape[0], k),
                       (0, _round_up(k, KBK) - k))
    return Int8Weight(kernel.contiguous(), tuple(wq.shape[1:3]), depthwise)


def unpack_weight(kernel: torch.Tensor, ksize: Sequence[int], cin: int,
                  depthwise: bool) -> torch.Tensor:
    """:func:`prepare_weight`'s ``kernel`` back to the int8 OHWI weight of
    the plain versions."""
    if depthwise:
        return kernel[:9].t().reshape(-1, 3, 3, 1)
    kh, kw = ksize
    return kernel[:, :kh * kw * cin].reshape(-1, kh, kw, cin)


def unpack_tma_taps(kernel: torch.Tensor) -> torch.Tensor:
    """The "tma" rows (9-20) of a depthwise ``kernel`` back to the int8
    [C, 3, 3, 1] weight, the zero fourth byte of each tap row dropped."""
    return kernel[9:].reshape(-1, 3, 4)[:, :, :3].reshape(-1, 3, 3, 1)


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def output_size(size: Sequence[int], kernel: Sequence[int],
                stride: Sequence[int], dilation: Sequence[int],
                pads: Pads) -> Tuple[int, int]:
    """(Ho, Wo) of a conv with explicit ((top, bottom), (left, right))
    pads."""
    return tuple((n + lo + hi - d * (k - 1) - 1) // s + 1 for n, k, s, d,
                 (lo, hi) in zip(size, kernel, stride, dilation, pads))


def conv_geometry(ksize: Sequence[int], stride: Sequence[int],
                  dilation: Sequence[int], pads: Pads) -> list:
    """A call's geometry as the operators take it, one ``int[]``: [kh, kw,
    sh, sw, dh, dw, top, bottom, left, right]; stride and dilation >= 1,
    pads >= 0."""
    (top, bottom), (left, right) = pads
    geometry = [int(v) for v in (*ksize, *stride, *dilation, top, bottom,
                                 left, right)]
    if len(geometry) != 10 or min(geometry[2:6]) < 1 or min(
            geometry[6:]) < 0:
        raise ValueError(f"ksize {tuple(ksize)}, stride {tuple(stride)} and "
                         f"dilation {tuple(dilation)} must be pairs >= 1 and "
                         f"pads {pads} >= 0")
    return geometry


def _same_cuda_device(what: str, x: torch.Tensor, **tensors) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x on {x.device}; the kernels take CUDA "
                         f"tensors (the CPU takes the plain versions)")
    for name, t in tensors.items():
        if t is None or t.device != x.device:
            raise ValueError(f"{what}: {name} on "
                             f"{None if t is None else t.device}, x on "
                             f"{x.device}; need one CUDA device")


def _check_operands(what: str, xq, kernel, scale, out_dtype):
    """What the kernels take, on top of the shapes the wrappers check."""
    _same_cuda_device(what, xq, weight=kernel, scale=scale)
    if xq.dtype != torch.int8 or not xq.is_contiguous():
        raise ValueError(f"{what}: xq must be contiguous int8 [B, H, W, C], "
                         f"got {xq.dtype} {tuple(xq.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: the kernel writes bf16 or fp32, not "
                        f"{out_dtype}")
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        raise ValueError(f"{what}: scale must be contiguous fp32, got "
                         f"{scale.dtype}")
    if kernel.dtype != torch.int8 or not kernel.is_contiguous():
        raise ValueError(f"{what}: the weight operand must be contiguous "
                         f"int8, got {kernel.dtype}")


def check_operand_shapes(what: str, x_shape: Sequence[int],
                         kernel: torch.Tensor, scale: torch.Tensor,
                         geometry: Sequence[int], depthwise: bool) -> None:
    """What every implementation takes: [B, H, W, C] ``xq``, the weight
    operand of :func:`prepare_weight` for a ``geometry``'s kernel size
    (a depthwise one a 3x3 of square stride and dilation) and a [Cout]
    ``scale``. Checked by the wrappers before the operators, and by
    ``QuantConv`` once an input shape."""
    if len(x_shape) != 4:
        raise ValueError(f"{what}: xq must be [B, H, W, C], got "
                         f"{tuple(x_shape)}")
    c = x_shape[-1]
    if depthwise:
        _square_3x3(what, geometry)
        check_dw_operand_shapes(what, c, kernel, scale)
        return
    cout = kernel.shape[0]
    expected = (cout, _round_up(geometry[0] * geometry[1] * c, KBK))
    if tuple(kernel.shape) != expected:
        raise ValueError(f"{what}: xq has {c} channels, the weight operand "
                         f"is {tuple(kernel.shape)}, not {expected}")
    if tuple(scale.shape) != (cout,):
        raise ValueError(f"{what}: scale must be [{cout}], got "
                         f"{tuple(scale.shape)}")


def check_dw_operand_shapes(what: str, c, kernel: torch.Tensor,
                            scale: torch.Tensor) -> None:
    """The depthwise weight operand and scale of a C-channel input:
    [DW_KERNEL_ROWS, C] and [C]. Checked by every implementation of both
    depthwise operators (fake, CPU and CUDA): the "tma" route reads rows
    9-20, which an operand of the 9-row layout (a container exported
    before those rows were added) does not hold."""
    if tuple(kernel.shape) != (DW_KERNEL_ROWS, c):
        raise ValueError(
            f"{what}: the depthwise weight operand must be "
            f"[{DW_KERNEL_ROWS}, {c}] (prepare_weight), got "
            f"{tuple(kernel.shape)}" + (
                "; a 9-row operand is the older layout without the tma "
                "route's rows: prepare the weight again, or export the "
                "model again" if tuple(kernel.shape) == (9, c) else ""))
    if tuple(scale.shape) != (c,):
        raise ValueError(f"{what}: scale must be [{c}], got "
                         f"{tuple(scale.shape)}")


def _pairs(geometry: Sequence[int]) -> Pads:
    return ((geometry[6], geometry[7]), (geometry[8], geometry[9]))


def _dequantize(acc: torch.Tensor, scale: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    """The epilogue the kernels round by: fp32 of the exact sum, times the
    fp32 scale, rounded once to ``out_dtype``."""
    return (acc.float() * scale).to(out_dtype)


# ---- K1: the dense conv -----------------------------------------------------

def int8_conv2d_reference(xq: torch.Tensor, wq: torch.Tensor,
                          scale: torch.Tensor, *, stride: Sequence[int],
                          dilation: Sequence[int], pads: Pads,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version: ``xq`` [B, H, W, Cin] int8 NHWC, ``wq`` [Cout, kh, kw,
    Cin] int8 OHWI, ``scale`` [Cout] fp32 -> [B, Ho, Wo, Cout] in
    ``out_dtype``. One float64 matmul a tap, summed: exact."""
    b, h, w, cin = xq.shape
    cout, kh, kw, _ = wq.shape
    (sh, sw), (dh, dw) = stride, dilation
    ho, wo = output_size((h, w), (kh, kw), stride, dilation, pads)
    (top, bottom), (left, right) = pads
    x = F.pad(xq.to(torch.float64), (0, 0, left, right, top, bottom))
    wt = wq.to(torch.float64)
    acc = torch.zeros(b, ho, wo, cout, dtype=torch.float64, device=xq.device)
    for i in range(kh):
        for j in range(kw):
            tap = x[:, i * dh:i * dh + (ho - 1) * sh + 1:sh,
                    j * dw:j * dw + (wo - 1) * sw + 1:sw]
            acc += tap @ wt[:, i, j].t()
    return _dequantize(acc, scale, out_dtype)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """K1's launch for one call shape. ``route``: "tma"
    (``csrc/int8_conv_tma.cu``) or "mma" (``csrc/int8_conv.cu``, the first
    design); ``bn``: output channels a tile (64 or 128 on "mma"; 64, 128
    or 256 on "tma"). "mma" only: ``vec``, the bytes of an A-tile copy (16,
    8, 4 or 1: the largest that divides Cin and the address of ``xq``).
    "tma" only: ``form`` "gemm" (1x1, stride 1, no pads: A is [B*H*W,
    Cin]) or "conv" (a ``th`` x ``tw`` tile of output pixels of one image),
    ``stages`` of the ring, ``splits`` of K, ``smem_bytes``, ``grid``
    (persistent blocks), and as the kernel counts them ``tiles`` (output
    tiles of 128 rows x ``bn`` channels) and ``chunks`` (128-byte K chunks
    a tile)."""
    route: str
    bn: int
    vec: int = 0
    form: str = ""
    th: int = 0
    tw: int = 0
    stages: int = 0
    splits: int = 1
    smem_bytes: int = 0
    grid: int = 0
    tiles: int = 0
    chunks: int = 0


def plan_mma(cin: int, cout: int, x_ptr: int = 0) -> ConvPlan:
    """The first design's launch: 64 channels a block up to Cout 64, else
    128; the A copy the largest of 16, 8, 4, 1 bytes dividing Cin and the
    address."""
    vec = next(v for v in (16, 8, 4, 1) if cin % v == 0 and x_ptr % v == 0)
    return ConvPlan("mma", 64 if cout <= 64 else 128, vec)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def conv_tile(ho: int, wo: int, sh: int, sw: int) -> Tuple[int, int]:
    """The conv form's output tile (th, tw): at most 128 pixels, a TMA box
    of at most 256 rows and columns at the stride; the fewest tiles over
    the map, then the widest (Wo 16-128 tiles exactly: 8 x 16 ... 1 x 128;
    50 and 100 take 5 x 25)."""
    best = None
    for tw in range(1, min(wo, TMA_BM, 256 // sw) + 1):
        th = min(TMA_BM // tw, ho, 256 // sh)
        key = (_cdiv(ho, th) * _cdiv(wo, tw), -tw)
        if best is None or key < best[0]:
            best = (key, (th, tw))
    return best[1]


def split_count(tiles: int, chunks: int, sm_count: int) -> int:
    """Slices of K for a call of ``tiles`` output tiles of ``chunks`` K
    chunks each (a tile's slices are one thread-block cluster): the most
    that keep the (tile, slice) units within one wave of the SMs (tiles x
    S <= ``sm_count``), at most one a chunk and 8, so 1 where the tiles
    alone fill more than half the SMs. A split that needs a second wave
    costs more than it saves (``int8_conv_variants.py``)."""
    return max(1, min(chunks, TMA_MAX_SPLITS, sm_count // tiles))


def plan_tma(x_shape: Sequence[int], cout: int, geometry: Sequence[int],
             sm_count: int = SM_COUNT) -> ConvPlan:
    """The "tma" route's launch for [B, H, W, Cin] ``x_shape``, ``cout``
    output channels and ``geometry`` (:func:`conv_geometry`)."""
    b, h, w, cin = x_shape
    kh, kw, sh, sw, dh, dw = geometry[:6]
    ho, wo = output_size((h, w), (kh, kw), (sh, sw), (dh, dw),
                         _pairs(geometry))
    cchunks = _cdiv(cin, TMA_KC)
    if (kh, kw, sh, sw) == (1, 1, 1, 1) and not any(geometry[6:]):
        form, (th, tw), chunks = "gemm", (0, 0), cchunks
        spatial = _cdiv(b * ho * wo, TMA_BM)
    else:
        form, (th, tw) = "conv", conv_tile(ho, wo, sh, sw)
        chunks = kh * kw * cchunks
        spatial = b * _cdiv(ho, th) * _cdiv(wo, tw)
    # 256 channels a tile where Cout is a multiple of 256 and the tiles
    # still fill the SMs; where they would not, 128: twice the tiles, so
    # half the slices of K, whose partials are half as large
    if cout <= 64:
        bn = 64
    elif cout <= 128 or cout % 256 or spatial * cout // 256 < sm_count:
        bn = 128
    else:
        bn = 256
    tiles = spatial * _cdiv(cout, bn)
    splits = split_count(tiles, chunks, sm_count)
    stages, smem_bytes = tma_ring(bn)
    return ConvPlan("tma", bn, form=form, th=th, tw=tw, stages=stages,
                    splits=splits, smem_bytes=smem_bytes,
                    grid=min(tiles * splits, sm_count), tiles=tiles,
                    chunks=chunks)


def with_width(plan: ConvPlan, cout: int, bn: int,
               splits: int) -> ConvPlan:
    """"tma" ``plan`` with ``bn`` channels a tile and ``splits`` slices of
    K, a plan the rule does not pick (``int8_conv_variants.py`` times
    them; a split's units must fit one wave of the SMs)."""
    tiles = plan.tiles // _cdiv(cout, plan.bn) * _cdiv(cout, bn)
    stages, smem_bytes = tma_ring(bn)
    return dataclasses.replace(
        plan, bn=bn, tiles=tiles, splits=splits, stages=stages,
        smem_bytes=smem_bytes, grid=min(tiles * splits, sm_count(0)))


def tma_ring(bn: int) -> Tuple[int, int]:
    """(stages, shared-memory bytes) of the "tma" route at ``bn`` channels
    a tile: as many stages of an A and a B tile as fit, at most 8."""
    stage = TMA_BM * TMA_KC + bn * TMA_KC
    stages = min(TMA_MAX_STAGES, (TMA_SMEM_LIMIT - TMA_FIXED_SMEM) // stage)
    return stages, TMA_FIXED_SMEM + stages * stage


@functools.lru_cache(maxsize=None)
def _plan(x_shape: Tuple[int, ...], cout: int, geometry: Tuple[int, ...],
          x_align: int, sm_count: int) -> ConvPlan:
    if x_shape[3] % 16 == 0 and x_align == 0:
        return plan_tma(x_shape, cout, geometry, sm_count)
    return plan_mma(x_shape[3], cout, x_align)


def plan_conv(x_shape: Sequence[int], cout: int, geometry: Sequence[int],
              x_ptr: int = 0, sm_count: int = SM_COUNT) -> ConvPlan:
    """K1's route and launch for one call, by a rule on its shape: "tma"
    where Cin is a multiple of 16 and ``xq`` (at ``x_ptr``) is 16-byte
    aligned (TMA's rules for a global stride and address; the output is
    allocated aligned, and both routes need an aligned weight, which
    :func:`conv_cuda` checks), "mma" for the rest. Computed once
    per (shape, Cout, geometry, alignment, SM count) and cached."""
    return _plan(tuple(x_shape), int(cout), tuple(geometry), x_ptr % 16,
                 sm_count)


def int8_conv2d(xq: torch.Tensor, weight: Int8Weight, scale: torch.Tensor,
                *, stride: Sequence[int] = (1, 1),
                dilation: Sequence[int] = (1, 1), pads: Pads = ((0, 0),
                                                                (0, 0)),
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``dtype(float(conv(xq, wq)) * scale)``: [B, H, W, Cin] int8 with a
    prepared weight (:func:`prepare_weight`) -> [B, Ho, Wo, Cout], the
    operator ``xdt::int8_conv``."""
    if weight.depthwise:
        raise ValueError("int8_conv2d: a depthwise weight; use "
                         "int8_depthwise_conv2d")
    geometry = conv_geometry(weight.ksize, stride, dilation, pads)
    check_operand_shapes("int8_conv2d", xq.shape, weight.kernel, scale,
                         geometry, False)
    return torch.ops.xdt.int8_conv.default(xq, weight.kernel, scale,
                                           geometry, out_dtype)


def conv_plain(xq, kernel, scale, geometry, out_dtype):
    """``xdt::int8_conv`` on CPU tensors: the plain version."""
    return int8_conv2d_reference(
        xq, unpack_weight(kernel, geometry[:2], xq.shape[-1], False), scale,
        stride=geometry[2:4], dilation=geometry[4:6], pads=_pairs(geometry),
        out_dtype=out_dtype)


def conv_output(xq, cout, geometry, out_dtype):
    """An empty [B, Ho, Wo, ``cout``] output of ``xdt::int8_conv`` or
    ``xdt::int8_dwconv``."""
    ho, wo = output_size(xq.shape[1:3], geometry[:2], geometry[2:4],
                         geometry[4:6], _pairs(geometry))
    return torch.empty((xq.shape[0], max(ho, 0), max(wo, 0), cout),
                       dtype=out_dtype, device=xq.device)


def check_weight_aligned(w_ptr: int) -> None:
    """K1's weight operand starts on 16 bytes: the "tma" route's tensor map
    and the "mma" route's 16-byte copies both need it, so no route takes
    a weight that does not (:func:`prepare_weight` allocates it so)."""
    if w_ptr % 16:
        raise ValueError(f"int8_conv2d: the weight operand starts {w_ptr % 16}"
                         f" bytes past a 16-byte boundary; both K1 routes "
                         f"need it aligned (prepare_weight allocates it so)")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv_cuda(xq, kernel, scale, geometry, out_dtype):
    """``xdt::int8_conv`` on CUDA tensors: K1, on the route that
    :func:`plan_conv` gives the call's shape."""
    _check_operands("int8_conv2d", xq, kernel, scale, out_dtype)
    check_weight_aligned(kernel.data_ptr())
    out = conv_output(xq, kernel.shape[0], geometry, out_dtype)
    if out.numel() == 0:
        return out
    b, ho, wo = out.shape[:3]
    if b * ho * wo > _INT_MAX:
        raise ValueError(f"int8_conv2d: {b * ho * wo} output pixels, the "
                         f"kernel takes < 2^31")
    plan = plan_conv(xq.shape, kernel.shape[0], geometry, xq.data_ptr(),
                     sm_count(xq.get_device()))
    return run_plan(plan, xq, kernel, scale, geometry, out)


def run_plan(plan: ConvPlan, xq, kernel, scale, geometry, out):
    """K1 on CUDA tensors by ``plan`` into ``out`` (:func:`conv_output`),
    counted in ``int8_conv2d.launches`` and its route's
    ``int8_conv2d.route_launches``."""
    b, h, w, cin = xq.shape
    cout, kp = kernel.shape
    ho, wo = out.shape[1:3]
    kh, kw, sh, sw, dh, dw, top, _, left, _ = geometry
    args = (xq.data_ptr(), kernel.data_ptr(), scale.data_ptr(),
            out.data_ptr())
    shape = (int(out.dtype == torch.bfloat16), b, h, w, cin, ho, wo, cout,
             kh, kw, sh, sw, dh, dw, top, left, kp)
    if plan.route == "tma":
        _build.launch(
            "xdt_int8_conv_tma", "int8_conv2d", xq, *args, *shape,
            int(plan.form == "gemm"), plan.th, plan.tw, plan.bn, plan.stages,
            plan.splits, plan.smem_bytes, plan.grid)
    else:
        _build.launch("xdt_int8_conv", "int8_conv2d", xq, *args, *shape,
                      plan.bn, plan.vec)
    int8_conv2d.launches += 1
    int8_conv2d.route_launches[plan.route] += 1
    return out


# ---- K2: the depthwise 3x3 --------------------------------------------------

def int8_depthwise_conv2d_reference(xq: torch.Tensor, wq: torch.Tensor,
                                    scale: torch.Tensor, *, stride: int,
                                    dilation: int, pads: Pads,
                                    out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version: ``xq`` [B, H, W, C] int8, ``wq`` [C, 3, 3, 1] int8,
    ``scale`` [C] fp32 -> [B, Ho, Wo, C] in ``out_dtype``; float64 sums of
    the 9 products, exact."""
    s, d = int(stride), int(dilation)
    ho, wo = output_size(xq.shape[1:3], (3, 3), (s, s), (d, d), pads)
    (top, bottom), (left, right) = pads
    x = F.pad(xq.to(torch.float64), (0, 0, left, right, top, bottom))
    wt = wq.to(torch.float64)
    acc = torch.zeros(xq.shape[0], ho, wo, xq.shape[3], dtype=torch.float64,
                      device=xq.device)
    for i in range(3):
        for j in range(3):
            acc += (x[:, i * d:i * d + (ho - 1) * s + 1:s,
                      j * d:j * d + (wo - 1) * s + 1:s] * wt[:, i, j, 0])
    return _dequantize(acc, scale, out_dtype)


def depthwise_vec(c: int, *ptrs: int) -> int:
    """K2's channels a thread on the "simt" route: 16, 4 or 1, the largest
    that divides C and the addresses."""
    return next(v for v in (16, 4, 1)
                if c % v == 0 and all(p % v == 0 for p in ptrs))


@dataclasses.dataclass(frozen=True)
class DepthwisePlan:
    """K2's launch for one call shape. ``route``: "tma"
    (``csrc/int8_dwconv_tma.cu``) or "simt" (``csrc/int8_conv.cu``, the
    first design). "simt" only: ``vec``, channels a thread. "tma" only: a
    tile of ``th`` x ``tw`` output pixels and 128 channels a unit, ``qw``
    x ``rr`` runs of ``rh`` rows x 4 columns a tile (a consumer warp
    each), the input ``box`` (rows, columns), the ring's ``stages``,
    ``smem_bytes``, ``units`` and ``grid`` (persistent blocks)."""
    route: str
    vec: int = 0
    qw: int = 0
    rr: int = 0
    rh: int = 0
    th: int = 0
    tw: int = 0
    box: Tuple[int, int] = (0, 0)
    stages: int = 0
    smem_bytes: int = 0
    units: int = 0
    grid: int = 0


def fuses_quantize(c: int, stride: int, dilation: int) -> bool:
    """Whether a depthwise call of C channels, ``stride`` and ``dilation``
    is of the shapes the "tma" route takes (C a multiple of 16, stride and
    dilation 1 or 2), and so the shapes whose K2 may quantize on its store
    (``models.layers.SeparableConvBN``)."""
    return c % 16 == 0 and stride in (1, 2) and dilation in (1, 2)


def dw_first_use(r: int, stride: int, dilation: int, rh: int) -> int:
    """The kernel's ``first_use``: the first of a run's ``rh`` output rows
    that reads input row ``r`` of the run, or ``rh``."""
    return next((o for o in range(rh) for i in range(3)
                 if o * stride + i * dilation == r), rh)


def dw_tile_smem(qw: int, rr: int, stride: int, dilation: int,
                 out_bytes: int, stages: int) -> Tuple[int, Tuple[int, int]]:
    """(shared-memory bytes, input box (rows, columns)) of a "tma" block of
    ``qw`` x ``rr`` runs: ``stages`` boxes of 128 channels, each rounded up
    to 1024 bytes after the slack a run may read past it, a staging run a
    warp, the mbarriers and 1024 bytes to align the base (the kernel's
    layout)."""
    rh = 8 // stride
    th, tw = rr * rh, qw * DW_QUAD
    box = ((th - 1) * stride + 2 * dilation + 1,
           (tw - 1) * stride + 2 * dilation + 1)
    stage = _round_up(box[0] * box[1] * DW_CB + DW_BOX_SLACK, 1024)
    staging = qw * rr * rh * DW_QUAD * DW_CB * out_bytes
    return stages * stage + staging + DW_BAR_BYTES + 1024, box


# warps a block needs before the estimate counts the kernel as bound by
# its instruction count, not latency
DW_LATENCY_WARPS = 8


def dw_ranked(x_shape: Sequence[int], geometry: Sequence[int],
              sm_count: int = SM_COUNT, out_bytes: int = 2) -> list:
    """The "tma" route's tiles of qw x rr runs (4 to DW_MAX_WARPS warps)
    whose ring of at least 2 stages fits one block an SM, as ((estimate,
    units, warps), qw, rr), least estimated time first: the units a block
    takes, times the warps (at least DW_LATENCY_WARPS: fewer hide no
    latency), times a run's instructions (3 x 4 x 4 x 2 an output row's
    products and 64 its epilogue, 12 a column word of an input row loaded
    and transposed); a tie to the fewer units, then warps."""
    b, h, w, c = x_shape
    stride, dilation = geometry[2], geometry[4]
    ho, wo = output_size((h, w), (3, 3), (stride, stride),
                         (dilation, dilation), _pairs(geometry))
    rh = 8 // stride
    words = _cdiv(3 * stride + 2 * dilation + 1, 4)
    rows = sum(dw_first_use(r, stride, dilation, rh) < rh
               for r in range((rh - 1) * stride + 2 * dilation + 1))
    run_cost = rh * (96 + 64) + rows * 12 * words
    ranked = []
    for warps in range(4, DW_MAX_WARPS + 1):
        for rr in range(1, warps + 1):
            if warps % rr:
                continue
            qw = warps // rr
            smem, box = dw_tile_smem(qw, rr, stride, dilation, out_bytes, 2)
            if smem > TMA_SMEM_LIMIT or max(box) > 256:
                continue
            units = b * _cdiv(ho, rr * rh) * _cdiv(wo, qw * DW_QUAD) * (
                _cdiv(c, DW_CB))
            est = _cdiv(units, min(units, sm_count)) * max(
                warps, DW_LATENCY_WARPS) * run_cost
            ranked.append(((est, units, warps), qw, rr))
    return sorted(ranked)


def plan_dw_tma(x_shape: Sequence[int], geometry: Sequence[int],
                sm_count: int = SM_COUNT, out_bytes: int = 2
                ) -> DepthwisePlan:
    """The "tma" route's launch for [B, H, W, C] ``x_shape``: the first
    tile of :func:`dw_ranked`, with as many ring stages as fit, at most
    4."""
    _, qw, rr = dw_ranked(x_shape, geometry, sm_count, out_bytes)[0]
    return dw_plan_with(x_shape, geometry, qw, rr, out_bytes, sm_count)


def dw_plan_with(x_shape: Sequence[int], geometry: Sequence[int], qw: int,
                 rr: int, out_bytes: int = 2,
                 sm_count: int = SM_COUNT) -> DepthwisePlan:
    """The "tma" plan of a tile of ``qw`` x ``rr`` runs, one persistent
    block an SM (``int8_dwconv_variants.py`` times tiles the rule does not
    pick): as many ring stages (2-4) as fit in a block's shared memory;
    ValueError where 2 do not."""
    b, h, w, c = x_shape
    stride, dilation = geometry[2], geometry[4]
    ho, wo = output_size((h, w), (3, 3), (stride, stride),
                         (dilation, dilation), _pairs(geometry))
    rh = 8 // stride
    fits = [st for st in range(2, DW_MAX_STAGES + 1) if dw_tile_smem(
        qw, rr, stride, dilation, out_bytes, st)[0] <= TMA_SMEM_LIMIT]
    if not fits:
        raise ValueError(f"a {qw} x {rr} tile at stride {stride}, dilation "
                         f"{dilation} takes more than {TMA_SMEM_LIMIT} "
                         f"bytes")
    smem, box = dw_tile_smem(qw, rr, stride, dilation, out_bytes, fits[-1])
    units = b * _cdiv(ho, rr * rh) * _cdiv(wo, qw * DW_QUAD) * (
        _cdiv(c, DW_CB))
    return DepthwisePlan("tma", qw=qw, rr=rr, rh=rh, th=rr * rh,
                         tw=qw * DW_QUAD, box=box, stages=fits[-1],
                         smem_bytes=smem, units=units,
                         grid=min(units, sm_count))


@functools.lru_cache(maxsize=None)
def _plan_dw(x_shape: Tuple[int, ...], geometry: Tuple[int, ...],
             aligns: Tuple[int, ...], sm_count: int,
             out_bytes: int) -> DepthwisePlan:
    c = x_shape[3]
    if fuses_quantize(c, geometry[2], geometry[4]) and not any(aligns):
        return plan_dw_tma(x_shape, geometry, sm_count, out_bytes)
    return DepthwisePlan("simt", vec=depthwise_vec(c, aligns[0],
                                                   aligns[1]))


def plan_depthwise(x_shape: Sequence[int], geometry: Sequence[int],
                   ptrs: Sequence[int] = (0, 0, 0, 0, 0),
                   sm_count: int = SM_COUNT,
                   out_bytes: int = 2) -> DepthwisePlan:
    """K2's route and launch for one call, by a rule on its shape: "tma"
    where C is a multiple of 16, stride and dilation are 1 or 2
    (:func:`fuses_quantize`) and the operands' addresses ``ptrs`` (xq, the
    weight operand's rows 0 and 9, the scale, the output) are 16-byte
    aligned (TMA's rules for a global address and stride; the taps and
    scale are read 16 bytes at a time); "simt" for the rest. Computed once
    per (shape, geometry, alignments, SM count, output bytes) and
    cached."""
    return _plan_dw(tuple(x_shape), tuple(geometry),
                    tuple(p % 16 for p in ptrs), sm_count, out_bytes)


def int8_depthwise_conv2d(xq: torch.Tensor, weight: Int8Weight,
                          scale: torch.Tensor, *, stride: int = 1,
                          dilation: int = 1, pads: Pads = ((1, 1), (1, 1)),
                          out_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """The depthwise 3x3 of :func:`int8_conv2d`, square ``stride`` and
    ``dilation``: [B, H, W, C] int8 -> [B, Ho, Wo, C], the operator
    ``xdt::int8_dwconv``."""
    geometry = _depthwise_geometry("int8_depthwise_conv2d", xq, weight,
                                   scale, stride, dilation, pads)
    return torch.ops.xdt.int8_dwconv.default(xq, weight.kernel, scale,
                                             geometry, out_dtype)


def int8_depthwise_conv2d_quantized(
        xq: torch.Tensor, weight: Int8Weight, scale: torch.Tensor,
        sx_out: torch.Tensor, *, stride: int = 1, dilation: int = 1,
        pads: Pads = ((1, 1), (1, 1)),
        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """:func:`int8_depthwise_conv2d`'s output in ``dtype`` quantized at the
    next conv's one-element ``sx_out`` as :func:`quantize_activation` does
    it, in one kernel: int8 [B, Ho, Wo, C], the operator
    ``xdt::int8_dwconv_q``."""
    geometry = _depthwise_geometry("int8_depthwise_conv2d_quantized", xq,
                                   weight, scale, stride, dilation, pads)
    if sx_out.numel() != 1:
        raise ValueError(f"int8_depthwise_conv2d_quantized: sx_out must be "
                         f"one value, got {tuple(sx_out.shape)}")
    return torch.ops.xdt.int8_dwconv_q.default(xq, weight.kernel, scale,
                                               sx_out, geometry, dtype)


def _depthwise_geometry(what, xq, weight, scale, stride, dilation, pads):
    if not weight.depthwise:
        raise ValueError(f"{what}: a dense weight; use int8_conv2d")
    s, d = int(stride), int(dilation)
    geometry = conv_geometry((3, 3), (s, s), (d, d), pads)
    check_operand_shapes(what, xq.shape, weight.kernel, scale, geometry,
                         True)
    return geometry


def _square_3x3(what: str, geometry: Sequence[int]) -> Tuple[int, int]:
    """(stride, dilation) of a depthwise call's ``geometry``."""
    kh, kw, sh, sw, dh, dw = geometry[:6]
    if (kh, kw) != (3, 3) or sh != sw or dh != dw:
        raise ValueError(f"{what}: the depthwise kernel takes a 3x3 of "
                         f"square stride and dilation, got {geometry}")
    return sh, dh


def dwconv_plain(xq, kernel, scale, geometry, out_dtype):
    """``xdt::int8_dwconv`` on CPU tensors: the plain version."""
    s, d = _square_3x3("int8_depthwise_conv2d", geometry)
    check_dw_operand_shapes("int8_depthwise_conv2d", xq.shape[-1], kernel,
                            scale)
    return int8_depthwise_conv2d_reference(
        xq, unpack_weight(kernel, (3, 3), xq.shape[-1], True), scale,
        stride=s, dilation=d, pads=_pairs(geometry), out_dtype=out_dtype)


def dwconv_q_plain(xq, kernel, scale, sx_out, geometry, dtype):
    """``xdt::int8_dwconv_q`` on CPU tensors: the two plain versions
    composed, K2's in ``dtype`` then K3's."""
    return quantize_activation_reference(
        dwconv_plain(xq, kernel, scale, geometry, dtype), sx_out
    ).contiguous()


def dwconv_cuda(xq, kernel, scale, geometry, out_dtype):
    """``xdt::int8_dwconv`` on CUDA tensors: K2, on the route that
    :func:`plan_depthwise` gives the call's shape."""
    out = _dwconv_output("int8_depthwise_conv2d", xq, kernel, scale,
                         geometry, out_dtype, out_dtype)
    if out.numel() == 0:
        return out
    plan = _dw_plan(xq, kernel, scale, geometry, out)
    return run_dw_plan(plan, xq, kernel, scale, None, geometry, out,
                       out_dtype)


def dwconv_q_cuda(xq, kernel, scale, sx_out, geometry, dtype):
    """``xdt::int8_dwconv_q`` on CUDA tensors: K2 quantizing on its store,
    on the "tma" route; a call that :func:`plan_depthwise` gives the first
    design ("simt", which has no such mode) raises."""
    what = "int8_depthwise_conv2d_quantized"
    out = _dwconv_output(what, xq, kernel, scale, geometry, dtype,
                         torch.int8)
    _same_cuda_device(what, xq, sx_out=sx_out)
    if sx_out.dtype != torch.float32 or sx_out.numel() != 1:
        raise ValueError(f"{what}: sx_out must be one fp32 value, got "
                         f"{sx_out.dtype} {tuple(sx_out.shape)}")
    if out.numel() == 0:
        return out
    plan = _dw_plan(xq, kernel, scale, geometry, out)
    if plan.route != "tma":
        raise ValueError(
            f"{what}: quantizing on the store runs on the tma route only: C "
            f"a multiple of 16, stride and dilation 1 or 2, 16-byte aligned "
            f"operands; got C {xq.shape[3]}, geometry {list(geometry)}")
    return run_dw_plan(plan, xq, kernel, scale, sx_out, geometry, out,
                       dtype)


def _dwconv_output(what, xq, kernel, scale, geometry, dtype, out_dtype):
    _check_operands(what, xq, kernel, scale, dtype)
    check_dw_operand_shapes(what, xq.shape[3], kernel, scale)
    _square_3x3(what, geometry)
    out = conv_output(xq, xq.shape[3], geometry, out_dtype)
    if out.numel() > _INT_MAX:
        raise ValueError(f"{what}: {out.numel()} outputs, the kernel takes "
                         f"< 2^31")
    return out


def _dw_plan(xq, kernel, scale, geometry, out) -> DepthwisePlan:
    c = xq.shape[3]
    return plan_depthwise(
        xq.shape, geometry, (xq.data_ptr(), kernel.data_ptr(),
                             kernel.data_ptr() + 9 * c, scale.data_ptr(),
                             out.data_ptr()),
        sm_count(xq.get_device()), out.element_size())


def dw_tma_args(plan: DepthwisePlan, xq, kernel, scale, sx_out, geometry,
                out, dtype) -> tuple:
    """``xdt_int8_dwconv_tma``'s arguments (the stream aside) for a "tma"
    ``plan`` (mode 0 / 1: bf16 / fp32 out; 2 / 3: int8 quantized from bf16
    / fp32 ``dtype`` at ``sx_out``)."""
    b, h, w, c = xq.shape
    mode = int(dtype != torch.bfloat16) + (2 if sx_out is not None else 0)
    return (xq.data_ptr(), kernel.data_ptr() + 9 * c, scale.data_ptr(),
            0 if sx_out is None else sx_out.data_ptr(), out.data_ptr(), mode,
            b, h, w, c, *out.shape[1:3], geometry[2], geometry[4],
            geometry[6], geometry[8], plan.qw, plan.rr, plan.stages,
            plan.smem_bytes, plan.grid)


def run_dw_plan(plan: DepthwisePlan, xq, kernel, scale, sx_out, geometry,
                out, dtype):
    """K2 on CUDA tensors by ``plan`` into ``out`` (``dtype`` the output's,
    or with ``sx_out`` the module dtype that int8 ``out`` is quantized
    from), counted in ``int8_depthwise_conv2d.launches``, its route's
    ``route_launches`` and its mode's ``mode_launches``."""
    if plan.route == "tma":
        _build.launch("xdt_int8_dwconv_tma", "int8_depthwise_conv2d", xq,
                      *dw_tma_args(plan, xq, kernel, scale, sx_out, geometry,
                                   out, dtype))
    else:
        b, h, w, c = xq.shape
        _build.launch(
            "xdt_int8_dwconv", "int8_depthwise_conv2d", xq, xq.data_ptr(),
            kernel.data_ptr(), scale.data_ptr(), out.data_ptr(),
            int(dtype == torch.bfloat16), b, h, w, c, *out.shape[1:3],
            geometry[2], geometry[4], geometry[6], geometry[8], plan.vec)
    fn = int8_depthwise_conv2d
    fn.launches += 1
    fn.route_launches[plan.route] += 1
    fn.mode_launches["dequant" if sx_out is None else "quantize"] += 1
    return out


def quantize_forms(v: torch.Tensor, sx: torch.Tensor):
    """(K2's quantize on its store, K3's) of fp32 CUDA ``v`` at one-element
    ``sx``, each int8 of ``v``'s shape: the "tma" route's division-free
    form (``csrc/int8_dwconv_tma.cu``) and K3's ``__fdiv_rn`` form, which
    the card tests hold equal."""
    _same_cuda_device("quantize_forms", v, sx=sx)
    if v.dtype != torch.float32 or not v.is_contiguous() or (
            sx.dtype != torch.float32 or sx.numel() != 1):
        raise ValueError("quantize_forms: contiguous fp32 v and one fp32 sx")
    fast, exact = (torch.empty(v.shape, dtype=torch.int8, device=v.device)
                   for _ in range(2))
    _build.launch("xdt_int8_quantize_forms", "quantize_forms", v,
                  v.data_ptr(), v.numel(), sx.data_ptr(), fast.data_ptr(),
                  exact.data_ptr())
    return fast, exact


# ---- bounds on one H100 -----------------------------------------------------

def input_extent(n: int, n_out: int, k: int, s: int, d: int,
                 pad: int) -> int:
    """Rows (or columns) of an ``n``-long input axis that some tap of some
    of ``n_out`` outputs reads (``k`` taps, stride ``s``, dilation ``d``,
    ``pad`` before): a strided 1x1 reads only its stride's grid."""
    return len({o * s - pad + i * d for o in range(n_out)
                for i in range(k)}.intersection(range(n)))


def _input_bytes(b: int, h: int, w: int, c: int, geometry: Sequence[int]):
    """(int8 bytes of a [B, H, W, C] input that a conv of ``geometry``
    reads, Ho, Wo)."""
    kh, kw, sh, sw, dh, dw, top, _, left, _ = geometry
    ho, wo = output_size((h, w), (kh, kw), (sh, sw), (dh, dw),
                         _pairs(geometry))
    rows = input_extent(h, ho, kh, sh, dh, top)
    cols = input_extent(w, wo, kw, sw, dw, left)
    return b * rows * cols * c, ho, wo


def conv_work(b: int, h: int, w: int, cin: int, cout: int,
              geometry: Sequence[int], out_bytes: int):
    """(int8 operations, bytes) of one K1 call: 2 M N K (K = kh kw Cin);
    the input pixels that some tap reads, the weight, the fp32 scale and
    the output each moved once."""
    read, ho, wo = _input_bytes(b, h, w, cin, geometry)
    m, k = b * ho * wo, geometry[0] * geometry[1] * cin
    nbytes = read + cout * k + 4 * cout + m * cout * out_bytes
    return 2.0 * m * cout * k, nbytes


def conv_bound_ms(b: int, h: int, w: int, cin: int, cout: int,
                  geometry: Sequence[int], out_bytes: int):
    """(least ms, what binds) of one K1 call: :func:`conv_work` at the
    tensor cores' int8 rate."""
    return roofline.bound_ms(*conv_work(b, h, w, cin, cout, geometry,
                                        out_bytes),
                             roofline.INT8_TENSOR_OPS_PER_S)


def depthwise_work(b: int, h: int, w: int, c: int, geometry: Sequence[int],
                   out_bytes: int):
    """(operations, bytes) of one K2 call: 9 multiply-adds an output; the
    input pixels that some tap reads, the 9 x C taps, the scale and the
    output each moved once."""
    read, ho, wo = _input_bytes(b, h, w, c, geometry)
    nbytes = read + 9 * c + 4 * c + b * ho * wo * c * out_bytes
    return 2.0 * 9 * b * ho * wo * c, nbytes


def depthwise_bound_ms(b: int, h: int, w: int, c: int,
                       geometry: Sequence[int], out_bytes: int):
    """K2: :func:`depthwise_work` on the CUDA cores (at the fp32 rate, the
    table's rate outside the tensor cores)."""
    return roofline.bound_ms(*depthwise_work(b, h, w, c, geometry,
                                             out_bytes),
                             roofline.FP32_FLOP_PER_S)


def quantize_work(n: int, in_bytes: int):
    """(operations, bytes) of one K3 call: one division an element; the
    input read and the int8 written once."""
    return float(n), n * (in_bytes + 1)


def quantize_bound_ms(n: int, in_bytes: int):
    """K3: :func:`quantize_work` at the fp32 rate."""
    return roofline.bound_ms(*quantize_work(n, in_bytes),
                             roofline.FP32_FLOP_PER_S)


def reset_launches() -> None:
    for fn in (quantize_activation, int8_conv2d, int8_depthwise_conv2d):
        fn.launches = 0
    int8_conv2d.route_launches = {"tma": 0, "mma": 0}
    int8_depthwise_conv2d.route_launches = {"tma": 0, "simt": 0}
    int8_depthwise_conv2d.mode_launches = {"dequant": 0, "quantize": 0}


reset_launches()
