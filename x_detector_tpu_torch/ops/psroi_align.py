"""PSROIAlign: position-sensitive RoI-align pooling, forward and backward.

Semantics (those of ``x_detector_tpu/ops/psroi_align.py``):
  * ``features``: [B, H, W, k*k*C]; channel group g = i*k + j serves bin
    (i, j), with C innermost.
  * ``rois``: [B, R, 4] normalized corners [ymin, xmin, ymax, xmax].
  * Each of the k x k bins is sampled at S x S uniform points with RoIAlign
    continuous coordinates ``norm * extent - 0.5``, clamped to
    ``[0, extent - 1]``, read bilinearly and averaged.
  * Output: [B, R, k, k, C] float32.

``batched_psroi_align`` calls the operator ``xdt::psroi_align_fwd`` and
``psroi_align_backward`` calls ``xdt::psroi_align_bwd`` (``ops/library.py``);
the forward's gradient is the backward operator. The dispatcher picks the
implementation from the tensors' device: on CUDA tensors the kernels of
``csrc/psroi_align.cu`` (:func:`forward_cuda`, :func:`backward_cuda`); on CPU
tensors the plain versions ``psroi_align_reference`` (a gather) and
``psroi_align_backward_reference`` (the transposed contractions of the JAX
package's ``_bwd``). The gradient goes to the features only, in their dtype
(fp32 sums, one rounding on store); the rois get none.

The kernels' launches are planned here, on the host: the forward's (threads,
rois per block, the paired-channel path, the tap table's shared memory) by
:func:`plan_forward`, the backward's (pixel tile, threads, list capacity,
shared memory) by :func:`plan_backward`.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from x_detector_tpu_torch import _build
from x_detector_tpu_torch.utils import roofline

# The backward kernel's compiled pixel tile (TH, TW) and limits; they
# mirror csrc/psroi_align.cu.
BACKWARD_TILE = (5, 10)
BACKWARD_MAX_THREADS = 512     # one thread per channel of the tile
BACKWARD_MAX_GRID = 32         # bins per axis: one bit each in a mask
BACKWARD_MAX_SAMPLES = 4
SMEM_LIMIT = 232448            # dynamic shared memory a block may use (sm_90)
SMEM_PER_SM = 233472           # what an SM shares among its blocks, 1 KB each
_COUNT_BYTES = 32 * 4          # the kernel's warp counts
_WORK_BYTES = 32 * 32 * 4      # and its warps' work lists
_ENTRY_BYTES = 16              # per listed roi: its index and bin masks
# The forward kernel's limits and defaults; they mirror csrc/psroi_align.cu.
FORWARD_MAX_THREADS = 512
FORWARD_THREADS = 256
FORWARD_LANES_PER_THREAD = 2   # a block takes rois for ~2 lanes a thread
FORWARD_TAP_BYTES = 24         # a Tap: two int64 offsets, two fp32 weights
_INT_MAX = 2 ** 31 - 1


def _sample_coords(rois: torch.Tensor, grid: int, samples: int, extent: int,
                   axis0: int, axis1: int) -> torch.Tensor:
    """Continuous pixel coords of every sample along one axis:
    rois [..., R, 4] -> [..., R, grid, samples], clamped to [0, extent-1]."""
    lo = rois[..., axis0][..., None, None]
    hi = rois[..., axis1][..., None, None]
    span = (hi - lo) / grid
    cell = torch.arange(grid, dtype=rois.dtype, device=rois.device)[:, None]
    sub = (torch.arange(samples, dtype=rois.dtype, device=rois.device)
           + 0.5) / samples
    norm = lo + (cell + sub) * span
    return (norm * extent - 0.5).clamp(0.0, extent - 1.0)


def _interp_weights(coords: torch.Tensor, extent: int) -> torch.Tensor:
    """[..., k, S] sample coords -> [..., k, extent] triangular weights
    ``sum_s relu(1 - |p - coord_s|)``."""
    pix = torch.arange(extent, dtype=coords.dtype, device=coords.device)
    return (1.0 - (pix - coords[..., None]).abs()).clamp_min(0.0).sum(-2)


def psroi_align_reference(features: torch.Tensor, rois: torch.Tensor,
                          grid: int = 7, samples: int = 2) -> torch.Tensor:
    """Plain gather version: [B, H, W, k*k*C] x [B, R, 4] -> [B, R, k, k, C]
    float32, four bilinear taps per sample, in float32."""
    b, h, w, kkc = features.shape
    c = kkc // (grid * grid)
    feat = features.float().reshape(b, h * w * grid * grid, c)
    rois = rois.float()
    ys = _sample_coords(rois, grid, samples, h, 0, 2)   # [B, R, k, S]
    xs = _sample_coords(rois, grid, samples, w, 1, 3)
    y0 = ys.floor().clamp(0, h - 1)
    x0 = xs.floor().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    fy = (ys - y0)[:, :, :, :, None, None]               # [B, R, k, S, 1, 1]
    fx = (xs - x0)[:, :, None, None, :, :]               # [B, R, 1, 1, k, S]
    ar = torch.arange(grid, device=features.device)
    group = ar[:, None, None, None] * grid + ar[None, None, :, None]  # k1k1
    bidx = torch.arange(b, device=features.device)[:, None, None, None, None,
                                                    None]

    def tap(yi, xi):
        pix = (yi.long()[:, :, :, :, None, None] * w
               + xi.long()[:, :, None, None, :, :])      # [B, R, k, S, k, S]
        return feat[bidx, pix * (grid * grid) + group]   # [..., C]

    acc = (((1 - fy) * (1 - fx))[..., None] * tap(y0, x0)
           + ((1 - fy) * fx)[..., None] * tap(y0, x1)
           + (fy * (1 - fx))[..., None] * tap(y1, x0)
           + (fy * fx)[..., None] * tap(y1, x1))
    return acc.mean(dim=(3, 5))                          # [B, R, k, k, C]


@dataclasses.dataclass(frozen=True)
class ForwardPlan:
    """Launch geometry of the forward kernel: ``blocks_per_image`` blocks
    an image of ``threads`` threads, each block ``rois_per_block`` rois
    (the last of an image fewer) and their ``lanes_per_roi`` lanes of work,
    one channel a lane, or two with ``paired``; with ``tabled`` the rois'
    taps in ``smem_bytes`` of shared memory."""
    threads: int
    rois_per_block: int
    paired: bool
    tabled: bool
    smem_bytes: int
    blocks_per_image: int
    lanes_per_roi: int

    def rois(self, block: int, r: int):
        """(image, first roi, rois) of block ``block``, as the kernel
        decodes blockIdx.x, for ``r`` rois an image."""
        b, u = divmod(block, self.blocks_per_image)
        r0 = u * self.rois_per_block
        return b, r0, min(self.rois_per_block, r - r0)


def forward_table_bytes(grid: int, samples: int) -> int:
    """Shared memory of one roi's taps: k*S samples along y and along x."""
    return 2 * grid * samples * FORWARD_TAP_BYTES


@functools.lru_cache(maxsize=None)
def plan_forward(b: int, r: int, grid: int, c: int, samples: int,
                 aligned: bool, rois_per_block: int = 0,
                 threads: int = FORWARD_THREADS) -> ForwardPlan:
    """Pairs of channels where C is even and the features are aligned to
    two elements (``aligned``); enough rois a block for about
    FORWARD_LANES_PER_THREAD lanes a thread (or ``rois_per_block``), as
    far as their taps fit the shared memory a block may use; taps made by
    each lane only where one roi's table exceeds it."""
    if grid < 1 or c < 1 or samples < 1 or r < 1 or b < 1:
        raise ValueError(f"psroi_align: nothing to plan for B={b}, R={r}, "
                         f"grid={grid}, C={c}, samples={samples}")
    if not 32 <= threads <= FORWARD_MAX_THREADS or threads % 32:
        raise ValueError(f"psroi_align: {threads} threads a block")
    paired = c % 2 == 0 and aligned
    lanes_per_roi = grid * grid * (c // 2 if paired else c)
    table = forward_table_bytes(grid, samples)
    tabled = table <= SMEM_LIMIT
    if not rois_per_block:
        rois_per_block = FORWARD_LANES_PER_THREAD * threads // lanes_per_roi
    if tabled:
        rois_per_block = min(rois_per_block, SMEM_LIMIT // table)
    # a block's lanes are counted in int32, blockDim.x past the last
    rois_per_block = max(1, min(rois_per_block, r, (
        _INT_MAX - FORWARD_MAX_THREADS) // lanes_per_roi))
    blocks_per_image = _ceil(r, rois_per_block)
    if b * blocks_per_image > _INT_MAX:
        raise ValueError(f"psroi_align: {b} x {blocks_per_image} blocks")
    threads = min(threads, _ceil(rois_per_block * lanes_per_roi, 32) * 32)
    return ForwardPlan(threads, rois_per_block, paired, tabled,
                       rois_per_block * table if tabled else 0,
                       blocks_per_image, lanes_per_roi)


def forward_cuda(features: torch.Tensor, rois: torch.Tensor, grid: int,
                 samples: int) -> torch.Tensor:
    """``xdt::psroi_align_fwd`` on CUDA tensors: checks what the kernel
    takes, plans the launch (:func:`plan_forward`) and launches it."""
    if features.device.type != "cuda" or rois.device != features.device:
        raise ValueError(f"batched_psroi_align: features on {features.device}"
                         f", rois on {rois.device}; need both on one CUDA "
                         "device (or the CPU)")
    if features.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"features must be bf16 or fp32, got {features.dtype}")
    if rois.dtype != torch.float32:
        raise TypeError(f"rois must be fp32, got {rois.dtype}")
    b, h, w, kkc = features.shape
    if not (features.is_contiguous() and rois.is_contiguous()):
        raise ValueError("features and rois must be contiguous")
    r, c = rois.shape[1], kkc // (grid * grid)
    out = torch.empty((b, r, grid, grid, c), dtype=torch.float32,
                      device=features.device)
    if out.numel() == 0:
        return out
    # a view may start at any element: pairs only from an aligned pointer
    pair = 2 * features.element_size()
    plan = plan_forward(b, r, grid, c, samples,
                        features.data_ptr() % pair == 0)
    _build.launch(
        "xdt_psroi_align_fwd", "psroi_align", features, features.data_ptr(),
        rois.data_ptr(), out.data_ptr(),
        int(features.dtype == torch.bfloat16), b, h, w, r, grid, c, samples,
        plan.threads, plan.rois_per_block, int(plan.paired),
        int(plan.tabled), plan.smem_bytes)
    batched_psroi_align.launches += 1
    return out


def psroi_align_backward_reference(grad: torch.Tensor, rois: torch.Tensor,
                                   height: int, width: int,
                                   dtype: torch.dtype, grid: int = 7,
                                   samples: int = 2) -> torch.Tensor:
    """Plain backward: upstream [B, R, k, k, C] x rois [B, R, 4] -> the
    features' gradient [B, H, W, k*k*C] in ``dtype``, as the JAX package's
    ``_bwd`` computes it: ``sum_r wy[r,i,p] * (g[r,i,j,c] * wx[r,j,q])``
    in fp32, times 1/S^2, one rounding to ``dtype``."""
    b, r, k, _, c = grad.shape
    rois = rois.float()
    wy = _interp_weights(_sample_coords(rois, grid, samples, height, 0, 2),
                         height)                            # [B, R, k, H]
    wx = _interp_weights(_sample_coords(rois, grid, samples, width, 1, 3),
                         width)                             # [B, R, k, W]
    gw2 = torch.einsum("brijc,brjq->brijqc", grad.float(), wx)
    dfeat = torch.einsum("brip,brijqc->bpqijc", wy, gw2) * (
        1.0 / float(samples * samples))
    return dfeat.reshape(b, height, width, k * k * c).to(dtype)


# rois per image that config 4's OHEM keeps (ohem_topk): the rows of the
# backward's upstream gradient that are not zero in a train step
OHEM_KEEP = 256


def ohem_shaped(gen: torch.Generator, g: torch.Tensor, keep: int = OHEM_KEEP):
    """``g`` [B, R, ...] with all but ``keep`` rows per image, chosen by
    ``gen``, set to zero (+0.0 and -0.0 alternately by roi): the upstream
    gradient of PSROIAlign in a train step, where OHEM keeps ``ohem_topk``
    rois. Returns it and the kept rows' indices [B, keep], in order."""
    b, r = g.shape[:2]
    kept = torch.rand(b, r, generator=gen, device=g.device).argsort(dim=1)[
        :, :keep].sort(dim=1).values
    mask = torch.zeros(b, r, dtype=torch.bool, device=g.device)
    mask.scatter_(1, kept, True)
    zero = torch.where(torch.arange(r, device=g.device) % 2 == 0, 0.0, -0.0)
    shape = (b, r) + (1,) * (g.dim() - 2)
    return torch.where(mask.view(shape), g, zero.view((1,) + shape[1:])), kept


def backward_smem_bytes(th: int, tw: int, grid: int, cap: int) -> int:
    """Dynamic shared memory of the backward kernel for a list of ``cap``
    rois: the warp counts and work lists, then per roi its index, its row
    and column bin masks and its weights over the tile's rows and columns
    (each row of weights padded to 4 floats)."""
    pad4 = lambda n: _ceil(n, 4) * 4
    return _COUNT_BYTES + _WORK_BYTES + cap * (
        _ENTRY_BYTES + 4 * grid * (pad4(th) + pad4(tw)))


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """Launch geometry of the backward kernel: blocks (tiles_h * tiles_w,
    passes, B) of ``threads`` threads, each block a th x tw pixel tile and
    ``threads`` of the k*k*C channels."""
    th: int
    tw: int
    threads: int
    passes: int            # blocks along the channels
    cap: int               # rois the shared-memory list holds
    smem_bytes: int
    tiles_h: int
    tiles_w: int

    def tile(self, u: int):
        """(row0, col0) of tile ``u``, as the kernel decodes blockIdx.x."""
        return u // self.tiles_w * self.th, u % self.tiles_w * self.tw


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def plan_backward(h: int, w: int, r: int, grid: int, c: int
                  ) -> BackwardPlan:
    """One thread per channel up to 512, further channels in further
    blocks; a roi list as long as the shared memory of the blocks an SM
    can hold allows, and at most what R needs."""
    if not 1 <= grid <= BACKWARD_MAX_GRID:
        raise ValueError(f"psroi_align_backward: grid {grid} outside "
                         f"1..{BACKWARD_MAX_GRID}")
    th, tw = BACKWARD_TILE
    kkc = grid * grid * c
    threads = min(BACKWARD_MAX_THREADS, _ceil(kkc, 32) * 32)
    per_sm = min(4, BACKWARD_MAX_THREADS // threads)
    budget = min(SMEM_LIMIT, SMEM_PER_SM // per_sm - 1024)
    fixed = backward_smem_bytes(th, tw, grid, 0)
    per_roi = backward_smem_bytes(th, tw, grid, 1) - fixed
    cap = min((budget - fixed) // per_roi // 32 * 32, _ceil(r, 32) * 32)
    return BackwardPlan(th, tw, threads, _ceil(kkc, threads), cap,
                        backward_smem_bytes(th, tw, grid, cap),
                        _ceil(h, th), _ceil(w, tw))


def psroi_align_backward(grad: torch.Tensor, rois: torch.Tensor,
                         height: int, width: int, dtype: torch.dtype,
                         grid: int = 7, samples: int = 2) -> torch.Tensor:
    """The features' gradient [B, H, W, k*k*C] in ``dtype`` (bf16 or fp32)
    from the upstream gradient [B, R, k, k, C]: the operator
    ``xdt::psroi_align_bwd``. CPU tensors take the plain version; CUDA
    tensors launch the deterministic tiled kernel (:func:`backward_cuda`)."""
    b, r = rois.shape[:2]
    if tuple(grad.shape[:4]) != (b, r, grid, grid) or grad.dim() != 5:
        raise ValueError(f"grad {tuple(grad.shape)} / rois "
                         f"{tuple(rois.shape)} do not fit grid {grid}")
    return torch.ops.xdt.psroi_align_bwd.default(grad, rois, height, width,
                                                 dtype, grid, samples)


def backward_cuda(grad: torch.Tensor, rois: torch.Tensor, height: int,
                  width: int, dtype: torch.dtype, grid: int,
                  samples: int) -> torch.Tensor:
    """``xdt::psroi_align_bwd`` on CUDA tensors (fp32 sums in roi order,
    one rounding on store, no atomics): a pre-pass writes each roi's sample
    extents (empty for a zero gradient row) into scratch, then the tiles
    run with :func:`plan_backward`'s plan."""
    if grad.device.type != "cuda" or rois.device != grad.device:
        raise ValueError(f"psroi_align_backward: grad on {grad.device}, "
                         f"rois on {rois.device}; need one CUDA device")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the features' dtype must be bf16 or fp32, got "
                        f"{dtype}")
    b, r = rois.shape[:2]
    c = grad.shape[-1]
    grad = grad.float().contiguous()
    if grad.shape != (b, r, grid, grid, c) or rois.dtype != torch.float32:
        raise ValueError(f"grad {tuple(grad.shape)} / rois "
                         f"{tuple(rois.shape)} {rois.dtype} do not fit")
    if c > 32 or samples > BACKWARD_MAX_SAMPLES:
        raise ValueError(f"the backward kernel takes C <= 32 and samples "
                         f"<= 4, got C={c}, samples={samples}")
    out = torch.empty((b, height, width, grid * grid * c), dtype=dtype,
                      device=grad.device)
    if out.numel() == 0:
        return out
    if r == 0:
        return out.zero_()
    plan = plan_backward(height, width, r, grid, c)
    rois = rois.contiguous()
    ext = torch.empty(b * r, 4, dtype=torch.float32, device=grad.device)
    _build.launch(
        "xdt_psroi_align_bwd", "psroi_align_backward", grad,
        grad.data_ptr(), rois.data_ptr(), out.data_ptr(), ext.data_ptr(),
        int(dtype == torch.bfloat16), b, height, width, r, grid, c, samples,
        plan.threads, plan.cap, plan.smem_bytes)
    psroi_align_backward.launches += 1
    return out


def _check_forward_shapes(features: torch.Tensor, rois: torch.Tensor,
                         grid: int) -> None:
    """What every implementation of the forward takes: [B, H, W, k*k*C]
    features and [B, R, 4] rois."""
    if features.dim() != 4 or rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(f"bad shapes {tuple(features.shape)} / "
                         f"{tuple(rois.shape)}")
    kkc = features.shape[-1]
    if grid < 1 or kkc % (grid * grid) or rois.shape[0] != features.shape[0]:
        raise ValueError(f"{kkc} channels do not split into {grid}x{grid} "
                         f"groups, or batch {features.shape[0]} != "
                         f"{rois.shape[0]}")


def batched_psroi_align(features: torch.Tensor, rois: torch.Tensor,
                        grid: int = 7, samples: int = 2) -> torch.Tensor:
    """[B, H, W, k*k*C] (bf16 or fp32) x [B, R, 4] fp32 -> [B, R, k, k, C]
    fp32, differentiable in ``features`` (its backward is
    ``xdt::psroi_align_bwd``). CPU tensors take the plain versions; CUDA
    tensors launch the kernels, which read bf16 or fp32 features and
    accumulate in fp32."""
    _check_forward_shapes(features, rois, grid)
    return torch.ops.xdt.psroi_align_fwd.default(features, rois, grid,
                                                 samples)


def work(b: int, r: int, kkc: int, map_bytes: int, samples: int = 2):
    """(operations, bytes) of the forward or the backward at B images of R
    rois on a map of k*k*C channels: per fp32 bin, samples^2 bilinear
    points of 4 fp32 multiply-adds; the map (``map_bytes``, read or
    written) and the fp32 bins each move once, and the rois are read
    once."""
    bins = b * r * kkc
    return bins * samples * samples * 4 * 2.0, map_bytes + b * r * 16 + (
        bins * 4)


def bound_ms(features: torch.Tensor, rois: torch.Tensor, samples: int = 2):
    """``roofline.bound_ms``'s (least ms, what binds) of the forward or
    the backward at these shapes (:func:`work`), at the fp32 rate."""
    return roofline.bound_ms(
        *work(rois.shape[0], rois.shape[1], features.shape[-1],
              features.numel() * features.element_size(), samples),
        roofline.FP32_FLOP_PER_S)


batched_psroi_align.launches = 0
psroi_align_backward.launches = 0
