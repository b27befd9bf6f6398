"""PSROIAlign: position-sensitive RoI-align pooling (forward).

Semantics (those of ``x_detector_tpu/ops/psroi_align.py``):
  * ``features``: [B, H, W, k*k*C]; channel group g = i*k + j serves bin
    (i, j), with C innermost.
  * ``rois``: [B, R, 4] normalized corners [ymin, xmin, ymax, xmax].
  * Each of the k x k bins is sampled at S x S uniform points with RoIAlign
    continuous coordinates ``norm * extent - 0.5``, clamped to
    ``[0, extent - 1]``, read bilinearly and averaged.
  * Output: [B, R, k, k, C] float32.

``batched_psroi_align`` launches the CUDA kernel ``csrc/psroi_align.cu`` on
CUDA tensors and runs the plain gather version ``psroi_align_reference`` on
CPU tensors.
"""

from __future__ import annotations

import torch

from x_detector_tpu_torch import _build


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


def batched_psroi_align(features: torch.Tensor, rois: torch.Tensor,
                        grid: int = 7, samples: int = 2) -> torch.Tensor:
    """[B, H, W, k*k*C] (bf16 or fp32) x [B, R, 4] fp32 -> [B, R, k, k, C]
    fp32. CPU tensors take the plain version; CUDA tensors launch the
    kernel, which reads bf16 or fp32 features and accumulates in fp32."""
    if features.device.type == "cpu":
        return psroi_align_reference(features, rois, grid, samples)
    if features.device.type != "cuda" or rois.device != features.device:
        raise ValueError(f"batched_psroi_align: features on {features.device}"
                         f", rois on {rois.device}; need both on one CUDA "
                         "device (or the CPU)")
    if features.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"features must be bf16 or fp32, got {features.dtype}")
    if rois.dtype != torch.float32:
        raise TypeError(f"rois must be fp32, got {rois.dtype}")
    if features.dim() != 4 or rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(f"bad shapes {tuple(features.shape)} / "
                         f"{tuple(rois.shape)}")
    b, h, w, kkc = features.shape
    if kkc % (grid * grid) or rois.shape[0] != b:
        raise ValueError(f"{kkc} channels do not split into {grid}x{grid} "
                         f"groups, or batch {b} != {rois.shape[0]}")
    if not (features.is_contiguous() and rois.is_contiguous()):
        raise ValueError("features and rois must be contiguous")
    r, c = rois.shape[1], kkc // (grid * grid)
    out = torch.empty((b, r, grid, grid, c), dtype=torch.float32,
                      device=features.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.xdt_psroi_align_fwd(
            features.data_ptr(), rois.data_ptr(), out.data_ptr(),
            int(features.dtype == torch.bfloat16), b, h, w, r, grid, c,
            samples, stream)
    _build.check(err, "psroi_align")
    batched_psroi_align.launches += 1
    return out


batched_psroi_align.launches = 0
