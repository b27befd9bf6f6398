"""The least time one NVIDIA H100 SXM could take for a kernel's work.

Peaks from NVIDIA's data sheet (dense, at the 700 W power limit): a kernel's
bound is the larger of the bytes it must move (each input read once, each
output written once) over the HBM rate and its operations over the peak rate
for their type.
"""

from __future__ import annotations

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
