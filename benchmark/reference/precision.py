"""Precisions the reference computes in.

``fp8``: an operand rounded to float8 e4m3 at a per-tensor scale (its
largest magnitude onto e4m3's largest finite value, 448), the way an fp8
product takes its operands: the control's conv and dense inputs. Its
fp32 stages (proposal decoding, the NMS tails) run in bfloat16, the step
below float32.

``bf16``: an operand rounded to bfloat16 and its gradient rounded the same
way on the way back, as a bfloat16 product takes and returns them: the
witness that reproduces the program's own roundings in the reference.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 at a per-tensor scale, back in ``t``'s dtype;
    the gradient passes the rounding unchanged (as an fp8 product's
    backward takes it)."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    q = (t.detach().float() / scale).to(torch.float8_e4m3fn)
    return t + ((q.float() * scale).to(t.dtype) - t).detach()


class _RoundBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16, back in its dtype; its gradient rounded
    to bfloat16 too."""
    return _RoundBF16.apply(t)


def fp32_exact() -> None:
    """Every float32 product in float32: no TF32 in matmuls or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
