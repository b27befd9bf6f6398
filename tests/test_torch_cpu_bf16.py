"""The port's CPU bf16 convs run in fp32 on bf16-rounded operands
(``models/layers.rounded_conv``).

PyTorch's CPU bf16 conv backward reads uninitialised memory on a 1 x 1
input with a 3 x 3 stride-2 kernel and padding 1: the 64 px SSD's last
extras. Its weight gradient then holds whatever the freed memory held. The
tests fill freed memory with NaN before each call and hold the gradients
finite, and the same in every repetition: the conv alone, and the whole
64 px SSD train step in bf16 (``cli.train --device cpu``'s default dtype).
The step in fp32 stays held to JAX's by ``tests/test_torch_ssd_train.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.nn.functional as F  # noqa: E402

from x_detector_tpu_torch.config import ssd_resnet50  # noqa: E402
from x_detector_tpu_torch.data.synthetic import synthetic_batches  # noqa: E402
from x_detector_tpu_torch.models import layers  # noqa: E402
from x_detector_tpu_torch.train.trainer import (  # noqa: E402
    create_model_and_state, make_train_step)

REPEATS = 4


def fill_freed_memory_with_nan():
    """Allocate and free NaN-filled blocks of 2^8 to 2^22 floats, so that
    an allocation reusing freed memory finds NaN. (The blocks must reach
    the size of extra1b's weight gradient, 512 x 256 x 3 x 3: with blocks
    up to 2^18 the parent's step stayed finite, with these its gradient
    held NaN in 3 runs of 4.)"""
    for n in (1 << k for k in range(8, 23)):
        blocks = [torch.full((n,), float("nan")) for _ in range(4)]
        del blocks


@pytest.mark.parametrize("size", [1, 2, 3])
def test_bf16_stride2_conv_backward_is_the_fp32_conv_of_rounded_operands(
        size):
    """conv2d in bf16 on a size x size map (1 x 1: the fault's shape): the
    output and both gradients equal fp32 F.conv2d of the bf16 operands,
    rounded to bf16, bit for bit, in every repetition after a NaN fill."""
    rng = np.random.default_rng(size)
    conv = torch.nn.Conv2d(16, 24, 3, stride=2, bias=True)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            rng.normal(0, 0.2, (24, 16, 3, 3)).astype(np.float32)))
        conv.bias.copy_(torch.from_numpy(rng.normal(0, 1, 24).astype(
            np.float32)))
    x0 = torch.from_numpy(rng.normal(0, 1, (2, 16, size, size)).astype(
        np.float32)).bfloat16()
    g = torch.from_numpy(rng.normal(0, 1, (2, 24, (size + 1) // 2,
                                           (size + 1) // 2)).astype(
        np.float32))

    xw = x0.float().requires_grad_()
    ww = conv.weight.detach().bfloat16().float().requires_grad_()
    want = F.conv2d(xw, ww, conv.bias.detach().bfloat16().float(), 2, 1)
    want.bfloat16().float().backward(g.bfloat16().float())
    want_dx, want_dw = xw.grad.bfloat16(), ww.grad
    for _ in range(REPEATS):
        fill_freed_memory_with_nan()
        x = x0.clone().requires_grad_()
        conv.weight.grad = None
        y = layers.conv2d(x, conv, ((1, 1), (1, 1)), torch.bfloat16)
        assert y.dtype == torch.bfloat16
        y.backward(g.bfloat16())
        assert torch.equal(y.float(), want.detach().bfloat16().float())
        assert torch.equal(x.grad, want_dx)
        assert torch.isfinite(conv.weight.grad).all()
        # the weight's gradient reaches fp32 through the bf16 cast's
        # backward, rounded there
        assert torch.equal(conv.weight.grad, want_dw.bfloat16().float())


def _ssd_64px():
    cfg = ssd_resnet50(64)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, backbone_stages=(1, 1, 1, 1),
                                       backbone_widths=(8, 16, 24, 32)),
        train=dataclasses.replace(cfg.train, batch_size=2))


def _bf16_step(cfg, batch):
    """One bf16 step of the thin 64 px SSD from seed 0: the loss and every
    parameter's gradient."""
    state = create_model_and_state(cfg, torch.device("cpu"), seed=0,
                                   dtype=torch.bfloat16)
    step = make_train_step(state.model, cfg)
    fill_freed_memory_with_nan()
    state, metrics = step(state, batch)
    return metrics["total_loss"].item(), {
        n: p.grad.clone() for n, p in state.model.named_parameters()}


def test_ssd_64px_bf16_step_gradients_are_finite_and_repeat():
    """The 64 px SSD (whose last extras are 1 x 1 maps, one of them fed to
    the 3 x 3 stride-2 conv) trained one bf16 step on the CPU REPEATS
    times from the same weights and batch, each after a NaN fill: every
    gradient finite, the loss finite, and every repetition the same bits."""
    cfg = _ssd_64px()
    raw = next(synthetic_batches(0, cfg.train.batch_size,
                                 cfg.model.image_size, cfg.data.max_gt_boxes))
    batch = {k: torch.from_numpy(np.asarray(raw[k])) for k in (
        "image", "gt_boxes", "gt_labels", "gt_mask")}
    batch["image"] = (batch["image"] - 115.0) / 60.0
    first_loss, first = _bf16_step(cfg, batch)
    extras = [n for n in first if n.startswith("extra")]
    assert extras and np.isfinite(first_loss)
    for _ in range(REPEATS - 1):
        loss, grads = _bf16_step(cfg, batch)
        assert loss == first_loss
        for name, grad in grads.items():
            assert torch.isfinite(grad).all(), name
            assert torch.equal(grad, first[name]), name
    for name, grad in first.items():
        assert torch.isfinite(grad).all(), name
