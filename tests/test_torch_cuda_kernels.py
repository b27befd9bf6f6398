"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and nvcc; elsewhere each skips with a
reason. The card is looked for inside a fixture, never at import. This file
imports no JAX, so on the card's machine (which has none) it runs without
the JAX suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from x_detector_tpu_torch.config import lighthead_xception  # noqa: E402
from x_detector_tpu_torch.inference import build_model  # noqa: E402
from x_detector_tpu_torch.ops import fused_sepconv as F  # noqa: E402
from x_detector_tpu_torch.ops import psroi_align as P  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


@pytest.mark.parametrize("b,h,w,cin,cout,d,res", [
    (2, 16, 11, 8, 16, 1, False),       # Cin, Cout below one tile
    (1, 7, 5, 40, 130, 2, True),        # odd H/W, ragged Cin and Cout
    (2, 9, 9, 64, 256, 2, True),
    (1, 1, 1, 32, 128, 1, False),       # every tap but the centre is padding
])
def test_fused_sepconv_kernel_matches_plain(dev, b, h, w, cin, cout, d, res):
    """bf16 output: one bf16 step (2^-8 relative) apart at most, from fp32
    sums taken in another order; held to 1e-2 of the output's scale."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _rand(gen, b, h, w, cin).bfloat16()
    args = (x, _rand(gen, 3, 3, cin, scale=0.3),
            _rand(gen, cin, cout, scale=cin ** -0.5),
            1.0 + _rand(gen, cout, scale=0.1), _rand(gen, cout, scale=0.1))
    kw = dict(dilation=d, relu=True,
              residual=_rand(gen, b, h, w, cout).bfloat16() if res else None)
    before = F.fused_separable_conv.launches
    got = F.fused_separable_conv(*args, **kw)
    ref = F.reference_separable_conv(*args, **kw)
    torch.cuda.synchronize()
    assert F.fused_separable_conv.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, w, cout)
    scale = max(1.0, ref.float().abs().max().item())
    assert (got.float() - ref.float()).abs().max().item() <= 1e-2 * scale


def test_fused_sepconv_kernel_refuses_fp32_activations(dev):
    x = torch.zeros(1, 4, 4, 8, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        F.fused_separable_conv(x, torch.zeros(3, 3, 8, device=dev),
                               torch.zeros(8, 8, device=dev),
                               torch.ones(8, device=dev),
                               torch.zeros(8, device=dev))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_psroi_kernel_matches_plain(dev, dtype):
    """Same features, same fp32 products, another summation order: 1e-5."""
    gen = torch.Generator(device=dev).manual_seed(1)
    feat = _rand(gen, 2, 13, 17, 490).to(dtype)
    lo = torch.rand(2, 300, 2, generator=gen, device=dev) * 0.8
    rois = torch.cat([lo, (lo + 0.3 * torch.rand(2, 300, 2, generator=gen,
                                                 device=dev)).clamp(max=1)],
                     dim=-1)
    rois[:, 0] = torch.tensor([0.0, 0.0, 1.0, 1.0])
    rois[:, 1] = torch.tensor([0.3, 0.3, 0.3, 0.3])       # zero area
    rois = rois.contiguous()
    before = P.batched_psroi_align.launches
    got = P.batched_psroi_align(feat, rois, 7)
    ref = P.psroi_align_reference(feat, rois, 7)
    torch.cuda.synchronize()
    assert P.batched_psroi_align.launches == before + 1
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_model_with_kernels_matches_unfused_path(dev):
    """A small config-3 model on the card, fused (kernel B2) against the
    unfused bf16 convs: both bf16 through the backbone, rounded at other
    places, so the RPN outputs are held to 5e-2 of their scale."""
    cfg = lighthead_xception(64).model
    cfg = dataclasses.replace(cfg, backbone_widths=(32, 64, 96, 128),
                              head_dim=64)
    fused = build_model(dataclasses.replace(cfg, backbone_fused_sepconv=True),
                        dev, seed=0)
    plain = build_model(cfg, dev, seed=None)
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator(
        device=dev).manual_seed(2), device=dev) * 50
    before = F.fused_separable_conv.launches
    with torch.inference_mode():
        got, ref = fused(x), plain(x)
    torch.cuda.synchronize()
    assert F.fused_separable_conv.launches == before + 14
    for key in ("rpn_cls", "rpn_loc"):
        scale = max(1.0, ref[key].abs().max().item())
        assert (got[key] - ref[key]).abs().max().item() <= 5e-2 * scale, key
