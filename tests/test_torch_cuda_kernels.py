"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and nvcc; elsewhere each skips with a
reason. The card is looked for inside a fixture, never at import. This file
imports no JAX, so on the card's machine (which has none) it runs without
the JAX suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from x_detector_tpu_torch.config import lighthead_xception  # noqa: E402
from x_detector_tpu_torch.inference import build_model  # noqa: E402
from x_detector_tpu_torch.models.layers import (  # noqa: E402
    prepare_for_inference)
from x_detector_tpu_torch.ops import fused_sepconv as F  # noqa: E402
from x_detector_tpu_torch.ops import psroi_align as P  # noqa: E402
from x_detector_tpu_torch.psroi_bwd_variants import ohem_shaped  # noqa: E402

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


def _sepconv_args(gen, b, h, w, cin, cout, d, res):
    x = _rand(gen, b, h, w, cin).bfloat16()
    args = (x, _rand(gen, 3, 3, cin, scale=0.3),
            _rand(gen, cin, cout, scale=cin ** -0.5),
            1.0 + _rand(gen, cout, scale=0.1), _rand(gen, cout, scale=0.1))
    kw = dict(dilation=d, relu=True,
              residual=_rand(gen, b, h, w, cout).bfloat16() if res else None)
    return args, kw


@pytest.mark.parametrize("b,h,w,cin,cout,d,res", [
    (2, 16, 11, 8, 16, 1, False),       # Cin, Cout below one chunk / slice
    (1, 7, 5, 40, 130, 2, True),        # odd H/W, Cout % 8 != 0: wmma route
    (2, 9, 9, 64, 256, 2, True),
    (1, 1, 1, 32, 128, 1, False),       # every tap but the centre is padding
    # config 3's shape families, at batch 1-2
    (1, 200, 200, 128, 128, 1, False),
    (1, 200, 200, 128, 128, 1, True),
    (1, 100, 100, 256, 256, 1, False),
    (1, 100, 100, 256, 256, 1, True),
    (2, 50, 50, 512, 512, 1, False),
    (2, 50, 50, 512, 512, 1, True),
    (1, 50, 50, 512, 1024, 2, False),
    (1, 50, 50, 1024, 1024, 2, False),
    (1, 50, 50, 1024, 1024, 2, True),
    (1, 37, 53, 64, 96, 1, True),       # tiles ragged in H and W and Cout
    (2, 13, 29, 72, 24, 2, False),      # halos across both images' edges
    (1, 20, 20, 1536, 256, 1, True),    # Cin above the wmma route's 1088
    # xdet_xception's stage shapes at 512 px: stage 4 at stride 32, d = 1,
    # the last at its batch of 8 (fewer work units than SMs)
    (1, 128, 128, 128, 128, 1, True),
    (2, 64, 64, 256, 256, 1, True),
    (2, 32, 32, 512, 512, 1, False),
    (8, 16, 16, 1024, 1024, 1, False),
    (8, 16, 16, 1024, 1024, 1, True),
])
def test_fused_sepconv_kernel_matches_plain(dev, b, h, w, cin, cout, d, res):
    """bf16 output: one bf16 step (2^-8 relative) apart at most, from fp32
    sums taken in another order; held to 1e-2 of the output's scale. Each
    call takes the route its channel counts give."""
    gen = torch.Generator(device=dev).manual_seed(0)
    args, kw = _sepconv_args(gen, b, h, w, cin, cout, d, res)
    route = F.route_for(cin, cout)
    before = F.fused_separable_conv.launches
    by_route = dict(F.fused_separable_conv.route_launches)
    got = F.fused_separable_conv(*args, **kw)
    ref = F.reference_separable_conv(*args, **kw)
    torch.cuda.synchronize()
    assert F.fused_separable_conv.launches == before + 1
    assert F.fused_separable_conv.route_launches[route] == by_route[route] + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, w, cout)
    scale = max(1.0, ref.float().abs().max().item())
    assert (got.float() - ref.float()).abs().max().item() <= 1e-2 * scale


def test_fused_sepconv_ragged_shapes_are_ragged(dev):
    """The plans behind the ragged cases above do leave partial tiles."""
    p = F.plan_launch(1, 37, 53, 64, 96, 1, 132)
    assert 37 % p.th and 53 % p.tw and 96 % F.BN
    p = F.plan_launch(2, 13, 29, 72, 24, 2, 132)
    assert 13 % p.th or 29 % p.tw


def test_fused_sepconv_wmma_route_matches_plain_at_a_config_shape(dev):
    """The first design, asked for explicitly, at stage 3's shape."""
    gen = torch.Generator(device=dev).manual_seed(1)
    args, kw = _sepconv_args(gen, 2, 50, 50, 512, 512, 1, True)
    before = F.fused_separable_conv.route_launches["wmma"]
    got = F.fused_separable_conv_prepared(
        args[0], F.prepare_weights(*args[1:], route="wmma"), **kw)
    ref = F.reference_separable_conv(*args, **kw)
    torch.cuda.synchronize()
    assert F.fused_separable_conv.route_launches["wmma"] == before + 1
    scale = max(1.0, ref.float().abs().max().item())
    assert (got.float() - ref.float()).abs().max().item() <= 1e-2 * scale


def test_fused_sepconv_kernel_is_bitwise_deterministic(dev):
    """No atomics: two runs on the same inputs give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(2)
    args, kw = _sepconv_args(gen, 2, 50, 50, 1024, 1024, 2, True)
    first = F.fused_separable_conv(*args, **kw)
    for _ in range(2):
        assert torch.equal(first, F.fused_separable_conv(*args, **kw))


def test_fused_sepconv_tma_route_refuses_misaligned_operands(dev):
    x = torch.zeros(1 * 4 * 4 * 8 + 1, device=dev,
                    dtype=torch.bfloat16)[1:].view(1, 4, 4, 8)
    with pytest.raises(ValueError, match="aligned"):
        F.fused_separable_conv(x, torch.zeros(3, 3, 8, device=dev),
                               torch.zeros(8, 8, device=dev),
                               torch.ones(8, device=dev),
                               torch.zeros(8, device=dev))


def test_fused_sepconv_kernel_refuses_fp32_activations(dev):
    x = torch.zeros(1, 4, 4, 8, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        F.fused_separable_conv(x, torch.zeros(3, 3, 8, device=dev),
                               torch.zeros(8, 8, device=dev),
                               torch.ones(8, device=dev),
                               torch.zeros(8, device=dev))


def _chip_smoke():
    root = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    return chip_smoke


# (B, H, W, R, grid, C, samples) of the forward's cases: the first design's
# test, config 3 and config 4 at B = 2, config 1 at its B = 1, odd C (the
# scalar path), C = 20 and 32 with S = 1, 3 and 4, one roi, none, rois
# outside [0, 1], features at an odd element offset (the scalar path), a
# table beyond 48 KB (k = 2240, S = 2: 210 KB) and one beyond the shared
# memory (k*S = 4900: each lane makes its taps)
PSROI_FORWARD_CASES = {
    "first_design": (2, 13, 17, 300, 7, 10, 2),
    "config_3": (2, 50, 50, 512, 7, 10, 2),
    "config_4": (2, 50, 50, 1000, 7, 10, 2),
    "config_1": (1, 50, 50, 512, 7, 10, 2),
    "odd_c": (2, 9, 5, 40, 3, 3, 2),
    "c20_s1": (2, 13, 17, 100, 7, 20, 1),
    "c20_s4": (1, 23, 11, 70, 7, 20, 4),
    "c32_s3": (1, 20, 30, 100, 7, 32, 3),
    "c32_s4": (1, 20, 30, 60, 7, 32, 4),
    "one_roi": (2, 13, 17, 1, 7, 10, 2),
    "no_roi": (2, 13, 17, 0, 7, 10, 2),
    "outside": (2, 13, 17, 200, 7, 10, 2),
    "offset_view": (2, 13, 17, 300, 7, 10, 2),
    "table_opt_in": (1, 2, 2, 1, 2240, 1, 2),
    "untabled": (1, 2, 2, 1, 4900, 1, 1),
}


def _forward_rois(gen, case, b, r, dev):
    """The first design's test's rois for its case; else chip_smoke's
    (edge and zero-area rois first, the first r of them), with "outside"
    also drawing rois from [-0.5, 1.5], some with their corners swapped."""
    if case == "first_design":
        lo = torch.rand(b, r, 2, generator=gen, device=dev) * 0.8
        rois = torch.cat([lo, (lo + 0.3 * torch.rand(
            b, r, 2, generator=gen, device=dev)).clamp(max=1)], dim=-1)
        rois[:, 0] = torch.tensor([0.0, 0.0, 1.0, 1.0])
        rois[:, 1] = torch.tensor([0.3, 0.3, 0.3, 0.3])     # zero area
        return rois.contiguous()
    rois = _chip_smoke().config_rois(gen, b, max(r, 6), dev)[:, :r]
    if case == "outside":
        rois[:, 6:] = torch.rand(b, r - 6, 4, generator=gen,
                                 device=dev) * 2.0 - 0.5
    return rois.contiguous()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(PSROI_FORWARD_CASES))
def test_psroi_kernel_matches_plain(dev, dtype, case):
    """Same features, same taps, another summation order: 1e-5. The plain
    version runs on the CPU copies: on the card PyTorch divides by a
    Python scalar as a multiply by its fp32 reciprocal, which moves a
    coordinate by an ulp and, on a 50-pixel noise map, an output by up to
    1.5e-5; the kernel divides as the CPU does (and as the backward does).
    One launch a call (none for R = 0), on the path the plan names."""
    b, h, w, r, grid, c, samples = PSROI_FORWARD_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(1)
    feat = _rand(gen, b, h, w, grid * grid * c).to(dtype)
    if case == "offset_view":
        feat = torch.cat([feat.new_zeros(1), feat.flatten()])[1:].view(
            feat.shape)
        assert feat.is_contiguous() and feat.storage_offset() == 1
    rois = _forward_rois(gen, case, b, r, dev)
    if r:
        aligned = feat.data_ptr() % (2 * feat.element_size()) == 0
        plan = P.plan_forward(b, r, grid, c, samples, aligned)
        assert plan.paired == (case not in ("odd_c", "offset_view",
                                            "table_opt_in", "untabled"))
        assert (plan.smem_bytes > 48 * 1024) == (case == "table_opt_in")
        assert plan.tabled == (case != "untabled")
    before = P.batched_psroi_align.launches
    got = P.batched_psroi_align(feat, rois, grid, samples)
    ref = P.psroi_align_reference(feat.cpu(), rois.cpu(), grid, samples)
    assert P.batched_psroi_align.launches == before + (1 if r else 0)
    assert got.shape == (b, r, grid, grid, c) and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), ref, atol=1e-5, rtol=1e-5)


def test_psroi_kernel_same_bits_at_config_4(dev):
    """Config 4's shape (B=16, R=1000, 50x50 bf16 map, k=7, C=10): two
    runs, the same bits."""
    gen = torch.Generator(device=dev).manual_seed(10)
    feat = _rand(gen, 16, 50, 50, 490).bfloat16()
    rois = _chip_smoke().config_rois(gen, 16, 1000, dev)
    first = P.batched_psroi_align(feat, rois, 7)
    assert torch.equal(first, P.batched_psroi_align(feat, rois, 7))


def test_model_with_kernels_matches_unfused_path(dev):
    """A small config-3 model on the card, fused (kernel B2) against the
    unfused bf16 convs: both bf16 through the backbone, rounded at other
    places, so the RPN outputs are held to 5e-2 of their scale."""
    cfg = lighthead_xception(64).model
    cfg = dataclasses.replace(cfg, backbone_widths=(32, 64, 96, 128),
                              head_dim=64)
    fused = prepare_for_inference(build_model(dataclasses.replace(
        cfg, backbone_fused_sepconv=True), dev, seed=0))
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


def _rois(gen, b, r, dev):
    lo = torch.rand(b, r, 2, generator=gen, device=dev) * 0.8
    rois = torch.cat([lo, (lo + 0.4 * torch.rand(b, r, 2, generator=gen,
                                                 device=dev)).clamp(max=1)],
                     dim=-1)
    edge = torch.tensor([[0.0, 0.0, 1.0, 1.0],
                         [0.3, 0.3, 0.3, 0.3],           # zero area
                         [0.999, 0.0, 1.0, 0.001]])      # edge sliver
    rois[:, :3] = edge[:r]
    return rois.contiguous()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,r,grid,c,samples", [
    (2, 13, 17, 300, 7, 10, 2),
    (1, 50, 50, 1000, 7, 10, 2),        # config 4's map and roi count
    (2, 9, 5, 40, 3, 3, 1),             # C below the smallest register tile
    (1, 23, 11, 70, 7, 20, 4),          # C above 16, the most samples
])
def test_psroi_backward_kernel_matches_plain(dev, dtype, b, h, w, r, grid,
                                             c, samples):
    """The same fp32 products summed in another order (1e-5 of the scale),
    then one rounding to the features' dtype: a bf16 result may land one
    bf16 step (2^-7 of the value) the other way."""
    gen = torch.Generator(device=dev).manual_seed(3)
    rois = _rois(gen, b, r, dev)
    g = _rand(gen, b, r, grid, grid, c)
    before = P.psroi_align_backward.launches
    got = P.psroi_align_backward(g, rois, h, w, dtype, grid, samples)
    ref = P.psroi_align_backward_reference(g, rois, h, w, dtype, grid,
                                           samples)
    torch.cuda.synchronize()
    assert P.psroi_align_backward.launches == before + 1
    assert got.shape == (b, h, w, grid * grid * c)
    _assert_backward_close(got, ref, dtype)


def _assert_backward_close(got, ref, dtype):
    """1e-5 of the scale, plus one bf16 step of the value in bf16."""
    assert got.dtype == dtype and got.shape == ref.shape
    scale = max(1.0, ref.float().abs().max().item())
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    bound = 1e-5 * scale + step * ref.float().abs()
    assert ((got.float() - ref.float()).abs() <= bound).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["ragged_tiles", "full_image_rois",
                                  "one_roi", "c32_s4"])
def test_psroi_backward_kernel_edge_cases(dev, dtype, case):
    """A map whose H and W are not multiples of the tile; rois that all
    cover the whole map (every roi reaches every tile, and the tile's list
    overflows its shared-memory capacity twice); R = 1; C = 32 with S = 4
    (more channels than one block's threads)."""
    b, h, w, r, grid, c, samples = {
        "ragged_tiles": (2, 37, 23, 500, 7, 10, 2),
        "full_image_rois": (1, 50, 50, 1200, 7, 10, 2),
        "one_roi": (2, 13, 17, 1, 7, 10, 2),
        "c32_s4": (1, 20, 30, 200, 7, 32, 4)}[case]
    plan = P.plan_backward(h, w, r, grid, c)
    gen = torch.Generator(device=dev).manual_seed(6)
    rois = _rois(gen, b, r, dev)
    if case == "ragged_tiles":
        assert h % plan.th and w % plan.tw
    if case == "full_image_rois":
        rois = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev).expand(
            b, r, 4).contiguous()
        assert plan.cap * 2 < r
    if case == "c32_s4":
        assert plan.passes > 1
    g = _rand(gen, b, r, grid, grid, c)
    before = P.psroi_align_backward.launches
    got = P.psroi_align_backward(g, rois, h, w, dtype, grid, samples)
    ref = P.psroi_align_backward_reference(g, rois, h, w, dtype, grid,
                                           samples)
    torch.cuda.synchronize()
    assert P.psroi_align_backward.launches == before + 1
    _assert_backward_close(got, ref, dtype)


def test_psroi_backward_kernel_zero_gradient_gives_exact_zeros(dev):
    """Rows of +0.0 and -0.0 only: every element is written, as +0."""
    gen = torch.Generator(device=dev).manual_seed(7)
    rois = _rois(gen, 2, 300, dev)
    g = torch.zeros(2, 300, 7, 7, 10, device=dev)
    g[:, ::2] = -0.0
    for dtype in (torch.bfloat16, torch.float32):
        got = P.psroi_align_backward(g, rois, 13, 17, dtype, 7)
        assert torch.equal(got, torch.zeros_like(got))
        assert not torch.signbit(got).any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_psroi_backward_kernel_ohem_shaped_gradient(dev, dtype):
    """256 non-zero gradient rows of 1000 per image: within the tolerance
    of the plain version, and the same bits as the kernel on the 256 kept
    rois alone, in their order (a +-0 row changes no sum)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    b, r, keep = 2, 1000, 256
    rois = _rois(gen, b, r, dev)
    g, kept = ohem_shaped(gen, _rand(gen, b, r, 7, 7, 10), keep)
    got = P.psroi_align_backward(g, rois, 50, 50, dtype, 7)
    ref = P.psroi_align_backward_reference(g, rois, 50, 50, dtype, 7)
    _assert_backward_close(got, ref, dtype)
    small = P.psroi_align_backward(
        torch.gather(g, 1, kept[..., None, None, None].expand(
            b, keep, 7, 7, 10)).contiguous(),
        torch.gather(rois, 1, kept[..., None].expand(b, keep, 4)).contiguous(),
        50, 50, dtype, 7)
    torch.cuda.synchronize()
    assert torch.equal(got, small)


def test_psroi_backward_kernel_same_bits_at_config_4(dev):
    """Config 4's shape (B=16, R=1000, 50x50 bf16 map, k=7, C=10): three
    runs, the same bits."""
    gen = torch.Generator(device=dev).manual_seed(9)
    rois = _rois(gen, 16, 1000, dev)
    g = _rand(gen, 16, 1000, 7, 7, 10)
    first = P.psroi_align_backward(g, rois, 50, 50, torch.bfloat16, 7)
    for _ in range(2):
        again = P.psroi_align_backward(g, rois, 50, 50, torch.bfloat16, 7)
        assert torch.equal(first, again)


def test_psroi_backward_kernel_is_bitwise_deterministic(dev):
    """Two runs on the same inputs give the same bits (no atomics), over
    more rois than one staged chunk holds."""
    gen = torch.Generator(device=dev).manual_seed(4)
    rois = _rois(gen, 2, 2000, dev)
    g = _rand(gen, 2, 2000, 7, 7, 10)
    first = P.psroi_align_backward(g, rois, 50, 50, torch.float32, 7)
    for _ in range(3):
        again = P.psroi_align_backward(g, rois, 50, 50, torch.float32, 7)
        assert torch.equal(first, again)


def test_psroi_function_gradcheck_fp32(dev):
    """``torch.autograd.gradcheck`` of the Function on the card at a tiny
    fp32 shape. The forward is linear in the features, so central
    differences are exact but for fp32 rounding of the outputs (~1e-7 of
    them over eps 1e-2): held to 1e-3; gradcheck's own second backward
    must give the same bits (nondet_tol 0)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    feat = _rand(gen, 1, 5, 4, 18).requires_grad_()
    rois = _rois(gen, 1, 5, dev)
    assert torch.autograd.gradcheck(
        lambda f: P.batched_psroi_align(f, rois, 3, 2), (feat,), eps=1e-2,
        atol=1e-3, rtol=1e-3, nondet_tol=0.0)


def test_psroi_backward_refuses_what_the_kernel_does_not_take(dev):
    rois = torch.zeros(1, 3, 4, device=dev)
    with pytest.raises(ValueError, match="C <= 32"):
        P.psroi_align_backward(torch.zeros(1, 3, 7, 7, 40, device=dev), rois,
                               8, 8, torch.float32, 7)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        P.psroi_align_backward(torch.zeros(1, 3, 7, 7, 4, device=dev), rois,
                               8, 8, torch.float16, 7)
    with pytest.raises(ValueError, match="grid 33"):
        P.psroi_align_backward(torch.zeros(1, 3, 33, 33, 1, device=dev),
                               rois, 8, 8, torch.float32, 33)


def test_train_step_on_the_card_goes_through_the_kernels(dev):
    """chip_smoke's train phase at 64 px, batch 2, on the card: one
    PSROIAlign forward and backward launch per step, exact NMS's two
    kernels, no fused conv."""
    chip_smoke = _chip_smoke()
    cfg = chip_smoke.train_config(64, batch_size=2)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_fused_sepconv=True,
        backbone_widths=(32, 64, 96, 128), head_dim=64))
    res = chip_smoke.run_train(cfg, dev, steps=2)
    assert res["launches"] == res["expected"] == {
        "fused_sepconv": 0, "psroi_align": 3, "psroi_align_backward": 3,
        "nms_suppress": 3 * 2}
    assert res["moved"] == res["params"]


# ---- the int8 kernels: K1 (dense conv), K2 (depthwise 3x3), K3 (quantizer)
# Each is held to its plain version run on the card bit for bit: the int8
# products and their int32 sums are exact, and the epilogue rounds as the
# plain version does.

def _int8(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int8)


# (B, H, W, Cin, Cout, kernel, stride, dilation, pads, route): the route
# that ops/int8_conv.plan_conv gives the shape ("tma" where Cin is a
# multiple of 16, else "mma")
INT8_CONV_CASES = {
    # ResNet's stem: Cin 3 (byte copies), K 147 (a K tail)
    "stem_7x7_cin3": (2, 17, 13, 3, 64, (7, 7), (2, 2), (1, 1),
                      ((3, 3), (3, 3)), "mma"),
    # Xception's folded stem: Cin 12 (4-byte copies), K 432
    "stem_12x3_cin12": (2, 24, 9, 12, 128, (12, 3), (4, 1), (1, 1),
                        ((4, 4), (1, 1)), "mma"),
    # Cout 100 (not a multiple of 64), dilation 2, K 576; Cin 64: half a
    # 128-byte chunk a tap
    "3x3_d2_cout100": (1, 9, 11, 64, 100, (3, 3), (1, 1), (2, 2),
                       ((2, 2), (2, 2)), "tma"),
    # Cin 40 (8-byte copies), 105 pixels (an M tail), K 360 (a K tail)
    "3x3_cin40_mtail": (3, 7, 5, 40, 24, (3, 3), (1, 1), (1, 1),
                        ((1, 1), (1, 1)), "mma"),
    # the strided 1x1 shortcut, 16-byte copies
    "1x1_s2": (1, 10, 10, 256, 512, (1, 1), (2, 2), (1, 1),
               ((0, 0), (0, 0)), "tma"),
    # SAME at stride 2 (pads (0, 1)), Cout 130: a third 128-wide block
    "3x3_s2_same_cout130": (2, 15, 15, 128, 130, (3, 3), (2, 2), (1, 1),
                            ((0, 1), (0, 1)), "tma"),
    # Cout 33 (odd: unpaired stores), K 9000
    "3x3_cout33_k9000": (1, 5, 6, 1000, 33, (3, 3), (1, 1), (1, 1),
                         ((1, 1), (1, 1)), "mma"),
    # config 2's widest: 3x3 x 512 at 16 x 16, K 4608 (batch 1: 8 tiles,
    # clusters of 8 slices)
    "config2_stage4": (1, 16, 16, 512, 512, (3, 3), (1, 1), (1, 1),
                       ((1, 1), (1, 1)), "tma"),
    # the gemm form with an M tail (189 rows), an N tail (Cout 96) and
    # half a K chunk (Cin 64)
    "gemm_mtail_cin64": (3, 7, 9, 64, 96, (1, 1), (1, 1), (1, 1),
                         ((0, 0), (0, 0)), "tma"),
    # the gemm form at Cin 48 and Cout 33: rows of 66 / 132 bytes, stored
    # an element at a time
    "gemm_cin48_cout33": (2, 5, 7, 48, 33, (1, 1), (1, 1), (1, 1),
                          ((0, 0), (0, 0)), "tma"),
    # Xception's strided 1x1 (100 -> 50): 5 x 25 tiles of a 50 x 50 map
    "1x1_s2_50x50": (1, 100, 100, 128, 256, (1, 1), (2, 2), (1, 1),
                     ((0, 0), (0, 0)), "tma"),
    # Cout 33 on the conv form
    "3x3_cin32_cout33": (1, 9, 9, 32, 33, (3, 3), (1, 1), (1, 1),
                         ((1, 1), (1, 1)), "tma"),
    # ResNet's strided 3x3 (pads (1, 1))
    "3x3_s2_resnet": (2, 32, 32, 256, 512, (3, 3), (2, 2), (1, 1),
                      ((1, 1), (1, 1)), "tma"),
    # config 3's strided 1x1 (200 -> 100) at batch 2: 160 tiles of 256
    # channels, each 5 x 25 pixels read at element stride 2
    "1x1_s2_config3_bn256": (2, 200, 200, 128, 256, (1, 1), (2, 2), (1, 1),
                             ((0, 0), (0, 0)), "tma"),
    # split-K at config 2's 16 x 16 shapes, batch 8: 64 tiles of 128
    # channels, 2 slices
    "split_config2_3x3_512": (8, 16, 16, 512, 512, (3, 3), (1, 1), (1, 1),
                              ((1, 1), (1, 1)), "tma"),
    "split_config2_1x1_2048": (8, 16, 16, 2048, 512, (1, 1), (1, 1),
                               (1, 1), ((0, 0), (0, 0)), "tma"),
    # config 2's stage 1 1x1 (64 -> 256 at 128 x 128, batch 8): 1024 tiles
    # of 256 channels, no split, 4 stages
    "gemm_config2_stage1": (8, 128, 128, 64, 256, (1, 1), (1, 1), (1, 1),
                            ((0, 0), (0, 0)), "tma"),
}
# cases whose plan must split K (the smaller "tma" cases split too) and
# cases whose plan must not
INT8_SPLIT_CASES = ("config2_stage4", "split_config2_3x3_512",
                    "split_config2_1x1_2048")
INT8_WHOLE_K_CASES = ("gemm_config2_stage1",)


def _int8_conv_operands(dev, case):
    from x_detector_tpu_torch.ops import int8_conv as Q
    b, h, w, cin, cout, k, s, d, pads, _ = INT8_CONV_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(len(case))
    xq = _int8(gen, b, h, w, cin)
    wq = _int8(gen, cout, *k, cin)
    scale = torch.rand(cout, generator=gen, device=dev) * 1e-3 + 1e-5
    return xq, wq, scale, dict(stride=s, dilation=d, pads=pads)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(INT8_CONV_CASES))
def test_int8_conv_kernel_matches_plain_bitwise(dev, case, out_dtype):
    """K1 on the route its shape takes, bit for bit the plain version; the
    route's counter and the total count one launch."""
    from x_detector_tpu_torch.ops import int8_conv as Q
    xq, wq, scale, kw = _int8_conv_operands(dev, case)
    route = INT8_CONV_CASES[case][-1]
    weight = Q.prepare_weight(wq, False)
    geometry = Q.conv_geometry(weight.ksize, kw["stride"], kw["dilation"],
                               kw["pads"])
    plan = Q.plan_conv(xq.shape, wq.shape[0], geometry, xq.data_ptr(),
                       Q.sm_count(xq.get_device()))
    assert plan.route == route
    if case in INT8_SPLIT_CASES + INT8_WHOLE_K_CASES:
        assert (plan.splits > 1) == (case in INT8_SPLIT_CASES)
    before = Q.int8_conv2d.launches
    by_route = dict(Q.int8_conv2d.route_launches)
    got = Q.int8_conv2d(xq, weight, scale, out_dtype=out_dtype, **kw)
    ref = Q.int8_conv2d_reference(xq, wq, scale, out_dtype=out_dtype, **kw)
    torch.cuda.synchronize()
    assert Q.int8_conv2d.launches == before + 1
    assert Q.int8_conv2d.route_launches == {
        r: n + (r == route) for r, n in by_route.items()}
    assert got.shape == ref.shape and got.dtype == out_dtype
    assert torch.equal(got, ref), (got.float() - ref.float()).abs().max()


@pytest.mark.parametrize("bn,splits", [(256, 4), (128, 2), (256, 2),
                                       (64, 1)])
def test_int8_conv_tma_plans_beyond_the_rule(dev, bn, splits):
    """The "tma" kernel at config 2's 16 x 16 x 512 3x3 under launch plans
    the rule does not pick (256 channels a tile in clusters of 4 slices:
    each slice's last chunk in the ring's first stage, where the partials
    go), bit for bit the plain version."""
    from x_detector_tpu_torch.ops import int8_conv as Q
    xq, wq, scale, kw = _int8_conv_operands(dev, "split_config2_3x3_512")
    weight = Q.prepare_weight(wq, False)
    g = Q.conv_geometry(weight.ksize, kw["stride"], kw["dilation"],
                        kw["pads"])
    plan = Q.with_width(Q.plan_conv(xq.shape, wq.shape[0], g, xq.data_ptr(),
                                  Q.sm_count(xq.get_device())),
                      wq.shape[0], bn, splits)
    ref = Q.int8_conv2d_reference(xq, wq, scale, out_dtype=torch.bfloat16,
                                  **kw)
    for _ in range(3):
        got = Q.run_plan(plan, xq, weight.kernel, scale, g,
                         Q.conv_output(xq, wq.shape[0], g, torch.bfloat16))
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


def test_int8_conv_misaligned_weight_raises(dev):
    """A weight operand off 16 bytes (a view) is refused on the card with
    a message naming the rule, and nothing is launched: both routes read
    it in 16-byte pieces."""
    from x_detector_tpu_torch.ops import int8_conv as Q
    xq, wq, scale, kw = _int8_conv_operands(dev, list(INT8_CONV_CASES)[0])
    kernel = Q.prepare_weight(wq, False).kernel
    buf = torch.empty(kernel.numel() + 1, dtype=torch.int8, device=dev)
    view = buf[1:].view(kernel.shape)
    view.copy_(kernel)
    weight = Q.Int8Weight(view, tuple(wq.shape[1:3]), False)
    before = Q.int8_conv2d.launches
    with pytest.raises(ValueError, match="16-byte"):
        Q.int8_conv2d(xq, weight, scale, **kw)
    assert Q.int8_conv2d.launches == before


@pytest.mark.parametrize("op", ["int8_dwconv", "int8_dwconv_q"])
def test_int8_depthwise_refuses_the_nine_row_weight_on_the_card(dev, op):
    """Each depthwise operator's CUDA implementation, called past the
    wrapper, refuses a weight operand of the older [9, C] layout (the
    "tma" route would read rows 9-20 past it) and launches nothing."""
    from x_detector_tpu_torch.ops import int8_conv as Q
    gen = torch.Generator(device=dev).manual_seed(5)
    c = 64
    xq = torch.randint(-127, 128, (2, 9, 11, c), generator=gen,
                       dtype=torch.int8, device=dev)
    wq = torch.randint(-127, 128, (c, 3, 3, 1), generator=gen,
                       dtype=torch.int8, device=dev)
    old = Q.prepare_weight(wq, True).kernel[:9].contiguous()
    scale = torch.rand(c, generator=gen, device=dev) * 1e-3
    geometry = Q.conv_geometry((3, 3), (1, 1), (1, 1), ((1, 1), (1, 1)))
    extra = ((torch.tensor([0.05], device=dev),) if op == "int8_dwconv_q"
             else ())
    before = Q.int8_depthwise_conv2d.launches
    with pytest.raises(ValueError, match="older layout"):
        getattr(torch.ops.xdt, op).default(xq, old, scale, *extra, geometry,
                                           torch.bfloat16)
    assert Q.int8_depthwise_conv2d.launches == before


def test_int8_conv_split_plan_on_two_streams(dev):
    """One split plan run on two streams at once, each on its own inputs,
    a few times over: a tile's slices meet in its cluster's shared memory,
    so the launches share nothing and both results stay bit for bit the
    plain version's."""
    from x_detector_tpu_torch.ops import int8_conv as Q
    runs = []
    for seed in (0, 1):
        xq, wq, scale, kw = _int8_conv_operands(dev, "split_config2_3x3_512")
        xq = xq.roll(seed, dims=-1).contiguous()
        runs.append((xq, Q.prepare_weight(wq, False), scale, wq, kw))
    streams = [torch.cuda.Stream(dev) for _ in runs]
    torch.cuda.synchronize()
    outs = [[] for _ in runs]
    for _ in range(4):
        for (xq, weight, scale, _, kw), st, out in zip(runs, streams, outs):
            with torch.cuda.stream(st):
                out.append(Q.int8_conv2d(xq, weight, scale, **kw))
    torch.cuda.synchronize()
    for (xq, _, scale, wq, kw), out in zip(runs, outs):
        ref = Q.int8_conv2d_reference(xq, wq, scale,
                                      out_dtype=torch.bfloat16, **kw)
        for got in out:
            assert torch.equal(got, ref)


# (B, H, W, C, stride, dilation): SAME pads
INT8_DW_CASES = {
    "c16": (2, 13, 11, 16, 1, 1),
    "config3_s2": (1, 20, 20, 128, 2, 1),
    "config3_d2": (2, 9, 10, 1024, 1, 2),
    "c20_vec4": (1, 7, 9, 20, 1, 1),
    "c7_vec1_s2_d2": (1, 6, 5, 7, 2, 2),
}


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(INT8_DW_CASES))
def test_int8_depthwise_kernel_matches_plain_bitwise(dev, case, out_dtype):
    from x_detector_tpu_torch.models.layers import same_pads
    from x_detector_tpu_torch.ops import int8_conv as Q
    b, h, w, c, s, d = INT8_DW_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(len(case))
    xq = _int8(gen, b, h, w, c)
    wq = _int8(gen, c, 3, 3, 1)
    scale = torch.rand(c, generator=gen, device=dev) * 1e-2 + 1e-4
    pads = same_pads((h, w), (3, 3), (s, s), (d, d))
    got = Q.int8_depthwise_conv2d(xq, Q.prepare_weight(wq, True), scale,
                                  stride=s, dilation=d, pads=pads,
                                  out_dtype=out_dtype)
    ref = Q.int8_depthwise_conv2d_reference(xq, wq, scale, stride=s,
                                            dilation=d, pads=pads,
                                            out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), (got.float() - ref.float()).abs().max()


# K2's "tma" route (csrc/int8_dwconv_tma.cu) in both modes: (B, H, W, C,
# stride, dilation, pads; None: SAME). C from 16 to 1024 (144: a partial
# second block of 128 channels), odd H and W (tiles past the map's edge),
# pads (0, 1) (SAME at stride 2 on an even size), (1, 1) at stride 2 and
# none, dilation 2 with stride 1 and 2.
INT8_DW_TMA_CASES = {
    "c16_odd": (2, 13, 11, 16, 1, 1, None),
    "c32_s2_same": (1, 16, 18, 32, 2, 1, None),
    "c48_d2": (2, 9, 10, 48, 1, 2, None),
    "c128_s2_pads11": (2, 21, 20, 128, 2, 1, ((1, 1), (1, 1))),
    "c144_two_blocks": (1, 7, 9, 144, 1, 1, None),
    "c256_s2_d2": (1, 19, 23, 256, 2, 2, None),
    "c512_no_pads": (1, 10, 12, 512, 1, 1, ((0, 0), (0, 0))),
    "c1024_d2": (2, 9, 10, 1024, 1, 2, None),
    "config3_stage1_cut": (2, 40, 40, 128, 1, 1, None),
}


def _int8_dw_tma_operands(dev, case, small=False):
    from x_detector_tpu_torch.models.layers import same_pads
    b, h, w, c, s, d, pads = INT8_DW_TMA_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(len(case) + 7 * c)
    if small:      # |acc| <= 81: v = acc / 2 is exact in bf16
        xq = torch.randint(-3, 4, (b, h, w, c), generator=gen, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-3, 4, (c, 3, 3, 1), generator=gen, device=dev,
                           dtype=torch.int8)
        scale = torch.full((c,), 0.5, device=dev)
    else:
        xq, wq = _int8(gen, b, h, w, c), _int8(gen, c, 3, 3, 1)
        scale = torch.rand(c, generator=gen, device=dev) * 1e-2 + 1e-4
    if pads is None:
        pads = same_pads((h, w), (3, 3), (s, s), (d, d))
    return xq, wq, scale, dict(stride=s, dilation=d, pads=pads)


def _counted_dw(Q, route, mode):
    before = (Q.int8_depthwise_conv2d.launches,
              dict(Q.int8_depthwise_conv2d.route_launches),
              dict(Q.int8_depthwise_conv2d.mode_launches))

    def check():
        n, routes, modes = before
        assert Q.int8_depthwise_conv2d.launches == n + 1
        assert Q.int8_depthwise_conv2d.route_launches == {
            r: v + (r == route) for r, v in routes.items()}
        assert Q.int8_depthwise_conv2d.mode_launches == {
            m: v + (m == mode) for m, v in modes.items()}
    return check


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(INT8_DW_TMA_CASES))
def test_int8_depthwise_tma_route_dequant_matches_plain_bitwise(
        dev, case, out_dtype):
    """K2 on the "tma" route (every shape here: C a multiple of 16, stride
    and dilation 1 or 2, aligned operands), dequantizing to bf16 or fp32,
    bit for bit the plain version; one launch, counted on its route and
    mode."""
    from x_detector_tpu_torch.ops import int8_conv as Q
    xq, wq, scale, kw = _int8_dw_tma_operands(dev, case)
    weight = Q.prepare_weight(wq, True)
    check = _counted_dw(Q, "tma", "dequant")
    got = Q.int8_depthwise_conv2d(xq, weight, scale, out_dtype=out_dtype,
                                  **kw)
    ref = Q.int8_depthwise_conv2d_reference(xq, wq, scale,
                                            out_dtype=out_dtype, **kw)
    torch.cuda.synchronize()
    check()
    assert got.shape == ref.shape and got.dtype == out_dtype
    assert torch.equal(got, ref), (got.float() - ref.float()).abs().max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(INT8_DW_TMA_CASES))
def test_int8_depthwise_tma_route_quantize_matches_plain_bitwise(
        dev, case, dtype):
    """K2 quantizing on its store: int8 bit for bit the plain versions
    composed (K2's in ``dtype``, then K3's), at a scale that saturates
    some outputs at +-127 and, with small operands (v = acc / 2, exact)
    and sx_out = 1, at one where many values lie exactly on half-integers
    of v / sx_out (rounded half to even)."""
    from x_detector_tpu_torch.ops import int8_conv as Q
    for small in (False, True):
        xq, wq, scale, kw = _int8_dw_tma_operands(dev, case, small)
        weight = Q.prepare_weight(wq, True)
        v = Q.int8_depthwise_conv2d_reference(xq, wq, scale, out_dtype=dtype,
                                              **kw)
        sx = torch.tensor(1.0 if small else float(v.float().abs().amax())
                          / 300.0, device=dev)
        check = _counted_dw(Q, "tma", "quantize")
        got = Q.int8_depthwise_conv2d_quantized(xq, weight, scale, sx,
                                                dtype=dtype, **kw)
        ref = Q.quantize_activation_reference(v, sx)
        torch.cuda.synchronize()
        check()
        assert got.dtype == torch.int8 and got.shape == ref.shape
        assert torch.equal(got, ref), (got.float() - ref.float()).abs().max()
        if small:
            half = (v.float() / sx).frac().abs() == 0.5
            assert half.float().mean() > 0.2
        else:
            assert (got.abs() == 127).any() and (got.abs() < 127).any()


# scales of the quantize-on-store check: the tests' and chip_smoke's kind
# (an output range / 127 or / 300, 1, 0.5), the smallest activation scale
# (1e-6 / 127), a wide log-uniform spread, and the edges of the fast form
QUANTIZE_SCALES = [1.0, 0.5, 2.0 / 3.0, 1e-6 / 127, 1.0 / 127, 0.0371, 3.0,
                   7.3, 1234.5, 1e-3, 2.0 ** -40, 2.0 ** 40, 2.0 ** -41,
                   2.0 ** 41, 1e-40, 0.0]


def test_int8_depthwise_fast_quantize_equals_k3s_form(dev):
    """The "tma" route quantizes on its store without a division
    (``quantize_fast``: a reciprocal once, a product and one fma
    correction, a clamp and a magic-number rint); held bitwise to K3's
    ``__fdiv_rn`` / ``__float2int_rn`` form at every bf16 value (all 65536
    bit patterns: NaN, infinities, subnormals included) for each scale of
    QUANTIZE_SCALES and 48 log-uniform ones in [1e-9, 1e4], and at fp32
    values within 12 ulps of every rounding boundary (k + 1/2) sx, |k| <=
    128."""
    from x_detector_tpu_torch.ops import int8_conv as Q
    bits = torch.arange(-32768, 32768, dtype=torch.int32, device=dev)
    every_bf16 = bits.to(torch.int16).view(torch.bfloat16).float()
    gen = torch.Generator(device=dev).manual_seed(0)
    scales = QUANTIZE_SCALES + (10.0 ** (torch.rand(
        48, generator=gen, device=dev) * 13 - 9)).tolist()
    k = torch.arange(-128, 129, device=dev, dtype=torch.float64) + 0.5
    steps = torch.arange(-12, 13, device=dev, dtype=torch.int32)
    for sx in scales:
        s = torch.tensor(sx, dtype=torch.float32, device=dev)
        edges = (k * float(s)).float()
        near = (edges.view(torch.int32)[:, None] + steps).view(
            torch.float32).reshape(-1)
        for v in (every_bf16, near.contiguous()):
            fast, exact = Q.quantize_forms(v, s)
            torch.cuda.synchronize()
            bad = (fast != exact).nonzero()
            assert bad.numel() == 0, (sx, v[bad[:5, 0]].tolist(),
                                      fast[bad[:5, 0]].tolist(),
                                      exact[bad[:5, 0]].tolist())
        if sx == 1.0:        # the form itself: K3's plain version's bits
            assert torch.equal(exact, Q.quantize_activation_reference(
                near, s))


def test_int8_depthwise_simt_route_takes_the_other_shapes(dev):
    """C off a multiple of 16, stride 3 and a view off 16 bytes take the
    first design ("simt"), bit for bit; quantizing on the store there
    raises, launching nothing."""
    from x_detector_tpu_torch.ops import int8_conv as Q
    gen = torch.Generator(device=dev).manual_seed(3)
    for shape, s, offset in (((1, 7, 9, 20), 1, 0), ((2, 11, 10, 32), 3, 0),
                             ((1, 6, 7, 64), 1, 4)):
        base = _int8(gen, shape[0] * shape[1] * shape[2] * shape[3] + offset)
        xq = base[offset:].view(shape)
        wq = _int8(gen, shape[3], 3, 3, 1)
        scale = torch.rand(shape[3], generator=gen, device=dev) * 1e-2
        kw = dict(stride=s, dilation=1, pads=((1, 1), (1, 1)))
        weight = Q.prepare_weight(wq, True)
        check = _counted_dw(Q, "simt", "dequant")
        got = Q.int8_depthwise_conv2d(xq, weight, scale, **kw)
        ref = Q.int8_depthwise_conv2d_reference(
            xq, wq, scale, out_dtype=torch.bfloat16, **kw)
        torch.cuda.synchronize()
        check()
        assert torch.equal(got, ref)
        n = Q.int8_depthwise_conv2d.launches
        with pytest.raises(ValueError, match="tma route only"):
            Q.int8_depthwise_conv2d_quantized(
                xq, weight, scale, torch.tensor(0.1, device=dev), **kw)
        assert Q.int8_depthwise_conv2d.launches == n


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_separable_block_quantizes_on_store_on_the_card(dev, dtype):
    """An int8 SeparableConvBN on the card: K2 quantizing its store at the
    pointwise conv's sx, then K1 on that map, bit for bit the two convs
    called one after the other (K2 dequantizing, K3, K1), and one K3 launch
    fewer."""
    from x_detector_tpu_torch.models.layers import SeparableConvBN
    from x_detector_tpu_torch.ops import int8_conv as Q
    torch.manual_seed(0)
    for s, d in ((1, 1), (2, 1), (1, 2)):
        m = SeparableConvBN(128, 256, (s, s), (d, d), quant="int8",
                            dtype=dtype).to(dev)
        m.Conv_0.act_amax.fill_(3.0)
        m.Conv_1.act_amax.fill_(0.05)
        m.eval()
        prepare_for_inference(m)
        assert m.quantizes_on_store
        x = torch.randn(2, 128, 23, 21, device=dev).to(dtype)
        with torch.no_grad():
            k3 = Q.quantize_activation.launches
            got = m(x)
            assert Q.quantize_activation.launches == k3 + 1
            want = torch.relu(m.bn(m.Conv_1(m.Conv_0(x))))
            assert Q.quantize_activation.launches == k3 + 3
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,offset", [(8 * 1000, 0), (1003, 0), (999, 1)])
def test_quantize_kernel_matches_plain_bitwise(dev, dtype, n, offset):
    """Saturated values, exact ties of the grid (sx = 0.5: x in quarters),
    a tail past the last 8 and a view off 16-byte alignment (the scalar
    path)."""
    from x_detector_tpu_torch.ops import int8_conv as Q
    gen = torch.Generator(device=dev).manual_seed(n)
    base = (torch.randint(-300, 300, (n + offset,), generator=gen,
                          device=dev) / 4.0).to(dtype)
    x = base[offset:]
    x[:4] = torch.tensor([0.25, 0.75, -0.25, 1e9], device=dev).to(dtype)
    sx = torch.tensor(0.5, device=dev)
    got = Q.quantize_activation(x, sx)
    ref = Q.quantize_activation_reference(x, sx)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert got[:4].tolist() == [0, 2, 0, 127]       # half to even, clipped


def test_int8_kernels_refuse_what_they_do_not_take(dev):
    from x_detector_tpu_torch.ops import int8_conv as Q
    gen = torch.Generator(device=dev).manual_seed(0)
    weight = Q.prepare_weight(_int8(gen, 8, 3, 3, 8), False)
    scale = torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="contiguous int8"):
        Q.int8_conv2d(_int8(gen, 1, 8, 8, 8).permute(0, 2, 1, 3), weight,
                      scale)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        Q.int8_conv2d(_int8(gen, 1, 8, 8, 8), weight, scale,
                      out_dtype=torch.float16)
    with pytest.raises(ValueError, match="one CUDA device"):
        Q.int8_conv2d(_int8(gen, 1, 8, 8, 8), weight, scale.cpu())
    with pytest.raises(ValueError, match="depthwise"):
        Q.int8_depthwise_conv2d(_int8(gen, 1, 8, 8, 8), weight, scale)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        Q.quantize_activation(torch.ones(8, device=dev, dtype=torch.float16),
                              torch.tensor(1.0, device=dev))


def test_int8_model_on_the_card_goes_through_the_kernels(dev):
    """chip_smoke's int8 phase at 128 px on thin backbones, on the card:
    calibrated, then K3 before every backbone conv, K1 for the dense ones
    (the stem, Cin 3 or 12, on the first design's route, every other one
    on the "tma" route) and K2 for the depthwise ones, B2 never."""
    chip_smoke = _chip_smoke()
    from x_detector_tpu_torch.config import ssd_resnet50
    for cfg in (ssd_resnet50(128), lighthead_xception(128)):
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, backbone_stages=(1, 1, 1, 1), large_sep_mid=16,
            head_dim=32, backbone_widths=(16, 32, 48, 64)))
        res, model = chip_smoke.run_int8(cfg, dev, batches=1, batch_size=2)
        assert res["launches"] == res["expected"]
        fused = res["batches"] * chip_smoke.quantizing_blocks(model)
        assert res["launches"]["quantize_s8"] == (
            res["launches"]["int8_conv"] + res["launches"]["int8_dwconv"]
            - fused)
        assert res["dw_modes"] == {
            "quantize": fused,
            "dequant": res["launches"]["int8_dwconv"] - fused}
        assert res["dw_routes"] == {"tma": res["launches"]["int8_dwconv"],
                                    "simt": 0}
        assert res["int8_routes"] == {
            "tma": res["launches"]["int8_conv"] - res["batches"],
            "mma": res["batches"]}


# ---- exact greedy NMS: xdt::nms_suppress's mask and scan kernels -----------
# Held bit for bit to the operator's plain version (the tile loop with its
# host checks) run on the CPU: every IoU rounds as ops/boxes.py's does and
# meets the fp32 threshold, so every decision is the plain version's.

def _nms_boxes(rows, n, seed, invalid=0.2):
    from _torch_nms_cases import cluttered_rows
    return torch.from_numpy(cluttered_rows(np.random.default_rng(seed), rows,
                                           n, invalid=invalid))


def _suppress_on_card(boxes, thr):
    from x_detector_tpu_torch.ops import nms
    before = nms.nms_suppress.launches
    got = nms.nms_suppress(boxes.cuda(), thr)
    assert nms.nms_suppress.launches == before + nms.KERNELS == before + 2
    assert got.dtype == torch.bool and got.is_cuda
    return got.cpu()


# (rows, boxes a row, threshold, share of invalid boxes): the proposal
# stage's serving and training shapes, the serving tail's 16 x 20 rows of
# 256, a few boxes off a multiple of 64, one partial word, invalid boxes
# almost everywhere (the live words skip their rows)
NMS_CASES = [(16, 1024, 0.7, 0.2), (16, 6016, 0.7, 0.2),
             (320, 256, 0.45, 0.2), (3, 1000, 0.5, 0.2), (1, 70, 0.3, 0.2),
             (2, 64, 0.7, 0.0), (16, 1024, 0.7, 0.97)]


@pytest.mark.parametrize("rows,n,thr,invalid", NMS_CASES)
def test_nms_suppress_kernel_matches_plain_bitwise(dev, rows, n, thr,
                                                   invalid):
    from x_detector_tpu_torch.ops import nms
    boxes = _nms_boxes(rows, n, seed=rows * n, invalid=invalid)
    want = nms.suppress_plain(boxes, thr)
    got = _suppress_on_card(boxes, thr)
    assert 0 < int(want.sum()) < rows * n * (1 - invalid)
    assert torch.equal(got, want)


@pytest.mark.parametrize("apart", [False, True])
@pytest.mark.parametrize("thr", [0.3, 0.45, 0.5, 0.7])
def test_nms_suppress_kernel_at_the_threshold(dev, thr, apart):
    """Pairs whose fp32 IoU is the fp32 threshold or one ulp off it, in one
    word of the mask or in two blocks apart: the kernel suppresses exactly
    the pairs above fp32(thr), as the plain version does."""
    from _torch_nms_cases import edge_rows
    from x_detector_tpu_torch.ops import nms
    boxes = torch.from_numpy(edge_rows(thr, apart=apart))
    want = nms.suppress_plain(boxes, thr)
    assert int(want.sum()) == len(boxes) // 3
    assert torch.equal(_suppress_on_card(boxes, thr), want)


def test_nms_suppress_kernel_with_nonfinite_boxes(dev):
    """NaN, infinite and huge coordinates: a NaN makes every union its box
    enters NaN, so its IoU is 0 in both versions, whatever min and max do."""
    boxes = _nms_boxes(8, 300, seed=3)
    flat = boxes.view(-1)
    pick = torch.randperm(flat.numel(), generator=torch.Generator()
                          .manual_seed(3))[:400]
    flat[pick] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                               1e30]).repeat(100)
    from x_detector_tpu_torch.ops import nms
    for thr in (0.5, 0.0):
        want = nms.suppress_plain(boxes, thr)
        assert torch.equal(_suppress_on_card(boxes, thr), want), thr


def test_nms_suppress_kernel_is_deterministic(dev):
    """The same inputs give the same bits, call after call, and each call
    adds its two kernels (mask, scan) to the wrapper's launches."""
    boxes = _nms_boxes(16, 6016, seed=7)
    first = _suppress_on_card(boxes, 0.7)
    for _ in range(3):
        assert torch.equal(_suppress_on_card(boxes, 0.7), first)


def test_nms_suppress_refuses_what_the_kernel_does_not_take(dev):
    from x_detector_tpu_torch.ops import nms
    boxes = _nms_boxes(4, 200, seed=1).cuda()
    with pytest.raises(ValueError, match="contiguous"):
        nms.nms_suppress(boxes.transpose(0, 1), 0.5)
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(TypeError, match="fp32"):
            nms.nms_suppress(boxes.to(dtype), 0.5)
    with pytest.raises(ValueError, match=r"\[R, N, 4\]"):
        nms.nms_suppress(boxes[0], 0.5)
    with pytest.raises(ValueError, match="at most"):
        nms.nms_suppress(torch.zeros(1, nms.MAX_BOXES + 1, 4, device=dev),
                         0.5)


@pytest.mark.parametrize("training", [False, True])
def test_proposal_stage_and_nms_tail_make_no_host_sync(dev, training):
    """Config 3's proposal stage at 800 px, batch 16, in serving's budget
    (1000 candidates) and training's (6000), then the serving tail over
    the proposals, all under ``torch.cuda.set_sync_debug_mode("error")``:
    nothing in them waits on the card, and each exact NMS is one call of
    the wrapper, its two kernels counted. The plain version raises there
    (its host checks)."""
    from x_detector_tpu_torch.models import lighthead
    from x_detector_tpu_torch.ops import anchors as anchor_ops
    from x_detector_tpu_torch.ops import nms
    cfg = lighthead_xception(800).model
    anchors = torch.from_numpy(anchor_ops.rpn_anchors(800, cfg.anchors)
                               ).to(dev)
    gen = torch.Generator(device="cuda").manual_seed(21)
    b, a = 16, anchors.shape[0]
    rpn_cls = _rand(gen, b, a, 2, scale=2.0)
    rpn_loc = _rand(gen, b, a, 4, scale=0.5)
    torch.cuda.synchronize()
    before = nms.nms_suppress.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        props, scores, valid = lighthead.generate_proposals(
            rpn_cls, rpn_loc, anchors, cfg.proposals, 800, training=training)
        r = props.shape[1]
        out = {"roi_cls": _rand(gen, b, r, cfg.num_classes + 1),
               "roi_box": _rand(gen, b, r, 4, scale=0.1),
               "proposals": props, "proposal_valid": valid}
        det = lighthead.lighthead_postprocess(out, cfg)
        with pytest.raises(RuntimeError, match="synchroniz"):
            nms.suppress_plain(props[:, :128].contiguous(), 0.7)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert nms.nms_suppress.launches == before + 2 * nms.KERNELS
    want_r = (cfg.proposals.post_nms_topk if training
              else cfg.proposals.post_nms_topk_eval)
    assert props.shape == (b, want_r, 4) and int(valid.sum()) > 0
    assert det.boxes.shape == (b, cfg.nms.max_output, 4)
