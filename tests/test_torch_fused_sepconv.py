"""The port's fused separable conv (kernel B2) against the JAX package.

The port's plain version (the one CPU tensors take) is held to JAX's
``fused_separable_conv``, which runs the Pallas kernel in interpret mode on
the CPU, or its lax reference where H has no whole row-band tiling. Inputs
come from numpy seeds and are fed to both. In fp32 the two compute the same
sums in another order: held to 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from x_detector_tpu.models import layers as jax_layers  # noqa: E402
from x_detector_tpu.ops.pallas.fused_sepconv import (  # noqa: E402
    _pick_band, fused_separable_conv as jax_fused)
from x_detector_tpu_torch.models.layers import SeparableConvBN  # noqa: E402
from x_detector_tpu_torch.ops import fused_sepconv as F  # noqa: E402
from x_detector_tpu_torch.utils.convert import from_jax_variables  # noqa: E402


def _inputs(seed, b, h, w, cin, cout, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(0, 1, (b, h, w, cin)).astype(dtype),
        wd=(rng.normal(0, 1, (3, 3, cin)) * 0.3).astype(np.float32),
        wp=(rng.normal(0, 1, (cin, cout)) * 0.2).astype(np.float32),
        scale=(rng.normal(0, 1, cout) * 0.5 + 1.0).astype(np.float32),
        bias=(rng.normal(0, 1, cout) * 0.1).astype(np.float32),
        residual=rng.normal(0, 1, (b, h, w, cout)).astype(dtype))


def _run_both(a, dilation, relu, with_residual):
    res = a["residual"] if with_residual else None
    ref = jax_fused(jnp.asarray(a["x"]), jnp.asarray(a["wd"]),
                    jnp.asarray(a["wp"]), jnp.asarray(a["scale"]),
                    jnp.asarray(a["bias"]), dilation=dilation, relu=relu,
                    residual=None if res is None else jnp.asarray(res))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = F.fused_separable_conv(
        t["x"], t["wd"], t["wp"], t["scale"], t["bias"], dilation=dilation,
        relu=relu, residual=t["residual"] if with_residual else None)
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dilation", [1, 2])
def test_plain_matches_jax_kernel(dilation, relu, with_residual):
    b, h, w, cin, cout = 2, 16, 11, 8, 16
    assert _pick_band(h, w, cin, cout, dilation) is not None  # Pallas path
    a = _inputs(dilation * 4 + relu * 2 + with_residual, b, h, w, cin, cout)
    ref, got = _run_both(a, dilation, relu, with_residual)
    assert got.shape == ref.shape == (b, h, w, cout)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dilation", [1, 2])
def test_plain_matches_jax_fallback_shape(dilation):
    """Odd H has no whole row-band tiling: JAX falls back to its lax
    reference; the port takes any H."""
    b, h, w, cin, cout = 1, 7, 5, 4, 8
    assert _pick_band(h, w, cin, cout, dilation) is None
    a = _inputs(11, b, h, w, cin, cout)
    ref, got = _run_both(a, dilation, True, True)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_plain_bf16_rounding_order_matches_jax_kernel():
    """bf16 activations: both round the fp32 taps to bf16 before the
    pointwise product and round once on store. A differently ordered fp32
    sum may flip one rounding, so one bf16 step (2^-8 relative, 2^-7 of
    magnitude near 1) is allowed."""
    import ml_dtypes
    a = _inputs(5, 1, 8, 8, 16, 16)
    a["x"] = a["x"].astype(ml_dtypes.bfloat16)
    a["residual"] = a["residual"].astype(ml_dtypes.bfloat16)
    ref = jax_fused(jnp.asarray(a["x"]), jnp.asarray(a["wd"]),
                    jnp.asarray(a["wp"]), jnp.asarray(a["scale"]),
                    jnp.asarray(a["bias"]), dilation=1, relu=True,
                    residual=jnp.asarray(a["residual"]))
    ref = np.asarray(ref).astype(np.float32)
    t = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in a.items()}
    got = F.fused_separable_conv(
        t["x"].bfloat16(), t["wd"], t["wp"], t["scale"], t["bias"],
        dilation=1, relu=True, residual=t["residual"].bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                               atol=2 ** -7)


@pytest.mark.parametrize("dilation", [1, 2])
def test_module_fused_matches_jax_module(dilation):
    """SeparableConvBN(fused=True) with the residual epilogue, weights
    carried over by from_jax_variables, BN statistics perturbed so the
    folded affine is non-trivial. Both modules in eval mode, as JAX's
    ``train=False``: the fused route serves inference only."""
    import jax
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 12, 12, 8)).astype(np.float32)
    res = rng.normal(0, 1, (2, 12, 12, 16)).astype(np.float32)
    jmod = jax_layers.SeparableConvBN(16, dilation=(dilation, dilation),
                                      relu=False, fused=True,
                                      dtype=jnp.float32)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(0.0, 0.2, v.shape
                                              ).astype(np.float32),
        variables)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False,
                                residual=jnp.asarray(res)))
    mod = SeparableConvBN(8, 16, dilation=(dilation, dilation), relu=False,
                          fused=True, dtype=torch.float32).eval()
    mod.load_state_dict(from_jax_variables(variables))
    mod.prepare_for_inference()
    with torch.inference_mode():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        rt = torch.from_numpy(res).permute(0, 3, 1, 2)
        got = mod(xt, residual=rt).permute(0, 2, 3, 1).numpy()
        unfused = SeparableConvBN(8, 16, dilation=(dilation, dilation),
                                  relu=False, dtype=torch.float32).eval()
        unfused.load_state_dict(mod.state_dict())
        got_unfused = unfused(xt, residual=rt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_unfused, ref, rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_non_cuda_device_without_fallback(monkeypatch):
    """No tensor off the CPU is quietly computed by the plain version: on
    the meta device the operator gives only its output's shape (its fake
    implementation, which export traces through), launching nothing; the
    CUDA implementation, handed tensors that are not on a card, raises."""
    monkeypatch.setattr(F, "reference_separable_conv", None)
    a = {k: torch.from_numpy(v).to("meta")
         for k, v in _inputs(0, 1, 4, 4, 8, 8).items()}
    out = F.fused_separable_conv(a["x"], a["wd"], a["wp"], a["scale"],
                                 a["bias"])
    assert out.device.type == "meta" and out.shape == (1, 4, 4, 8)
    assert F.fused_separable_conv.launches == 0
    ops = F.prepare_weights(*(torch.zeros_like(a[k], device="cpu")
                              for k in ("wd", "wp", "scale", "bias")))
    with pytest.raises(ValueError, match="CUDA"):
        F.launch_cuda(torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16),
                      *ops, None, 1, True, F.ROUTE)
    assert F.fused_separable_conv.launches == 0


# Kernel B2's calls per batch of config 3 at 800 px (H, W, Cin, Cout, d), as
# chip_smoke.B2_SHAPES lists them.
CONFIG3_SHAPES = [(200, 200, 128, 128, 1), (100, 100, 256, 256, 1),
                  (50, 50, 512, 512, 1), (50, 50, 512, 1024, 2),
                  (50, 50, 1024, 1024, 2)]


@pytest.mark.parametrize("h,w,cin,cout,d", CONFIG3_SHAPES)
def test_tma_plan_fits_one_block_per_sm(h, w, cin, cout, d):
    """At batch 16 the plan fits the 232,448 bytes of shared memory a block
    may use, keeps 2 or more ring stages and takes at most one block per
    SM of the 132."""
    p = F.plan_launch(16, h, w, cin, cout, d, 132)
    assert p.smem_bytes == F.smem_bytes(p.th, p.tw, d, p.stages, p.bn)
    assert p.smem_bytes <= 232448 and 2 <= p.stages <= F.MAX_STAGES
    assert p.th * p.tw <= F.ROWS and p.bn in (F.BN, 2 * F.BN)
    assert p.grid == min(p.units, 132)
    assert F.takes(cin, cout)


@pytest.mark.parametrize("b,h,w,cin,cout,d", [
    (2,) + s for s in CONFIG3_SHAPES] + [
    (1, 37, 53, 64, 96, 1), (2, 13, 29, 72, 24, 2), (1, 1, 1, 32, 128, 1)])
def test_tma_plan_tiles_cover_every_output_once(b, h, w, cin, cout, d):
    """The work units, decoded as the kernel decodes them and clipped at
    the image's edge and at Cout (as TMA clips its stores), write every
    output element exactly once."""
    p = F.plan_launch(b, h, w, cin, cout, d, 132)
    seen = np.zeros((b, h, w, cout), np.int8)
    for u in range(p.units):
        bi, h0, w0, n0 = p.unit(u)
        seen[bi, h0:h0 + p.th, w0:w0 + p.tw, n0:n0 + p.bn] += 1
    assert (seen == 1).all()


# Kernel B2's shapes in xdet_xception at 512 px (stage 4 at stride 32, not
# dilated), batch 8, as chip_smoke.XDET_B2_SHAPES lists them.
XDET_SHAPES = [(128, 128, 128, 128, 1), (64, 64, 256, 256, 1),
               (32, 32, 512, 512, 1), (16, 16, 1024, 1024, 1)]


@pytest.mark.parametrize("h,w,cin,cout,d", XDET_SHAPES)
def test_tma_plan_at_xdet_shapes(h, w, cin, cout, d):
    """At batch 8 each plan fits a block's shared memory, and its units
    cover every output once. At 16 x 16 x 1024 there are fewer units than
    SMs: the persistent grid then takes one block a unit."""
    p = F.plan_launch(8, h, w, cin, cout, d, 132)
    assert p.smem_bytes <= 232448 and 2 <= p.stages <= F.MAX_STAGES
    assert p.grid == min(p.units, 132)
    if h == 16:
        assert p.units < 132 and p.grid == p.units
    seen = np.zeros((8, h, w, cout), np.int8)
    for u in range(p.units):
        bi, h0, w0, n0 = p.unit(u)
        seen[bi, h0:h0 + p.th, w0:w0 + p.tw, n0:n0 + p.bn] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("h,w,cin,cout,res,ms,by", [
    (200, 200, 128, 128, False, 0.098, "bytes"),
    (200, 200, 128, 128, True, 0.147, "bytes"),
    (100, 100, 256, 256, False, 0.049, "bytes"),
    (100, 100, 256, 256, True, 0.073, "bytes"),
    (50, 50, 512, 512, False, 0.025, "bytes"),
    (50, 50, 512, 512, True, 0.037, "bytes"),
    (50, 50, 512, 1024, False, 0.043, "operations"),
    (50, 50, 1024, 1024, False, 0.086, "operations"),
    (50, 50, 1024, 1024, True, 0.086, "operations"),
])
def test_bound_matches_the_roofline_of_each_config3_shape(h, w, cin, cout,
                                                          res, ms, by):
    """max(2 P Cin (9 + Cout) / 989 TFLOP/s, bytes moved once / 3.35
    TB/s) at batch 16, to the microsecond."""
    got, binds = F.bound_ms(16, h, w, cin, cout, res)
    assert round(got, 3) == ms and binds == by


def test_plan_constants_mirror_the_kernel_source():
    """ops/fused_sepconv.py restates the kernel's fixed geometry to plan
    its launches; the two must agree."""
    import re
    from x_detector_tpu_torch import _build
    src = (_build.CSRC / "fused_sepconv.cu").read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    for name in ("KC", "BN", "ROWS", "BAR_BYTES"):
        assert const[name] == getattr(F, name), name
    assert const["MAX_STAGES"] >= F.MAX_STAGES


def test_tma_route_takes_only_channel_counts_that_tma_can_address():
    """The kernel takes Cin and Cout that are multiples of 8; its CUDA
    implementation refuses other widths before anything else."""
    assert F.takes(128, 128) and F.takes(8, 16)
    assert not F.takes(40, 130) and not F.takes(12, 16)
    assert not F.takes(130, 40)
    a = {k: torch.from_numpy(v) for k, v in _inputs(0, 1, 4, 4, 12, 16)
         .items()}
    ops = F.prepare_weights(a["wd"], a["wp"], a["scale"], a["bias"])
    with pytest.raises(ValueError, match="multiples of 8"):
        F.launch_cuda(a["x"].bfloat16(), *ops, None, 1, True, F.ROUTE)
    assert F.fused_separable_conv.launches == 0


@pytest.mark.parametrize("cin,cout", [(8, 16), (24, 40), (40, 130)])
def test_prepared_weights_on_the_cpu_take_the_plain_version(cin, cout):
    """``wp`` is [Cout, Cin] for every width, and the operator's plain
    version on the prepared operands is the plain function itself."""
    a = {k: torch.from_numpy(v)
         for k, v in _inputs(4, 2, 6, 7, cin, cout).items()}
    ops = F.prepare_weights(a["wd"], a["wp"], a["scale"], a["bias"],
                            dtype=torch.float32)
    assert ops.wp.shape == (cout, cin) and torch.equal(ops.wp, a["wp"].t())
    assert ops.wp.dtype == torch.float32 and ops.wp.is_contiguous()
    got = F.fused_separable_conv_prepared(a["x"], ops, dilation=2,
                                          residual=a["residual"])
    ref = F.reference_separable_conv(a["x"], a["wd"], a["wp"], a["scale"],
                                     a["bias"], dilation=2,
                                     residual=a["residual"])
    assert torch.equal(got, ref)


def test_module_caches_fused_operands_per_weight_version():
    """SeparableConvBN holds the fused route's operands in buffers once
    prepared (eval mode only) and reads them in its forward; it drops them
    on load_state_dict and train(), and an eval-mode forward without them
    raises, naming the prepare step, rather than make them itself. Prepared
    operands equal fresh ones."""
    torch.manual_seed(0)
    mod = SeparableConvBN(8, 16, fused=True, dtype=torch.float32).eval()
    x = torch.randn(2, 8, 5, 6)

    def fresh():
        scale, bias = mod.bn.folded()
        return F.prepare_weights(mod.Conv_0.weight[:, 0].permute(1, 2, 0),
                                 mod.Conv_1.weight[:, :, 0, 0].t(), scale,
                                 bias, dtype=torch.float32)

    def same(ops, ref):
        for got, want in zip(ops[:4], ref[:4]):
            torch.testing.assert_close(got, want, rtol=0, atol=0)

    def unprepared():
        assert mod.fused_wp is None
        with pytest.raises(ValueError, match="prepare_for_inference"):
            mod.fused_weights()
        with pytest.raises(ValueError, match="prepare_for_inference"):
            mod(x)

    unprepared()
    mod.prepare_for_inference()
    first = mod.fused_weights()
    assert first.wp is mod.fused_wp and mod.fused_weights().wp is first.wp
    assert "fused_wp" not in mod.state_dict()        # not persistent
    same(first, fresh())
    state = {k: v + 0.1 for k, v in mod.state_dict().items()}
    mod.load_state_dict(state)
    unprepared()
    mod.prepare_for_inference()
    second = mod.fused_weights()
    assert second.wp is not first.wp
    same(second, fresh())
    mod.train()
    assert mod.fused_wp is None
    with pytest.raises(ValueError, match="eval"):
        mod.prepare_for_inference()
    mod.eval()
    unprepared()
    mod.prepare_for_inference()
    with torch.inference_mode():
        got = mod(x)
        unfused = SeparableConvBN(8, 16, dtype=torch.float32).eval()
        unfused.load_state_dict(mod.state_dict())
        torch.testing.assert_close(got, unfused(x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin,cout", [(40, 130), (12, 16), (130, 40)])
def test_block_of_a_width_the_kernel_does_not_take_runs_unfused(cin, cout):
    """An eval block with the fused flag whose Cin or Cout is not a
    multiple of 8 takes the unfused route: it holds no fused operands once
    prepared and gives the bits of the same block built unfused."""
    torch.manual_seed(cin + cout)
    mod = SeparableConvBN(cin, cout, fused=True, dtype=torch.float32).eval()
    mod.bn.running_mean.uniform_(-0.2, 0.2)
    mod.bn.running_var.uniform_(0.5, 1.5)
    assert not mod.takes_fused_route
    mod.prepare_for_inference()
    assert all(getattr(mod, name) is None for name in
               ("fused_wd", "fused_wp", "fused_scale", "fused_bias"))
    unfused = SeparableConvBN(cin, cout, dtype=torch.float32).eval()
    unfused.load_state_dict(mod.state_dict())
    x = torch.randn(2, cin, 5, 6)
    with torch.inference_mode():
        assert torch.equal(mod(x), unfused(x))


def test_operator_schema_keeps_its_route_argument():
    """``xdt::fused_sepconv`` is registered as programs exported with it
    name it, trailing ``str route`` included; every implementation takes
    only the one kernel's route and names the retired design otherwise."""
    assert str(torch.ops.xdt.fused_sepconv.default._schema) == (
        "xdt::fused_sepconv(Tensor x, Tensor wd, Tensor wp, Tensor scale, "
        "Tensor bias, Tensor? residual, int dilation, bool relu, str route)"
        " -> Tensor")
    a = {k: torch.from_numpy(v) for k, v in _inputs(1, 1, 4, 4, 8, 16)
         .items()}
    ops = F.prepare_weights(a["wd"], a["wp"], a["scale"], a["bias"],
                            dtype=torch.float32)
    for device in ("cpu", "meta"):
        args = [t.to(device) for t in (a["x"], *ops)]
        op = torch.ops.xdt.fused_sepconv.default
        assert op(*args, None, 1, True, "tma").shape == (1, 4, 4, 16)
        with pytest.raises(ValueError, match="first design was retired"):
            op(*args, None, 1, True, "wmma")
    with pytest.raises(ValueError, match="first design was retired"):
        F.launch_cuda(a["x"].bfloat16(), *ops, None, 1, True, "wmma")


def test_unfused_cudnn_yardstick_computes_the_same_function():
    """chip_smoke's yardstick for B2 (depthwise conv, 1x1 conv, folded BN,
    residual, ReLU as separate calls) computes what the kernel computes; in
    bf16 it rounds at two more places, so it is held at 5e-2 of the
    scale."""
    import pathlib
    import sys
    root = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    a = {k: torch.from_numpy(v) for k, v in _inputs(6, 2, 9, 7, 16, 24)
         .items()}
    x, res = a["x"].bfloat16(), a["residual"].bfloat16()
    run = chip_smoke.unfused_cudnn(x, a["wd"], a["wp"], a["scale"],
                                   a["bias"], dilation=2, relu=True,
                                   residual=res)
    got = run().permute(0, 2, 3, 1).float()
    ref = F.reference_separable_conv(x, a["wd"], a["wp"], a["scale"],
                                     a["bias"], dilation=2, residual=res)
    scale = ref.float().abs().max().item()
    assert (got - ref.float()).abs().max().item() <= 5e-2 * scale
