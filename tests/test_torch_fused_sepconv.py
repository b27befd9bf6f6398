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
    res = rng.normal(0, 1, (2, 12, 12, 12)).astype(np.float32)
    jmod = jax_layers.SeparableConvBN(12, dilation=(dilation, dilation),
                                      relu=False, fused=True,
                                      dtype=jnp.float32)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(0.0, 0.2, v.shape
                                              ).astype(np.float32),
        variables)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False,
                                residual=jnp.asarray(res)))
    mod = SeparableConvBN(8, 12, dilation=(dilation, dilation), relu=False,
                          fused=True, dtype=torch.float32).eval()
    mod.load_state_dict(from_jax_variables(variables))
    with torch.inference_mode():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        rt = torch.from_numpy(res).permute(0, 3, 1, 2)
        got = mod(xt, residual=rt).permute(0, 2, 3, 1).numpy()
        unfused = SeparableConvBN(8, 12, dilation=(dilation, dilation),
                                  relu=False, dtype=torch.float32).eval()
        unfused.load_state_dict(mod.state_dict())
        got_unfused = unfused(xt, residual=rt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_unfused, ref, rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_non_cuda_device_without_fallback():
    """A tensor that is neither on the CPU nor on a CUDA card is refused,
    not quietly computed by the plain version."""
    a = {k: torch.from_numpy(v).to("meta")
         for k, v in _inputs(0, 1, 4, 4, 8, 8).items()}
    with pytest.raises(ValueError, match="CUDA"):
        F.fused_separable_conv(a["x"], a["wd"], a["wp"], a["scale"],
                               a["bias"])
    assert F.fused_separable_conv.launches == 0
