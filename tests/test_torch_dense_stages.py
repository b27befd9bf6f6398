"""The port's dense Xception-lite stages (``XceptionLite(dense_stages=N)``,
``SeparableConvBN(dense=True)``) against the JAX package's.

JAX's weights (BatchNorms moved off identity) carried by
``from_jax_variables`` (strict: a dense block's ``Conv_0`` kernel
[3, 3, Cin, Cout] maps onto an OIHW 3x3), both sides fp32 on the CPU, the
JAX package's fused kernel in Pallas interpret mode. Tolerances: c3, c4,
c5 within 1e-5 of their scale (``tests/test_torch_resnet.py``'s
REL_TOL: the same sums in another order); training mode's running stats
too; int8 within the int8 tests' boundary-flip tolerance (rtol 1e-3, atol
1e-2, ``tests/test_torch_quant.py``).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from test_torch_resnet import (assert_close_to_scale, jax_init,  # noqa: E402
                               perturb_bn)
from x_detector_tpu.models import xception as jax_xception  # noqa: E402
from x_detector_tpu_torch.models import layers, xception  # noqa: E402
from x_detector_tpu_torch.ops import fused_sepconv  # noqa: E402
from x_detector_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

WIDTHS, UNITS = (16, 32, 48, 64), (2, 1, 1, 1)
BOUNDARY_RTOL, BOUNDARY_ATOL = 1e-3, 1e-2


def _x(scale=1.0):
    return (np.random.default_rng(4).normal(0, 1, (2, 32, 32, 3)) * scale
            ).astype(np.float32)


def _jax(dense, fused=False, quant=None):
    return jax_xception.XceptionLite(
        widths=WIDTHS, units_per_stage=UNITS, dense_stages=dense,
        fused_sepconv=fused, quant=quant, dtype=jnp.float32)


def _port(dense, variables, fused=False, quant=None):
    model = xception.XceptionLite(widths=WIDTHS, units_per_stage=UNITS,
                                  dense_stages=dense, fused_sepconv=fused,
                                  quant=quant, dtype=torch.float32)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.fixture(scope="module", params=[1, 2], ids=["dense1", "dense2"])
def dense_pair(request):
    dense = request.param
    x = _x()
    variables = perturb_bn(jax_init(_jax(dense), jnp.asarray(x)))
    return dense, x, variables


def test_dense_blocks_hold_one_3x3(dense_pair):
    """Stage 1 (and stage 2 with 2) holds one dense 3x3 ``Conv_0`` a block,
    no ``Conv_1``; JAX's tree has the same kernels, HWIO."""
    dense, _, variables = dense_pair
    model = _port(dense, variables)
    for i, stage in enumerate((model.stage1, model.stage2, model.stage3), 1):
        for m in stage.modules():
            if isinstance(m, layers.SeparableConvBN):
                assert m.dense == (i <= dense)
                assert (m.Conv_1 is None) == (i <= dense)
                if m.dense:
                    assert m.Conv_0.groups == 1
                    assert m.Conv_0.kernel_size == (3, 3)
    k = variables["params"]["stage1"]["sep0a"]["Conv_0"]["kernel"]
    assert k.shape == (3, 3, WIDTHS[0], WIDTHS[0])
    assert np.array_equal(model.stage1.sep0a.Conv_0.weight.detach().numpy(),
                          k.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_dense_eval_forward_matches_jax(dense_pair, fused, monkeypatch):
    """Inference, unfused and fused: a dense block never takes B2's route
    (the fused model's B2 blocks are the separable stride-1 ones only)."""
    dense, x, variables = dense_pair
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    ref = jax.jit(lambda v: _jax(dense, fused).apply(v, x, train=False))(
        variables)
    model = _port(dense, variables, fused=fused).eval()
    layers.prepare_for_inference(model)
    routes = {name: m.takes_fused_route for name, m in model.named_modules()
              if isinstance(m, layers.SeparableConvBN)}
    assert not any(r for n, r in routes.items()
                   if n.startswith("stage1") or (dense == 2 and n.startswith(
                       "stage2")))
    assert sum(routes.values()) == (0 if not fused else
                                     {1: 4, 2: 3}[dense])
    calls = []
    right = fused_sepconv.fused_separable_conv_prepared
    monkeypatch.setattr(layers, "fused_separable_conv_prepared",
                        lambda *a, **k: calls.append(1) or right(*a, **k))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(calls) == sum(routes.values())
    for key in ("c3", "c4", "c5"):
        assert_close_to_scale(_nhwc(got[key]), ref[key], what=key)


def test_dense_train_forward_matches_jax(dense_pair):
    """Training mode: batch statistics, and the running stats moved as
    JAX's batch_stats move."""
    dense, x, variables = dense_pair
    ref, mut = jax.jit(lambda v: _jax(dense).apply(
        v, x, train=True, mutable=["batch_stats"]))(variables)
    model = _port(dense, variables).train()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for key in ("c3", "c4", "c5"):
        assert_close_to_scale(_nhwc(got[key]), ref[key], what=key)
    want = from_jax_variables({"batch_stats": jax.tree_util.tree_map(
        np.asarray, mut["batch_stats"])})
    state = model.state_dict()
    for key, value in want.items():
        assert_close_to_scale(state[key], value.numpy(), what=key)


def test_dense_int8_forward_matches_jax(dense_pair):
    """With quant: a dense block is one QuantConv 3x3. JAX's calibrated
    ranges (its quant collection, one act_amax a conv) carried over; the
    int8 backbone against JAX's jitted int8 apply."""
    dense, _, variables = dense_pair
    x = _x(100.0)
    _, mut = jax.jit(lambda v: _jax(dense, quant="calibrate").apply(
        v, x, train=False, mutable=["quant"]))(variables)
    qv = jax.tree_util.tree_map(np.asarray, mut["quant"])
    assert "Conv_1" not in qv["stage1"]["sep0a"]
    ref = jax.jit(lambda v: _jax(dense, quant="int8").apply(
        v, x, train=False))({**variables, "quant": qv})
    model = _port(dense, {**variables, "quant": qv}, quant="int8").eval()
    assert isinstance(model.stage1.sep0a.Conv_0, layers.QuantConv)
    assert not model.stage1.sep0a.Conv_0.depthwise
    layers.prepare_for_inference(model)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for key in ("c3", "c4", "c5"):
        np.testing.assert_allclose(_nhwc(got[key]), np.asarray(ref[key]),
                                   rtol=BOUNDARY_RTOL, atol=BOUNDARY_ATOL,
                                   err_msg=key)
