"""The port's act8 training probe (``QuantConv(mode="act8")``) against the
JAX package's.

act8's forward is the plain conv; its backward reads an int8 copy of the
activation (K3's function, ``clip(round(x / s), -127, 127)`` with ``s =
max|x| / 127 + 1e-12``; on the CPU its plain version). Both sides run fp32
on the CPU, the JAX convs applied eagerly (a jitted apply would multiply by
fp32(1/127) where it divides). Tolerances, after the JAX package's own
test (``tests/test_quant.py::test_act8_exact_dx_quantized_dk``): forward
and dL/dx within 1e-6 of their scale (JAX's and torch's convs sum fp32 in
other orders) and bitwise equal to the port's plain conv's (dL/dx reads no
activation: exact); dL/dbias exactly equal (sums of integers); dL/dk
against JAX's act8 dL/dk within 1e-5 of its scale (the same int8
activation, summed in another order) and 0 < relative RMS < 0.02 against
the unquantized dL/dk. Whole steps: the metrics, and every gradient that
reads no int8 activation, within the whole-step tolerance
(``tests/test_torch_train.py``: STEP_RTOL of each leaf's largest value);
the backbone's conv kernels' gradients within ACT8_DK_REL of theirs: an
fp32 sum an ulp apart before a conv may put an activation on the other
side of a rounding boundary of the int8 grid (as in the int8 tests), and
each such flip moves dL/dk by a grid step's share; 0.02 is the JAX
package's bound on act8's whole effect on dL/dk.
"""

import copy
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import flax.linen  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from test_torch_ssd_train import RELU_SMOOTH, _train_cfg, _two_steps  # noqa
from test_torch_train import STEP_RTOL, _assert_leaves_close  # noqa: E402
from test_train import get_batch, small_lighthead_cfg  # noqa: E402
from x_detector_tpu.models import layers as jax_layers  # noqa: E402
from x_detector_tpu.models import lighthead as L  # noqa: E402
from x_detector_tpu.ops.pallas import psroi_align_kernel as K  # noqa: E402
from x_detector_tpu.train import trainer as jax_trainer  # noqa: E402
from x_detector_tpu_torch import config, inference, quant  # noqa: E402
from x_detector_tpu_torch.models import layers  # noqa: E402
from x_detector_tpu_torch.models.lighthead import LightHeadRCNN  # noqa: E402
from x_detector_tpu_torch.ops import int8_conv  # noqa: E402
from x_detector_tpu_torch.train import schedule  # noqa: E402
from x_detector_tpu_torch.train.train_state import TrainState  # noqa: E402
from x_detector_tpu_torch.train.trainer import make_train_step  # noqa: E402
from x_detector_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

TOL = 1e-6
DK_REL = 1e-5
ACT8_DK_REL = 2e-2

# (features, kernel, strides, dilation, depthwise, bias), input 2 x 12 x 12
# x 8: a stride-2 3x3 on 12 px pads (0, 1), asymmetric SAME
CONVS = {
    "dense_bias": (12, (3, 3), (1, 1), (1, 1), False, True),
    "depthwise": (8, (3, 3), (1, 1), (1, 1), True, False),
    "dilated": (12, (3, 3), (1, 1), (2, 2), False, False),
    "strided_same": (12, (3, 3), (2, 2), (1, 1), False, True),
    "depthwise_strided": (8, (3, 3), (2, 2), (1, 1), True, False),
}


def _jax_grads(mod, variables, x):
    def loss(params, xx):
        y = mod.apply(params, xx)
        return (y * jnp.arange(y.size, dtype=y.dtype).reshape(y.shape)).sum()

    y = mod.apply(variables, x)
    gp, gx = jax.grad(loss, argnums=(0, 1))(variables, x)
    return np.asarray(y), gp["params"], np.asarray(gx)


@pytest.fixture(scope="module", params=sorted(CONVS))
def conv_pair(request):
    """JAX's float and act8 QuantConv-shaped convs and the port's act8
    QuantConv with the same weights: outputs and gradients of
    sum(y * arange)."""
    feats, kernel, strides, dilation, depthwise, bias = CONVS[request.param]
    x = np.random.default_rng(1).normal(0, 1, (2, 12, 12, 8)).astype(
        np.float32)
    groups = 8 if depthwise else 1
    common = dict(features=feats, kernel_size=kernel, strides=strides,
                  kernel_dilation=dilation, feature_group_count=groups,
                  use_bias=bias, dtype=jnp.float32)
    a8 = jax_layers.QuantConv(mode="act8", **common)
    variables = jax.tree_util.tree_map(np.asarray, a8.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    if bias:
        variables["params"]["bias"] = np.random.default_rng(2).normal(
            0, 1, (feats,)).astype(np.float32)
    ref = jax.tree_util.tree_map(jnp.asarray, variables)
    want = _jax_grads(a8, ref, jnp.asarray(x))
    # the unquantized conv: flax's, with the same parameter tree
    plain = flax.linen.Conv(feats, kernel, strides=strides,
                            kernel_dilation=dilation, padding="SAME",
                            feature_group_count=groups, use_bias=bias,
                            dtype=jnp.float32)
    unq = _jax_grads(plain, ref, jnp.asarray(x))

    port = layers.QuantConv(8, feats, kernel, strides, dilation,
                            groups=groups, bias=bias, mode="act8",
                            dtype=torch.float32)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = port(xt)
    yn = y.permute(0, 2, 3, 1)
    (yn * torch.arange(yn.numel(), dtype=torch.float32).reshape(
        yn.shape)).sum().backward()
    got = (yn.detach().numpy(), port, xt.grad.permute(0, 2, 3, 1).numpy())
    return request.param, want, unq, got


def _close_to_scale(got, want, rel, what):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def test_act8_forward_and_dx_match_jax(conv_pair):
    """Within 1e-6 of the scale of JAX's act8 conv; bitwise the port's
    plain conv of the same module (its forward, and its dL/dx: exact)."""
    name, want, unq, (y, port, dx) = conv_pair
    _close_to_scale(y, want[0], TOL, name)
    _close_to_scale(dx, want[2], TOL, name)
    _close_to_scale(dx, unq[2], TOL, name)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (2, 12, 12, 8)).astype(np.float32)).permute(0, 3, 1, 2)
    x = x.requires_grad_()
    yp = layers.conv2d(x, copy.deepcopy(port), "SAME", torch.float32)
    if port.bias is None:                 # the bias is added after the conv
        yp = yp.contiguous()
    yn = yp.permute(0, 2, 3, 1)
    (yn * torch.arange(yn.numel(), dtype=torch.float32).reshape(
        yn.shape)).sum().backward()
    assert np.array_equal(x.grad.permute(0, 2, 3, 1).numpy(), dx), name
    if port.bias is None:
        assert np.array_equal(yn.detach().numpy(), y), name


def test_act8_dbias_exact_and_dk_quantized(conv_pair):
    name, want, unq, (_, port, _) = conv_pair
    grads = from_jax_variables({"params": jax.tree_util.tree_map(
        np.asarray, want[1])})
    if port.bias is not None:
        assert torch.equal(port.bias.grad, grads["bias"])
    dk, ref = port.weight.grad.double(), grads["weight"].double()
    assert (dk - ref).abs().max() <= DK_REL * ref.abs().max(), name
    unq_dk = from_jax_variables({"params": jax.tree_util.tree_map(
        np.asarray, unq[1])})["weight"].double()
    rms = ((dk - unq_dk).pow(2).mean().sqrt()
           / unq_dk.pow(2).mean().sqrt()).item()
    assert 0.0 < rms < 0.02, (name, rms)


def test_act8_quantizes_through_k3_once_a_forward(monkeypatch):
    """A forward that records a gradient quantizes its input once, through
    K3's function (``int8_conv.quantize_activation``) at s = max|x| / 127
    + 1e-12, and saves only that int8 copy; without a gradient it is the
    plain conv and quantizes nothing."""
    calls = []
    right = int8_conv.quantize_activation

    def spy(x, sx):
        calls.append(float(sx))
        return right(x, sx)

    monkeypatch.setattr(int8_conv, "quantize_activation", spy)
    conv = layers.QuantConv(4, 6, (3, 3), mode="act8", dtype=torch.float32)
    x = torch.randn(2, 4, 7, 7, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        plain = layers.conv2d(x, conv, "SAME", torch.float32)
        assert torch.equal(conv(x), plain) and calls == []
    y = conv(x.requires_grad_())
    assert torch.equal(y, plain) and len(calls) == 1
    want = np.float32(np.abs(x.detach().numpy()).max()) / np.float32(127.0)
    assert calls[0] == np.float32(want + np.float32(1e-12))


def test_act8_modules_keep_the_float_state_dict():
    """act8 QuantConvs hold no act_amax, as a JAX act8 tree has no quant
    collection: the state dict is the float module's, and loads strictly
    both ways; config.check_backbone_quant accepts "act8"."""
    assert config.check_backbone_quant("act8") == "act8"
    for build in (lambda q: layers.ConvBN(8, 12, (3, 3), quant=q),
                  lambda q: layers.SeparableConvBN(8, 12, quant=q),
                  lambda q: layers.SeparableConvBN(8, 12, dense=True,
                                                   quant=q)):
        f, a = build(None), build("act8")
        assert ({k: v.shape for k, v in f.state_dict().items()}
                == {k: v.shape for k, v in a.state_dict().items()})
        a.load_state_dict(f.state_dict(), strict=True)


# ---- whole steps ------------------------------------------------------------

def _act8(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_quant="act8"))


def _assert_act8_grads_close(got, ref):
    """The backbone's conv kernels (dL/dk reads act8's int8 activation)
    within ACT8_DK_REL of each leaf's largest value, the rest within
    STEP_RTOL."""
    quantized = {n for n in ref if n.startswith("backbone.")
                 and n.endswith("Conv_0.weight") or n.startswith(
                     "backbone.") and n.endswith("Conv_1.weight")}
    assert quantized
    _assert_leaves_close({n: got[n] for n in ref if n not in quantized},
                         {n: v for n, v in ref.items()
                          if n not in quantized}, "gradient")
    for n in quantized:
        want = ref[n].numpy()
        err = np.abs(got[n].detach().numpy() - want).max()
        assert err <= ACT8_DK_REL * np.abs(want).max(), (n, err)


def test_act8_lighthead_step_matches_jax():
    """The tiny Light-Head's act8 step from JAX's act8 weights, batch and
    RPN draws (``tests/test_torch_train.py``'s whole step): metrics,
    gradients and BatchNorm statistics within STEP_RTOL; every parameter
    moves; K3 once a backbone conv."""
    from test_torch_train import _jax_step_priorities
    cfg = _act8(small_lighthead_cfg())
    model, state = jax_trainer.create_model_and_state(
        cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    assert "quant" not in jax.tree_util.tree_map(lambda x: 0, {
        "params": state.params, "batch_stats": state.batch_stats})
    batch = get_batch(cfg)
    key = jax.random.PRNGKey(11)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        mp.setattr(L, "batched_psroi_align", K.batched_psroi_align_pallas)
        grads, new_bs, metrics = jax.jit(jax_trainer.make_grad_fn(
            jax_trainer.make_loss_fn(model, cfg), 1))(
            state.params, state.batch_stats, batch, key)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    port = LightHeadRCNN(cfg.model, dtype=torch.float32)
    port.load_state_dict(from_jax_variables(np_tree(
        {"params": state.params, "batch_stats": state.batch_stats})),
        strict=True)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    optimizer, sched = schedule.make_optimizer(port, cfg.train)
    pstate = TrainState.create(port, optimizer, sched)
    pri = _jax_step_priorities(key, cfg.train.batch_size, 1,
                               port.anchors.shape[0])
    calls = []
    right = int8_conv.quantize_activation
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(int8_conv, "quantize_activation",
                   lambda x, s: calls.append(1) or right(x, s))
        _, got_metrics = make_train_step(port, cfg)(
            pstate, {k: torch.from_numpy(np.asarray(v))
                     for k, v in batch.items()}, priorities=pri)
    assert len(calls) == len(quant.quant_convs(port)) > 0
    for k, want in metrics.items():
        np.testing.assert_allclose(got_metrics[k].item(), float(want),
                                   rtol=STEP_RTOL, atol=1e-6, err_msg=k)
    _assert_act8_grads_close(
        {n: p.grad for n, p in port.named_parameters()},
        from_jax_variables({"params": np_tree(grads)}))
    _assert_leaves_close(
        {n: b for n, b in port.named_buffers()
         if n.endswith(("running_mean", "running_var"))},
        from_jax_variables({"batch_stats": np_tree(new_bs)}), "batch stats")
    assert all(not torch.equal(before[n], p)
               for n, p in port.named_parameters())


def test_act8_ssd_steps_match_jax():
    """config 2's thin SSD, two act8 steps with its EMA at 256 px on both
    sides (``tests/test_torch_ssd_train.py``'s steps, ReLU smoothed on both
    sides as there): metrics and gradients within STEP_RTOL, every
    gradient-carrying parameter moved."""
    cfg = _act8(_train_cfg("ssd_resnet50", 1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "relu",
                   lambda x: x * jax.nn.sigmoid(x / RELU_SMOOTH))
        mp.setattr(torch.nn.functional, "relu",
                   lambda x: x * torch.sigmoid(x / RELU_SMOOTH))
        _, ref, got = _two_steps(cfg, 1)
    for k, want in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], want, rtol=STEP_RTOL,
                                   atol=1e-6, err_msg=k)
    _assert_act8_grads_close(got["grads"], ref["grads"])
    with_grad = [n for n, g in got["grads"].items() if g.any()]
    assert len(with_grad) > len(got["grads"]) // 2
    assert all(not torch.equal(got["params2"][n], ref["params0"][n])
               for n in with_grad)


def test_build_model_with_act8_detects_as_the_float_model():
    """Inference ignores act8 (no gradient, no quantization): the same
    weights detect bit for bit as the float model."""
    from test_train import small_ssd_cfg
    cfg = small_ssd_cfg()
    want_model = inference.build_model(cfg.model, "cpu", seed=0,
                                       dtype=torch.float32)
    got_model = inference.build_model(_act8(cfg).model, "cpu", seed=0,
                                      dtype=torch.float32)
    got_model.load_state_dict(want_model.state_dict(), strict=True)
    images = torch.from_numpy(np.asarray(get_batch(cfg)["image"]))
    want = inference.build_eval_fn(want_model, cfg, "cpu")(images)
    got = inference.build_eval_fn(got_model, _act8(cfg), "cpu")(images)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
