"""The port's SSD / X-Det training (``ssd_loss`` and the whole step, with
the EMA shadow) against the JAX package, on the CPU in fp32.

``ssd_loss`` is held to JAX's per image at 1e-5, its gradient too, and the
anchors it mines (the rows with a gradient) exactly: on noise, on a run of
exactly tied losses that the ``int32(ratio * num_fg)`` cut goes through,
with no positives, and with more negatives asked for than there are.

The whole step runs the thin backbones of ``tests/test_torch_ssd.py``'s
``small_configs`` (ResNet; Xception with ``fpn_fusion``, whose fused flag is
for inference only, so both sides train unfused) from JAX's init with
BatchNorms moved off identity, ``grad_accum_steps`` 1 and 2 and the EMA
shadow at 0.99, and is held to JAX's ``make_grad_fn`` and
``TrainState.apply_gradients`` over two steps with the tolerances of
``tests/test_torch_train.py``'s whole-step tests. It runs at 256 px, not
at those configs' 64 and 128: there the last extra levels are 1 x 1 maps,
and BatchNorm's training statistics over a batch's two values (E[x^2] -
E[x]^2 in fp32, as both packages compute them) cancel, so the two sides'
roundings drive the train-mode logits 6e-3 (ResNet, 64 px) and 5e-4
(Xception, 128 px) of their scale apart; at 256 px every level has at
least 2 x 2 cells and the logits agree to 4e-6.

ReLU's gradient jumps at 0, and with random weights a few activations lie
within the two sides' rounding of it: 8 of xdet's BatchNorm outputs change
sign between the packages' fp32 forwards at 256 px (one of ResNet's), and
one such element moves a leaf's gradient by up to 1e-1 of its largest
value (measured against a float64 run of the port: JAX's fp32 gradient and
the port's fall on either side). So the whole-step tests run both packages
with every ReLU replaced by ``x * sigmoid(x / RELU_SMOOTH)``, the same
function in both (within 0.28 * RELU_SMOOTH of ReLU, its gradient
continuous): they hold the port's step arithmetic to JAX's, not the side
of 0 a rounding lands on. ReLU itself is held to JAX with its true
gradient by the inference tests and ``tests/test_torch_train.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import flax.linen  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_resnet import jax_init, perturb_bn  # noqa: E402
from test_torch_ssd import small_configs  # noqa: E402
from test_torch_train import STEP_RTOL, _assert_leaves_close  # noqa: E402
from test_train import get_batch  # noqa: E402
from x_detector_tpu.models import ssd as jax_ssd  # noqa: E402
from x_detector_tpu.train import losses as jax_losses  # noqa: E402
from x_detector_tpu.train import schedule as jax_schedule  # noqa: E402
from x_detector_tpu.train import trainer as jax_trainer  # noqa: E402
from x_detector_tpu.train.train_state import (  # noqa: E402
    TrainState as JaxTrainState)
from x_detector_tpu_torch.models.layers import SeparableConvBN  # noqa: E402
from x_detector_tpu_torch.models.ssd import SSDModel  # noqa: E402
from x_detector_tpu_torch.train import losses  # noqa: E402
from x_detector_tpu_torch.train import schedule  # noqa: E402
from x_detector_tpu_torch.train.train_state import TrainState  # noqa: E402
from x_detector_tpu_torch.train.trainer import make_train_step  # noqa: E402
from x_detector_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

LOSS_TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# ssd_loss
# ---------------------------------------------------------------------------

def _loss_case(name):
    """(cls [B, A, C], box [B, A, 4], labels, targets, fg [B, A], ratio)."""
    rng = np.random.default_rng(3)
    b, a, c = 3, 64, 5
    cls = rng.normal(0, 2, (b, a, c)).astype(np.float32)
    box = rng.normal(0, 1, (b, a, 4)).astype(np.float32)
    fg = np.zeros((b, a), bool)
    ratio = 3.0
    if name == "noise":
        for i, n in enumerate((4, 9, 1)):
            fg[i, rng.choice(a, n, replace=False)] = True
    elif name == "ties":
        # 5 positives and ratio 2.5: int32(12.5) = 12 negatives, the 7 of
        # distinct high loss, then 5 of a run of 10 identical rows
        ratio = 2.5
        fg[:, :5] = True
        row = np.zeros(c, np.float32)
        for j, lead in enumerate(np.linspace(-6.0, -3.0, 7)):
            cls[:, 5 + j] = row
            cls[:, 5 + j, 0] = lead
        cls[:, 12:22] = row
        cls[:, 12:22, 0] = -2.0
        cls[:, 22:] = row
        cls[:, 22:, 0] = 3.0                    # low loss, also tied
        cls[1] = cls[1, rng.permutation(a)]     # ties spread out, and fg too
        fg[1] = fg[1, rng.permutation(a)]
    elif name == "no_fg":
        pass
    elif name == "ratio_exceeds_bg":
        fg[:, : a - 10] = True                  # 3 x 54 > 10 negatives
    labels = np.where(fg, rng.integers(1, c, (b, a)), 0).astype(np.int32)
    tgt = np.where(fg[..., None], rng.normal(0, 1, (b, a, 4)), 0.0).astype(
        np.float32)
    return cls, box, labels, tgt, fg, ratio


@pytest.mark.parametrize("case", ["noise", "ties", "no_fg",
                                  "ratio_exceeds_bg"])
def test_ssd_loss_matches_jax(case):
    """Loss, metrics and the gradients of both inputs within 1e-5; the
    anchors that get a class gradient (positives and mined negatives)
    exactly JAX's."""
    cls, box, labels, tgt, fg, ratio = _loss_case(case)
    tc, tb = _t(cls).requires_grad_(), _t(box).requires_grad_()
    total, metrics = losses.ssd_loss(tc, tb, _t(labels), _t(tgt), _t(fg),
                                     neg_pos_ratio=ratio)
    total.sum().backward()
    for b in range(cls.shape[0]):
        args = [jnp.asarray(v[b]) for v in (labels, tgt, fg)]
        fn = lambda c, x: jax_losses.ssd_loss(c, x, *args,
                                              neg_pos_ratio=ratio)
        (ref_total, ref_m), (g_cls, g_box) = jax.value_and_grad(
            fn, argnums=(0, 1), has_aux=True)(jnp.asarray(cls[b]),
                                              jnp.asarray(box[b]))
        np.testing.assert_allclose(total[b].item(), float(ref_total),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        for k, v in ref_m.items():
            np.testing.assert_allclose(metrics[k][b].item(), float(v),
                                       rtol=LOSS_TOL, atol=LOSS_TOL,
                                       err_msg=k)
        np.testing.assert_allclose(tc.grad[b].numpy(), np.asarray(g_cls),
                                   atol=LOSS_TOL, rtol=0)
        np.testing.assert_allclose(tb.grad[b].numpy(), np.asarray(g_box),
                                   atol=LOSS_TOL, rtol=0)
        np.testing.assert_array_equal((tc.grad[b] != 0).any(-1).numpy(),
                                      (np.asarray(g_cls) != 0).any(-1))
    counted = (tc.grad != 0).any(-1).sum(-1).tolist()
    want = {"noise": [16, 36, 4], "ties": [17] * 3, "no_fg": [0] * 3,
            "ratio_exceeds_bg": [64] * 3}[case]
    assert counted == want


# ---------------------------------------------------------------------------
# The whole step
# ---------------------------------------------------------------------------

TRAIN_SIZE = 256
RELU_SMOOTH = 1e-2


def _train_cfg(preset, accum):
    cfg = small_configs()[preset]
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, image_size=TRAIN_SIZE), data=dataclasses.replace(
        cfg.data, image_size=TRAIN_SIZE), train=dataclasses.replace(
        cfg.train, batch_size=2, ema_decay=0.99, grad_accum_steps=accum))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=[
    ("ssd_resnet50", 1), ("ssd_resnet50", 2), ("xdet_xception", 1),
    ("xdet_xception", 2)], ids=lambda p: f"{p[0]}-accum{p[1]}")
def ssd_steps(request):
    """Two train steps on both sides from the same weights and batches.
    Returns (cfg, reference, port) readings: step 1's metrics, gradients
    and batch stats; the initial parameters; after step 2 the parameters
    and the EMA shadow."""
    preset, accum = request.param
    cfg = _train_cfg(preset, accum)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "relu",
                   lambda x: x * jax.nn.sigmoid(x / RELU_SMOOTH))
        mp.setattr(torch.nn.functional, "relu",
                   lambda x: x * torch.sigmoid(x / RELU_SMOOTH))
        return _two_steps(cfg, accum)


def _two_steps(cfg, accum):
    size = cfg.model.image_size
    module = jax_ssd.SSDModel(config=cfg.model, dtype=jnp.float32)
    variables = perturb_bn(jax_init(module, jnp.zeros((1, size, size, 3))))
    batches = [get_batch(cfg, seed=s) for s in (0, 1)]
    key = jax.random.PRNGKey(11)

    state = JaxTrainState.create(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        tx=jax_schedule.make_optimizer(cfg.train),
        ema_decay=cfg.train.ema_decay)
    grad_fn = jax.jit(jax_trainer.make_grad_fn(
        jax_trainer.make_loss_fn(module, cfg), accum))
    first = None
    for batch in batches:
        grads, new_bs, metrics = grad_fn(state.params, state.batch_stats,
                                         batch, key)
        first = first or (grads, new_bs, metrics)
        state = state.apply_gradients(grads, new_bs)
    ref = {"metrics": {k: float(v) for k, v in first[2].items()},
           "grads": from_jax_variables({"params": _np_tree(first[0])}),
           "batch_stats": from_jax_variables(
               {"batch_stats": _np_tree(first[1])}),
           "params0": from_jax_variables({"params": variables["params"]}),
           "params2": from_jax_variables({"params": _np_tree(state.params)}),
           "ema2": from_jax_variables({"params": _np_tree(
               state.ema_params)})}

    port = SSDModel(cfg.model, dtype=torch.float32)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    optimizer, sched = schedule.make_optimizer(port, cfg.train)
    pstate = TrainState.create(port, optimizer, sched,
                               ema_decay=cfg.train.ema_decay)
    step = make_train_step(port, cfg)
    got = {}
    for i, batch in enumerate(batches):
        pstate, metrics = step(pstate, {k: _t(v) for k, v in batch.items()})
        if i == 0:
            got["metrics"] = {k: v.item() for k, v in metrics.items()}
            got["grads"] = {n: p.grad.clone()
                            for n, p in port.named_parameters()}
            got["batch_stats"] = {
                n: b.clone() for n, b in port.named_buffers()
                if n.endswith(("running_mean", "running_var"))}
            got["fused_blocks"] = sum(
                1 for m in port.modules()
                if isinstance(m, SeparableConvBN) and m.takes_fused_route)
    got["params2"] = dict(port.named_parameters())
    got["ema2"] = pstate.ema_params
    got["step"] = pstate.step
    return cfg, ref, got


def test_ssd_step_loss_and_metrics_match_jax(ssd_steps):
    _, ref, got = ssd_steps
    assert set(got["metrics"]) == set(ref["metrics"]) == {
        "ssd_cls_loss", "ssd_loc_loss", "ssd_num_fg", "total_loss"}
    for k, want in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], want, rtol=STEP_RTOL,
                                   atol=1e-6, err_msg=k)
    assert ref["metrics"]["ssd_num_fg"] > 0


def test_ssd_step_gradients_match_jax(ssd_steps):
    """Every gradient leaf (backbone through BatchNorm's batch statistics,
    extras, fusion, head) within STEP_RTOL of its largest value; training
    takes no fused block."""
    cfg, ref, got = ssd_steps
    _assert_leaves_close(got["grads"], ref["grads"], "gradient")
    assert got["fused_blocks"] == 0


def test_ssd_step_batch_stats_match_jax(ssd_steps):
    _, ref, got = ssd_steps
    _assert_leaves_close(got["batch_stats"], ref["batch_stats"],
                         "batch stat")


def _ulps(leaves, n):
    """``ulp_of`` leaves for ``_assert_leaves_close``: n fp32 ulps of each
    leaf's largest value (the spacing of 2^k x is 2^k times x's)."""
    return {name: float(n) * v for name, v in leaves.items()}


def test_ssd_step_parameter_updates_match_jax(ssd_steps):
    """The parameters' move over two steps (momentum SGD in warmup, decay
    on kernels), plus one fp32 ulp of the parameter for each step's
    rounding of ``p + u``."""
    _, ref, got = ssd_steps
    move = lambda p: {n: p[n] - ref["params0"][n] for n in ref["params0"]}
    _assert_leaves_close(move(got["params2"]), move(ref["params2"]),
                         "update", ulp_of=_ulps(ref["params2"], 2))
    assert got["step"] == 2


def test_ssd_step_ema_shadow_matches_jax(ssd_steps):
    """The shadow's move over two steps at decay 0.99 within STEP_RTOL of
    its largest value plus four fp32 ulps of the shadow: each step rounds
    d * e, (1 - d) * p and their sum, in either order or fused."""
    _, ref, got = ssd_steps
    move = lambda e: {n: e[n] - ref["params0"][n] for n in ref["params0"]}
    _assert_leaves_close(move(got["ema2"]), move(ref["ema2"]), "shadow",
                         ulp_of=_ulps(ref["ema2"], 4))
    assert set(got["ema2"]) == set(ref["params0"])
