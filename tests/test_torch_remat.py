"""``backbone_remat_stages`` in the port: the first N backbone stages run
under ``torch.utils.checkpoint`` in a training forward and recompute in the
backward (the JAX package's ``nn.remat``), with BatchNorm's running-stat
update off during the recompute (``models.layers.remat``).

Tolerances: against the port without remat, bitwise on the CPU (the
recompute runs the same ops on the same inputs); against the JAX package's
``remat_stages=4``, its own tolerance (rtol 1e-3, atol 1e-4,
``tests/test_models.py``), rtol taken of each leaf's largest value: the two
frameworks' convolutions sum fp32 in other orders, and a gradient element
that cancels to near zero keeps the absolute error of its large partial
sums (a few elements of a thousand sit 1-2% off elementwise). Inference
ignores the field, as the JAX package's does.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_train import get_batch, small_lighthead_cfg, small_ssd_cfg  # noqa
from x_detector_tpu.models import resnet as jax_resnet  # noqa: E402
from x_detector_tpu.models import xception as jax_xception  # noqa: E402
from x_detector_tpu_torch.inference import build_eval_fn, build_model  # noqa
from x_detector_tpu_torch.models import layers  # noqa: E402
from x_detector_tpu_torch.models.resnet import ResNetV1  # noqa: E402
from x_detector_tpu_torch.models.xception import XceptionLite  # noqa: E402
from x_detector_tpu_torch.train.trainer import (  # noqa: E402
    create_model_and_state, make_train_step)
from x_detector_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

RTOL, ATOL = 1e-3, 1e-4

BACKBONES = {
    "xception": (lambda r: XceptionLite(widths=(8, 8, 16, 16),
                                        units_per_stage=(1, 1, 1, 1),
                                        remat_stages=r, dtype=torch.float32),
                 lambda r: jax_xception.XceptionLite(
                     widths=(8, 8, 16, 16), units_per_stage=(1, 1, 1, 1),
                     remat_stages=r, dtype=jnp.float32)),
    "resnet": (lambda r: ResNetV1(stage_sizes=(1, 1, 1, 1),
                                  widths=(4, 4, 8, 8), remat_stages=r,
                                  dtype=torch.float32),
               lambda r: jax_resnet.ResNetV1(
                   stage_sizes=(1, 1, 1, 1), widths=(4, 4, 8, 8),
                   remat_stages=r, dtype=jnp.float32)),
}


def _remat(cfg, stages=2):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_remat_stages=stages))


def _x():
    return np.random.default_rng(1).normal(0, 1, (1, 32, 32, 3)).astype(
        np.float32)


def _port_grads(make, stages, variables):
    """Loss sum(feature^2), its gradients and the BatchNorm running stats
    after one training forward, and how many BatchNorm forwards ran."""
    model = make(stages).train()
    model.load_state_dict(from_jax_variables(variables), strict=True)
    calls = []
    for m in model.modules():
        if isinstance(m, layers.BatchNorm2D):
            m.register_forward_hook(lambda *a: calls.append(1))
    feats = model(torch.from_numpy(_x()))
    loss = sum((v.float() ** 2).sum() for v in feats.values())
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers()}
    return loss.detach(), grads, stats, len(calls)


@pytest.fixture(scope="module", params=sorted(BACKBONES))
def backbone_runs(request):
    make, make_jax = BACKBONES[request.param]
    variables = jax.tree_util.tree_map(np.asarray, make_jax(0).init(
        jax.random.PRNGKey(0), jnp.asarray(_x()), train=True))
    return request.param, make, make_jax, variables, {
        r: _port_grads(make, r, variables) for r in (0, 2, 4)}


def test_remat_is_bitwise_the_same_backbone(backbone_runs):
    """Remat of 2 and 4 stages: the loss, every gradient and every running
    stat bitwise those without; the recomputed stages ran their BatchNorms
    twice, and the stats moved once all the same."""
    _, _, _, _, runs = backbone_runs
    loss0, grads0, stats0, calls0 = runs[0]
    for r in (2, 4):
        loss, grads, stats, calls = runs[r]
        assert torch.equal(loss, loss0)
        assert all(torch.equal(grads[n], g) for n, g in grads0.items())
        assert all(torch.equal(stats[n], s) for n, s in stats0.items())
        assert calls > calls0                 # the recompute ran
    assert runs[4][3] > runs[2][3]


def test_recompute_without_the_guard_moves_the_stats_twice(backbone_runs,
                                                           monkeypatch):
    """Mutation check: with the recompute's guard disabled, the running
    stats of a recomputed stage differ, so the bitwise test above sees the
    guard."""
    _, make, _, variables, runs = backbone_runs
    monkeypatch.setattr(layers, "_recomputing",
                        lambda: layers.contextlib.nullcontext())
    _, _, stats, _ = _port_grads(make, 4, variables)
    assert any(not torch.equal(stats[n], s) for n, s in runs[0][2].items())


def test_remat_grads_match_jax_remat(backbone_runs):
    """The port's remat_stages=4 against JAX's remat_stages=4 (its own
    test's loss and tolerance), and JAX's batch stats."""
    _, _, make_jax, variables, runs = backbone_runs
    module = make_jax(4)

    def loss(params):
        out, mut = module.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(_x()), train=True, mutable=["batch_stats"])
        return sum(jnp.sum(v ** 2) for v in out.values()), mut

    (l_ref, mut), g_ref = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    loss_port, grads, stats, _ = runs[4]
    np.testing.assert_allclose(float(loss_port), float(l_ref), rtol=1e-6)
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, {
        "params": g_ref, "batch_stats": mut["batch_stats"]}))
    for name, w in want.items():
        got = (grads[name] if name in grads else stats[name]).numpy()
        err = np.abs(got - w.numpy()).max()
        assert err <= ATOL + RTOL * np.abs(w.numpy()).max(), (name, err)


@pytest.mark.parametrize("make_cfg", [small_lighthead_cfg, small_ssd_cfg],
                         ids=["lighthead", "ssd"])
def test_train_step_with_remat_is_bitwise_without(make_cfg):
    """Each family's step with backbone_remat_stages=2 leaves the same
    parameters, BatchNorm stats, momentum (and EMA shadow) as without."""
    cfg = make_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ema_decay=0.9))
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in get_batch(cfg).items()}
    states = []
    for c in (cfg, _remat(cfg)):
        state = create_model_and_state(c, "cpu", seed=0, dtype=torch.float32)
        step = make_train_step(state.model, c)
        for _ in range(2):
            state, metrics = step(state, batch,
                                  torch.Generator().manual_seed(3))
        assert torch.isfinite(metrics["total_loss"])
        states.append(state)
    a, b = states
    assert a.model.backbone.remat_stages == 0
    assert b.model.backbone.remat_stages == 2
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert all(torch.equal(a.ema_params[k], b.ema_params[k])
               for k in a.ema_params)
    for pa, pb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        assert torch.equal(pa["momentum_buffer"], pb["momentum_buffer"])


@pytest.mark.parametrize("make_cfg", [small_lighthead_cfg, small_ssd_cfg],
                         ids=["lighthead", "ssd"])
def test_train_path_refuses_remat_and_inference_ignores_it(make_cfg):
    """(The train path no longer refuses the field; the name stays.) A
    model of a remat config detects as one without the field: inference
    runs no checkpoint."""
    cfg = make_cfg()
    images = torch.from_numpy(np.array(get_batch(cfg)["image"]))
    want = build_eval_fn(build_model(cfg.model, "cpu", seed=0,
                                     dtype=torch.float32), cfg, "cpu")(images)
    got = build_eval_fn(build_model(_remat(cfg).model, "cpu", seed=0,
                                    dtype=torch.float32), _remat(cfg),
                        "cpu")(images)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
