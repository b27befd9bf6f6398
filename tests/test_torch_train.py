"""The port's training step against the JAX package, on the CPU in fp32.

Each piece gets the same numpy-seeded inputs on both sides; where the JAX
package draws random numbers (RPN sampling), the test reproduces its
``jax.random`` splits and hands the draws to the port's apply half. The
tolerances are stated per test: fp32 on both sides, sums taken in other
orders.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from test_psroi import random_rois  # noqa: E402
from test_torch_psroi import EDGE_ROIS  # noqa: E402
from test_train import get_batch, small_lighthead_cfg  # noqa: E402
from x_detector_tpu.models import lighthead as L  # noqa: E402
from x_detector_tpu.ops import matching as jax_matching  # noqa: E402
from x_detector_tpu.ops.pallas import psroi_align_kernel as K  # noqa: E402
from x_detector_tpu.train import losses as jax_losses  # noqa: E402
from x_detector_tpu.train import schedule as jax_schedule  # noqa: E402
from x_detector_tpu.train import trainer as jax_trainer  # noqa: E402
from x_detector_tpu_torch.models.layers import BatchNorm2D  # noqa: E402
from x_detector_tpu_torch.models.lighthead import LightHeadRCNN  # noqa: E402
from x_detector_tpu_torch.ops import matching  # noqa: E402
from x_detector_tpu_torch.ops import psroi_align as P  # noqa: E402
from x_detector_tpu_torch.train import losses  # noqa: E402
from x_detector_tpu_torch.train import schedule  # noqa: E402
from x_detector_tpu_torch.train.train_state import TrainState  # noqa: E402
from x_detector_tpu_torch.train.trainer import (  # noqa: E402
    create_model_and_state, make_train_step)
from x_detector_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

# Whole-step tolerance: each gradient leaf, BN statistic and parameter
# update within 1e-3 of the leaf's largest value (fp32 through ~30 layers
# on both sides, convolutions summed in other orders).
STEP_RTOL = 1e-3


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run pallas_call in interpreter mode (no TPU here)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# B1's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid,c,h,w", [(7, 10, 9, 11), (3, 4, 10, 12)])
def test_psroi_backward_matches_jax_bwd(rng, interpret_mode, grid, c, h, w):
    """The port's plain backward and the forward operator's registered
    backward on the CPU against ``jax.grad`` of ``psroi_align_pallas`` (its ``_bwd``), with
    edge and zero-area rois: the same fp32 products summed in another
    order, held to 1e-5."""
    feats = rng.normal(0, 1, (2, h, w, grid * grid * c)).astype(np.float32)
    rois = np.stack([np.concatenate([EDGE_ROIS, random_rois(rng, 34)])
                     for _ in range(2)])
    g = rng.normal(0, 1, (2, 40, grid, grid, c)).astype(np.float32)
    ref = np.asarray(jax.grad(lambda f: jnp.sum(K.batched_psroi_align_pallas(
        f, jnp.asarray(rois), grid=grid) * g))(jnp.asarray(feats)))

    plain = P.psroi_align_backward_reference(_t(g), _t(rois), h, w,
                                             torch.float32, grid)
    np.testing.assert_allclose(plain.numpy(), ref, atol=1e-5, rtol=1e-5)

    f = _t(feats).requires_grad_()
    P.batched_psroi_align(f, _t(rois), grid).backward(_t(g))
    np.testing.assert_allclose(f.grad.numpy(), ref, atol=1e-5, rtol=1e-5)
    assert P.psroi_align_backward.launches == 0      # CPU: no kernel


def test_psroi_backward_bf16_features_get_a_bf16_gradient(rng):
    """bf16 features: the gradient is the fp32 gradient rounded once."""
    feats = torch.from_numpy(rng.normal(0, 1, (1, 6, 7, 98)).astype(
        np.float32)).bfloat16().requires_grad_()
    rois = _t(np.concatenate([EDGE_ROIS, random_rois(rng, 10)]))[None]
    g = _t(rng.normal(0, 1, (1, 16, 7, 7, 2)).astype(np.float32))
    P.batched_psroi_align(feats, rois, 7).backward(g)
    want = P.psroi_align_backward_reference(g, rois, 6, 7, torch.float32, 7)
    assert feats.grad.dtype == torch.bfloat16
    torch.testing.assert_close(feats.grad, want.bfloat16(), atol=0, rtol=0)


@pytest.mark.parametrize("dilation", [1, 2])
def test_separable_block_trains_like_jax(rng, dilation):
    """A fused separable block in training mode (the unfused convs and
    BatchNorm over the batch's statistics, as JAX's ``train=True`` runs
    them) with the residual epilogue: output, new running stats and the
    gradients of the input and every parameter within 1e-5 of scale."""
    from x_detector_tpu.models import layers as jax_layers
    from x_detector_tpu_torch.models.layers import SeparableConvBN
    x = rng.normal(0, 1, (2, 9, 9, 8)).astype(np.float32)
    res = rng.normal(0, 1, (2, 9, 9, 12)).astype(np.float32)
    w = rng.normal(0, 1, (2, 9, 9, 12)).astype(np.float32)
    jmod = jax_layers.SeparableConvBN(12, dilation=(dilation, dilation),
                                      relu=False, fused=True,
                                      dtype=jnp.float32)
    variables = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(0.0, 0.2, v.shape).astype(
            np.float32), jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))

    def loss(params, xx):
        y, new = jmod.apply({"params": params,
                             "batch_stats": variables["batch_stats"]}, xx,
                            train=True, residual=jnp.asarray(res),
                            mutable=["batch_stats"])
        return (y * w).sum(), (y, new)

    (_, (y_ref, new_ref)), (g_params, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))
    mod = SeparableConvBN(8, 12, dilation=(dilation, dilation), relu=False,
                          fused=True, dtype=torch.float32)
    mod.load_state_dict(from_jax_variables(variables))
    assert mod.training
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_()
    y = mod(xt, residual=_t(res).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    (y * _t(w)).sum().backward()
    close = lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=1e-5 * max(1.0, np.abs(b).max()))
    close(y.detach().numpy(), np.asarray(y_ref))
    close(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g_x))
    want = from_jax_variables({"params": jax.tree_util.tree_map(
        np.asarray, g_params), "batch_stats": jax.tree_util.tree_map(
        np.asarray, new_ref["batch_stats"])})
    for name, t in {**dict(mod.named_parameters()),
                    **dict(mod.named_buffers())}.items():
        got = t.grad if isinstance(t, torch.nn.Parameter) else t
        close(got.detach().numpy(), want[name].numpy())


# ---------------------------------------------------------------------------
# Matching, RPN sampling, losses
# ---------------------------------------------------------------------------

def _gt(rng, batch, g, n_valid):
    """Padded gt: random boxes, the last rows zero and masked."""
    boxes = np.zeros((batch, g, 4), np.float32)
    mask = np.zeros((batch, g), bool)
    for b, n in enumerate(n_valid):
        boxes[b, :n] = random_rois(rng, n)
        mask[b, :n] = True
    labels = np.where(mask, rng.integers(1, 21, (batch, g)), 0).astype(
        np.int32)
    return boxes, labels, mask


def test_match_anchors_matches_jax(rng):
    """Exact masks, indices and labels (ties included: the anchors repeat
    rows, and an image without valid gt); targets within 1e-6."""
    anchors = random_rois(rng, 300)
    anchors[150:] = anchors[:150]                  # duplicated rows: ties
    gtb, gtl, gtm = _gt(rng, 3, 8, [5, 1, 0])
    got = matching.match_anchors(_t(anchors), _t(gtb), _t(gtl), _t(gtm),
                                 0.5, 0.3, force_match=True)
    for b in range(3):
        ref = jax_matching.match_anchors(
            jnp.asarray(anchors), jnp.asarray(gtb[b]), jnp.asarray(gtl[b]),
            jnp.asarray(gtm[b]), 0.5, 0.3, force_match=True)
        for name in ("matched_gt", "fg_mask", "bg_mask", "labels"):
            np.testing.assert_array_equal(
                getattr(got, name)[b].numpy(), np.asarray(getattr(ref, name)),
                err_msg=name)
        for name in ("matched_iou", "reg_targets"):
            np.testing.assert_allclose(
                getattr(got, name)[b].numpy(), np.asarray(getattr(ref, name)),
                atol=1e-6, rtol=1e-6, err_msg=name)
    assert got.fg_mask[0].any() and not got.fg_mask[2].any()


def test_match_proposals_matches_jax(rng):
    props = random_rois(rng, 64)
    pmask = rng.random(64) < 0.8
    props[~pmask] = 0.0
    gtb, gtl, gtm = _gt(rng, 2, 6, [4, 0])
    got = matching.match_proposals(
        _t(props)[None].expand(2, -1, -1), _t(pmask)[None].expand(2, -1),
        _t(gtb), _t(gtl), _t(gtm), 0.5, 0.5, 0.1)
    for b in range(2):
        ref = jax_matching.match_proposals(
            jnp.asarray(props), jnp.asarray(pmask), jnp.asarray(gtb[b]),
            jnp.asarray(gtl[b]), jnp.asarray(gtm[b]), 0.5, 0.5, 0.1)
        for name in ("fg_mask", "bg_mask", "labels"):
            np.testing.assert_array_equal(
                getattr(got, name)[b].numpy(), np.asarray(getattr(ref, name)),
                err_msg=name)
        np.testing.assert_allclose(got.reg_targets[b].numpy(),
                                   np.asarray(ref.reg_targets), atol=1e-6)


def jax_rpn_priorities(keys, num_anchors):
    """JAX's RPN draws, by the splits of ``losses.sample_rpn_minibatch``:
    one key per image, split into (kf, kb), each drawing [A] uniforms."""
    fg, bg = [], []
    for key in keys:
        kf, kb = jax.random.split(key)
        fg.append(np.asarray(jax.random.uniform(kf, (num_anchors,))))
        bg.append(np.asarray(jax.random.uniform(kb, (num_anchors,))))
    return losses.RPNPriorities(_t(np.stack(fg)), _t(np.stack(bg)))


@pytest.mark.parametrize("batch_size,fg_fraction", [(256, 0.5), (16, 0.5),
                                                    (8, 0.25)])
def test_rpn_sampling_and_loss_match_jax(rng, batch_size, fg_fraction):
    """Given JAX's own draws: the same minibatch, exactly (few and many
    positives, and more negatives than slots), and the same losses within
    1e-6."""
    a = 2000
    fg = rng.random((3, a)) < np.array([[0.002], [0.05], [0.0]])
    bg = ~fg & (rng.random((3, a)) < 0.7)
    cls = rng.normal(0, 1, (3, a, 2)).astype(np.float32)
    loc = rng.normal(0, 1, (3, a, 4)).astype(np.float32)
    tgt = np.where(fg[..., None], rng.normal(0, 1, (3, a, 4)), 0.0).astype(
        np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    pri = jax_rpn_priorities(keys, a)
    weights = losses.sample_rpn_minibatch(pri, _t(fg), _t(bg), batch_size,
                                          fg_fraction)
    total, metrics = losses.rpn_loss(pri, _t(cls), _t(loc), _t(fg), _t(bg),
                                     _t(tgt), batch_size, fg_fraction)
    for b in range(3):
        ref_w = jax_losses.sample_rpn_minibatch(
            keys[b], jnp.asarray(fg[b]), jnp.asarray(bg[b]), batch_size,
            fg_fraction)
        np.testing.assert_array_equal(weights[b].numpy(), np.asarray(ref_w))
        ref_total, ref_m = jax_losses.rpn_loss(
            keys[b], jnp.asarray(cls[b]), jnp.asarray(loc[b]),
            jnp.asarray(fg[b]), jnp.asarray(bg[b]), jnp.asarray(tgt[b]),
            batch_size, fg_fraction)
        np.testing.assert_allclose(total[b].item(), float(ref_total),
                                   rtol=1e-6)
        for k, v in ref_m.items():
            np.testing.assert_allclose(metrics[k][b].item(), float(v),
                                       rtol=1e-6, err_msg=k)
    assert weights.sum(dim=-1).tolist() == [float(batch_size)] * 3


@pytest.mark.parametrize("per_class", [False, True])
def test_roi_loss_ohem_matches_jax(rng, per_class):
    """The OHEM keep mask exactly (JAX's stable rank, with tied losses) and
    the losses within 1e-6."""
    r, c = 48, 5
    cls = rng.normal(0, 1, (2, r, c)).astype(np.float32)
    cls[:, 20:30] = cls[:, 10:20]                       # tied per-roi losses
    box = rng.normal(0, 1, (2, r, c, 4) if per_class else (2, r, 4)
                     ).astype(np.float32)
    labels = rng.integers(0, c, (2, r)).astype(np.int32)
    labels[:, 20:30] = labels[:, 10:20]
    fg = labels > 0
    fg[:, 10:30] = False
    tgt = np.where(fg[..., None], rng.normal(0, 1, (2, r, 4)), 0.0).astype(
        np.float32)
    valid = rng.random((2, r)) < 0.8
    valid[:, 10:30] = True
    total, metrics, keep = losses.roi_loss_ohem(
        _t(cls), _t(box), _t(labels), _t(tgt), _t(fg), _t(valid), ohem_topk=16)
    for b in range(2):
        ref_total, ref_m = jax_losses.roi_loss_ohem(
            jnp.asarray(cls[b]), jnp.asarray(box[b]), jnp.asarray(labels[b]),
            jnp.asarray(tgt[b]), jnp.asarray(fg[b]), jnp.asarray(valid[b]),
            ohem_topk=16)
        np.testing.assert_array_equal(
            keep[b].numpy(), np.asarray(_jax_ohem_keep(
                cls[b], box[b], labels[b], tgt[b], fg[b], valid[b], 16)))
        np.testing.assert_allclose(total[b].item(), float(ref_total),
                                   rtol=1e-6)
        for k, v in ref_m.items():
            np.testing.assert_allclose(metrics[k][b].item(), float(v),
                                       rtol=1e-6, err_msg=k)
    assert keep.sum(dim=-1).tolist() == [16, 16]


def _jax_ohem_keep(cls, box, labels, tgt, fg, valid, k):
    """The keep mask of JAX's ``roi_loss_ohem`` from its own pieces."""
    per_roi = jax_losses.softmax_ce(jnp.asarray(cls), jnp.asarray(labels))
    box = jnp.asarray(box)
    if box.ndim == 3:
        onehot = labels[:, None] == np.arange(box.shape[1])
        box = jnp.where(onehot[..., None], box, 0.0).sum(axis=1)
    loc = jax_losses.smooth_l1(box, jnp.asarray(tgt))
    per_roi = per_roi + jnp.where(fg, loc, 0.0)
    rank = jax_losses._rank_of(jnp.where(valid, per_roi, -jnp.inf))
    return valid & (rank < min(k, per_roi.shape[0]))


def test_rank_of_is_stable_like_jnp_argsort(rng):
    v = rng.integers(0, 4, (3, 50)).astype(np.float32)
    v[0, 5] = -np.inf
    got = losses._rank_of(_t(v))
    for b in range(3):
        np.testing.assert_array_equal(
            got[b].numpy(), np.asarray(jax_losses._rank_of(jnp.asarray(v[b]))))


# ---------------------------------------------------------------------------
# Schedule and optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup", [0, 5, 500])
def test_schedule_matches_optax_at_the_boundaries(warmup):
    base, bounds, decays = 2e-3, (800, 1000), (1.0, 0.1, 0.01)
    ref = jax_schedule.piecewise_with_warmup(base, bounds, decays, warmup)
    got = schedule.piecewise_with_warmup(base, bounds, decays, warmup)
    steps = {0, 1, warmup - 1, warmup, warmup + 1, 799, 800, 801, 999, 1000,
             1001, 5000}
    for step in sorted(s for s in steps if s >= 0):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6,
                                   err_msg=f"step {step}")


def test_schedule_rejects_what_the_jax_package_rejects():
    with pytest.raises(ValueError):
        schedule.piecewise_with_warmup(1.0, (10,), (1.0,), 0)
    with pytest.raises(ValueError):
        schedule.piecewise_with_warmup(1.0, (10,), (1.0, 0.1), 10)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(2, 3, 3)
        self.bn = BatchNorm2D(3)
        self.fc = torch.nn.Linear(3, 4)


def test_optimizer_steps_match_optax(rng):
    """Two SGD-momentum steps with weight decay on kernels only (conv and
    dense weights; not the biases, not BatchNorm's scale, which torch also
    names ``weight``), across a warmup, against optax: within 1e-6."""
    from x_detector_tpu.config import TrainConfig
    cfg = TrainConfig(learning_rate=0.1, weight_decay=0.05, warmup_steps=1,
                      lr_boundaries=(3,), lr_decays=(1.0, 0.1))
    model = _Tiny()
    names = {"conv.weight": ("conv", "kernel"), "conv.bias": ("conv", "bias"),
             "bn.weight": ("bn", "scale"), "bn.bias": ("bn", "bias"),
             "fc.weight": ("fc", "kernel"), "fc.bias": ("fc", "bias")}
    params = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(_t(rng.normal(0, 1, p.shape).astype(np.float32)))
            mod, leaf = names[name]
            params.setdefault(mod, {})[leaf] = jnp.asarray(p.numpy())
    kernels, _ = schedule.decay_groups(model)
    assert {id(p) for p in kernels} == {id(model.conv.weight),
                                        id(model.fc.weight)}
    optimizer, sched = schedule.make_optimizer(model, cfg)
    state = TrainState.create(model, optimizer, sched)
    tx = jax_schedule.make_optimizer(cfg)
    opt_state = tx.init(params)
    for _ in range(2):
        grads = {}
        for name, p in model.named_parameters():
            g = rng.normal(0, 1, p.shape).astype(np.float32)
            p.grad = _t(g)
            mod, leaf = names[name]
            grads.setdefault(mod, {})[leaf] = jnp.asarray(g)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        state.apply_gradients()
        for name, p in model.named_parameters():
            mod, leaf = names[name]
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[mod][leaf]),
                                       atol=1e-6, rtol=1e-6, err_msg=name)
    assert state.step == 2


def test_ema_shadow_follows_the_parameters():
    model = _Tiny()
    optimizer, sched = schedule.make_optimizer(
        model, dataclasses.replace(small_lighthead_cfg().train,
                                   learning_rate=0.5))
    state = TrainState.create(model, optimizer, sched, ema_decay=0.75)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    state.apply_gradients()
    for n, p in model.named_parameters():
        torch.testing.assert_close(state.ema_params[n],
                                   0.75 * before[n] + 0.25 * p.detach())
    assert TrainState.create(model, optimizer, sched).ema_params is None


# ---------------------------------------------------------------------------
# The whole step
# ---------------------------------------------------------------------------

def _step_cfg(accum):
    cfg = small_lighthead_cfg()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, weight_decay=1e-2, grad_accum_steps=accum))


def _jax_step_priorities(rng_key, batch, accum, num_anchors):
    """JAX's RPN draws for one step: per microbatch ``fold_in(rng, i)``
    (only when accumulating), then one key per image."""
    if accum <= 1:
        return jax_rpn_priorities(jax.random.split(rng_key, batch),
                                  num_anchors)
    parts = [jax_rpn_priorities(jax.random.split(
        jax.random.fold_in(rng_key, i), batch // accum), num_anchors)
        for i in range(accum)]
    return losses.RPNPriorities(*(torch.cat(p) for p in zip(*parts)))


@pytest.fixture(scope="module", params=[1, 2], ids=["accum1", "accum2"])
def whole_step(request):
    """One train step of the tiny Light-Head on both sides from the same
    JAX-initialised weights, batch and RPN draws. The JAX model pools with
    ``batched_psroi_align_pallas`` (interpret mode), so its gradient is
    ``_bwd`` itself."""
    accum = request.param
    cfg = _step_cfg(accum)
    model, state = jax_trainer.create_model_and_state(
        cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    batch = get_batch(cfg)
    key = jax.random.PRNGKey(11)
    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call",
               functools.partial(pl.pallas_call, interpret=True))
    mp.setattr(L, "batched_psroi_align", K.batched_psroi_align_pallas)
    try:
        loss_fn = jax_trainer.make_loss_fn(model, cfg)
        grads, new_bs, metrics = jax.jit(jax_trainer.make_grad_fn(
            loss_fn, accum))(state.params, state.batch_stats, batch, key)
        new_state = state.apply_gradients(grads, new_bs)
        out = None
        if accum == 1:
            out, _ = jax.jit(lambda v, x: model.apply(
                v, x, train=True, mutable=["batch_stats"]))(
                {"params": state.params, "batch_stats": state.batch_stats},
                batch["image"])
    finally:
        mp.undo()
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    ref = {"grads": from_jax_variables({"params": np_tree(grads)}),
           "batch_stats": from_jax_variables(
               {"batch_stats": np_tree(new_bs)}),
           "params0": from_jax_variables({"params": np_tree(state.params)}),
           "params1": from_jax_variables(
               {"params": np_tree(new_state.params)}),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "outputs": None if out is None else np_tree(out)}

    port = LightHeadRCNN(cfg.model, dtype=torch.float32)
    port.load_state_dict(from_jax_variables(np_tree(
        {"params": state.params, "batch_stats": state.batch_stats})))
    optimizer, sched = schedule.make_optimizer(port, cfg.train)
    pstate = TrainState.create(port, optimizer, sched)
    tbatch = {k: _t(v) for k, v in batch.items()}
    pri = _jax_step_priorities(key, cfg.train.batch_size, accum,
                               port.anchors.shape[0])
    aux = None
    if accum == 1:     # the step's own forward, for its proposals and OHEM
        from x_detector_tpu_torch.train.trainer import make_lighthead_loss_fn
        bn = [(m, m.running_mean.clone(), m.running_var.clone())
              for m in port.modules() if isinstance(m, BatchNorm2D)]
        _, _, aux = make_lighthead_loss_fn(port, cfg)(tbatch, pri)
        with torch.no_grad():
            for m, mean, var in bn:
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)
    _, got_metrics = make_train_step(port, cfg)(pstate, tbatch,
                                                priorities=pri)
    got = {"grads": {n: p.grad for n, p in port.named_parameters()},
           "params1": dict(port.named_parameters()),
           "batch_stats": {n: b for n, b in port.named_buffers()
                           if n.endswith(("running_mean", "running_var"))},
           "metrics": {k: v.item() for k, v in got_metrics.items()},
           "aux": aux, "step": pstate.step}
    return cfg, batch, ref, got


def _assert_leaves_close(got, ref, what, ulp_of=None):
    """Each leaf within STEP_RTOL of its largest value, plus one fp32 ulp
    of ``ulp_of``'s leaf where given."""
    assert set(got) == set(ref), what
    for name, want in ref.items():
        want = want.numpy()
        err = np.abs(got[name].detach().numpy() - want).max()
        ulp = 0.0 if ulp_of is None else float(
            np.spacing(np.abs(ulp_of[name].numpy()).max()))
        assert err <= STEP_RTOL * max(np.abs(want).max(), 1e-12) + ulp, (
            f"{what} {name}: max abs err {err:.3g} against scale "
            f"{np.abs(want).max():.3g}")


def test_whole_step_loss_and_metrics_match_jax(whole_step):
    _, _, ref, got = whole_step
    assert set(got["metrics"]) == set(ref["metrics"])
    for k, want in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], want, rtol=STEP_RTOL,
                                   atol=1e-6, err_msg=k)
    assert ref["metrics"]["roi_num_fg"] > 0 and ref["metrics"][
        "rpn_num_fg"] > 0


def test_whole_step_gradients_match_jax(whole_step):
    """Every gradient leaf, including the thin map's (through B1's
    backward) and the backbone's (through BatchNorm's batch statistics)."""
    _, _, ref, got = whole_step
    _assert_leaves_close(got["grads"], ref["grads"], "gradient")
    assert np.abs(ref["grads"]["thin_map.col_b.weight"].numpy()).max() > 0


def test_whole_step_batch_stats_match_jax(whole_step):
    _, _, ref, got = whole_step
    _assert_leaves_close(got["batch_stats"], ref["batch_stats"],
                         "batch stat")


def test_whole_step_parameter_updates_match_jax(whole_step):
    """The update of every parameter (momentum SGD, decay on kernels),
    plus one fp32 ulp of the parameter: ``p + u`` rounds to the parameter's
    ulp, which for a BatchNorm scale near 1 is 1e-3 of a 1e-4 update."""
    _, _, ref, got = whole_step
    upd_got = {n: got["params1"][n] - ref["params0"][n] for n in ref[
        "params0"]}
    upd_ref = {n: ref["params1"][n] - ref["params0"][n] for n in ref[
        "params0"]}
    _assert_leaves_close(upd_got, upd_ref, "update", ulp_of=ref["params1"])
    assert got["step"] == 1


@pytest.mark.parametrize("whole_step", [1], indirect=True, ids=["accum1"])
def test_whole_step_proposals_and_ohem_masks_match_jax(whole_step):
    """The train-mode forward's proposals (training budgets) and the OHEM
    keep mask of the unsplit batch, exactly; proposal boxes within the
    golden test's 2e-4."""
    cfg, batch, ref, got = whole_step
    out, aux = ref["outputs"], got["aux"]
    np.testing.assert_array_equal(aux["proposal_valid"].numpy(),
                                  out["proposal_valid"])
    assert aux["proposals"].shape[1] == cfg.model.proposals.post_nms_topk
    np.testing.assert_allclose(aux["proposals"].detach().numpy(),
                               out["proposals"], atol=2e-4, rtol=0)
    tcfg = cfg.train
    gt_mask = np.asarray(jax_trainer._train_gt_mask(batch, cfg))
    for b in range(cfg.train.batch_size):
        m = jax_matching.match_proposals(
            out["proposals"][b], out["proposal_valid"][b],
            batch["gt_boxes"][b], batch["gt_labels"][b], gt_mask[b],
            tcfg.roi_fg_iou, tcfg.roi_bg_iou_hi, tcfg.roi_bg_iou_lo)
        want = _jax_ohem_keep(out["roi_cls"][b], out["roi_box"][b],
                              np.asarray(m.labels), np.asarray(m.reg_targets),
                              np.asarray(m.fg_mask),
                              np.asarray(m.fg_mask | m.bg_mask),
                              tcfg.ohem_topk)
        np.testing.assert_array_equal(aux["ohem_keep"][b].numpy(),
                                      np.asarray(want))


def test_difficult_objects_make_no_targets():
    cfg = small_lighthead_cfg()
    batch = {"gt_mask": torch.tensor([[True, True, False]]),
             "difficult": torch.tensor([[False, True, False]])}
    from x_detector_tpu_torch.train.trainer import _train_gt_mask
    assert _train_gt_mask(batch, cfg).tolist() == [[True, False, False]]
    keep = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, include_difficult=True))
    assert _train_gt_mask(batch, keep).tolist() == [[True, True, False]]


def test_create_model_and_state_trains_and_refuses_ssd():
    """Both families build a state in training mode; config 2's SSD state
    carries its EMA shadow (``ema_decay=0.99``), a copy of every parameter
    by name, and the Light-Head preset none. (The SSD family was refused
    until its step was ported; the name stays.)"""
    cfg = small_lighthead_cfg()
    state = create_model_and_state(cfg, "cpu", seed=0, dtype=torch.float32)
    assert state.model.training and state.step == 0
    assert state.ema_params is None
    from x_detector_tpu_torch.config import ssd_resnet50
    from x_detector_tpu_torch.models.ssd import SSDModel
    ssd = ssd_resnet50(64)
    ssd = dataclasses.replace(ssd, model=dataclasses.replace(
        ssd.model, backbone_stages=(1, 1, 1, 1),
        backbone_widths=(8, 16, 24, 32)))
    state = create_model_and_state(ssd, "cpu", seed=0, dtype=torch.float32)
    assert isinstance(state.model, SSDModel) and state.model.training
    assert state.ema_decay == 0.99 and state.step == 0
    params = dict(state.model.named_parameters())
    assert set(state.ema_params) == set(params)
    for name, p in params.items():
        assert torch.equal(state.ema_params[name], p)
        assert state.ema_params[name].data_ptr() != p.data_ptr()


def test_profile_step_attributes_device_work_to_the_innermost_stage():
    """The step profiler's trace arithmetic on a made-up trace: a parent
    stage's own time leaves out its child's, device work goes to the
    innermost stage by its midpoint, overlapping work counts once, and the
    kernel families come from the kernels' names."""
    from x_detector_tpu_torch.train import profile_step as ps
    rng = lambda name, ts, dur: {"ph": "X", "cat": "user_annotation",
                                 "name": "stage:" + name, "ts": ts,
                                 "dur": dur}
    dev = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name,
                                      "ts": ts, "dur": dur}
    trace = [
        rng("losses", 0.0, 100.0), rng("forward backbone", 10.0, 40.0),
        rng("backward", 200.0, 50.0),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "stage:losses",
         "ts": 0.0, "dur": 100.0},
        dev("kernel", "cudnn_conv_fwd", 12.0, 20.0),           # backbone
        dev("kernel", "vectorized_elementwise_kernel", 25.0, 10.0),
        dev("kernel", "reduce_kernel", 60.0, 10.0),            # losses
        dev("gpu_memcpy", "Memcpy DtoD", 65.0, 10.0),
        dev("kernel", "xdt_psroi_align_bwd_kernel", 210.0, 5.0),
        dev("kernel", "outside", 500.0, 5.0),
    ]
    rows = ps.stage_breakdown(trace)
    assert set(rows) == {"losses", "forward backbone", "backward"}
    assert rows["losses"]["own"] == 60.0
    assert rows["forward backbone"]["own"] == 40.0
    assert rows["forward backbone"]["busy"] == 23.0        # 12..35
    assert rows["forward backbone"]["families"] == {"conv": 20.0,
                                                    "elementwise": 10.0}
    assert rows["losses"]["busy"] == 15.0                  # 60..75
    assert rows["losses"]["families"] == {"reduce": 10.0}
    assert rows["backward"]["families"] == {"psroi": 5.0}
    assert ps.union_length([]) == 0.0
    assert ps.union_length([(5, 6), (0, 2), (1, 3)]) == 4.0
