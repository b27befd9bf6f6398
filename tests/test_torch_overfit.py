"""End-to-end: the port overfits a fixed synthetic set to mAP 1.0.

The port of ``tests/test_integration_overfit.py`` with the JAX test's
recipe and gates (``x_detector_tpu_torch/tools/overfit.py`` holds the
body, which ``chip_smoke.py`` also runs at full width): the thin SSD of
``tests/test_train.small_ssd_cfg`` at batch 8 and learning rate 1e-2, the
8 fixed images of 4 classes at 64 px, 120 steps in fp32, scored with
batch statistics; the last loss must be below 0.2 and the mAP above 0.95.
About 40 s on one thread: not marked slow (the JAX test is, at ~11 min).

At full width config 3's Light-Head diverges at the test's learning rate;
``test_lighthead_at_full_width_diverges_in_both_packages`` (slow) shows
the JAX package does too, from the same weights, batch and draws.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_train import small_ssd_cfg  # noqa: E402
from x_detector_tpu.data.synthetic import (  # noqa: E402
    synthetic_batches as jax_synthetic_batches)
from x_detector_tpu_torch.tools import overfit  # noqa: E402


def test_small_config_is_the_jax_tests_recipe():
    """The port's model and recipe equal ``small_ssd_cfg`` with the JAX
    test's batch of 8 and learning rate 1e-2, field for field; the fixed
    images and gt are the JAX package's draw."""
    cfg = small_ssd_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=8, learning_rate=1e-2))
    assert (dataclasses.asdict(overfit.small_config())
            == dataclasses.asdict(cfg))
    want = next(jax_synthetic_batches(0, 8, 64, cfg.data.max_gt_boxes,
                                      num_classes=4))
    got = overfit.fixed_batch(overfit.small_config(), "cpu")
    np.testing.assert_array_equal(got["image"].numpy(),
                                  (want["image"] - 115.0) / 60.0)
    for key in ("gt_boxes", "gt_labels", "gt_mask"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])


def test_fixed_images_at_full_width_are_the_tests_resized():
    """At another size the same objects: the gt is the 64 px draw's, the
    image its bilinear resize (half-pixel centres, as
    ``F.interpolate(align_corners=False)``; whitening commutes with it),
    within fp32 rounding."""
    small = overfit.fixed_batch(overfit.small_config(), "cpu")
    cfg = dataclasses.replace(overfit.small_config(), model=dataclasses.
                              replace(overfit.small_config().model,
                                      image_size=128))
    big = overfit.fixed_batch(cfg, "cpu")
    assert big["image"].shape == (8, 128, 128, 3)
    for key in ("gt_boxes", "gt_labels", "gt_mask"):
        assert torch.equal(big[key], small[key])
    want = torch.nn.functional.interpolate(
        small["image"].permute(0, 3, 1, 2), size=(128, 128),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    torch.testing.assert_close(big["image"], want, atol=1e-5, rtol=0)


def test_overfit_to_perfect_map():
    res = overfit.overfit(overfit.small_config(), "cpu", overfit.STEPS,
                          torch.float32)
    assert res["total_loss"] < 0.2, "did not overfit"
    assert res["mAP"] > 0.95, f"overfit mAP {res['mAP']}: {res}"
    assert res["passed"]



# Config 3's Light-Head, published widths, on the fixed images cut to 256 px
# (at 128 px the port's loss stayed near 1-5 for 30 steps at lr 1e-2; at
# 256 px it diverges), batch 8, fp32, from the same JAX-initialised
# weights, RPN draws and batch in both packages: at the test's lr 1e-2 until
# both have diverged (at most 60 steps), at the full-width overfit's 2e-3
# for 20 steps.
WITNESS_SIZE, WITNESS_THREADS = 256, 4
WITNESS_STEPS = {1e-2: 60, overfit.FULL_WIDTH_LR["lighthead"]: 20}
# the first step's loss is the whole-step parity's (both sides' fp32 sums
# in other orders); from there the updates amplify every difference
WITNESS_FIRST_RTOL = 1e-4
# a loss past this (or NaN) has left training for good
DIVERGED = 1e4


@pytest.mark.slow  # ~5 min each on 4 threads: full-width steps
@pytest.mark.parametrize("lr", sorted(WITNESS_STEPS, reverse=True))
def test_lighthead_at_full_width_diverges_in_both_packages(lr):
    """Both packages' losses step by step (printed, ``-s``); the first
    step's agree. At lr 1e-2 each package's loss passes DIVERGED or turns
    NaN; at ``overfit.FULL_WIDTH_LR`` every loss of both stays finite and
    each package ends below its first step. The port's full-width overfit
    therefore trains the Light-Head at FULL_WIDTH_LR: the divergence at
    the test's rate is the recipe's, not the port's."""
    import jax
    import jax.numpy as jnp

    from test_torch_train import jax_rpn_priorities
    from x_detector_tpu.config import lighthead_xception
    from x_detector_tpu.train import trainer as jax_trainer
    from x_detector_tpu_torch.models.lighthead import LightHeadRCNN
    from x_detector_tpu_torch.train import schedule
    from x_detector_tpu_torch.train.train_state import TrainState
    from x_detector_tpu_torch.train.trainer import make_train_step
    from x_detector_tpu_torch.utils.convert import from_jax_variables

    full = overfit.full_width_config("lighthead")
    pcfg = dataclasses.replace(
        full, model=dataclasses.replace(full.model, image_size=WITNESS_SIZE),
        data=dataclasses.replace(full.data, image_size=WITNESS_SIZE),
        train=dataclasses.replace(full.train, learning_rate=lr))
    jcfg = lighthead_xception(WITNESS_SIZE)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, batch_size=8, learning_rate=lr, warmup_steps=0,
        weight_decay=0.0))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    tbatch = overfit.fixed_batch(pcfg, "cpu")
    batch = {k: v.numpy() for k, v in tbatch.items()}

    model, jstate = jax_trainer.create_model_and_state(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    port = LightHeadRCNN(pcfg.model, dtype=torch.float32)
    port.load_state_dict(from_jax_variables(np_tree(
        {"params": jstate.params, "batch_stats": jstate.batch_stats})))
    optimizer, sched = schedule.make_optimizer(port, pcfg.train)
    pstate = TrainState.create(port, optimizer, sched)
    pstep = make_train_step(port, pcfg)
    jstep = jax.jit(jax_trainer.make_train_step(model, jcfg))

    def gone(v):
        return not np.isfinite(v) or v > DIVERGED

    losses = {"jax": [], "port": []}
    threads = torch.get_num_threads()
    torch.set_num_threads(WITNESS_THREADS)
    try:
        for i in range(WITNESS_STEPS[lr]):
            key = jax.random.fold_in(jax.random.PRNGKey(11), i)
            if not (losses["jax"] and gone(losses["jax"][-1])):
                jstate, jm = jstep(jstate, batch, key)
                losses["jax"].append(float(jm["total_loss"]))
            if not (losses["port"] and gone(losses["port"][-1])):
                pri = jax_rpn_priorities(jax.random.split(key, 8),
                                         port.anchors.shape[0])
                pstate, pm = pstep(pstate, tbatch, priorities=pri)
                losses["port"].append(float(pm["total_loss"]))
            print(f"lr {lr:g} step {i + 1}: " + ", ".join(
                f"{side} {v[-1]:.6g}" for side, v in losses.items()),
                flush=True)
            if all(gone(v[-1]) for v in losses.values()):
                break
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_allclose(losses["port"][0], losses["jax"][0],
                               rtol=WITNESS_FIRST_RTOL)
    for side, v in losses.items():
        if lr == 1e-2:
            assert gone(v[-1]), (f"{side} did not diverge in "
                                 f"{WITNESS_STEPS[lr]} steps: {v}")
        else:
            assert not any(map(gone, v)) and v[-1] < v[0], (
                f"{side} did not train at lr {lr:g}: {v}")
