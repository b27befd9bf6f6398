"""The port's data parallelism (``x_detector_tpu_torch/parallel/``) on the
CPU: two gloo ranks in real processes (``mesh.run_ranks``), each joined
within JOIN_TIMEOUT_S so that a hang fails the test.

- The tiny Light-Head's DP step against JAX's ``make_dp_train_step`` on a
  2-device CPU mesh, from the same weights and batch, with JAX's per-device
  RPN draws rebuilt with ``fold_in(key, device)``: the whole-step test's
  tolerance (``STEP_RTOL`` of each leaf's largest value).
- The same DP step against the port's own ``grad_accum_steps = 2`` step on
  the whole batch with the same draws: bitwise (fp32, one thread a rank:
  each rank's shard is one microbatch of the accumulation, the two-rank sum
  commutes exactly and the halving is exact).
- The SSD family with its EMA shadow for 3 steps: every rank's parameters,
  BatchNorm stats, momentum and shadow bitwise equal across ranks and to
  the accumulation; the ranks start from other weights, which
  ``replicate_state`` replaces by rank 0's.
- DP evaluation's sharding, padding and gather against one process.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from test_torch_checkpoint import assert_bitwise, snapshot  # noqa: E402
from test_torch_train import (STEP_RTOL, _assert_leaves_close,  # noqa: E402
                              _jax_step_priorities)
from test_train import get_batch, small_lighthead_cfg, small_ssd_cfg  # noqa
from x_detector_tpu.models import lighthead as L  # noqa: E402
from x_detector_tpu.ops.pallas import psroi_align_kernel as K  # noqa: E402
from x_detector_tpu.parallel import mesh as jax_mesh  # noqa: E402
from x_detector_tpu.parallel import data_parallel as jax_dp  # noqa: E402
from x_detector_tpu.train import trainer as jax_trainer  # noqa: E402
from x_detector_tpu_torch.cli.evaluate import run_eval  # noqa: E402
from x_detector_tpu_torch.inference import build_model  # noqa: E402
from x_detector_tpu_torch.parallel import mesh  # noqa: E402
from x_detector_tpu_torch.parallel.data_parallel import (  # noqa: E402
    make_dp_train_step)
from x_detector_tpu_torch.train import losses  # noqa: E402
from x_detector_tpu_torch.train.schedule import make_optimizer  # noqa: E402
from x_detector_tpu_torch.train.train_state import TrainState  # noqa: E402
from x_detector_tpu_torch.train.trainer import make_train_step  # noqa: E402
from x_detector_tpu_torch.utils.convert import (  # noqa: E402
    from_jax_variables)

WORLD = 2
JOIN_TIMEOUT_S = 120


def _state(cfg, weights):
    """A CPU fp32 TrainState of ``cfg`` holding ``weights`` (its shadow, if
    the config keeps one, a copy of them)."""
    model = build_model(cfg.model, "cpu", seed=None,
                        dtype=torch.float32).train()
    model.load_state_dict(weights)
    optimizer, schedule = make_optimizer(model, cfg.train)
    return TrainState.create(model, optimizer, schedule,
                             ema_decay=cfg.train.ema_decay)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _priorities(draws, step, rows=slice(None)):
    return None if draws is None else losses.RPNPriorities(
        *(d[rows] for d in draws[step]))


def _dp_rank(rank, world, cfg, weights, batches, draws, out_dir):
    """One rank: its own starting weights (``weights[rank]``), then
    ``replicate_state``, then a DP step a batch on its rows, with its rows
    of each step's draws; saves its snapshot and metrics."""
    torch.set_num_threads(1)
    state = mesh.replicate_state(_state(cfg, weights[rank]))
    step = make_dp_train_step(state.model, cfg)
    metrics = []
    for i, batch in enumerate(batches):
        rows = mesh.shard_rows(cfg.train.batch_size, rank, world)
        state, m = step(state, mesh.shard_batch(batch, rank, world),
                        priorities=_priorities(draws, i, rows))
        metrics.append({k: v.item() for k, v in m.items()})
    torch.save({"snapshot": snapshot(state), "metrics": metrics,
                "params": {n: p.detach().clone()
                           for n, p in state.model.named_parameters()},
                "stats": {n: b.clone() for n, b in state.model.named_buffers()
                          if n.endswith(("running_mean", "running_var"))}},
               os.path.join(out_dir, f"rank{rank}.pt"))
    return rank


def _run_dp(tmp_path, cfg, weights, batches, draws):
    assert mesh.run_ranks(_dp_rank, WORLD, "gloo", (
        cfg, weights, batches, draws, str(tmp_path)),
        timeout_s=JOIN_TIMEOUT_S) == 0
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _accumulated(cfg, weights, batches, draws):
    """The single-process step with ``grad_accum_steps = WORLD`` over the
    same batches and draws: snapshot and metrics."""
    acc = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, grad_accum_steps=WORLD))
    state = _state(acc, weights)
    step = make_train_step(state.model, acc)
    metrics = []
    for i, batch in enumerate(batches):
        state, m = step(state, batch, priorities=_priorities(draws, i))
        metrics.append({k: v.item() for k, v in m.items()})
    return snapshot(state), metrics


# ---------------------------------------------------------------------------
# The Light-Head: against JAX and against the accumulation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lighthead_dp(tmp_path_factory):
    """One DP step of the tiny Light-Head (global batch 4, 2 images a rank)
    on both sides from JAX's initial weights; JAX's model pools with
    ``batched_psroi_align_pallas`` (interpret mode), as the whole-step
    test's does."""
    cfg = small_lighthead_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=4, weight_decay=1e-2))
    model, state = jax_trainer.create_model_and_state(
        cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    batch = get_batch(cfg)
    key = jax.random.PRNGKey(11)
    jmesh = jax_mesh.make_mesh(WORLD)
    # numpy copies first: the step donates the state it is given
    params0 = from_jax_variables({"params": _np_tree(state.params)})
    weights = from_jax_variables(_np_tree(
        {"params": state.params, "batch_stats": state.batch_stats}))
    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call",
               functools.partial(pl.pallas_call, interpret=True))
    mp.setattr(L, "batched_psroi_align", K.batched_psroi_align_pallas)
    try:
        step = jax_dp.make_dp_train_step(model, cfg, jmesh)
        new_state, metrics = step(jax_mesh.replicate_state(jmesh, state),
                                  jax_mesh.shard_batch(jmesh, batch), key)
        new_state = _np_tree(new_state)
    finally:
        mp.undo()
    ref = {"params0": params0,
           "params1": from_jax_variables({"params": new_state.params}),
           "batch_stats": from_jax_variables(
               {"batch_stats": new_state.batch_stats}),
           "metrics": {k: float(v) for k, v in metrics.items()}}

    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    num_anchors = _state(cfg, weights).model.anchors.shape[0]
    b = cfg.train.batch_size // WORLD
    # JAX's per-device draws: fold_in(key, device), one split a image
    parts = [_jax_step_priorities(jax.random.fold_in(key, r), b, 1,
                                  num_anchors) for r in range(WORLD)]
    draws = [losses.RPNPriorities(*(torch.cat(p) for p in zip(*parts)))]
    ranks = _run_dp(tmp_path_factory.mktemp("lighthead_dp"), cfg,
                    [weights] * WORLD, [tbatch], draws)
    return cfg, weights, [tbatch], draws, ref, ranks


def test_dp_lighthead_step_matches_jax(lighthead_dp):
    """Parameters' updates, BatchNorm stats and metrics of rank 0 against
    JAX's DP step, within the whole-step test's STEP_RTOL of each leaf's
    largest value (plus an fp32 ulp of the parameter for the updates)."""
    _, _, _, _, ref, ranks = lighthead_dp
    got = ranks[0]
    upd_got = {n: got["params"][n] - ref["params0"][n] for n in ref[
        "params0"]}
    upd_ref = {n: ref["params1"][n] - ref["params0"][n] for n in ref[
        "params0"]}
    _assert_leaves_close(upd_got, upd_ref, "update", ulp_of=ref["params1"])
    _assert_leaves_close(got["stats"], ref["batch_stats"], "batch stat")
    assert set(got["metrics"][0]) == set(ref["metrics"])
    for k, want in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][0][k], want, rtol=STEP_RTOL,
                                   atol=1e-6, err_msg=k)
    assert ref["metrics"]["roi_num_fg"] > 0


def test_dp_lighthead_step_equals_the_accumulation_bitwise(lighthead_dp):
    """Two ranks of 2 images = one process accumulating 2 microbatches of 2
    (the same draws), bit for bit: parameters, BatchNorm stats, momentum,
    metrics; and the ranks equal each other."""
    cfg, weights, batches, draws, _, ranks = lighthead_dp
    want, metrics = _accumulated(cfg, weights, batches, draws)
    for got in ranks:
        assert_bitwise(got["snapshot"], want)
        assert got["metrics"] == metrics


# ---------------------------------------------------------------------------
# The SSD family with its EMA shadow, 3 steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ssd_dp(tmp_path_factory):
    cfg = small_ssd_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=4, weight_decay=1e-2))
    assert cfg.train.ema_decay > 0
    # the ranks start from other weights
    weights = [build_model(cfg.model, "cpu", seed=r,
                           dtype=torch.float32).state_dict()
               for r in range(WORLD)]
    batches = []
    for seed in range(3):
        b = get_batch(cfg, seed=seed)
        batches.append({k: torch.from_numpy(np.array(v))
                        for k, v in b.items()})
    ranks = _run_dp(tmp_path_factory.mktemp("ssd_dp"), cfg, weights,
                    batches, None)
    return cfg, weights, batches, ranks


def test_dp_ranks_stay_bitwise_equal(ssd_dp):
    """After 3 steps every rank holds the same parameters, BatchNorm stats,
    momentum buffers and EMA shadow, bit for bit, and logged the same
    metrics; the shadow moved off the parameters."""
    *_, ranks = ssd_dp
    tensors, step = ranks[0]["snapshot"]
    assert step == 3 and any(k.startswith("ema.") for k in tensors)
    for other in ranks[1:]:
        assert_bitwise(other["snapshot"], ranks[0]["snapshot"])
        assert other["metrics"] == ranks[0]["metrics"]
    assert any(not torch.equal(tensors["ema." + n], p)
               for n, p in ranks[0]["params"].items())


def test_dp_ssd_with_ema_equals_the_accumulation_bitwise(ssd_dp):
    """The DP run from rank 0's weights (replicated) equals 3 accumulation
    steps from them, shadow included, bit for bit."""
    cfg, weights, batches, ranks = ssd_dp
    want, metrics = _accumulated(cfg, weights[0], batches, None)
    assert_bitwise(ranks[0]["snapshot"], want)
    assert ranks[0]["metrics"] == metrics
    assert all(m["ssd_num_fg"] > 0 for m in metrics)


# ---------------------------------------------------------------------------
# Evaluation, sharding, the launcher
# ---------------------------------------------------------------------------

def _oracle_eval_fn(images):
    """Detections read off the images: pixel (0, j) of channel 0 holds box
    coordinate j (x 100, after whitening), pixel (0, 4) the class; one
    detection an image, so a row sent back to the wrong image scores 0."""
    from x_detector_tpu_torch.config import DataConfig
    code = images[:, 0, :5, 0] + DataConfig().pixel_means[0]
    boxes = torch.zeros(images.shape[0], 4, 4)
    boxes[:, 0] = code[:, :4] / 100.0
    classes = torch.zeros(images.shape[0], 4, dtype=torch.int32)
    classes[:, 0] = code[:, 4].round().int()
    scores = torch.where(classes > 0, 0.9, 0.0)
    return boxes, scores, classes, classes > 0


def _eval_batches(sizes, size=16):
    rng = np.random.default_rng(5)
    batches = []
    for n in sizes:
        lo = rng.uniform(0.0, 0.5, (n, 2))
        boxes = np.concatenate([lo, lo + rng.uniform(0.2, 0.4, (n, 2))], 1)
        labels = rng.integers(1, 6, n)
        img = rng.uniform(0, 255, (n, size, size, 3)).astype(np.float32)
        img[:, 0, :4, 0] = boxes * 100.0
        img[:, 0, 4, 0] = labels
        batches.append({
            "image": img,
            "gt_boxes": boxes[:, None].astype(np.float32),
            "gt_labels": labels[:, None].astype(np.int32),
            "gt_mask": np.ones((n, 1), bool),
            "image_id": [f"im{len(batches)}_{i}".encode() for i in range(n)]})
    return batches


def _eval_rank(rank, world, sizes):
    torch.set_num_threads(1)
    from x_detector_tpu_torch.config import lighthead_xception
    return run_eval(torch.nn.Linear(1, 1), lighthead_xception(16),
                    iter(_eval_batches(sizes)), len(sizes),
                    eval_fn=_oracle_eval_fn, rank=rank, world=world)


def test_dp_eval_equals_one_process():
    """Batches of 3, 2 and 1 images over 2 ranks (zero rows padded, rows
    gathered back in order): the evaluator's result equals one process's,
    and every detection found its image (mAP 1)."""
    sizes = (3, 2, 1)
    one = _eval_rank(0, 1, sizes)
    two = mesh.run_ranks(_eval_rank, WORLD, "gloo", (sizes,),
                         timeout_s=JOIN_TIMEOUT_S)
    assert two == one
    assert one["mAP"] == pytest.approx(1.0)


def _fail_on_rank_one(rank, world):
    if rank == 1:
        raise SystemExit(3)
    torch.distributed.barrier()
    return rank


def test_run_ranks_raises_when_a_rank_fails():
    """A rank that exits with an error ends the run with an error naming it
    (rank 0, waiting in a collective, is ended too)."""
    with pytest.raises(RuntimeError, match=r"ranks \[(0, )?1\] of 2 failed"):
        mesh.run_ranks(_fail_on_rank_one, WORLD, "gloo",
                       timeout_s=JOIN_TIMEOUT_S)


def test_shard_rows_and_batches():
    batch = {"image": np.arange(8).reshape(4, 2), "image_id": list("abcd")}
    got = mesh.shard_batch(batch, 1, 2)
    assert got["image"].tolist() == [[4, 5], [6, 7]]
    assert got["image_id"] == ["c", "d"]
    assert mesh.shard_rows(6, 2, 3) == slice(4, 6)
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_rows(5, 0, 2)


def test_require_devices_counts_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices.*1 visible"):
        mesh.require_devices("cuda", 2)
    mesh.require_devices("cuda", 1)
    mesh.require_devices("cpu", 8)
    assert mesh.backend_for("cuda") == "nccl"
    assert mesh.backend_for("cpu") == "gloo"


def test_sharded_augmentation_equals_the_whole_batchs():
    """Each rank draws the global batch's augmentation and applies its rows:
    two ranks' halves, put together, are the whole batch augmented on one
    device, bit for bit (one thread)."""
    from x_detector_tpu_torch.config import lighthead_xception
    from x_detector_tpu_torch.data.augment import preprocess_batch_for_train
    from x_detector_tpu_torch.data.synthetic import synthetic_batch_device
    cfg = lighthead_xception(64).data
    raw = synthetic_batch_device(torch.Generator().manual_seed(1), 4, 76, 8)
    whole = preprocess_batch_for_train(torch.Generator().manual_seed(5), raw,
                                       cfg)
    parts = [preprocess_batch_for_train(
        torch.Generator().manual_seed(5), mesh.shard_batch(raw, r, WORLD),
        cfg, shard=(r, WORLD)) for r in range(WORLD)]
    for k, v in whole.items():
        assert torch.equal(torch.cat([p[k] for p in parts]), v), k
