"""The torchrun path of the port's data parallelism, on the CPU: two real
processes started by ``python -m torch.distributed.run --standalone
--nproc-per-node 2`` with ``XDET_MULTIHOST=1``, each joining the gloo group
through ``parallel/mesh.maybe_initialize_distributed`` (``env://``).

The counterpart of the JAX package's ``tests/test_multihost.py``: each
process (``tests/_torch_multihost_child.py``) feeds only its local rows of
one seeded global batch to ``make_dp_train_step`` (JAX's small SSD, 1
image a rank, from JAX-initialised weights). The loss is the same in both
processes; both end with bitwise equal train states, equal to one
process's ``grad_accum_steps = 2`` step on the same global batch; and the
loss is within JAX's rel 1e-3 of the JAX package's mean of per-shard
losses. Then the CLI branch that torchrun takes (``cli/train.py``'s
``maybe_initialize_distributed``): ``cli.train`` at world 2 under torchrun
writes the same checkpoint, bit for bit, as ``--num-devices 2``
(``mesh.run_ranks``).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_multihost_child import small_ssd_cfg  # noqa: E402
from test_torch_cli import (_assert_checkpoints_equal,  # noqa: E402
                            _checkpoint, train_args)
from test_train import get_batch  # noqa: E402
from test_train import small_ssd_cfg as jax_small_ssd_cfg  # noqa: E402
from x_detector_tpu.train import trainer as jax_trainer  # noqa: E402
from x_detector_tpu_torch.cli import train  # noqa: E402
from x_detector_tpu_torch.inference import build_model  # noqa: E402
from x_detector_tpu_torch.train.schedule import make_optimizer  # noqa: E402
from x_detector_tpu_torch.train.train_state import (  # noqa: E402
    TrainState, snapshot_differs, train_snapshot)
from x_detector_tpu_torch.train.trainer import make_train_step  # noqa: E402
from x_detector_tpu_torch.utils.convert import (  # noqa: E402
    from_jax_variables)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "_torch_multihost_child.py")
WORLD = 2
TIMEOUT_S = 300


def torchrun(args, timeout=TIMEOUT_S):
    """``args`` under ``torch.distributed.run --standalone`` with WORLD
    processes on this machine, each a rank that joins through
    ``XDET_MULTIHOST=1``; returns the completed process."""
    env = dict(os.environ, XDET_MULTIHOST="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def multihost(tmp_path_factory):
    """JAX's weights and global batch, the two torchrun ranks' results and
    their printed losses."""
    cfg = small_ssd_cfg(WORLD)
    jcfg = jax_small_ssd_cfg()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    module, jstate = jax_trainer.create_model_and_state(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    batch = get_batch(jcfg)
    weights = from_jax_variables(jax.tree_util.tree_map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats}))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    work = tmp_path_factory.mktemp("multihost")
    torch.save({"weights": weights, "batch": tbatch}, work / "setup.pt")
    proc = torchrun([CHILD, str(work)])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    printed = {}
    for line in proc.stdout.splitlines():
        if line.startswith("MULTIHOST_LOSS"):
            _, rank, loss = line.split()
            printed[int(rank)] = float(loss)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=True)
             for r in range(WORLD)]
    return cfg, (module, jstate, batch), weights, tbatch, printed, ranks


def test_torchrun_ranks_print_the_same_loss(multihost):
    *_, printed, ranks = multihost
    assert set(printed) == set(range(WORLD))
    assert printed[0] == printed[1] == ranks[0]["loss"] == ranks[1]["loss"]
    assert np.isfinite(printed[0])


def test_torchrun_ranks_equal_the_accumulation_of_two_bitwise(multihost):
    """Both ranks' train states (parameters, BatchNorm stats, momentum, the
    EMA shadow, the step) bitwise equal to each other and to one process
    accumulating the same global batch in 2 microbatches."""
    cfg, _, weights, tbatch, _, ranks = multihost
    assert snapshot_differs(ranks[0]["snapshot"], ranks[1]["snapshot"]) == []
    acc = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, grad_accum_steps=WORLD))
    model = build_model(acc.model, "cpu", seed=None,
                        dtype=torch.float32).train()
    model.load_state_dict(weights)
    optimizer, schedule = make_optimizer(model, acc.train)
    state = TrainState.create(model, optimizer, schedule,
                              ema_decay=acc.train.ema_decay)
    state, metrics = make_train_step(model, acc)(state, tbatch)
    want = train_snapshot(state)
    assert any(k.startswith("momentum.") for k in want)
    assert snapshot_differs(ranks[0]["snapshot"], want) == []
    assert metrics["total_loss"].item() == ranks[0]["loss"]


def test_torchrun_loss_matches_jax_shard_mean(multihost):
    """The ranks' loss against the JAX package's mean of its jitted loss on
    each rank's rows (the DP loss is the mean of the per-rank losses), from
    the same weights: within JAX's own test's rel 1e-3."""
    cfg, (module, jstate, batch), *_, printed, _ = multihost
    loss_fn = jax.jit(jax_trainer.make_loss_fn(module, cfg))
    rng = jax.random.PRNGKey(1)
    b = cfg.train.batch_size // WORLD
    shard_losses = [float(loss_fn(
        jstate.params, jstate.batch_stats,
        {k: v[r * b:(r + 1) * b] for k, v in batch.items()},
        jax.random.fold_in(rng, r))[0]) for r in range(WORLD)]
    ref = float(np.mean(shard_losses))
    rel = abs(ref - printed[0]) / max(abs(ref), 1e-6)
    print(f"MULTIHOST_REF {ref:.8f} ranks {printed[0]:.8f} rel {rel:.2e}")
    assert rel < 1e-3, (ref, printed)


def test_torchrun_cli_writes_the_checkpoint_of_num_devices_2(tmp_path):
    """``cli.train --device cpu --dtype float32`` for 2 steps under torchrun
    at world 2 (each process a rank, ``cli/train.py``'s torchrun branch)
    and with ``--num-devices 2`` (ranks spawned by ``mesh.run_ranks``): the
    same checkpoint at step 2, bit for bit, and the same metrics."""
    dp = ("--batch-size", "4", "--steps", "2", "--checkpoint-every", "1")
    under = tmp_path / "torchrun"
    proc = torchrun(["-m", "x_detector_tpu_torch.cli.train",
                     *train_args("ssd_resnet50", under, *dp)])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("done: 2 steps") == 1     # rank 0 alone
    spawned = tmp_path / "spawned"
    assert train.main(train_args("ssd_resnet50", spawned, *dp,
                                 "--num-devices", "2")) is None
    for step in (1, 2):
        _assert_checkpoints_equal(_checkpoint(under, step),
                                  _checkpoint(spawned, step))
    assert _checkpoint(under, 2)["data_state"] == {"position": 2}
    drop = lambda text: [{k: v for k, v in rec.items() if k != "wall_time_s"}
                         for rec in map(json.loads, text.splitlines())]
    assert drop((under / "metrics.jsonl").read_text()) == drop(
        (spawned / "metrics.jsonl").read_text())
