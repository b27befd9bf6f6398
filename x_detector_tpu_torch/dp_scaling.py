"""Config 5 across the visible cards, against one card, in one call.

    python -m x_detector_tpu_torch.dp_scaling [--world N] [--steps K]

Config 5 is config 4's model (``lighthead_xception`` at 800 px) trained at
a global batch of 128. The script runs its data-parallel step at world N
(NCCL, one rank a card, 128 / N images a rank in microbatches of 8), then
at world 1 on card 0 (16 microbatches of 8), each for one warm-up and K
timed steps on synthetic batches made on the card, and prints per rank:
step seconds, the flattened all-reduce's ms (timed alone with CUDA events),
peak memory and whether every rank holds the same parameters (their sums
gathered to every rank). Then ``cli.train --num-devices N --data-dir``
for 3 steps over the committed mini VOC tree (the native loader on every
rank). Prints the card's name and power limit first. ``run_steps`` and
``allreduce_ms`` also drive and time the step in ``chip_smoke.py``'s
``dp`` phase.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

GLOBAL_BATCH = 128
CANVAS_SCALE = 1.2          # raw canvases: 960 px for 800 px inputs
TESTDATA = Path(__file__).resolve().parent / "data" / "testdata"


def run_steps(cfg, device, steps: int, rank: int = 0, world: int = 1,
              seed: int = 0) -> dict:
    """The data-parallel step on this rank of an initialised group: the
    state built from ``seed`` and replicated from rank 0, then one warm-up
    and ``steps`` timed steps. Each step makes the same global batch on
    every rank (synthetic, on ``device``, on 1.2x canvases), augments this
    rank's rows as part of it, and draws the RPN samples from a generator
    seeded with the step and the rank. Returns the state, the last step's
    metrics, the parameters before the first step ("before"), the timed
    steps' seconds and every step's metrics as floats ("losses")."""
    from x_detector_tpu_torch.data.augment import preprocess_batch_for_train
    from x_detector_tpu_torch.data.synthetic import synthetic_batch_device
    from x_detector_tpu_torch.parallel import mesh
    from x_detector_tpu_torch.parallel.data_parallel import (
        make_dp_train_step)
    from x_detector_tpu_torch.train.trainer import create_model_and_state
    device = torch.device(device)
    state = mesh.replicate_state(create_model_and_state(cfg, device,
                                                        seed=seed))
    step = make_dp_train_step(state.model, cfg)
    before = [p.detach().clone() for p in state.model.parameters()]
    gen = torch.Generator(device=device).manual_seed(seed + 100)
    b = cfg.train.batch_size
    rows = mesh.shard_rows(b, rank, world)
    canvas = int(cfg.data.image_size * CANVAS_SCALE)
    sync = (lambda: torch.cuda.synchronize(device)) if (
        device.type == "cuda") else (lambda: None)
    seconds, losses = [], []
    for i in range(steps + 1):
        sync()
        t0 = time.perf_counter()
        raw = synthetic_batch_device(gen, b, canvas, cfg.data.max_gt_boxes)
        batch = preprocess_batch_for_train(
            gen, {k: v[rows] for k, v in raw.items()}, cfg.data,
            shard=(rank, world))
        draws = torch.Generator(device=device).manual_seed(
            seed + 1000 * i + rank)
        state, metrics = step(state, batch, draws)
        sync()
        seconds.append(time.perf_counter() - t0)
        losses.append({k: v.item() for k, v in metrics.items()})
    return {"state": state, "metrics": metrics, "before": before,
            "seconds": seconds[1:], "losses": losses}


def allreduce_ms(model, metrics, device, reps: int = 10) -> float:
    """The DP step's flattened all-reduce of ``model``'s gradients and
    BatchNorm stats and of ``metrics``, timed alone after two warm-up
    calls: CUDA events on a card, the host clock elsewhere."""
    from x_detector_tpu_torch.parallel.data_parallel import make_sync
    sync = make_sync(model)
    for _ in range(2):
        sync(metrics)
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            sync(metrics)
        return (time.perf_counter() - t0) / reps * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        sync(metrics)
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def dp_rank(rank: int, world: int, steps: int) -> dict:
    """One rank of config 5's DP step: its readings (printed as well)."""
    import torch.distributed as dist
    from x_detector_tpu_torch.config import config5
    from x_detector_tpu_torch.parallel import mesh
    dev = mesh.rank_device("cuda", rank)
    cfg = config5(world)
    res = run_steps(cfg, dev, steps, rank, world)
    model = res["state"].model
    ms = allreduce_ms(model, res["metrics"], dev)
    sums = torch.stack([p.detach().double().sum()
                        for p in model.parameters()])
    gathered = [torch.empty_like(sums) for _ in range(world)]
    dist.all_gather(gathered, sums)
    out = {"world": world, "rank": rank,
           "accum": cfg.train.grad_accum_steps, "step_s": res["seconds"],
           "allreduce_ms": ms,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "ranks_equal": all(torch.equal(g, gathered[0])
                              for g in gathered)}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> None:
    from x_detector_tpu_torch import _build
    from x_detector_tpu_torch.cli import convert_voc, train
    from x_detector_tpu_torch.parallel import mesh
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--world", type=int, default=None,
                   help="ranks (default: every visible card)")
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dp_scaling needs CUDA cards")
    world = args.world or torch.cuda.device_count()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.build()                  # once, before the ranks load it
    for w in (world, 1):
        res = mesh.run_ranks(dp_rank, w, "nccl", (args.steps,),
                             timeout_s=600)
        mean = sum(res["step_s"]) / len(res["step_s"])
        print(f"world {w}: step {mean * 1e3:.2f} ms = "
              f"{GLOBAL_BATCH / mean:.1f} images/s "
              f"({GLOBAL_BATCH / mean / w:.1f} a card)", flush=True)
    tmp = tempfile.mkdtemp()
    try:
        shutil.copytree(TESTDATA / "voc_mini", f"{tmp}/voc")
        convert_voc.main(["--voc-root", f"{tmp}/voc", "--output-dir",
                          f"{tmp}/shards"])
        t0 = time.perf_counter()
        train.main(["--preset", "lighthead_xception", "--num-devices",
                    str(world), "--batch-size", str(4 * world),
                    "--data-dir", f"{tmp}/shards", "--model-dir",
                    f"{tmp}/model", "--steps", "3", "--log-every", "1"])
        print(f"cli.train --num-devices {world} --data-dir: 3 steps in "
              f"{time.perf_counter() - t0:.1f} s (start-up included)",
              flush=True)
    finally:
        shutil.rmtree(tmp)


if __name__ == "__main__":
    main()
