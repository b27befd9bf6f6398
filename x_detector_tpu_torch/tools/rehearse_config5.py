"""Config 5's crash-and-resume rehearsal: data-parallel training, a hard
kill right after a checkpoint lands, a resume, and the whole train state
bitwise equal to an uninterrupted run's.

The port of the JAX package's ``tools/rehearse_config5.py``. Three runs,
each a fresh process:

  A  an uninterrupted ``--steps``-step data-parallel Light-Head run;
  B  the same run with a checkpoint every ``--ckpt-every`` steps, killed
     with ``os._exit(KILL_EXIT)`` right after the step-K checkpoint has
     landed (``CheckpointManager.save`` returns once the file is in place):
     a crash with a durable checkpoint and no graceful shutdown;
  C  ``--resume`` from B's newest checkpoint, continued to ``--steps``.

It passes if and only if every tensor of run C's train state
(``train_state.train_snapshot``: parameters, BatchNorm running stats, SGD
momentum, the step) is bitwise equal to run A's, and prints one JSON
verdict line with the JAX tool's keys; a mismatch exits 1.

Ranks. ``--device cpu``: ``--devices`` gloo ranks (8 by default), each a
spawned process (``mesh.run_ranks``) on one thread. On the card (the
default): one rank a visible card over NCCL (``--devices`` defaults to the
visible count); a world of one runs in the child itself. In run B every
rank waits at a barrier behind rank 0's save, then exits with
``KILL_EXIT``; the child exits with ``KILL_EXIT`` only when every rank
did, and any other failure stays a failure.

``--per-device-batch`` is a rank's microbatch: each step a rank takes
``per-device-batch x grad-accum`` rows of the global batch, so one card at
``--per-device-batch 8 --grad-accum 16`` steps on config 5's global batch
of 128. (The JAX tool splits ``--per-device-batch`` into ``--grad-accum``
microbatches instead; the two read alike at ``--grad-accum 1``.)

The model is the JAX tool's tiny Light-Head (``tiny_lh_dp``, 64 px, fp32 on
the CPU). ``--full-width`` builds config 5's model instead (config 4's
``lighthead_xception`` at 800 px, ``config.config5``), which the card runs
in bf16. Step i's global batch, augmentation and RPN draws come from
``cli.train.position_generator`` keyed (seed 0, stream, i), so any run
draws the same at step i; each rank keeps its rows.

On the card every child runs with cuDNN deterministic and
``torch.use_deterministic_algorithms(True, warn_only=True)`` and prints the
ops PyTorch warned about. Rank 0 of every child prints its steps' losses
and seconds and its kernels' launch counts (``ops.library.launch_line``).

  python -m x_detector_tpu_torch.tools.rehearse_config5 --device cpu \\
      [--steps 24] [--ckpt-every 8]
  python -m x_detector_tpu_torch.tools.rehearse_config5 --device cpu \\
      --devices 16 --per-device-batch 8 --steps 6 --ckpt-every 2
  python -m x_detector_tpu_torch.tools.rehearse_config5 --full-width \\
      --per-device-batch 8 --grad-accum 16 --steps 6 --ckpt-every 2
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from typing import Callable, Optional

import torch
import torch.distributed as dist

from x_detector_tpu_torch.cli.train import (AUGMENT_STREAM, STEP_STREAM,
                                            position_generator)
from x_detector_tpu_torch.config import (DataConfig, ExperimentConfig,
                                         ModelConfig, NMSConfig,
                                         ProposalConfig, TrainConfig,
                                         config5)
from x_detector_tpu_torch.data.augment import preprocess_batch_for_train
from x_detector_tpu_torch.data.synthetic import synthetic_batch_device
from x_detector_tpu_torch.ops import anchors as anchor_lib
from x_detector_tpu_torch.ops.library import launch_line
from x_detector_tpu_torch.parallel import mesh
from x_detector_tpu_torch.parallel.data_parallel import make_dp_train_step
from x_detector_tpu_torch.tools import repo_env
from x_detector_tpu_torch.tools.fast_nms_ab import harness_dtype
from x_detector_tpu_torch.train import losses as loss_lib
from x_detector_tpu_torch.train.checkpoint import CheckpointManager
from x_detector_tpu_torch.train.train_state import (snapshot_differs,
                                                    train_snapshot)
from x_detector_tpu_torch.train.trainer import create_model_and_state

KILL_EXIT = 17
SEED, DATA_STREAM = 0, 0
CANVAS_SCALE = 1.2
CPU_DEVICES = 8


def rehearsal_config(world: int, per_device_batch: int, grad_accum: int,
                     full_width: bool) -> ExperimentConfig:
    """The run's config: a global batch of ``world x per_device_batch x
    grad_accum``, each rank in ``grad_accum`` microbatches of
    ``per_device_batch``; the JAX tool's tiny Light-Head, or with
    ``full_width`` config 5's."""
    global_batch = world * per_device_batch * grad_accum
    if full_width:
        return config5(world, 800, global_batch, per_device_batch)
    model = ModelConfig(
        name="tiny_lh_dp", backbone="xception_lite", family="lighthead",
        image_size=64, large_sep_mid=16, head_dim=64,
        backbone_stages=(1, 1, 1, 1), backbone_widths=(32, 64, 96, 128),
        proposals=ProposalConfig(pre_nms_topk=128, post_nms_topk=32,
                                 pre_nms_topk_eval=128,
                                 post_nms_topk_eval=32, min_size=2.0),
        nms=NMSConfig(max_output=20))
    return ExperimentConfig(
        model=model, data=DataConfig(image_size=64, max_gt_boxes=8),
        train=TrainConfig(batch_size=global_batch, learning_rate=1e-3,
                          warmup_steps=0, weight_decay=0.0, ohem_topk=16,
                          grad_accum_steps=grad_accum))


def step_batch(cfg, device: torch.device, step: int, rank: int, world: int):
    """This rank's rows of step ``step``'s global batch, augmented as part
    of it, and its rows of the step's RPN draws: pure functions of the
    step."""
    b, size = cfg.train.batch_size, cfg.model.image_size
    rows = mesh.shard_rows(b, rank, world)
    raw = synthetic_batch_device(
        position_generator(device, SEED, DATA_STREAM, step), b,
        int(size * CANVAS_SCALE), cfg.data.max_gt_boxes)
    batch = preprocess_batch_for_train(
        position_generator(device, SEED, AUGMENT_STREAM, step),
        {k: v[rows] for k, v in raw.items()}, cfg.data, shard=(rank, world))
    draws = loss_lib.draw_rpn_priorities(
        position_generator(device, SEED, STEP_STREAM, step), b,
        anchor_lib.rpn_anchors(size, cfg.model.anchors).shape[0])
    return batch, loss_lib.RPNPriorities(*(d[rows] for d in draws))


def world_size(args) -> int:
    if args.devices:
        return args.devices
    if torch.device(args.device).type == "cuda":
        return max(1, torch.cuda.device_count())
    return CPU_DEVICES


def _rank_main(rank: int, world: int, args) -> None:
    """One rank of a child run: build (or restore), step to ``--steps``,
    checkpoint, and in run B exit with KILL_EXIT after the kill step's
    checkpoint."""
    device_type = torch.device(args.device).type
    device = mesh.rank_device(device_type, mesh.local_rank())
    lead = rank == 0
    if device_type == "cuda":
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
    else:
        torch.set_num_threads(1)
    cfg = rehearsal_config(world, args.per_device_batch, args.grad_accum,
                           args.full_width)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state = create_model_and_state(cfg, device, seed=SEED,
                                       dtype=harness_dtype(device))
        step_fn = make_dp_train_step(state.model, cfg)
        mgr = (CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir
               else None)
        start = 0
        if args.resume:
            if mgr is None or mgr.latest_step() is None:
                raise SystemExit("nothing to resume")
            state, data_state = mgr.restore(state)
            start = int(data_state["position"])
            if lead:
                print(f"resumed at step {start}", flush=True)
        mesh.replicate_state(state)
        sync = ((lambda: torch.cuda.synchronize(device))
                if device_type == "cuda" else (lambda: None))
        for i in range(start, args.steps):
            sync()
            t0 = time.perf_counter()
            batch, draws = step_batch(cfg, device, i, rank, world)
            state, metrics = step_fn(state, batch, priorities=draws)
            loss = metrics["total_loss"].item()
            if lead:
                print(f"step {i + 1}: loss {loss:.6f}, "
                      f"{time.perf_counter() - t0:.3f} s", flush=True)
            if mgr and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
                if lead:
                    mgr.save(i + 1, state, {"position": i + 1})
                if args.kill_after and i + 1 >= args.kill_after:
                    if lead:
                        print(launch_line(), flush=True)
                        print(f"hard-killing after step {i + 1}", flush=True)
                    if world > 1:
                        dist.barrier()      # the checkpoint is durable...
                    os._exit(KILL_EXIT)     # ...then crash
    if not lead:
        return
    torch.save(train_snapshot(state), args.out)
    print(launch_line(), flush=True)
    if device_type == "cuda":
        print("nondeterministic ops warned: " + json.dumps(sorted({
            str(w.message).split(".")[0] for w in caught
            if "deterministic" in str(w.message)})), flush=True)
    print(f"final loss {loss:.6f}; step {state.step} -> {args.out}",
          flush=True)


def child_main(args) -> int:
    """A child run: its ranks, or in a world of one the run itself. Run B
    exits with KILL_EXIT only when every rank did."""
    device_type = torch.device(args.device).type
    world = world_size(args)
    mesh.require_devices(device_type, world)
    if world == 1:
        mesh.init_group(mesh.backend_for(device_type))
        try:
            _rank_main(0, 1, args)
        finally:
            dist.destroy_process_group()
        return 0
    try:
        mesh.run_ranks(_rank_main, world, mesh.backend_for(device_type),
                       (args,))
    except mesh.RanksFailed as e:
        if args.kill_after and e.exit_codes == {
                r: KILL_EXIT for r in range(world)}:
            return KILL_EXIT
        raise
    return 0


def child_env(device_type: str) -> dict:
    if device_type != "cuda":
        return repo_env()
    # cuBLAS's deterministic workspaces, set before CUDA starts
    return repo_env(CUBLAS_WORKSPACE_CONFIG=os.environ.get(
        "CUBLAS_WORKSPACE_CONFIG", ":4096:8"))


def run_child(out: str, args, ckpt_dir: Optional[str] = None,
              kill_after: int = 0, resume: bool = False) -> int:
    cmd = [sys.executable, "-m", "x_detector_tpu_torch.tools.rehearse_config5",
           "--mode", "child", "--out", out, "--steps", str(args.steps),
           "--devices", str(world_size(args)),
           "--per-device-batch", str(args.per_device_batch),
           "--grad-accum", str(args.grad_accum), "--device", args.device]
    if args.full_width:
        cmd += ["--full-width"]
    if ckpt_dir:
        cmd += ["--ckpt-dir", ckpt_dir, "--ckpt-every", str(args.ckpt_every)]
    if kill_after:
        cmd += ["--kill-after", str(kill_after)]
    if resume:
        cmd += ["--resume"]
    sys.stdout.flush()
    return subprocess.run(cmd, env=child_env(torch.device(
        args.device).type)).returncode


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", default="parent", choices=["parent", "child"])
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--ckpt-every", type=int, default=8)
    p.add_argument("--devices", type=int, default=0,
                   help="ranks, one a device (default: 8 gloo ranks on the "
                        "CPU, one a visible card on CUDA)")
    p.add_argument("--per-device-batch", type=int, default=1,
                   help="a rank's microbatch (8 = config 5's)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="microbatches a rank accumulates a step (16 on one "
                        "card = config 5's global batch of 128)")
    p.add_argument("--full-width", action="store_true",
                   help="config 5's model (lighthead_xception at 800 px) in "
                        "place of the tiny Light-Head")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; one rank a card) or cpu (gloo "
                        "ranks)")
    p.add_argument("--kill-after", type=int, default=0)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def main(argv=None, after_kill: Optional[Callable[[str], None]] = None
         ) -> int:
    """Runs A, B and C and the verdict; returns the exit code (1 on a
    mismatch). ``after_kill(ckpt_dir)``, if given, runs between B and C."""
    args = parse_args(argv)
    if args.mode == "child":
        return child_main(args)
    if torch.device(args.device).type == "cuda" and (
            not torch.cuda.is_available()):
        raise SystemExit("--device cuda: no CUDA device is present (pass "
                         "--device cpu for gloo ranks on the CPU)")
    world = world_size(args)
    kill_at = args.ckpt_every * max(1, args.steps // (2 * args.ckpt_every))
    with tempfile.TemporaryDirectory(prefix="rehearse_c5_") as work:
        a_out, c_out = f"{work}/a.pt", f"{work}/c.pt"
        ckpt = f"{work}/ckpt"
        shape = (f"{world} {args.device} ranks x {args.per_device_batch} x "
                 f"{args.grad_accum} microbatches (global "
                 f"{world * args.per_device_batch * args.grad_accum})"
                 + (", full width" if args.full_width else ""))
        print(f"[A] uninterrupted {args.steps}-step DP run [{shape}]",
              flush=True)
        rc = run_child(a_out, args)
        if rc != 0:
            raise SystemExit(f"run A failed rc={rc}")
        print(f"[B] checkpointed run, hard-kill after step {kill_at}",
              flush=True)
        rc = run_child(f"{work}/b.pt", args, ckpt_dir=ckpt,
                       kill_after=kill_at)
        if rc != KILL_EXIT:
            raise SystemExit(f"run B should die with {KILL_EXIT}, rc={rc}")
        if after_kill is not None:
            after_kill(ckpt)
        print("[C] resume from the crash checkpoint", flush=True)
        rc = run_child(c_out, args, ckpt_dir=ckpt, resume=True)
        if rc != 0:
            raise SystemExit(f"run C failed rc={rc}")
        a, c = torch.load(a_out), torch.load(c_out)
    bad = snapshot_differs(a, c)
    print(json.dumps({
        "steps": args.steps, "killed_after": kill_at, "devices": world,
        "global_batch": world * args.per_device_batch * args.grad_accum,
        "grad_accum": args.grad_accum, "leaves": len(a),
        "mismatched": len(bad), "bitwise_identical": not bad}), flush=True)
    if bad:
        print("MISMATCHED LEAVES:", bad[:10], file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
