"""Training steps, back to back, as ``cli/train.py`` runs them, on one
card or data-parallel over the cell's cards.

Set-up makes the seeded weights and a pool of distinct raw batches on
``canvas`` x ``canvas`` canvases (``reference.synthetic`` on the card),
builds the program's train state and ``make_train_step`` (over several
cards ``make_dp_train_step``, one spawned rank a card, ``parallel/mesh.
run_ranks``, each rank making its own rows of the global batch), and runs
the first ``CHECKED_STEPS`` steps on pool batches that all differ: they
warm up every shape, and the reference follows them after the window. A
step draws its augmentation from a generator seeded from ``--seed`` and
the step (the global batch's draws, each rank applying its rows) and its
RPN samples after them from the same generator on one card, or from one
seeded with the rank folded in on several; it goes through the program's
``preprocess_batch_for_train`` and the train step; its metrics stay on
the card until the window's end, as the CLI reads them at log steps only.

On one card the window issues steps until the host clock passes
``--seconds``, then waits for the card; on several, all ranks run the
number of steps that the checked steps' pace fits into ``--seconds``
between two barriers. The window runs to the end of that wait.
``train_images_per_s`` is every image of every step (all ranks') over it;
``train_peak_gib`` the most memory allocated in it on the fullest card.

Traffic parameters (``traffic/<mix>.json``): ``batch`` (the global batch),
``canvas``, ``pool_batches`` (at least ``CHECKED_STEPS``, so that the
checked steps' rows all differ), ``traced_steps``.
"""

from __future__ import annotations

import gc
import os
import time

import torch

from benchmark.harness import (core, program, spans as spans_lib, trace,
                               weights)
from benchmark.reference import nets, roofline, synthetic, train_check
from benchmark.reference.train_ref import StepPlan

SEED_POOL = 11
MAX = (1 << 63)
CHECKED_STEPS = 3     # the steps of set-up that the reference follows


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator (its augmentation draws)."""
    return (seed * 1_000_003 + step * 7_919 + 17) % MAX


def rpn_seed(seed: int, step: int, rank: int) -> int:
    """The seed of a rank's RPN draws in a data-parallel step."""
    return (step_seed(seed, step) * 31 + 104_729 * (rank + 1)) % MAX


def make_pool(seed: int, rank: int, n: int, rows: int, canvas: int,
              max_gt: int, device):
    """A rank's rows of ``n`` raw batches."""
    gen = torch.Generator(device=device).manual_seed(
        (seed * 7919 + SEED_POOL + rank * 104_729) % MAX)
    return [synthetic.batch(gen, rows, canvas, max_gt=max_gt)
            for _ in range(n)]


def step_plan(cfgj: dict, world: int, seed: int, step: int) -> StepPlan:
    """How the program splits a global step: its microbatches, and on
    several cards each rank's RPN draws."""
    t = cfgj["train"]
    micro = t["batch_size"] // world // t["grad_accum_steps"]
    if world == 1:
        return StepPlan(micro=None if micro == t["batch_size"] else micro)
    return StepPlan(micro=micro, rpn_seeds=[rpn_seed(seed, step, r)
                                            for r in range(world)])


def global_raws(cfgj: dict, t: dict, world: int, seed: int, steps: int,
                device):
    """The raw global batch of each of the first ``steps`` steps, every
    rank's rows in rank order."""
    pools = [make_pool(seed, r, t["pool_batches"], t["batch"] // world,
                       t["canvas"], cfgj["data"]["max_gt_boxes"], device)
             for r in range(world)]
    return [{k: torch.cat([p[i % len(p)][k] for p in pools])
             for k in pools[0][0]} for i in range(steps)]


def run(cell, seed: int, seconds: float, traced: bool, device,
        started: float) -> dict:
    if cell.chips == 1:
        return _run(0, 1, cell, seed, seconds, traced, device, started)
    from x_detector_tpu_torch.parallel import mesh
    return mesh.run_ranks(_rank, cell.chips, mesh.backend_for(device.type),
                          args=(cell, seed, seconds, traced, device.type,
                                started))


def _rank(rank: int, world: int, cell, seed, seconds, traced, device_type,
          started):
    from x_detector_tpu_torch.parallel import mesh
    # the ranks share the host's cores: a share each, not all each
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    device = mesh.rank_device(device_type, rank)
    return _run(rank, world, cell, seed, seconds, traced, device, started)


def _run(rank: int, world: int, cell, seed: int, seconds: float,
         traced: bool, device, started: float):
    from x_detector_tpu_torch.data.augment import preprocess_batch_for_train
    dist = _Dist(world, device)
    cfgj, t = cell.config, cell.traffic
    batch, rows = t["batch"], t["batch"] // world
    phases = [("start", started), ("imports", time.perf_counter())]
    params = weights.make(nets.param_spec(cfgj), seed, device)
    phases.append(("weights", time.perf_counter()))
    cfg, state, step = program.build_training(cfgj, params, device, world)
    model = state.model
    phases.append(("program", time.perf_counter()))
    pool = make_pool(seed, rank, t["pool_batches"], rows, t["canvas"],
                     cfg.data.max_gt_boxes, device)
    phases.append(("pool", time.perf_counter()))
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def one(i: int):
        gen = torch.Generator(device=device).manual_seed(step_seed(seed, i))
        aug = preprocess_batch_for_train(gen, pool[i % len(pool)], cfg.data,
                                         shard=(rank, world))
        if world > 1:
            gen = torch.Generator(device=device).manual_seed(
                rpn_seed(seed, i, rank))
        return step(state, aug, gen)[1]

    # the checked steps: every forward's outputs (the RPN's of the first
    # only), the losses, SGD's state after the first step and the
    # parameters after the last
    names = {p: n for n, p in model.named_parameters()}
    outs = []

    def keep(_m, _i, o):
        kept = ("proposals", "proposal_valid") + (
            ("rpn_cls", "rpn_loc") if not outs and rank == 0 else ())
        outs.append({k: o[k].detach().clone() for k in kept})

    hook = model.register_forward_hook(keep)
    losses, first, paces = [], None, []
    for i in range(CHECKED_STEPS):
        t0 = time.perf_counter()
        metrics = one(i)
        losses.append(float(metrics["total_loss"]))
        paces.append(time.perf_counter() - t0)
        if i == 0:
            first = {names[p]: s["momentum_buffer"].detach().clone()
                     for p, s in state.optimizer.state.items()}
    hook.remove()
    outs = dist.to_rank0(outs, CHECKED_STEPS)
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    # what the check keeps waits on the host, out of the window's memory
    held = _to((params, first, after, outs), "cpu")
    del params, first, after, outs
    sync()
    peak_setup = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    n = CHECKED_STEPS
    steps = dist.from_rank0(max(1, round(seconds / min(paces[1:] or paces))))
    dist.barrier()
    phases.append(("checked_steps", time.perf_counter()))
    setup_s = time.perf_counter() - started
    t_start = time.perf_counter()
    while True:
        metrics = one(n)
        n += 1
        if (world == 1 and time.perf_counter() - t_start >= seconds) or (
                world > 1 and n - CHECKED_STEPS == steps):
            break
    sync()
    dist.barrier()
    window_s = time.perf_counter() - t_start
    float(metrics["total_loss"])            # read at the window's end
    done = n - CHECKED_STEPS
    images_per_s = done * batch / window_s
    peak = dist.max(torch.cuda.max_memory_allocated(device) if on_card
                    else 0)
    e2e = {"setup_s": setup_s, "train_images_per_s": images_per_s,
           "train_peak_gib": peak / 2 ** 30}
    result = {"attempted": done * batch, "failed": 0, "setup": phases,
              "metrics": e2e}

    if traced:
        rois = cfgj["proposals"]["post_nms_topk"]
        micro = rows // cfg.train.grad_accum_steps
        info = {"images_per_s": images_per_s, "cards": world,
                "flop_per_image": roofline.count_flops(
                    cfgj, micro, rois, train=True) / micro,
                "b1_bwd_bound_ms_per_unit": cfg.train.grad_accum_steps
                * roofline.psroi_bwd_bound_ms(cfgj, micro, rois)}
        sp = spans_lib.Spans(model, cfgj.get("spans", {}))

        def unit(i: int) -> None:
            with torch.profiler.record_function("bench/step"):
                one(n + i)

        window = trace.traced(unit, t["traced_steps"], info,
                              counters=program.kernel_launches,
                              agree=dist.all)
        sp.remove()
        result.update(window=window, busy_s=dist.mean(window.busy_s),
                      window_s=dist.mean(window.window_s))
    result["memory_peak_bytes"] = max(peak, dist.max(peak_setup))
    # what each rank has loaded once the window has closed
    result["loaded"] = sorted(set().union(*dist.gather(
        core.forbidden_modules())))
    dist.barrier()
    del model, state, step, pool
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if rank:
        return None
    checked = CHECKED_STEPS
    params, first, after, outs = _to(held, device)
    raws = global_raws(cfgj, t, world, seed, checked, device)
    seeds = [step_seed(seed, i) for i in range(checked)]
    result["numbers"] = train_check.numbers(
        cfgj, params, raws, seeds, device, losses, first, after, outs,
        plan_of=lambda i: step_plan(cfgj, world, seed, i))
    return result


def _to(tree, device):
    """Every tensor of nested tuples, lists and dicts on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return type(tree)(_to(v, device) for v in tree)


class _Dist:
    """The few collectives the loop needs, or their one-rank identities."""

    def __init__(self, world: int, device):
        self.world, self.device = world, device
        if world > 1:
            import torch.distributed as dist
            self.dist = dist

    def barrier(self) -> None:
        if self.world > 1:
            self.dist.barrier()

    def _reduce(self, value: float, op) -> float:
        if self.world == 1:
            return value
        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=self.device)
        self.dist.all_reduce(t, op=op)
        return float(t)

    def max(self, value: float) -> float:
        return self._reduce(value, self.world > 1 and self.dist.ReduceOp.MAX)

    def mean(self, value: float) -> float:
        return self._reduce(value, self.world > 1 and self.dist.ReduceOp.SUM
                            ) / self.world

    def all(self, value: bool) -> bool:
        """Whether ``value`` holds on every rank."""
        return self._reduce(float(value), self.world > 1
                            and self.dist.ReduceOp.MIN) > 0.5

    def gather(self, value) -> list:
        """Every rank's ``value`` on rank 0 (on the others, theirs alone)."""
        if self.world == 1:
            return [value]
        got = [None] * self.world if self.dist.get_rank() == 0 else None
        self.dist.gather_object(value, got, dst=0)
        return got or [value]

    def from_rank0(self, value):
        if self.world == 1:
            return value
        box = [value]
        self.dist.broadcast_object_list(box, src=0)
        return box[0]

    def to_rank0(self, outs: list, steps: int) -> list:
        """Every rank's forward outputs, on rank 0, in the global batch's
        order step by step (rank by rank within a step)."""
        if self.world == 1:
            return outs
        got = [None] * self.world if self.dist.get_rank() == 0 else None
        self.dist.gather_object([{k: v.cpu() for k, v in o.items()}
                                 for o in outs], got, dst=0)
        if got is None:
            return []
        per = len(got[0]) // steps
        return [{k: v.to(self.device) for k, v in o.items()}
                for i in range(steps) for r in got
                for o in r[i * per:(i + 1) * per]]
