"""Config 5's data-parallel step against the benchmark's plain reference,
on the CPU: the port's ``make_dp_train_step`` over four gloo ranks
(``mesh.run_ranks``) at a tiny cut of ``benchmark/configs/config5_dp4.json``
(64 px, widths 16 / 32 / 48 / 64, ``grad_accum_steps`` 2, microbatches of
2, float32), followed by ``benchmark/reference/train_ref.follow`` from the
same seeded weights and raw batches, the plan ``loops/train.step_plan``
builds (microbatches and each rank's RPN seed) and the program's own
proposals, as the benchmark's check does.

The gradients the exchange leaves in every rank's ``.grad`` and the first
update agree with the reference's to float32 rounding; the same ranks
stepping with the exchange left out (each rank's own rows alone) do not;
and the exchange all-reduces once a dtype a step, not once a microbatch.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from benchmark.harness import program, spec, weights  # noqa: E402
from benchmark.loops import train as loop  # noqa: E402
from benchmark.reference import nets, train_ref  # noqa: E402
from x_detector_tpu_torch.parallel import mesh  # noqa: E402
from x_detector_tpu_torch.parallel.data_parallel import (  # noqa: E402
    all_reduce_mean_)

WORLD = 4
SEED = 2 ** 31 + 2203
JOIN_TIMEOUT_S = 300
# Both sides run float32 on the CPU from the same weights, draws and
# proposals; what is left is the order of float32 sums (the port's
# convolutions, BatchNorm and microbatch means against plain ones, the
# four-rank sum against one process's). Measured on four seeds: 6.2e-7 to
# 9.1e-7 of the gradient's norm, 1.7e-6 to 2.6e-6 of the update's; leaving
# the exchange out (the first rank's quarter of the batch) reads 1.6 to 2.0.
GRAD_TOL = 1e-5     # ||g_prog - g_ref|| / ||g_ref|| over every leaf
UPDATE_TOL = 3e-5   # the same for the first update of the parameters


def _tiny():
    """(configuration, traffic) of the cut: the cell's own numbers but the
    widths, the image and the batch."""
    here = spec.HERE
    cfgj = json.loads((here / "configs" / "config5_dp4.json").read_text())
    cfgj.update(image_size=64, compute_dtype="float32",
                backbone_widths=[16, 32, 48, 64])
    cfgj["proposals"].update(pre_nms_topk=200, post_nms_topk=64)
    cfgj["train"].update(grad_accum_steps=2, batch_size=WORLD * 2 * 2)
    traffic = json.loads((here / "traffic" / "train_g128_800.json"
                          ).read_text())
    traffic.update(batch=cfgj["train"]["batch_size"], canvas=80,
                   pool_batches=1)
    return cfgj, traffic


def _step(rank, world, cfgj, t, seed, params, exchange: bool):
    """One step of this rank's rows as the benchmark's loop makes it:
    (model, its forwards' proposals, the counters' moves and the number of
    metrics)."""
    from x_detector_tpu_torch.data.augment import preprocess_batch_for_train
    device = torch.device("cpu")
    cfg, state, step = program.build_training(cfgj, params, device,
                                              world if exchange else 1)
    pool = loop.make_pool(seed, rank, 1, t["batch"] // world, t["canvas"],
                          cfg.data.max_gt_boxes, device)
    outs = []
    hook = state.model.register_forward_hook(lambda _m, _i, o: outs.append(
        {k: o[k].detach().clone() for k in ("proposals",
                                            "proposal_valid")}))
    calls, elements = all_reduce_mean_.calls, all_reduce_mean_.elements
    gen = torch.Generator(device=device).manual_seed(loop.step_seed(seed, 0))
    aug = preprocess_batch_for_train(gen, pool[0], cfg.data,
                                     shard=(rank, world))
    _, metrics = step(state, aug, torch.Generator(device=device).manual_seed(
        loop.rpn_seed(seed, 0, rank)))
    hook.remove()
    return state.model, outs, (all_reduce_mean_.calls - calls,
                               all_reduce_mean_.elements - elements,
                               len(metrics))


def _rank(rank, world, cfgj, t, seed):
    import torch.distributed as dist
    torch.set_num_threads(1)
    params = weights.make(nets.param_spec(cfgj), seed, torch.device("cpu"))
    model, outs, moved = _step(rank, world, cfgj, t, seed, params, True)
    got = {"grads": {n: p.grad.clone() for n, p in model.named_parameters()},
           "after": {n: p.detach().clone()
                     for n, p in model.named_parameters()},
           "moved": moved,
           "exchanged": sum(p.numel() for p in model.parameters())
           + sum(b.numel() for n, b in model.named_buffers()
                 if n.endswith(("running_mean", "running_var")))}
    alone, _, moved = _step(rank, world, cfgj, t, seed, params, False)
    got["alone"] = {"grads": {n: p.grad.clone()
                              for n, p in alone.named_parameters()},
                    "after": {n: p.detach().clone()
                              for n, p in alone.named_parameters()},
                    "moved": moved}
    every = [None] * world if rank == 0 else None
    dist.gather_object(outs, every, dst=0)
    if rank:
        return None
    got["outs"] = [o for r in every for o in r]     # rank by rank
    return _as(got, lambda v: v.numpy())     # tensors do not cross the pipe


def _as(tree, leaf):
    if isinstance(tree, dict):
        return {k: _as(v, leaf) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as(v, leaf) for v in tree]
    return leaf(tree) if hasattr(tree, "shape") else tree


@pytest.fixture(scope="module")
def stepped():
    cfgj, t = _tiny()
    got = _as(mesh.run_ranks(_rank, WORLD, "gloo", (cfgj, t, SEED),
                             timeout_s=JOIN_TIMEOUT_S), torch.from_numpy)
    device = torch.device("cpu")
    params = weights.make(nets.param_spec(cfgj), SEED, device)
    raws = loop.global_raws(cfgj, t, WORLD, SEED, 1, device)
    props = [(o["proposals"].float(), o["proposal_valid"])
             for o in got["outs"]]
    _, _, grads, after, _ = train_ref.follow(
        cfgj, params, raws, [loop.step_seed(SEED, 0)], device, 1,
        props_of=lambda i: props,
        plan_of=lambda i: loop.step_plan(cfgj, WORLD, SEED, i))
    ref = {"grads": grads,
           "update": {k: after[k] - params[k] for k in grads}}
    return cfgj, params, got, ref


def _rel(prog, ref):
    """||prog - ref|| / ||ref|| over every leaf the reference has."""
    num = sum(float((prog[k].double() - ref[k].double()).square().sum())
              for k in ref)
    den = sum(float(ref[k].double().square().sum()) for k in ref)
    return (num / den) ** 0.5


def _gaps(got, params, ref):
    update = {k: got["after"][k] - params[k] for k in ref["grads"]}
    return _rel(got["grads"], ref["grads"]), _rel(update, ref["update"])


def test_plan_is_four_ranks_of_two_microbatches(stepped):
    cfgj, _, got, _ = stepped
    plan = loop.step_plan(cfgj, WORLD, SEED, 0)
    assert plan.micro == 2 and len(plan.rpn_seeds) == WORLD
    assert len(got["outs"]) == WORLD * cfgj["train"]["grad_accum_steps"]


def test_gradients_and_update_match_the_reference(stepped):
    _, params, got, ref = stepped
    assert set(got["grads"]) == set(ref["grads"])
    grad, update = _gaps(got, params, ref)
    assert grad < GRAD_TOL and update < UPDATE_TOL, (grad, update)


def test_skipped_exchange_falls_outside_the_tolerances(stepped):
    _, params, got, ref = stepped
    grad, update = _gaps(got["alone"], params, ref)
    assert grad > 1e3 * GRAD_TOL and update > 1e3 * UPDATE_TOL, (grad,
                                                                  update)
    assert got["alone"]["moved"][:2] == (0, 0)


def test_one_all_reduce_a_dtype_a_step(stepped):
    """Every tensor exchanged is float32 (parameters, running statistics
    and the metrics): one all-reduce a step for two microbatches,
    carrying each of them once."""
    cfgj, _, got, _ = stepped
    assert cfgj["train"]["grad_accum_steps"] == 2
    calls, elements, metrics = got["moved"]
    assert calls == 1
    assert elements == got["exchanged"] + metrics

