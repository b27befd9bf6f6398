"""What decides ``correct`` in a training cell: the program's first steps
followed by the plain reference.

The harness keeps, from the program's train state as the window gets it,
each checked step's loss, SGD's momentum trace after the first step (the
gradient as the optimizer takes it, weight decay included), the
parameters after the last, and each step's RPN outputs and proposals (a
forward hook). The reference then runs the same steps in float32 from the
same weights, batches and draws:

* ``loss_gap``: the largest |program - reference| / |reference| of a
  step's loss;
* ``grad_gap``: over the leaves, the largest gap between the norms of the
  program's and the reference's first gradient, over the larger of the
  reference leaf's norm and the median leaf's;
* ``update_gap``: the same for the parameters' change over the steps;
* ``rpn_rel``: the first forward's RPN logits and box codes against the
  reference's (relative L2 error, the worse of the two): the network's
  precision, which the gradients' norms carry only in part;
* ``proposals_off``: the share of the first step's proposal slots that
  the reference's proposal stage (training budgets), run on the program's
  RPN outputs, places otherwise.

The limits compare ``rpn_rel``, the median leaf's gaps and
``proposals_off``. The worst leaf's gaps are printed, not compared: on
the card the program's bfloat16 moves single leaves of the stem and
stage 2 (BatchNorm affines, small kernels) by 0.1-0.65 on every seed,
and the reference computed with bfloat16 operands and gradients does the
same; no fault reads far enough above that to bound them.

The proposal stage is discrete, so the reference's RoI targets and
pooling take the program's proposals (``proposals_off`` checks that
stage by itself). Leaves whose reference gradient is under a thousandth of
the median leaf's (a gradient nought to rounding) are left out of
``grad_gap`` and ``update_gap``.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List

import torch

from benchmark.reference import post, serve_check, train_ref
from benchmark.reference.nets import identity
from benchmark.reference.precision import fp32_exact

ZERO_GRAD = 1e-3      # of the median leaf's gradient norm


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep) -> Dict[str, float]:
    """Each kept leaf's | |p| - |r| | / max(|r|, median |r|); a leaf the
    program did not produce reads a norm of 0."""
    pn = {k: float(prog[k].double().norm()) if k in prog else 0.0
          for k in keep}
    rn = {k: float(ref[k].double().norm()) for k in keep}
    med = float(torch.tensor(sorted(rn.values())).median())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keep}


def _worst_and_median(name: str, gaps: Dict[str, float], got: dict) -> None:
    got[name] = max(gaps.values())
    got[name + "_median"] = float(torch.tensor(sorted(gaps.values()))
                                  .median())
    worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
    print(f"{name}: worst leaves " + ", ".join(
        f"{k} {gaps[k]:.4g}" for k in worst), file=sys.stderr)


def leaves_kept(raw_grads: Dict[str, torch.Tensor]) -> List[str]:
    norms = {k: float(g.double().norm()) for k, g in raw_grads.items()}
    med = float(torch.tensor(sorted(norms.values())).median())
    return sorted(k for k, v in norms.items() if v >= ZERO_GRAD * med)


def numbers(cfg: dict, params, raws, seeds, device, losses, first, after,
            outs, plan_of: Callable = lambda i: train_ref.StepPlan()
            ) -> Dict[str, float]:
    """The program's checked steps judged by the reference's. ``outs``
    holds every forward's outputs in step order (one a microbatch, in the
    global batch's order)."""
    fp32_exact()
    steps = len(losses)
    props = [(o["proposals"].float(), o["proposal_valid"]) for o in outs]
    per = len(props) // steps
    r_losses, r_first, r_grads, r_after, stages = train_ref.follow(
        cfg, params, raws, seeds, device, steps,
        props_of=lambda i: props[i * per:(i + 1) * per], plan_of=plan_of)
    keep = leaves_kept(r_grads)
    got = {"loss_gap": max(abs(p - r) / max(abs(r), 1e-30)
                           for p, r in zip(losses, r_losses))}
    _worst_and_median("grad_gap", leaf_gaps(first, r_first, keep), got)
    _worst_and_median("update_gap", leaf_gaps(
        {k: after[k] - params[k] for k in keep},
        {k: r_after[k] - params[k] for k in keep}, keep), got)
    rc, rl = stages[0][:2]
    got["rpn_rel"] = max(serve_check.rel(outs[0]["rpn_cls"], rc),
                         serve_check.rel(outs[0]["rpn_loc"], rl))
    del stages
    anchors = torch.from_numpy(post.rpn_anchors(
        cfg["image_size"], cfg["anchors"])).to(device)
    with torch.no_grad():
        pb, _, pv = post.proposals(outs[0]["rpn_cls"].float(),
                                   outs[0]["rpn_loc"].float(), anchors, cfg,
                                   training=True)
    off, total = serve_check.boxes_off(outs[0]["proposals"],
                                       outs[0]["proposal_valid"], pb, pv)
    got["proposals_off"] = off / total
    return got


def control_state(cfg: dict, params, raws, seeds, device, steps: int,
                  cast: Callable = identity, fault: str = "", low=None,
                  plan_of: Callable = lambda i: train_ref.StepPlan()):
    """What a program in the reference's place would hand the check:
    (losses, first trace, parameters after, outputs) of the reference with
    ``cast`` on every product and its proposal stage in ``low`` (the
    control), or with a ``fault``: "half_batch", each loss the mean over
    the first half of its microbatch only; "no_exchange", the gradient of
    the first rank's microbatches only (``ranks`` of them share a step)."""
    fp32_exact()

    def faulty(i):
        plan = plan_of(i)
        b = raws[i]["image"].shape[0]
        micro = plan.micro or b
        if fault == "half_batch":
            return plan._replace(rows=micro // 2)
        if fault == "no_exchange":
            ranks = len(plan.rpn_seeds)
            return plan._replace(only=b // micro // ranks)
        return plan

    losses, first, _, after, stages = train_ref.follow(
        cfg, params, raws, seeds, device, steps, cast, plan_of=faulty,
        low=low)
    outs = [{"rpn_cls": rc, "rpn_loc": rl, "proposals": pb,
             "proposal_valid": pv} for rc, rl, pb, pv in stages]
    return losses, first, after, outs
