"""The control of a cell's comparison: the reference put in the program's
place one precision below the configuration's (products in fp8, float32
stages in bfloat16), judged by the same numbers and limits as the
program. In a training cell also faults planted in the reference put in
the program's place: each step's loss taken over half of its batch
(``half_batch``) and, over several cards, the exchange between them left
out (``no_exchange``: the first card's microbatches alone make the
step). (A state the steps leave unchanged reads ``update_gap`` 1 by its
measure, with no run.)
Every seed's numbers are printed as a JSON line; a sound comparison reads
``correct`` false for each.

    python3 benchmark/control.py --workload lhx_serve_b16 --seeds 1,2,3

With ``--witness`` it runs, instead, the reference with the program's
precision (bfloat16 operands and gradients at every product, float32
elsewhere) in the program's place: a second witness of what gaps bfloat16
alone makes, and on which leaves (printed on standard error).

It runs the cell's own sizes on the card; ``control_numbers`` is what the
CPU tests call at a small size.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import core, spec, weights  # noqa: E402
from benchmark.loops import serve, train  # noqa: E402
from benchmark.reference import nets, serve_check, train_check  # noqa: E402
from benchmark.reference.precision import (  # noqa: E402
    bf16, fp8, fp32_exact)


def control_numbers(cell, seed: int, device, witness: bool = False) -> dict:
    """{"control": its numbers, and in a training cell the faults'} on
    what a run of ``seed`` would check; with ``witness``,
    {"bf16_witness": its numbers}."""
    fp32_exact()
    cfgj, t = cell.config, cell.traffic
    params = weights.make(nets.param_spec(cfgj), seed, device)
    if t["loop"] == "train":
        steps, world = train.CHECKED_STEPS, cell.chips
        raws = train.global_raws(cfgj, t, world, seed, steps, device)
        seeds = [train.step_seed(seed, i) for i in range(steps)]

        def plan_of(i):
            return train.step_plan(cfgj, world, seed, i)

        out = {}
        faults = [("control", {"cast": fp8, "low": torch.bfloat16}),
                  ("half_batch", {"fault": "half_batch"})]
        if witness:
            faults = [("bf16_witness", {"cast": bf16})]
        elif world > 1:
            faults.append(("no_exchange", {"fault": "no_exchange"}))
        for name, kw in faults:
            state = train_check.control_state(cfgj, params, raws, seeds,
                                              device, steps, plan_of=plan_of,
                                              **kw)
            out[name] = train_check.numbers(cfgj, params, raws, seeds,
                                            device, *state, plan_of=plan_of)
        return out
    pool = serve.make_pool(seed, t["pool_batches"], t["batch"],
                           cfgj["image_size"], device)
    per_batch = []
    for i in range(serve.CHECKED_BATCHES):
        images = pool[i % len(pool)].to(device)
        out, dets = serve_check.control_outputs(
            cfgj, params, images, *((bf16, torch.float32) if witness else ()))
        per_batch.append(serve_check.batch_numbers(cfgj, params, images, out,
                                                   dets))
    return {"bf16_witness" if witness else "control":
            serve_check.merge(per_batch)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--witness", action="store_true")
    args = p.parse_args()
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        for name, numbers in control_numbers(cell, seed, device,
                                             args.witness).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              name: numbers,
                              "correct": core.verdict(numbers, cell.limits)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    np.seterr(all="ignore")
    sys.exit(main())
