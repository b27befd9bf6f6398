"""Serving in bulk: one client in a closed loop, a batch at a time.

Set-up makes the seeded weights and a pool of distinct uint8 batches
(``reference.synthetic`` on the card, then pinned host memory), builds
the program's model and ``build_eval_fn``, and warms up the one batch
shape. Each batch then leaves pinned host memory, goes through the
program's ``preprocess_for_eval`` and ``build_eval_fn``, and its
detections are copied back to pinned host memory; the batch is timed
from before the copy to the card until they are there.

The window runs batches back to back until the first one that ends at or
after ``--seconds``: its length is that end. ``detect_images_per_s`` is
every image of every batch over it, ``detect_batch_p95_ms`` the 95th
percentile of every batch's time.

Traffic parameters (``traffic/<mix>.json``): ``batch`` and
``pool_batches``. The reference judges ``CHECKED_BATCHES`` batches drawn
from the seed among those a window of ``--seconds`` completes at
``CHECKED_PER_S`` (a rate below every cell's; a drawn batch the window
does not reach is not judged).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import program, spans as spans_lib, trace, weights
from benchmark.reference import nets, roofline, serve_check, synthetic
from benchmark.reference.precision import fp32_exact

SEED_POOL, SEED_SAMPLE = 1, 2     # streams drawn from --seed
WARMUP_BATCHES = 3
TRACED_BATCHES = 50               # the profiled window of a --trace 1 run
CHECKED_BATCHES, CHECKED_PER_S = 3, 10


def make_pool(seed: int, n: int, batch: int, size: int, device):
    """``n`` batches of uint8 images in pinned host memory."""
    gen = torch.Generator(device=device).manual_seed(
        (seed * 7919 + SEED_POOL) % (1 << 63))
    pool = torch.empty((n, batch, size, size, 3), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    for i in range(n):
        pool[i].copy_(synthetic.images_u8(gen, batch, size))
    return pool


def run(cell, seed: int, seconds: float, traced: bool, device,
        started: float) -> dict:
    from x_detector_tpu_torch.data.augment import preprocess_for_eval
    cfgj, t = cell.config, cell.traffic
    batch, size = t["batch"], cfgj["image_size"]
    phases = [("start", started), ("imports", time.perf_counter())]
    params = weights.make(nets.param_spec(cfgj), seed, device)
    phases.append(("weights", time.perf_counter()))
    cfg, model, detect = program.build_serving(cfgj, params, device)
    phases.append(("program", time.perf_counter()))
    pool = make_pool(seed, t["pool_batches"], batch, size, device)
    phases.append(("pool", time.perf_counter()))
    pinned = device.type == "cuda"
    k = cfg.model.nms.max_output
    host = [torch.empty(s, dtype=d, pin_memory=pinned) for s, d in (
        ((batch, k, 4), torch.float32), ((batch, k), torch.float32),
        ((batch, k), torch.int32), ((batch, k), torch.bool))]
    sync = (torch.cuda.current_stream(device).synchronize if pinned
            else (lambda: None))

    captured: Dict[int, tuple] = {}
    want = {"now": None}

    def keep_outputs(_module, _inputs, out):
        if want["now"] is not None:
            captured[want["now"]] = (_clone(out), None)

    hook = model.register_forward_hook(keep_outputs)

    def one(i: int) -> None:
        x = pool[i % len(pool)].to(device, non_blocking=True)
        dets = detect(preprocess_for_eval(x, cfg.data))
        for h, d in zip(host, dets):
            h.copy_(d, non_blocking=True)
        sync()

    for i in range(WARMUP_BATCHES):
        one(i)
    rng = np.random.default_rng([seed, SEED_SAMPLE])
    span = max(CHECKED_BATCHES, int(seconds * CHECKED_PER_S))
    checked = sorted(rng.choice(span, CHECKED_BATCHES,
                                replace=False).tolist())
    lat: List[float] = []
    phases.append(("warmup", time.perf_counter()))
    setup_s = time.perf_counter() - started
    t_start = time.perf_counter()
    n = 0
    while True:
        want["now"] = n if n in checked else None
        t0 = time.perf_counter()
        one(n)
        t1 = time.perf_counter()
        if want["now"] is not None:
            captured[n] = (captured[n][0], [h.clone() for h in host])
        lat.append(t1 - t0)
        n += 1
        if t1 - t_start >= seconds:
            break
    want["now"] = None
    window_s = t1 - t_start
    images_per_s = n * batch / window_s
    e2e = {"setup_s": setup_s, "detect_images_per_s": images_per_s,
           "detect_batch_p95_ms": float(np.percentile(lat, 95)) * 1e3}
    result = {"attempted": n * batch, "failed": 0, "setup": phases,
              "metrics": e2e}

    if traced:
        info = {"images_per_s": images_per_s,
                "flop_per_image": roofline.count_flops(
                    cfgj, 1, cfgj.get("proposals", {}).get(
                        "post_nms_topk_eval", 0), train=False)}
        if cfg.model.backbone_fused_sepconv:
            info["b2_bound_ms_per_unit"] = roofline.sepconv_bound_ms(cfgj,
                                                                     batch)
        sp = spans_lib.Spans(model, cfgj.get("spans", {}))

        def unit(i: int) -> None:
            with torch.profiler.record_function("bench/batch"):
                one(n + i)

        result["window"] = trace.traced(unit, TRACED_BATCHES, info,
                                        counters=program.kernel_launches)
        sp.remove()
    hook.remove()
    if pinned:
        result["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    del model, detect
    gc.collect()
    if pinned:
        torch.cuda.empty_cache()
    result["numbers"] = judge(cfgj, params, pool, captured, device)
    return result


def judge(cfgj: dict, params, pool, captured: dict, device) -> dict:
    """The reference's numbers over the captured batches (float32, no
    TF32)."""
    fp32_exact()
    per_batch = []
    for i, (out, dets) in sorted(captured.items()):
        if dets is None:
            continue
        images = pool[i % len(pool)].to(device)
        per_batch.append(serve_check.batch_numbers(cfgj, params, images, out,
                                                   dets))
    if not per_batch:
        raise RuntimeError("no checked batch finished in the window")
    return serve_check.merge(per_batch)


def _clone(out):
    if isinstance(out, dict):
        return {k: v.detach().clone() for k, v in out.items()}
    return tuple(v.detach().clone() for v in out)
