"""Where a train step spends its time on one CUDA card.

    python -m x_detector_tpu_torch.train.profile_step [--preset NAME]

The preset (``PATHS``) sets the model and the batch: config 4 by default
(``lighthead_xception(800)`` training at batch 16 with no warmup);
``ssd_resnet50`` is config 2 (batch 8, 512 px, with its EMA shadow) and
``xdet_xception`` the X-Det variant (batch 8, 512 px, trained unfused);
``config5`` is config 5 on this card (``config.config5()``: config 4's
model in the data-parallel step at world 1 over an NCCL group, a global
batch of 128 in 16 microbatches of 8), its flattened all-reduce a stage.
Synthetic batches are made on the card on canvases 1.2 times the input
size. After two warm-up steps the script prints the card's name and power
limit (``nvidia-smi``), then:

  1. six host-clock step times, one synchronize per step, and peak memory;
  2. each stage's wall time, with a synchronize at every stage edge;
  3. from ``torch.profiler`` over two such staged steps: each stage's kernel
     time, the device's idle share inside it and its largest kernel
     families;
  4. from ``torch.profiler`` over two whole steps without stage edges: the
     device's idle share of the window and the share of PSROIAlign's
     forward and backward kernels (B1).

Every number is per step. The Chrome traces are written to ``build/``
(git-ignored) under the working directory.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import subprocess
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from x_detector_tpu_torch.config import PRESETS, config5

STAGE = "stage:"
# Kernel families by substrings of the kernel's name, first match wins.
FAMILIES = (
    ("psroi", ("psroi",)),
    ("fused sepconv", ("sepconv",)),
    ("int8", ("int8_conv_kernel", "int8_conv_tma_kernel",
              "int8_dwconv_kernel", "quantize_s8")),
    ("conv", ("conv", "xmma", "cudnn", "cutlass", "implicit", "sm90_",
              "nhwc", "dgrad", "wgrad")),
    ("gemm", ("gemm",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("reduce", ("reduce",)),
    ("sort/topk", ("sort", "topk", "radix")),
)
FORWARD_PARTS = ("backbone", "rpn", "thin_map", "roi_head")
TIMED_STEPS = 6
OUT_DIR = pathlib.Path("build")


def _preset(name: str, size: int, batch: int):
    def build():
        cfg = PRESETS[name](size)
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=batch, warmup_steps=0))
    return build


# profiled path -> its config (no warmup); "config5" runs the DP step
PATHS = {"lighthead_xception": _preset("lighthead_xception", 800, 16),
         "ssd_resnet50": _preset("ssd_resnet50", 512, 8),
         "xdet_xception": _preset("xdet_xception", 512, 8),
         "config5": config5}


def family(kernel_name: str) -> str:
    low = kernel_name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by the (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def device_events(trace: List[dict]) -> List[dict]:
    return [e for e in trace if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]


def stage_breakdown(trace: List[dict]) -> Dict[str, dict]:
    """Per stage range (``record_function("stage:<name>")``): its own time
    (children's ranges taken out), the union of the device work whose
    midpoint falls in it and in none of its children, and that work's
    kernel time by family, all in microseconds."""
    ranges = [e for e in trace if e.get("ph") == "X" and e.get("cat") ==
              "user_annotation" and str(e.get("name", "")).startswith(STAGE)]
    inside = lambda c, r: c is not r and r["ts"] <= c["ts"] and (
        c["ts"] + c["dur"] <= r["ts"] + r["dur"])
    out: Dict[str, dict] = {}
    for r in ranges:
        kids = [c for c in ranges if inside(c, r)]
        own = r["dur"] - sum(c["dur"] for c in kids if not any(
            inside(c, k) for k in kids))
        row = out.setdefault(r["name"][len(STAGE):],
                             {"own": 0.0, "spans": [], "families": {}})
        row["own"] += own
    for ev in device_events(trace):
        mid = ev["ts"] + ev["dur"] / 2
        inner = [r for r in ranges if r["ts"] <= mid <= r["ts"] + r["dur"]]
        if not inner:
            continue
        row = out[min(inner, key=lambda r: r["dur"])["name"][len(STAGE):]]
        row["spans"].append((ev["ts"], ev["ts"] + ev["dur"]))
        if ev["cat"] == "kernel":
            fam = family(ev["name"])
            row["families"][fam] = row["families"].get(fam, 0.0) + ev["dur"]
    for row in out.values():
        row["busy"] = union_length(row.pop("spans"))
    return out


def forward_parts(model) -> Optional[Dict[str, str]]:
    """The SSD model's stages by submodule (None: the Light-Head's)."""
    from x_detector_tpu_torch.models.ssd import SSDModel
    if not isinstance(model, SSDModel):
        return None
    parts = {"backbone": "forward backbone", "head": "forward head"}
    for name, _ in model.named_children():
        if name.startswith("extra"):
            parts[name] = "forward extras"
        elif name.startswith(("lateral", "fuse")):
            parts[name] = "forward fusion"
    return parts


@contextlib.contextmanager
def staged(model, names: Dict[str, float],
           parts: Optional[Dict[str, str]] = None):
    """Wrap the forward's parts (``parts``: submodule name -> stage name,
    by default the Light-Head's ``FORWARD_PARTS``) and the Light-Head's
    proposal and PSROIAlign calls so each runs between two synchronizes
    inside a ``stage:`` range, adding its wall ms to ``names``; undone on
    exit."""
    from x_detector_tpu_torch.models import lighthead

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.record_function(STAGE + name):
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            names[name] = names.get(name, 0.0) + (
                time.perf_counter() - t0) * 1e3
            return out
        return run

    if parts is None:
        parts = {part: "forward " + part for part in FORWARD_PARTS}
    saved = (lighthead.generate_proposals, lighthead.batched_psroi_align)
    for part, name in parts.items():
        sub = getattr(model, part)
        sub.forward = timed(name, sub.forward)
    lighthead.generate_proposals = timed("proposals + NMS", saved[0])
    lighthead.batched_psroi_align = timed("psroi_align forward", saved[1])
    try:
        yield timed
    finally:
        for part in parts:
            del getattr(model, part).forward
        lighthead.generate_proposals, lighthead.batched_psroi_align = saved


def main(argv=None) -> None:
    from x_detector_tpu_torch.data.augment import preprocess_batch_for_train
    from x_detector_tpu_torch.data.synthetic import synthetic_batch_device
    from x_detector_tpu_torch.train import losses as loss_lib
    from x_detector_tpu_torch.train.trainer import (create_model_and_state,
                                                    make_grad_fn,
                                                    make_loss_fn,
                                                    make_train_step)
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--preset", choices=sorted(PATHS),
                        default="lighthead_xception")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    cfg = PATHS[args.preset]()
    size, batch_size = cfg.model.image_size, cfg.train.batch_size
    accum = cfg.train.grad_accum_steps
    canvas = int(size * 1.2)
    state = create_model_and_state(cfg, dev, seed=0)
    model = state.model
    sync = None
    if args.preset == "config5":
        from x_detector_tpu_torch.parallel import mesh
        from x_detector_tpu_torch.parallel.data_parallel import make_sync
        mesh.init_group("nccl")
        sync = make_sync(model)
    step = make_train_step(model, cfg, sync=sync)
    loss_fn = make_loss_fn(model, cfg)
    lighthead = cfg.model.family == "lighthead"
    optimizer_stage = ("optimizer" if state.ema_params is None
                       else "optimizer + EMA")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"{args.preset} training at {size} px, batch {batch_size} in "
          f"{accum} microbatch(es){' (DP step, world 1)' if sync else ''}, "
          f"from {canvas} px canvases", flush=True)

    def new_batch():
        raw = synthetic_batch_device(gen, batch_size, canvas,
                                     cfg.data.max_gt_boxes)
        return preprocess_batch_for_train(gen, raw, cfg.data)

    for _ in range(2):
        step(state, new_batch(), gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        step(state, new_batch(), gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    mean = sum(times) / len(times)
    print(f"1. step ms {[round(t, 2) for t in times]}, mean {mean:.2f} = "
          f"{batch_size * 1e3 / mean:.1f} images/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    def staged_steps(n, wall):
        # make_train_step's body, stage by stage: "backward" is grad_fn's
        # own time, the backward and the accumulation's bookkeeping
        with staged(model, wall, forward_parts(model)) as timed:
            grad_fn = make_grad_fn(model, timed("targets + losses", loss_fn),
                                   accum)
            for _ in range(n):
                raw = timed("data", synthetic_batch_device)(
                    gen, batch_size, canvas, cfg.data.max_gt_boxes)
                batch = timed("augment", preprocess_batch_for_train)(
                    gen, raw, cfg.data)
                draws = loss_lib.draw_rpn_priorities(
                    gen, batch_size, model.anchors.shape[0]) if (
                    lighthead) else None
                metrics = timed("backward", grad_fn)(batch, draws)
                if sync is not None:
                    timed("all-reduce", sync)(metrics)
                timed(optimizer_stage, state.apply_gradients)()

    n = 2
    wall: Dict[str, float] = {}
    staged_steps(n, wall)
    wall["backward"] -= wall["targets + losses"]
    wall["targets + losses"] -= sum(
        v for k, v in wall.items() if k.startswith("forward ")
        or k in ("proposals + NMS", "psroi_align forward"))
    print("2. stage wall ms, synchronized edges: " + json.dumps(
        {k: round(v / n, 2) for k, v in sorted(
            wall.items(), key=lambda kv: -kv[1])})
        + f"; sum {sum(wall.values()) / n:.2f}", flush=True)

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        staged_steps(n, {})
    path = OUT_DIR / "train_stages_trace.json"
    prof.export_chrome_trace(str(path))
    rows = stage_breakdown(json.loads(path.read_text())["traceEvents"])
    if not any(r["busy"] for r in rows.values()):
        raise SystemExit("the profiler recorded no device work")
    print("3. per stage, profiled: kernel ms, idle share, families (ms)")
    for name, row in sorted(rows.items(), key=lambda kv: -kv[1]["own"]):
        fams = {f: round(us / n / 1e3, 2) for f, us in sorted(
            row["families"].items(), key=lambda kv: -kv[1])}
        print(f"   {name:22s} {sum(row['families'].values()) / n / 1e3:8.2f}"
              f" {1 - row['busy'] / row['own'] if row['own'] else 0:7.3f}  "
              f"{json.dumps(fams)}", flush=True)

    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(n):
            with torch.profiler.record_function("train_step"):
                step(state, new_batch(), gen)
                torch.cuda.synchronize()
    path = OUT_DIR / "train_steps_trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())["traceEvents"]
    marks = [e for e in trace if e.get("ph") == "X" and e.get("cat") ==
             "user_annotation" and e.get("name") == "train_step"]
    w0 = min(e["ts"] for e in marks)
    w1 = max(e["ts"] + e["dur"] for e in marks)
    dev_ev = device_events(trace)
    busy = union_length((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                        for e in dev_ev if e["ts"] + e["dur"] > w0
                        and e["ts"] < w1)
    kernels = [e for e in dev_ev if e["cat"] == "kernel"]
    k_total = sum(e["dur"] for e in kernels)
    b1 = sum(e["dur"] for e in kernels if family(e["name"]) == "psroi")
    print(f"4. whole steps, profiled: window {(w1 - w0) / n / 1e3:.2f} ms, "
          f"device busy {busy / n / 1e3:.2f} ms, idle share "
          f"{1 - busy / (w1 - w0):.4f}; kernels {k_total / n / 1e3:.2f} ms,"
          f" of which B1 forward + backward {b1 / n / 1e3:.3f} ms "
          f"({100 * b1 / k_total:.2f}% of kernel time)", flush=True)
    if sync is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
