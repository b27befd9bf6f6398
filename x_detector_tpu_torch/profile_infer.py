"""Where an inference batch spends its time on one CUDA card.

    python -m x_detector_tpu_torch.profile_infer [--preset NAME]
        [--backbone-quant int8]

The preset (``PATHS``) sets the model, the batch and the raw images: config
3 by default (``lighthead_xception(800)`` with ``backbone_fused_sepconv``,
batch 16, canvas-size images); ``lighthead_resnet50`` is config 1 (batch
1, 375 x 500 images resized to 800 px); ``ssd_resnet50`` config 2 and
``xdet_xception`` (fused) the SSD family at 512 px, batch 8. Seeded weights
(flax's default initialisation) and seeded uint8 images go through
``preprocess_for_eval`` and ``build_eval_fn``; with ``--backbone-quant
int8`` the backbone is int8, calibrated first over two seeded batches
(``quant.calibrate_backbone``; B2 then never runs, the int8 kernels are
the family "int8"). After two warm-up batches
the script prints the card's name and power limit (``nvidia-smi``), then:

  1. six host-clock batch times, one synchronize per batch, and peak
     memory;
  2. each stage's wall time, with a synchronize at every stage edge;
  3. from ``torch.profiler`` over two such staged batches: each stage's
     kernel time, the device's idle share inside it and its largest kernel
     families (kernel B2 is the family "fused sepconv");
  4. from ``torch.profiler`` over two whole batches without stage edges:
     the device's idle share of the window and the shares of kernels B2
     and B1.

Every number is per batch. The Chrome traces are written to ``build/``
(git-ignored) under the working directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, Iterable, Optional

import torch

from x_detector_tpu_torch.train.profile_step import (OUT_DIR, device_events,
                                                     family, forward_parts,
                                                     stage_breakdown, staged,
                                                     union_length)
from x_detector_tpu_torch.utils.profiling import card_label

TIMED_BATCHES = 6
# preset -> (batch, raw image (H, W) or None for the canvas, fused B2)
PATHS = {"lighthead_xception": (16, None, True),
         "lighthead_resnet50": (1, (375, 500), False),
         "ssd_resnet50": (8, None, False),
         "xdet_xception": (8, None, True)}


def path_config(preset: str, backbone_quant: Optional[str] = None,
                image_size: Optional[int] = None):
    """A profiled path's config: the preset (at ``image_size`` if given)
    with its backbone's separable blocks on B2 where ``PATHS`` says so (the
    Xception-lite presets, as config 3 serves) and ``backbone_quant``."""
    from x_detector_tpu_torch.config import PRESETS
    cfg = (PRESETS[preset](image_size) if image_size
           else PRESETS[preset]())
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_fused_sepconv=PATHS[preset][2],
        backbone_quant=backbone_quant))


def build_path(cfg, device, calib: Iterable[torch.Tensor] = (),
               dtype: torch.dtype = torch.bfloat16):
    """(model, ``build_eval_fn``) of ``cfg`` on ``device``: seeded weights
    (flax's default initialisation), and with ``backbone_quant`` the
    backbone calibrated over ``calib`` (eval-preprocessed batches,
    ``quant.calibrate_backbone``) before the eval function prepares it."""
    from x_detector_tpu_torch.inference import build_eval_fn, build_model
    model = build_model(cfg.model, device, seed=0, dtype=dtype)
    if cfg.model.backbone_quant:
        from x_detector_tpu_torch import quant
        quant.calibrate_backbone(cfg, model, calib)
    return model, build_eval_fn(model, cfg, device)


def main(argv=None) -> None:
    from x_detector_tpu_torch.data.augment import preprocess_for_eval
    from x_detector_tpu_torch.inference import postprocess
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--preset", choices=sorted(PATHS),
                        default="lighthead_xception")
    parser.add_argument("--backbone-quant", choices=["int8"], default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_infer needs a CUDA card")
    print(card_label(), flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    batch, raw_hw, _ = PATHS[args.preset]
    cfg = path_config(args.preset, args.backbone_quant)
    gen = torch.Generator(device=dev).manual_seed(0)
    size = cfg.model.image_size
    h, w = raw_hw or (size, size)
    print(f"{args.preset} at {size} px, batch {batch}, from {h} x {w} uint8 "
          f"images, backbone {args.backbone_quant or 'float'}", flush=True)

    def images():
        return torch.randint(0, 256, (batch, h, w, 3), generator=gen,
                             dtype=torch.uint8, device=dev)

    model, detect = build_path(cfg, dev, [
        preprocess_for_eval(images(), cfg.data) for _ in range(
            2 if args.backbone_quant else 0)])

    for _ in range(2):
        detect(preprocess_for_eval(images(), cfg.data))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TIMED_BATCHES):
        u8 = images()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        detect(preprocess_for_eval(u8, cfg.data))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    mean = sum(times) / len(times)
    print(f"1. batch ms {[round(t, 2) for t in times]}, mean {mean:.2f} = "
          f"{batch * 1e3 / mean:.1f} images/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    def staged_batches(n, wall):
        with staged(model, wall, forward_parts(model)) as timed, \
                torch.inference_mode():
            for _ in range(n):
                u8 = images()
                x = timed("preprocess", preprocess_for_eval)(u8, cfg.data)
                out = model(x)
                timed("postprocess + NMS", postprocess)(model, out,
                                                        cfg.model)

    n = 2
    wall: Dict[str, float] = {}
    staged_batches(n, wall)
    print("2. stage wall ms, synchronized edges: " + json.dumps(
        {k: round(v / n, 2) for k, v in sorted(
            wall.items(), key=lambda kv: -kv[1])})
        + f"; sum {sum(wall.values()) / n:.2f}", flush=True)

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        staged_batches(n, {})
    path = OUT_DIR / "infer_stages_trace.json"
    prof.export_chrome_trace(str(path))
    rows = stage_breakdown(json.loads(path.read_text())["traceEvents"])
    if not any(r["busy"] for r in rows.values()):
        raise SystemExit("the profiler recorded no device work")
    print("3. per stage, profiled: kernel ms, idle share, families (ms)")
    for name, row in sorted(rows.items(), key=lambda kv: -kv[1]["own"]):
        fams = {f: round(us / n / 1e3, 3) for f, us in sorted(
            row["families"].items(), key=lambda kv: -kv[1])}
        print(f"   {name:22s} {sum(row['families'].values()) / n / 1e3:8.3f}"
              f" {1 - row['busy'] / row['own'] if row['own'] else 0:7.3f}  "
              f"{json.dumps(fams)}", flush=True)

    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(n):
            u8 = images()
            with torch.profiler.record_function("batch"):
                detect(preprocess_for_eval(u8, cfg.data))
                torch.cuda.synchronize()
    path = OUT_DIR / "infer_batches_trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())["traceEvents"]
    marks = [e for e in trace if e.get("ph") == "X" and e.get("cat") ==
             "user_annotation" and e.get("name") == "batch"]
    w0 = min(e["ts"] for e in marks)
    w1 = max(e["ts"] + e["dur"] for e in marks)
    dev_ev = [e for e in device_events(trace)
              if e["ts"] + e["dur"] > w0 and e["ts"] < w1]
    busy = union_length((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                        for e in dev_ev)
    kernels = [e for e in dev_ev if e["cat"] == "kernel"]
    k_total = sum(e["dur"] for e in kernels)
    share = {fam: sum(e["dur"] for e in kernels if family(e["name"]) == fam)
             for fam in ("fused sepconv", "psroi", "int8")}
    print(f"4. whole batches, profiled: window {(w1 - w0) / n / 1e3:.2f} ms, "
          f"device busy {busy / n / 1e3:.2f} ms, idle share "
          f"{1 - busy / (w1 - w0):.4f}; kernels {k_total / n / 1e3:.2f} ms, "
          f"of which B2 {share['fused sepconv'] / n / 1e3:.3f} ms "
          f"({100 * share['fused sepconv'] / k_total:.2f}%), B1 "
          f"{share['psroi'] / n / 1e3:.3f} ms, int8 (K1-K3) "
          f"{share['int8'] / n / 1e3:.3f} ms", flush=True)


if __name__ == "__main__":
    main()
