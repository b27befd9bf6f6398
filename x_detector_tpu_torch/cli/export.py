"""Export a trained detector as a ``torch.export`` program (serving), or as
a shared-weights container of batch buckets.

The port of ``x_detector_tpu/cli/export.py``: the images -> (boxes, scores,
classes, valid) pipeline, NMS included, frozen into programs that a process
importing no model code reloads and runs (``serving.py``). Examples (on the
card, where the programs are traced and then serve)::

  python -m x_detector_tpu_torch.cli.export --preset lighthead_xception \\
      --model-dir DIR --output det.pt2 --batch 8 --raw-rgb
  python -m x_detector_tpu_torch.cli.export --preset lighthead_xception \\
      --model-dir DIR --output CONTAINER --container --raw-rgb \\
      --batches 1,4,8,16 [--bake-batches 1] [--quant int8]

Reload: ``serving.load(path)(images[, box_scale])`` or
``serving.load_container(CONTAINER).detect(images[, box_scale])``.

Inputs: with ``--raw-rgb`` raw [0, 255] RGB at the model's input size (the
eval preprocessing is inside); without it, eval-preprocessed (whitened)
images, what ``inference.build_eval_fn`` takes. A raw-RGB program of a
letterbox config (the Light-Head presets) also takes ``box_scale`` [B, 2]
(``serving.letterbox_batch``) and returns boxes in the original images'
normalized coordinates.

A program is traced on ``--device`` (``cuda`` by default) and stays pinned
to that device type. Its hand kernels are ``xdt::*`` operator nodes, which
launch the same kernels as eager inference, as often.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.utils._pytree as pytree
from torch import nn
from torch.overrides import TorchFunctionMode

from x_detector_tpu_torch import quant, serving
from x_detector_tpu_torch.cli import common
from x_detector_tpu_torch.data.augment import preprocess_for_eval
from x_detector_tpu_torch.data.synthetic import synthetic_batch_device
from x_detector_tpu_torch.inference import ServingModule
from x_detector_tpu_torch.models.layers import prepare_for_inference

CALIB_SEED = 10_000       # synthetic calibration batch i is seeded 10000 + i


class _Seen(TorchFunctionMode):
    """Records every tensor passed to an operation."""

    def __init__(self):
        super().__init__()
        self.ids = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ids.update(id(t) for t in pytree.tree_leaves((args, kwargs))
                        if isinstance(t, torch.Tensor))
        return func(*args, **kwargs)


def read_tensors(module: nn.Module, inputs: Sequence[torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """The parameters and buffers (non-persistent ones included) that
    ``module``'s forward reads, by name: one run of it on ``inputs``,
    recording the tensors every operation is given. A prepared model's
    fused and int8 blocks read their prepared operands, not the weights
    they came from."""
    with torch.no_grad(), _Seen() as seen:
        module(*inputs)
    named = dict(module.named_parameters())
    named.update(module.named_buffers())
    return {k: v.detach() for k, v in named.items() if id(v) in seen.ids}


class _SharedWeights(nn.Module):
    """``served`` with its tensors taken as the first input (a dict by
    name): the exported graph holds no weights."""

    def __init__(self, served: nn.Module):
        super().__init__()
        object.__setattr__(self, "served", served)   # not a submodule

    def forward(self, weights: Dict[str, torch.Tensor], *inputs):
        return torch.func.functional_call(self.served, weights, inputs)


class _BakedWeights(nn.Module):
    """``served`` holding only ``weights`` (what it reads) as its own
    buffers: the exported graph embeds exactly those."""

    def __init__(self, served: nn.Module, weights: Dict[str, torch.Tensor]):
        super().__init__()
        object.__setattr__(self, "served", served)
        self.names = list(weights)
        for i, t in enumerate(weights.values()):
            self.register_buffer(f"w{i}", t)

    def forward(self, *inputs):
        weights = {name: getattr(self, f"w{i}")
                   for i, name in enumerate(self.names)}
        return torch.func.functional_call(self.served, weights, inputs)


def example_inputs(module: ServingModule, batch: int, device
                   ) -> List[torch.Tensor]:
    """Inputs of the program's shapes: images [B, S, S, 3] float32 and,
    for a letterbox program, box_scale [B, 2]."""
    size = module.cfg.model.image_size
    inputs = [torch.zeros(batch, size, size, 3, device=device)]
    if module.letterbox:
        inputs.append(torch.ones(batch, 2, device=device))
    return inputs


def export_program(module: ServingModule, batch: int, device,
                   weights: Optional[Dict[str, torch.Tensor]] = None,
                   baked: bool = True) -> torch.export.ExportedProgram:
    """``module`` (its model prepared, in eval mode) at ``batch``, traced
    on ``device``: embedding ``weights`` (by default every tensor its
    forward reads, :func:`read_tensors`) with ``baked``, else taking them
    as its first input."""
    inputs = example_inputs(module, batch, device)
    if weights is None:
        weights = read_tensors(module, inputs)
    if baked:
        wrapped, args = _BakedWeights(module, weights), tuple(inputs)
    else:
        wrapped, args = _SharedWeights(module), (weights, *inputs)
    with torch.no_grad():
        program = torch.export.export(wrapped, args, strict=False)
    program.example_inputs = None    # else saved: the weights, the images
    return program


def export_container(module: ServingModule, directory: str,
                     buckets: Sequence[int], bake: Sequence[int], device,
                     meta: dict) -> Dict[int, float]:
    """Write a container (``serving.save_container``): the tensors the
    graphs read stored once, one program per bucket, the ``bake`` buckets
    holding their own. Returns each bucket's export seconds."""
    weights = read_tensors(module, example_inputs(module, min(buckets),
                                                  device))
    graphs, seconds = {}, {}
    for b in buckets:
        t0 = time.perf_counter()
        graphs[b] = export_program(module, b, device, weights, b in bake)
        seconds[b] = time.perf_counter() - t0
    serving.save_container(directory, weights, graphs, baked=bake, meta=dict(
        meta, device=torch.device(device).type,
        image_size=module.cfg.model.image_size, letterbox=module.letterbox,
        raw_rgb=module.raw_rgb))
    return seconds


def calibration_batches(args, cfg, device, batch_size: int):
    """``--calib-batches`` eval-preprocessed batches on ``device``: from
    the ``--data-dir`` shards (the distribution the model will serve), or
    synthetic ones seeded ``CALIB_SEED + i``."""
    if args.data_dir:
        calib_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=batch_size))
        it = common.batch_iterator(args, calib_cfg, training=False,
                                   cuda_device=common.cuda_index(device))
        for i in range(args.calib_batches):
            try:
                raw = next(it)
            except StopIteration:
                if i == 0:
                    raise ValueError(f"no calibration data in "
                                     f"{args.data_dir}") from None
                return
            yield preprocess_for_eval(
                torch.from_numpy(raw["image"]).to(device), cfg.data)
        return
    for i in range(args.calib_batches):
        gen = torch.Generator(device=device).manual_seed(CALIB_SEED + i)
        images = synthetic_batch_device(gen, batch_size,
                                        cfg.model.image_size,
                                        cfg.data.max_gt_boxes)["image"]
        yield preprocess_for_eval(images, cfg.data)


def parse_args(argv: Optional[List[str]]):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_common_args(p)
    p.add_argument("--output", required=True,
                   help="program path (.pt2), or the container's directory")
    p.add_argument("--batch", type=int, default=1,
                   help="static serving batch size")
    p.add_argument("--dtype", default="bfloat16",
                   choices=sorted(common.DTYPES))
    p.add_argument("--raw-rgb", action="store_true",
                   help="bake the eval preprocessing in, taking raw [0,255] "
                        "RGB of the model input size")
    p.add_argument("--fused-sepconv", action="store_true",
                   help="run the backbone's stride-1 separable blocks on "
                        "the fused kernel (B2), as config 3 serves; an "
                        "Xception-lite preset's weights load unchanged")
    p.add_argument("--quant", default="none", choices=("none", "int8"),
                   help="int8: the post-training-quantized backbone "
                        "(quant.py), calibrated here; per-channel int8 "
                        "weights (prequantized into the stored tensors for "
                        "--container), static activation scales; heads and "
                        "NMS stay in --dtype / fp32")
    p.add_argument("--calib-batches", type=int, default=8,
                   help="calibration batches for --quant int8: from the "
                        "--data-dir shards, else synthetic eval-preprocessed "
                        "images")
    p.add_argument("--calib-batch-size", type=int, default=None,
                   help="images a calibration batch (default: --batch)")
    p.add_argument("--calib-percentile", type=float, default=100.0,
                   help="activation-scale statistic for --quant int8: 100 = "
                        "running abs-max; e.g. 99.9 = running max of each "
                        "batch's 99.9th percentile of |x|")
    p.add_argument("--container", action="store_true",
                   help="write a shared-weights container of --batches "
                        "buckets to --output (a directory), reloaded by "
                        "serving.load_container")
    p.add_argument("--batches", default="1,4,8,16",
                   help="bucket batch sizes for --container")
    p.add_argument("--bake-batches", default=None,
                   help="container buckets whose programs embed the weights "
                        "instead of taking the stored ones (default: bucket "
                        "1 when present; '' bakes none; a bucket missing "
                        "from --batches is an error)")
    return p, p.parse_args(argv)


def bake_buckets(p, args) -> tuple:
    """(--batches, the buckets to bake), or an argparse error for a bake
    request that would be dropped."""
    buckets = sorted({int(b) for b in args.batches.split(",")})
    if args.bake_batches is not None and not args.container:
        p.error("--bake-batches requires --container")
    if args.bake_batches is None:
        return buckets, {1} & set(buckets)
    bake = {int(b) for b in args.bake_batches.split(",") if b.strip()}
    missing = bake - set(buckets)
    if missing:
        p.error(f"--bake-batches {sorted(missing)} not in --batches "
                f"{buckets}")
    return buckets, bake


def main(argv: Optional[List[str]] = None) -> dict:
    """Returns what was written: the path, the buckets and their export
    seconds."""
    p, args = parse_args(argv)
    buckets, bake = bake_buckets(p, args)
    device = common.resolve_device(args)
    cfg = common.resolve_config(args)
    if args.fused_sepconv:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, backbone_fused_sepconv=True))
    dtype = common.DTYPES[args.dtype]
    model = common.restored_model(args, cfg, device, dtype, "exporting")
    if args.quant == "int8":
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, backbone_quant="int8"))
        float_state = model.state_dict()
        model = quant.build_detector(cfg.model, device, dtype)
        model.load_state_dict(float_state)
        batch_size = args.calib_batch_size or args.batch
        quant.calibrate_backbone(cfg, model, calibration_batches(
            args, cfg, device, batch_size), percentile=args.calib_percentile)
        stat = ("amax" if args.calib_percentile >= 100.0
                else f"p{args.calib_percentile}")
        print(f"calibrated int8 backbone ({stat}) on {args.calib_batches} "
              f"batches of {batch_size}")
        if args.container:
            # the stored tensors are read as they are: hold int8 weights
            quant.prequantize(model)
            print("prequantized backbone weights to int8 for the container")
    module = ServingModule(prepare_for_inference(model), cfg,
                           raw_rgb=args.raw_rgb)
    if args.container:
        seconds = export_container(
            module, args.output, buckets, bake, device,
            meta={"preset": cfg.model.name, "quant": args.quant})
        print(f"wrote container -> {args.output}: buckets {buckets}, baked "
              f"{sorted(bake)}, exported in "
              f"{ {b: round(s, 1) for b, s in seconds.items()} } s")
        return {"output": args.output, "seconds": seconds}
    t0 = time.perf_counter()
    program = export_program(module, args.batch, device)
    torch.export.save(program, args.output)
    seconds = {args.batch: time.perf_counter() - t0}
    print(f"wrote {args.output} (batch {args.batch}, raw_rgb "
          f"{args.raw_rgb}, letterbox {module.letterbox}; outputs boxes, "
          f"scores, classes, valid)")
    return {"output": args.output, "seconds": seconds}


if __name__ == "__main__":
    main()
