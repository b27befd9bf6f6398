"""Kernel B1's forward at config 3's and config 4's shapes on one card: as
built, at other launch plans, with parts switched off, and against another
checkout's kernel.

    python -m x_detector_tpu_torch.psroi_fwd_variants [--parent DIR]

At config 3's shape (B=16, R=512, a 50x50 bf16 map, k=7, C=10, S=2) and
config 4's (R=1000) the forward is held to the plain version (1e-5 of the
scale) and timed two ways: the device time of its kernel from
``torch.profiler`` (what the card spends, without the host's launch time)
and CUDA events around 20 back-to-back calls of the wrapper
(``batched_psroi_align``, which adds the wrapper's host time where that is
longer than the kernel). The map is not flushed from L2 between calls: the
real caller finds it just written by the thin-map conv. Then, by device
time: the kernel at other plans (threads, rois per block, the scalar path
in place of the paired one); the kernel built with each of its measurement
switches (listed in its header; each gives wrong results on purpose, and
none is checked) into ``build/psroi_fwd_variants/``; and the L2 sectors the
gather asks for, counted on the card from the taps of these rois as the
kernel's warps read them (distinct 32-byte sectors per warp load; an upper
bound on the L2 traffic, since L1 hits are not subtracted). With
``--parent DIR``, DIR's ``x_detector_tpu_torch/csrc/psroi_align.cu`` is
built with nvcc (the backward's parent build,
``psroi_bwd_variants.parent_backward``) and its forward, whose C entry takes
the first design's arguments (no plan: one thread an output element), is
checked, its sectors counted, and timed in turns with this one on the same
inputs (parent, this, this, parent). Prints the card's name and power limit,
the kernels' registers and spills, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess

import torch

from x_detector_tpu_torch import _build
from x_detector_tpu_torch import psroi_bwd_variants as bwd
from x_detector_tpu_torch.ops import psroi_align as pa
from x_detector_tpu_torch.utils import profiling

B, SIZE, GRID, C, SAMPLES = 16, 50, 7, 10, 2
ROIS = {"config3": 512, "config4": 1000}
VARIANT_DIR = bwd.BUILD / "psroi_fwd_variants"
SWITCHES = {"no_load": ["-DXDT_FWD_NO_LOAD"],
            "const_table": ["-DXDT_FWD_CONST_TABLE"],
            "no_load_const_table": ["-DXDT_FWD_NO_LOAD",
                                    "-DXDT_FWD_CONST_TABLE"],
            "runtime_samples": ["-DXDT_FWD_RUNTIME_SAMPLES"]}
# (threads, rois per block, paired) of the plans timed beside the default
PLANS = [(t, n, True) for t in (128, 256, 512) for n in (1, 2, 4, 8, 16)] + [
    (256, 0, False)]
REPS = 50                # profiled calls per reading
_P, _I = ctypes.c_void_p, ctypes.c_int


def device_ms(fn) -> float:
    """The forward kernel's mean device ms per call of ``fn``
    (``torch.profiler``)."""
    return profiling.device_ms(fn, REPS, keep="psroi")


def build_switched():
    """{switch name: the kernel library built with that switch}, one nvcc
    each, all started together."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    src = str(_build.CSRC / "psroi_align.cu")
    procs = {name: subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", *flags, "-o",
         str(VARIANT_DIR / f"{name}.so"), src], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, flags in SWITCHES.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(VARIANT_DIR / f"{name}.so"))
        fn = lib.xdt_psroi_align_fwd
        fn.argtypes = _build.SIGNATURES["xdt_psroi_align_fwd"]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def parent_forward(checkout: pathlib.Path):
    """The first design's forward from ``checkout``, built by the
    backward's parent build: (function of (feat, rois, out) that launches
    it, ptxas lines)."""
    _, lines = bwd.parent_backward(checkout)
    fn = ctypes.CDLL(str(bwd.PARENT_DIR / "libparent.so")).xdt_psroi_align_fwd
    fn.argtypes = [_P] * 3 + [_I] * 8 + [_P]
    fn.restype = ctypes.c_int

    def run(feat, rois, out):
        err = fn(feat.data_ptr(), rois.data_ptr(), out.data_ptr(),
                 int(feat.dtype == torch.bfloat16), feat.shape[0], SIZE,
                 SIZE, rois.shape[1], GRID, C, SAMPLES,
                 torch.cuda.current_stream().cuda_stream)
        _build.check(err, "parent psroi_align")
    return run, lines


def launch(plan: pa.ForwardPlan, feat, rois, out) -> None:
    """The forward kernel at ``plan``, on the current library."""
    err = _build.library().xdt_psroi_align_fwd(
        feat.data_ptr(), rois.data_ptr(), out.data_ptr(),
        int(feat.dtype == torch.bfloat16), *feat.shape[:3], rois.shape[1],
        GRID, C, SAMPLES, plan.threads, plan.rois_per_block,
        int(plan.paired), int(plan.tabled), plan.smem_bytes,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "psroi_align")


def gather_sectors(feat, rois, width: int, group_of) -> tuple:
    """(warp loads, distinct 32-byte sectors they touch) of the gather: for
    each of the S*S*4 taps, the byte addresses of lanes that read ``width``
    channels each, grouped into warp loads by ``group_of(lane index [B, R,
    k, k, C/width], row-major)``."""
    b, h, w, kkc = feat.shape
    dev = feat.device
    ys = pa._sample_coords(rois, GRID, SAMPLES, h, 0, 2)     # [B, R, k, S]
    xs = pa._sample_coords(rois, GRID, SAMPLES, w, 1, 3)
    ar = torch.arange(GRID, device=dev)
    ch = ((ar[:, None, None] * GRID + ar[None, :, None]) * C
          + width * torch.arange(C // width, device=dev))    # [k, k, C/w]
    lane = torch.arange(b * rois.shape[1] * GRID * GRID * (C // width),
                        device=dev).view(b, -1, GRID, GRID, C // width)
    group = group_of(lane)
    loads = sectors = 0
    for sy in range(SAMPLES):
        y0 = ys[..., sy].floor()
        for sx in range(SAMPLES):
            x0 = xs[..., sx].floor()
            for y in (y0, (y0 + 1).clamp(max=h - 1)):
                for x in (x0, (x0 + 1).clamp(max=w - 1)):
                    pix = ((torch.arange(b, device=dev)[:, None, None, None]
                            * h + y.long()[..., :, None]) * w
                           + x.long()[..., None, :])          # [B, R, k, k]
                    addr = (pix[..., None] * kkc + ch) * feat.element_size()
                    key = group * (1 << 32) + addr // 32
                    loads += int(group.unique().numel())
                    sectors += int(key.unique().numel())
    return loads, sectors


def check(got, ref, what: str) -> float:
    err = (got - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    if not err <= 1e-5 * scale:
        raise AssertionError(f"{what}: max abs err {err:.3g} beyond 1e-5 x "
                             f"scale {scale:.3g}")
    return err


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="root of a checkout whose forward kernel to time "
                         "beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("psroi_fwd_variants needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    lib = _build.build()
    for line in bwd.ptxas_lines((lib.parent / _build.LOG_NAME).read_text()):
        print("  " + line, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    feat = torch.randn(B, SIZE, SIZE, GRID * GRID * C, generator=gen,
                       device=dev).to(torch.bfloat16)
    inputs = {}
    for name, r in ROIS.items():
        lo = torch.rand(B, r, 2, generator=gen, device=dev) * 0.8
        hw = torch.rand(B, r, 2, generator=gen, device=dev) * 0.5
        inputs[name] = torch.cat([lo, (lo + hw).clamp(max=1.0)],
                                 dim=-1).contiguous()
    fwd = {name: (lambda rois=rois: pa.batched_psroi_align(feat, rois, GRID,
                                                            SAMPLES))
           for name, rois in inputs.items()}
    result = {"card": smi, "shape": [B, SIZE, GRID, C, SAMPLES],
              "kernel": {}, "plans": {}, "sectors": {}, "switches": {}}
    refs = {}
    for name, rois in inputs.items():
        refs[name] = pa.psroi_align_reference(feat, rois, GRID, SAMPLES)
        result["kernel"][name + "_err"] = check(fwd[name](), refs[name],
                                                name)
        result["kernel"][name + "_device_ms"] = device_ms(fwd[name])
        result["kernel"][name + "_event_ms"] = bwd.cuda_ms(fwd[name])
    print(f"kernel: {result['kernel']}", flush=True)
    for name, rois in inputs.items():
        out = torch.empty(B, rois.shape[1], GRID, GRID, C, device=dev)
        for threads, per_block, paired in PLANS:
            plan = pa.plan_forward(B, rois.shape[1], GRID, C, SAMPLES, paired,
                                   per_block, threads)
            key = (f"{name} threads={plan.threads} "
                   f"rois_per_block={plan.rois_per_block} paired={paired}")
            result["plans"][key] = device_ms(
                lambda p=plan, r=rois: launch(p, feat, r, out))
        plan = pa.plan_forward(B, rois.shape[1], GRID, C, SAMPLES, True)
        result["plans"][name + " default"] = repr(plan)
        # a block's lanes run contiguously through its image's; a warp
        # load takes 32 of them
        per_image = rois.shape[1] * plan.lanes_per_roi
        per_block = plan.rois_per_block * plan.lanes_per_roi
        chunks = -(-per_block // 32)
        this = gather_sectors(feat, rois, 2, lambda lane: (
            (lane // per_image * plan.blocks_per_image
             + lane % per_image // per_block) * chunks
            + lane % per_image % per_block // 32))
        result["sectors"][name] = {"warp_loads": this[0],
                                   "sectors": this[1]}
    print(f"plans (device ms): {result['plans']}", flush=True)
    print(f"gather (warp loads, 32-byte sectors): {result['sectors']}",
          flush=True)
    original = _build.library
    try:
        for switch, lib in build_switched().items():
            _build.library = lambda lib=lib: lib
            result["switches"][switch] = {
                name + "_device_ms": device_ms(fn) for name, fn in fwd.items()}
            print(f"switch {switch}: {result['switches'][switch]}",
                  flush=True)
    finally:
        _build.library = original
    if args.parent is not None:
        old, lines = parent_forward(args.parent.resolve())
        for line in lines:
            print("  parent " + line, flush=True)
        for name, rois in inputs.items():
            out = torch.empty(B, rois.shape[1], GRID, GRID, C, device=dev)
            parent = lambda rois=rois, out=out: old(feat, rois, out)
            parent()
            torch.cuda.synchronize()
            result[f"parent_{name}_err"] = check(out, refs[name], "parent")
            # one thread an output element, 256 a block, c fastest
            loads, sectors = gather_sectors(feat, rois, 1,
                                            lambda lane: lane // 32)
            result["sectors"]["parent_" + name] = {"warp_loads": loads,
                                                   "sectors": sectors}
            turns = [("parent", parent), ("this", fwd[name]),
                     ("this", fwd[name]), ("parent", parent)]
            result[f"turns_{name}"] = [
                (who, device_ms(fn), bwd.cuda_ms(fn)) for who, fn in turns]
            print(f"turns, {name} (who, device ms, event ms): "
                  f"{result[f'turns_{name}']}", flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
