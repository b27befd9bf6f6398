"""Kernel B1's backward at config 4's shape on one card: by gradient, with
parts switched off, and against another checkout's kernel.

    python -m x_detector_tpu_torch.psroi_bwd_variants [--parent DIR]

At config 4's shape (B=16, R=1000, a 50x50 bf16 map, k=7, C=10, S=2) times
the backward kernel for three upstream gradients: dense (``randn``), shaped
like OHEM's (256 non-zero rows of 1000 per image, chosen by the seeded
generator, the rest +-0) and all zero (the pre-pass and the culling, with
nothing to add), each first held to the plain version (1e-5 of the scale
plus one bf16 step), with the device time of the pre-pass and of the tile
kernel from ``torch.profiler``. Then the kernel built with each of its
measurement switches (listed in its header; each gives wrong results on
purpose, and none is checked) into ``build/psroi_bwd_variants/``. With
``--parent DIR``, DIR's ``x_detector_tpu_torch/csrc/psroi_align.cu`` is
built with nvcc into ``build/psroi_bwd_parent/`` and its backward, whose C
entry takes the first design's arguments (no plan), is checked and timed in
turns with this one on the same inputs (parent, this, this, parent) for the
dense and the OHEM-shaped gradient. Prints the card's name and power limit,
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
from x_detector_tpu_torch.ops import psroi_align as pa
from x_detector_tpu_torch.utils.profiling import (card_label, cuda_ms,
                                                  kernel_device_ms)

B, R, SIZE, GRID, C, SAMPLES, OHEM_KEEP = 16, 1000, 50, 7, 10, 2, 256
BUILD = pathlib.Path(__file__).resolve().parent.parent / "build"
PARENT_DIR = BUILD / "psroi_bwd_parent"
VARIANT_DIR = BUILD / "psroi_bwd_variants"
SWITCHES = {"prepare_only": "-DXDT_BWD_PREPARE_ONLY",
            "no_grad_load": "-DXDT_BWD_NO_GRAD_LOAD",
            "no_accumulate": "-DXDT_BWD_NO_ACCUMULATE",
            "cull_only": "-DXDT_BWD_CULL_ONLY"}
_P, _I = ctypes.c_void_p, ctypes.c_int


def device_ms(fn, reps: int = 10) -> dict:
    """{"prepare" or "tiles": mean device ms per call of ``fn``}
    (:func:`utils.profiling.kernel_device_ms`): what the card spends on the
    backward's kernels, without the host's launch time."""
    out = {}
    for key, ms in kernel_device_ms(fn, reps).items():
        if "psroi" in key:
            name = "prepare" if "prepare" in key else "tiles"
            out[name] = out.get(name, 0.0) + ms
    return out


def ptxas_lines(log: str):
    """ptxas's register, shared memory and spill lines for psroi kernels."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = "psroi" in line
            if keep:
                out.append(line.split("entry function ")[-1].split(" for ")[0])
        elif keep and ("Used" in line or "spill" in line):
            out.append("  " + line.split("info    : ")[-1].strip())
    return out


def parent_backward(checkout: pathlib.Path):
    """The first design's backward from ``checkout``: (function of (grad,
    rois, out) that launches it, ptxas lines)."""
    PARENT_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = PARENT_DIR / "libparent.so"
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
         str(lib_path),
         str(checkout / "x_detector_tpu_torch" / "csrc" / "psroi_align.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the parent:\n{proc.stdout}"
                           f"{proc.stderr}")
    fn = ctypes.CDLL(str(lib_path)).xdt_psroi_align_bwd
    fn.argtypes = [_P] * 3 + [_I] * 8 + [_P]
    fn.restype = ctypes.c_int

    def run(grad, rois, out):
        err = fn(grad.data_ptr(), rois.data_ptr(), out.data_ptr(),
                 int(out.dtype == torch.bfloat16), B, SIZE, SIZE, R, GRID, C,
                 SAMPLES, torch.cuda.current_stream().cuda_stream)
        _build.check(err, "parent psroi_align_backward")
    return run, ptxas_lines(proc.stdout + proc.stderr)


def build_switched():
    """{switch name: the kernel library built with that switch}, one nvcc
    each, all started together."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    src = str(_build.CSRC / "psroi_align.cu")
    procs = {name: subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", flag, "-o",
         str(VARIANT_DIR / f"{name}.so"), src], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, flag in SWITCHES.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(VARIANT_DIR / f"{name}.so"))
        fn = lib.xdt_psroi_align_bwd
        fn.argtypes = _build.SIGNATURES["xdt_psroi_align_bwd"]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def check(got, ref, what: str) -> float:
    err = (got.float() - ref.float()).abs()
    scale = max(1.0, ref.float().abs().max().item())
    if (err > 1e-5 * scale + 2.0 ** -7 * ref.float().abs()).any():
        raise AssertionError(f"{what}: max abs err {err.max().item():.3g} "
                             f"beyond 1e-5 x scale {scale:.3g} + one bf16 "
                             "step")
    return err.max().item()


def ohem_shaped(gen, g: torch.Tensor, keep: int = OHEM_KEEP):
    """``g`` [B, R, ...] with all but ``keep`` rows per image, chosen by
    ``gen``, set to zero (+0.0 and -0.0 alternately by roi): the upstream
    gradient of PSROIAlign in a train step, where OHEM keeps ``ohem_topk``
    rois. Returns it and the kept rows' indices [B, keep], in order."""
    b, r = g.shape[:2]
    kept = torch.rand(b, r, generator=gen, device=g.device).argsort(dim=1)[
        :, :keep].sort(dim=1).values
    mask = torch.zeros(b, r, dtype=torch.bool, device=g.device)
    mask.scatter_(1, kept, True)
    zero = torch.where(torch.arange(r, device=g.device) % 2 == 0, 0.0, -0.0)
    shape = (b, r) + (1,) * (g.dim() - 2)
    return torch.where(mask.view(shape), g, zero.view((1,) + shape[1:])), kept


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="root of a checkout whose backward kernel to time "
                         "beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("psroi_bwd_variants needs a CUDA card")
    smi = card_label()
    print(smi, flush=True)
    lib = _build.build()
    for line in ptxas_lines((lib.parent / _build.LOG_NAME).read_text()):
        print("  " + line, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    lo = torch.rand(B, R, 2, generator=gen, device=dev) * 0.8
    hw = torch.rand(B, R, 2, generator=gen, device=dev) * 0.5
    rois = torch.cat([lo, (lo + hw).clamp(max=1.0)], dim=-1).contiguous()
    dense = torch.randn(B, R, GRID, GRID, C, generator=gen, device=dev)
    grads = {"dense": dense, "ohem": ohem_shaped(gen, dense)[0],
             "zero": torch.zeros_like(dense)}
    bwd = {name: (lambda g=g: pa.psroi_align_backward(
        g, rois, SIZE, SIZE, torch.bfloat16, GRID, SAMPLES))
        for name, g in grads.items()}
    result = {"card": smi, "shape": [B, R, SIZE, GRID, C, SAMPLES],
              "plan": repr(pa.plan_backward(SIZE, SIZE, R, GRID, C)),
              "kernel": {}, "device_ms": {}, "switches": {}}
    refs = {}
    for name, g in grads.items():
        refs[name] = pa.psroi_align_backward_reference(
            g, rois, SIZE, SIZE, torch.bfloat16, GRID, SAMPLES)
        result["kernel"][name + "_err"] = check(bwd[name](), refs[name],
                                                name)
        result["kernel"][name + "_ms"] = cuda_ms(bwd[name])
        result["device_ms"][name] = device_ms(bwd[name])
    print(f"kernel: {result['kernel']}", flush=True)
    print(f"device time by kernel (profiler): {result['device_ms']}",
          flush=True)
    original = _build.library
    try:
        for switch, lib in build_switched().items():
            _build.library = lambda lib=lib: lib
            result["switches"][switch] = {
                name + "_ms": cuda_ms(fn) for name, fn in bwd.items()}
            print(f"switch {switch}: {result['switches'][switch]}",
                  flush=True)
    finally:
        _build.library = original
    if args.parent is not None:
        old, lines = parent_backward(args.parent.resolve())
        for line in lines:
            print("  parent " + line, flush=True)
        out = torch.empty(B, SIZE, SIZE, GRID * GRID * C,
                          dtype=torch.bfloat16, device=dev)
        for name in ("dense", "ohem"):
            parent = lambda g=grads[name]: old(g, rois, out)
            parent()
            torch.cuda.synchronize()
            result[f"parent_{name}_err"] = check(out, refs[name], "parent")
            turns = [("parent", parent), ("this", bwd[name]),
                     ("this", bwd[name]), ("parent", parent)]
            result[f"turns_{name}_ms"] = [(who, cuda_ms(fn))
                                         for who, fn in turns]
            print(f"turns, {name}: {result[f'turns_{name}_ms']}", flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
