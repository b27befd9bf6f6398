"""Kernel B2 with parts compiled out, timed at config 3's shapes on one card.

    python -m x_detector_tpu_torch.sepconv_variants

Builds ``csrc/fused_sepconv.cu`` once as it is and once with each of its
measurement switches (``XDT_SKIP_DEPTHWISE``, ``XDT_SKIP_PRODUCTS``,
``XDT_ONE_TAP_ROW``), each into its own library under
``build/sepconv_variants/`` (one nvcc per variant, all started together),
then times every variant on the same inputs at each of B2's config-3 shapes
(batch 16, no residual) with CUDA events. Prints the card's name and power
limit, each variant's registers and spills, then one line per shape. The
variants other than the full kernel compute wrong results on purpose: they
show where the kernel's time goes, nothing else.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import torch

from x_detector_tpu_torch import _build
from x_detector_tpu_torch.ops import fused_sepconv as fs

VARIANTS = {"full": (), "skip_depthwise": ("-DXDT_SKIP_DEPTHWISE",),
            "skip_products": ("-DXDT_SKIP_PRODUCTS",),
            "one_tap_row": ("-DXDT_ONE_TAP_ROW",)}
SHAPES = [(200, 200, 128, 128, 1), (100, 100, 256, 256, 1),
          (50, 50, 512, 512, 1), (50, 50, 512, 1024, 2),
          (50, 50, 1024, 1024, 2)]
BATCH = 16
OUT_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / (
    "sepconv_variants")


def build_variants():
    """{name: (loaded library, ptxas's register and spill lines)}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = str(_build.CSRC / "fused_sepconv.cu")
    procs = {name: subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", *flags, "-o",
         str(OUT_DIR / f"{name}.so"), src], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, flags in VARIANTS.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
        fn = lib.xdt_fused_sepconv_tma
        fn.argtypes = _build.SIGNATURES["xdt_fused_sepconv_tma"]
        fn.restype = ctypes.c_int
        libs[name] = (lib, [line.strip() for line in log.splitlines()
                            if "Used" in line or "spill" in line])
    return libs


def cuda_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sepconv_variants needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build_variants()
    for name, (_, report) in libs.items():
        print(f"{name}: {'; '.join(report)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    original = _build.library
    try:
        for h, w, cin, cout, d in SHAPES:
            x = randn(BATCH, h, w, cin).to(torch.bfloat16)
            ops = fs.prepare_weights(randn(3, 3, cin) / 3.0,
                                     randn(cin, cout) / cin ** 0.5,
                                     1.0 + 0.1 * randn(cout),
                                     0.1 * randn(cout))
            run = lambda: fs.fused_separable_conv_prepared(x, ops,
                                                           dilation=d)
            times = []
            for name, (lib, _) in libs.items():
                _build.library = lambda lib=lib: lib
                times.append(f"{name} {cuda_ms(run):.4f} ms")
            print(f"{h}x{w} {cin}->{cout} d={d}: " + "; ".join(times),
                  flush=True)
    finally:
        _build.library = original


if __name__ == "__main__":
    main()
