"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file compiles with its own ``nvcc``, all started
together (``csrc/*.cuh`` holds what several of them include), and the
objects link into one shared library with a plain C interface, loaded with
``ctypes``; no PyTorch header is included, so the build takes seconds. The
build happens at first use, into ``build/torch_kernels/<hash>/`` at the
root of the checkout, keyed by a hash of the sources, the headers and the
flags: a changed source or header builds anew, an unchanged tree loads the
library already there. The compiler's report (``-Xptxas -v``:
registers, shared memory and spills per kernel) is kept beside the library
as ``nvcc.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")
LIB_NAME = "libxdt_kernels.so"
LOG_NAME = "nvcc.log"

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (every entry returns a cudaError_t)
SIGNATURES = {
    # x, wd, wp, scale, bias, residual (or NULL), out,
    # B, H, W, Cin, Cout, dilation, relu, then the plan: th, tw, stages,
    # smem_bytes, bn, grid; stream
    "xdt_fused_sepconv_tma": [_P] * 7 + [_I] * 13 + [_P],
    # features, rois, out, features_are_bf16,
    # B, H, W, R, grid, C, samples, then the plan: threads, rois per block,
    # paired, tabled, smem_bytes; stream
    "xdt_psroi_align_fwd": [_P] * 3 + [_I] * 13 + [_P],
    # grad, rois, dfeat, roi extents (scratch), dfeat_is_bf16,
    # B, H, W, R, grid, C, samples, then the plan: threads, cap,
    # smem_bytes; stream
    "xdt_psroi_align_bwd": [_P] * 4 + [_I] * 11 + [_P],
    # x, w, scale, out, out_is_bf16, B, H, W, Cin, Ho, Wo, Cout, kh, kw,
    # sh, sw, dh, dw, pt, pl, Kp, then the plan: bn, vec; stream
    "xdt_int8_conv": [_P] * 4 + [_I] * 19 + [_P],
    # the same, then the plan: gemm, th, tw, bn, stages, splits,
    # smem_bytes, grid; stream
    "xdt_int8_conv_tma": [_P] * 4 + [_I] * 25 + [_P],
    # x, w, scale, out, out_is_bf16, B, H, W, C, Ho, Wo, stride, dilation,
    # pt, pl, vec; stream
    "xdt_int8_dwconv": [_P] * 4 + [_I] * 12 + [_P],
    # x, w (its "tma" rows), scale, sx_out (or NULL), out, mode, B, H, W,
    # C, Ho, Wo, stride, dilation, pt, pl, then the plan: qw, rr, stages,
    # smem_bytes, grid; stream
    "xdt_int8_dwconv_tma": [_P] * 5 + [_I] * 16 + [_P],
    # v, n, sx, kernel_q, k3_q; stream: the tma route's quantize beside K3's
    "xdt_int8_quantize_forms": [_P, _I, _P, _P, _P, _P],
    # x, sx, q, x_is_bf16, n, vec; stream
    "xdt_quantize_s8": [_P] * 3 + [_I] * 3 + [_P],
    # boxes, scratch (the mask and the live words), flags, R, N,
    # iou_threshold (fp32); stream
    "xdt_nms_suppress": [_P] * 3 + [_I] * 2 + [ctypes.c_float, _P],
}


def find_nvcc() -> str:
    """Path of nvcc, from PATH or CUDA_HOME, else a clear error."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "CUDA kernels are compiled from x_detector_tpu_torch/csrc at first "
        "use and need the CUDA toolkit")


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; returns
    the library's path (``nvcc.log`` beside it holds the compiler's
    report)."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # each build runs in its own directory, so that ranks starting
    # together may build at once; the results are moved in atomically
    with tempfile.TemporaryDirectory(dir=out_dir) as work:
        objs = [Path(work) / (src.stem + ".o") for src in sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources(), objs)]
        logs = [proc.communicate()[0] for proc in procs]
        codes = [proc.returncode for proc in procs]
        tmp = Path(work) / LIB_NAME
        if not any(codes):
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o",
                                   str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            codes.append(link.returncode)
        if any(codes):
            raise RuntimeError(f"nvcc failed ({codes}):\n" + "\n".join(logs))
        (Path(work) / LOG_NAME).write_text("\n".join(logs))
        os.replace(Path(work) / LOG_NAME, out_dir / LOG_NAME)
        os.replace(tmp, lib)      # atomic: a reader never sees half a file
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error at launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def launch(entry: str, what: str, on: torch.Tensor, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and the raw current
    stream of ``on``'s card, with that card current; raise if it reported
    a CUDA error. The card is switched only when another one is current:
    a launch is host-bound, and a ``torch.cuda.device`` guard and a
    ``torch.cuda.Stream`` object cost more host time than the launch."""
    index = on.get_device()
    fn = getattr(library(), entry)
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    check(err, what)
