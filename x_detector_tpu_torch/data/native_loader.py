"""ctypes binding of the native C++ TFRecord / JPEG loader.

The port of ``x_detector_tpu/data/native_loader.py``. The C++ is the port's
own copy, ``x_detector_tpu_torch/native/xdet_loader.cc`` (ABI version 2, as
the JAX package's): a threaded reader of TFRecord shards (framing and
CRC32C, protobuf parsing, JPEG decode, bilinear canvas resize) whose batch
stream is bitwise deterministic and resumes in O(1).

The library is built with ``g++`` at first use into
``build/torch_loader/<decoder>-<hash>/`` at the root of the checkout, keyed
by a hash of the source, the flags and the CPU's features (``-march=native``),
and loaded with ``ctypes``. The JPEG decoder
is chosen by what the machine has: libjpeg where its header is found, else
nvJPEG from the CUDA toolkit (``$CUDA_HOME``, by default
``/usr/local/cuda``), which decodes on the GPU. If neither builds,
``NativeLoader`` raises with the compiler's messages.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "xdet_loader.cc"
BUILD_ROOT = (Path(__file__).resolve().parent.parent.parent / "build"
              / "torch_loader")
LIB_NAME = "libxdet_loader.so"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
            "-pthread", "-shared")
DECODERS = ("libjpeg", "nvjpeg")     # tried in this order
_ABI_VERSION = 2  # must match xdet_loader_abi_version() in xdet_loader.cc
_ID_CAPACITY = 64


def _cuda_home() -> str:
    return os.environ.get("CUDA_HOME", "/usr/local/cuda")


def _flags(decoder: str) -> Tuple[List[str], List[str]]:
    """(compile flags, link flags) of a decoder's build."""
    if decoder == "libjpeg":
        return [], ["-ljpeg"]
    cuda = _cuda_home()
    return (["-DXDET_NVJPEG", f"-I{cuda}/include"],
            [f"-L{cuda}/lib64", f"-Wl,-rpath,{cuda}/lib64", "-lnvjpeg",
             "-lcudart"])


def _host_key() -> bytes:
    """What ``-march=native`` compiles for: the CPU's feature flags."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")),
                        b"")
    except OSError:
        return platform.processor().encode()


def _lib_path(decoder: str) -> Path:
    cflags, ldflags = _flags(decoder)
    h = hashlib.sha256(" ".join([*CXXFLAGS, *cflags, *ldflags]).encode())
    h.update(SOURCE.read_bytes())
    h.update(_host_key())
    return BUILD_ROOT / f"{decoder}-{h.hexdigest()[:16]}" / LIB_NAME


def _loads(path: Path) -> bool:
    """Whether the library and the decoder library it links load here."""
    try:
        ctypes.CDLL(str(path))
        return True
    except OSError:
        return False


def build() -> Tuple[Path, str]:
    """The library's path and its decoder: one built before for this
    source and CPU that loads, or a new build with the first decoder that
    compiles and loads. Raises with every compiler message when none
    does."""
    for decoder in DECODERS:
        if _lib_path(decoder).is_file() and _loads(_lib_path(decoder)):
            return _lib_path(decoder), decoder
    errors = []
    for decoder in DECODERS:
        lib = _lib_path(decoder)
        lib.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        cflags, ldflags = _flags(decoder)
        proc = subprocess.run(["g++", *CXXFLAGS, *cflags, str(SOURCE), "-o",
                               tmp, *ldflags, "-pthread"],
                              capture_output=True, text=True)
        if proc.returncode == 0 and _loads(Path(tmp)):
            os.replace(tmp, lib)      # atomic: a reader never sees half a file
            return lib, decoder
        os.unlink(tmp)
        errors.append(f"[{decoder}] {proc.stderr[-2000:] or 'does not load'}")
    raise RuntimeError("the native loader did not build with any JPEG "
                       "decoder (libjpeg, nvJPEG):\n" + "\n".join(errors))


@functools.lru_cache(maxsize=None)
def _load_library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.xdet_loader_abi_version.restype = ctypes.c_uint64
    lib.xdet_loader_abi_version.argtypes = []
    if lib.xdet_loader_abi_version() != _ABI_VERSION:
        raise ImportError(f"{path} reports ABI "
                          f"{lib.xdet_loader_abi_version()} != {_ABI_VERSION}")
    lib.xdet_loader_create.restype = ctypes.c_void_p
    lib.xdet_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
    lib.xdet_loader_next.restype = ctypes.c_int
    lib.xdet_loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
        ctypes.c_char_p, ctypes.c_int]
    lib.xdet_loader_position.restype = ctypes.c_uint64
    lib.xdet_loader_position.argtypes = [ctypes.c_void_p]
    lib.xdet_loader_num_examples.restype = ctypes.c_uint64
    lib.xdet_loader_num_examples.argtypes = [ctypes.c_void_p]
    lib.xdet_loader_destroy.restype = None
    lib.xdet_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.xdet_loader_decoder.restype = ctypes.c_int
    lib.xdet_loader_decoder.argtypes = []
    lib.xdet_loader_set_cuda_device.restype = None
    lib.xdet_loader_set_cuda_device.argtypes = [ctypes.c_int]
    lib.xdet_loader_decoder_check.restype = ctypes.c_int
    lib.xdet_loader_decoder_check.argtypes = []
    lib.xdet_decode_jpeg.restype = ctypes.c_int
    lib.xdet_decode_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int]
    return lib


def decoder() -> str:
    """The JPEG decoder the built library uses: "libjpeg" or "nvjpeg"."""
    return DECODERS[_load_library().xdet_loader_decoder()]


def _ready_decoder(lib, cuda_device: int) -> None:
    """Point nvJPEG's threads at ``cuda_device`` and check that a thread
    can make its decoder; raises if not (a decoder that cannot start would
    turn every image into a zero example)."""
    lib.xdet_loader_set_cuda_device(int(cuda_device))
    status = lib.xdet_loader_decoder_check()
    if status:
        raise RuntimeError(f"the {decoder()} JPEG decoder did not start on "
                           f"CUDA device {cuda_device} (status {status})")


def decode_jpeg(data: bytes, cuda_device: int = 0,
                planar: bool = False) -> np.ndarray:
    """One JPEG's RGB pixels, [height, width, 3] uint8, from the loader's
    decoder. With libjpeg, ``planar`` takes libjpeg's raw planes (before
    upsampling and colour conversion) through the upsampling and colour
    conversion that the nvJPEG build applies to nvJPEG's planes
    (greyscale, 4:4:4, 4:2:2, 4:2:0)."""
    lib = _load_library()
    _ready_decoder(lib, cuda_device)
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    status = lib.xdet_decode_jpeg(data, len(data), None, 0, ctypes.byref(w),
                                  ctypes.byref(h), int(planar))
    if status == 1:
        raise ValueError("not a decodable JPEG")
    out = np.empty((h.value, w.value, 3), np.uint8)
    status = lib.xdet_decode_jpeg(data, len(data), out.ctypes.data, out.nbytes,
                                  ctypes.byref(w), ctypes.byref(h),
                                  int(planar))
    if status:
        raise ValueError(f"JPEG decode failed (status {status})")
    return out


class NativeLoader:
    """Iterator of numpy batches with the trainer's schema (image, gt_boxes,
    gt_labels, gt_mask) plus difficult, box_scale and image_id.

    The stream is **bitwise deterministic** for given shards, seed and
    options, whatever the thread count: each epoch is an exact seeded
    permutation of a record index, decoded by position. ``position`` is
    the count of examples consumed; passing it back as ``start_example``
    continues the identical stream. Where nvJPEG decodes, its threads use
    ``cuda_device``."""

    def __init__(self, shard_paths: Sequence[str], canvas_size: int,
                 max_gt: int, batch_size: int, shuffle: bool = True,
                 seed: int = 0, repeat: bool = True, num_threads: int = 4,
                 letterbox: bool = False, start_example: int = 0,
                 cuda_device: int = 0):
        self._lib = _load_library()
        _ready_decoder(self._lib, cuda_device)
        self.canvas = canvas_size
        self.max_gt = max_gt
        self.batch = batch_size
        # oversubscribing a small host collapses throughput: cap at the
        # core count
        num_threads = max(1, min(num_threads, os.cpu_count() or 1))
        paths = [str(p).encode() for p in shard_paths]
        arr = (ctypes.c_char_p * len(paths))(*paths)
        self._handle = self._lib.xdet_loader_create(
            arr, len(paths), canvas_size, max_gt, batch_size,
            int(shuffle), seed, int(repeat), num_threads, int(letterbox),
            start_example)
        if not self._handle:
            raise RuntimeError("native loader creation failed")

    @property
    def position(self) -> int:
        """Examples consumed so far: the resume token (``start_example``)."""
        return int(self._lib.xdet_loader_position(self._handle))

    @property
    def num_examples(self) -> int:
        """Indexed records per epoch."""
        return int(self._lib.xdet_loader_num_examples(self._handle))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b, c, g = self.batch, self.canvas, self.max_gt
        images = np.empty((b, c, c, 3), np.float32)
        boxes = np.empty((b, g, 4), np.float32)
        labels = np.empty((b, g), np.int32)
        mask = np.empty((b, g), np.uint8)
        difficult = np.empty((b, g), np.uint8)
        box_scale = np.empty((b, 2), np.float32)
        ids = ctypes.create_string_buffer(b * _ID_CAPACITY)
        n = self._lib.xdet_loader_next(
            self._handle,
            images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            difficult.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            box_scale.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ids, _ID_CAPACITY)
        if n == 0:
            raise StopIteration
        id_list = [
            ids.raw[i * _ID_CAPACITY:(i + 1) * _ID_CAPACITY].split(b"\0")[0]
            for i in range(n)]
        return {
            "image": images[:n], "gt_boxes": boxes[:n],
            "gt_labels": labels[:n], "gt_mask": mask[:n].astype(bool),
            "difficult": difficult[:n].astype(bool),
            "box_scale": box_scale[:n], "image_id": id_list,
        }

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.xdet_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
