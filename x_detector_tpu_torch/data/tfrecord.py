"""VOC -> TFRecord shards, and a record reader, without TensorFlow.

The port of ``x_detector_tpu/data/tfrecord.py``'s writer. Shards hold
``tf.train.Example`` protobufs with the JAX package's schema (``_KEYS``):
the encoded JPEG, normalized corner boxes, labels, difficult flags, the
image id and size. Here the protobuf wire format and the TFRecord framing
are written by hand, so neither TensorFlow nor a protobuf package is needed:

  record   u64 length | u32 masked crc32c(length) | data | u32 masked
           crc32c(data), little-endian
  Example  features (1) -> Features: map<string, Feature> feature (1);
           Feature: bytes_list (1) | float_list (2) | int64_list (3), each a
           message whose field 1 holds the values (floats and int64s packed)

Readers: the native loader (``data/native_loader.py``) for training and
evaluation; :func:`read_records` and :func:`parse_example` here for tools
and tests. The JAX package's ``tf.data`` reader is not ported (the card's
machine has no TensorFlow; the native loader is the reader).
"""

from __future__ import annotations

import functools
import os
import struct
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from x_detector_tpu_torch.data import voc as voc_lib

_KEYS = {
    "encoded": "image/encoded",
    "ymin": "image/object/bbox/ymin",
    "xmin": "image/object/bbox/xmin",
    "ymax": "image/object/bbox/ymax",
    "xmax": "image/object/bbox/xmax",
    "label": "image/object/bbox/label",
    "difficult": "image/object/bbox/difficult",
    "image_id": "image/id",
    "height": "image/height",
    "width": "image/width",
}

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) and the TFRecord mask
# ---------------------------------------------------------------------------

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (_POLY if _c & 1 else 0)
    _TABLE.append(_c)
_NP_TABLE = np.asarray(_TABLE, np.uint32)
_LANE = 256     # bytes a numpy lane advances through in step with the others


def _advance(state: int, data: bytes) -> int:
    """The CRC register after ``data``, a byte at a time."""
    t = _TABLE
    for b in data:
        state = t[(state ^ b) & 0xFF] ^ (state >> 8)
    return state


@functools.lru_cache(maxsize=None)
def _lane_operator() -> List[List[int]]:
    """The register's advance over _LANE zero bytes, a linear map over
    GF(2), as four byte-indexed tables."""
    cols = [_advance(1 << bit, bytes(_LANE)) for bit in range(32)]
    tables = []
    for byte in range(4):
        row = []
        for v in range(256):
            acc = 0
            for bit in range(8):
                if v >> bit & 1:
                    acc ^= cols[8 * byte + bit]
            row.append(acc)
        tables.append(row)
    return tables


def crc32c(data: bytes) -> int:
    """CRC32C of ``data``. The register's update is linear in (register,
    data), so the whole _LANE-byte blocks advance from 0 side by side in
    numpy and are chained with the zero-advance operator; the tail goes a
    byte at a time."""
    state = 0xFFFFFFFF
    n = len(data) // _LANE
    if n >= 8:
        lanes = np.frombuffer(data, np.uint8, n * _LANE).reshape(n, _LANE)
        s = np.zeros(n, np.uint32)
        for j in range(_LANE):
            s = _NP_TABLE[(s ^ lanes[:, j]) & 0xFF] ^ (s >> 8)
        m0, m1, m2, m3 = _lane_operator()
        for part in s.tolist():
            state = (m0[state & 0xFF] ^ m1[state >> 8 & 0xFF]
                     ^ m2[state >> 16 & 0xFF] ^ m3[state >> 24]) ^ part
        data = data[n * _LANE:]
    return _advance(state, data) ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------

def frame_record(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the data, the data's CRC."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


def read_records(path: str) -> Iterator[bytes]:
    """The records of one shard, in order. A corrupt frame raises
    ``ValueError`` (the native loader instead stops its index there or
    zeroes the example, to keep positions exact)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise ValueError(f"{path}: truncated record header")
            length, length_crc = struct.unpack("<QI", header)
            if masked_crc32c(header[:8]) != length_crc:
                raise ValueError(f"{path}: corrupt record length")
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4:
                raise ValueError(f"{path}: truncated record")
            if masked_crc32c(data) != struct.unpack("<I", footer)[0]:
                raise ValueError(f"{path}: record data fails its CRC")
            yield data


# ---------------------------------------------------------------------------
# tf.train.Example, written and read by hand
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1                   # int64 as its two's complement
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited field (wire type 2)."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _packed(number: int, payload: bytes) -> bytes:
    return _field(number, payload) if payload else b""


def _feature(kind: str, values) -> bytes:
    if kind == "bytes":
        body = b"".join(_field(1, v) for v in values)
        return _field(1, body)
    if kind == "float":
        body = _packed(1, np.asarray(values, "<f4").reshape(-1).tobytes())
        return _field(2, body)
    body = _packed(1, b"".join(_varint(int(v)) for v in
                               np.asarray(values, np.int64).reshape(-1)))
    return _field(3, body)


def encode_example(features: Dict[str, Tuple[str, object]]) -> bytes:
    """A serialized ``tf.train.Example`` of ``{key: (kind, values)}``, kind
    one of "bytes", "float", "int64"; map entries in the order given."""
    entries = b"".join(
        _field(1, _field(1, key.encode()) + _field(2, _feature(kind, v)))
        for key, (kind, v) in features.items())
    return _field(1, entries)


def make_example(encoded: bytes, image_id: str, ann: Dict) -> bytes:
    """One VOC example in the JAX package's schema (``_make_example``)."""
    boxes = ann["boxes"]
    return encode_example({
        _KEYS["encoded"]: ("bytes", [encoded]),
        _KEYS["image_id"]: ("bytes", [image_id.encode()]),
        _KEYS["height"]: ("int64", [ann["height"]]),
        _KEYS["width"]: ("int64", [ann["width"]]),
        _KEYS["ymin"]: ("float", boxes[:, 0]),
        _KEYS["xmin"]: ("float", boxes[:, 1]),
        _KEYS["ymax"]: ("float", boxes[:, 2]),
        _KEYS["xmax"]: ("float", boxes[:, 3]),
        _KEYS["label"]: ("int64", ann["labels"]),
        _KEYS["difficult"]: ("int64", ann["difficult"].astype(np.int64)),
    })


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    v = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of a message: an int for varints,
    bytes for the rest."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        number, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield number, wire, value


def _list_values(kind: int, body: bytes):
    out = []
    for number, wire, value in _fields(body):
        if number != 1:
            continue
        if kind == 1:
            out.append(bytes(value))
        elif kind == 2:
            out.extend(np.frombuffer(value, "<f4").tolist())
        elif wire == 0:
            out.append(value)
        else:                                    # packed varints
            pos = 0
            while pos < len(value):
                v, pos = _read_varint(value, pos)
                out.append(v)
    if kind == 1:
        return out
    if kind == 2:
        return np.asarray(out, np.float32)
    ints = np.asarray(out, np.uint64).astype(np.int64)   # two's complement
    return ints


def parse_example(data: bytes) -> Dict[str, object]:
    """A serialized ``tf.train.Example`` as ``{key: values}``: a list of
    bytes, a float32 array or an int64 array."""
    out: Dict[str, object] = {}
    for number, _, features in _fields(data):
        if number != 1:
            continue
        for fnum, _, entry in _fields(features):
            if fnum != 1:
                continue
            key, feature = None, b""
            for enum, _, value in _fields(entry):
                if enum == 1:
                    key = bytes(value).decode()
                elif enum == 2:
                    feature = value
            for kind, _, body in _fields(feature):
                out[key] = _list_values(kind, body)
    return out


# ---------------------------------------------------------------------------
# The converter
# ---------------------------------------------------------------------------

def convert_voc_to_tfrecords(voc_root: str, years_splits: Sequence[tuple],
                             output_dir: str, shard_size: int = 500,
                             prefix: str = "voc") -> List[str]:
    """Offline conversion of VOC splits into ``{prefix}-{n:05d}.tfrecord``
    shards of ``shard_size`` examples, in split order. Returns the shard
    paths."""
    os.makedirs(output_dir, exist_ok=True)
    ids = [(year, image_id) for year, split in years_splits
           for image_id in voc_lib.list_split(voc_root, year, split)]
    paths: List[str] = []
    out = None
    try:
        for i, (year, image_id) in enumerate(ids):
            if i % shard_size == 0:
                if out is not None:
                    out.close()
                paths.append(os.path.join(
                    output_dir, f"{prefix}-{len(paths):05d}.tfrecord"))
                out = open(paths[-1], "wb")
            p = voc_lib.example_paths(voc_root, year, image_id)
            with open(p["image"], "rb") as f:
                encoded = f.read()
            ann = voc_lib.parse_annotation(p["annotation"])
            out.write(frame_record(make_example(encoded, image_id, ann)))
    finally:
        if out is not None:
            out.close()
    return paths
