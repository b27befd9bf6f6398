"""The port's data sources on the CPU against the JAX package's: VOC
annotation parsing, the TF-free TFRecord writer and reader, the native
loader (its own copy of the C++, built under ``build/torch_loader/``),
``cli.convert_voc`` and ``cli.common.batch_iterator`` over shards."""

import argparse
import dataclasses
import os
import pathlib
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_voc_io import make_fake_voc  # noqa: E402
from x_detector_tpu.data import voc as jax_voc  # noqa: E402
from x_detector_tpu_torch.cli import common, convert_voc  # noqa: E402
from x_detector_tpu_torch.config import lighthead_xception  # noqa: E402
from x_detector_tpu_torch.data import native_loader  # noqa: E402
from x_detector_tpu_torch.data import tfrecord as tfr  # noqa: E402
from x_detector_tpu_torch.data import voc  # noqa: E402
from x_detector_tpu_torch.data.native_loader import NativeLoader  # noqa

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_IMAGES = 7


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A fake VOCdevkit (PIL JPEGs of 60-120 px, 1-3 objects each, some
    difficult) and the port's shards of it, 3 examples a shard."""
    root = tmp_path_factory.mktemp("voc")
    ids, meta = make_fake_voc(str(root), n_images=N_IMAGES)
    shards = convert_voc.main(["--voc-root", str(root), "--output-dir",
                               str(root / "port"), "--shard-size", "3"])
    return root, ids, meta, shards


@pytest.fixture(scope="module")
def jax_shards(tree):
    """The JAX package's shards of the same tree (its writer needs TF)."""
    pytest.importorskip("tensorflow")
    from x_detector_tpu.data import tfrecord as jax_tfr
    root = tree[0]
    return jax_tfr.convert_voc_to_tfrecords(
        str(root), [("2007", "trainval")], str(root / "jax"), shard_size=3)


# ---------------------------------------------------------------------------
# VOC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index", range(N_IMAGES))
def test_parse_annotation_equals_the_jax_packages(tree, index):
    root, ids, *_ = tree
    path = voc.example_paths(str(root), "2007", ids[index])["annotation"]
    got, want = voc.parse_annotation(path), jax_voc.parse_annotation(path)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def test_splits_paths_and_label_map_equal_the_jax_packages(tree):
    root, ids, *_ = tree
    assert voc.list_split(str(root), "2007", "trainval") == ids == (
        jax_voc.list_split(str(root), "2007", "trainval"))
    assert voc.example_paths("r", "2012", "x") == jax_voc.example_paths(
        "r", "2012", "x")
    assert voc.VOC_LABEL_MAP == jax_voc.VOC_LABEL_MAP
    assert voc.CANONICAL_SPLIT_SIZES == jax_voc.CANONICAL_SPLIT_SIZES


# ---------------------------------------------------------------------------
# The TF-free writer and reader
# ---------------------------------------------------------------------------

def _crc_bytewise(data):
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
    return crc ^ 0xFFFFFFFF


@pytest.mark.parametrize("n", [0, 1, 9, 255, 2047, 2048, 2049, 6000])
def test_crc32c_equals_the_bitwise_definition(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert tfr.crc32c(data) == _crc_bytewise(data)
    assert tfr.crc32c(b"123456789") == 0xE3069283      # the check value


def test_shards_are_named_and_filled_as_the_jax_packages(tree, jax_shards):
    *_, shards = tree
    assert [os.path.basename(p) for p in shards] == [
        os.path.basename(p) for p in jax_shards] == [
        "voc-00000.tfrecord", "voc-00001.tfrecord", "voc-00002.tfrecord"]
    assert [len(list(tfr.read_records(p))) for p in shards] == [3, 3, 1]


def test_shards_parse_through_tf_to_the_jax_packages_records(tree,
                                                            jax_shards):
    """TensorFlow reads the port's shards (framing and CRCs) and parses
    every record into the same tf.train.Example as the JAX writer's; the
    port's reader and parser give the same bytes and values as TF."""
    tf = pytest.importorskip("tensorflow")
    *_, shards = tree
    for port, ref in zip(shards, jax_shards):
        got = [r.numpy() for r in tf.data.TFRecordDataset(port)]
        want = [r.numpy() for r in tf.data.TFRecordDataset(ref)]
        assert len(got) == len(want) > 0
        assert got == list(tfr.read_records(port))
        for g, w in zip(got, want):
            assert (tf.train.Example.FromString(g)
                    == tf.train.Example.FromString(w))
            parsed, tf_parsed = tfr.parse_example(g), tfr.parse_example(w)
            assert parsed.keys() == tf_parsed.keys()
            for k, v in parsed.items():
                np.testing.assert_array_equal(np.asarray(v),
                                              np.asarray(tf_parsed[k]))


def test_encode_example_round_trips_negative_and_empty_lists():
    ex = tfr.encode_example({"a": ("int64", [-1, 0, 2 ** 40]),
                             "b": ("float", []), "c": ("bytes", [b"x", b""]),
                             "d": ("float", [0.5, -2.25])})
    got = tfr.parse_example(ex)
    assert got["a"].tolist() == [-1, 0, 2 ** 40]
    assert got["b"].shape == (0,) and got["c"] == [b"x", b""]
    assert got["d"].tolist() == [0.5, -2.25]


def test_read_records_rejects_a_corrupt_record(tree, tmp_path):
    *_, shards = tree
    data = bytearray(pathlib.Path(shards[0]).read_bytes())
    first = struct.unpack("<Q", data[:8])[0]
    data[12 + first // 2] ^= 0xFF               # a byte of the first payload
    bad = tmp_path / "bad.tfrecord"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="fails its CRC"):
        list(tfr.read_records(str(bad)))
    bad.write_bytes(b"\x01" + bytes(data[1:]))      # the length's CRC
    with pytest.raises(ValueError, match="corrupt record length"):
        list(tfr.read_records(str(bad)))


# ---------------------------------------------------------------------------
# The native loader
# ---------------------------------------------------------------------------

def _stream(loader, n):
    return [next(loader) for _ in range(n)]


def _assert_streams_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)


def test_loader_builds_its_own_copy_under_build(tree):
    """The port's library comes from its own source into
    ``build/torch_loader/``, never from or into ``x_detector_tpu/``; here
    libjpeg decodes."""
    path, decoder = native_loader.build()
    assert decoder == native_loader.decoder() == "libjpeg"
    assert path.is_relative_to(ROOT / "build" / "torch_loader")
    assert native_loader.SOURCE == (
        ROOT / "x_detector_tpu_torch" / "native" / "xdet_loader.cc")


OPTIONS = {
    "shuffled": dict(shuffle=True, repeat=True, seed=3),
    "letterbox-resumed": dict(shuffle=True, repeat=True, seed=5,
                              letterbox=True, start_example=5),
    "ordered-once": dict(shuffle=False, repeat=False),
}


@pytest.mark.parametrize("options", sorted(OPTIONS))
def test_loader_batches_equal_the_jax_loaders_bitwise(tree, options):
    """The same shards, seed and start position give the same batches, bit
    for bit (images, boxes, labels, masks, difficult, box_scale, ids)."""
    from x_detector_tpu.data.native_loader import NativeLoader as JaxLoader
    *_, shards = tree
    kw = dict(canvas_size=48, max_gt=6, batch_size=2, **OPTIONS[options])
    got = list(zip(range(6), NativeLoader(shards, num_threads=3, **kw)))
    want = list(zip(range(6), JaxLoader(shards, num_threads=2, **kw)))
    _assert_streams_equal([b for _, b in got], [b for _, b in want])
    assert len(got) == (4 if options == "ordered-once" else 6)


def test_jax_loader_reads_the_port_shards_as_the_jax_shards(tree,
                                                           jax_shards):
    from x_detector_tpu.data.native_loader import NativeLoader as JaxLoader
    *_, shards = tree
    kw = dict(canvas_size=40, max_gt=6, batch_size=3, shuffle=True, seed=1,
              num_threads=2)
    _assert_streams_equal(_stream(JaxLoader(shards, **kw), 5),
                          _stream(JaxLoader(jax_shards, **kw), 5))


def test_loader_stream_is_independent_of_the_thread_count(tree):
    *_, shards = tree
    kw = dict(canvas_size=32, max_gt=6, batch_size=4, shuffle=True, seed=7)
    _assert_streams_equal(_stream(NativeLoader(shards, num_threads=1, **kw),
                                  6),
                          _stream(NativeLoader(shards, num_threads=4, **kw),
                                  6))


def test_loader_resumes_exactly(tree):
    """The position after k batches, passed back as ``start_example``,
    continues the uninterrupted stream bit for bit."""
    *_, shards = tree
    kw = dict(canvas_size=32, max_gt=6, batch_size=3, shuffle=True, seed=11,
              num_threads=2)
    full = NativeLoader(shards, **kw)
    _stream(full, 4)
    probe = NativeLoader(shards, **kw)
    _stream(probe, 4)
    assert probe.position == 12
    _assert_streams_equal(
        _stream(NativeLoader(shards, start_example=probe.position, **kw), 5),
        _stream(full, 5))


def test_loader_epochs_are_exact_permutations(tree):
    _, ids, _, shards = tree
    loader = NativeLoader(shards, canvas_size=32, max_gt=6, batch_size=1,
                          shuffle=True, seed=3, num_threads=2)
    assert loader.num_examples == N_IMAGES
    epochs = [[next(loader)["image_id"][0].decode() for _ in ids]
              for _ in range(2)]
    assert sorted(epochs[0]) == sorted(epochs[1]) == sorted(ids)
    assert epochs[0] != epochs[1]


def test_loader_rejects_corrupt_records_by_crc(tree, tmp_path):
    """A record whose data fails its CRC becomes a zero example (no gt) in
    its position; a shard whose first length fails its CRC holds no
    records; the others are read as before."""
    _, ids, _, shards = tree
    data = bytearray(pathlib.Path(shards[0]).read_bytes())
    first = struct.unpack("<Q", data[:8])[0]
    data[12 + first - 10] ^= 0x55               # inside the first payload
    bad_data = tmp_path / "a.tfrecord"
    bad_data.write_bytes(bytes(data))
    bad_len = tmp_path / "b.tfrecord"
    bad_len.write_bytes(b"\x01" + bytes(data[1:]))
    kw = dict(canvas_size=32, max_gt=6, batch_size=1, shuffle=False,
              repeat=False, num_threads=1)
    clean = [b for b in NativeLoader(shards, **kw)]
    got = [b for b in NativeLoader([str(bad_len), str(bad_data)]
                                   + shards[1:], **kw)]
    assert len(got) == len(clean) == N_IMAGES
    assert not got[0]["gt_mask"].any() and not got[0]["image"].any()
    assert got[0]["image_id"] == [b""]
    _assert_streams_equal(got[1:], clean[1:])


def test_decode_jpeg_equals_pil(tree):
    from PIL import Image
    root, ids, meta, _ = tree
    for image_id in ids[:3]:
        path = voc.example_paths(str(root), "2007", image_id)["image"]
        got = native_loader.decode_jpeg(pathlib.Path(path).read_bytes())
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(got, want)
        assert got.shape == (meta[image_id][1], meta[image_id][0], 3)
    with pytest.raises(ValueError, match="not a decodable JPEG"):
        native_loader.decode_jpeg(b"not a jpeg")


@pytest.mark.parametrize("sampling", ["grey", "4:4:4", "4:2:2", "4:2:0"])
def test_planar_decode_equals_libjpeg(tmp_path, sampling):
    """The nvJPEG build's chroma upsampling and colour conversion, fed
    libjpeg's raw planes, give libjpeg's pixels (and PIL's) bit for bit, at
    odd sizes, with chroma planes 2 samples wide (replicated, not
    interpolated) and at VOC's 500 x 375."""
    from PIL import Image
    from x_detector_tpu_torch.data.testdata.make_voc_mini import photo
    rng = np.random.default_rng(7)
    for h, w in [(37, 53), (64, 48), (5, 3), (17, 4), (9, 6), (375, 500)]:
        pil = Image.fromarray(photo(rng, h, w))
        path = tmp_path / f"{h}x{w}.jpg"
        if sampling == "grey":
            pil.convert("L").save(path, quality=90)
        else:
            pil.save(path, quality=90, subsampling=sampling)
        data = path.read_bytes()
        want = native_loader.decode_jpeg(data)
        np.testing.assert_array_equal(
            want, np.asarray(Image.open(path).convert("RGB")))
        np.testing.assert_array_equal(
            native_loader.decode_jpeg(data, planar=True), want,
            err_msg=f"{sampling} {h} x {w}")


def test_a_failed_build_raises_with_the_compilers_messages(monkeypatch,
                                                           tmp_path):
    broken = tmp_path / "xdet_loader.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SOURCE", broken)
    monkeypatch.setattr(native_loader, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"did not build(.|\n)*"
                                           r"\[libjpeg\](.|\n)*\[nvjpeg\]"):
        native_loader.build()


# ---------------------------------------------------------------------------
# The CLI's data stream
# ---------------------------------------------------------------------------

def _args(**kw):
    return argparse.Namespace(**{"data_dir": None, "seed": 4, **kw})


def _cfg(batch_size=2):
    cfg = lighthead_xception(64)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=batch_size))


def test_batch_iterator_reads_the_shards_and_resumes_in_place(tree):
    """Training streams are shuffled, repeat and resume at a batch position
    as if the skipped batches had been read; eval streams go once, in
    order; letterboxing follows the preset (on for Light-Head)."""
    root, ids, _, shards = tree
    args, cfg = _args(data_dir=str(root / "port")), _cfg()
    whole = common.batch_iterator(args, cfg, training=True, canvas_size=48)
    _stream(whole, 2)
    _assert_streams_equal(
        _stream(common.batch_iterator(args, cfg, training=True,
                                      canvas_size=48, start_batch=2), 3),
        _stream(whole, 3))
    once = list(common.batch_iterator(args, cfg, training=False))
    assert [i.decode() for b in once for i in b["image_id"]] == ids
    assert once[0]["image"].shape == (2, 64, 64, 3)
    assert cfg.data.letterbox and (once[0]["box_scale"] < 1).any()


def test_batch_iterator_without_shards_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no .tfrecord shards"):
        common.batch_iterator(_args(data_dir=str(tmp_path)), _cfg(),
                              training=True)
