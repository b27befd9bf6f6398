"""The port's TensorBoard event files (``utils/logging.py``), written
without TensorFlow, against the JAX package's ``MetricsLogger``, which
writes them with TensorFlow's summary writer (TensorFlow is on this host).

Both files are read back with ``tf.compat.v1.train.summary_iterator`` and
with the port's ``read_events`` (CRCs checked): the same (step, tag,
value) triples (``wall_time_s`` is each logger's own clock: its tag and
steps only), the same image pixels after PNG decoding (the PNG encoders
differ), and the same record framing TensorBoard needs.
"""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from x_detector_tpu.utils import logging as jax_logging  # noqa: E402
from x_detector_tpu_torch.utils import logging as port_logging  # noqa: E402

RECORDS = [(1, {"loss": 2.5, "lr": 1e-3, "n": 3}),
           (2, {"loss": torch.tensor(2.0), "lr": 5e-4, "name": "x"}),
           (20, {"loss": torch.tensor(1.25), "eval_mAP": 0.375})]


def _image(c):
    return np.random.default_rng(c).integers(0, 256, (6, 9, c), np.uint8)


def _write(module, logdir):
    lg = module.MetricsLogger(None, echo=False, tensorboard_dir=logdir)
    for step, metrics in RECORDS:
        lg.log(step, metrics)
    lg.log_image(3, "boxes", _image(3))
    lg.log_image(4, "grey", _image(1))
    lg.log_image(5, "float", _image(3).astype(np.float32) * 1.5)
    lg.close()
    files = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    assert len(files) == 1
    return files[0]


@pytest.fixture(scope="module")
def event_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tb")
    return (_write(jax_logging, str(tmp / "jax")),
            _write(port_logging, str(tmp / "port")))


def _tf_triples(path):
    tf = pytest.importorskip("tensorflow")
    scalars, images, versions = set(), {}, []
    for event in tf.compat.v1.train.summary_iterator(path):
        if event.file_version:
            versions.append(event.file_version)
        for v in event.summary.value:
            plugin = v.metadata.plugin_data.plugin_name
            if plugin == "images":
                w, h, png = v.tensor.string_val
                pixels = tf.io.decode_png(png).numpy()
                assert pixels.shape[:2] == (int(h), int(w))
                images[(event.step, v.tag)] = pixels
            else:
                assert plugin == "scalars"
                value = float(tf.make_ndarray(v.tensor))
                scalars.add((event.step, v.tag, None if v.tag ==
                             "wall_time_s" else value))
    return versions, scalars, images


def test_event_files_read_the_same_through_tensorflow(event_files):
    jax_file, port_file = event_files
    jv, js, ji = _tf_triples(jax_file)
    pv, ps, pi = _tf_triples(port_file)
    assert jv == pv == ["brain.Event:2"]
    assert ps == js
    assert (20, "eval_mAP", 0.375) in ps and (2, "wall_time_s", None) in ps
    assert set(pi) == set(ji) == {(3, "boxes"), (4, "grey"), (5, "float")}
    for key in ji:
        np.testing.assert_array_equal(pi[key], ji[key], err_msg=str(key))


def test_port_reader_reads_tensorflows_files(event_files):
    """read_events (the port's, CRCs checked) gives TensorFlow's file the
    triples TensorFlow's reader gives the port's."""
    jax_file, port_file = event_files
    for path in (jax_file, port_file):
        events = list(port_logging.read_events(path))
        assert events[0]["file_version"] == "brain.Event:2"
        got = {(e["step"], tag, None if tag == "wall_time_s" else value)
               for e in events for tag, plugin, value in e.get("values", ())
               if plugin == "scalars"}
        assert got == _tf_triples(port_file)[1]
        shapes = {(e["step"], tag): value[:2] for e in events
                  for tag, plugin, value in e.get("values", ())
                  if plugin == "images"}
        assert shapes[(4, "grey")] == [b"9", b"6"]


def test_a_corrupt_event_file_fails_its_crc(event_files, tmp_path):
    data = bytearray(open(event_files[1], "rb").read())
    data[len(data) // 2] ^= 0x40
    bad = tmp_path / "events.out.tfevents.bad"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC|corrupt"):
        list(port_logging.read_events(str(bad)))
