"""The port's serving side: the letterbox and bucket helpers and the
drawing against the JAX package's, then the CLIs end to end on the CPU
(``cli.train`` -> ``cli.export --container --raw-rgb`` -> a process that
imports only ``serving`` -> ``cli.predict``), and the guards."""

import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from x_detector_tpu import serving as jax_serving  # noqa: E402
from x_detector_tpu.utils.draw import (  # noqa: E402
    draw_detections as jax_draw)
from x_detector_tpu_torch import serving  # noqa: E402
from x_detector_tpu_torch.cli import common, export, predict  # noqa: E402
from x_detector_tpu_torch.cli import train as train_cli  # noqa: E402
from x_detector_tpu_torch.data.augment import preprocess_for_eval  # noqa: E402
from x_detector_tpu_torch.data.testdata.make_voc_mini import (  # noqa: E402
    write_voc_tree)
from x_detector_tpu_torch.inference import (  # noqa: E402
    build_eval_fn, unscale_boxes)
from x_detector_tpu_torch.utils.draw import draw_detections  # noqa: E402

THIN = ["--preset", "lighthead_xception", "--image-size", "64",
        "--batch-size", "2", "--backbone-stages", "1,1,1,1",
        "--backbone-widths", "16,32,48,64", "--device", "cpu", "--dtype",
        "float32"]


# ---------------------------------------------------------------------------
# The helpers against the JAX package's (tests/test_export.py's cases)
# ---------------------------------------------------------------------------

def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_letterbox_image_and_batch_equal_jaxs():
    """A wide and a tall image, alone and as a batch: the same canvases
    and box scales, bit for bit (PIL bilinear, half-up rounding)."""
    rng = np.random.default_rng(0)
    wide = rng.integers(0, 255, (30, 60, 3), np.uint8)
    tall = rng.integers(0, 255, (50, 20, 3), np.uint8)
    for image in (wide, tall, wide.astype(np.float32)):
        _assert_same(serving.letterbox_image(image, 64),
                     jax_serving.letterbox_image(image, 64))
    canvas, scale = serving.letterbox_image(wide, 64)
    np.testing.assert_allclose(scale, [32 / 64, 64 / 64])
    assert (canvas[32:] == 0).all() and canvas[:32, :64].any()
    _assert_same(serving.letterbox_batch([wide, tall], 64),
                 jax_serving.letterbox_batch([wide, tall], 64))


@pytest.mark.parametrize("n", [1, 3, 4, 9, 40])
def test_pick_bucket_equals_jaxs(n):
    buckets = [1, 4, 8, 16]
    assert serving.pick_bucket(n, buckets) == jax_serving.pick_bucket(
        n, buckets)


def test_bucketed_letterbox_batch_equals_jaxs():
    """Three images padded to bucket 4 (zero canvases, box scale 1), as
    JAX pads them; a burst past the largest bucket raises in both."""
    imgs = [np.full((32, 48, 3), 128, np.uint8) for _ in range(3)]
    got = serving.bucketed_letterbox_batch(imgs, 64, [1, 4, 8])
    _assert_same(got[:2], jax_serving.bucketed_letterbox_batch(
        imgs, 64, [1, 4, 8])[:2])
    assert got[0].shape == (4, 64, 64, 3) and got[2] == 3
    assert (got[0][3] == 0).all() and (got[1][3] == 1.0).all()
    with pytest.raises(ValueError, match="split"):
        serving.bucketed_letterbox_batch(imgs * 4, 64, [1, 4, 8])


def test_draw_detections_equals_jaxs():
    """Boxes, labels and scores drawn on a seeded image, a few invalid or
    under the threshold: the same pixels."""
    rng = np.random.default_rng(1)
    image = rng.uniform(0, 300, (60, 80, 3)).astype(np.float32)
    lo = rng.uniform(0, 0.5, (6, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.1, 0.5, (6, 2))],
                           axis=1).astype(np.float32)
    scores = rng.uniform(0, 1, 6).astype(np.float32)
    classes = rng.integers(0, 22, 6).astype(np.int32)
    valid = np.array([True, True, False, True, True, True])
    got = draw_detections(image, boxes, scores, classes, valid,
                          score_threshold=0.2)
    want = jax_draw(image, boxes, scores, classes, valid,
                    score_threshold=0.2)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The CLIs end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """cli.train writes a checkpoint; cli.export makes a raw-RGB container
    of buckets 1 and 2 from it; a seeded photo-sized JPEG."""
    root = tmp_path_factory.mktemp("serve")
    model_dir = root / "model"
    train_cli.main(THIN + ["--model-dir", str(model_dir), "--steps", "2"])
    out = export.main(THIN + ["--model-dir", str(model_dir), "--output",
                              str(root / "container"), "--container",
                              "--raw-rgb", "--batches", "1,2"])
    write_voc_tree(str(root / "voc"), 1, hw=(45, 60))
    jpeg, = (root / "voc").rglob("*.jpg")
    return {"root": root, "model_dir": model_dir, "container": out["output"],
            "jpeg": jpeg}


def test_export_cli_writes_a_raw_rgb_container(exported):
    cont = serving.load_container(exported["container"])
    assert cont.meta == {"preset": "lighthead_xception", "quant": "none",
                         "device": "cpu", "image_size": 64,
                         "letterbox": True, "raw_rgb": True,
                         "buckets": [1, 2], "baked": [1]}
    assert set(cont.weights) and all(k.startswith("model.")
                                     for k in cont.weights)


def _eager(exported, canvas, scale):
    """The checkpoint through the eager path: preprocess_for_eval,
    build_eval_fn, the unscale."""
    import argparse
    p = argparse.ArgumentParser()
    common.add_common_args(p)
    p.add_argument("--dtype")
    args = p.parse_args(THIN + ["--model-dir", str(exported["model_dir"])])
    cfg = common.resolve_config(args)
    model = common.restored_model(args, cfg, "cpu", torch.float32, "eager")
    detect = build_eval_fn(model, cfg, "cpu")
    boxes, scores, classes, valid = detect(preprocess_for_eval(
        torch.from_numpy(canvas), cfg.data))
    return unscale_boxes(boxes, torch.from_numpy(scale)), scores, classes, \
        valid


# one thread, as in this process: the CPU's sums take another order on more
SERVE_ONLY = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from x_detector_tpu_torch import serving
cont = serving.load_container(sys.argv[1])
canvas, scale, n = serving.bucketed_letterbox_batch(
    [np.load(sys.argv[2])], cont.meta["image_size"], cont.buckets)
np.savez(sys.argv[3], *[t.numpy() for t in cont.detect(canvas, scale)])
print(json.dumps(sorted(m for m in sys.modules
                        if m.startswith("x_detector_tpu"))))
"""


def test_a_process_importing_only_serving_detects_as_eager(exported,
                                                           tmp_path):
    """A fresh process that imports ``x_detector_tpu_torch.serving`` alone
    loads the container and detects a letterboxed image: the eager path's
    bits, and no module of ``x_detector_tpu_torch.models`` (nor of the JAX
    package) was imported."""
    image = np.asarray(np.random.default_rng(2).integers(
        0, 256, (40, 64, 3)), np.uint8)
    np.save(tmp_path / "image.npy", image)
    proc = subprocess.run(
        [sys.executable, "-c", SERVE_ONLY, exported["container"],
         str(tmp_path / "image.npy"), str(tmp_path / "out.npz")],
        capture_output=True, text=True, timeout=300, check=True)
    modules = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "x_detector_tpu_torch.serving" in modules
    assert not [m for m in modules
                if m.startswith("x_detector_tpu_torch.models")
                or m.split(".")[0] == "x_detector_tpu"], modules
    got = np.load(tmp_path / "out.npz")
    canvas, scale = serving.letterbox_batch([image], 64)
    want = _eager(exported, canvas, scale)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[f"arr_{i}"], w.numpy())


def test_predict_artifact_and_model_dir_give_the_same_detections(exported):
    """cli.predict --artifact (the container, no model code) writes its
    PNG, and cli.predict --model-dir (the live checkpoint, letterboxed the
    same way) gives the same detections bit for bit."""
    png = exported["root"] / "artifact.png"
    got = predict.main(["--artifact", exported["container"], "--device",
                        "cpu", "--input", str(exported["jpeg"]), "--output",
                        str(png), "--score-threshold", "0"])
    assert png.stat().st_size > 0
    want = predict.main(THIN + ["--model-dir", str(exported["model_dir"]),
                                "--input", str(exported["jpeg"]), "--output",
                                str(exported["root"] / "live.png")])
    _assert_same(got, want)
    assert got[3].any()


# ---------------------------------------------------------------------------
# The guards
# ---------------------------------------------------------------------------

def test_save_container_refuses_no_graphs(tmp_path):
    with pytest.raises(ValueError, match="no graphs"):
        serving.save_container(str(tmp_path / "c"), {}, {}, meta={})


def test_export_bake_batches_requires_container(tmp_path):
    with pytest.raises(SystemExit):
        export.main(THIN + ["--model-dir", str(tmp_path), "--output",
                            str(tmp_path / "x.pt2"), "--bake-batches", "1"])


def test_export_bake_bucket_must_be_in_batches(tmp_path):
    with pytest.raises(SystemExit):
        export.main(THIN + ["--model-dir", str(tmp_path), "--output",
                            str(tmp_path / "c"), "--container", "--batches",
                            "1,2", "--bake-batches", "4"])


def test_container_serves_only_its_buckets_and_its_device(exported):
    """A container traced on the CPU refuses another device, naming both;
    a batch without a bucket raises."""
    with pytest.raises(ValueError, match="cpu.*cuda"):
        serving.load_container(exported["container"], device="cuda")
    cont = serving.load_container(exported["container"])
    with pytest.raises(ValueError, match="no graph for batch 3"):
        cont.detect(np.zeros((3, 64, 64, 3), np.float32),
                    np.ones((3, 2), np.float32))


def test_predict_artifact_refuses_a_whitened_container(exported, tmp_path):
    """A container exported without --raw-rgb takes whitened images:
    cli.predict --artifact refuses it."""
    out = export.main(THIN + ["--model-dir", str(exported["model_dir"]),
                              "--output", str(tmp_path / "c"), "--container",
                              "--batches", "1"])
    assert serving.load_container(out["output"]).meta["raw_rgb"] is False
    with pytest.raises(SystemExit, match="raw-rgb"):
        predict.main(["--artifact", out["output"], "--device", "cpu",
                      "--input", str(exported["jpeg"]), "--output",
                      str(tmp_path / "p.png")])
