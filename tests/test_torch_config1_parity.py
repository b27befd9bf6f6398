"""Config 1's parity record (``x_detector_tpu_torch/tools/config1_parity.py``)
against the JAX package's (``tools/config1_parity.py``) on the CPU.

The record of one image is held to the calls of JAX's tool
(``preprocess_for_eval``, ``model.apply``, ``lighthead_postprocess``, the
valid slots rounded to 5 decimals) from the same weights, converted by
``from_jax_variables``: at thin widths (ResNet stages of one block, 128 px)
in tier-1, and at config 1's full 800 px as a ``slow`` case. JAX's
Light-Head pools with its PSROIAlign kernel in interpret mode here (its
default pools with a bf16 einsum; the port pools in fp32), as
``tests/test_torch_lighthead.py`` holds the models. ``--compare``'s four
failure kinds (the count, a box, a score, a class) each fail the verdict
and exit 1; an equal record passes.
"""

import contextlib
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from x_detector_tpu.config import (  # noqa: E402
    lighthead_resnet50 as jax_lighthead_resnet50)
from x_detector_tpu.data.augment import (  # noqa: E402
    preprocess_for_eval as jax_preprocess)
from x_detector_tpu.models import lighthead as L  # noqa: E402
from x_detector_tpu.ops.pallas.psroi_align_kernel import (  # noqa: E402
    batched_psroi_align_pallas)
from x_detector_tpu.train import trainer as jax_trainer  # noqa: E402
from x_detector_tpu_torch.config import lighthead_resnet50  # noqa: E402
from x_detector_tpu_torch.inference import build_model  # noqa: E402
from x_detector_tpu_torch.tools import config1_parity as c1  # noqa: E402
from x_detector_tpu_torch.utils.convert import (  # noqa: E402
    from_jax_variables)

DET_ATOL = 1e-4      # the whole-model tolerance of test_torch_lighthead.py


def _thin(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_stages=(1, 1, 1, 1),
        backbone_widths=(8, 16, 24, 32)))


@contextlib.contextmanager
def _jax_psroi_kernel():
    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call",
               functools.partial(pl.pallas_call, interpret=True))
    mp.setattr(L, "batched_psroi_align", batched_psroi_align_pallas)
    try:
        yield
    finally:
        mp.undo()


def _jax_record(jcfg, image):
    """The JAX tool's body: weights from PRNGKey(0), the record of
    ``image``; returns it and the weights in the port's names."""
    model, state = jax_trainer.create_model_and_state(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    with _jax_psroi_kernel():
        inp = jax_preprocess(jnp.asarray(image), jcfg.data)[None]
        out = model.apply(variables, inp, train=False)
        det = L.lighthead_postprocess(out, jcfg.model)
    valid = np.asarray(det.valid[0])
    record = {
        "boxes": np.asarray(det.boxes[0])[valid].round(5).tolist(),
        "scores": np.asarray(det.scores[0])[valid].round(5).tolist(),
        "classes": np.asarray(det.classes[0])[valid].tolist(),
    }
    return record, from_jax_variables(jax.tree_util.tree_map(
        np.asarray, variables))


def _assert_records_match(got, want):
    assert len(got["scores"]) == len(want["scores"]) > 0
    assert got["classes"] == want["classes"]
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=DET_ATOL)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=DET_ATOL)


def _port_record(cfg, weights, image):
    model = build_model(cfg.model, "cpu", seed=None, dtype=torch.float32)
    model.load_state_dict(weights, strict=True)
    return c1.detection_record(model, cfg, image, "cpu")


def test_record_at_thin_widths_matches_jaxs():
    """A 96 x 128 image (resized to 128 px) through config 1's path at thin
    widths, JAX-initialised: the same detections, in the same order."""
    image = np.random.default_rng(0).uniform(0, 255, (96, 128, 3)).astype(
        np.float32)
    want, weights = _jax_record(_thin(jax_lighthead_resnet50(128)), image)
    got = _port_record(_thin(lighthead_resnet50(128)), weights, image)
    assert got["config"] == "lighthead_resnet50_128px_cpu"
    assert got["image"] == c1.SYNTHETIC
    _assert_records_match(got, want)


@pytest.mark.slow  # config 1's full ResNet-50 at 800 px in both packages
def test_record_at_800px_matches_jaxs(capsys):
    """The JAX tool's default input, the synthetic 600 x 800 image, at
    config 1's full width and 800 px: the same count and classes, scores
    within DET_ATOL, and the record passes the JAX tool's own ``--compare``
    rules. (Its boxes are not held to DET_ATOL: through ResNet-50's 53
    layers of random weights at 800 px the box codes decode 6.9e-4 apart
    at most, in 10 of 80 coordinates, first measured here.)"""
    image = c1.synthetic_image()
    want, weights = _jax_record(jax_lighthead_resnet50(800), image)
    got = _port_record(lighthead_resnet50(800), weights, image)
    assert got["config"] == "lighthead_resnet50_800px_cpu"
    assert len(got["scores"]) == len(want["scores"]) > 0
    assert got["classes"] == want["classes"]
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=DET_ATOL)
    assert c1.compare(got, want)
    print(capsys.readouterr().out)


def test_synthetic_image_is_the_jax_tools():
    img = c1.synthetic_image()
    assert img.shape == (600, 800, 3) and img.dtype == np.float32
    np.testing.assert_array_equal(img, np.random.default_rng(0).uniform(
        0, 255, (600, 800, 3)).astype(np.float32))


REF = {"config": "c", "image": "i",
       "boxes": [[0.1, 0.2, 0.3, 0.4], [0.5, 0.5, 0.9, 0.9]],
       "scores": [0.9, 0.5], "classes": [3, 7]}


def _moved(**change):
    out = json.loads(json.dumps(REF))
    for key, (i, value) in change.items():
        out[key][i] = value
    return out


@pytest.mark.parametrize("record, printed", [
    (dict(REF, scores=[0.9], boxes=REF["boxes"][:1], classes=[3]),
     "DETECTION COUNT MISMATCH: 1 vs 2"),
    (_moved(boxes=(1, [0.5, 0.5, 0.9, 0.92])), "det 1: box_d=0.0200"),
    (_moved(scores=(0, 0.87)), "det 0: box_d=0.0000 score_d=0.0300"),
    (_moved(classes=(1, 8)), "cls 8 vs 7")],
    ids=["count", "box", "score", "class"])
def test_compare_fails_on_each_kind(record, printed, capsys):
    assert c1.compare(record, REF) is False
    out = capsys.readouterr().out
    assert printed in out and out.rstrip().endswith("PARITY FAILED")


def test_compare_passes_within_the_tolerances(capsys):
    near = _moved(boxes=(0, [0.105, 0.2, 0.3, 0.4]), scores=(1, 0.51))
    assert c1.compare(near, REF) is True
    out = capsys.readouterr().out
    assert "lowest kept score (the cut): 0.51000 vs 0.50000" in out
    assert out.rstrip().endswith("PARITY OK")


def test_main_writes_the_record_and_compare_sets_the_exit_code(
        tmp_path, monkeypatch, capsys):
    """``main`` at thin widths (the preset patched): the JSON record, then
    ``--compare`` against it (exit 0) and against a record with one class
    changed (exit 1)."""
    monkeypatch.setattr(c1, "lighthead_resnet50",
                        lambda image_size: _thin(lighthead_resnet50(128)))
    first = tmp_path / "a.json"
    assert c1.main(["--device", "cpu", "--out", str(first)]) == 0
    record = json.loads(first.read_text())
    assert set(record) == {"config", "image", "boxes", "scores", "classes"}
    assert record["image"] == c1.SYNTHETIC and record["scores"]
    assert c1.main(["--device", "cpu", "--out", str(tmp_path / "b.json"),
                    "--compare", str(first)]) == 0
    record["classes"][0] += 1
    moved = tmp_path / "moved.json"
    moved.write_text(json.dumps(record))
    assert c1.main(["--device", "cpu", "--out", str(tmp_path / "c.json"),
                    "--compare", str(moved)]) == 1
    assert capsys.readouterr().out.rstrip().endswith("PARITY FAILED")
