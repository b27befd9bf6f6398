"""The port's Light-Head + Xception-lite slice against the JAX package.

The tiny config of ``tests/test_lighthead.py`` (full-width Xception-lite at
64 px) with ``backbone_fused_sepconv=True``, batch 2. JAX initialises the
weights with ``PRNGKey(7)``; ``from_jax_variables`` carries them over; both
run fp32 on the CPU over the same numpy-seeded images.

JAX's Light-Head pools with its bf16 einsum (``psroi_align(precise=False)``)
where the port pools in fp32, the operation of the PSROIAlign kernel
``psroi_align_pallas`` (``precise=True``). The model comparison therefore
has the JAX model pool with that kernel (interpret mode): every output is
then held to the golden test's tolerances (ATOL 2e-4, rtol 1e-3).
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from test_golden import ATOL, GOLDEN_DIR  # noqa: E402
from test_lighthead import tiny_config  # noqa: E402
from x_detector_tpu.config import lighthead_xception  # noqa: E402
from x_detector_tpu.data.augment import (  # noqa: E402
    preprocess_for_eval as jax_preprocess)
from x_detector_tpu.models import lighthead as L  # noqa: E402
from x_detector_tpu.ops.pallas.psroi_align_kernel import (  # noqa: E402
    batched_psroi_align_pallas)
from x_detector_tpu_torch.data.augment import preprocess_for_eval  # noqa: E402
from x_detector_tpu_torch import inference  # noqa: E402
from x_detector_tpu_torch.models.layers import (  # noqa: E402
    prepare_for_inference)
from x_detector_tpu_torch.models.lighthead import (  # noqa: E402
    LightHeadRCNN, lighthead_postprocess)
from x_detector_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

RTOL = 1e-3


def _jax_variables(model, x):
    variables = jax.jit(lambda k: model.init(k, x, train=False))(
        jax.random.PRNGKey(7))
    return jax.tree_util.tree_map(np.asarray, variables)


def _port(cfg, variables):
    model = LightHeadRCNN(cfg, dtype=torch.float32).eval()
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def fused_slice():
    """JAX outputs of the fused tiny slice (pooling with the PSROIAlign
    kernel) and the port with the same weights."""
    cfg = dataclasses.replace(tiny_config("xception_lite"),
                              backbone_fused_sepconv=True)
    images = (np.random.default_rng(3).normal(0, 1, (2, 64, 64, 3)) * 0.3
              ).astype(np.float32)
    model = L.LightHeadRCNN(config=cfg, dtype=jnp.float32)
    variables = _jax_variables(model, images)
    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call",
               functools.partial(pl.pallas_call, interpret=True))
    mp.setattr(L, "batched_psroi_align", batched_psroi_align_pallas)
    try:
        out = jax.jit(lambda v: model.apply(v, images, train=False))(
            variables)
        det = L.lighthead_postprocess(out, cfg)
    finally:
        mp.undo()
    ref = {k: np.asarray(v) for k, v in out.items()}
    return cfg, images, variables, ref, det, _port(cfg, variables)


def _assert_outputs_close(got, ref, atol=ATOL, rtol=RTOL, keys=None):
    for key in keys or ref:
        g = got[key].numpy()
        assert g.shape == ref[key].shape, key
        if ref[key].dtype == bool:
            np.testing.assert_array_equal(g, ref[key], err_msg=key)
        else:
            np.testing.assert_allclose(g, ref[key], atol=atol, rtol=rtol,
                                       err_msg=key)


def test_fused_slice_outputs_match_jax(fused_slice):
    cfg, images, _, ref, _, port = fused_slice
    prepare_for_inference(port)
    with torch.inference_mode():
        got = port(torch.from_numpy(images))
    assert set(got) == set(ref)
    assert ref["proposal_valid"].any()
    _assert_outputs_close(got, ref)


def test_fused_slice_detections_match_jax(fused_slice):
    """build_eval_fn end to end: same valid count and classes; boxes and
    scores within 1e-4 (fp32 through ~40 layers, then exact NMS)."""
    cfg, images, _, _, det, port = fused_slice
    exp = dataclasses.replace(lighthead_xception(64), model=cfg)
    detect = inference.build_eval_fn(port, exp, "cpu")
    boxes, scores, classes, valid = detect(torch.from_numpy(images))
    valid_ref = np.asarray(det.valid)
    assert valid_ref.sum() > 0
    np.testing.assert_array_equal(valid.numpy(), valid_ref)
    np.testing.assert_array_equal(classes.numpy(), np.asarray(det.classes))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(det.boxes),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(scores.numpy(), np.asarray(det.scores),
                               atol=1e-4, rtol=0)


def test_postprocess_per_class_boxes_match_jax(fused_slice):
    """The per-class box branch of lighthead_postprocess on the same
    outputs, with random per-class codes."""
    cfg, _, _, ref, _, _ = fused_slice
    outs = dict(ref)
    outs["roi_box"] = np.random.default_rng(0).normal(
        0, 1, ref["roi_box"].shape[:2] + (cfg.num_classes, 4)
    ).astype(np.float32)
    want = L.lighthead_postprocess({k: jnp.asarray(v)
                                    for k, v in outs.items()}, cfg)
    got = lighthead_postprocess({k: torch.from_numpy(v)
                                 for k, v in outs.items()}, cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy().astype(np.float32),
                                   np.asarray(w).astype(np.float32),
                                   atol=1e-5, rtol=0)


def test_fused_and_unfused_port_agree(fused_slice):
    """The same weights through the port's unfused separable path."""
    cfg, images, variables, ref, _, _ = fused_slice
    unfused = _port(dataclasses.replace(cfg, backbone_fused_sepconv=False),
                    variables)
    with torch.inference_mode():
        got = unfused(torch.from_numpy(images))
    _assert_outputs_close(got, ref)


def test_unfused_forward_matches_golden():
    """The port on the golden test's model, input and weights, against
    ``tests/golden/lighthead_tiny_forward.npz``. The golden roi outputs were
    pooled by JAX's bf16 einsum (operands rounded to 8 significant bits:
    2.2e-4 measured against an fp32 pooling), so they are held at 1e-3;
    every other output at the golden test's own ATOL 2e-4 / rtol 1e-3."""
    cfg = tiny_config("xception_lite")
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(42),
                                     (1, 64, 64, 3)) * 0.3)
    variables = _jax_variables(L.LightHeadRCNN(config=cfg, dtype=jnp.float32),
                               x)
    with torch.inference_mode():
        got = _port(cfg, variables)(torch.from_numpy(x))
    ref = dict(np.load(os.path.join(GOLDEN_DIR, "lighthead_tiny_forward.npz")))
    assert set(ref) == set(got)
    roi = {"roi_cls", "roi_box"}
    _assert_outputs_close(got, ref, keys=set(ref) - roi)
    _assert_outputs_close(got, ref, atol=1e-3, keys=roi)


def test_preprocess_for_eval_matches_jax():
    cfg = lighthead_xception(32).data
    u8 = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3),
                                           dtype=np.uint8)
    ref = np.stack([np.asarray(jax_preprocess(jnp.asarray(im), cfg))
                    for im in u8])
    got = preprocess_for_eval(torch.from_numpy(u8), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    # another size than the canvas is resized to it, as JAX does (two fp32
    # contractions of up to 32 terms in another order: 1e-4 on [0, 255])
    small = u8[:, :16]
    ref = np.stack([np.asarray(jax_preprocess(jnp.asarray(im), cfg))
                    for im in small])
    got = preprocess_for_eval(torch.from_numpy(small), cfg)
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def test_build_model_seeded_init_is_flax_like():
    """Seeded random init: reproducible, zero biases, BN identity, and
    kernels at flax's lecun-normal scale."""
    cfg = dataclasses.replace(tiny_config("xception_lite"),
                              backbone_widths=(8, 16, 24, 32))
    a = inference.build_model(cfg, "cpu", seed=1,
                                dtype=torch.float32).state_dict()
    b = inference.build_model(cfg, "cpu", seed=1,
                                dtype=torch.float32).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], atol=0, rtol=0)
    assert not a["roi_head.fc.bias"].any()
    assert (a["backbone.stem.bn.running_var"] == 1).all()
    w = a["backbone.stage4.sep0b.Conv_1.weight"]           # fan_in 32
    assert abs(w.std().item() * 32 ** 0.5 - 1.0) < 0.15
