"""The port's SSD / X-Det family (configs 2 and ``xdet_xception``) against
the JAX package.

Weights come from JAX's init through ``from_jax_variables``, BatchNorms
moved off identity (``test_torch_resnet.perturb_bn``); both sides run fp32
on the CPU over the same numpy-seeded images, JAX's fused separable conv in
Pallas interpret mode (its own default on the CPU). Tolerances: anchors
exactly equal; raw ``cls_logits`` / ``box_codes`` within 1e-5 of their
scale (the same sums in another order); detections equal in classes and
``valid``, boxes and scores within 1e-5.

With random weights every SSD score sits near 1/21, where JAX's and
torch's fp32 softmax, an ulp apart on some inputs, may order near-ties
differently. The models are therefore compared on their raw outputs, and
the detection tests feed class logits whose scores are either well apart
(constructed log-probabilities) or exactly tied (a head whose class convs
carry only distinct biases).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_resnet import (assert_close_to_scale, jax_init,  # noqa: E402
                               perturb_bn)
from x_detector_tpu.cli import evaluate as jax_evaluate  # noqa: E402
from x_detector_tpu.config import (SSDAnchorConfig,  # noqa: E402
                                   lighthead_resnet50, ssd_resnet50,
                                   xdet_xception)
from x_detector_tpu.data.augment import (  # noqa: E402
    preprocess_for_eval as jax_preprocess)
from x_detector_tpu.models import detector as jax_detector  # noqa: E402
from x_detector_tpu.models import ssd as jax_ssd  # noqa: E402
from x_detector_tpu.ops import anchors as jax_anchors  # noqa: E402
from x_detector_tpu_torch import inference  # noqa: E402
from x_detector_tpu_torch.data.augment import (  # noqa: E402
    _resize_weights as resize_weights, preprocess_for_eval)
from x_detector_tpu_torch.models.detector import (  # noqa: E402
    postprocess_detections)
from x_detector_tpu_torch.models.ssd import SSDModel  # noqa: E402
from x_detector_tpu_torch.models.layers import (  # noqa: E402
    prepare_for_inference)
from x_detector_tpu_torch.ops import anchors as port_anchors  # noqa: E402
from x_detector_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

DET_TOL = 1e-5


def small_configs():
    """Config 2 on a thin ResNet at 64 px, and ``xdet_xception`` (top-down
    fusion, the fused backbone) on a thin Xception-lite at 128 px, where
    every stage is tall enough for JAX's Pallas row bands."""
    ssd = ssd_resnet50(64)
    xdet = xdet_xception(128)
    return {
        "ssd_resnet50": dataclasses.replace(ssd, model=dataclasses.replace(
            ssd.model, backbone_stages=(1, 1, 1, 1),
            backbone_widths=(8, 16, 24, 32))),
        "xdet_xception": dataclasses.replace(xdet, model=dataclasses.replace(
            xdet.model, backbone_stages=(1, 1, 1, 1),
            backbone_widths=(16, 32, 48, 64), backbone_fused_sepconv=True)),
    }


@pytest.fixture(scope="module", params=["ssd_resnet50", "xdet_xception"])
def ssd_pair(request):
    """(experiment config, images, JAX module, its variables, the port with
    the same weights)."""
    exp = small_configs()[request.param]
    size = exp.model.image_size
    images = (np.random.default_rng(5).normal(0, 1, (2, size, size, 3)) * 0.5
              ).astype(np.float32)
    module = jax_ssd.SSDModel(config=exp.model, dtype=jnp.float32)
    variables = perturb_bn(jax_init(module, jnp.asarray(images)))
    port = SSDModel(exp.model, dtype=torch.float32).eval()
    port.load_state_dict(from_jax_variables(variables), strict=True)
    prepare_for_inference(port)
    return exp, images, module, variables, port


@pytest.mark.parametrize("size", [512, 300, 64])
def test_ssd_anchors_equal_jax(size):
    cfg = SSDAnchorConfig()
    ref = jax_anchors.ssd_anchors(size, cfg)
    got = port_anchors.ssd_anchors(size, cfg)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    counts = port_anchors.ssd_layer_anchor_counts(size, cfg)
    assert counts == jax_anchors.ssd_layer_anchor_counts(size, cfg)
    assert sum(counts) == got.shape[0]
    if size == 512:
        assert got.shape[0] == 32736       # 64^2 + ... + 4^2 cells x 6


def test_ssd_model_outputs_match_jax(ssd_pair):
    exp, images, module, variables, port = ssd_pair
    ref = module.apply(variables, jnp.asarray(images), train=False)
    with torch.inference_mode():
        got = port(torch.from_numpy(images))
    assert port.anchors.shape[0] == got[0].shape[1]
    assert got[0].dtype == got[1].dtype == torch.float32
    for g, r, key in zip(got, ref, ("cls_logits", "box_codes")):
        assert_close_to_scale(g, r, what=key)


def test_ssd_model_builds_the_xdet_modules():
    """``fpn_fusion`` adds five laterals and fuse convs; the fused backbone
    routes its 13 stride-1 separable blocks at 512 px (stage 4 at stride
    32, not dilated) through kernel B2's wrapper."""
    exp = xdet_xception(512)
    model = SSDModel(dataclasses.replace(exp.model,
                                         backbone_fused_sepconv=True)).eval()
    names = {n for n, _ in model.named_children()}
    assert {f"lateral{i}" for i in range(5)} <= names
    assert {f"fuse{i}" for i in range(5)} <= names
    from x_detector_tpu_torch.models.layers import SeparableConvBN
    fused = [m for m in model.modules()
             if isinstance(m, SeparableConvBN) and m.takes_fused_route]
    assert len(fused) == 13


def _head_with_distinct_class_biases(variables, seed=0):
    """``variables`` with every head class conv's kernel zeroed and its
    biases a permutation of evenly spaced values: each anchor's class
    scores are then exactly equal across the cells of a level (in both
    frameworks) and well apart otherwise."""
    rng = np.random.default_rng(seed)
    head = dict(variables["params"]["head"])
    for name in [k for k in head if k.startswith("cls")]:
        n = head[name]["bias"].shape[0]
        head[name] = {"kernel": np.zeros_like(head[name]["kernel"]),
                      "bias": rng.permutation(np.linspace(-3, 3, n)
                                              ).astype(np.float32)}
    params = dict(variables["params"], head=head)
    return {"params": params, "batch_stats": variables["batch_stats"]}


def test_ssd_build_eval_fn_matches_jax(ssd_pair):
    """``inference.build_eval_fn`` (family "ssd") against JAX's
    ``cli/evaluate.build_eval_fn`` on the same weights and images. The
    scores tie exactly across cells, and on ties JAX's batched
    ``approx_max_k`` (its exact fallback on the CPU) picks other candidates
    than ``lax.top_k``; so both sides run the exact prefilter here, and
    ``approx_prefilter`` is held to JAX on distinct scores below and in
    ``tests/test_torch_nms.py``."""
    exp, images, module, variables, _ = ssd_pair
    exp = dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, nms=dataclasses.replace(exp.model.nms,
                                           approx_prefilter=False)))
    variables = _head_with_distinct_class_biases(variables)
    ref = jax_evaluate.build_eval_fn(module, exp)(variables,
                                                  jnp.asarray(images))
    port = inference.build_model(exp.model, "cpu", seed=None,
                                 dtype=torch.float32)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    got = inference.build_eval_fn(port, exp, "cpu")(torch.from_numpy(images))
    valid = np.asarray(ref[3])
    assert valid.sum() > 0
    np.testing.assert_array_equal(got[3].numpy(), valid)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=DET_TOL,
                                   rtol=0)


def separated_logits(rng, b, n, c):
    """[b, n, c+1] logits whose softmax gives each image's n x c
    foreground scores distinct values at least 0.2 / (n c) apart: the logs
    of a permuted grid, the background taking the rest of each row's mass.
    JAX's and torch's softmax agree to ~1e-7 there, so no order can flip."""
    step = 0.2 / (n * c)
    fg = np.stack([rng.permutation(np.arange(1, n * c + 1) * step)
                   for _ in range(b)]).reshape(b, n, c)
    probs = np.concatenate([1.0 - fg.sum(-1, keepdims=True), fg], axis=-1)
    return np.log(probs).astype(np.float32)


@pytest.mark.parametrize("per_class_boxes", [False, True])
@pytest.mark.parametrize("approx_prefilter", [False, True])
def test_postprocess_detections_matches_jax(per_class_boxes,
                                            approx_prefilter):
    """Separated scores, random codes against random anchors, 300 anchors
    (past the 256 NMS candidates, so the prefilter runs) and 5 classes +
    background."""
    rng = np.random.default_rng(4)
    b, n, c = 2, 300, 5
    lo = rng.uniform(0, 0.8, (n, 2))
    anchors = np.concatenate([lo, lo + rng.uniform(0.05, 0.3, (n, 2))],
                             axis=1).astype(np.float32)
    logits = separated_logits(rng, b, n, c)
    shape = (b, n, c, 4) if per_class_boxes else (b, n, 4)
    codes = rng.normal(0, 1, shape).astype(np.float32)
    # at most 5 x 20 survivors in 120 slots: the padded tail is compared too
    kw = dict(max_output=120, iou_threshold=0.45, score_threshold=0.17,
              per_class_topk=20, approx_prefilter=approx_prefilter)
    ref = jax_detector.postprocess_detections(
        jnp.asarray(codes), jnp.asarray(logits), jnp.asarray(anchors), **kw)
    got = postprocess_detections(torch.from_numpy(codes),
                                 torch.from_numpy(logits),
                                 torch.from_numpy(anchors), **kw)
    assert got.valid.any() and not got.valid[:, 5 * 20:].any()
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(ref.classes))
    for g, r in ((got.boxes, ref.boxes), (got.scores, ref.scores)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=DET_TOL,
                                   rtol=0)


def test_postprocess_detections_fast_mode_raises():
    with pytest.raises(NotImplementedError, match="MaxpoolNMS"):
        postprocess_detections(torch.zeros(1, 4, 4), torch.zeros(1, 4, 3),
                               torch.zeros(4, 4), fast_mode=True)


def test_training_the_ssd_family_is_refused():
    """``create_model_and_state`` builds both SSD presets in training mode
    (it refused them until the SSD step was ported; the name stays), with
    the EMA shadow config 2 asks for and none for xdet_xception, whose
    fused blocks then take the unfused route."""
    from x_detector_tpu_torch.models.layers import SeparableConvBN
    from x_detector_tpu_torch.train.trainer import create_model_and_state
    for preset, ema in (("ssd_resnet50", True), ("xdet_xception", False)):
        state = create_model_and_state(small_configs()[preset], "cpu",
                                       seed=0, dtype=torch.float32)
        assert isinstance(state.model, SSDModel) and state.model.training
        assert (state.ema_params is not None) == ema, preset
        assert not any(m.takes_fused_route for m in state.model.modules()
                       if isinstance(m, SeparableConvBN))


def test_preprocess_for_eval_resizes_a_voc_image_like_jax():
    """One VOC-sized uint8 image (375 x 500) to config 1's 800 px canvas:
    the full-image bilinear resize and the whitening. Held to a float64
    evaluation of the same resize within 1e-5 of the pixel scale (255), and
    to JAX within the a-priori bound of two fp32 contractions of up to 500
    terms, 2 * 500 * 2^-24 * 255 (JAX's einsum on the CPU sits 5.9e-3 from
    the float64 value, the port 2.7e-5)."""
    cfg = lighthead_resnet50(800).data
    u8 = np.random.default_rng(6).integers(0, 256, (375, 500, 3),
                                           dtype=np.uint8)
    ref = np.asarray(jax_preprocess(jnp.asarray(u8), cfg))
    got = preprocess_for_eval(torch.from_numpy(u8), cfg)
    assert got.shape == (800, 800, 3) and got.dtype == torch.float32
    wy, wx = (resize_weights(torch.zeros(1), torch.ones(1), 800, extent
                             )[0].double().numpy() for extent in (375, 500))
    exact = (np.einsum("qw,pwc->pqc", wx, np.einsum(
        "ph,hwc->pwc", wy, u8.astype(np.float64)))
        - np.asarray(cfg.pixel_means))
    np.testing.assert_allclose(got.numpy(), exact, atol=1e-5 * 255, rtol=0)
    np.testing.assert_allclose(got.numpy(), ref, atol=2 * 500 * 2.0 ** -24
                               * 255, rtol=0)
    batched = preprocess_for_eval(torch.from_numpy(np.stack([u8, u8])), cfg)
    assert batched.shape == (2, 800, 800, 3)
    np.testing.assert_allclose(batched[1].numpy(), got.numpy(),
                               atol=1e-5 * 255, rtol=0)


def test_build_eval_fn_refuses_another_device_or_family():
    """The device stays explicit: a model on the CPU is not run on "cuda";
    and a config's family must match the model's class."""
    exp = small_configs()["ssd_resnet50"]
    model = inference.build_model(exp.model, "cpu", seed=0,
                                  dtype=torch.float32)
    with pytest.raises(ValueError, match="not on cuda"):
        inference.build_eval_fn(model, exp, "cuda")
    with pytest.raises(TypeError, match="LightHeadRCNN"):
        inference.build_eval_fn(model, lighthead_resnet50(64), "cpu")
