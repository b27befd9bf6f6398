"""The port's ResNet-50 pieces and config 1's Light-Head on ResNet against
the JAX package.

JAX initialises each module; ``from_jax_variables`` carries the weights
across, with the BatchNorm statistics and affine moved off their initial
values (``perturb_bn``) so that the folded affine is not the identity. Both
sides run fp32 on the CPU over the same numpy-seeded inputs. Tolerances:
pooling is exact (a max of the same values); convolutions sum the same
products in another order, held to 1e-5 of the output's scale; the whole
Light-Head forward to the golden test's ATOL 2e-4 / rtol 1e-3 as
``tests/test_torch_lighthead.py`` holds it, and its detections equal in
classes and ``valid``, boxes and scores within 1e-4.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from test_golden import ATOL  # noqa: E402
from test_lighthead import tiny_config  # noqa: E402
from x_detector_tpu.cli import evaluate as jax_evaluate  # noqa: E402
from x_detector_tpu.config import lighthead_resnet50  # noqa: E402
from x_detector_tpu.models import layers as jax_layers  # noqa: E402
from x_detector_tpu.models import lighthead as L  # noqa: E402
from x_detector_tpu.models import resnet as jax_resnet  # noqa: E402
from x_detector_tpu.ops.pallas.psroi_align_kernel import (  # noqa: E402
    batched_psroi_align_pallas)
from x_detector_tpu_torch import inference  # noqa: E402
from x_detector_tpu_torch.models import layers, resnet  # noqa: E402
from x_detector_tpu_torch.models.lighthead import LightHeadRCNN  # noqa: E402
from x_detector_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

REL_TOL = 1e-5          # of the output's scale, fp32 convolutions
RTOL = 1e-3
STAGES = (1, 1, 1, 1)
WIDTHS = (8, 16, 24, 32)


def jax_init(module, *args, seed=7):
    """Numpy variables of ``module`` (jitted init, inference mode)."""
    variables = jax.jit(lambda k: module.init(k, *args, train=False))(
        jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, variables)


def perturb_bn(variables, seed=11):
    """A copy of flax ``variables`` with every BatchNorm's scale, bias,
    running mean and variance moved by seeded noise."""
    rng = np.random.default_rng(seed)

    def walk(tree, stats):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict) or hasattr(value, "items"):
                out[key] = walk(value, stats or key == "bn")
            elif key in ("mean", "scale", "bias") and stats:
                out[key] = (value + 0.1 * rng.normal(0, 1, value.shape)
                            ).astype(np.float32)
            elif key == "var" and stats:
                out[key] = (value * (1.0 + 0.5 * rng.uniform(
                    0, 1, value.shape))).astype(np.float32)
            else:
                out[key] = value
        return out

    return {"params": walk(variables["params"], False),
            "batch_stats": walk(variables["batch_stats"], True)}


def assert_close_to_scale(got, ref, rel=REL_TOL, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3g} > {rel} x " \
                               f"scale {scale:.3g}"


def nhwc(t):
    return t.permute(0, 2, 3, 1)


@pytest.mark.parametrize("window,stride", [(3, 2), (3, 1), (2, 2)])
@pytest.mark.parametrize("h,w", [(16, 16), (15, 13)])
@pytest.mark.parametrize("explicit_pad", [True, False])
def test_max_pool_matches_jax(h, w, window, stride, explicit_pad):
    """Exactly equal, at even and odd sizes: all-negative inputs, so a
    padding that entered a max would show."""
    x = (-1.0 - np.random.default_rng(h * w).uniform(0, 1, (2, h, w, 5))
         ).astype(np.float32)
    ref = np.asarray(jax_layers.max_pool(jnp.asarray(x), window, stride,
                                         explicit_pad=explicit_pad))
    got = layers.max_pool(torch.from_numpy(x).permute(0, 3, 1, 2), window,
                          stride, explicit_pad=explicit_pad)
    np.testing.assert_array_equal(nhwc(got).numpy(), ref)


@pytest.mark.parametrize("cin,features,strides,dilation,size", [
    (16, 4, (2, 2), (1, 1), 16),    # stride 2: proj at stride 2
    (16, 4, (2, 2), (1, 1), 15),    # stride 2 at an odd size
    (8, 4, (1, 1), (2, 2), 11),     # dilation 2, proj for the width
    (16, 4, (1, 1), (1, 1), 9),     # identity shortcut
])
def test_bottleneck_matches_jax(cin, features, strides, dilation, size):
    x = np.random.default_rng(size).normal(0, 1, (2, size, size, cin)
                                           ).astype(np.float32)
    module = jax_resnet.Bottleneck(features, strides=strides,
                                   dilation=dilation, dtype=jnp.float32)
    variables = perturb_bn(jax_init(module, jnp.asarray(x)))
    ref = module.apply(variables, jnp.asarray(x), train=False)
    port = resnet.Bottleneck(cin, features, strides=strides,
                             dilation=dilation, dtype=torch.float32).eval()
    port.load_state_dict(from_jax_variables(variables), strict=True)
    assert (port.proj is None) == (cin == 4 * features and strides == (1, 1))
    with torch.inference_mode():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert_close_to_scale(nhwc(got), ref, what="bottleneck")


@pytest.mark.parametrize("dilate_c5,size", [(True, 64), (False, 64),
                                            (True, 72), (False, 70)])
def test_resnet_matches_jax(dilate_c5, size):
    """c3, c4 and c5 at strides 8, 16 and 16 dilated or 32, at sizes that
    round up at each stride (70: 35, 18, 9, 5, 3 pixels)."""
    x = (np.random.default_rng(1).normal(0, 1, (2, size, size, 3)) * 0.5
         ).astype(np.float32)
    module = jax_resnet.ResNetV1(stage_sizes=STAGES, widths=WIDTHS,
                                 dilate_c5=dilate_c5, dtype=jnp.float32)
    variables = perturb_bn(jax_init(module, jnp.asarray(x)))
    ref = module.apply(variables, jnp.asarray(x), train=False)
    port = resnet.ResNetV1(STAGES, WIDTHS, dilate_c5=dilate_c5,
                           dtype=torch.float32).eval()
    port.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert set(got) == set(ref) == {"c3", "c4", "c5"}
    for key in ref:
        assert got[key].shape[1] == port.feature_widths[key]
        assert_close_to_scale(nhwc(got[key]), ref[key], what=key)
    stride5 = 16 if dilate_c5 else 32
    assert ref["c5"].shape[1] == -(-size // stride5)


def test_resnet50_has_the_published_shape():
    """Stages [3, 4, 6, 3], c3/c4/c5 of 512/1024/2048 channels, and the
    parameter count of the JAX model (torchvision's ResNet-50 trunk:
    23.5 M without its classifier)."""
    port = resnet.resnet50()
    assert port.stage_sizes == (3, 4, 6, 3)
    assert port.feature_widths == {"c3": 512, "c4": 1024, "c5": 2048}
    n = sum(p.numel() for p in port.parameters())
    jax_vars = jax.eval_shape(
        lambda k: jax_resnet.resnet50(dtype=jnp.float32).init(
            k, jnp.zeros((1, 64, 64, 3)), train=False),
        jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(v.shape)) for v in
                    jax.tree_util.tree_leaves(jax_vars["params"]))


def tiny_resnet_config():
    """Config 1's Light-Head on a thin ResNet: stages (1, 1, 1, 1) of
    widths 8-32, so c4 has 96 channels and c5 128, at 64 px."""
    return dataclasses.replace(tiny_config("resnet50"),
                               backbone_stages=STAGES, backbone_widths=WIDTHS)


@pytest.fixture(scope="module")
def resnet_slice():
    """The JAX Light-Head on ResNet (pooling with the PSROIAlign kernel,
    interpret mode, as the port pools in fp32), its outputs and
    detections through JAX's ``build_eval_fn``, and the port with the same
    weights."""
    cfg = tiny_resnet_config()
    images = (np.random.default_rng(3).normal(0, 1, (2, 64, 64, 3)) * 0.3
              ).astype(np.float32)
    model = L.LightHeadRCNN(config=cfg, dtype=jnp.float32)
    variables = perturb_bn(jax_init(model, images))
    exp = dataclasses.replace(lighthead_resnet50(64), model=cfg)
    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call",
               functools.partial(pl.pallas_call, interpret=True))
    mp.setattr(L, "batched_psroi_align", batched_psroi_align_pallas)
    try:
        out = jax.jit(lambda v: model.apply(v, images, train=False))(
            variables)
        det = jax_evaluate.build_eval_fn(model, exp)(variables, images)
    finally:
        mp.undo()
    port = LightHeadRCNN(cfg, dtype=torch.float32).eval()
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return (exp, images, {k: np.asarray(v) for k, v in out.items()},
            [np.asarray(t) for t in det], port)


def test_lighthead_builds_from_the_backbones_output_widths(resnet_slice):
    """The RPN and the thin map take c4's and c5's channels, 4 x the
    stage widths on ResNet (they took the stage widths before)."""
    port = resnet_slice[-1]
    assert port.rpn.conv.Conv_0.in_channels == 4 * WIDTHS[2]
    assert port.thin_map.col_a.in_channels == 4 * WIDTHS[3]
    assert port.thin_map.row_a.in_channels == 4 * WIDTHS[3]


def test_lighthead_resnet_outputs_match_jax(resnet_slice):
    _, images, ref, _, port = resnet_slice
    with torch.inference_mode():
        got = port(torch.from_numpy(images))
    assert set(got) == set(ref)
    assert ref["proposal_valid"].any()
    for key in ref:
        if ref[key].dtype == bool:
            np.testing.assert_array_equal(got[key].numpy(), ref[key],
                                          err_msg=key)
        else:
            np.testing.assert_allclose(got[key].numpy(), ref[key], atol=ATOL,
                                       rtol=RTOL, err_msg=key)


def test_lighthead_resnet_build_eval_fn_matches_jax(resnet_slice):
    """``inference.build_eval_fn`` against JAX's ``cli/evaluate``
    ``build_eval_fn`` on the same weights and images: the same valid slots
    and classes; boxes and scores within 1e-4."""
    exp, images, _, ref, port = resnet_slice
    boxes, scores, classes, valid = inference.build_eval_fn(
        port, exp, "cpu")(torch.from_numpy(images))
    assert ref[3].sum() > 0
    np.testing.assert_array_equal(valid.numpy(), ref[3])
    np.testing.assert_array_equal(classes.numpy(), ref[2])
    np.testing.assert_allclose(boxes.numpy(), ref[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(scores.numpy(), ref[1], atol=1e-4, rtol=0)


def test_build_model_resnet_is_seeded_flax_like():
    """``build_model`` on ResNet: reproducible from its seed, BatchNorm at
    identity, kernels at flax's lecun-normal scale."""
    cfg = tiny_resnet_config()
    a = inference.build_model(cfg, "cpu", seed=2,
                              dtype=torch.float32).state_dict()
    b = inference.build_model(cfg, "cpu", seed=2,
                              dtype=torch.float32).state_dict()
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], atol=0, rtol=0)
    assert (a["backbone.stage4_block0.ConvBN_2.bn.running_var"] == 1).all()
    w = a["backbone.stage3_block0.proj.Conv_0.weight"]     # fan_in 64
    assert abs(w.std().item() * 64 ** 0.5 - 1.0) < 0.2
