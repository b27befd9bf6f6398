"""The port's export boundary: the ``xdt`` operators, the prepare step, and
programs exported with ``torch.export`` against eager inference and against
the JAX package's export ``serving_fn``.

Tiny models on the CPU, where every operator runs its plain version: the
exported programs (and their ``torch.export.save`` / ``load`` round trips)
must give eager inference's bits. The JAX side runs as its own tests run it:
on the CPU, Pallas in interpret mode.
"""

import dataclasses
import functools
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from test_lighthead import tiny_config  # noqa: E402
from test_train import get_batch, small_lighthead_cfg  # noqa: E402
from x_detector_tpu.cli.evaluate import (  # noqa: E402
    build_eval_fn as jax_build_eval_fn)
from x_detector_tpu.config import lighthead_xception as jax_lh  # noqa: E402
from x_detector_tpu.data.augment import (  # noqa: E402
    preprocess_for_eval as jax_preprocess)
from x_detector_tpu.models import lighthead as L  # noqa: E402
from x_detector_tpu.ops.pallas.psroi_align_kernel import (  # noqa: E402
    batched_psroi_align_pallas)
from x_detector_tpu_torch import config as C  # noqa: E402
from x_detector_tpu_torch import quant, serving  # noqa: E402
from x_detector_tpu_torch.cli import export  # noqa: E402
from x_detector_tpu_torch.data.augment import preprocess_for_eval  # noqa: E402
from x_detector_tpu_torch.inference import (  # noqa: E402
    ServingModule, build_eval_fn, build_model, unscale_boxes)
from x_detector_tpu_torch.models.layers import (  # noqa: E402
    QuantConv, SeparableConvBN, prepare_for_inference)
from x_detector_tpu_torch.ops import fused_sepconv as F  # noqa: E402
from x_detector_tpu_torch.ops import int8_conv as Q  # noqa: E402
from x_detector_tpu_torch.ops import library, nms  # noqa: E402
from x_detector_tpu_torch.ops import psroi_align as P  # noqa: E402
from x_detector_tpu_torch.train.trainer import (  # noqa: E402
    create_model_and_state, make_train_step)
from x_detector_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

# detections of the tiny Light-Head against JAX's, as
# tests/test_torch_lighthead.py holds them (fp32 through ~40 layers, then
# exact NMS)
DET_ATOL = 1e-4


def _tiny_lighthead(fused=False, size=64):
    """The tests' tiny Light-Head (Xception-lite) in the port's config."""
    model = C.ModelConfig(
        name="tiny_xception_lite", backbone="xception_lite",
        family="lighthead", image_size=size,
        proposals=C.ProposalConfig(pre_nms_topk=128, post_nms_topk=32,
                                   pre_nms_topk_eval=128,
                                   post_nms_topk_eval=32, nms_threshold=0.7,
                                   min_size=2.0),
        nms=C.NMSConfig(max_output=20, score_threshold=0.01),
        large_sep_mid=16, head_dim=64, backbone_fused_sepconv=fused)
    return dataclasses.replace(C.lighthead_xception(size), model=model)


def _thin(cfg, **kw):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_stages=(1, 1, 1, 1), **kw))


def _images(seed, batch, size, scale=255.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0, scale, (batch, size, size, 3)
                                        ).astype(np.float32))


def _int8_model(cfg, seed=0):
    """``cfg``'s int8 model with seeded weights, calibrated on one batch."""
    qcfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_quant="int8"))
    model = build_model(qcfg.model, "cpu", seed=seed, dtype=torch.float32)
    size = cfg.model.image_size
    quant.calibrate_backbone(qcfg, model, [preprocess_for_eval(
        _images(seed + 1, 2, size), qcfg.data)])
    return qcfg, model


def _models():
    """name -> a maker of (cfg, model) with seeded weights, in eval mode."""
    lh = _tiny_lighthead()
    xdet = _thin(C.xdet_xception(128), backbone_widths=(32, 64, 96, 128),
                 backbone_fused_sepconv=True)
    ssd = _thin(C.ssd_resnet50(64), backbone_widths=(8, 16, 24, 32))
    return {"lighthead": lambda: (lh, build_model(lh.model, "cpu", seed=0,
                                                  dtype=torch.float32)),
            "xdet_fused": lambda: (xdet, build_model(
                xdet.model, "cpu", seed=0, dtype=torch.float32)),
            "ssd_int8": lambda: _int8_model(ssd)}


def _equal(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["lighthead", "xdet_fused", "ssd_int8"])
def test_exported_program_equals_eager_bitwise(name):
    """The model's serving program (pre-whitened inputs), exported with its
    weights and with the weights as inputs, then through torch.export.save
    and serving.load: every output equals eager inference's bits, and the
    graph reaches the model's kernels only as ``xdt`` operator nodes."""
    cfg, model = _models()[name]()
    x = preprocess_for_eval(_images(3, 2, cfg.model.image_size), cfg.data)
    want = build_eval_fn(model, cfg, "cpu")(x)
    module = ServingModule(model, cfg)
    baked = export.export_program(module, 2, "cpu")
    weights = export.read_tensors(module, [x])
    shared = export.export_program(module, 2, "cpu", weights, baked=False)
    targets = {str(n.target) for n in baked.graph.nodes}
    expect = {"lighthead": {"xdt.psroi_align_fwd.default"},
              "xdet_fused": {"xdt.fused_sepconv.default"},
              "ssd_int8": {"xdt.int8_conv.default",
                           "xdt.quantize_s8.default"}}[name]
    assert expect | {"xdt.self_suppress.default"} <= targets
    with torch.inference_mode():
        _equal(baked.module()(x), want)
        _equal(shared.module()(weights, x), want)
        for program, args in ((baked, (x,)), (shared, (weights, x))):
            buf = io.BytesIO()
            torch.export.save(program, buf)
            buf.seek(0)
            _equal(torch.export.load(buf).module()(*args), want)


def test_prepared_blocks_export_their_operands_not_their_weights():
    """A prepared fused block and a prepared int8 conv are read through
    their operand buffers: the tensors a program stores are those, not the
    weights they came from (nor the int8 convs' ranges)."""
    cfg, model = _models()["xdet_fused"]()
    module = ServingModule(prepare_for_inference(model), cfg)
    read = export.read_tensors(module, export.example_inputs(module, 1,
                                                             "cpu"))
    fused = [n for n, m in module.named_modules()
             if isinstance(m, SeparableConvBN) and m.takes_fused_route]
    assert fused
    for n in fused:
        assert f"{n}.fused_wp" in read and f"{n}.Conv_1.weight" not in read
    cfg, model = _models()["ssd_int8"]()
    module = ServingModule(prepare_for_inference(model), cfg)
    read = export.read_tensors(module, export.example_inputs(module, 1,
                                                             "cpu"))
    convs = [n for n, m in module.named_modules() if isinstance(m, QuantConv)]
    assert convs
    for n in convs:
        assert f"{n}.int8_kernel" in read and f"{n}.act_amax" not in read
        assert read[f"{n}.int8_kernel"].dtype == torch.int8


def test_prequantized_container_equals_eager_bitwise(tmp_path):
    """The int8 SSD, prequantized, as a container of buckets 1 (baked) and
    2: the stored tensors hold the int8 kernels (no float weight of a
    QuantConv), and each bucket's loaded program gives the eager
    prequantized model's bits."""
    cfg, model = _models()["ssd_int8"]()
    quant.prequantize(model)
    module = ServingModule(model, cfg)
    seconds = export.export_container(module, str(tmp_path), (1, 2), (1,),
                                      "cpu", {"preset": cfg.model.name,
                                              "quant": "int8"})
    assert sorted(seconds) == [1, 2]
    cont = serving.load_container(str(tmp_path))
    assert cont.meta["baked"] == [1] and cont.meta["device"] == "cpu"
    stored = torch.load(tmp_path / serving.WEIGHTS, weights_only=True)
    convs = [n for n, m in model.named_modules() if isinstance(m, QuantConv)]
    for n in convs:
        assert stored[f"model.{n}.int8_kernel"].dtype == torch.int8
        assert f"model.{n}.weight" not in stored
    detect = build_eval_fn(model, cfg, "cpu")
    for b in (1, 2):
        x = preprocess_for_eval(_images(5 + b, b, 64), cfg.data)
        _equal(cont.detect(x), detect(x))


# ---------------------------------------------------------------------------
# Against the JAX package's export serving_fn
# ---------------------------------------------------------------------------

def test_raw_rgb_letterbox_program_matches_jax_serving_fn():
    """A raw-RGB letterbox program of the tiny Light-Head (JAX's weights
    through from_jax_variables) against JAX's ``serving_fn`` as its export
    CLI builds it (whiten, detect, ``clip(boxes / max(s, 1e-6), 0, 1)``),
    on letterboxed seeded images: boxes and scores within the Light-Head
    parity tolerance, classes and valid exact. JAX pools with its
    PSROIAlign kernel (the port's precise pooling)."""
    jcfg = tiny_config("xception_lite")
    exp = dataclasses.replace(jax_lh(64), model=jcfg)
    rng = np.random.default_rng(11)
    raw = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
           for hw in ((30, 60), (50, 20))]
    canvas, scale = serving.letterbox_batch(raw, 64)
    jmodel = L.LightHeadRCNN(config=jcfg, dtype=jnp.float32)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jmodel.init(k, canvas, train=False))(jax.random.PRNGKey(7)))
    eval_fn = jax_build_eval_fn(jmodel, exp)

    def serving_fn(v, images, box_scale):
        whitened = jax.vmap(lambda im: jax_preprocess(im, exp.data))(images)
        boxes, scores, classes, valid = eval_fn(v, whitened)
        s = box_scale[:, None, jnp.array([0, 1, 0, 1])]
        boxes = jnp.clip(boxes / jnp.maximum(s, 1e-6), 0.0, 1.0)
        return boxes, scores, classes, valid

    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call",
               functools.partial(pl.pallas_call, interpret=True))
    mp.setattr(L, "batched_psroi_align", batched_psroi_align_pallas)
    try:
        ref = [np.asarray(t) for t in serving_fn(variables, canvas, scale)]
    finally:
        mp.undo()
    cfg = _tiny_lighthead()
    model = build_model(cfg.model, "cpu", seed=None, dtype=torch.float32)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    module = ServingModule(prepare_for_inference(model), cfg, raw_rgb=True)
    assert module.letterbox
    program = export.export_program(module, 2, "cpu")
    with torch.inference_mode():
        got = [t.numpy() for t in program.module()(
            torch.from_numpy(canvas), torch.from_numpy(scale))]
    assert ref[3].sum() > 0
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[0], ref[0], atol=DET_ATOL, rtol=0)
    np.testing.assert_allclose(got[1], ref[1], atol=DET_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# The operators
# ---------------------------------------------------------------------------

def _op_args(name):
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
    i8 = lambda *s: torch.from_numpy(rng.integers(-127, 128, s, dtype=np.int8))
    rois = torch.from_numpy(np.sort(rng.uniform(0, 1, (1, 5, 2, 2)), axis=2)
                            .transpose(0, 1, 3, 2).reshape(1, 5, 4)
                            .astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=(2, 8, 8)) < 0.3).triu(1)
    kernel = Q.prepare_weight(i8(16, 3, 3, 8), False).kernel
    return {
        "psroi_align_fwd": (t(1, 6, 7, 98).requires_grad_(), rois, 7, 2),
        "psroi_align_bwd": (t(1, 5, 7, 7, 2), rois, 6, 7, torch.float32, 7,
                            2),
        "fused_sepconv": (t(1, 4, 5, 8), t(3, 3, 8), t(16, 8), t(16), t(16),
                          t(1, 4, 5, 16), 1, True, "tma"),
        "int8_conv": (i8(1, 5, 6, 8), kernel, t(16).abs(),
                      [3, 3, 1, 1, 1, 1, 1, 1, 1, 1], torch.bfloat16),
        "int8_dwconv": (i8(1, 5, 6, 8),
                        Q.prepare_weight(i8(8, 3, 3, 1), True).kernel,
                        t(8).abs(),
                        [3, 3, 2, 2, 1, 1, 0, 1, 0, 1], torch.float32),
        "int8_dwconv_q": (i8(1, 5, 6, 16),
                          Q.prepare_weight(i8(16, 3, 3, 1), True).kernel,
                          t(16).abs(), torch.tensor(0.05),
                          [3, 3, 2, 2, 1, 1, 0, 1, 0, 1], torch.bfloat16),
        "quantize_s8": (t(2, 3, 4) * 3, torch.tensor(0.05)),
        "self_suppress": (mask,),
    }[name]


@pytest.mark.parametrize("name", library.OPERATORS)
def test_operator_passes_opcheck(name):
    """``torch.library.opcheck`` of every ``xdt`` operator at tiny shapes
    on the CPU: its schema, its fake implementation against the real one,
    its autograd registration (B1's forward, whose features need a
    gradient) and a dynamic-shape AOT trace."""
    torch.library.opcheck(getattr(torch.ops.xdt, name).default,
                          _op_args(name))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_psroi_registered_autograd_equals_the_plain_backward(dtype):
    """B1's forward operator differentiates through its registered
    backward (the backward operator): the features' gradient equals the
    plain backward of the same upstream gradient bit for bit, in the
    features' dtype; the rois get none."""
    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.normal(0, 1, (2, 9, 11, 98)).astype(
        np.float32)).to(dtype).requires_grad_()
    rois = torch.from_numpy(np.sort(rng.uniform(0, 1, (2, 12, 2, 2)), axis=2)
                            .transpose(0, 1, 3, 2).reshape(2, 12, 4)
                            .astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.normal(0, 1, (2, 12, 7, 7, 2)).astype(
        np.float32))
    P.batched_psroi_align(feats, rois, 7).backward(g)
    want = P.psroi_align_backward_reference(g, rois.detach(), 9, 11, dtype)
    assert feats.grad.dtype == dtype
    assert torch.equal(feats.grad, want)
    assert rois.grad is None


def _greedy(mask):
    """Sequential greedy suppression of one [T, T] mask: t is suppressed
    when a kept j < t suppresses it."""
    t = mask.shape[-1]
    sup = [False] * t
    for i in range(t):
        sup[i] = any(not sup[j] and bool(mask[j, i]) for j in range(i))
    return torch.tensor(sup)


def test_self_suppress_operator_equals_sequential_greedy():
    """``xdt::self_suppress`` against sequential greedy suppression, row by
    row: random masks, and a chain (j suppresses j + 1 only) whose Jacobi
    fixpoint takes T steps, many groups of ``CHECK_EVERY``."""
    rng = np.random.default_rng(5)
    t = 40
    chain = torch.zeros(t, t, dtype=torch.bool)
    chain[torch.arange(t - 1), torch.arange(1, t)] = True
    masks = torch.from_numpy(rng.uniform(size=(5, t, t)) < 0.1).triu(1)
    mask = torch.cat([masks, chain[None]])
    assert t > 2 * nms.CHECK_EVERY
    got = torch.ops.xdt.self_suppress(mask)
    for row, m in zip(got, mask):
        assert torch.equal(row, _greedy(m))
    assert torch.equal(got[-1], torch.arange(t) % 2 == 1)


def test_prepared_model_trained_one_step_detects_with_the_new_weights():
    """A fused Light-Head prepared for inference, trained one step, then
    put back in eval(): train() dropped the prepared operands, so the old
    eval function raises rather than detect with stale ones, and a new one
    (build_eval_fn prepares) detects with the new weights: the bits of a
    fresh model loaded with them."""
    cfg = small_lighthead_cfg()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_fused_sepconv=True))
    state = create_model_and_state(cfg, "cpu", seed=0, dtype=torch.float32)
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in get_batch(cfg).items()}
    model = state.model.eval()
    detect = build_eval_fn(model, cfg, "cpu")
    blocks = [m for m in model.modules()
              if isinstance(m, SeparableConvBN) and m.takes_fused_route]
    assert blocks and all(m.fused_wp is not None for m in blocks)
    before = detect(batch["image"])
    make_train_step(model, cfg)(state, batch, torch.Generator().manual_seed(0))
    assert all(m.fused_wp is None for m in blocks)
    model.eval()
    with pytest.raises(ValueError, match="prepare_for_inference"):
        detect(batch["image"])
    after = build_eval_fn(model, cfg, "cpu")(batch["image"])
    fresh = build_model(cfg.model, "cpu", seed=None, dtype=torch.float32)
    fresh.load_state_dict(model.state_dict())
    _equal(after, build_eval_fn(fresh, cfg, "cpu")(batch["image"]))
    assert not torch.equal(after[1], before[1])


def test_unscale_boxes_is_jaxs_unscale():
    """The letterbox unscale, against the JAX export's formula."""
    rng = np.random.default_rng(6)
    boxes = rng.uniform(0, 1, (3, 5, 4)).astype(np.float32)
    scale = np.array([[0.5, 1.0], [1.0, 0.25], [0.0, 1.0]], np.float32)
    s = scale[:, None, [0, 1, 0, 1]]
    want = np.asarray(jnp.clip(boxes / jnp.maximum(s, 1e-6), 0.0, 1.0))
    got = unscale_boxes(torch.from_numpy(boxes), torch.from_numpy(scale))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_check_shapes_before_any_implementation():
    """Shape errors are raised by the wrappers, on any device (meta
    tensors included), before the dispatcher picks an implementation."""
    meta = lambda *s, dtype=torch.float32: torch.zeros(*s, dtype=dtype,
                                                       device="meta")
    with pytest.raises(ValueError, match="shape"):
        F.fused_separable_conv(meta(1, 4, 4, 8), meta(3, 3, 8),
                               meta(8, 16), meta(8), meta(16))
    weight = Q.prepare_weight(torch.zeros(16, 3, 3, 8, dtype=torch.int8),
                              False)
    with pytest.raises(ValueError, match="channels"):
        Q.int8_conv2d(torch.zeros(1, 5, 5, 4, dtype=torch.int8), weight,
                      torch.ones(16))
    with pytest.raises(ValueError, match="split"):
        P.batched_psroi_align(meta(1, 4, 4, 50), meta(1, 3, 4), 7)


def test_conv_geometry_is_checked_before_any_operator():
    """One ``int[10]`` geometry a K1 / K2 call: stride and dilation below
    1 and negative pads are refused by ``conv_geometry``, and a depthwise
    call off the square 3x3 by the wrappers' checks and by the operator."""
    assert Q.conv_geometry((3, 1), (2, 1), (1, 2), ((0, 1), (2, 3))) == [
        3, 1, 2, 1, 1, 2, 0, 1, 2, 3]
    with pytest.raises(ValueError, match=">= 1"):
        Q.conv_geometry((3, 3), (0, 1), (1, 1), ((1, 1), (1, 1)))
    with pytest.raises(ValueError, match=">= 0"):
        Q.conv_geometry((3, 3), (1, 1), (1, 1), ((-1, 1), (1, 1)))
    kernel, scale = torch.zeros(9, 8, dtype=torch.int8), torch.ones(8)
    with pytest.raises(ValueError, match="square"):
        Q.check_operand_shapes("dw", (1, 5, 5, 8), kernel, scale,
                               Q.conv_geometry((3, 3), (2, 1), (1, 1),
                                               ((1, 1), (1, 1))), True)
    with pytest.raises(ValueError, match="square"):      # the operator too
        torch.ops.xdt.int8_dwconv.default(
            torch.zeros(1, 5, 5, 8, dtype=torch.int8), kernel, scale,
            [3, 3, 1, 1, 1, 2, 1, 1, 1, 1], torch.float32)


def test_int8_conv_reads_prepared_operands_in_eval_and_checks_once():
    """An int8 QuantConv in eval mode raises without its prepared operands
    (naming the prepare step) and reads them once prepared; its launch
    geometry is checked and kept once an input shape; in training mode it
    makes its operands in each forward, and gives the prepared bits."""
    torch.manual_seed(0)
    conv = QuantConv(8, 16, (3, 3), (2, 2), mode="int8",
                     dtype=torch.float32)
    conv.act_amax.fill_(2.0)
    x = torch.randn(2, 8, 9, 10)
    conv.eval()
    with pytest.raises(ValueError, match="prepare_for_inference"):
        conv(x)
    conv.prepare_for_inference()
    with torch.no_grad():
        got = conv(x)
        conv(x)
        conv(x[..., :8])
    assert sorted(conv._geometry) == [(8, 9, 8), (8, 9, 10)]
    assert conv._geometry[(8, 9, 10)] == [3, 3, 2, 2, 1, 1, 1, 1, 0, 1]
    conv.train()
    assert conv.int8_kernel is None
    with torch.no_grad():
        assert torch.equal(conv(x), got)
