"""The port's int8 post-training quantization (``quant.py``, ``QuantConv``,
``ops/int8_conv.py``) against the JAX package's.

Both sides run on the CPU, the port's int8 convs through their plain
versions (exact float64 sums of the int8 products). Tolerances:
  * one QuantConv in int8 and the calibrate statistics: bitwise, with JAX
    applied eagerly. Jitted, XLA rewrites the division by the constant 127
    in ``sx`` and ``sw`` into a multiply by fp32(1/127), which rounds some
    scales one ulp away from the IEEE division the port (and eager JAX)
    takes;
  * ``prequantize``: bitwise (JAX's runs eagerly);
  * ``calibrate_backbone``'s ranges: 1e-5 relative, the fp32 convolutions
    before each conv summing in another order;
  * whole int8 backbones and models, jitted on the JAX side: rtol 1e-3,
    atol 1e-2 (the JAX package's own limit for quantization-boundary flips,
    ``tests/test_quant.py:292-294``): a scale one ulp apart, or an fp32 sum
    in another order, moves a value across a rounding boundary of the
    int8 grid, and the flip travels on.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_resnet import jax_init, perturb_bn  # noqa: E402
from test_train import small_lighthead_cfg, small_ssd_cfg  # noqa: E402
from x_detector_tpu import quant as jax_quant  # noqa: E402
from x_detector_tpu.models import layers as jax_layers  # noqa: E402
from x_detector_tpu.models import resnet as jax_resnet  # noqa: E402
from x_detector_tpu.models import xception as jax_xception  # noqa: E402
from x_detector_tpu_torch import config, inference, quant  # noqa: E402
from x_detector_tpu_torch.models import layers, resnet, xception  # noqa: E402
from x_detector_tpu_torch.ops import int8_conv  # noqa: E402
from x_detector_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

BOUNDARY_RTOL, BOUNDARY_ATOL = 1e-3, 1e-2
AMAX_REL = 1e-5


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().float().numpy()


# ---- QuantConv's modes and keys ---------------------------------------------

def _module_pairs():
    common = dict(dtype=torch.float32)
    return {
        "conv_bn_3x3_s2": lambda q: layers.ConvBN(
            8, 12, (3, 3), strides=(2, 2), padding="EXPLICIT", quant=q,
            **common),
        "conv_1x1_bias": lambda q: layers.ConvBN(8, 12, (1, 1), use_bn=False,
                                                 quant=q, **common),
        "separable": lambda q: layers.SeparableConvBN(8, 12, quant=q,
                                                      **common),
    }


@pytest.mark.parametrize("name", sorted(_module_pairs()))
def test_quantconv_state_dict_keys_are_nn_conv2ds(name):
    """The quantized module's parameters are the float module's, by name
    and shape; its state dict adds one ``act_amax`` a conv; a float state
    dict loads into it with strict=True (the ranges stay 0)."""
    build = _module_pairs()[name]
    float_mod, quant_mod = build(None), build("int8")
    assert ([(n, p.shape) for n, p in float_mod.named_parameters()]
            == [(n, p.shape) for n, p in quant_mod.named_parameters()])
    extra = set(quant_mod.state_dict()) - set(float_mod.state_dict())
    convs = [n for n, m in quant_mod.named_modules()
             if isinstance(m, layers.QuantConv)]
    assert extra == {f"{n}.act_amax" for n in convs} and convs
    quant_mod.load_state_dict(float_mod.state_dict(), strict=True)
    for n, p in float_mod.state_dict().items():
        assert torch.equal(quant_mod.state_dict()[n], p)
    assert all(float(v) == 0.0 for k, v in quant_mod.state_dict().items()
               if k.endswith("act_amax"))


def test_backbone_quant_values():
    """'calibrate', 'calibrate:p<pct>', 'int8' and 'act8' build (a whole
    model too, act8's QuantConvs without act_amax); anything else
    raises."""
    for mode in ("calibrate", "calibrate:p99.9", "int8", "act8"):
        assert config.check_backbone_quant(mode) == mode
        layers.SeparableConvBN(8, 8, quant=mode)
    assert "Conv_0.act_amax" not in layers.ConvBN(8, 8, quant="act8"
                                                  ).state_dict()
    for bad in ("int4", "calibrate:p0", "calibrate:p100"):
        with pytest.raises(ValueError, match="backbone_quant"):
            config.check_backbone_quant(bad)
    cfg = small_ssd_cfg().model
    model = inference.build_model(
        dataclasses.replace(cfg, backbone_quant="act8"), "cpu")
    convs = quant.quant_convs(model)
    assert convs and all(m.mode == "act8" for m in convs.values())


def _conv_bn_pair(x, percentile_mode="calibrate", seed=0):
    """A JAX ConvBN(12, 3x3) initialised on ``x`` and the port's float and
    quantized ConvBN with its weights."""
    module = jax_layers.ConvBN(12, (3, 3), dtype=jnp.float32)
    variables = perturb_bn(jax_init(module, jnp.asarray(x), seed=seed))
    state = from_jax_variables(variables)
    ports = {}
    for q in (None, percentile_mode):
        ports[q] = layers.ConvBN(x.shape[-1], 12, (3, 3), quant=q,
                                 dtype=torch.float32).eval()
        ports[q].load_state_dict(state, strict=True)
    return module, variables, ports


def test_calibrate_mode_is_the_float_path_and_records_jaxs_amax():
    """Calibrate mode's output equals the float module's bit for bit; its
    act_amax equals JAX's QuantConv(mode="calibrate") exactly (a max is
    exact) and is a running max: a smaller second batch leaves it."""
    x = (np.random.default_rng(1).normal(0, 1, (2, 16, 16, 8)) * 3.0
         ).astype(np.float32)
    module, variables, ports = _conv_bn_pair(x)
    qmod = dataclasses.replace(module, quant="calibrate")
    _, mut = qmod.apply(variables, jnp.asarray(x), mutable=["quant"])
    ref_amax = np.asarray(jax.tree_util.tree_leaves(mut["quant"])[0])
    with torch.no_grad():
        want = ports[None](nchw(x))
        got = ports["calibrate"](nchw(x))
        assert torch.equal(got, want)
        amax = ports["calibrate"].Conv_0.act_amax.clone()
        assert amax.numpy() == ref_amax
        ports["calibrate"](nchw(x * 0.1))
    assert torch.equal(ports["calibrate"].Conv_0.act_amax, amax)


def test_percentile_calibration_matches_jax_on_a_large_input():
    """'calibrate:p99' on 2 x 64 x 64 x 264 = 2.16M > 2^21 elements: the
    subsample of |x| raveled in NHWC order at stride 2 (every other
    element of the first 2^21: the even channels only, the reference's
    aliasing, reproduced) and the linear interpolation give JAX's value
    exactly; a subsample taken in NCHW order gives another."""
    rng = np.random.default_rng(4)
    x = rng.standard_exponential((2, 64, 64, 264)).astype(np.float32)
    x *= rng.uniform(0.5, 2.0, 264).astype(np.float32)   # channels differ
    module = jax_layers.ConvBN(4, (1, 1), dtype=jnp.float32)
    variables = jax_init(module, jnp.asarray(x[:, :4, :4]))
    pmod = dataclasses.replace(module, quant="calibrate:p99")
    _, mut = pmod.apply(variables, jnp.asarray(x), mutable=["quant"])
    ref = np.asarray(jax.tree_util.tree_leaves(mut["quant"])[0])
    port = layers.ConvBN(264, 4, (1, 1), quant="calibrate:p99",
                         dtype=torch.float32).eval()
    port.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        port(nchw(x))
    assert port.Conv_0.act_amax.numpy() == ref
    # |x| raveled in NCHW order instead: a [1, 1, n, 1] tensor's NHWC
    # ravel is its storage
    nchw_order = torch.from_numpy(x).permute(0, 3, 1, 2).reshape(1, 1, -1, 1)
    assert float(layers.observe(nchw_order, 99.0)) != float(ref)


def test_percentile_calibration_ignores_a_hot_pixel():
    """JAX's hot-pixel case (``tests/test_quant.py``): one 1000 in a
    uniform [0, 1) input sets the abs-max but not the 99th percentile; both
    calibrate modes keep the float path's bits; the running max holds;
    each statistic equals JAX's."""
    x = np.random.default_rng(1).uniform(0, 1, (2, 16, 16, 8)
                                         ).astype(np.float32)
    x[0, 3, 4, 2] = 1000.0
    module, variables, ports = _conv_bn_pair(x, "calibrate:p99")
    amax_port = layers.ConvBN(8, 12, (3, 3), quant="calibrate",
                              dtype=torch.float32).eval()
    amax_port.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        want = ports[None](nchw(x))
        assert torch.equal(amax_port(nchw(x)), want)
        assert torch.equal(ports["calibrate:p99"](nchw(x)), want)
    assert float(amax_port.Conv_0.act_amax) == 1000.0
    p99 = float(ports["calibrate:p99"].Conv_0.act_amax)
    assert 0.5 < p99 <= 1.0
    _, mut = dataclasses.replace(module, quant="calibrate:p99").apply(
        variables, jnp.asarray(x), mutable=["quant"])
    assert p99 == float(jax.tree_util.tree_leaves(mut["quant"])[0])
    with torch.no_grad():
        ports["calibrate:p99"](nchw(x * 0.1))
    assert float(ports["calibrate:p99"].Conv_0.act_amax) == p99


# ---- one int8 conv against JAX, bitwise -------------------------------------

# name: (cin, cout, kernel, strides, dilation, padding, groups, bias, (h, w))
INT8_CONVS = {
    "3x3_s1_same": (8, 12, (3, 3), (1, 1), (1, 1), "SAME", 1, False, (9, 11)),
    "3x3_s2_same": (8, 12, (3, 3), (2, 2), (1, 1), "SAME", 1, False, (10, 9)),
    "1x1_bias": (16, 24, (1, 1), (1, 1), (1, 1), "SAME", 1, True, (7, 7)),
    "stem_7x7_s2": (3, 16, (7, 7), (2, 2), (1, 1), ((3, 3), (3, 3)), 1,
                    False, (20, 18)),
    "stem_12x3_s4x1": (12, 16, (12, 3), (4, 1), (1, 1), ((4, 4), (1, 1)), 1,
                       False, (24, 8)),
    "depthwise_d2": (16, 16, (3, 3), (1, 1), (2, 2), "SAME", 16, False,
                     (9, 10)),
    "depthwise_s2": (16, 16, (3, 3), (2, 2), (1, 1), "SAME", 16, False,
                     (10, 11)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(INT8_CONVS))
def test_int8_conv_matches_jax_bitwise(name, dtype):
    """The port's QuantConv in int8 mode equals JAX's (applied eagerly) bit
    for bit: the same x, kernel and act_amax; the range 0.8 of max|x|, so
    the largest inputs saturate. In fp32 the input holds exact ties of the
    int8 grid (act_amax 127: sx = 1, x in halves), rounded half to even."""
    cin, cout, kernel, strides, dilation, padding, groups, bias, (h, w) = (
        INT8_CONVS[name])
    rng = np.random.default_rng(len(name))
    if dtype == "float32":
        x = (rng.integers(-300, 300, (2, h, w, cin)) / 2.0).astype(np.float32)
        amax = np.float32(127.0)
    else:
        x = (rng.normal(0, 2, (2, h, w, cin))).astype(np.float32)
        amax = np.float32(0.8 * np.abs(x).max())
    k = rng.normal(0, 0.3, (*kernel, cin // groups, cout)).astype(np.float32)
    params = {"kernel": k}
    if bias:
        params["bias"] = rng.normal(0, 1, cout).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    module = jax_layers.QuantConv(
        cout, kernel, strides=strides, kernel_dilation=dilation,
        padding=padding, feature_group_count=groups, use_bias=bias,
        mode="int8", dtype=jdt)
    xj = jnp.asarray(x).astype(jdt)
    ref = np.asarray(module.apply({"params": params,
                                   "quant": {"act_amax": amax}}, xj)
                     .astype(jnp.float32))
    tdt = getattr(torch, dtype)
    port = layers.QuantConv(cin, cout, kernel, strides, dilation,
                            groups=groups, bias=bias, pads=padding,
                            mode="int8", dtype=tdt)
    port.load_state_dict(from_jax_variables(
        {"params": params, "quant": {"act_amax": amax}}), strict=True)
    with torch.no_grad():
        got = port(nchw(np.asarray(xj.astype(jnp.float32))).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(nhwc(got), ref)


def test_int8_plain_versions_equal_float64_conv2d():
    """The plain versions (one float64 matmul a tap) against F.conv2d in
    float64 of the same integers, at a stem shape, a dilated 3x3 and the
    depthwise: the same bits."""
    F = torch.nn.functional
    rng = np.random.default_rng(0)
    for cin, cout, k, s, d, pads, depthwise in (
            (3, 10, (7, 7), (2, 2), (1, 1), ((3, 3), (3, 3)), False),
            (12, 24, (3, 3), (1, 1), (2, 2), ((2, 2), (2, 2)), False),
            (16, 16, (3, 3), (2, 2), (1, 1), ((0, 1), (0, 1)), True)):
        xq = torch.from_numpy(rng.integers(-127, 128, (2, 13, 12, cin),
                                           dtype=np.int8))
        wq = torch.from_numpy(rng.integers(-127, 128, (
            cout, *k, 1 if depthwise else cin), dtype=np.int8))
        scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, cout
                                             ).astype(np.float32))
        x64 = F.pad(xq.permute(0, 3, 1, 2).double(),
                    (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
        acc = F.conv2d(x64, wq.permute(0, 3, 1, 2).double(), stride=s,
                       dilation=d, groups=cin if depthwise else 1)
        want = (acc.permute(0, 2, 3, 1).float() * scale).to(torch.bfloat16)
        weight = int8_conv.prepare_weight(wq, depthwise)
        if depthwise:
            got = int8_conv.int8_depthwise_conv2d(
                xq, weight, scale, stride=s[0], dilation=d[0], pads=pads)
        else:
            got = int8_conv.int8_conv2d(xq, weight, scale, stride=s,
                                        dilation=d, pads=pads)
        assert torch.equal(got, want)


def test_quantize_weight_and_activation_match_jax():
    """The per-channel weight scale and int8 weight, and the activation's
    int8, against JAX's formulas run eagerly: bitwise."""
    rng = np.random.default_rng(2)
    k = rng.normal(0, 0.2, (3, 3, 8, 16)).astype(np.float32)
    k[..., 3] = 0.0                                   # sw = 1e-8 / 127
    kj = jnp.asarray(k)
    sw = jnp.maximum(jnp.max(jnp.abs(kj), axis=(0, 1, 2)), 1e-8) / 127.0
    kq = jnp.clip(jnp.round(kj / sw), -127, 127).astype(jnp.int8)
    wq, sw_port = int8_conv.quantize_weight(
        torch.from_numpy(k.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(sw_port.numpy(), np.asarray(sw))
    np.testing.assert_array_equal(wq.numpy(),
                                  np.asarray(kq).transpose(3, 2, 0, 1))
    x = (rng.normal(0, 3, (4, 5, 6, 7))).astype(np.float32)
    amax = np.float32(5.0)
    sx = jnp.maximum(jnp.asarray(amax), 1e-6) / 127.0
    xq = jnp.clip(jnp.round(jnp.asarray(x) / sx), -127, 127).astype(jnp.int8)
    sx_port = int8_conv.activation_scale(torch.tensor(amax))
    assert sx_port.numpy() == np.asarray(sx)
    np.testing.assert_array_equal(
        int8_conv.quantize_activation(torch.from_numpy(x), sx_port).numpy(),
        np.asarray(xq))


def test_int8_conv_plan():
    """K1's plan: 64 channels a block up to Cout 64, else 128; the A copy
    the largest of 16, 8, 4, 1 bytes dividing Cin and the address."""
    assert int8_conv.plan_conv(3, 64) == int8_conv.ConvPlan(64, 1)
    assert int8_conv.plan_conv(12, 128) == int8_conv.ConvPlan(128, 4)
    assert int8_conv.plan_conv(64, 256, x_ptr=8) == int8_conv.ConvPlan(128,
                                                                        8)
    assert int8_conv.plan_conv(1024, 21) == int8_conv.ConvPlan(64, 16)
    assert int8_conv.depthwise_vec(1024, 0, 16) == 16
    assert int8_conv.depthwise_vec(20, 0, 0) == 4
    assert int8_conv.output_size((800, 200), (12, 3), (4, 1), (1, 1),
                                 ((4, 4), (1, 1))) == (200, 200)


# ---- tiny backbones ---------------------------------------------------------

BACKBONES = {
    "xception_lite": (
        lambda q: jax_xception.XceptionLite(
            widths=(16, 32, 48, 64), units_per_stage=(1, 1, 1, 1), quant=q,
            dtype=jnp.float32),
        lambda q: xception.XceptionLite(
            widths=(16, 32, 48, 64), units_per_stage=(1, 1, 1, 1), quant=q,
            dtype=torch.float32)),
    "resnet": (
        lambda q: jax_resnet.ResNetV1(
            stage_sizes=(1, 1, 1, 1), widths=(8, 16, 24, 32), quant=q,
            dtype=jnp.float32),
        lambda q: resnet.ResNetV1(
            stage_sizes=(1, 1, 1, 1), widths=(8, 16, 24, 32), quant=q,
            dtype=torch.float32)),
}


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_tiny_int8_backbone_matches_jax(name):
    """JAX's weights (BatchNorms moved off identity) and its calibrated
    ranges carried by ``from_jax_variables`` (strict), the port's int8
    backbone against JAX's jitted int8 apply: c3, c4 and c5 within the
    boundary-flip tolerance; the ranges the port's calibrate mode records
    within 1e-5 of JAX's."""
    jax_build, port_build = BACKBONES[name]
    x = (np.random.default_rng(2).normal(0, 1, (1, 32, 32, 3)) * 100.0
         ).astype(np.float32)
    variables = perturb_bn(jax_init(jax_build(None), jnp.asarray(x)))
    _, mut = jax.jit(lambda v, xx: jax_build("calibrate").apply(
        v, xx, train=False, mutable=["quant"]))(variables, x)
    qv = jax.tree_util.tree_map(np.asarray, mut["quant"])
    ref = jax.jit(lambda v, xx: jax_build("int8").apply(v, xx, train=False)
                  )({**variables, "quant": qv}, x)
    port = port_build("int8").eval()
    port.load_state_dict(from_jax_variables({**variables, "quant": qv}),
                         strict=True)
    layers.prepare_for_inference(port)
    calib = port_build("calibrate").eval()
    calib.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        calib(torch.from_numpy(x))
    for key in ("c3", "c4", "c5"):
        np.testing.assert_allclose(nhwc(got[key]), np.asarray(ref[key]),
                                   rtol=BOUNDARY_RTOL, atol=BOUNDARY_ATOL,
                                   err_msg=key)
    want = from_jax_variables({"quant": qv})
    state = calib.state_dict()
    assert set(want) == {k for k in state if k.endswith("act_amax")}
    for key, value in want.items():
        np.testing.assert_allclose(state[key].numpy(), value.numpy(),
                                   rtol=AMAX_REL, err_msg=key)


# ---- calibrate_backbone, prequantize and the whole pipelines ----------------

PIPELINES = {"ssd": small_ssd_cfg, "lighthead": small_lighthead_cfg}


@pytest.fixture(scope="module", params=sorted(PIPELINES))
def pipeline(request):
    """A small config of each family: JAX's weights, its calibrated ranges
    over two batches, its prequantized tree, its int8 model's raw outputs
    and detections; the port's int8 model with JAX's float weights and its
    own ranges."""
    cfg = PIPELINES[request.param]()
    qcfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_quant="int8"))
    size = cfg.model.image_size
    images = (np.random.default_rng(5).normal(0, 1, (2, size, size, 3))
              ).astype(np.float32)
    batches = [images, images * 0.5]
    module = jax_quant.build_detector(cfg.model, dtype=jnp.float32)
    variables = perturb_bn(jax_init(module, jnp.asarray(images)))
    qv = jax.tree_util.tree_map(np.asarray, jax_quant.calibrate_backbone(
        cfg, variables, [jnp.asarray(b) for b in batches],
        dtype=jnp.float32))
    qmodule = jax_quant.build_detector(qcfg.model, dtype=jnp.float32)
    raw = jax.jit(lambda v: qmodule.apply(v, images, train=False))(
        {**variables, "quant": qv})
    from x_detector_tpu.cli.evaluate import build_eval_fn
    det = build_eval_fn(qmodule, qcfg)({**variables, "quant": qv}, images)
    pre = jax.tree_util.tree_map(np.asarray, jax_quant.prequantize(
        {**variables, "quant": qv}))
    port = quant.build_detector(qcfg.model, "cpu", torch.float32)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    ranges = quant.calibrate_backbone(
        cfg, port, [torch.from_numpy(b) for b in batches])
    return dict(cfg=qcfg, images=images, variables=variables, qv=qv,
                raw=raw, det=det, pre=pre, port=port, ranges=ranges)


def test_calibrate_backbone_matches_jax(pipeline):
    """Every backbone conv's range, keyed as in the state dict, within 1e-5
    of JAX's ``calibrate_backbone``; all positive; the model's modes are
    int8 again."""
    want = from_jax_variables({"quant": pipeline["qv"]})
    assert set(pipeline["ranges"]) == set(want)
    for key, value in want.items():
        got = pipeline["ranges"][key]
        assert float(got) > 0.0
        np.testing.assert_allclose(got.numpy(), value.numpy(),
                                   rtol=AMAX_REL, err_msg=key)
        assert torch.equal(pipeline["port"].state_dict()[key], got)
    assert {m.mode for m in quant.quant_convs(pipeline["port"]).values()} == {
        "int8"}


def test_calibrate_backbone_refuses_an_empty_stream_or_a_float_model(
        pipeline):
    """Both raise; the empty stream leaves the model's ranges as they
    were."""
    before = {k: v.clone() for k, v in pipeline["port"].state_dict().items()}
    with pytest.raises(ValueError, match="at least one batch"):
        quant.calibrate_backbone(pipeline["cfg"], pipeline["port"], [])
    assert all(torch.equal(v, before[k])
               for k, v in pipeline["port"].state_dict().items())
    float_model = inference.build_model(dataclasses.replace(
        pipeline["cfg"].model, backbone_quant=None), "cpu", seed=0,
        dtype=torch.float32)
    with pytest.raises(ValueError, match="no QuantConv"):
        quant.calibrate_backbone(pipeline["cfg"], float_model,
                                 [torch.zeros(1, 64, 64, 3)])


def test_prequantize_matches_jax_bitwise(pipeline):
    """``prequantize`` of the state dict with JAX's ranges: the int8 weights
    and w_scale equal JAX's ``prequantize`` bit for bit; the calibrated and
    the prequantized JAX trees each load into the port with strict=True,
    and the prequantized model's outputs equal the in-graph model's bit for
    bit (one formula for sw)."""
    calibrated = from_jax_variables({**pipeline["variables"],
                                     "quant": pipeline["qv"]})
    got = quant.prequantize(calibrated)
    want = from_jax_variables(pipeline["pre"])
    assert set(got) == set(want)
    n_int8 = 0
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key
        n_int8 += value.dtype == torch.int8
    assert n_int8 == len(quant.quant_convs(pipeline["port"]))
    in_graph = quant.build_detector(pipeline["cfg"].model, "cpu",
                                    torch.float32)
    in_graph.load_state_dict(calibrated, strict=True)
    prequantized = quant.build_detector(pipeline["cfg"].model, "cpu",
                                        torch.float32)
    prequantized.load_state_dict(want, strict=True)
    x = torch.from_numpy(pipeline["images"])
    with torch.no_grad():
        a = inference.build_eval_fn(in_graph, pipeline["cfg"], "cpu")(x)
        b = inference.build_eval_fn(prequantized, pipeline["cfg"], "cpu")(x)
        assert all(torch.equal(u, v) for u, v in zip(a, b))
        quant.prequantize(in_graph)          # the module, in place
        c = inference.build_eval_fn(in_graph, pipeline["cfg"], "cpu")(x)
    assert all(torch.equal(u, v) for u, v in zip(a, c))


def test_prequantize_guards(pipeline):
    """Applied twice, uncalibrated ranges and no calibrated conv each
    raise, changing nothing."""
    calibrated = from_jax_variables({**pipeline["variables"],
                                     "quant": pipeline["qv"]})
    with pytest.raises(ValueError, match="already int8"):
        quant.prequantize(quant.prequantize(calibrated))
    zeros = {k: torch.zeros_like(v) if k.endswith("act_amax") else v
             for k, v in calibrated.items()}
    with pytest.raises(ValueError, match="uncalibrated"):
        quant.prequantize(zeros)
    floats = from_jax_variables(pipeline["variables"])
    with pytest.raises(ValueError, match="no calibrated convs"):
        quant.prequantize(floats)
    model = quant.build_detector(pipeline["cfg"].model, "cpu", torch.float32)
    model.load_state_dict(floats, strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="uncalibrated"):
        quant.prequantize(model)
    assert all(torch.equal(v, before[k]) for k, v in
               model.state_dict().items())


def test_int8_pipeline_matches_jax(pipeline):
    """The port's int8 model (JAX's weights, its own ranges) against JAX's
    int8 model: the raw outputs before any discrete choice (SSD's
    ``cls_logits`` / ``box_codes``, Light-Head's RPN) within the
    boundary-flip tolerance; then ``build_eval_fn``'s detections finite and
    shaped as JAX's."""
    port, raw = pipeline["port"], pipeline["raw"]
    x = torch.from_numpy(pipeline["images"])
    with torch.inference_mode():
        out = port(x)
    if isinstance(raw, dict):
        pairs = [(out[k], raw[k]) for k in ("rpn_cls", "rpn_loc")]
    else:
        pairs = list(zip(out, raw))
    for got, ref in pairs:
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref),
                                   rtol=BOUNDARY_RTOL, atol=BOUNDARY_ATOL)
    det = inference.build_eval_fn(port, pipeline["cfg"], "cpu")(x)
    for got, ref in zip(det, pipeline["det"]):
        assert tuple(got.shape) == np.asarray(ref).shape
    assert torch.isfinite(det[0]).all() and torch.isfinite(det[1]).all()
    assert bool(det[3].any())
