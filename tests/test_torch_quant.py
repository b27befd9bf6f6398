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
    """K1's plan. The first design ("mma" route): 64 channels a block up
    to Cout 64, else 128; the A copy the largest of 16, 8, 4, 1 bytes
    dividing Cin and the address. The rule: Cin a multiple of 16 and a
    16-byte aligned ``xq`` take the "tma" route, the rest the "mma"
    one."""
    assert int8_conv.plan_mma(3, 64) == int8_conv.ConvPlan("mma", 64, 1)
    assert int8_conv.plan_mma(12, 128) == int8_conv.ConvPlan("mma", 128, 4)
    assert int8_conv.plan_mma(64, 256, x_ptr=8) == int8_conv.ConvPlan(
        "mma", 128, 8)
    assert int8_conv.plan_mma(1024, 21) == int8_conv.ConvPlan("mma", 64, 16)
    assert int8_conv.depthwise_vec(1024, 0, 16) == 16
    assert int8_conv.depthwise_vec(20, 0, 0) == 4
    assert int8_conv.output_size((800, 200), (12, 3), (4, 1), (1, 1),
                                 ((4, 4), (1, 1))) == (200, 200)
    g3 = int8_conv.conv_geometry((3, 3), (1, 1), (1, 1), ((1, 1), (1, 1)))
    assert int8_conv.plan_conv((1, 8, 8, 3), 64, g3) == int8_conv.plan_mma(
        3, 64)
    assert int8_conv.plan_conv((1, 8, 8, 40), 64, g3).route == "mma"
    assert int8_conv.plan_conv((1, 8, 8, 48), 64, g3).route == "tma"
    # the conv form's tile: the fewest tiles, then the widest
    assert int8_conv.conv_tile(16, 16, 1, 1) == (8, 16)
    assert int8_conv.conv_tile(128, 128, 1, 1) == (1, 128)
    assert int8_conv.conv_tile(50, 50, 1, 1) == (5, 25)
    assert int8_conv.conv_tile(100, 100, 2, 2) == (5, 25)
    # split-K: the most slices that keep one wave of units, at most one a
    # K chunk and 8 (a cluster); none where the tiles fill more than half
    # the SMs
    assert int8_conv.split_count(67, 36, 132) == 1
    assert int8_conv.split_count(8, 1, 132) == 1
    assert int8_conv.split_count(1, 5, 132) == 5
    assert int8_conv.split_count(64, 36, 132) == 2
    assert int8_conv.split_count(8, 36, 132) == 8
    assert int8_conv.split_count(30, 36, 132) == 4


def test_tma_plan_constants_mirror_the_kernel_source():
    """ops/int8_conv.py restates the "tma" kernel's fixed geometry to plan
    its launches (chunk bytes, tile rows, stages, splits, shared memory);
    the two must agree."""
    import re
    from x_detector_tpu_torch import _build
    src = (_build.CSRC / "int8_conv_tma.cu").read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    assert const["KC"] == int8_conv.TMA_KC
    assert const["BM"] == int8_conv.TMA_BM
    assert const["MAX_STAGES"] == int8_conv.TMA_MAX_STAGES
    assert const["MAX_SPLITS"] == int8_conv.TMA_MAX_SPLITS
    assert const["SMEM_LIMIT"] == int8_conv.TMA_SMEM_LIMIT
    assert "STAGING_BYTES = 2 * PASS_BYTES" in src
    assert "PASS_BYTES = BM * 128" in src
    # the Layout: ring, staging, barriers, 1024 bytes of alignment slack
    assert int8_conv.TMA_FIXED_SMEM == (2 * const["BM"] * 128
                                        + const["BAR_BYTES"] + 1024)


def test_int8_conv_plan_misaligned_input_takes_the_first_design():
    """An ``xq`` off 16-byte alignment (a view) cannot be a TMA operand:
    the plan sends it to the "mma" route, whose copy width follows the
    address."""
    g = int8_conv.conv_geometry((1, 1), (1, 1), (1, 1), ((0, 0), (0, 0)))
    for ptr, vec in ((8, 8), (4, 4), (2, 1), (1, 1)):
        plan = int8_conv.plan_conv((8, 32, 32, 256), 256, g, x_ptr=ptr)
        assert plan == int8_conv.plan_mma(256, 256, ptr)
        assert plan.route == "mma" and plan.vec == vec
    assert int8_conv.plan_conv((8, 32, 32, 256), 256, g,
                               x_ptr=256).route == "tma"


def test_int8_conv_weight_must_be_aligned():
    """Both K1 routes read the weight in 16-byte pieces (a tensor map, or
    16-byte copies), so the CUDA path refuses a weight off 16 bytes with a
    message naming the rule, rather than sending it to a route."""
    for ptr in (0, 16, 4096):
        int8_conv.check_weight_aligned(ptr)
    for ptr in (1, 4, 8, 4104):
        with pytest.raises(ValueError, match="16-byte"):
            int8_conv.check_weight_aligned(ptr)


# (H, W, Cin, Cout, kernel, stride, dilation, pads): a strided 1x1 of
# Xception's (reads a quarter of its input), ResNet's strided 3x3 and 7x7
# stem, a dilated 3x3, and a 1x1 stride 1
INT8_BOUND_CASES = {
    "strided_1x1_200": (200, 200, 128, 256, (1, 1), (2, 2), (1, 1),
                        ((0, 0), (0, 0))),
    "strided_1x1_odd": (25, 25, 64, 64, (1, 1), (2, 2), (1, 1),
                        ((0, 0), (0, 0))),
    "3x3_s2_same": (64, 64, 256, 256, (3, 3), (2, 2), (1, 1),
                    ((0, 1), (0, 1))),
    "7x7_s2_stem": (64, 64, 3, 64, (7, 7), (2, 2), (1, 1), ((2, 3), (2, 3))),
    "3x3_d2": (20, 20, 32, 48, (3, 3), (1, 1), (2, 2), ((2, 2), (2, 2))),
    "1x1": (16, 16, 512, 2048, (1, 1), (1, 1), (1, 1), ((0, 0), (0, 0))),
}


@pytest.mark.parametrize("case,depthwise", [
    (case, dw) for case, row in INT8_BOUND_CASES.items()
    for dw in ((False, True) if row[4] == (3, 3) else (False,))])
def test_int8_conv_bound_counts_the_input_pixels_read(case, depthwise):
    """K1's and K2's bounds count the input pixels some tap reads, counted
    here by marking them one output and tap at a time: a strided 1x1 reads
    its stride's grid only. The operations and the other operands as
    before."""
    from x_detector_tpu_torch.utils import roofline
    h, w, cin, cout, k, s, d, pads = INT8_BOUND_CASES[case]
    if depthwise:
        cout = cin
    b = 2
    g = int8_conv.conv_geometry(k, s, d, pads)
    ho, wo = int8_conv.output_size((h, w), k, s, d, pads)
    read = np.zeros((h, w), bool)
    for oy in range(ho):
        for ox in range(wo):
            for i in range(k[0]):
                for j in range(k[1]):
                    y = oy * s[0] - pads[0][0] + i * d[0]
                    x = ox * s[1] - pads[1][0] + j * d[1]
                    if 0 <= y < h and 0 <= x < w:
                        read[y, x] = True
    m = b * ho * wo
    if depthwise:
        want = roofline.bound_ms(
            2.0 * 9 * m * cin, b * int(read.sum()) * cin + 13 * cin
            + m * cin * 2, roofline.FP32_FLOP_PER_S)
        got = int8_conv.depthwise_bound_ms(b, h, w, cin, g, 2)
    else:
        kk = k[0] * k[1] * cin
        want = roofline.bound_ms(
            2.0 * m * cout * kk, b * int(read.sum()) * cin + cout * kk
            + 4 * cout + m * cout * 2, roofline.INT8_TENSOR_OPS_PER_S)
        got = int8_conv.conv_bound_ms(b, h, w, cin, cout, g, 2)
    assert got == want
    if case.startswith("strided_1x1"):
        assert int(read.sum()) == ho * wo < h * w


def test_int8_conv_plan_is_computed_once_per_shape(monkeypatch):
    """conv_cuda asks for the plan on every call; it is built once per
    (shape, Cout, geometry, alignment, SM count) and then read from the
    cache."""
    built = []
    plan_tma = int8_conv.plan_tma
    monkeypatch.setattr(int8_conv, "plan_tma",
                        lambda *a: built.append(a) or plan_tma(*a))
    int8_conv._plan.cache_clear()
    g = int8_conv.conv_geometry((3, 3), (1, 1), (1, 1), ((1, 1), (1, 1)))
    plans = [int8_conv.plan_conv(torch.Size([8, 16, 16, 512]), 512, list(g),
                                 x_ptr=4096 * i, sm_count=132)
             for i in range(5)]
    assert len(built) == 1 and len(set(plans)) == 1
    int8_conv.plan_conv((8, 16, 16, 512), 512, g, x_ptr=0, sm_count=114)
    int8_conv.plan_conv((8, 16, 16, 512), 256, g, x_ptr=0, sm_count=132)
    assert len(built) == 3
    info = int8_conv._plan.cache_info()
    assert (info.hits, info.misses) == (4, 3)


def _cdiv(a, b):
    return -(-a // b)


def _tile_rows(plan, x_shape, cout, geometry, tile):
    """The output pixels (rows of [B*Ho*Wo, Cout]) that tile ``tile`` of a
    "tma" plan writes, and its first output channel: the kernel's
    ``tile_of`` and ``out_row`` (csrc/int8_conv_tma.cu) restated."""
    b, h, w, _ = x_shape
    ho, wo = int8_conv.output_size((h, w), geometry[:2], geometry[2:4],
                                   geometry[4:6], (geometry[6:8],
                                                   geometry[8:10]))
    tiles_n = _cdiv(cout, plan.bn)
    n0, t = (tile % tiles_n) * plan.bn, tile // tiles_n
    bm = int8_conv.TMA_BM
    if plan.form == "gemm":
        return list(range(t * bm, min((t + 1) * bm, b * ho * wo))), n0
    tiles_w, tiles_h = _cdiv(wo, plan.tw), _cdiv(ho, plan.th)
    w0, t = (t % tiles_w) * plan.tw, t // tiles_w
    h0, img = (t % tiles_h) * plan.th, t // tiles_h
    pixels = ((h0 + r // plan.tw, w0 + r % plan.tw)
              for r in range(plan.th * plan.tw))
    return [(img * ho + oh) * wo + ow for oh, ow in pixels
            if oh < ho and ow < wo], n0


def _slice_chunks(plan, s):
    """The K chunks of split slice ``s``: the kernel's ``chunk_begin``
    restated."""
    return range(s * plan.chunks // plan.splits,
                 (s + 1) * plan.chunks // plan.splits)


def _chunk_columns(plan, cin, k):
    """The weight columns [start, stop) of ``[Cout, Kp]`` that K chunk
    ``k`` of a "tma" plan multiplies by ``xq``'s bytes, as the kernel's
    producer loads them: the B box starts at ``start``; its columns from
    ``stop`` on meet A's zero fill (channels past Cin)."""
    kc = int8_conv.TMA_KC
    if plan.form == "gemm":
        return k * kc, min((k + 1) * kc, cin)
    tap, c = divmod(k, _cdiv(cin, kc))
    return tap * cin + c * kc, tap * cin + min((c + 1) * kc, cin)


# Every dense int8 conv call of configs 2 and 3 at full size, as
# chip_smoke.int8_conv_calls reads them: (B, H, W, Cin, Cout, kernel,
# stride, dilation, pads) -> calls a batch
INT8_CALLS = {
    "config2": {   # SSD + ResNet-50, batch 8, 512 px: 53 calls
        (8, 16, 16, 512, 512, (3, 3), (1, 1), (1, 1), ((1, 1), (1, 1))): 2,
        (8, 16, 16, 512, 2048, (1, 1), (1, 1), (1, 1), ((0, 0), (0, 0))): 3,
        (8, 16, 16, 2048, 512, (1, 1), (1, 1), (1, 1), ((0, 0), (0, 0))): 2,
        (8, 32, 32, 256, 256, (3, 3), (1, 1), (1, 1), ((1, 1), (1, 1))): 5,
        (8, 32, 32, 256, 1024, (1, 1), (1, 1), (1, 1), ((0, 0), (0, 0))): 6,
        (8, 32, 32, 512, 512, (3, 3), (2, 2), (1, 1), ((1, 1), (1, 1))): 1,
        (8, 32, 32, 1024, 256, (1, 1), (1, 1), (1, 1), ((0, 0), (0, 0))): 5,
        (8, 32, 32, 1024, 512, (1, 1), (1, 1), (1, 1), ((0, 0), (0, 0))): 1,
        (8, 32, 32, 1024, 2048, (1, 1), (2, 2), (1, 1), ((0, 0), (0, 0))): 1,
        (8, 64, 64, 128, 128, (3, 3), (1, 1), (1, 1), ((1, 1), (1, 1))): 3,
        (8, 64, 64, 128, 512, (1, 1), (1, 1), (1, 1), ((0, 0), (0, 0))): 4,
        (8, 64, 64, 256, 256, (3, 3), (2, 2), (1, 1), ((1, 1), (1, 1))): 1,
        (8, 64, 64, 512, 128, (1, 1), (1, 1), (1, 1), ((0, 0), (0, 0))): 3,
        (8, 64, 64, 512, 256, (1, 1), (1, 1), (1, 1), ((0, 0), (0, 0))): 1,
        (8, 64, 64, 512, 1024, (1, 1), (2, 2), (1, 1), ((0, 0), (0, 0))): 1,
        (8, 128, 128, 64, 64, (1, 1), (1, 1), (1, 1), ((0, 0), (0, 0))): 1,
        (8, 128, 128, 64, 64, (3, 3), (1, 1), (1, 1), ((1, 1), (1, 1))): 3,
        (8, 128, 128, 64, 256, (1, 1), (1, 1), (1, 1), ((0, 0), (0, 0))): 4,
        (8, 128, 128, 128, 128, (3, 3), (2, 2), (1, 1),
         ((1, 1), (1, 1))): 1,
        (8, 128, 128, 256, 64, (1, 1), (1, 1), (1, 1), ((0, 0), (0, 0))): 2,
        (8, 128, 128, 256, 128, (1, 1), (1, 1), (1, 1),
         ((0, 0), (0, 0))): 1,
        (8, 128, 128, 256, 512, (1, 1), (2, 2), (1, 1),
         ((0, 0), (0, 0))): 1,
        (8, 512, 512, 3, 64, (7, 7), (2, 2), (1, 1), ((3, 3), (3, 3))): 1,
    },
    "config3": {   # Light-Head + Xception-lite, batch 16, 800 px: 20 calls
        (16, 50, 50, 256, 512, (1, 1), (1, 1), (1, 1), ((0, 0), (0, 0))): 1,
        (16, 50, 50, 512, 512, (1, 1), (1, 1), (1, 1), ((0, 0), (0, 0))): 3,
        (16, 50, 50, 512, 1024, (1, 1), (1, 1), (1, 1),
         ((0, 0), (0, 0))): 2,
        (16, 50, 50, 1024, 1024, (1, 1), (1, 1), (1, 1),
         ((0, 0), (0, 0))): 3,
        (16, 100, 100, 128, 256, (1, 1), (1, 1), (1, 1),
         ((0, 0), (0, 0))): 1,
        (16, 100, 100, 256, 256, (1, 1), (1, 1), (1, 1),
         ((0, 0), (0, 0))): 3,
        (16, 100, 100, 256, 512, (1, 1), (2, 2), (1, 1),
         ((0, 0), (0, 0))): 1,
        (16, 200, 200, 128, 128, (1, 1), (1, 1), (1, 1),
         ((0, 0), (0, 0))): 4,
        (16, 200, 200, 128, 256, (1, 1), (2, 2), (1, 1),
         ((0, 0), (0, 0))): 1,
        (16, 800, 200, 12, 128, (12, 3), (4, 1), (1, 1),
         ((4, 4), (1, 1))): 1,
    },
}
INT8_CALL_SHAPES = [(tag, shape) for tag, calls in INT8_CALLS.items()
                    for shape in calls]


def test_int8_call_table_counts_every_dense_call():
    assert {tag: sum(c.values()) for tag, c in INT8_CALLS.items()} == {
        "config2": 53, "config3": 20}


@pytest.mark.parametrize("tag,shape", INT8_CALL_SHAPES,
                         ids=[f"{t}-{s[:5]}-{s[5][0]}x{s[5][1]}s{s[6][0]}"
                              for t, s in INT8_CALL_SHAPES])
def test_int8_conv_plan_at_every_call_shape(tag, shape):
    """K1's plan at a call shape of configs 2 and 3 (132 SMs): the stems
    (Cin 3 and 12) on the first design and every other call on the "tma"
    route; its output tiles cover every (pixel, 128-row x bn block) once;
    its split slices take whole K chunks, each chunk once, and the chunks'
    weight columns cover the conv's K = kh*kw*Cin once; the (tile, slice)
    units fill one wave of the SMs as far as K's chunks (and a cluster's 8
    blocks) allow, and no more; the shared memory fits."""
    b, h, w, cin, cout, k, s, d, pads = shape
    g = int8_conv.conv_geometry(k, s, d, pads)
    plan = int8_conv.plan_conv((b, h, w, cin), cout, g, sm_count=132)
    if cin in (3, 12):
        assert plan == int8_conv.plan_mma(cin, cout)
        return
    assert plan.route == "tma"
    assert plan.form == ("gemm" if (k, s, pads) == (
        (1, 1), (1, 1), ((0, 0), (0, 0))) else "conv")
    ho, wo = int8_conv.output_size((h, w), k, s, d, pads)
    tiles_n = -(-cout // plan.bn)
    seen = np.zeros((b * ho * wo, tiles_n), np.int64)
    for tile in range(plan.tiles):
        rows, n0 = _tile_rows(plan, (b, h, w, cin), cout, g, tile)
        assert len(rows) <= int8_conv.TMA_BM and n0 % plan.bn == 0
        np.add.at(seen[:, n0 // plan.bn], rows, 1)
    assert (seen == 1).all()
    chunks = [kc for sl in range(plan.splits)
              for kc in _slice_chunks(plan, sl)]
    assert chunks == list(range(plan.chunks))
    assert all(len(_slice_chunks(plan, sl)) >= 1
               for sl in range(plan.splits))
    kp = -(-k[0] * k[1] * cin // int8_conv.KBK) * int8_conv.KBK
    cols = np.zeros(kp, np.int64)
    for kc in chunks:
        start, stop = _chunk_columns(plan, cin, kc)
        assert 0 <= start < stop <= kp
        cols[start:stop] += 1
    assert (cols[:k[0] * k[1] * cin] == 1).all()
    assert (cols[k[0] * k[1] * cin:] == 0).all()   # the weight's zero pad
    assert plan.splits == 1 or plan.tiles * plan.splits <= 132
    assert plan.splits in (plan.chunks, int8_conv.TMA_MAX_SPLITS) or (
        plan.tiles * (plan.splits + 1) > 132)
    assert plan.grid == min(132, plan.tiles * plan.splits)
    assert plan.smem_bytes <= int8_conv.TMA_SMEM_LIMIT
    assert 2 <= plan.stages <= int8_conv.TMA_MAX_STAGES


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
