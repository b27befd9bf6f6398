"""Kernel K2's Hopper route (``csrc/int8_dwconv_tma.cu``) and its quantize
on store, on the CPU: the route rule and the launch plan (mirrored from the
kernel source), the re-laid weight, the operator ``xdt::int8_dwconv_q``'s
plain version, the int8 separable block that calls it, a tiny int8
Xception-lite against JAX, an exported int8 Light-Head, and the launch
counts of configs 2 and 3.

The CPU runs every operator's plain version; the kernel itself is held to
them on the card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
Tolerances: the fused and unfused paths, the plain versions and the
exported program are bitwise (the same integer sums, the same roundings);
against JAX's jitted int8 backbone rtol 1e-3 / atol 1e-2, as
``tests/test_torch_quant.py`` holds it (a scale one ulp apart moves a value
across the int8 grid).
"""

import dataclasses
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_resnet import jax_init, perturb_bn  # noqa: E402
from x_detector_tpu.models import xception as jax_xception  # noqa: E402
from x_detector_tpu_torch import _build, quant, serving  # noqa: E402
from x_detector_tpu_torch import config as C  # noqa: E402
from x_detector_tpu_torch.cli import export  # noqa: E402
from x_detector_tpu_torch.data.augment import preprocess_for_eval  # noqa: E402
from x_detector_tpu_torch.inference import (  # noqa: E402
    ServingModule, build_eval_fn, build_model)
from x_detector_tpu_torch.models import layers, xception  # noqa: E402
from x_detector_tpu_torch.models.layers import (  # noqa: E402
    SeparableConvBN, prepare_for_inference, same_pads)
from x_detector_tpu_torch.ops import int8_conv as Q  # noqa: E402
from x_detector_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BOUNDARY_RTOL, BOUNDARY_ATOL = 1e-3, 1e-2

# config 3's depthwise calls, batch 16 at 800 px: (shape, stride, dilation,
# pads), one each
CONFIG3_DW = [
    ((16, 200, 200, 128), 1, 1, ((1, 1), (1, 1))),
    ((16, 200, 200, 128), 2, 1, ((0, 1), (0, 1))),
    ((16, 100, 100, 256), 1, 1, ((1, 1), (1, 1))),
    ((16, 100, 100, 256), 2, 1, ((0, 1), (0, 1))),
    ((16, 50, 50, 512), 1, 1, ((1, 1), (1, 1))),
    ((16, 50, 50, 512), 1, 2, ((2, 2), (2, 2))),
    ((16, 50, 50, 1024), 1, 2, ((2, 2), (2, 2))),
]


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _geometry(s, d, pads):
    return Q.conv_geometry((3, 3), (s, s), (d, d), pads)


# ---- the route rule ---------------------------------------------------------

def test_depthwise_route_rule():
    """"tma" where C is a multiple of 16, stride and dilation are 1 or 2
    and every operand is 16-byte aligned; "simt" (the first design, its
    channels a thread the largest of 16, 4, 1 dividing C and the input's
    and taps' addresses) for the rest. The rule reads the shape only."""
    g = _geometry(1, 1, ((1, 1), (1, 1)))
    for c in (16, 32, 48, 144, 1024):
        assert Q.plan_depthwise((2, 9, 9, c), g).route == "tma"
        assert Q.fuses_quantize(c, 1, 1)
    assert Q.plan_depthwise((2, 9, 9, 20), g) == Q.DepthwisePlan("simt",
                                                                 vec=4)
    assert Q.plan_depthwise((2, 9, 9, 7), g) == Q.DepthwisePlan("simt",
                                                                vec=1)
    assert Q.plan_depthwise((2, 9, 9, 40), g).vec == 4
    for s, d in ((3, 1), (1, 3)):
        gg = _geometry(s, d, ((1, 1), (1, 1)))
        assert Q.plan_depthwise((2, 19, 19, 64), gg) == Q.DepthwisePlan(
            "simt", vec=16)
        assert not Q.fuses_quantize(64, s, d)
    for i, off in enumerate((8, 4, 1)):
        ptrs = [4096] * 5
        ptrs[i if i < 2 else 4] += off
        plan = Q.plan_depthwise((2, 9, 9, 64), g, ptrs)
        assert plan.route == "simt"
        assert plan.vec == (16 if i == 2 else {8: 4, 4: 4, 1: 1}[off])
    plan = Q.plan_depthwise((2, 9, 9, 64), g, (16, 32, 48, 64, 80))
    assert plan.route == "tma"


def test_depthwise_plan_is_computed_once_per_shape(monkeypatch):
    """The plan is built once per (shape, geometry, alignments, SM count,
    output bytes) and then read from the cache."""
    built = []
    plan_dw_tma = Q.plan_dw_tma
    monkeypatch.setattr(Q, "plan_dw_tma",
                        lambda *a: built.append(a) or plan_dw_tma(*a))
    Q._plan_dw.cache_clear()
    g = _geometry(1, 1, ((1, 1), (1, 1)))
    plans = {Q.plan_depthwise(torch.Size([4, 20, 20, 128]), list(g),
                              [4096 * i] * 5) for i in range(4)}
    assert len(plans) == 1 and len(built) == 1
    Q.plan_depthwise((4, 20, 20, 128), g, out_bytes=1)
    Q.plan_depthwise((4, 20, 20, 128), g, sm_count=114)
    assert len(built) == 3


# ---- the plan, mirrored from the kernel source ------------------------------

def _kernel_source():
    return (_build.CSRC / "int8_dwconv_tma.cu").read_text()


def test_tma_plan_constants_mirror_the_kernel_source():
    """ops/int8_conv.py restates the kernel's fixed geometry and its
    shared-memory layout to plan the launch; the two must agree, and the
    entry must be bound with the argument count its C signature has."""
    src = _kernel_source()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    assert const["CB"] == Q.DW_CB
    assert const["QUAD"] == Q.DW_QUAD
    assert const["MAX_WARPS"] == Q.DW_MAX_WARPS
    assert const["MAX_STAGES"] == Q.DW_MAX_STAGES
    assert const["BOX_SLACK"] == Q.DW_BOX_SLACK
    assert const["BAR_BYTES"] == Q.DW_BAR_BYTES
    assert const["SMEM_LIMIT"] == Q.TMA_SMEM_LIMIT
    assert "constexpr int RH = 8 / S;" in src
    assert ("p.stage_bytes = (p.box_bytes + BOX_SLACK + 1023) / 1024 * 1024"
            in src)
    assert "p.staging_bytes = rh * QUAD * CB * ob;" in src
    assert ("const int need = stages * p.stage_bytes + qw * rr * "
            "p.staging_bytes +\n                   BAR_BYTES + 1024;" in src)
    entry = src[src.index('extern "C" int xdt_int8_dwconv_tma('):]
    params = entry[:entry.index(")")].count(",") + 1
    assert params == len(_build.SIGNATURES["xdt_int8_dwconv_tma"])


@pytest.mark.parametrize("s,d", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_first_use_loads_every_row_a_run_reads(s, d):
    """The kernel loads input row R of a run at the first of its output
    rows that reads it (``first_use``), so a row is read once a run; the
    rows loaded are exactly the rows some output row reads (s = 2, d = 2
    reads the even ones)."""
    rh = 8 // s
    nr = (rh - 1) * s + 2 * d + 1
    reads = {r: {r * s + i * d for i in range(3)} for r in range(rh)}
    for row in range(nr):
        first = Q.dw_first_use(row, s, d, rh)
        readers = [r for r in range(rh) if row in reads[r]]
        assert first == (min(readers) if readers else rh)
    assert all(max(rows) < nr for rows in reads.values())


@pytest.mark.parametrize("out_bytes", [2, 1, 4])
@pytest.mark.parametrize("case", range(len(CONFIG3_DW)))
def test_tma_plan_fits_every_config3_call(case, out_bytes):
    """At every config 3 depthwise call, in each output mode (bf16, int8,
    fp32): the tile's shared memory (a ring of 2-4 boxes, a staging run a
    warp, the mbarriers) fits, the box is a TMA box (at most 256 a side),
    the tiles cover the output map, each run's input columns (4 column
    words a word of taps) stay within the box and its slack, and the grid
    is one wave."""
    shape, s, d, pads = CONFIG3_DW[case]
    g = _geometry(s, d, pads)
    plan = Q.plan_depthwise(shape, g, out_bytes=out_bytes)
    b, h, w, c = shape
    ho, wo = Q.output_size((h, w), (3, 3), (s, s), (d, d), pads)
    assert plan.route == "tma" and plan.rh == 8 // s
    assert 4 <= plan.qw * plan.rr <= Q.DW_MAX_WARPS
    assert 2 <= plan.stages <= Q.DW_MAX_STAGES
    smem, box = Q.dw_tile_smem(plan.qw, plan.rr, s, d, out_bytes,
                               plan.stages)
    assert (smem, box) == (plan.smem_bytes, plan.box)
    assert smem <= Q.TMA_SMEM_LIMIT and max(box) <= 256
    assert box == ((plan.th - 1) * s + 2 * d + 1,
                   (plan.tw - 1) * s + 2 * d + 1)
    tiles = -(-ho // plan.th) * -(-wo // plan.tw)
    assert plan.units == b * tiles * -(-c // Q.DW_CB)
    assert plan.grid == min(plan.units, Q.SM_COUNT)
    words = -(-(3 * s + 2 * d + 1) // 4)
    last = 4 * (plan.qw - 1) * s + 4 * words - 1
    assert (last - (box[1] - 1)) * Q.DW_CB <= Q.DW_BOX_SLACK
    # the tile is no more than a third larger than the map it covers
    assert tiles * plan.th * plan.tw <= 4 / 3 * ho * wo * 1.01 + (
        plan.th * plan.tw)


# ---- the weight -------------------------------------------------------------

@pytest.mark.parametrize("c", [16, 144, 1024])
def test_relaid_weight_unpacks_to_wq(c):
    """The depthwise operand [21, C]: rows 0-8 the taps by tap (the "simt"
    route's), rows 9-20 channel c's tap row i at bytes 12c + 4i as (w_i0,
    w_i1, w_i2, 0) (the "tma" route's). Both unpack to ``wq`` exactly."""
    rng = np.random.default_rng(c)
    wq = torch.from_numpy(rng.integers(-128, 128, (c, 3, 3, 1),
                                       dtype=np.int8))
    weight = Q.prepare_weight(wq, True)
    assert weight.kernel.shape == (Q.DW_KERNEL_ROWS, c)
    assert weight.kernel.dtype == torch.int8 and weight.kernel.is_contiguous()
    assert torch.equal(Q.unpack_weight(weight.kernel, (3, 3), c, True), wq)
    assert torch.equal(Q.unpack_tma_taps(weight.kernel), wq)
    flat = weight.kernel.reshape(-1)[9 * c:].reshape(c, 3, 4)
    assert torch.equal(flat[:, :, 3], torch.zeros(c, 3, dtype=torch.int8))
    for ch in (0, c // 2, c - 1):
        for i in range(3):
            for j in range(3):
                assert flat[ch, i, j] == wq[ch, i, j, 0]
    assert torch.equal(weight.kernel[:9].t().reshape(c, 3, 3), wq[..., 0])


# ---- the operator's plain version -------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,d", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_fused_operator_plain_equals_the_composition(s, d, dtype):
    """``xdt::int8_dwconv_q`` on CPU tensors is K2's plain version in
    ``dtype`` then K3's, bit for bit: at a scale that saturates some
    outputs at +-127, and with small operands (v = acc / 2, exact) at sx =
    1, where many values lie on half-integers."""
    rng = np.random.default_rng(10 * s + d)
    b, h, w, c = 2, 9, 11, 32
    pads = same_pads((h, w), (3, 3), (s, s), (d, d))
    for small in (False, True):
        lim = 4 if small else 128
        xq = torch.from_numpy(rng.integers(-lim + 1, lim, (b, h, w, c),
                                           dtype=np.int8))
        wq = torch.from_numpy(rng.integers(-lim + 1, lim, (c, 3, 3, 1),
                                           dtype=np.int8))
        scale = (torch.full((c,), 0.5) if small else
                 torch.from_numpy(rng.uniform(1e-4, 1e-2, c).astype(
                     np.float32)))
        v = Q.int8_depthwise_conv2d_reference(xq, wq, scale, stride=s,
                                              dilation=d, pads=pads,
                                              out_dtype=dtype)
        sx = torch.tensor(1.0 if small else float(v.float().abs().amax())
                          / 300.0)
        got = Q.int8_depthwise_conv2d_quantized(
            xq, Q.prepare_weight(wq, True), scale, sx, stride=s,
            dilation=d, pads=pads, dtype=dtype)
        want = Q.quantize_activation_reference(v, sx)
        assert got.dtype == torch.int8 and torch.equal(got, want)
        if small:
            assert ((v.float() / sx).frac().abs() == 0.5).float().mean() > 0.2
        else:
            assert (got.abs() == 127).any() and (got.abs() < 127).any()


def test_fused_operator_checks_its_operands():
    """The wrapper refuses a dense weight, a weight of the old [9, C]
    layout and an sx_out of more than one value, before the operator."""
    xq = torch.zeros(1, 5, 5, 16, dtype=torch.int8)
    dense = Q.prepare_weight(torch.zeros(16, 3, 3, 16, dtype=torch.int8),
                             False)
    with pytest.raises(ValueError, match="dense weight"):
        Q.int8_depthwise_conv2d_quantized(xq, dense, torch.ones(16),
                                          torch.tensor(1.0))
    old = Q.Int8Weight(torch.zeros(9, 16, dtype=torch.int8), (3, 3), True)
    with pytest.raises(ValueError, match="weight operand"):
        Q.int8_depthwise_conv2d_quantized(xq, old, torch.ones(16),
                                          torch.tensor(1.0))
    weight = Q.prepare_weight(torch.zeros(16, 3, 3, 1, dtype=torch.int8),
                              True)
    with pytest.raises(ValueError, match="one value"):
        Q.int8_depthwise_conv2d_quantized(xq, weight, torch.ones(16),
                                          torch.ones(2))


@pytest.mark.parametrize("impl", ["cpu", "fake"])
@pytest.mark.parametrize("op", ["int8_dwconv", "int8_dwconv_q"])
def test_depthwise_operators_refuse_the_nine_row_weight(op, impl):
    """Called past the wrapper, each depthwise operator's CPU and fake
    implementations refuse a weight operand of the older [9, C] layout
    (as an older exported container holds it) and a scale of another
    length, naming the layout; the [21, C] operand of prepare_weight
    passes. The CUDA implementation's check is the card test's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rng = np.random.default_rng(3)
    c = 16
    xq = torch.from_numpy(rng.integers(-127, 128, (1, 5, 6, c),
                                       dtype=np.int8))
    good = Q.prepare_weight(torch.from_numpy(rng.integers(
        -127, 128, (c, 3, 3, 1), dtype=np.int8)), True).kernel
    old, scale = good[:9].contiguous(), torch.rand(c) * 1e-2
    geometry = _geometry(1, 1, ((1, 1), (1, 1)))
    fn = getattr(torch.ops.xdt, op).default

    def call(kernel, scale):
        args = (xq, kernel, scale) + (
            (torch.tensor(0.05), geometry, torch.bfloat16)
            if op == "int8_dwconv_q" else (geometry, torch.bfloat16))
        if impl == "fake":
            with FakeTensorMode() as mode:
                args = tuple(mode.from_tensor(a) if isinstance(
                    a, torch.Tensor) else a for a in args)
                return fn(*args)
        return fn(*args)

    assert call(good, scale).shape == (1, 5, 6, c)
    with pytest.raises(ValueError, match="older layout"):
        call(old, scale)
    with pytest.raises(ValueError, match="scale must be"):
        call(good, scale[:8])


# ---- the int8 separable block -----------------------------------------------

def _block(cin, cout, s, d, dtype, seed=0):
    torch.manual_seed(seed)
    m = SeparableConvBN(cin, cout, (s, s), (d, d), quant="int8",
                        dtype=dtype)
    with torch.no_grad():
        m.bn.running_mean.uniform_(-0.5, 0.5)
        m.bn.running_var.uniform_(0.5, 2.0)
    m.Conv_0.act_amax.fill_(2.5)
    m.Conv_1.act_amax.fill_(0.6)
    return m.eval()


def _counting_k3(monkeypatch):
    calls = []
    quantize = Q.quantize_activation
    monkeypatch.setattr(Q, "quantize_activation",
                        lambda x, sx: calls.append(x.shape) or quantize(x,
                                                                        sx))
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,d", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_int8_separable_block_fused_equals_unfused_bitwise(monkeypatch, s,
                                                           d, dtype):
    """An int8 SeparableConvBN whose depthwise conv quantizes its store
    (one quantize, K3, for the block's input only) gives the bits of the
    two convs called one after the other (K2 in ``dtype``, K3 at the
    pointwise conv's sx, K1), in eval mode with prepared operands and in
    training mode, which makes them each forward."""
    m = _block(32, 48, s, d, dtype)
    prepare_for_inference(m)
    assert m.quantizes_on_store
    x = torch.from_numpy(np.random.default_rng(s + 3 * d).normal(
        0, 1, (2, 32, 13, 11)).astype(np.float32)).to(dtype)
    calls = _counting_k3(monkeypatch)
    with torch.no_grad():
        got = m(x)
        assert len(calls) == 1
        want = torch.relu(m.bn(m.Conv_1(m.Conv_0(x))))
        assert len(calls) == 3
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert m.Conv_1._geometry and m.Conv_0._geometry
        m.train()
        m.bn.eval()           # batch statistics aside, the same block
        assert torch.equal(m(x), got)


def test_int8_separable_block_keeps_two_calls_where_it_cannot_fuse():
    """Calibrate and act8 blocks, an int8 block of C off a multiple of 16,
    and a dense block keep today's path (no quantize on store)."""
    assert not _block(20, 48, 1, 1, torch.float32).quantizes_on_store
    m = _block(32, 48, 1, 1, torch.float32)
    m.Conv_0.mode = m.Conv_1.mode = "calibrate"
    assert not m.quantizes_on_store
    for quant_mode in ("calibrate", "act8"):
        assert not SeparableConvBN(32, 48, quant=quant_mode
                                   ).quantizes_on_store
    assert not SeparableConvBN(32, 48, dense=True,
                               quant="int8").quantizes_on_store


# ---- a tiny int8 Xception-lite against JAX ----------------------------------

def test_tiny_int8_xception_lite_with_fused_blocks_matches_jax():
    """The tiny int8 Xception-lite (widths 16-64: every separable block
    quantizes on its depthwise store) from JAX's weights and calibrated
    ranges, against JAX's jitted int8 apply: c3, c4 and c5 within the
    boundary-flip tolerance."""
    build_jax = lambda q: jax_xception.XceptionLite(
        widths=(16, 32, 48, 64), units_per_stage=(1, 1, 1, 1), quant=q,
        dtype=jnp.float32)
    x = (np.random.default_rng(7).normal(0, 1, (1, 32, 32, 3)) * 100.0
         ).astype(np.float32)
    variables = perturb_bn(jax_init(build_jax(None), jnp.asarray(x)))
    _, mut = jax.jit(lambda v, xx: build_jax("calibrate").apply(
        v, xx, train=False, mutable=["quant"]))(variables, x)
    qv = jax.tree_util.tree_map(np.asarray, mut["quant"])
    ref = jax.jit(lambda v, xx: build_jax("int8").apply(v, xx, train=False)
                  )({**variables, "quant": qv}, x)
    port = xception.XceptionLite(widths=(16, 32, 48, 64),
                                 units_per_stage=(1, 1, 1, 1), quant="int8",
                                 dtype=torch.float32).eval()
    port.load_state_dict(from_jax_variables({**variables, "quant": qv}),
                         strict=True)
    layers.prepare_for_inference(port)
    assert _chip_smoke().quantizing_blocks(port) == 8
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for key in ("c3", "c4", "c5"):
        np.testing.assert_allclose(
            got[key].permute(0, 2, 3, 1).float().numpy(),
            np.asarray(ref[key]), rtol=BOUNDARY_RTOL, atol=BOUNDARY_ATOL,
            err_msg=key)


# ---- export -----------------------------------------------------------------

def _tiny_int8_lighthead(size=64):
    model = C.ModelConfig(
        name="tiny_xception_lite", backbone="xception_lite",
        family="lighthead", image_size=size, backbone_quant="int8",
        backbone_stages=(1, 1, 1, 1), backbone_widths=(16, 32, 48, 64),
        proposals=C.ProposalConfig(pre_nms_topk=128, post_nms_topk=32,
                                   pre_nms_topk_eval=128,
                                   post_nms_topk_eval=32, nms_threshold=0.7,
                                   min_size=2.0),
        nms=C.NMSConfig(max_output=20, score_threshold=0.01),
        large_sep_mid=16, head_dim=32)
    cfg = dataclasses.replace(C.lighthead_xception(size), model=model)
    net = build_model(cfg.model, "cpu", seed=0, dtype=torch.float32)
    rng = np.random.default_rng(1)
    batch = torch.from_numpy(rng.uniform(0, 255, (2, size, size, 3)).astype(
        np.float32))
    quant.calibrate_backbone(cfg, net, [preprocess_for_eval(batch,
                                                            cfg.data)])
    return cfg, net


def test_tiny_int8_lighthead_exports_and_reloads_bitwise(tmp_path):
    """The tiny int8 Light-Head, prequantized, exported as a container of
    buckets 1 (baked) and 2: its graphs call ``xdt::int8_dwconv_q`` once a
    separable block (and K3 once a conv that no block's K2 feeds); each
    bucket's loaded program gives the eager model's bits, and the stored
    tensors hold the pointwise convs' sx that the fused calls read."""
    cfg, net = _tiny_int8_lighthead()
    quant.prequantize(net)
    blocks = _chip_smoke().quantizing_blocks(net)
    assert blocks == 8
    module = ServingModule(net, cfg)
    export.export_container(module, str(tmp_path), (1, 2), (1,), "cpu",
                            {"preset": cfg.model.name, "quant": "int8"})
    cont = serving.load_container(str(tmp_path))
    detect = build_eval_fn(net, cfg, "cpu")
    rng = np.random.default_rng(5)
    for b in (1, 2):
        x = preprocess_for_eval(torch.from_numpy(rng.uniform(
            0, 255, (b, 64, 64, 3)).astype(np.float32)), cfg.data)
        for g, w in zip(cont.detect(x), detect(x)):
            assert g.dtype == w.dtype and torch.equal(g, w)
    program = torch.export.load(str(tmp_path / serving.graph_file(2)))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    n_convs = len(quant.quant_convs(net))
    assert targets.count("xdt.int8_dwconv_q.default") == blocks
    assert targets.count("xdt.int8_dwconv.default") == 0
    assert targets.count("xdt.quantize_s8.default") == n_convs - blocks
    stored = torch.load(tmp_path / serving.WEIGHTS, weights_only=True)
    for name, m in net.named_modules():
        if isinstance(m, SeparableConvBN) and m.quantizes_on_store:
            assert f"model.{name}.Conv_1.int8_sx" in stored


# ---- launch counts ----------------------------------------------------------

@pytest.mark.parametrize("preset,want", [
    ("lighthead_xception", {"int8_conv": 20, "int8_dwconv": 16,
                            "quantize_s8": 20}),
    ("ssd_resnet50", {"int8_conv": 53, "int8_dwconv": 0,
                      "quantize_s8": 53})])
def test_int8_launch_counts_of_configs_2_and_3(preset, want):
    """What chip_smoke.py holds the card to a batch: config 3 launches K1
    20, K2 16 (every one quantizing its store) and K3 20; config 2 K1 53
    and K3 53 (the models built on the meta device, nothing run)."""
    chip_smoke = _chip_smoke()
    cfg = getattr(C, preset)(800 if preset == "lighthead_xception" else 512)
    model = build_model(dataclasses.replace(cfg.model, backbone_quant="int8"),
                        "meta", seed=None)
    assert chip_smoke.int8_calls(model) == want
    assert chip_smoke.quantizing_blocks(model) == want["int8_dwconv"]


# ---- chip_smoke's int8 phases, rehearsed on the CPU -------------------------

def _counting_operators(monkeypatch, chip_smoke):
    """Every int8 ``xdt`` operator replaced by its plain version that
    counts as its CUDA implementation does (route and mode by the plan),
    so that chip_smoke's launch checks can run on the CPU."""
    import types
    monkeypatch.setattr(Q, "sm_count", lambda index: Q.SM_COUNT)
    dw = Q.int8_depthwise_conv2d

    def quantize(x, sx):
        Q.quantize_activation.launches += 1
        return Q.quantize_activation_reference(x, sx).contiguous()

    def conv(xq, kernel, scale, geometry, dtype):
        plan = Q.plan_conv(xq.shape, kernel.shape[0], geometry,
                           xq.data_ptr())
        Q.int8_conv2d.launches += 1
        Q.int8_conv2d.route_launches[plan.route] += 1
        return Q.conv_plain(xq, kernel, scale, geometry, dtype)

    def count_dw(xq, kernel, scale, geometry, out_bytes, mode):
        c = xq.shape[3]
        plan = Q._plan_dw(tuple(xq.shape), tuple(geometry), (
            xq.data_ptr() % 16, kernel.data_ptr() % 16,
            (kernel.data_ptr() + 9 * c) % 16, scale.data_ptr() % 16, 0),
            Q.SM_COUNT, out_bytes)
        if mode == "quantize" and plan.route != "tma":
            raise ValueError("tma route only")
        dw.launches += 1
        dw.route_launches[plan.route] += 1
        dw.mode_launches[mode] += 1

    def dwconv(xq, kernel, scale, geometry, dtype):
        count_dw(xq, kernel, scale, geometry, 2, "dequant")
        return Q.dwconv_plain(xq, kernel, scale, geometry, dtype)

    def dwconv_q(xq, kernel, scale, sx_out, geometry, dtype):
        count_dw(xq, kernel, scale, geometry, 1, "quantize")
        return Q.dwconv_q_plain(xq, kernel, scale, sx_out, geometry, dtype)

    for name, fn in (("quantize_s8", quantize), ("int8_conv", conv),
                     ("int8_dwconv", dwconv), ("int8_dwconv_q", dwconv_q)):
        monkeypatch.setattr(torch.ops.xdt, name,
                            types.SimpleNamespace(default=fn))


def _thin_int8_lighthead(chip_smoke, size=64):
    cfg = C.lighthead_xception(size)
    return chip_smoke.fused(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_stages=(1, 1, 1, 1), large_sep_mid=16,
        head_dim=32, backbone_widths=(16, 32, 48, 64),
        proposals=C.ProposalConfig(pre_nms_topk_eval=128,
                                   post_nms_topk_eval=32, min_size=2.0),
        nms=C.NMSConfig(max_output=20))))


def test_cpu_rehearsal_of_chip_smoke_int8_kernel_phase(monkeypatch):
    """chip_smoke.time_int8 at the thin Light-Head's and SSD's call shapes
    on the CPU (timers stubbed, operators counting as on the card): every
    K2 call of the thin Light-Head planned on the "tma" route, held in
    both modes and on the first design; K3 summed over the calls that run
    it (12 of the thin Light-Head's 20: its 8 pointwise convs take their
    input from K2's quantizing store); the report and the kernels line's
    K1-K3 entries (K2's ms and bound the dequantizing kernel's, as before
    it had two modes, its quantize_* fields the main path's mode at 1 byte
    out, with its route split and shapes)."""
    import json
    from x_detector_tpu_torch.utils import profiling
    chip_smoke = _chip_smoke()
    _counting_operators(monkeypatch, chip_smoke)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, *a: (fn(), 1.0)[1])
    monkeypatch.setattr(profiling, "device_ms",
                        lambda fn, *a, **k: (fn(), 0.5)[1])
    gen = torch.Generator().manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=gen)
    ssd = dataclasses.replace(C.ssd_resnet50(64), model=dataclasses.replace(
        C.ssd_resnet50(64).model, backbone_stages=(1, 1, 1, 1),
        backbone_widths=(16, 32, 48, 64)))
    tots = {}
    for tag, cfg in (("config2", ssd),
                     ("config3", _thin_int8_lighthead(chip_smoke))):
        calls, fused = chip_smoke.int8_conv_calls(cfg, "cpu", 2)
        tots[tag] = chip_smoke.time_int8(calls, randn, fused)
        chip_smoke.report_int8_kernels(tag, tots[tag])
    assert tots["config3"]["quantize_s8"]["calls"] == 12
    assert tots["config2"]["quantize_s8"]["calls"] == (
        tots["config2"]["int8_conv"]["calls"])
    assert tots["config3"]["quantize_s8"]["device_ms"] == 12 * 0.5
    k2 = tots["config3"]["int8_dwconv"]
    assert k2["calls"] == 8 and k2["routes"]["tma"]["calls"] == 8
    assert 0 < k2["q_bound_ms"] < k2["bound_ms"]
    assert len(k2["shapes"]) == len({(sh["shape"][3], sh["stride"],
                                      sh["dilation"]) for sh in k2["shapes"]})
    rows = {r["name"]: r for r in chip_smoke.int8_kernel_lines(tots)}
    json.dumps(list(rows.values()))
    row = rows["int8_dwconv"]
    assert row["source"] == "x_detector_tpu_torch/csrc/int8_dwconv_tma.cu"
    assert row["bound_ms"] == k2["bound_ms"] and row["bound_out_bytes"] == 2
    assert row["device_ms"] == k2["device_ms"] and row["ms"] == k2["ms"]
    assert row["quantize_bound_ms"] == k2["q_bound_ms"] < row["bound_ms"]
    assert row["quantize_bound_out_bytes"] == 1
    assert row["quantize_device_ms"] == k2["q_device_ms"]
    assert rows["quantize_s8"]["config3_calls_per_batch"] == 12
    assert all(r["device_missing"] == [] for r in rows.values())
    for key in ("name", "route", "source", "replaces", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"):
        assert all(key in r for r in rows.values())
    assert "device_ms" in rows["quantize_s8"]


def test_cpu_rehearsal_of_chip_smoke_int8_rounds(monkeypatch):
    """chip_smoke.int8_rounds on the thin int8 Light-Head on the CPU
    (the int8 operators counting as on the card): the new path launches K2
    8 times quantizing on its store and K3 12 times a batch; with the first
    design's K1, and with the first design's K2 and a separate K3
    (first_depthwise_design), it launches as expected and gives the same detections; the
    four sides alternate."""
    chip_smoke = _chip_smoke()
    _counting_operators(monkeypatch, chip_smoke)
    cfg = _thin_int8_lighthead(chip_smoke)
    res, model = chip_smoke.run_int8(cfg, "cpu", batches=1, batch_size=2,
                                     keep_path=True)
    per_batch = {"int8_conv": 12, "int8_dwconv": 8, "quantize_s8": 12}
    for name, v in per_batch.items():      # (B1 counts on the card only)
        assert res["launches"][name] == res["expected"][name] == 2 * v
    assert res["dw_modes"] == {"dequant": 0, "quantize": 16}
    assert res["dw_routes"] == {"tma": 16, "simt": 0}
    assert res["int8_routes"] == {"tma": 22, "mma": 2}
    ms = chip_smoke.int8_rounds("int8_config3", res, cfg, 2, per_batch,
                                {"tma": 11, "mma": 1},
                                {"dequant": 0, "quantize": 8}, device="cpu",
                                rounds=2)
    assert set(ms) == {"bf16", "int8", "int8_first_design", "int8_first_dw"}
    with chip_smoke.first_depthwise_design():
        assert chip_smoke.quantizing_blocks(model) == 0
        assert Q.plan_depthwise((2, 9, 9, 64), _geometry(
            1, 1, ((1, 1), (1, 1)))).route == "simt"
    assert chip_smoke.quantizing_blocks(model) == 8


def test_int8_device_time_falls_back_to_events_and_says_so(monkeypatch):
    """Where the profiler records no kernel, chip_smoke's int8 phase gives
    no device time (None) and goes on: the call's time by CUDA events is
    kept apart, under its kernel's entry, a per-batch device sum that
    holds the call is None, and the logs say "not measured"; where the
    profiler records, its device time is taken."""
    from x_detector_tpu_torch.utils import profiling
    chip_smoke = _chip_smoke()
    monkeypatch.setattr(chip_smoke, "DEVICE_MISSING", [])
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, *a: 2.5)
    monkeypatch.setattr(profiling, "device_ms", lambda fn, **k: 0.75)
    assert chip_smoke.int8_device_ms(lambda: None, "int8_dwconv", "a") == 0.75

    def silent(fn, **k):
        raise AssertionError("the profiler recorded no kernel in 6 windows")

    monkeypatch.setattr(profiling, "device_ms", silent)
    assert chip_smoke.int8_device_ms(lambda: None, "int8_dwconv", "b") is None
    assert chip_smoke.DEVICE_MISSING == [
        {"kernel": "int8_dwconv", "call": "b", "events_ms": 2.5}]
    row = {"device_ms": 0.0}
    chip_smoke.add_ms(row, "device_ms", 0.75, 4)
    assert row["device_ms"] == 3.0
    chip_smoke.add_ms(row, "device_ms", None, 1)
    chip_smoke.add_ms(row, "device_ms", 0.75, 2)
    assert row["device_ms"] is None
    assert chip_smoke.ms_text(None) == "not measured"
    assert chip_smoke.share_text(1.0, None) == "not measured"
    assert chip_smoke.share_text(1.0, 2.0) == "50.0%"


@pytest.mark.parametrize("out_bytes", [2, 1])
def test_dwconv_variants_plans_fit(out_bytes):
    """int8_dwconv_variants.py's plans at config 3's shapes, on the CPU:
    the rule's first, then distinct tiles of 4 to DW_MAX_WARPS warps, one
    block an SM, whose shared memory fits a block and whose grid is one
    wave."""
    from x_detector_tpu_torch import int8_dwconv_variants as V
    for b, h, w, c, s, d, pads, _ in V.SHAPES:
        g = _geometry(s, d, pads)
        plans = V.candidates((b, h, w, c), g, out_bytes, Q.SM_COUNT)
        assert plans[0] == ("rule", Q.plan_depthwise((b, h, w, c), g,
                                                     out_bytes=out_bytes))
        assert len({p for _, p in plans}) == len(plans) > 1
        for _, p in plans[1:]:
            assert 4 <= p.qw * p.rr <= Q.DW_MAX_WARPS
            assert p.smem_bytes <= Q.TMA_SMEM_LIMIT
            assert p.grid == min(p.units, Q.SM_COUNT)