"""The port's MaxpoolNMS (``ops/maxpool_nms.py``) and its two fast paths,
the proposal stage's ``fast_nms`` and the SSD tail's ``fast_mode``, against
the JAX package.

The JAX package's own cases (``tests/test_maxpool_nms.py``) restated on the
port, then seeded parity. Tolerances: masks, masked scores and windows
bitwise (a max and a compare are exact; the maps are drawn on a few levels,
so equal-score plateaus occur); proposals and detections of the same
scores equal in ``valid`` and classes, boxes within 1e-6 and scores within
1e-6 (the decode and the softmax round in another order); whole tiny models
within the Light-Head slice's tolerance (``tests/test_torch_lighthead.py``:
atol 1e-4 on detections).
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
from test_torch_resnet import jax_init  # noqa: E402
from x_detector_tpu.cli.evaluate import (  # noqa: E402
    build_eval_fn as jax_build_eval_fn)
from x_detector_tpu.config import (AnchorConfig,  # noqa: E402
                                   ProposalConfig, SSDAnchorConfig,
                                   lighthead_xception, ssd_resnet50)
from x_detector_tpu.models import detector as jax_detector  # noqa: E402
from x_detector_tpu.models import lighthead as L  # noqa: E402
from x_detector_tpu.models import ssd as jax_ssd  # noqa: E402
from x_detector_tpu.ops import anchors as jax_anchors  # noqa: E402
from x_detector_tpu.ops import maxpool_nms as J  # noqa: E402
from x_detector_tpu.ops.pallas.psroi_align_kernel import (  # noqa: E402
    batched_psroi_align_pallas)
from x_detector_tpu_torch import config as C  # noqa: E402
from x_detector_tpu_torch import inference  # noqa: E402
from x_detector_tpu_torch.cli import export  # noqa: E402
from x_detector_tpu_torch.models import lighthead as port_lh  # noqa: E402
from x_detector_tpu_torch.models.detector import (  # noqa: E402
    postprocess_detections)
from x_detector_tpu_torch.ops import anchors as anchor_lib  # noqa: E402
from x_detector_tpu_torch.ops import boxes as box_ops  # noqa: E402
from x_detector_tpu_torch.ops import maxpool_nms as T  # noqa: E402
from x_detector_tpu_torch.ops import nms  # noqa: E402
from x_detector_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

BOX_TOL = SCORE_TOL = 1e-6
DET_ATOL = 1e-4


def t(x):
    return torch.from_numpy(np.asarray(x))


# ---- the JAX package's cases, restated ---------------------------------------

def test_local_max_mask_basic():
    m = torch.zeros(8, 8, 1)
    m[2, 2, 0], m[2, 3, 0], m[6, 6, 0] = 0.9, 0.5, 0.7
    mask = T.local_max_mask(m, 3)
    assert mask[2, 2, 0]          # the peak survives
    assert not mask[2, 3, 0]      # its smaller neighbour does not
    assert mask[6, 6, 0]          # an isolated second peak survives
    m2 = torch.stack([m[..., 0], torch.roll(m[..., 0], 1, dims=1)], dim=-1)
    mask2 = T.local_max_mask(m2, 3)
    assert mask2[2, 2, 0] and mask2[2, 3, 1]     # channels independent


def test_kernel_matches_iou_threshold():
    assert T._kernel_for(128.0, 16, 0.7, 50) == 3    # r = 1.41
    assert T._kernel_for(512.0, 16, 0.7, 50) == 13   # r = 5.65 -> 6 -> 13
    assert T._kernel_for(32.0, 16, 0.7, 50) == 3     # the floor at 3
    assert T._kernel_for(512.0, 16, 0.7, 4) == 3     # capped at the map


def test_rpn_maxpool_layout_and_suppression():
    """A peak planted at flat (y, x, a) survives there, its same-channel
    neighbour goes to 0, another channel at the same cell is kept."""
    cfg = AnchorConfig()
    f, a = 8, cfg.num_anchors
    scores = torch.full((1, f * f * a), 0.01)

    def flat(y, x, k):
        return (y * f + x) * a + k

    scores[0, flat(3, 3, 0)] = 0.9
    scores[0, flat(3, 4, 0)] = 0.5
    scores[0, flat(3, 3, 5)] = 0.6
    out = T.rpn_maxpool_scores(scores, cfg, 128, 0.7)
    assert out.shape == scores.shape
    assert out[0, flat(3, 3, 0)] == np.float32(0.9)
    assert out[0, flat(3, 4, 0)] == 0.0
    assert out[0, flat(3, 3, 5)] == np.float32(0.6)
    assert (out >= 0).all()


def test_ssd_maxpool_layer_split():
    """Suppressed entries are exactly 0, survivors keep their scores, and
    every (level, anchor, class) plane keeps its global max."""
    cfg = SSDAnchorConfig()
    counts = anchor_lib.ssd_layer_anchor_counts(256, cfg)
    c, a_per = 4, cfg.anchors_per_cell
    scores = np.random.default_rng(0).uniform(
        0.0, 1.0, (2, sum(counts), c)).astype(np.float32)
    out = T.ssd_maxpool_scores(t(scores), cfg, 256, 0.45).numpy()
    kept = out > 0
    assert kept.any() and (~kept).any()
    np.testing.assert_array_equal(out[kept], scores[kept])
    start = 0
    for count in counts:
        side = int(np.sqrt(count // a_per))
        pm = scores[:, start:start + count].reshape(2, side, side, a_per, c)
        om = out[:, start:start + count].reshape(2, side, side, a_per, c)
        for b in range(2):
            for a in range(a_per):
                for k in range(c):
                    y, x = np.unravel_index(np.argmax(pm[b, :, :, a, k]),
                                            (side, side))
                    assert om[b, y, x, a, k] == pm[b, y, x, a, k]
        start += count


def _rpn_peak_logits(anchors, peak, neigh):
    cls = np.zeros((1, anchors.shape[0], 2), np.float32)
    cls[0, :, 0] = 5.0                          # background everywhere
    cls[0, peak] = (0.0, 6.0)
    cls[0, neigh] = (0.0, 4.0)
    return cls


def test_generate_proposals_fast_path():
    """One strong anchor and a weaker same-channel neighbour: the peak's
    clipped anchor comes first, the neighbour's is absent."""
    acfg = C.AnchorConfig()
    anchors = t(anchor_lib.rpn_anchors(128, acfg))
    pcfg = C.ProposalConfig(post_nms_topk_eval=8, pre_nms_topk_eval=64,
                            min_size=1.0, fast_nms=True)
    peak, neigh = (4 * 8 + 4) * 15 + 7, (4 * 8 + 5) * 15 + 7
    cls = t(_rpn_peak_logits(anchors, peak, neigh))
    props, _, valid = port_lh.generate_proposals(
        cls, torch.zeros(1, anchors.shape[0], 4), anchors, pcfg, 128,
        training=False, anchor_cfg=acfg)
    assert props.shape == (1, 8, 4) and valid.shape == (1, 8)
    torch.testing.assert_close(props[0, 0], box_ops.clip_boxes(anchors[peak]),
                               atol=1e-6, rtol=0)
    n_anchor = box_ops.clip_boxes(anchors[neigh])
    assert not any(torch.allclose(g, n_anchor, atol=1e-6)
                   for g in props[0][valid[0]])


def test_postprocess_fast_mode_finds_isolated_boxes():
    cfg = C.SSDAnchorConfig()
    anchors = t(anchor_lib.ssd_anchors(256, cfg))
    logits = torch.zeros(1, anchors.shape[0], 3)
    logits[:, :, 0] = 4.0
    logits[0, 100] = torch.tensor([0.0, 6.0, 0.0])
    logits[0, 4000] = torch.tensor([0.0, 0.0, 6.0])
    det = postprocess_detections(
        torch.zeros(1, anchors.shape[0], 4), logits, anchors, max_output=10,
        score_threshold=0.05, fast_mode=True, ssd_anchor_cfg=cfg,
        image_size=256)
    assert set(det.classes[0][det.valid[0]].tolist()) == {1, 2}
    for i in (100, 4000):
        want = box_ops.clip_boxes(anchors[i])
        assert any(torch.allclose(g, want, atol=1e-5)
                   for g in det.boxes[0, :2])


def test_fast_mode_without_anchor_cfg_raises():
    """Each fast path raises ValueError without its anchor config: a silent
    exact fallback would report exact-path timings as the fast path's."""
    acfg = C.AnchorConfig()
    anchors = t(anchor_lib.rpn_anchors(128, acfg))
    a = anchors.shape[0]
    pcfg = C.ProposalConfig(post_nms_topk_eval=8, pre_nms_topk_eval=64,
                            fast_nms=True)
    with pytest.raises(ValueError, match="anchor_cfg"):
        port_lh.generate_proposals(torch.zeros(1, a, 2), torch.zeros(1, a, 4),
                                   anchors, pcfg, 128, anchor_cfg=None)
    s_anchors = t(anchor_lib.ssd_anchors(256, C.SSDAnchorConfig()))
    n = s_anchors.shape[0]
    with pytest.raises(ValueError, match="ssd_anchor_cfg"):
        postprocess_detections(torch.zeros(1, n, 4), torch.zeros(1, n, 3),
                               s_anchors, fast_mode=True, ssd_anchor_cfg=None,
                               image_size=256)


def test_fast_path_zeroes_invalid_proposal_boxes():
    """Scores strictly decreasing in raster order leave cell (0, 0) the only
    local max of each channel: 15 valid slots of 64, the rest zero boxes."""
    acfg = C.AnchorConfig()
    anchors = t(anchor_lib.rpn_anchors(128, acfg))
    a = anchors.shape[0]
    pcfg = C.ProposalConfig(post_nms_topk_eval=64, pre_nms_topk_eval=128,
                            min_size=1.0, fast_nms=True)
    cls = torch.zeros(1, a, 2)
    cls[0, :, 1] = -torch.arange(a, dtype=torch.float32) * 1e-3
    props, _, valid = port_lh.generate_proposals(
        cls, torch.zeros(1, a, 4), anchors, pcfg, 128, anchor_cfg=acfg)
    assert valid[0].sum() == 15 and not valid[0].all()
    assert (props[0][~valid[0]] == 0).all()


# ---- seeded parity with the JAX package, bitwise ----------------------------

def _levels(rng, shape, levels=4):
    """Scores on a few levels, so that equal-score plateaus occur."""
    return (rng.integers(0, levels, shape) / levels).astype(np.float32)


@pytest.mark.parametrize("shape,kernel", [
    ((2, 8, 8, 5), 3), ((3, 9, 7, 2), 5), ((1, 13, 13, 4), 13),
    ((2, 1, 1, 3), 3), ((2, 2, 2, 4), 3), ((1, 2, 1, 6), 3)],
    ids=["8x8", "9x7", "13x13", "1x1", "2x2", "2x1"])
def test_local_max_mask_matches_jax(shape, kernel):
    """Plateaus and maps of 1-2 cells, where the 3-window exceeds the map
    and every channel keeps only its global max (with its ties)."""
    x = _levels(np.random.default_rng(sum(shape)), shape)
    want = np.asarray(J.local_max_mask(jnp.asarray(x), kernel))
    got = T.local_max_mask(t(x), kernel).numpy()
    np.testing.assert_array_equal(got, want)
    if shape[1] * shape[2] <= 2:
        np.testing.assert_array_equal(got, x == x.max(axis=(1, 2),
                                                      keepdims=True))


@pytest.mark.parametrize("image_size,thr", [(128, 0.7), (64, 0.7),
                                            (800, 0.7), (96, 0.5)])
def test_rpn_maxpool_scores_match_jax(image_size, thr):
    cfg = AnchorConfig()
    feat = -(-image_size // cfg.stride)
    s = _levels(np.random.default_rng(image_size),
                (2, feat * feat * cfg.num_anchors), levels=6)
    want = np.asarray(J.rpn_maxpool_scores(jnp.asarray(s), cfg, image_size,
                                           thr))
    got = T.rpn_maxpool_scores(t(s), C.AnchorConfig(), image_size, thr)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("image_size,thr", [(64, 0.45), (128, 0.45),
                                            (512, 0.45), (256, 0.6)])
def test_ssd_windows_and_scores_match_jax(image_size, thr):
    """ssd_layer_kernels equal JAX's (config 2's 512 px windows 5 / 9 / 7 /
    5 / 3); ssd_maxpool_scores bitwise, the last levels 1-2 cells wide."""
    cfg = SSDAnchorConfig()
    kernels = T.ssd_layer_kernels(image_size, C.SSDAnchorConfig(), thr)
    assert kernels == J.ssd_layer_kernels(image_size, cfg, thr)
    if image_size == 512:
        assert [k for _, k in kernels] == [5, 9, 7, 5, 3]
        assert sum(anchor_lib.ssd_layer_anchor_counts(512, cfg)) == 32736
    n = sum(jax_anchors.ssd_layer_anchor_counts(image_size, cfg))
    s = _levels(np.random.default_rng(image_size), (2, n, 5))
    want = np.asarray(J.ssd_maxpool_scores(jnp.asarray(s), cfg, image_size,
                                           thr))
    got = T.ssd_maxpool_scores(t(s), C.SSDAnchorConfig(), image_size, thr)
    np.testing.assert_array_equal(got.numpy(), want)


def test_config3_rpn_windows():
    """Config 3's proposal stage at 800 px: 50 x 50 x 15 anchors, windows
    3 / 3 / 3 / 7 / 13 for scales 32 to 512."""
    cfg = C.AnchorConfig()
    assert [T._kernel_for(s, 16, 0.7, 50) for s in cfg.scales] == [
        3, 3, 3, 7, 13]
    assert anchor_lib.rpn_anchors(800, cfg).shape[0] == 37500


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_generate_proposals_fast_matches_jax(training):
    """Seeded RPN logits on a few levels (plateaus) and box codes, both
    budgets (post_nms_topk in training, post_nms_topk_eval at eval)."""
    acfg = AnchorConfig()
    anchors = jax_anchors.rpn_anchors(128, acfg)
    a = anchors.shape[0]
    rng = np.random.default_rng(int(training))
    cls = np.zeros((2, a, 2), np.float32)
    cls[..., 1] = rng.integers(-8, 4, (2, a)) / 2.0
    loc = rng.normal(0, 0.2, (2, a, 4)).astype(np.float32)
    pcfg = ProposalConfig(pre_nms_topk=600, post_nms_topk=96,
                          pre_nms_topk_eval=300, post_nms_topk_eval=48,
                          min_size=4.0, fast_nms=True)
    want = L.generate_proposals(jnp.asarray(cls), jnp.asarray(loc),
                                jnp.asarray(anchors), pcfg, 128,
                                training=training, anchor_cfg=acfg)
    got = port_lh.generate_proposals(
        t(cls), t(loc), t(anchors), C.ProposalConfig(**dataclasses.asdict(
            pcfg)), 128, training=training, anchor_cfg=C.AnchorConfig())
    k = 96 if training else 48
    assert got[0].shape == (2, k, 4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].any()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=BOX_TOL, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize("per_class", [False, True], ids=["N4", "NC4"])
def test_postprocess_fast_mode_matches_jax(per_class):
    """fast_mode on [B, N, 4] and per-class [B, N, C, 4] codes: logits on a
    few levels (ties broken toward the lower (box, class) index on both
    sides), the global top-k over N x C pairs."""
    cfg = SSDAnchorConfig()
    anchors = jax_anchors.ssd_anchors(128, cfg)
    n, c = anchors.shape[0], 6
    rng = np.random.default_rng(7 + per_class)
    logits = (rng.integers(-6, 6, (2, n, c + 1)) / 2.0).astype(np.float32)
    codes = rng.normal(0, 0.3, (2, n) + ((c,) if per_class else ()) + (4,)
                       ).astype(np.float32)
    kw = dict(max_output=50, iou_threshold=0.45, score_threshold=0.2,
              fast_mode=True, image_size=128)
    want = jax_detector.postprocess_detections(
        jnp.asarray(codes), jnp.asarray(logits), jnp.asarray(anchors),
        ssd_anchor_cfg=cfg, **kw)
    got = postprocess_detections(t(codes), t(logits), t(anchors),
                                 ssd_anchor_cfg=C.SSDAnchorConfig(), **kw)
    assert got.valid.any()
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=BOX_TOL, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=SCORE_TOL, rtol=0)


# ---- tiny models end to end ------------------------------------------------

def test_tiny_lighthead_fast_nms_matches_jax():
    """The tests' tiny Light-Head (Xception-lite, 64 px) with fast_nms on
    both sides, JAX pooling with its PSROIAlign kernel (interpret mode) as
    in tests/test_torch_lighthead.py: proposals and valid slots equal,
    detections through build_eval_fn within the slice's tolerance; the
    port's proposal stage calls NMS's fixpoint never."""
    mcfg = tiny_config("xception_lite")
    mcfg = dataclasses.replace(mcfg, proposals=dataclasses.replace(
        mcfg.proposals, fast_nms=True))
    images = (np.random.default_rng(3).normal(0, 1, (2, 64, 64, 3)) * 0.3
              ).astype(np.float32)
    model = L.LightHeadRCNN(config=mcfg, dtype=jnp.float32)
    variables = jax_init(model, images)
    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call",
               functools.partial(pl.pallas_call, interpret=True))
    mp.setattr(L, "batched_psroi_align", batched_psroi_align_pallas)
    try:
        out = jax.jit(lambda v: model.apply(v, images, train=False))(
            variables)
        det = L.lighthead_postprocess(out, mcfg)
    finally:
        mp.undo()
    port_cfg = C.ModelConfig(**{
        **dataclasses.asdict(mcfg),
        "anchors": C.AnchorConfig(**dataclasses.asdict(mcfg.anchors)),
        "ssd_anchors": C.SSDAnchorConfig(**dataclasses.asdict(
            mcfg.ssd_anchors)),
        "proposals": C.ProposalConfig(**dataclasses.asdict(mcfg.proposals)),
        "nms": C.NMSConfig(**dataclasses.asdict(mcfg.nms))})
    port = port_lh.LightHeadRCNN(port_cfg, dtype=torch.float32).eval()
    port.load_state_dict(from_jax_variables(variables), strict=True)
    before = nms.self_suppress.calls
    with torch.inference_mode():
        got = port(t(images))
    assert nms.self_suppress.calls == before      # no fixpoint: MaxpoolNMS
    np.testing.assert_array_equal(got["proposal_valid"].numpy(),
                                  np.asarray(out["proposal_valid"]))
    assert got["proposal_valid"].any()
    np.testing.assert_allclose(got["proposals"].numpy(),
                               np.asarray(out["proposals"]), atol=DET_ATOL,
                               rtol=0)
    exp = dataclasses.replace(C.lighthead_xception(64), model=port_cfg)
    boxes, scores, classes, valid = inference.build_eval_fn(
        port, exp, "cpu")(t(images))
    assert np.asarray(det.valid).any()
    np.testing.assert_array_equal(valid.numpy(), np.asarray(det.valid))
    np.testing.assert_array_equal(classes.numpy(), np.asarray(det.classes))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(det.boxes),
                               atol=DET_ATOL, rtol=0)
    np.testing.assert_allclose(scores.numpy(), np.asarray(det.scores),
                               atol=DET_ATOL, rtol=0)


def _tiny_fast_ssd():
    """Config 2 on a thin ResNet at 64 px with fast_mode, max_output 20,
    JAX weights whose class convs are scaled up 20x: random-weight scores
    then spread far apart, so no near-tie (which fp32 sums in another
    order could flip) reaches the top 20."""
    exp = ssd_resnet50(64)
    mcfg = dataclasses.replace(
        exp.model, backbone_stages=(1, 1, 1, 1),
        backbone_widths=(8, 16, 24, 32),
        nms=dataclasses.replace(exp.model.nms, fast_mode=True,
                                max_output=20))
    exp = dataclasses.replace(exp, model=mcfg)
    images = (np.random.default_rng(5).normal(0, 1, (2, 64, 64, 3)) * 0.5
              ).astype(np.float32)
    module = jax_ssd.SSDModel(config=mcfg, dtype=jnp.float32)
    variables = jax_init(module, images)
    head = variables["params"]["head"]
    for name in list(head):
        if name.startswith("cls"):
            head[name] = dict(head[name], kernel=head[name]["kernel"] * 20.0)
    port_exp = C.PRESETS["ssd_resnet50"](64)
    port_exp = dataclasses.replace(port_exp, model=dataclasses.replace(
        port_exp.model, backbone_stages=(1, 1, 1, 1),
        backbone_widths=(8, 16, 24, 32),
        nms=dataclasses.replace(port_exp.model.nms, fast_mode=True,
                                max_output=20)))
    port = inference.build_model(port_exp.model, "cpu", seed=None,
                                 dtype=torch.float32)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return exp, images, module, variables, port_exp, port


def test_tiny_ssd_fast_mode_matches_jax():
    """build_eval_fn against JAX's on the same weights and images, both in
    fast_mode: equal classes and valid slots, boxes and scores within the
    slice tolerance; the port's tail calls NMS's fixpoint never."""
    exp, images, module, variables, port_exp, port = _tiny_fast_ssd()
    want = jax_build_eval_fn(module, exp)(variables, jnp.asarray(images))
    before = nms.self_suppress.calls
    got = inference.build_eval_fn(port, port_exp, "cpu")(t(images))
    assert nms.self_suppress.calls == before
    assert np.asarray(want[3]).sum() > 0
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=DET_ATOL,
                                   rtol=0)


def test_tiny_ssd_fast_mode_exports_bitwise():
    """The fast-mode SSD exported with torch.export (the max-pool and the
    stable sort trace), saved and loaded: bitwise equal to eager."""
    _, images, _, _, port_exp, port = _tiny_fast_ssd()
    eager = inference.build_eval_fn(port, port_exp, "cpu")(t(images))
    program = export.export_program(
        inference.ServingModule(port, port_exp), 2, "cpu")
    buf = io.BytesIO()
    torch.export.save(program, buf)
    buf.seek(0)
    loaded = torch.export.load(buf).module()
    with torch.no_grad():
        got = loaded(t(images))
    for g, w in zip(got, eager):
        assert g.dtype == w.dtype and torch.equal(g, w)
