"""The port's exact greedy NMS and proposal stage against the JAX package.

Both are exact algorithms over the same fp32 inputs, so kept boxes, their
order, scores and class ids must agree; coordinates are held to 1e-6 (the
IoU arithmetic is the same, decisions at the threshold could only differ
by an fp32 rounding). Inputs include tied scores (ties go to the lower
index, as ``lax.top_k`` breaks them) and scores below the floor.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from _torch_nms_cases import (cluttered_rows, edge_rows,  # noqa: E402
                              greedy_flags)
from test_nms import np_greedy_nms, random_cluttered_boxes  # noqa: E402
from x_detector_tpu.models import lighthead as jax_lighthead  # noqa: E402
from x_detector_tpu.config import ProposalConfig  # noqa: E402
from x_detector_tpu.ops import nms as jax_nms  # noqa: E402
from x_detector_tpu_torch.models import lighthead as port_lighthead  # noqa: E402
from x_detector_tpu_torch.ops import nms as N  # noqa: E402

T = torch.from_numpy


def _tied(scores, rng, levels=8):
    """Quantize scores so that many are exactly equal."""
    return (np.floor(scores * levels) / levels + 0.01).astype(np.float32)


def _assert_same(got, ref, atol=1e-6):
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, atol=atol, rtol=0)


@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("n,thresh", [(5, 0.5), (100, 0.3), (300, 0.7),
                                      (1000, 0.7)])
def test_nms_padded_matches_jax(rng, n, thresh, presorted):
    boxes, scores = random_cluttered_boxes(rng, n)
    scores = _tied(scores, rng)
    scores[::7] = 0.02                     # below the floor of 0.05
    if presorted:
        order = np.argsort(-scores, kind="stable")
        boxes, scores = boxes[order], scores[order]
    ref = jax_nms.nms_padded(jnp.asarray(boxes), jnp.asarray(scores),
                             max_output=min(n, 300), iou_threshold=thresh,
                             score_threshold=0.05, presorted=presorted)
    got = N.nms_padded(T(boxes), T(scores), max_output=min(n, 300),
                       iou_threshold=thresh, score_threshold=0.05,
                       presorted=presorted)
    _assert_same(got, ref)
    if not presorted:   # and the sequential oracle
        kept = np_greedy_nms(boxes, scores, thresh, 0.05)[:min(n, 300)]
        assert int(got.valid.sum()) == len(kept)


def test_nms_padded_batched_rows_match_one_by_one(rng):
    rows = [random_cluttered_boxes(rng, 200, clusters=4) for _ in range(3)]
    boxes = np.stack([b for b, _ in rows])
    scores = np.stack([_tied(s, rng) for _, s in rows])
    got = N.nms_padded(T(boxes), T(scores), 50, 0.5, 0.1)
    for i in range(3):
        ref = jax_nms.nms_padded(jnp.asarray(boxes[i]),
                                 jnp.asarray(scores[i]), 50, 0.5, 0.1)
        _assert_same([t[i] for t in got], ref)


@pytest.mark.parametrize("n", [40, 400])   # below / above nms_candidates
def test_multiclass_nms_matches_jax(rng, n):
    boxes, _ = random_cluttered_boxes(rng, n)
    scores = _tied(rng.uniform(0, 1, (n, 4)), rng)
    scores[rng.uniform(0, 1, scores.shape) < 0.3] = 0.005   # below 0.01
    ref = jax_nms.multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                 max_output=50, iou_threshold=0.45,
                                 score_threshold=0.01)
    got = N.multiclass_nms(T(boxes), T(scores), max_output=50,
                           iou_threshold=0.45, score_threshold=0.01)
    _assert_same(got, ref)
    assert (got.classes.numpy() > 0).tolist() == got.valid.numpy().tolist()


def test_batched_multiclass_nms_per_class_boxes_matches_jax(rng):
    b, n, c = 2, 64, 3
    boxes = np.stack([np.stack([random_cluttered_boxes(rng, n)[0]
                                for _ in range(c)], axis=1)
                      for _ in range(b)])                    # [B, N, C, 4]
    scores = rng.uniform(0, 1, (b, n, c)).astype(np.float32)
    ref = jax_nms.batched_multiclass_nms(jnp.asarray(boxes),
                                         jnp.asarray(scores), max_output=400)
    got = N.batched_multiclass_nms(T(boxes), T(scores), max_output=400)
    _assert_same(got, ref)      # 3 x 100 < 400 slots: the padded tail too


@pytest.mark.parametrize("per_class_boxes", [False, True])
def test_approx_prefilter_matches_jax(rng, per_class_boxes):
    """``approx_prefilter=True`` against JAX's ``multiclass_nms`` with the
    same flag, past the 256 candidates so that the prefilter runs: off the
    TPU, XLA lowers ``lax.approx_max_k`` to an exact top-k, the port's
    exact stable top-k. Distinct scores (on exact ties JAX's batched
    fallback may pick other candidates than ``lax.top_k``); the result is
    also the port's with the flag off."""
    b, n, c = 2, 400, 3
    boxes = np.stack([random_cluttered_boxes(rng, n)[0] for _ in range(b)])
    if per_class_boxes:
        boxes = np.stack([boxes] + [np.roll(boxes, k, axis=1)
                                    for k in range(1, c)], axis=2)
    scores = np.stack([rng.permutation(n * c) for _ in range(b)]
                      ).reshape(b, n, c).astype(np.float32) / (n * c)
    kw = dict(max_output=150, iou_threshold=0.45, score_threshold=0.01)
    ref = jax_nms.batched_multiclass_nms(jnp.asarray(boxes),
                                         jnp.asarray(scores),
                                         approx_prefilter=True, **kw)
    got = N.batched_multiclass_nms(T(boxes), T(scores),
                                   approx_prefilter=True, **kw)
    _assert_same(got, ref)
    exact = N.batched_multiclass_nms(T(boxes), T(scores), **kw)
    for g, e in zip(got, exact):
        assert torch.equal(g, e)


def test_generate_proposals_matches_jax(rng):
    """Softmax, decode, clip, min-size, top-k with ties, exact NMS."""
    a, b = 600, 2
    anchors = np.sort(rng.uniform(0, 1, (a, 2, 2)), axis=1).reshape(a, 4)
    anchors = anchors.astype(np.float32)
    # logits drawn from 8 pairs: scores tie exactly in both frameworks
    # (distinct logits may round an ulp apart in the two softmaxes and swap
    # near-ties, which says nothing about the port)
    pairs = np.array([[0.0, d] for d in (-2, -1, -0.5, 0, 0.5, 1, 2, 3)],
                     np.float32)
    rpn_cls = pairs[rng.integers(0, len(pairs), (b, a))]
    rpn_loc = rng.normal(0, 1, (b, a, 4)).astype(np.float32)
    cfg = ProposalConfig(pre_nms_topk_eval=300, post_nms_topk_eval=300,
                         nms_threshold=0.7, min_size=8.0)
    ref = jax_lighthead.generate_proposals(
        jnp.asarray(rpn_cls), jnp.asarray(rpn_loc), jnp.asarray(anchors),
        cfg, image_size=100)
    got = port_lighthead.generate_proposals(T(rpn_cls), T(rpn_loc), T(anchors), cfg,
                             image_size=100)
    _assert_same(got, ref)
    assert 0 < int(got[2].sum()) < 300 * b   # some suppressed or filtered


# ---- xdt::nms_suppress ------------------------------------------------------

def _rows(case, rng):
    """The operator's input for each case: score-sorted rows, invalid
    boxes zero (``nms_padded``'s hand-off)."""
    kind, rows, n = case
    boxes = cluttered_rows(rng, rows, n)
    if kind == "cluttered":
        return boxes
    if kind == "nonfinite":                 # NaN and infinite coordinates
        flat = boxes.reshape(-1)
        pick = rng.choice(flat.size, 40, replace=False)
        flat[pick] = np.array([np.nan, np.inf, -np.inf, 1e30],
                              np.float32)[np.arange(40) % 4]
        return boxes
    boxes[0] = 0.0                          # an all-zero row
    boxes[1, 1:] = 0.0                      # a single box
    boxes[2, 1:] = 0.0
    boxes[2, 0] = 0.0
    boxes[2, n - 1] = (0.1, 0.1, 0.5, 0.5)  # a single box in the last slot
    boxes[3] = (0.2, 0.2, 0.6, 0.6)         # one box repeated: all but one go
    return boxes


@pytest.mark.parametrize("thr", [0.45, 0.7])
@pytest.mark.parametrize("case", [
    ("cluttered", 2, 1000), ("cluttered", 20, 256),
    ("cluttered", 3, 200),     # N off a multiple of 64 and of 128
    ("cluttered", 4, 70), ("degenerate", 4, 130), ("nonfinite", 3, 150)])
def test_nms_suppress_plain_equals_sequential_greedy(rng, case, thr):
    """The operator's plain version (the CPU implementation) against
    sequential greedy suppression written here in numpy fp32."""
    boxes = _rows(case, rng)
    got = torch.ops.xdt.nms_suppress(T(boxes), thr)
    assert got.dtype == torch.bool and got.shape == boxes.shape[:2]
    np.testing.assert_array_equal(got.numpy(), greedy_flags(boxes, thr))
    if case[0] == "degenerate":
        assert not got[:3].any() and got[3, 1:].all() and not got[3, 0]


@pytest.mark.parametrize("apart", [False, True])
@pytest.mark.parametrize("thr", [0.3, 0.45, 0.5, 0.7])
def test_nms_suppress_plain_at_the_threshold(thr, apart):
    """Pairs whose fp32 IoU is the fp32 threshold or one ulp off it: the
    box is suppressed exactly where its IoU exceeds fp32(thr) (0.3 rounds
    up in fp32, so a comparison in double would differ on it)."""
    boxes = edge_rows(thr, apart=apart)
    got = torch.ops.xdt.nms_suppress(T(boxes), thr).numpy()
    want = greedy_flags(boxes, thr)
    np.testing.assert_array_equal(got, want)
    j = 100 if apart else 1
    assert want[:, j].sum() == len(boxes) // 3     # the ulp above only


def test_nms_padded_suppresses_through_the_operator_once(rng):
    """``nms_padded`` makes one ``xdt::nms_suppress`` call (and no other
    suppression), and its kept boxes are the sequential oracle's."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Calls(TorchDispatchMode):
        names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._schema.name.startswith("xdt::"):
                self.names.append(func._schema.name)
            return func(*args, **(kwargs or {}))

    boxes, scores = random_cluttered_boxes(rng, 700)
    with Calls() as calls:
        got = N.nms_padded(T(boxes), T(scores), 300, 0.5, 0.05)
    assert calls.names == ["xdt::nms_suppress"]
    kept = np_greedy_nms(boxes, scores, 0.5, 0.05)[:300]
    assert int(got.valid.sum()) == len(kept)
    np.testing.assert_array_equal(got.boxes[:len(kept)].numpy(), boxes[kept])
