"""The port's box geometry and anchors against the JAX package, elementwise.

Same fp32 formulas on the same inputs: held to 1e-6 (anchors, which are the
same numpy code, exactly).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from x_detector_tpu.config import AnchorConfig  # noqa: E402
from x_detector_tpu.ops import anchors as jax_anchors  # noqa: E402
from x_detector_tpu.ops import boxes as jax_boxes  # noqa: E402
from x_detector_tpu_torch.ops import anchors, boxes  # noqa: E402


def _boxes(rng, n):
    lo = rng.uniform(-0.2, 0.9, (n, 2))
    hw = rng.uniform(-0.05, 0.6, (n, 2))        # some inverted (degenerate)
    out = np.concatenate([lo, lo + hw], -1).astype(np.float32)
    out[:3] = 0.0                                # zero rows: padded boxes
    return out


@pytest.mark.parametrize("image_size", [64, 800, 100])
def test_rpn_anchors_equal(image_size):
    cfg = AnchorConfig()
    np.testing.assert_array_equal(anchors.rpn_anchors(image_size, cfg),
                                  jax_anchors.rpn_anchors(image_size, cfg))


@pytest.mark.parametrize("fn", ["area", "iou", "intersection", "clip_boxes"])
def test_geometry_matches_jax(rng, fn):
    a, b = _boxes(rng, 50), _boxes(rng, 40)
    if fn in ("area", "clip_boxes"):
        ref = getattr(jax_boxes, fn)(jnp.asarray(a))
        got = getattr(boxes, fn)(torch.from_numpy(a))
    else:
        ref = getattr(jax_boxes, fn)(jnp.asarray(a), jnp.asarray(b))
        got = getattr(boxes, fn)(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


def test_decode_matches_jax_including_the_clamp(rng):
    codes = rng.normal(0, 1, (3, 50, 4)).astype(np.float32)
    codes[0, :5, 2:] = 200.0           # exp clamp at +10
    codes[1, :5, 2:] = -200.0          # and at -10
    anc = _boxes(rng, 50)[None]
    ref = jax_boxes.decode(jnp.asarray(codes), jnp.asarray(anc))
    got = boxes.decode(torch.from_numpy(codes), torch.from_numpy(anc))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)
