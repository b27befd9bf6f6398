"""The port's PSROIAlign (kernel B1) against the JAX package.

The port's plain gather version (the one CPU tensors take) is held to JAX's
``psroi_align_pallas`` (the TPU kernel, run in interpret mode on the CPU,
``precise=True``: fp32 operands) and to its gather oracle
``psroi_align_reference``. Both sides sum the same fp32 products in another
order: held to 1e-5.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from test_psroi import random_rois  # noqa: E402
from x_detector_tpu.ops.pallas import psroi_align_kernel as K  # noqa: E402
from x_detector_tpu.ops.psroi_align import (  # noqa: E402
    psroi_align_reference as jax_reference)
from x_detector_tpu_torch.ops import psroi_align as P  # noqa: E402

EDGE_ROIS = np.array([[0.0, 0.0, 1.0, 1.0],      # whole map
                      [0.9, 0.9, 1.0, 1.0],      # bottom-right corner
                      [0.0, 0.5, 0.0, 0.5],      # zero area on the edge
                      [0.3, 0.3, 0.3, 0.3],      # zero area inside
                      [0.999, 0.0, 1.0, 0.001],  # sliver at the bottom edge
                      [0.0, 0.0, 0.0, 0.0]], np.float32)


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run pallas_call in interpreter mode (no TPU here)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _rois(rng, n):
    return np.concatenate([EDGE_ROIS, random_rois(rng, n - len(EDGE_ROIS))])


@pytest.mark.parametrize("grid,c,h,w", [(7, 10, 13, 17), (3, 4, 10, 12),
                                        (7, 10, 4, 4)])
def test_plain_matches_jax_pallas_kernel(rng, interpret_mode, grid, c, h, w):
    feats = rng.normal(0, 1, (2, h, w, grid * grid * c)).astype(np.float32)
    rois = np.stack([_rois(rng, K.BLOCK_R) for _ in range(2)])
    ref = np.asarray(K.batched_psroi_align_pallas(
        jnp.asarray(feats), jnp.asarray(rois), grid=grid))
    got = P.batched_psroi_align(torch.from_numpy(feats),
                                torch.from_numpy(rois), grid).numpy()
    assert got.shape == ref.shape == (2, K.BLOCK_R, grid, grid, c)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("samples", [1, 2, 3])
def test_plain_matches_jax_gather_oracle(rng, samples):
    grid, c = 7, 10
    feat = rng.normal(0, 1, (9, 11, grid * grid * c)).astype(np.float32)
    rois = _rois(rng, 40)
    ref = np.asarray(jax_reference(jnp.asarray(feat), jnp.asarray(rois),
                                   grid=grid, samples=samples))
    got = P.psroi_align_reference(torch.from_numpy(feat)[None],
                                  torch.from_numpy(rois)[None], grid,
                                  samples)[0].numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_bf16_features_widen_exactly(rng):
    """The model hands the bf16 thin map straight to the op: pooling it must
    equal pooling its exact fp32 widening."""
    feat = torch.from_numpy(
        rng.normal(0, 1, (1, 6, 7, 49 * 2)).astype(np.float32)).bfloat16()
    rois = torch.from_numpy(_rois(rng, 16))[None]
    got = P.batched_psroi_align(feat, rois, 7)
    ref = P.batched_psroi_align(feat.float(), rois, 7)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, atol=0.0, rtol=0.0)


def test_wrapper_rejects_non_cuda_device_without_fallback(rng):
    feat = torch.zeros(1, 4, 4, 49, device="meta")
    rois = torch.zeros(1, 3, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        P.batched_psroi_align(feat, rois, 7)
    assert P.batched_psroi_align.launches == 0
