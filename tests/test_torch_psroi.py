"""The port's PSROIAlign (kernel B1) against the JAX package.

The port's plain gather version (the one CPU tensors take) is held to JAX's
``psroi_align_pallas`` (the TPU kernel, run in interpret mode on the CPU,
``precise=True``: fp32 operands) and to its gather oracle
``psroi_align_reference``. Both sides sum the same fp32 products in another
order: held to 1e-5.
"""

import functools
import pathlib
import sys

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

ROOT = pathlib.Path(__file__).resolve().parent.parent
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


# ---------------------------------------------------------------------------
# The backward kernel's host side: its launch plan and its culling predicate
# ---------------------------------------------------------------------------

# (B, H, W, R, grid, C, samples): config 4, then the card-only tests' shapes
BACKWARD_SHAPES = [(16, 50, 50, 1000, 7, 10, 2), (2, 13, 17, 300, 7, 10, 2),
                   (1, 50, 50, 1000, 7, 10, 2), (2, 9, 5, 40, 3, 3, 1),
                   (1, 23, 11, 70, 7, 20, 4), (2, 50, 50, 2000, 7, 10, 2),
                   (2, 37, 23, 500, 7, 10, 2), (1, 50, 50, 1200, 7, 10, 2),
                   (2, 13, 17, 1, 7, 10, 2), (1, 20, 30, 200, 7, 32, 4),
                   (2, 50, 50, 1000, 7, 10, 2), (1, 5, 4, 5, 3, 2, 2)]


@pytest.mark.parametrize("b,h,w,r,grid,c,samples", BACKWARD_SHAPES)
def test_backward_plan_covers_every_output_once_and_fits(b, h, w, r, grid, c,
                                                         samples):
    """Tiles x channel blocks write every (pixel, channel) of an image
    exactly once; the list fits 232,448 bytes of shared memory."""
    plan = P.plan_backward(h, w, r, grid, c)
    kkc = grid * grid * c
    hits = np.zeros((h, w, kkc), np.int32)
    for u in range(plan.tiles_h * plan.tiles_w):
        row0, col0 = plan.tile(u)
        for ch0 in range(0, plan.passes * plan.threads, plan.threads):
            hits[row0:row0 + plan.th, col0:col0 + plan.tw,
                 ch0:ch0 + plan.threads] += 1
    assert (hits == 1).all()
    assert (plan.tiles_h - 1) * plan.th < h          # no tile left empty
    assert (plan.tiles_w - 1) * plan.tw < w
    assert (plan.passes - 1) * plan.threads < kkc
    assert plan.smem_bytes == P.backward_smem_bytes(plan.th, plan.tw, grid,
                                                    plan.cap) <= P.SMEM_LIMIT
    assert plan.threads % 32 == 0 and plan.cap % 32 == 0
    assert plan.threads <= 512 and 32 <= plan.cap
    assert (plan.th, plan.tw) == P.BACKWARD_TILE


def test_backward_plan_at_config_4_leaves_no_dead_pixels():
    plan = P.plan_backward(50, 50, 1000, 7, 10)
    assert plan.tiles_h * plan.th == 50 and plan.tiles_w * plan.tw == 50
    assert plan.passes == 1 and plan.threads == 512


def test_backward_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="grid 33"):
        P.plan_backward(8, 8, 3, 33, 1)
    small = P.plan_backward(8, 8, 3, 3, 2)        # 18 channels: 32 threads
    assert small.threads == 32 and small.cap == 32
    assert small.smem_bytes * 4 <= P.SMEM_PER_SM - 4096  # four blocks an SM


def test_backward_kernel_constants_mirror_the_source():
    """The tile, the shared-memory layout and the limits the plan assumes
    are the ones csrc/psroi_align.cu compiles."""
    src = (pathlib.Path(P.__file__).resolve().parent.parent / "csrc"
           / "psroi_align.cu").read_text()
    assert "constexpr int kTileH = 5, kTileW = 10;" in src
    assert P.BACKWARD_TILE == (5, 10)
    assert "constexpr int kEntryBytes = 16;" in src and P._ENTRY_BYTES == 16
    assert "constexpr int kWarpListBytes = 32 * 32 * 4;" in src
    assert P._WORK_BYTES == 32 * 32 * 4
    assert "constexpr int kCountBytes = 32 * 4;" in src
    assert P._COUNT_BYTES == 32 * 4
    assert "constexpr int kMaxGrid = 32;" in src
    assert "constexpr int kMaxBwdThreads = 512;" in src
    assert "constexpr int kMaxSamples = 4;" in src


def sample_extents(coords: torch.Tensor) -> torch.Tensor:
    """The kernel's pre-pass along one axis (``psroi_align_bwd_prepare``):
    [..., k, S] sample coordinates -> [..., 2], the least and the greatest
    of the first and the last sample."""
    ends = torch.stack([coords[..., 0, 0], coords[..., -1, -1]], -1)
    return torch.stack([ends.min(-1).values, ends.max(-1).values], -1)


def reaches(extents: torch.Tensor, first: int, last: int) -> torch.Tensor:
    """The kernel's culling test along one axis: some sample may lie within
    one pixel of pixels [first, last]. [...] bool."""
    return (extents[..., 1] > first - 1.0) & (extents[..., 0] < last + 1.0)


def _culling_rois(rng):
    """Seeded random rois, the edge and zero-area rois of this file, the
    card tests and chip_smoke.config_rois, and rois near each edge."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    smoke = chip_smoke.config_rois(torch.Generator().manual_seed(0), 1, 40,
                                   "cpu")[0].numpy()
    lo = rng.uniform(0, 0.8, (60, 2))
    sizes = rng.uniform(0, 0.5, (60, 2)) * (rng.uniform(size=(60, 1)) < 0.8)
    near = np.concatenate([lo, np.minimum(lo + sizes, 1.0)], -1)
    return torch.from_numpy(np.concatenate([
        EDGE_ROIS, random_rois(rng, 60), smoke, near,
        [[0.3, 0.3, 0.31, 0.31], [0.3, 0.3, 0.3, 0.3]]]).astype(np.float32))


@pytest.mark.parametrize("samples", [1, 2, 3, 4])
def test_culling_test_never_culls_a_weighted_roi(rng, samples):
    """Along either axis, for tiles of 1, 3, 5 and 10 pixels (the kernel's
    5 x 10 and others) and every tile: a roi with a non-zero weight
    (``_interp_weights``) on a pixel of the tile passes the kernel's test,
    so the tile lists it. The extents of
    the first and the last sample are those of all samples (the coordinates
    are monotone), and the test culls some rois."""
    rois = _culling_rois(rng)
    grid, culled = 7, 0
    sides = sorted({1, 3, *P.BACKWARD_TILE})
    for extent, lo, hi in ((23, 0, 2), (37, 1, 3)):
        coords = P._sample_coords(rois, grid, samples, extent, lo, hi)
        ext = sample_extents(coords)
        flat = coords.flatten(-2)
        assert torch.equal(ext[:, 0], flat.min(-1).values)
        assert torch.equal(ext[:, 1], flat.max(-1).values)
        weights = P._interp_weights(coords, extent)       # [R, k, extent]
        for size in sides:
            for first in range(0, extent, size):
                last = min(first + size, extent) - 1
                weighted = (weights[..., first:last + 1] > 0).any(-1).any(-1)
                passed = reaches(ext, first, last)
                assert not (weighted & ~passed).any(), (extent, size, first)
                culled += int((~passed).sum())
    assert culled > 0


def test_culled_rois_change_no_bit_of_the_tile(rng):
    """The plain backward with only the rois the kernel lists for a tile
    (and not those with a zero gradient row) gives the tile the same bits
    as with every roi: the culled rois add exact zeros there."""
    grid, c, samples, h, w = 7, 2, 2, 23, 37
    rois = _culling_rois(rng)[None]
    g = torch.from_numpy(rng.normal(0, 1, (1, rois.shape[1], grid, grid, c)
                                    ).astype(np.float32))
    g[:, ::3] = 0.0
    full = P.psroi_align_backward_reference(g, rois, h, w, torch.float32,
                                            grid, samples)
    nonzero = (g != 0).flatten(2).any(-1)[0]
    ys = sample_extents(P._sample_coords(rois, grid, samples, h, 0, 2)[0])
    xs = sample_extents(P._sample_coords(rois, grid, samples, w, 1, 3)[0])
    plan = P.plan_backward(h, w, rois.shape[1], grid, c)
    for u in range(plan.tiles_h * plan.tiles_w):
        row0, col0 = plan.tile(u)
        row1, col1 = min(row0 + plan.th, h), min(col0 + plan.tw, w)
        listed = (nonzero & reaches(ys, row0, row1 - 1)
                  & reaches(xs, col0, col1 - 1))
        kept = P.psroi_align_backward_reference(
            g * listed[None, :, None, None, None], rois, h, w,
            torch.float32, grid, samples)
        assert torch.equal(kept[:, row0:row1, col0:col1],
                           full[:, row0:row1, col0:col1]), u


def test_train_step_upstream_gradient_has_at_most_ohem_topk_rows():
    """The tiny CPU train step of tests/test_torch_train.py: the gradient
    that reaches PSROIAlign's backward is non-zero on at most ``ohem_topk``
    rois per image (the RoI head works per roi and OHEM keeps only its
    hardest), the claim behind the kernel's skipping of zero rows."""
    from test_train import get_batch, small_lighthead_cfg
    from x_detector_tpu_torch.train.trainer import (create_model_and_state,
                                                    make_train_step)
    cfg = small_lighthead_cfg()
    state = create_model_and_state(cfg, "cpu", seed=0, dtype=torch.float32)
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in get_batch(cfg).items()}
    seen = []
    right = P.psroi_align_backward

    def record(grad, *args, **kwargs):
        seen.append(grad.detach().clone())
        return right(grad, *args, **kwargs)

    P.psroi_align_backward = record
    try:
        make_train_step(state.model, cfg)(state, batch,
                                          torch.Generator().manual_seed(0))
    finally:
        P.psroi_align_backward = right
    grad, = seen
    b, r = grad.shape[:2]
    assert b == cfg.train.batch_size and r > cfg.train.ohem_topk
    rows = (grad.reshape(b, r, -1) != 0).any(-1).sum(-1)
    assert (rows <= cfg.train.ohem_topk).all() and (rows > 0).all(), rows
