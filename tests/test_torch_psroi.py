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
                                        (7, 10, 4, 4), (3, 3, 10, 12)])
def test_plain_matches_jax_pallas_kernel(rng, interpret_mode, grid, c, h, w):
    feats = rng.normal(0, 1, (2, h, w, grid * grid * c)).astype(np.float32)
    rois = np.stack([_rois(rng, K.BLOCK_R) for _ in range(2)])
    ref = np.asarray(K.batched_psroi_align_pallas(
        jnp.asarray(feats), jnp.asarray(rois), grid=grid))
    got = P.batched_psroi_align(torch.from_numpy(feats),
                                torch.from_numpy(rois), grid).numpy()
    assert got.shape == ref.shape == (2, K.BLOCK_R, grid, grid, c)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_plain_matches_jax_pallas_kernel_at_four_samples(rng,
                                                         interpret_mode):
    """S = 4, which the forward kernel takes at run time (it fixes only S
    = 2 at compile time): the TPU kernel in interpret mode, a small map."""
    grid, c, h, w = 3, 4, 10, 12
    feats = rng.normal(0, 1, (2, h, w, grid * grid * c)).astype(np.float32)
    rois = np.stack([_rois(rng, K.BLOCK_R) for _ in range(2)])
    ref = np.asarray(K.batched_psroi_align_pallas(
        jnp.asarray(feats), jnp.asarray(rois), grid=grid, samples=4))
    got = P.batched_psroi_align(torch.from_numpy(feats),
                                torch.from_numpy(rois), grid, 4).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("samples", [1, 2, 3, 4])
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


def _outside_rois(rng, n):
    """Rois drawn from [-0.5, 1.5]: partly or wholly off the map, some with
    their corners swapped."""
    return rng.uniform(-0.5, 1.5, (n, 4)).astype(np.float32)


@pytest.mark.parametrize("samples", [2, 4])
def test_plain_matches_jax_gather_oracle_outside_the_map(rng, samples):
    """Rois outside [0, 1] clamp as the JAX package clamps them."""
    grid, c = 7, 10
    feat = rng.normal(0, 1, (9, 11, grid * grid * c)).astype(np.float32)
    rois = np.concatenate([EDGE_ROIS, _outside_rois(rng, 40)])
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


def test_wrapper_rejects_non_cuda_device_without_fallback(rng,
                                                          monkeypatch):
    """On the meta device the operator gives only its output's shape (its
    fake implementation), not the plain version's values; the CUDA
    implementation raises on tensors that are not on a card."""
    monkeypatch.setattr(P, "psroi_align_reference", None)
    feat = torch.zeros(1, 4, 4, 49, device="meta")
    rois = torch.zeros(1, 3, 4, device="meta")
    out = P.batched_psroi_align(feat, rois, 7)
    assert out.device.type == "meta" and out.shape == (1, 3, 7, 7, 1)
    with pytest.raises(ValueError, match="CUDA"):
        P.forward_cuda(torch.zeros(1, 4, 4, 49), torch.zeros(1, 3, 4), 7, 2)
    with pytest.raises(ValueError, match="CUDA"):
        P.backward_cuda(torch.zeros(1, 3, 7, 7, 1), torch.zeros(1, 3, 4), 4,
                        4, torch.float32, 7, 2)
    assert P.batched_psroi_align.launches == 0


# ---------------------------------------------------------------------------
# The forward kernel's host side: its launch plan, its walk and its tap table
# ---------------------------------------------------------------------------

# (B, R, grid, C, samples): configs 3 and 4, then the card-only tests' shapes
FORWARD_SHAPES = [(16, 512, 7, 10, 2), (16, 1000, 7, 10, 2),
                  (2, 300, 7, 10, 2), (2, 512, 7, 10, 2),
                  (2, 1000, 7, 10, 2), (2, 40, 3, 3, 2), (2, 100, 7, 20, 1),
                  (1, 70, 7, 20, 4), (1, 100, 7, 32, 3), (1, 60, 7, 32, 4),
                  (2, 1, 7, 10, 2), (2, 200, 7, 10, 2), (1, 1, 2240, 1, 2),
                  (1, 1, 4900, 1, 1),
                  (1, 5, 3, 2, 2)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("b,r,grid,c,samples", FORWARD_SHAPES)
def test_forward_plan_covers_every_roi_once_and_fits(b, r, grid, c, samples,
                                                     aligned):
    """The blocks take every (image, roi) exactly once, none empty; the
    tap table fits 232,448 bytes (or, where one roi's does not, none is
    kept); pairs only for even C and aligned features."""
    plan = P.plan_forward(b, r, grid, c, samples, aligned)
    hits = np.zeros((b, r), np.int32)
    for block in range(b * plan.blocks_per_image):
        image, r0, n = plan.rois(block, r)
        assert n >= 1
        hits[image, r0:r0 + n] += 1
    assert (hits == 1).all()
    assert plan.paired == (c % 2 == 0 and aligned)
    assert plan.lanes_per_roi == grid * grid * (c // 2 if plan.paired else c)
    table = P.forward_table_bytes(grid, samples)
    assert plan.tabled == (table <= P.SMEM_LIMIT)
    assert plan.smem_bytes == (plan.rois_per_block * table if plan.tabled
                               else 0) <= P.SMEM_LIMIT
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
    assert plan.threads < plan.rois_per_block * plan.lanes_per_roi + 32
    assert (plan.rois_per_block * plan.lanes_per_roi
            + P.FORWARD_MAX_THREADS < 2 ** 31)


def test_forward_plan_at_configs_3_and_4():
    """Pairs of bf16 channels, a table a few KB, no block left short but an
    image's last."""
    for r in (512, 1000):
        plan = P.plan_forward(16, r, 7, 10, 2, True)
        assert plan.paired and plan.tabled and plan.lanes_per_roi == 245
        assert plan.smem_bytes <= 48 * 1024          # no opt-in needed
    assert not P.plan_forward(16, 512, 7, 10, 2, False).paired
    assert not P.plan_forward(16, 512, 7, 5, 2, True).paired
    with pytest.raises(ValueError, match="samples=0"):
        P.plan_forward(1, 3, 7, 10, 0, True)


def walk(plan, n: int, grid: int, c: int):
    """The kernel's walk of a block of ``n`` rois, mirrored: for each
    thread, its lanes e (blockDim.x apart) with the (roi, i, j, c) its
    loop counters give."""
    per_bin = c // 2 if plan.paired else c
    per_roi = grid * grid * per_bin
    t_roi, rest = divmod(plan.threads, per_roi)
    t_c, t_i, t_j = rest % per_bin, rest // per_bin // grid, (
        rest // per_bin % grid)
    for t in range(plan.threads):
        roi, rest = divmod(t, per_roi)
        ch, i, j = rest % per_bin, rest // per_bin // grid, (
            rest // per_bin % grid)
        for e in range(t, n * per_roi, plan.threads):
            yield e, (roi, i, j, ch)
            ch += t_c
            carry = ch >= per_bin
            ch -= per_bin if carry else 0
            j += t_j + carry
            carry = j >= grid
            j -= grid if carry else 0
            i += t_i + carry
            carry = i >= grid
            i -= grid if carry else 0
            roi += t_roi + carry


@pytest.mark.parametrize("b,r,grid,c,samples", [
    (16, 512, 7, 10, 2), (2, 40, 3, 3, 2), (1, 60, 7, 32, 4),
    (2, 1, 7, 10, 2), (1, 5, 3, 2, 2)])
def test_forward_walk_covers_every_output_once(b, r, grid, c, samples):
    """The loop counters give each lane the (roi, i, j, c) that division
    would, and the block's lanes cover its outputs once, in a full block
    and in an image's last."""
    plan = P.plan_forward(b, r, grid, c, samples, True)
    per_bin = c // 2 if plan.paired else c
    for n in {plan.rois_per_block, r - (plan.blocks_per_image - 1)
              * plan.rois_per_block}:
        lanes = [e for e, digits in walk(plan, n, grid, c)
                 if digits == (e // (grid * grid * per_bin),
                               e // per_bin // grid % grid,
                               e // per_bin % grid, e % per_bin)]
        assert sorted(lanes) == list(range(n * grid * grid * per_bin))


def taps(rois: torch.Tensor, grid: int, samples: int, extent: int,
         lo: int, hi: int):
    """The kernel's tap table along one axis, mirrored (``make_tap``): for
    each roi, cell and sample, the pixels of its two taps and their weights
    1 - f and f, in fp32: ([R, k, S, 2] pixels, [R, k, S, 2] weights)."""
    coords = P._sample_coords(rois, grid, samples, extent, lo, hi)
    p0 = coords.floor()
    f = coords - p0
    pix = torch.stack([p0, (p0 + 1).clamp(max=extent - 1)], -1).long()
    return pix, torch.stack([1.0 - f, f], -1)


@pytest.mark.parametrize("samples", [1, 2, 3, 4])
def test_tap_table_holds_the_triangular_weights(rng, samples):
    """Summed over the samples, the taps' weights are ``_interp_weights``
    (to an ulp: 1 - (p0 + 1 - c) against c - p0), and the forward from
    them in the TPU kernel's separable form is the plain version's within
    1e-5. Seeded, edge, zero-area, swapped and off-map rois."""
    grid, c, h, w = 7, 3, 13, 17
    rois = torch.from_numpy(np.concatenate([
        EDGE_ROIS, random_rois(rng, 20), _outside_rois(rng, 20)]))
    dense = []
    for extent, lo, hi in ((h, 0, 2), (w, 1, 3)):
        pix, wt = taps(rois, grid, samples, extent, lo, hi)
        weights = torch.zeros(len(rois), grid, extent).scatter_add_(
            -1, pix.flatten(2), wt.flatten(2))
        want = P._interp_weights(P._sample_coords(
            rois, grid, samples, extent, lo, hi), extent)
        torch.testing.assert_close(weights, want, atol=1e-6, rtol=0)
        dense.append(weights)
    feat = torch.from_numpy(rng.normal(0, 1, (h, w, grid * grid * c)
                                       ).astype(np.float32))
    got = torch.einsum("rip,pqijc,rjq->rijc", dense[0],
                       feat.view(h, w, grid, grid, c), dense[1]) / (
        samples * samples)
    ref = P.psroi_align_reference(feat[None], rois[None], grid, samples)[0]
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_forward_kernel_constants_mirror_the_source():
    """The thread limit and the tap table's size the plan assumes are the
    ones csrc/psroi_align.cu compiles and checks."""
    src = (pathlib.Path(P.__file__).resolve().parent.parent / "csrc"
           / "psroi_align.cu").read_text()
    assert "constexpr int kMaxFwdThreads = 512;" in src
    assert P.FORWARD_MAX_THREADS == 512
    assert "struct Tap {\n  long long o0, o1;\n  float w0, w1;\n};" in src
    assert P.FORWARD_TAP_BYTES == 2 * 8 + 2 * 4
    assert ("2LL * rois_per_block * grid * samples * (long long)sizeof(Tap)"
            in src)
    assert P.forward_table_bytes(7, 2) == 2 * 7 * 2 * P.FORWARD_TAP_BYTES


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
