"""The port's train augmentation and synthetic data against the JAX package.

The apply halves get JAX's own draws, reproduced by the same
``jax.random`` splits as ``x_detector_tpu/data/augment.py``, and are held to
the JAX functions on the same numpy-seeded inputs. The draw halves cannot
give JAX's bits (another generator), so they are held to their ranges and to
JAX's distributions, in the manner of ``tests/test_augment_tf_oracle.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

from x_detector_tpu.config import DataConfig  # noqa: E402
from x_detector_tpu.data import augment as JA  # noqa: E402
from x_detector_tpu.data import synthetic as JS  # noqa: E402
from x_detector_tpu.ops import boxes as jax_boxes  # noqa: E402
from x_detector_tpu_torch.data import augment as A  # noqa: E402
from x_detector_tpu_torch.data import synthetic as S  # noqa: E402
from x_detector_tpu_torch.ops import boxes as box_ops  # noqa: E402

CFG = DataConfig(image_size=32, max_gt_boxes=6, crop_attempts=20)


def _t(x):
    return torch.from_numpy(np.array(x))


def _gt(rng, batch, g=6):
    """Padded gt per image: 3, 1 and 0 valid boxes, cycling."""
    boxes = np.zeros((batch, g, 4), np.float32)
    mask = np.zeros((batch, g), bool)
    for b in range(batch):
        n = (3, 1, 0)[b % 3]
        lo = rng.uniform(0, 0.6, (n, 2))
        boxes[b, :n] = np.concatenate(
            [lo, lo + rng.uniform(0.1, 0.4, (n, 2))], -1)
        mask[b, :n] = True
    labels = np.where(mask, rng.integers(1, 21, (batch, g)), 0).astype(
        np.int32)
    return boxes, labels, mask


def jax_crop_draws(keys, cfg):
    """The draws of JAX's ``sample_distorted_box``, one key per image."""
    n, out = cfg.crop_attempts, []
    for key in keys:
        k_aspect, k_area, k_y, k_x = jax.random.split(key, 4)
        aspect = jax.random.uniform(k_aspect, (n,),
                                    minval=cfg.aspect_ratio_range[0],
                                    maxval=cfg.aspect_ratio_range[1])
        if cfg.crop_sampler == "r1":
            area = jax.random.uniform(k_area, (n,), minval=cfg.area_range[0],
                                      maxval=cfg.area_range[1])
        else:
            area = jax.random.uniform(k_area, (n,))
        out.append([aspect, area, jax.random.uniform(k_y, (n,)),
                    jax.random.uniform(k_x, (n,))])
    return A.CropDraws(*(_t(np.stack([np.asarray(o[i]) for o in out]))
                         for i in range(4)))


def jax_color_draws(keys, cfg):
    """The draws of JAX's ``distort_color``, one key per image."""
    cols = [[] for _ in range(5)]
    for key in keys:
        ks = jax.random.split(key, 5)
        vals = [
            jax.random.uniform(ks[0], (), minval=-cfg.brightness_max_delta,
                               maxval=cfg.brightness_max_delta),
            jax.random.uniform(ks[1], (), minval=cfg.saturation_range[0],
                               maxval=cfg.saturation_range[1]),
            jax.random.uniform(ks[2], (), minval=-cfg.hue_max_delta,
                               maxval=cfg.hue_max_delta) * 2.0 * jnp.pi,
            jax.random.uniform(ks[3], (), minval=cfg.contrast_range[0],
                               maxval=cfg.contrast_range[1]),
            jax.random.bernoulli(ks[4])]
        for c, v in zip(cols, vals):
            c.append(np.asarray(v))
    return A.ColorDraws(*(_t(np.stack(c)) for c in cols))


def jax_augment_draws(key, batch, cfg):
    """The draws of JAX's ``preprocess_batch_for_train``: one key per image,
    split into (crop, colour, flip)."""
    keys = jax.random.split(key, batch)
    parts = [jax.random.split(k, 3) for k in keys]
    flip = np.stack([np.asarray(jax.random.bernoulli(p[2])) for p in parts])
    return A.AugmentDraws(jax_crop_draws([p[0] for p in parts], cfg),
                          jax_color_draws([p[1] for p in parts], cfg),
                          _t(flip))


@pytest.mark.parametrize("sampler,letterbox", [("tf", False), ("tf", True),
                                               ("r1", False)])
def test_crop_window_matches_jax(rng, sampler, letterbox):
    """Given JAX's draws: the same window, to the fp32 ulp (elementwise
    ops in the same order); the fallback and no-gt images included."""
    cfg = dataclasses.replace(CFG, crop_sampler=sampler,
                              min_object_covered=0.5)
    b = 6
    gtb, _, gtm = _gt(rng, b)
    keys = jax.random.split(jax.random.PRNGKey(1), b)
    scale = (rng.uniform(0.5, 1.0, (b, 2)).astype(np.float32) if letterbox
             else None)
    got = A.sample_distorted_box(jax_crop_draws(keys, cfg), _t(gtb), _t(gtm),
                                 cfg, None if scale is None else _t(scale))
    for i in range(b):
        ref = JA.sample_distorted_box(
            keys[i], jnp.asarray(gtb[i]), jnp.asarray(gtm[i]), cfg,
            None if scale is None else jnp.asarray(scale[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref),
                                   atol=1e-7, rtol=1e-6)


def test_crop_fallback_matches_jax():
    cfg = DataConfig(image_size=32, min_object_covered=1.0,
                     area_range=(0.01, 0.02), crop_attempts=10)
    gtb = np.array([[[0.0, 0.0, 1.0, 1.0]]], np.float32)
    gtm = np.array([[True]])
    keys = jax.random.split(jax.random.PRNGKey(0), 1)
    got = A.sample_distorted_box(jax_crop_draws(keys, cfg), _t(gtb), _t(gtm),
                                 cfg)
    np.testing.assert_array_equal(got[0].numpy(), [0, 0, 1, 1])


def test_box_transform_matches_jax(rng):
    b = 5
    gtb, _, gtm = _gt(rng, b)
    lo = rng.uniform(0, 0.4, (b, 2))
    crop = np.concatenate([lo, lo + rng.uniform(0.3, 0.6, (b, 2))],
                          -1).astype(np.float32)
    boxes, keep = A.transform_boxes_to_crop(_t(gtb), _t(gtm), _t(crop), 0.3)
    for i in range(b):
        rb, rk = JA.transform_boxes_to_crop(
            jnp.asarray(gtb[i]), jnp.asarray(gtm[i]), jnp.asarray(crop[i]),
            0.3)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(rk))
        np.testing.assert_allclose(boxes[i].numpy(), np.asarray(rb),
                                   atol=1e-7, rtol=1e-6)


def test_box_helpers_match_jax(rng):
    a = np.concatenate([np.zeros((1, 4), np.float32),
                        _gt(rng, 1, 5)[0][0]]).astype(np.float32)
    bb = _gt(rng, 1, 4)[0][0]
    np.testing.assert_allclose(box_ops.ioa(_t(a), _t(bb)).numpy(),
                               np.asarray(jax_boxes.ioa(a, bb)), atol=1e-7)
    np.testing.assert_array_equal(
        box_ops.flip_boxes_horizontal(_t(a)).numpy(),
        np.asarray(jax_boxes.flip_boxes_horizontal(jnp.asarray(a))))
    anchors = _gt(rng, 1, 5)[0][0] + 0.05
    np.testing.assert_allclose(
        box_ops.encode(_t(a[1:]), _t(anchors)).numpy(),
        np.asarray(jax_boxes.encode(jnp.asarray(a[1:]),
                                    jnp.asarray(anchors))),
        atol=1e-6, rtol=1e-6)


def test_crop_and_resize_matches_jax(rng):
    """Two fp32 contractions summed in another order: 1e-4 on [0, 255]."""
    img = rng.uniform(0, 255, (3, 20, 24, 3)).astype(np.float32)
    crop = np.array([[0.1, 0.2, 0.7, 0.9], [0.0, 0.0, 1.0, 1.0],
                     [0.5, 0.5, 0.5, 0.6]], np.float32)
    got = A.crop_and_resize(_t(img), _t(crop), 16)
    for i in range(3):
        ref = JA.crop_and_resize(jnp.asarray(img[i]), jnp.asarray(crop[i]), 16)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=0)


def test_color_ops_match_jax(rng):
    """Each adjust_* on [0, 1] images: within 1e-6 (a mean or a 3-term
    product summed in another order)."""
    img = rng.uniform(0, 1, (2, 8, 9, 3)).astype(np.float32)
    v = np.array([0.3, -0.7], np.float32)
    f = np.array([0.6, 1.4], np.float32)
    cases = [(A.adjust_brightness, JA.adjust_brightness, v),
             (A.adjust_contrast, JA.adjust_contrast, f),
             (A.adjust_saturation, JA.adjust_saturation, f),
             (A.adjust_hue, JA.adjust_hue, v)]
    for port_fn, jax_fn, arg in cases:
        got = port_fn(_t(img), _t(arg))
        for i in range(2):
            np.testing.assert_allclose(
                got[i].numpy(), np.asarray(jax_fn(jnp.asarray(img[i]),
                                                  jnp.asarray(arg[i]))),
                atol=1e-6, err_msg=port_fn.__name__)
    zero = A.adjust_hue(_t(img), torch.zeros(2))
    np.testing.assert_allclose(zero.numpy(), img, atol=1e-6)


def test_distort_color_matches_jax(rng):
    img = rng.uniform(0, 1, (8, 8, 8, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(6), 8)   # both orders drawn
    draws = jax_color_draws(keys, CFG)
    assert draws.contrast_last.any() and not draws.contrast_last.all()
    got = A.distort_color(draws, _t(img))
    for i in range(8):
        ref = JA.distort_color(keys[i], jnp.asarray(img[i]), CFG)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref),
                                   atol=1e-6)


@pytest.mark.parametrize("letterbox", [False, True])
def test_preprocess_for_train_matches_jax(rng, letterbox):
    """The whole pipeline, crop to whiten, with flips, given JAX's draws:
    images within 2e-3 on the [0, 255] scale (the resize's 1e-4, scaled up
    to ~2.3x by the contrast and saturation factors, plus the colour ops'
    1e-6 on [0, 1], 2.6e-4 at 255), boxes within 1e-6, masks and labels
    exact."""
    b = 6
    gtb, gtl, gtm = _gt(rng, b)
    batch = {"image": rng.uniform(0, 255, (b, 40, 40, 3)).astype(np.float32),
             "gt_boxes": gtb, "gt_labels": gtl, "gt_mask": gtm}
    if letterbox:
        batch["box_scale"] = rng.uniform(0.6, 1.0, (b, 2)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    ref = JA.preprocess_batch_for_train(
        key, {k: jnp.asarray(v) for k, v in batch.items()}, CFG)
    draws = jax_augment_draws(key, b, CFG)
    assert draws.flip.any() and not draws.flip.all()
    t = {k: _t(v) for k, v in batch.items()}
    got = A.preprocess_for_train(draws, t["image"], t["gt_boxes"],
                                 t["gt_labels"], t["gt_mask"], CFG,
                                 t.get("box_scale"))
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(ref["image"]),
                               atol=2e-3, rtol=0)
    np.testing.assert_allclose(got["gt_boxes"].numpy(),
                               np.asarray(ref["gt_boxes"]), atol=1e-6)
    for k in ("gt_labels", "gt_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_preprocess_batch_for_train_passes_difficult_through(rng):
    """The batch entry point draws its own values and keeps the gt slots:
    ``difficult`` passes through unchanged, as in the JAX package."""
    gtb, gtl, gtm = _gt(rng, 4)
    batch = {"image": rng.uniform(0, 255, (4, 40, 40, 3)).astype(np.float32),
             "gt_boxes": gtb, "gt_labels": gtl, "gt_mask": gtm,
             "difficult": rng.random((4, 6)) < 0.3}
    out = A.preprocess_batch_for_train(torch.Generator().manual_seed(0),
                                       {k: _t(v) for k, v in batch.items()},
                                       CFG)
    ref = JA.preprocess_batch_for_train(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()},
        CFG)
    assert set(out) == set(ref)
    assert out["image"].shape == ref["image"].shape == (4, 32, 32, 3)
    np.testing.assert_array_equal(out["difficult"].numpy(),
                                  batch["difficult"])
    assert not (out["gt_mask"].numpy() & ~gtm).any()
    assert not out["gt_labels"][~out["gt_mask"]].any()


def _marginals(s):
    h = s[:, 2] - s[:, 0]
    w = s[:, 3] - s[:, 1]
    return {"h": h, "aspect": w / np.maximum(h, 1e-6), "cy": s[:, 0] + h / 2,
            "cx": s[:, 1] + w / 2}


@pytest.mark.parametrize("sampler", ["tf", "r1"])
def test_crop_draws_follow_jax_distribution(sampler):
    """The port's own draws against JAX's sampler over 1500 crops each: the
    same marginals (two-sample KS < 0.06) and every crop inside the image
    with aspect and area in range."""
    n = 1500
    cfg = dataclasses.replace(CFG, crop_sampler=sampler)
    gtb = np.array([[0.3, 0.3, 0.7, 0.7]], np.float32)
    gtm = np.array([True])
    gen = torch.Generator().manual_seed(0)
    ours = A.sample_distorted_box(
        A.draw_crop(gen, n, cfg), _t(gtb)[None].expand(n, -1, -1),
        _t(gtm)[None].expand(n, -1), cfg).numpy()
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    theirs = np.asarray(jax.jit(jax.vmap(lambda k: JA.sample_distorted_box(
        k, jnp.asarray(gtb), jnp.asarray(gtm), cfg)))(keys))
    assert (ours >= 0).all() and (ours <= 1 + 1e-6).all()
    m = _marginals(ours)
    crop = m["h"] < 0.999
    assert ((m["aspect"][crop] >= cfg.aspect_ratio_range[0] - 1e-4)
            & (m["aspect"][crop] <= cfg.aspect_ratio_range[1] + 1e-4)).all()
    area = m["h"] * m["aspect"] * m["h"]
    assert (area[crop] >= cfg.area_range[0] - 1e-4).all()
    mt = _marginals(theirs)
    for k in m:
        assert stats.ks_2samp(m[k], mt[k]).statistic < 0.06, k


def test_color_and_flip_draws_cover_their_ranges():
    n = 4000
    gen = torch.Generator().manual_seed(1)
    d = A.draw_augment(gen, n, CFG)
    c = d.color
    assert c.brightness.abs().max() <= CFG.brightness_max_delta
    for v, (lo, hi) in ((c.saturation, CFG.saturation_range),
                        (c.contrast, CFG.contrast_range)):
        assert lo <= v.min() and v.max() < hi
        assert abs(v.mean().item() - (lo + hi) / 2) < 0.02
    assert c.hue.abs().max() <= CFG.hue_max_delta * 2 * np.pi + 1e-6
    for flag in (c.contrast_last, d.flip):
        assert abs(flag.float().mean().item() - 0.5) < 0.03
    assert d.crop.aspect.shape == (n, CFG.crop_attempts)


def test_synthetic_batches_equal_the_jax_packages():
    ours = next(S.synthetic_batches(3, 2, 32, max_gt=5))
    theirs = next(JS.synthetic_batches(3, 2, 32, max_gt=5))
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_synthetic_batch_device_invariants():
    """The JAX generator's task family: 1 to 6 boxes per image of sides
    in [0.15, 0.5] inside the image, labels 1..20 on valid rows, zeros on
    padding, pixels in [0, 255] and boxes painted in their class colour."""
    gen = torch.Generator().manual_seed(0)
    b = S.synthetic_batch_device(gen, 8, 48, max_gt=10)
    assert b["image"].shape == (8, 48, 48, 3)
    assert b["image"].dtype == torch.float32
    assert b["gt_labels"].dtype == torch.int32 and b["gt_mask"].dtype == \
        torch.bool
    n = b["gt_mask"].sum(dim=1)
    assert ((n >= 1) & (n <= 6)).all()
    assert (b["gt_mask"][:, :-1] >= b["gt_mask"][:, 1:]).all()
    m = b["gt_mask"]
    boxes, labels = b["gt_boxes"][m], b["gt_labels"][m]
    sides = boxes[:, 2:] - boxes[:, :2]
    assert ((sides >= 0.15 - 1e-6) & (sides <= 0.5 + 1e-6)).all()
    assert ((boxes >= 0) & (boxes <= 1)).all()
    assert ((labels >= 1) & (labels <= 20)).all()
    assert not b["gt_boxes"][~m].any() and not b["gt_labels"][~m].any()
    assert 0 <= b["image"].min() and b["image"].max() <= 255
    assert b["image"].max() > 100          # painted boxes, not just noise
    again = S.synthetic_batch_device(torch.Generator().manual_seed(0), 8, 48,
                                     max_gt=10)
    for k in b:
        torch.testing.assert_close(b[k], again[k], atol=0, rtol=0)
