"""The accuracy harnesses (``x_detector_tpu_torch/tools/``) against the JAX
package's (``tools/``) on the CPU, at ``smoke_shrink`` size in fp32.

The harnesses draw their train, held-out and calibration streams from
``torch.Generator``s, which JAX's keys cannot reproduce; so the parity
tests inject the same numpy batches into both packages: images from the
numpy ``synthetic_batches``, ground truth taken from JAX's own top
detections (so that the mAP moves with the detections instead of sitting
near 0, as it does for random weights on the synthetic gt). JAX weights
(BatchNorms moved off identity; the SSD's class convs scaled up 20x so
that no near-tie reaches the top 200, as ``tests/test_torch_maxpool_nms.py``
does) go to the port through ``from_jax_variables``. JAX's Light-Head
detects in fp32 here and pools with its PSROIAlign kernel (interpret
mode), as ``tests/test_torch_lighthead.py`` holds the models.

Tolerances: float detections equal in valid slots and classes, boxes and
scores within DET_ATOL (the whole-model tolerance of
``tests/test_torch_lighthead.py``), mAP within MAP_TOL; the int8 arm's mAP
within INT8_MAP_TOL of JAX's int8 mAP (whole int8 models sit within rtol
1e-3 / atol 1e-2 of each other, ``tests/test_torch_quant.py``, where an
activation crosses a rounding boundary of the int8 grid: that reorders
near-tied detections).
"""

import contextlib
import dataclasses
import functools
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from test_torch_resnet import jax_init, perturb_bn  # noqa: E402
from x_detector_tpu import quant as jax_quant  # noqa: E402
from x_detector_tpu.data.augment import (  # noqa: E402
    preprocess_for_eval as jax_preprocess)
from x_detector_tpu.data.synthetic import synthetic_batches  # noqa: E402
from x_detector_tpu.models import lighthead as L  # noqa: E402
from x_detector_tpu.models.ssd import SSDModel as JaxSSD  # noqa: E402
from x_detector_tpu.ops.pallas.psroi_align_kernel import (  # noqa: E402
    batched_psroi_align_pallas)
from x_detector_tpu.utils.metrics_voc import (  # noqa: E402
    VOCEvaluator as JaxVOCEvaluator)
from x_detector_tpu_torch.cli.train import (  # noqa: E402
    AUGMENT_STREAM, STEP_STREAM, position_generator)
from x_detector_tpu_torch.data.augment import (  # noqa: E402
    preprocess_batch_for_train)
from x_detector_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_batch_device)
from x_detector_tpu_torch.inference import build_model  # noqa: E402
from x_detector_tpu_torch.tools import calib_sensitivity  # noqa: E402
from x_detector_tpu_torch.tools import ema_ab  # noqa: E402
from x_detector_tpu_torch.tools import fast_nms_ab as ab  # noqa: E402
from x_detector_tpu_torch.tools import overfit  # noqa: E402
from x_detector_tpu_torch.tools import quant_ab  # noqa: E402
from x_detector_tpu_torch.tools import train_synthetic_capstone  # noqa: E402
from x_detector_tpu_torch.train.trainer import (  # noqa: E402
    create_model_and_state, make_train_step)
from x_detector_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))     # the JAX package's harnesses
try:
    import calib_sensitivity as jax_calib  # noqa: E402
    import fast_nms_ab as jax_ab  # noqa: E402
    import quant_ab as jax_quant_ab  # noqa: E402
finally:
    sys.path.remove(str(ROOT / "tools"))

DET_ATOL = 1e-4
MAP_TOL = 1e-4
INT8_MAP_TOL = 1e-2
FAMILIES = ("lighthead", "lighthead_resnet50", "ssd", "xdet")
GT_PER_IMAGE = 3


def _configs(fam):
    """(JAX's, the port's) smoke-size capstone config of ``fam``."""
    return (jax_ab.smoke_shrink(jax_ab.capstone_config(fam, 3000), fam),
            ab.smoke_shrink(ab.capstone_config(fam, 3000), fam))


# ---- the recipe -------------------------------------------------------------

@pytest.mark.parametrize("steps", [300, 3000, 12000])
@pytest.mark.parametrize("fam", FAMILIES)
def test_capstone_config_and_smoke_shrink_equal_jaxs(fam, steps):
    """Field for field, at full size and shrunk."""
    full = ab.capstone_config(fam, steps)
    assert (dataclasses.asdict(full)
            == dataclasses.asdict(jax_ab.capstone_config(fam, steps)))
    assert (dataclasses.asdict(ab.smoke_shrink(full, fam))
            == dataclasses.asdict(jax_ab.smoke_shrink(
                jax_ab.capstone_config(fam, steps), fam)))


def test_capstone_and_ema_recipes_equal_jaxs():
    """``train_synthetic_capstone``'s and ``ema_ab``'s configs against the
    ones the JAX package's scripts build in their bodies (restated here
    line by line: neither script can be imported without running)."""
    from x_detector_tpu.config import lighthead_xception, ssd_resnet50
    steps = 12000
    cfg = lighthead_xception(image_size=800)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, crop_sampler="r1"))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=16, learning_rate=3e-3, warmup_steps=200,
        lr_boundaries=(int(steps * 2 / 3), int(steps * 7 / 8)),
        lr_decays=(1.0, 0.3, 0.1), seed=1))
    got = train_synthetic_capstone.capstone_recipe(steps, seed=1, lr=3e-3,
                                                   sampler="r1")
    assert dataclasses.asdict(got) == dataclasses.asdict(cfg)
    steps = 3000
    cfg = ssd_resnet50(image_size=512)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=16, learning_rate=2e-3, warmup_steps=200,
        ema_decay=0.999,
        lr_boundaries=(int(steps * 0.7), int(steps * 0.9)),
        lr_decays=(1.0, 0.3, 0.1)))
    assert (dataclasses.asdict(ema_ab.ema_config(steps))
            == dataclasses.asdict(cfg))


def test_train_synthetic_is_the_documented_draws():
    """3 steps of ``train_synthetic`` equal 3 direct ``make_train_step``
    calls fed the draws its docstring names, bit for bit (weights and
    losses); a second run equals the first; another seed differs."""
    _, cfg = _configs("lighthead")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             seed=3))
    quiet = dict(log=lambda line: None)
    state, info = ab.train_synthetic(cfg, 3, "cpu", torch.float32, **quiet)
    ref = create_model_and_state(cfg, "cpu", seed=3, dtype=torch.float32)
    step = make_train_step(ref.model, cfg)
    cpu = torch.device("cpu")
    losses = []
    for i in range(3):
        raw = synthetic_batch_device(
            position_generator(cpu, 3, ab.DATA_STREAM, i), 2,
            int(64 * 1.2), 8)
        batch = preprocess_batch_for_train(
            position_generator(cpu, 3, AUGMENT_STREAM, i), raw, cfg.data)
        ref, metrics = step(ref, batch, position_generator(
            cpu, 3, STEP_STREAM, i))
        losses.append(float(metrics["total_loss"]))
    assert info["losses"] == losses
    assert info["train_loss"] == sum(losses) / 3
    want = ref.model.state_dict()
    for key, value in state.model.state_dict().items():
        assert torch.equal(value, want[key]), key
    again, info2 = ab.train_synthetic(cfg, 3, "cpu", torch.float32, **quiet)
    assert info2["losses"] == losses
    assert all(torch.equal(v, again.model.state_dict()[k])
               for k, v in state.model.state_dict().items())
    other = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                               seed=4))
    _, info3 = ab.train_synthetic(other, 3, "cpu", torch.float32, **quiet)
    assert info3["losses"] != losses


def test_streams_are_keyed_apart():
    """The held-out, calibration and train streams come from generators
    keyed apart: the held-out batch differs from a train batch of the
    same seed and index, and from the calibration stream."""
    _, cfg = _configs("ssd")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, seed=ab.HELD_OUT_SEED))
    held = ab.held_out_batch(cfg, "cpu", 0)["image"]
    train = synthetic_batch_device(position_generator(
        torch.device("cpu"), ab.HELD_OUT_SEED, ab.DATA_STREAM, 0), 2, 64, 8)
    calib = next(quant_ab.calibration_images(cfg, "cpu", 1))
    assert not torch.equal(held, train["image"])
    assert not torch.equal(held, calib)
    assert torch.equal(held, ab.held_out_batch(cfg, "cpu", 0)["image"])


# ---- held-out mAP against the JAX package -----------------------------------

@contextlib.contextmanager
def _jax_in_fp32():
    """JAX's harnesses as the tests run them: Pallas in interpret mode,
    the Light-Head pooling with its PSROIAlign kernel, the models the
    harnesses build in bf16 built in fp32."""
    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call",
               functools.partial(pl.pallas_call, interpret=True))
    mp.setattr(L, "batched_psroi_align", batched_psroi_align_pallas)
    mp.setattr(jax_ab, "LightHeadRCNN",
               lambda config, dtype: L.LightHeadRCNN(config=config,
                                                     dtype=jnp.float32))
    build = jax_quant.build_detector
    mp.setattr(jax_quant, "build_detector",
               lambda mcfg, dtype=None: build(mcfg, jnp.float32))
    try:
        yield
    finally:
        mp.undo()


def _with_gt(batches, outs):
    """``batches`` with each image's gt replaced by the first GT_PER_IMAGE
    valid detections of ``outs`` (boxes and classes)."""
    got = []
    for raw, (boxes, _, classes, valid) in zip(batches, outs):
        b = {k: np.array(v) for k, v in raw.items()}
        for key in ("gt_boxes", "gt_labels", "gt_mask"):
            b[key][:] = 0
        for i in range(len(boxes)):
            idx = np.nonzero(valid[i])[0][:GT_PER_IMAGE]
            b["gt_boxes"][i, :len(idx)] = boxes[i, idx]
            b["gt_labels"][i, :len(idx)] = classes[i, idx]
            b["gt_mask"][i, :len(idx)] = True
        got.append(b)
    return got


def _jax_eval_map(detect, variables, batches):
    """The JAX package's ``fast_nms_ab.eval_map`` over given batches (its
    loop; its own stream replaced by ``batches``). Returns the mAP and the
    detections."""
    ev = JaxVOCEvaluator(num_classes=20)
    outs = []
    for bi, raw in enumerate(batches):
        out = tuple(map(np.asarray, detect(variables,
                                           jnp.asarray(raw["image"]))))
        outs.append(out)
        boxes, scores, classes, valid = out
        for i in range(len(boxes)):
            m = raw["gt_mask"][i]
            ev.add_ground_truth(f"b{bi}i{i}", raw["gt_boxes"][i][m],
                                raw["gt_labels"][i][m])
            v = valid[i]
            ev.add_detections(f"b{bi}i{i}", boxes[i][v], scores[i][v],
                              classes[i][v])
    return ev.evaluate()["mAP"], outs


@pytest.fixture(scope="module", params=["lighthead", "ssd"])
def pair(request):
    """A smoke-size model of each family: JAX's weights (for SSD the class
    convs scaled up, and the weights before, ``plain``) and module, the
    port's model holding them, two numpy batches of raw synthetic images
    (gt from JAX's exact detections) and two calibration batches."""
    fam = request.param
    jcfg, pcfg = _configs(fam)
    it = synthetic_batches(5, 2, 64, 8)
    images = [next(it) for _ in range(2)]
    calib = [next(it)["image"] for _ in range(2)]
    x = jnp.asarray(images[0]["image"]
                    - np.asarray(jcfg.data.pixel_means, np.float32))
    module = (L.LightHeadRCNN(config=jcfg.model, dtype=jnp.float32)
              if fam == "lighthead"
              else JaxSSD(config=jcfg.model, dtype=jnp.float32))
    plain = perturb_bn(jax_init(module, x))
    variables = jax.tree_util.tree_map(np.copy, plain)
    if fam == "ssd":
        head = variables["params"]["head"]
        for name in [k for k in head if k.startswith("cls")]:
            head[name] = dict(head[name], kernel=head[name]["kernel"] * 20.0)
    with _jax_in_fp32():
        detect = jax_ab.make_detect_fn(jcfg, module, "exact")
        _, outs = _jax_eval_map(detect, variables, images)
    port = build_model(pcfg.model, "cpu", seed=None, dtype=torch.float32)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return dict(fam=fam, jcfg=jcfg, pcfg=pcfg, module=module,
                variables=variables, plain=plain, port=port, images=images,
                batches=_with_gt(images, outs), calib=calib)


def _port_outs(detect, batches):
    return [tuple(t.numpy() for t in detect(torch.from_numpy(b["image"])))
            for b in batches]


@pytest.mark.parametrize("mode", ["exact", "maxpool"])
def test_eval_map_matches_jax(pair, mode):
    """``make_detect_fn`` + ``eval_map`` against JAX's ``make_detect_fn`` +
    its ``eval_map`` loop on the same weights and injected batches: the
    detections within DET_ATOL (valid slots and classes equal), the mAP
    within MAP_TOL."""
    with _jax_in_fp32():
        detect = jax_ab.make_detect_fn(pair["jcfg"], pair["module"], mode)
        want_map, want = _jax_eval_map(detect, pair["variables"],
                                       pair["batches"])
    port = ab.make_detect_fn(pair["pcfg"], pair["port"], mode, torch.float32)
    got = _port_outs(port, pair["batches"])
    for g, w in zip(got, want):
        assert w[3].any()
        np.testing.assert_array_equal(g[3], w[3])
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_allclose(g[0], w[0], atol=DET_ATOL, rtol=0)
        np.testing.assert_allclose(g[1], w[1], atol=DET_ATOL, rtol=0)
    got_map = ab.eval_map(pair["pcfg"], port, 0, "cpu", pair["batches"])
    assert want_map > 0.0
    assert abs(got_map - want_map) <= MAP_TOL, (got_map, want_map)


def test_approx_is_exact_bitwise(pair):
    """The port's approx_prefilter is the exact top-k: the "approx" path's
    detections equal the "exact" path's bit for bit."""
    exact = ab.make_detect_fn(pair["pcfg"], pair["port"], "exact",
                              torch.float32)
    approx = ab.make_detect_fn(pair["pcfg"], pair["port"], "approx",
                               torch.float32)
    assert approx.model.config.nms.approx_prefilter
    assert not exact.model.config.nms.approx_prefilter
    for b in pair["batches"]:
        x = torch.from_numpy(b["image"])
        for g, w in zip(approx(x), exact(x)):
            assert torch.equal(g, w)


def test_int8_arm_matches_jax(pair):
    """``quant_ab``'s int8 arm (``calibrate`` on the trained weights over
    the calibration batches, ``make_int8_detect``) against JAX's
    (``quant.calibrate_backbone`` on the same eval-preprocessed batches,
    ``quant_ab.make_detect``): ranges within 1e-5, the int8 mAP within
    INT8_MAP_TOL on batches whose gt is JAX's int8 top detections. The SSD
    runs its weights before the class convs' scaling: scaled, its scores
    saturate at 1.0, and which of thousands of tied anchors fill the top
    200 is then decided by any int8 rounding step."""
    jcfg, pcfg = pair["jcfg"], pair["pcfg"]
    with _jax_in_fp32():
        pre = jax.jit(jax.vmap(lambda im: jax_preprocess(im, jcfg.data)))
        qv = jax_quant.calibrate_backbone(
            jcfg, pair["plain"], [pre(jnp.asarray(c))
                                      for c in pair["calib"]],
            dtype=jnp.float32)
        detect = jax_quant_ab.make_detect(jcfg, dataclasses.replace(
            jcfg.model, backbone_quant="int8"))
        v = dict(pair["plain"], quant=qv)
        _, outs = _jax_eval_map(detect, v, pair["images"])
        batches = _with_gt(pair["images"], outs)
        want_map, _ = _jax_eval_map(detect, v, batches)
    model = build_model(pcfg.model, "cpu", seed=None, dtype=torch.float32)
    model.load_state_dict(from_jax_variables(pair["plain"]), strict=True)
    ranges = quant_ab.calibrate(pcfg, model, [
        torch.from_numpy(c) for c in pair["calib"]], torch.float32)
    want = from_jax_variables({"quant": jax.tree_util.tree_map(np.asarray,
                                                               qv)})
    assert set(ranges) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(ranges[key].numpy(), value.numpy(),
                                   rtol=1e-5, err_msg=key)
    port = quant_ab.make_int8_detect(pcfg, model, ranges, torch.float32)
    got_map = ab.eval_map(pcfg, port, 0, "cpu", batches)
    assert want_map > 0.0
    assert abs(got_map - want_map) <= INT8_MAP_TOL, (got_map, want_map)


# ---- EMA and calibration ----------------------------------------------------

def test_ema_ab_decay_zero_scores_raw_and_shadow_the_same():
    """A state trained with decay 0 keeps no shadow, and a shadow of decay
    0 is the parameters: raw and shadow give the same detections and mAP
    on injected batches. With a decay, the shadow's model holds the shadow
    and the model's BatchNorm statistics."""
    cfg = ab.smoke_shrink(ema_ab.ema_config(3000, ema_decay=0.0), "ssd")
    state, _ = ab.train_synthetic(cfg, 2, "cpu", torch.float32,
                                  augment=False, log=lambda line: None)
    assert state.ema_params is None
    it = synthetic_batches(6, 2, 64, 8)
    batches = [next(it) for _ in range(2)]
    maps = ema_ab.score_weight_sets(cfg, state, 0, "cpu", torch.float32,
                                    batches=batches)
    assert maps["raw"] == maps["ema"]
    sets = ema_ab.weight_sets(state)
    raw, ema = (ab.make_detect_fn(cfg, state.model, "exact", torch.float32,
                                  state_dict=sets[k]) for k in ("raw", "ema"))
    x = torch.from_numpy(batches[0]["image"])
    assert all(torch.equal(a, b) for a, b in zip(raw(x), ema(x)))
    cfg = ab.smoke_shrink(ema_ab.ema_config(3000, ema_decay=0.5), "ssd")
    state, _ = ab.train_synthetic(cfg, 2, "cpu", torch.float32,
                                  augment=False, log=lambda line: None)
    sets = ema_ab.weight_sets(state)
    raw = state.model.state_dict()
    for key, value in sets["ema"].items():
        want = state.ema_params.get(key, raw[key])
        assert torch.equal(value, want), key
    moved = [k for k in state.ema_params
             if not torch.equal(state.ema_params[k], raw[k])]
    assert moved
    detect = ab.make_detect_fn(cfg, state.model, "exact", torch.float32,
                               state_dict=sets["ema"])
    held = detect.model.state_dict()
    assert all(torch.equal(held[k], state.ema_params[k]) for k in moved)


def test_hot_pixel_injection_matches_jax():
    """``corrupt`` fed the draws JAX's ``corrupt`` makes from its key
    (split in two: hot = uniform < frac, sign = -1 where uniform < 0.5)
    gives JAX's images exactly; ``draw_hot_pixels`` draws about ``frac``
    hot pixels, each signed +-1."""
    images = np.random.default_rng(0).uniform(
        0, 255, (2, 48, 40, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    frac, magnitude = 0.05, 8.0
    want = np.asarray(jax_calib.corrupt(jnp.asarray(images), key, frac,
                                        magnitude))
    k1, k2 = jax.random.split(key)
    hot = np.asarray(jax.random.uniform(k1, images.shape[:-1]) < frac)
    sign = np.asarray(jnp.where(jax.random.uniform(
        k2, images.shape[:-1]) < 0.5, -1.0, 1.0))
    got = calib_sensitivity.corrupt(torch.from_numpy(images),
                                    calib_sensitivity.HotPixels(
                                        torch.from_numpy(np.array(hot)),
                                        torch.from_numpy(np.array(sign))),
                                    magnitude)
    assert hot.any()
    np.testing.assert_array_equal(got.numpy(), want)
    draws = calib_sensitivity.draw_hot_pixels(
        torch.Generator().manual_seed(0), (4, 200, 200, 3), frac)
    assert abs(float(draws.hot.float().mean()) - frac) < 0.005
    assert set(draws.sign.unique().tolist()) == {-1.0, 1.0}
    ratios = calib_sensitivity.inflation(
        {"a": torch.tensor(4.0), "b": torch.tensor(1.0),
         "c": torch.tensor(3.0)},
        {"a": torch.tensor(2.0), "b": torch.tensor(1.0),
         "c": torch.tensor(1.0)})
    assert ratios == {"max": 3.0, "median": 2.0, "convs": 3,
                      "per_conv": {"a": 2.0, "b": 1.0, "c": 3.0}}


# ---- the entry points -------------------------------------------------------

# each harness's JSON lines: the JAX package's keys (images_per_sec_per_chip
# renamed images_per_sec) and device, steps, train_images_per_sec
HARNESS_KEYS = {
    "fast_nms_ab": ({"family", "preset", "nms", "held_out_mAP",
                     "images_per_sec"}, 6, ["--rounds", "1"]),
    "quant_ab": ({"family", "preset", "seed", "precision", "held_out_mAP",
                  "ms_per_batch", "images_per_sec"}, 8, ["--rounds", "1"]),
    "ema_ab": ({"family", "preset", "weights", "held_out_mAP"}, 2, []),
    "calib_sensitivity": ({"family", "steps", "seed", "hot_frac",
                           "hot_magnitude", "precision", "calibration",
                           "held_out_mAP"}, 3, []),
    "train_synthetic_capstone": ({"family", "preset", "seed",
                                  "held_out_mAP", "per_class_ap"}, 1, []),
}


@pytest.mark.parametrize("name", sorted(HARNESS_KEYS))
def test_main_prints_json_lines(name, capsys):
    """``--smoke --steps 2 --eval-batches 1 --device cpu``: one JSON line a
    family, mode or precision, and seed, with the keys above."""
    keys, lines, extra = HARNESS_KEYS[name]
    module = sys.modules[f"x_detector_tpu_torch.tools.{name}"]
    rows = module.main(["--smoke", "--steps", "2", "--eval-batches", "1",
                        "--device", "cpu", *extra])
    printed = [json.loads(line) for line in capsys.readouterr().out.split(
        "\n") if line.startswith("{")]
    if name == "calib_sensitivity":
        infl = printed.pop(0)["scale_inflation_amax_over_pct"]
        assert infl["convs"] > 0 and infl["max"] >= infl["median"] > 0
        rows = rows[1:]
    assert printed == rows and len(rows) == lines
    for row in rows:
        assert keys | {"device", "steps", "train_images_per_sec"} <= set(row)
        assert row["device"] == "cpu" and row["steps"] == 2
        assert row["train_images_per_sec"] > 0
        assert 0.0 <= row["held_out_mAP"] <= 1.0


@pytest.mark.parametrize("name", sorted(HARNESS_KEYS) + ["overfit"])
def test_main_raises_without_a_card(name):
    """The default device is the card, and with none the harness raises
    before any work (no quiet fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    module = sys.modules[f"x_detector_tpu_torch.tools.{name}"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--smoke"] if name != "overfit" else [])


# ---- chip_smoke.py's learn phase --------------------------------------------

def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_cpu_rehearsal_of_chip_smoke_learn(monkeypatch):
    """chip_smoke's learn phase on thin models on the CPU: the overfit runs
    of both families count what the card must show (B1 once a Light-Head
    step each way, once more for the scoring forward) while the counters
    stay 0; the short capstone on the smoke Light-Head trains, scores four
    sides on the same held-out batch (B2 a fused block and B1 once a
    batch; int8: K1 a dense conv, K2 a depthwise one, K3 each but the
    pointwise convs K2 fed), and its checks pass on the counts the card
    would give and catch a loss that rises and an approx path that moved."""
    chip_smoke = _chip_smoke()
    monkeypatch.setattr(chip_smoke, "LEARN_LOSS_WINDOW", 2)
    for cfg, b1 in ((overfit.small_config(), 0),
                    (overfit._recipe(_configs("lighthead")[1]), 1)):
        res = chip_smoke.run_overfit(cfg, "cpu", 2, torch.float32)
        assert res["launches"] == dict.fromkeys(res["launches"], 0)
        # exact NMS's two kernels: each Light-Head step's proposals, and
        # the scoring forward's proposals (Light-Head) and tail
        assert res["expected"] == {**res["launches"], "psroi_align": 3 * b1,
                                   "psroi_align_backward": 2 * b1,
                                   "nms_suppress": 2 * (1 + 3 * b1)}
        assert len(res["losses"]) == 2 and 0.0 <= res["mAP"] <= 1.0
        with pytest.raises(AssertionError, match="did not overfit"):
            chip_smoke.check_overfit("rehearsal", dict(
                res, launches=res["expected"], passed=False))
    _, cfg = _configs("lighthead")
    res = chip_smoke.run_capstone(cfg, "cpu", steps=6, eval_batches=1,
                                  calib_batches=1, dtype=torch.float32)
    assert set(res["eval"]) == {"exact", "approx", "maxpool", "int8"}
    # exact NMS's two kernels for the proposals and the tail; MaxpoolNMS
    # takes the proposals'
    float_side = {"fused_sepconv": 6, "psroi_align": 1, "nms_suppress": 4}
    per_batch = {"exact": float_side, "approx": float_side,
                 "maxpool": {**float_side, "nms_suppress": 2},
                 "int8": {"int8_conv": 12, "int8_dwconv": 8,
                          "quantize_s8": 12, "psroi_align": 1,
                          "nms_suppress": 4}}
    assert res["train_expected"]["psroi_align"] == 6
    assert res["train_expected"]["nms_suppress"] == 6 * 2
    as_on_card = dict(res, train_launches=res["train_expected"], eval={
        name: dict(side, launches=side["expected"])
        for name, side in res["eval"].items()})
    for side in res["eval"].values():
        assert side["launches"] == dict.fromkeys(side["launches"], 0)
    falling = dict(as_on_card, train=dict(res["train"], losses=[
        4.0, 3.0, 2.0, 1.0]))
    chip_smoke.check_capstone(falling, per_batch)
    with pytest.raises(AssertionError, match="did not fall"):
        chip_smoke.check_capstone(dict(falling, train=dict(
            res["train"], losses=[1.0, 2.0, 3.0, 4.0])), per_batch)
    moved = [tuple(t + 1 if i == 1 else t for i, t in enumerate(d))
             for d in res["eval"]["approx"]["detections"]]
    with pytest.raises(AssertionError, match="approx"):
        chip_smoke.check_capstone(dict(falling, eval=dict(
            falling["eval"], approx=dict(falling["eval"]["approx"],
                                         detections=moved))), per_batch)
    with pytest.raises(AssertionError, match="should launch"):
        chip_smoke.check_capstone(falling, {**per_batch, "int8": float_side})
