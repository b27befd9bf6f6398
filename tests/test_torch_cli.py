"""The port's train, evaluate and convert_voc CLIs on the CPU (``--device
cpu``, thin backbones at 64 px): synthetic data and TFRecord shards
(``--data-dir``), one process and two gloo ranks (``--num-devices 2``); its
metrics logger, ``eval_variables`` and its VOC evaluator against the JAX
package's."""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_checkpoint import assert_bitwise, snapshot  # noqa: E402
from test_voc_io import make_fake_voc  # noqa: E402
from x_detector_tpu.utils import metrics_voc as jax_voc  # noqa: E402
from x_detector_tpu.cli import inspect_data as jax_inspect  # noqa: E402
from x_detector_tpu_torch.cli import (common, convert_voc,  # noqa: E402
                                      evaluate, inspect_data, train)
from x_detector_tpu_torch.train.trainer import (  # noqa: E402
    create_model_and_state)
from x_detector_tpu_torch.utils import metrics_voc as voc  # noqa: E402
from x_detector_tpu_torch.utils.logging import (  # noqa: E402
    MetricsLogger, read_events)

THIN = ["--image-size", "64", "--batch-size", "2", "--backbone-stages",
        "1,1,1,1", "--device", "cpu", "--dtype", "float32"]
PRESETS = {"ssd_resnet50": ["--backbone-widths", "8,16,24,32"],
           "lighthead_xception": ["--backbone-widths", "16,32,48,64"]}


def cli_args(preset, model_dir, *extra):
    return ["--preset", preset, *THIN, *PRESETS[preset], "--model-dir",
            str(model_dir), *extra]


def train_args(preset, model_dir, *extra):
    return cli_args(preset, model_dir, "--log-every", "1", *extra)


def records(model_dir):
    with open(model_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module", params=sorted(PRESETS))
def runs(request, tmp_path_factory):
    """(preset, an uninterrupted 4-step run's dir and final state, and a
    2-step run resumed for 2 more: its dir and final state)."""
    preset = request.param
    whole = tmp_path_factory.mktemp(preset + "_whole")
    split = tmp_path_factory.mktemp(preset + "_split")
    state_whole = train.main(train_args(preset, whole, "--steps", "4",
                                        "--checkpoint-every", "2"))
    train.main(train_args(preset, split, "--steps", "2"))
    state_split = train.main(train_args(preset, split, "--steps", "4",
                                        "--resume"))
    return preset, whole, state_whole, split, state_split


def test_resumed_run_ends_bitwise_like_an_uninterrupted_one(runs):
    """2 steps + ``--resume`` + 2 steps: every parameter, BatchNorm
    statistic, momentum buffer, the shadow (config 2) and the step equal
    the 4-step run's, bit for bit; so do the logged metrics, step by step
    (the data position and the per-position draws resume too)."""
    preset, whole, state_whole, split, state_split = runs
    assert state_whole.step == state_split.step == 4
    assert (state_whole.ema_params is not None) == (preset == "ssd_resnet50")
    assert_bitwise(snapshot(state_split), snapshot(state_whole))
    drop = lambda rec: {k: v for k, v in rec.items() if k != "wall_time_s"}
    assert [drop(r) for r in records(split)] == [
        drop(r) for r in records(whole)]


def test_metrics_and_checkpoints_hold_the_expected_steps(runs):
    _, whole, _, split, _ = runs
    for d in (whole, split):
        recs = records(d)
        assert [r["step"] for r in recs] == [1, 2, 3, 4]
        assert all(math.isfinite(r["total_loss"]) for r in recs)
    assert sorted(p.name for p in (whole / "ckpt").iterdir()) == [
        "ckpt-2.pt", "ckpt-4.pt", "meta-2.json", "meta-4.json"]
    assert sorted(p.name for p in (split / "ckpt").iterdir()) == [
        "ckpt-2.pt", "ckpt-4.pt", "meta-2.json", "meta-4.json"]


def test_evaluate_runs_on_the_checkpoint(runs, capsys):
    """``cli.evaluate`` restores step 4 and evaluates the EMA shadow where
    the checkpoint has one (config 2), the raw parameters otherwise; mAP in
    [0, 1]."""
    preset, whole, *_ = runs
    res = evaluate.main(cli_args(preset, whole, "--num-batches", "2"))
    assert res["step"] == 4
    assert res["ema"] == (preset == "ssd_resnet50")
    assert 0.0 <= res["mAP"] <= 1.0
    out = capsys.readouterr().out
    assert "restored checkpoint at step 4" in out
    assert ("evaluating EMA shadow weights" in out) == res["ema"]


def test_periodic_eval_logs_the_map(tmp_path):
    train.main(train_args("ssd_resnet50", tmp_path, "--steps", "2",
                          "--eval-every", "2", "--eval-batches", "1"))
    recs = records(tmp_path)
    assert [r["step"] for r in recs] == [1, 2, 2]
    assert 0.0 <= recs[-1]["eval_mAP"] <= 1.0


@pytest.mark.parametrize("cli,extra,error,match", [
    (train, ["--preset", "lighthead_xception", "--pretrained", "r50.pth"],
     SystemExit, "ResNet-50"),
    (train, ["--pretrained", "missing.pth"], FileNotFoundError,
     "missing.pth"),
    (train, ["--device", "cuda"], RuntimeError, "no CUDA device"),
    (train, ["--device", "cuda", "--num-devices", "2"], RuntimeError,
     "needs 2 CUDA devices, one a rank; 0 visible"),
    (evaluate, ["--device", "cuda"], RuntimeError, "no CUDA device"),
    (evaluate, ["--device", "cuda", "--num-devices", "2"], RuntimeError,
     "needs 2 CUDA devices, one a rank; 0 visible"),
], ids=["train-pretrained", "train-pretrained-missing", "train-cuda",
        "train-num-devices-cuda", "eval-cuda", "eval-num-devices-cuda"])
def test_refusals_name_what_is_missing(tmp_path, monkeypatch, cli, extra,
                                       error, match):
    """Each refusal raises with its message (``--pretrained`` on a preset
    that is not ResNet-50, or a file that is not there), and ``--device
    cuda`` with no card present (one rank or two) never falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (train_args("ssd_resnet50", tmp_path, "--steps", "1", *extra)
            if cli is train else cli_args("ssd_resnet50", tmp_path, *extra))
    with pytest.raises(error, match=match):
        cli.main(args)
    assert not (tmp_path / "metrics.jsonl").exists()


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """``cli.convert_voc`` of a fake VOCdevkit of 5 images: 2 shards."""
    root = tmp_path_factory.mktemp("voc")
    make_fake_voc(str(root), n_images=5)
    paths = convert_voc.main(["--voc-root", str(root), "--output-dir",
                              str(root / "shards"), "--shard-size", "3"])
    assert len(paths) == 2
    return root / "shards"


def test_train_and_evaluate_read_the_shards(shards, tmp_path, capsys):
    """``--data-dir``: Light-Head (letterboxed) trains 2 steps from the
    shards through the native loader, checkpoints its data position and
    resumes to 3; evaluate reads the 5 images once, in order (a partial
    last batch)."""
    args = ("lighthead_xception", tmp_path, "--data-dir", str(shards))
    train.main(train_args(*args, "--steps", "2"))
    state = train.main(train_args(*args, "--steps", "3", "--resume"))
    assert state.step == 3
    assert "resumed from step 2 (data position 2)" in capsys.readouterr().out
    assert [r["step"] for r in records(tmp_path)] == [1, 2, 3]
    assert all(math.isfinite(r["total_loss"]) for r in records(tmp_path))
    res = evaluate.main(cli_args(*args, "--num-batches", "50"))
    assert res["step"] == 3 and 0.0 <= res["mAP"] <= 1.0


@pytest.fixture
def short_spawn_timeout(monkeypatch):
    """Ranks that hang fail the test within 120 s."""
    monkeypatch.setattr(train, "SPAWN_TIMEOUT_S", 120)
    monkeypatch.setattr(evaluate, "SPAWN_TIMEOUT_S", 120)


def _checkpoint(model_dir, step):
    return torch.load(model_dir / "ckpt" / f"ckpt-{step}.pt",
                      weights_only=True)


def _assert_checkpoints_equal(a, b):
    assert a["step"] == b["step"] and a["data_state"] == b["data_state"]
    flat = lambda p: {**{"model." + k: v for k, v in p["model"].items()},
                      **{f"opt.{i}": s["momentum_buffer"] for i, s in
                         p["optimizer"]["state"].items()},
                      **{"ema." + k: v for k, v in (p["ema"] or {}).items()}}
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


def test_train_tensorboard_writes_every_logged_scalar(tmp_path):
    """``--tensorboard`` writes ``<model-dir>/tb``: one event file, read
    back with CRCs checked, holding every float of ``metrics.jsonl`` at
    its step (as float32)."""
    train.main(train_args("ssd_resnet50", tmp_path, "--steps", "2",
                          "--tensorboard"))
    (event_file,) = (tmp_path / "tb").glob("events.out.tfevents.*")
    got = {(e["step"], tag, value)
           for e in read_events(str(event_file))
           for tag, _, value in e.get("values", ())}
    want = {(r["step"], k, float(np.float32(v))) for r in records(tmp_path)
            for k, v in r.items() if k != "step" and isinstance(v, float)}
    assert len(want) > 2 * 4 and want <= got


def _inspect(module, argv, capsys):
    module.main(argv)
    return capsys.readouterr().out.splitlines()


def test_inspect_data_matches_jax_on_the_synthetic_stream(tmp_path, capsys):
    """``cli.inspect_data`` on the synthetic stream against the JAX
    package's: the same file names, the same printed gt counts and classes,
    and the same pixels (the same drawing of the same batches)."""
    from PIL import Image
    argv = ["--num-images", "3", "--canvas", "64", "--batch-size", "2"]
    want = _inspect(jax_inspect, argv + ["--output-dir", str(tmp_path / "j")],
                    capsys)
    got = _inspect(inspect_data, argv + ["--device", "cpu", "--output-dir",
                                         str(tmp_path / "p")], capsys)
    strip = lambda lines, d: [line.replace(str(tmp_path / d), "DIR")
                              for line in lines]
    assert strip(got, "p") == strip(want, "j")
    assert got[-1].startswith("wrote 3 annotated images")
    names = sorted(p.name for p in (tmp_path / "p").iterdir())
    assert names == [f"synthetic_{i}.png" for i in range(3)]
    for name in names:
        assert np.array_equal(np.asarray(Image.open(tmp_path / "p" / name)),
                              np.asarray(Image.open(tmp_path / "j" / name)))


def test_inspect_data_reads_the_shards(shards, tmp_path, capsys):
    """Through the native loader: a PNG named by each image id."""
    lines = _inspect(inspect_data, [
        "--data-dir", str(shards), "--num-images", "5", "--output-dir",
        str(tmp_path), "--device", "cpu", "--batch-size", "2"], capsys)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"{i:06d}.png" for i in range(5)]
    assert len(lines) == 6 and "gt boxes" in lines[0]


def test_two_ranks_resume_bitwise(tmp_path, short_spawn_timeout, capfd):
    """``--num-devices 2 --device cpu`` (gloo): config 2's model (with its
    EMA shadow) for 4 steps equals 2 + ``--resume`` + 2, bit for bit, in
    every checkpointed tensor and in the metrics rank 0 logs; rank 0 alone
    writes."""
    whole, split = tmp_path / "whole", tmp_path / "split"
    dp = ("--num-devices", "2", "--batch-size", "4")
    assert train.main(train_args("ssd_resnet50", whole, "--steps", "4",
                                 *dp)) is None
    train.main(train_args("ssd_resnet50", split, "--steps", "2", *dp))
    train.main(train_args("ssd_resnet50", split, "--steps", "4", "--resume",
                          *dp))
    out = capfd.readouterr().out      # the ranks' own processes print
    assert out.count("resumed from step 2 (data position 2)") == 1
    _assert_checkpoints_equal(_checkpoint(split, 4), _checkpoint(whole, 4))
    assert _checkpoint(whole, 4)["ema"] is not None
    drop = lambda rec: {k: v for k, v in rec.items() if k != "wall_time_s"}
    assert [drop(r) for r in records(split)] == [
        drop(r) for r in records(whole)]
    assert [r["step"] for r in records(whole)] == [1, 2, 3, 4]


def test_two_rank_eval_equals_one_process(shards, tmp_path,
                                          short_spawn_timeout):
    """``cli.evaluate --num-devices 2`` over the shards (5 images in
    batches of 2: the last one padded) gives one process's result."""
    args = ("lighthead_xception", tmp_path, "--data-dir", str(shards))
    train.main(train_args(*args, "--steps", "1"))
    one = evaluate.main(cli_args(*args))
    two = evaluate.main(cli_args(*args, "--num-devices", "2"))
    assert two == one and one["step"] == 1


def test_eval_variables_prefers_the_shadow_and_keeps_the_stats():
    """Auto takes the shadow where there is one, False the raw parameters,
    True demands a shadow; BatchNorm's running stats are the model's."""
    from test_torch_checkpoint import tiny_ssd
    state = create_model_and_state(tiny_ssd(), "cpu", seed=0,
                                   dtype=torch.float32)
    for v in state.ema_params.values():
        v.add_(1.0)
    name = next(iter(state.ema_params))
    stats = {k: v for k, v in state.model.state_dict().items()
             if "running" in k}
    for use_ema, want in ((None, state.ema_params[name]), (True,
                          state.ema_params[name]),
                          (False, state.model.get_parameter(name))):
        got = common.eval_variables(state, use_ema)
        assert torch.equal(got[name], want)
        assert all(torch.equal(got[k], v) for k, v in stats.items())
    plain = create_model_and_state(tiny_ssd(ema_decay=0.0), "cpu", seed=0,
                                   dtype=torch.float32)
    assert torch.equal(common.eval_variables(plain)[name],
                       plain.model.get_parameter(name))
    with pytest.raises(ValueError, match="no EMA shadow"):
        common.eval_variables(plain, True)


def test_metrics_logger_writes_floats_at_log_time(tmp_path, capsys):
    """Tensors become floats in the record; the file is appended to (a
    resumed run); stderr echoes every ``echo_every`` steps; with
    ``tensorboard_dir`` every float of a record is also a scalar event."""
    path = tmp_path / "m.jsonl"
    lg = MetricsLogger(str(path), echo_every=2)
    lg.log(1, {"loss": torch.tensor(2.5), "lr": 1e-3})
    lg.log(2, {"loss": torch.tensor(2.0), "n": 3})
    lg.close()
    lg = MetricsLogger(str(path), echo=False)
    lg.log(3, {"loss": torch.tensor(1.5)})
    lg.close()
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert [r["loss"] for r in recs] == [2.5, 2.0, 1.5]
    assert recs[1]["n"] == 3.0 and "wall_time_s" in recs[0]
    err = capsys.readouterr().err
    assert "[step 2]" in err and "[step 1]" not in err
    lg = MetricsLogger(None, echo=False, tensorboard_dir=str(tmp_path / "tb"))
    lg.log(4, {"loss": torch.tensor(1.25), "n": 2})
    lg.close()
    (event_file,) = (tmp_path / "tb").glob("events.out.tfevents.*")
    triples = {(e["step"], tag) + ((value,) if tag != "wall_time_s" else ())
               for e in read_events(str(event_file))
               for tag, _, value in e.get("values", ())}
    assert triples == {(4, "loss", 1.25), (4, "n", 2.0), (4, "wall_time_s")}


def _seeded_eval(rng, module, use_07):
    """Ground truth and detections for 12 images and 6 classes, fed to the
    module's evaluator: difficult boxes, an image with no gt, class 5 with
    detections but no gt, class 6 with neither, duplicates of true boxes."""
    ev = module.VOCEvaluator(num_classes=6, use_07_metric=use_07)
    for i in range(12):
        n = int(rng.integers(0, 5)) if i else 0
        lo = rng.uniform(0, 0.6, (n, 2))
        boxes = np.concatenate([lo, lo + rng.uniform(0.1, 0.4, (n, 2))], 1)
        labels = rng.integers(1, 5, n)
        difficult = rng.random(n) < 0.25
        ev.add_ground_truth(f"im{i}", boxes, labels, difficult)
        jitter = boxes + rng.normal(0, 0.03, boxes.shape)
        extra = rng.uniform(0, 1, (3, 4))
        extra[:, 2:] = extra[:, :2] + 0.2
        det_boxes = np.concatenate([jitter, jitter[:1], extra])
        det_labels = np.concatenate([labels, labels[:1],
                                     rng.integers(1, 6, 3)])
        scores = rng.uniform(0, 1, len(det_boxes))
        ev.add_detections(f"im{i}", det_boxes, scores, det_labels)
    return ev.evaluate()


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_evaluator_equals_the_jax_packages(use_07):
    """Per-class AP and mAP exactly JAX's, 11-point and area forms."""
    got = _seeded_eval(np.random.default_rng(8), voc, use_07)
    want = _seeded_eval(np.random.default_rng(8), jax_voc, use_07)
    assert got == want
    assert 5 in got["per_class_ap"] and 6 not in got["per_class_ap"]
    assert got["per_class_ap"][5] == 0.0 and 0.0 < got["mAP"] < 1.0


def test_voc_ap_equals_the_jax_packages():
    rng = np.random.default_rng(2)
    for _ in range(5):
        recall = np.sort(rng.uniform(0, 1, 20))
        precision = rng.uniform(0, 1, 20)
        for use_07 in (True, False):
            assert voc.voc_ap(recall, precision, use_07) == jax_voc.voc_ap(
                recall, precision, use_07)
