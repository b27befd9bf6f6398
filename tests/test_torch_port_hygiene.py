"""What the PyTorch port may import, its preset tree, its build errors, its
kernels' sources, and tiny CPU rehearsals of chip_smoke.py's slice and train
phases."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from x_detector_tpu import config as jax_config  # noqa: E402
from x_detector_tpu_torch import _build  # noqa: E402
from x_detector_tpu_torch import config as port_config  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "x_detector_tpu")


def _port_files():
    return sorted((ROOT / "x_detector_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_no_jax(path):
    """No JAX, no flax and nothing of the JAX package (not even its config:
    the card's machine has no JAX, and the port restates the presets)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path.name} imports {name}"


@pytest.mark.parametrize("preset", sorted(jax_config.PRESETS))
def test_presets_equal_the_jax_packages(preset):
    assert (dataclasses.asdict(port_config.PRESETS[preset]())
            == dataclasses.asdict(jax_config.PRESETS[preset]()))


@pytest.mark.parametrize("cls", ["AnchorConfig", "SSDAnchorConfig",
                                 "NMSConfig", "ProposalConfig", "ModelConfig",
                                 "DataConfig", "TrainConfig",
                                 "ExperimentConfig"])
def test_config_classes_have_the_jax_fields_and_defaults(cls):
    assert (dataclasses.asdict(getattr(port_config, cls)())
            == dataclasses.asdict(getattr(jax_config, cls)()))


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_cpu_rehearsal_of_chip_smoke_slice():
    """chip_smoke.run_slice at a tiny size on the CPU: the plain versions
    serve every call, so the kernels' counters stay 0 while the expected
    counts (what the card must show) follow from the model."""
    chip_smoke = _chip_smoke()
    cfg = port_config.lighthead_xception(64)
    model = dataclasses.replace(
        cfg.model, backbone_fused_sepconv=True, large_sep_mid=16,
        head_dim=32, backbone_widths=(16, 32, 48, 64),
        proposals=port_config.ProposalConfig(pre_nms_topk_eval=128,
                                             post_nms_topk_eval=32,
                                             min_size=2.0),
        nms=port_config.NMSConfig(max_output=20))
    cfg = dataclasses.replace(cfg, model=model, data=dataclasses.replace(
        cfg.data, image_size=64))
    res = chip_smoke.run_slice(cfg, "cpu", batches=1, batch_size=2)
    assert res["launches"] == {"fused_sepconv": 0, "psroi_align": 0,
                               "psroi_align_backward": 0}
    assert res["expected"] == {"fused_sepconv": 2 * 14, "psroi_align": 2,
                               "psroi_align_backward": 0}
    assert len(res["seconds"]) == 1
    assert res["detections"][3].any()
    assert _build.library.cache_info().currsize == 0   # nothing was built


def _thin(cfg, **kw):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_stages=(1, 1, 1, 1), **kw))


@pytest.mark.parametrize("path", ["config1", "ssd", "xdet"])
def test_cpu_rehearsal_of_chip_smoke_new_paths(path):
    """chip_smoke's phases for config 1 (one 75 x 100 image resized to the
    canvas), config 2 and xdet_xception (fused) at 128 px on thin
    backbones, on the CPU: the counters stay 0, the expected counts follow
    from each model (B1's forward once a batch for Light-Head only; B2 once
    a fused block: 5 a batch on the thin Xception), and the 128 px check
    runs its comparison (the CPU in bf16 against the CPU in fp32)."""
    chip_smoke = _chip_smoke()
    cfg, kw, keys, per_batch = {
        "config1": (_thin(port_config.lighthead_resnet50(128)),
                    dict(batch_size=1, raw_hw=(75, 100)),
                    ("rpn_cls", "rpn_loc"), (0, 1)),
        "ssd": (_thin(port_config.ssd_resnet50(128)), dict(batch_size=2),
                ("cls_logits", "box_codes"), (0, 0)),
        "xdet": (chip_smoke.fused(_thin(
            port_config.xdet_xception(128),
            backbone_widths=(32, 64, 96, 128))), dict(batch_size=2),
                 ("cls_logits", "box_codes"), (5, 0)),
    }[path]
    res = chip_smoke.run_slice(cfg, "cpu", batches=1, **kw)
    assert res["launches"] == dict.fromkeys(res["launches"], 0)
    assert res["expected"] == {"fused_sepconv": 2 * per_batch[0],
                               "psroi_align": 2 * per_batch[1],
                               "psroi_align_backward": 0}
    assert res["detections"][0].shape[0] == kw["batch_size"]
    assert res["anchors"] == (960 if path == "config1" else 2046)
    assert chip_smoke.slice_reference_check(cfg.model, "cpu", keys) <= (
        chip_smoke.SLICE_REL_TOL)


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    """Alone in a directory, on a machine without CUDA: a non-zero exit and
    no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_cpu_rehearsal_of_chip_smoke_train():
    """chip_smoke.run_train at 64 px, batch 2, on the CPU: every call takes
    a plain version, so the counters stay 0, while the expected counts (one
    PSROIAlign forward and backward per step; no fused conv, though the
    model has fused blocks, since training takes the unfused route) follow
    from the model and the microbatch count; the losses are finite and
    every parameter moves."""
    chip_smoke = _chip_smoke()
    cfg = chip_smoke.train_config(64, batch_size=2)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_fused_sepconv=True, large_sep_mid=16,
        head_dim=32, backbone_widths=(16, 32, 48, 64),
        proposals=port_config.ProposalConfig(pre_nms_topk=300,
                                             post_nms_topk=64, min_size=2.0)))
    res = chip_smoke.run_train(cfg, "cpu", steps=1)
    assert res["launches"] == {"fused_sepconv": 0, "psroi_align": 0,
                               "psroi_align_backward": 0}
    assert res["expected"] == {"fused_sepconv": 0, "psroi_align": 2,
                               "psroi_align_backward": 2}
    assert len(res["seconds"]) == 1 and len(res["losses"]) == 2
    for metrics in res["losses"]:
        assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert res["moved"] == res["params"] > 0
    accum = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, grad_accum_steps=2))
    assert chip_smoke.run_train(accum, "cpu", steps=0)["expected"] == {
        "fused_sepconv": 0, "psroi_align": 2, "psroi_align_backward": 2}
    assert _build.library.cache_info().currsize == 0   # nothing was built


def test_cpu_rehearsal_of_chip_smoke_train_check():
    """chip_smoke.train_reference_check with the CPU in the card's place
    (bf16, plain versions): the backward taken in the step matches the
    plain backward of its captured inputs to one bf16 step, and the gaps to
    fp32 are those of the bf16 control, within the script's limits."""
    chip_smoke = _chip_smoke()
    res = chip_smoke.train_reference_check("cpu")
    assert res["bwd_err"] <= chip_smoke.BF16_STEP
    for key in ("loss", "leaf_grad", "leaf_update"):
        assert res[key] == res["control_" + key]
    assert res["loss"] <= chip_smoke.TRAIN_LOSS_REL_TOL
    assert max(res["leaf_grad"], res["leaf_update"]) <= (
        chip_smoke.TRAIN_LEAF_REL_TOL)


def test_chip_smoke_train_check_catches_a_wrong_backward(monkeypatch):
    """A PSROIAlign backward 2% off in the train step fails the check."""
    from x_detector_tpu_torch.ops import psroi_align as pa
    chip_smoke = _chip_smoke()
    right = pa.psroi_align_backward
    monkeypatch.setattr(pa, "psroi_align_backward",
                        lambda *a, **k: right(*a, **k) * 0.98)
    with pytest.raises(AssertionError, match="PSROIAlign's backward"):
        chip_smoke.train_reference_check("cpu")


def test_kernel_sources_use_no_atomic_add():
    """The backward gathers by destination: no source may scatter with
    atomics (the same inputs must give the same bits)."""
    sources = sorted((ROOT / "x_detector_tpu_torch" / "csrc").glob("*"))
    assert sources
    for path in sources:
        assert "atomicAdd" not in path.read_text(), path.name
