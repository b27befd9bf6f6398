"""What the PyTorch port may import, its preset tree, its build errors, and a
tiny CPU rehearsal of chip_smoke.py's slice."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

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


def test_cpu_rehearsal_of_chip_smoke_slice():
    """chip_smoke.run_slice at a tiny size on the CPU: the plain versions
    serve every call, so the kernels' counters stay 0 while the expected
    counts (what the card must show) follow from the model."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
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
    assert res["launches"] == {"fused_sepconv": 0, "psroi_align": 0}
    assert res["expected"] == {"fused_sepconv": 2 * 14, "psroi_align": 2}
    assert len(res["seconds"]) == 1
    assert res["detections"][3].any()
    assert _build.library.cache_info().currsize == 0   # nothing was built


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
