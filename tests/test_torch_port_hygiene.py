"""What the PyTorch port may import and build, its preset tree, its build
errors, its kernels' sources, and tiny CPU rehearsals of chip_smoke.py's
slice and train phases."""

import ast
import dataclasses
import os
import pathlib
import re
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


def _non_doc_strings(tree):
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_builds_and_loads_nothing_of_the_jax_package(path):
    """No string of the port's code names a path in the JAX package (its
    ``native/`` sources, Makefile or ``libxdet_loader.so``) but as a
    ``file:line`` reference to a kernel it replaces, and none runs
    ``make``: the port builds its own copies into ``build/``."""
    for text in _non_doc_strings(ast.parse(path.read_text(), str(path))):
        for m in re.finditer(r"x_detector_tpu(?!_torch)\S*", text):
            assert re.fullmatch(r"x_detector_tpu/[\w/]+\.py:\d+",
                                m.group(0)), f"{path.name}: {text!r}"
        assert text != "make", f"{path.name} runs make"


def test_port_builds_into_build_and_loads_its_own_loader():
    """The kernels' and the loader's sources are the port's, their builds
    go to ``build/`` at the root of the checkout, and a fresh process that
    loads the port's loader (and reads a batch) has no file of the JAX
    package mapped."""
    from x_detector_tpu_torch.data import native_loader
    for path in (_build.CSRC, native_loader.SOURCE):
        assert path.is_relative_to(ROOT / "x_detector_tpu_torch"), path
    for path in (_build.BUILD_ROOT, native_loader.BUILD_ROOT):
        assert path.is_relative_to(ROOT / "build"), path
    lib, _ = native_loader.build()
    code = ("import pathlib\n"
            "from x_detector_tpu_torch.data import native_loader\n"
            "native_loader._load_library()\n"
            "print(pathlib.Path('/proc/self/maps').read_text())\n")
    maps = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    assert str(lib) in maps
    assert str(ROOT / "x_detector_tpu") + "/" not in maps


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


# the Pallas kernels' modules, ported into the modules that launch them
KERNEL_MODULES = {"ops/pallas/__init__.py": None,
                  "ops/pallas/fused_sepconv.py": "ops/fused_sepconv.py",
                  "ops/pallas/psroi_align_kernel.py": "ops/psroi_align.py"}


def test_every_jax_module_has_a_counterpart_and_nothing_is_refused():
    """Each module of the JAX package has one of the same path in the port
    (the Pallas kernels' in the ops that launch them), and no module of
    the port raises NotImplementedError: it does all the JAX package
    does."""
    jax_root, port_root = ROOT / "x_detector_tpu", ROOT / "x_detector_tpu_torch"
    for path in sorted(jax_root.rglob("*.py")):
        rel = str(path.relative_to(jax_root))
        twin = KERNEL_MODULES.get(rel, rel)
        assert twin is None or (port_root / twin).exists(), rel
    for path in _port_files():
        assert "NotImplementedError" not in path.read_text(), path.name


# The JAX package's tools/ with no module of the same name in the port's
# tools/, and why
TOOLS_LEFT = {
    name: "drives the JAX package's TPU measurement queues"
    for name in ("tpu_queue.sh", "tpu_queue2.sh", "tpu_queue_r5.sh")}


def test_every_jax_tool_has_a_counterpart_or_a_reason():
    """Each file of the JAX package's tools/ has a module of the same name
    in the port's tools/ or a TOOLS_LEFT entry, never both; the port's
    tools are among the files that must import no JAX."""
    jax_tools = sorted(p.name for p in (ROOT / "tools").iterdir()
                       if p.is_file())
    port_tools = ROOT / "x_detector_tpu_torch" / "tools"
    for name in jax_tools:
        assert (port_tools / name).exists() != (name in TOOLS_LEFT), name
    assert set(TOOLS_LEFT) <= set(jax_tools)
    ported = [p for p in port_tools.glob("*.py") if p.name in jax_tools]
    assert len(ported) == 19
    assert set(port_tools.glob("*.py")) <= set(_port_files())


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
                               "psroi_align_backward": 0, "nms_suppress": 0}
    # exact NMS's two kernels for the proposals and for the tail
    assert res["expected"] == {"fused_sepconv": 2 * 14, "psroi_align": 2,
                               "psroi_align_backward": 0,
                               "nms_suppress": 2 * 4}
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
    # exact NMS's two kernels a call: proposals and tail, or the tail
    nms_calls = 2 if path == "config1" else 1
    res = chip_smoke.run_slice(cfg, "cpu", batches=1, **kw)
    assert res["launches"] == dict.fromkeys(res["launches"], 0)
    assert res["expected"] == {"fused_sepconv": 2 * per_batch[0],
                               "psroi_align": 2 * per_batch[1],
                               "psroi_align_backward": 0,
                               "nms_suppress": 2 * 2 * nms_calls}
    assert res["detections"][0].shape[0] == kw["batch_size"]
    assert res["anchors"] == (960 if path == "config1" else 2046)
    assert chip_smoke.slice_reference_check(cfg.model, "cpu", keys) <= (
        chip_smoke.SLICE_REL_TOL)


@pytest.mark.parametrize("path", ["ssd", "lighthead"])
def test_cpu_rehearsal_of_chip_smoke_int8(path):
    """chip_smoke's int8 phase on thin backbones at 128 px, on the CPU: the
    calibration gives every range, the counters stay 0 while the expected
    counts follow from the model (K1 a dense QuantConv, K2 a depthwise one,
    K3 each but the pointwise convs whose input their block's K2 quantized;
    B2 never, though config 3 asks for the fused blocks), the
    prequantized model gives the in-graph model's bits, the 128 px check
    runs (the CPU in the card's place: no gap), and the hooks that read
    the kernel phase's call shapes see every QuantConv call."""
    chip_smoke = _chip_smoke()
    cfg, keys = {
        "ssd": (_thin(port_config.ssd_resnet50(128)),
                ("cls_logits", "box_codes")),
        "lighthead": (chip_smoke.fused(_thin(
            port_config.lighthead_xception(128), large_sep_mid=16,
            head_dim=32, backbone_widths=(16, 32, 48, 64),
            proposals=port_config.ProposalConfig(pre_nms_topk_eval=128,
                                                 post_nms_topk_eval=32,
                                                 min_size=2.0),
            nms=port_config.NMSConfig(max_output=20))),
            ("rpn_cls", "rpn_loc")),
    }[path]
    res, model = chip_smoke.run_int8(cfg, "cpu", batches=1, batch_size=2)
    assert res["launches"] == dict.fromkeys(res["launches"], 0)
    per_batch = {"ssd": (17, 0, 0, 0), "lighthead": (12, 8, 1, 8)}[path]
    assert chip_smoke.quantizing_blocks(model) == per_batch[3]
    assert res["expected"] == {
        "fused_sepconv": 0, "psroi_align": 2 * per_batch[2],
        "psroi_align_backward": 0,
        "nms_suppress": 2 * 2 * (1 + per_batch[2]),
        "int8_conv": 2 * per_batch[0],
        "int8_dwconv": 2 * per_batch[1],
        "quantize_s8": 2 * (per_batch[0] + per_batch[1] - per_batch[3])}
    assert all(float(v) > 0 for v in res["ranges"].values())
    assert len(res["ranges"]) == per_batch[0] + per_batch[1]
    assert chip_smoke.check_prequantized(model, cfg, "cpu") >= 6
    gaps = chip_smoke.int8_reference_check(cfg.model, "cpu", keys,
                                           res["ranges"])
    assert set(gaps.values()) == {0.0}
    calls, fused = chip_smoke.int8_conv_calls(cfg, "cpu", 2)
    assert sum(calls.values()) == per_batch[0] + per_batch[1]
    assert sum(n for shape, n in calls.items() if shape[-1]) == per_batch[1]
    assert sum(fused.values()) == per_batch[3]
    assert all(not shape[-1] and n <= calls[shape]
               for shape, n in fused.items())
    assert _build.library.cache_info().currsize == 0   # nothing was built


def test_cpu_rehearsal_of_chip_smoke_first_design_planned():
    """chip_smoke.first_design_planned: within it K1's plan is the first
    design's for every shape, cached; after it the rule's plan is back.
    alternating_ms hands back each side's rounds, which the int8 phase
    pairs round by round."""
    from x_detector_tpu_torch.ops import int8_conv
    chip_smoke = _chip_smoke()
    g = int8_conv.conv_geometry((1, 1), (1, 1), (1, 1), ((0, 0), (0, 0)))
    assert int8_conv.plan_conv((8, 32, 32, 256), 256, g).route == "tma"
    with chip_smoke.first_design_planned():
        for ptr in (0, 4):
            plan = int8_conv.plan_conv((8, 32, 32, 256), 256, g, x_ptr=ptr)
            assert plan == int8_conv.plan_mma(256, 256, ptr)
    assert int8_conv.plan_conv((8, 32, 32, 256), 256, g).route == "tma"
    calls = []
    ms = chip_smoke.alternating_ms({"a": lambda: calls.append("a"),
                                    "b": lambda: calls.append("b")},
                                   rounds=4, batches=2, device="cpu")
    assert calls == (["a"] * 2 + ["b"] * 2) * 4
    assert [len(v["rounds"]) for v in ms.values()] == [4, 4]
    assert ms["a"]["median"] == sorted(ms["a"]["rounds"])[2]
    assert "median of 4 alternating rounds of" in chip_smoke.rounds_text(ms)


def test_cpu_rehearsal_of_chip_smoke_serve(tmp_path):
    """chip_smoke's serve phase on the CPU at tiny shapes: the fused thin
    Light-Head at 64 px as a raw-RGB letterbox container of buckets 1
    (baked) and 2, loaded and held bit for bit to the eager path at each
    bucket and through a program taking the weights as inputs, the
    expected launches a batch read by counters that stay 0 (no kernel on
    the CPU); the thin int8 SSD as a prequantized container holding int8
    tensors, bit for bit against the eager model; cli.predict --artifact
    writes its PNG."""
    chip_smoke = _chip_smoke()
    cfg = chip_smoke.fused(_thin(
        port_config.lighthead_xception(64), large_sep_mid=16, head_dim=32,
        backbone_widths=(16, 32, 48, 64),
        proposals=port_config.ProposalConfig(pre_nms_topk_eval=128,
                                             post_nms_topk_eval=32,
                                             min_size=2.0),
        nms=port_config.NMSConfig(max_output=20)))
    res = chip_smoke.run_serve(cfg, "cpu", str(tmp_path / "lh"), (1, 2),
                               (1,), batches=1, raw_hw=(30, 40), rounds=2)
    assert sorted(res["export_s"]) == [1, 2]
    for b, r in res["buckets"].items():
        sides = ("eager", "loaded", "shared")[:3 if b == 1 else 2]
        assert tuple(r["ms"]) == sides
        for side in sides:
            assert r[side]["per_batch"] == dict.fromkeys(
                ("fused_sepconv", "psroi_align", "psroi_align_backward",
                 "nms_suppress"), 0)
            assert 0 < r["ms"][side]["best"] <= r["ms"][side]["median"]
    assert res["weights_mb"] > 0
    pred = chip_smoke.run_predict_artifact(str(tmp_path / "lh"), "cpu",
                                           str(tmp_path))
    assert pred["png_bytes"] > 0
    ssd = _thin(port_config.ssd_resnet50(128))
    res = chip_smoke.run_serve_int8(ssd, "cpu", str(tmp_path / "q"),
                                    bucket=2, batches=1, rounds=2)
    assert "torch.int8" in res["stored"]
    assert set(res["ms"]) == {"eager", "loaded"}
    assert res["loaded"]["per_batch"] == dict.fromkeys(
        res["loaded"]["per_batch"], 0)
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
                               "psroi_align_backward": 0, "nms_suppress": 0}
    # exact NMS's two kernels in each step's proposal stage
    assert res["expected"] == {"fused_sepconv": 0, "psroi_align": 2,
                               "psroi_align_backward": 2,
                               "nms_suppress": 2 * 2}
    assert len(res["seconds"]) == 1 and len(res["losses"]) == 2
    for metrics in res["losses"]:
        assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert res["moved"] == res["params"] > 0
    accum = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, grad_accum_steps=2))
    assert chip_smoke.run_train(accum, "cpu", steps=0)["expected"] == {
        "fused_sepconv": 0, "psroi_align": 2, "psroi_align_backward": 2,
        "nms_suppress": 2 * 2}
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


def test_kernel_sources_compile_no_measurement_switches():
    """The hand kernels compile one way: no source leaves code in or out
    on a switch of its own (an ``XDT_`` macro)."""
    sources = sorted((ROOT / "x_detector_tpu_torch" / "csrc").glob("*"))
    assert sources
    switch = re.compile(r"^\s*#\s*(if|ifdef|ifndef|elif)\b.*\bXDT_", re.M)
    for path in sources:
        assert not switch.search(path.read_text()), path.name


def _thin_ssd_train(chip_smoke, preset, image_size):
    cfg = chip_smoke.ssd_train_config(preset, image_size, batch_size=2)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_stages=(1, 1, 1, 1),
        backbone_widths=(16, 32, 48, 64)))


@pytest.mark.parametrize("preset", ["ssd_resnet50", "xdet_xception"])
def test_cpu_rehearsal_of_chip_smoke_train_ssd(preset):
    """chip_smoke's train_ssd and train_xdet phases at 128 px on thin
    backbones, on the CPU: no kernel is expected or launched, the losses
    are finite with positives matched, every parameter moves, and config
    2's shadow moves and equals d * e + (1 - d) * p of the last step's
    inputs (xdet has none); then the 128 px check runs its comparison
    (the CPU in bf16 in the card's place)."""
    chip_smoke = _chip_smoke()
    cfg = _thin_ssd_train(chip_smoke, preset, 128)
    res = chip_smoke.run_train(cfg, "cpu", steps=1)
    zero = {"fused_sepconv": 0, "psroi_align": 0, "psroi_align_backward": 0,
            "nms_suppress": 0}
    chip_smoke.check_train(preset, res, zero)
    assert all(m["ssd_num_fg"] > 0 for m in res["losses"])
    assert ("ema" in res) == (preset == "ssd_resnet50")
    if "ema" in res:
        assert res["ema"]["moved"] >= res["moved"] > 0
    readings = chip_smoke.ssd_train_reference_check(
        _thin_ssd_train(chip_smoke, preset, 128), "cpu")
    for key in ("loss", "leaf_grad", "leaf_update"):
        assert readings["bf16_" + key] == readings["control_" + key]
        assert readings[key] == 0.0        # the CPU in fp32 twice
    assert readings["bf16_loss"] <= chip_smoke.TRAIN_LOSS_REL_TOL
    assert _build.library.cache_info().currsize == 0   # nothing was built


def test_chip_smoke_train_check_catches_a_shadow_off_its_update():
    """check_train fails when the shadow is not d * e + (1 - d) * p."""
    chip_smoke = _chip_smoke()
    res = {"seconds": [0.1], "losses": [{"total_loss": 1.0}] * 2,
           "launches": {"b": 0}, "expected": {"b": 0}, "moved": 3,
           "params": 3, "stuck": [],
           "ema": {"moved": 3, "gap": 1e-6, "scale": 1.0}}
    with pytest.raises(AssertionError, match="EMA shadow"):
        chip_smoke.check_train("t", res, {"b": 0})
    res["ema"]["gap"] = 1e-7
    chip_smoke.check_train("t", res, {"b": 0})


def test_cpu_rehearsal_of_chip_smoke_cli():
    """chip_smoke's cli phase on the CPU with thin backbones at 64 px: the
    SSD run's checkpoint reloads bit for bit and resumes, evaluate takes
    the shadow, and the Light-Head run expects B1's forward and backward
    twice (the CPU launches no kernel)."""
    chip_smoke = _chip_smoke()
    res = chip_smoke.run_cli("cpu", extra=[
        "--image-size", "64", "--batch-size", "2", "--backbone-stages",
        "1,1,1,1", "--backbone-widths", "16,32,48,64", "--dtype",
        "float32"])
    assert res["launches"] == {"fused_sepconv": 0, "psroi_align": 0,
                               "psroi_align_backward": 0, "nms_suppress": 0}
    assert res["expected"] == {"fused_sepconv": 0, "psroi_align": 2,
                               "psroi_align_backward": 2,
                               "nms_suppress": 2 * 2}
    assert res["evaluate"]["ema"] and res["evaluate"]["step"] == (
        chip_smoke.CLI_RESUME_STEPS)


def _thin_lighthead(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, image_size=64, large_sep_mid=16, head_dim=32,
        backbone_stages=(1, 1, 1, 1), backbone_widths=(16, 32, 48, 64),
        proposals=port_config.ProposalConfig(pre_nms_topk=300,
                                             post_nms_topk=64, min_size=2.0)),
        data=dataclasses.replace(cfg.data, image_size=64))


def test_cpu_rehearsal_of_chip_smoke_dp():
    """chip_smoke.run_dp at world 1 over a gloo group on the CPU, 2
    microbatches of 2 at 64 px: every parameter moves, the expected counts
    (B1 once a microbatch each way) follow from the accumulation, the
    all-reduce is timed and its buffer counted, and the group is gone
    afterwards."""
    chip_smoke = _chip_smoke()
    cfg = _thin_lighthead(port_config.config5(1, 64, global_batch=4,
                                              microbatch=2))
    assert cfg.train.batch_size == 4 and cfg.train.grad_accum_steps == 2
    res = chip_smoke.run_dp(cfg, "cpu", steps=1)
    assert res["expected"] == {"fused_sepconv": 0, "psroi_align": 4,
                               "psroi_align_backward": 4,
                               "nms_suppress": 4 * 2}
    assert res["launches"] == dict.fromkeys(res["launches"], 0)
    assert res["moved"] == res["params"] > 0 and not res["stuck"]
    assert res["allreduce_ms"] > 0 and res["allreduce_bytes"] > 4e5
    assert "state" not in res
    assert not torch.distributed.is_initialized()


def test_cpu_rehearsal_of_chip_smoke_dp_pair(monkeypatch):
    """chip_smoke.run_dp_pair with two gloo ranks on the CPU (2 images each,
    2 steps): the ranks' train states agree bit for bit, and with the
    accumulation's too (one thread a process): parameters, BatchNorm
    running stats, momentum and the step."""
    monkeypatch.syspath_prepend(str(ROOT))        # the ranks import it
    chip_smoke = _chip_smoke()
    cfg = _thin_lighthead(port_config.config5(2, 64, global_batch=4,
                                              microbatch=2))
    assert cfg.train.grad_accum_steps == 1
    pair = chip_smoke.run_dp_pair(cfg, "cpu", steps=2)
    assert set(pair) == {"model", "running stats", "momentum", "step"}
    assert pair["momentum"] == pair["model"] > 0 < pair["running stats"]


def test_chip_smoke_train_snapshots_differ_in_each_kind():
    """snapshot_differs names a tensor of each kind of the train state that
    moved: a running stat, a momentum buffer, the step; none when equal."""
    from x_detector_tpu_torch.data.augment import preprocess_batch_for_train
    from x_detector_tpu_torch.data.synthetic import synthetic_batch_device
    from x_detector_tpu_torch.train.trainer import (create_model_and_state,
                                                    make_train_step)
    chip_smoke = _chip_smoke()
    cfg = _thin_lighthead(port_config.config5(1, 64, global_batch=2,
                                              microbatch=2))
    state = create_model_and_state(cfg, "cpu", seed=0, dtype=torch.float32)
    step = make_train_step(state.model, cfg)
    gen = torch.Generator().manual_seed(0)
    state, _ = step(state, preprocess_batch_for_train(
        gen, synthetic_batch_device(gen, 2, 76, cfg.data.max_gt_boxes),
        cfg.data), gen)
    a = chip_smoke.train_snapshot(state)
    assert chip_smoke.snapshot_differs(a, chip_smoke.train_snapshot(state)
                                       ) == []
    for key in (next(k for k in a if k.endswith("running_var")),
                "momentum.0", "step"):
        b = dict(a, **{key: a[key] + 1})
        assert chip_smoke.snapshot_differs(a, b) == [key]


def test_cpu_rehearsal_of_chip_smoke_cli_refusal():
    chip_smoke = _chip_smoke()
    assert "0 visible" in chip_smoke.check_cli_refuses_two_ranks("cuda")


def test_cpu_rehearsal_of_chip_smoke_data():
    """chip_smoke.run_data on the CPU with thin flags: the committed JPEGs
    decode (libjpeg here) to exactly the committed pixels, the loader
    resumes bitwise and is timed on photo-sized JPEGs made on the spot,
    and the CLIs train 3 steps and evaluate from those shards (B1 expected
    once a step each way; the CPU launches no kernel)."""
    chip_smoke = _chip_smoke()
    res = chip_smoke.run_data("cpu", extra=[
        "--image-size", "64", "--batch-size", "2", "--backbone-stages",
        "1,1,1,1", "--backbone-widths", "16,32,48,64", "--dtype",
        "float32"], rate_batches=1, canvas=96, photos=4)
    assert res["decoder"] == "libjpeg"
    assert [v[0] for v in res["pixels"].values()] == [
        "420", "420", "420", "full", "full", "420"]
    assert all(v[1:] == (0, 0.0) for v in res["pixels"].values())
    assert 50 < res["photo_kb"] < 120
    assert res["cores"] >= 1 and 1 in res["images_per_s"]
    assert all(r > 0 for r in res["images_per_s"].values())
    assert res["launches"] == dict.fromkeys(res["launches"], 0)
    assert res["expected"] == {"fused_sepconv": 0, "psroi_align": 3,
                               "psroi_align_backward": 3,
                               "nms_suppress": 3 * 2}
    assert len(res["losses"]) == 3 and 0.0 <= res["mAP"] <= 1.0
    assert res["inspected"] == 6          # cli.inspect_data: a PNG an image


def _thin_eval_lighthead(size=64):
    """Config 3 (fused) on the thin Xception-lite at ``size`` px, budgets cut
    to the tiny map."""
    cfg = _thin(port_config.lighthead_xception(size), large_sep_mid=16,
                head_dim=32, backbone_widths=(16, 32, 48, 64),
                backbone_fused_sepconv=True,
                proposals=port_config.ProposalConfig(pre_nms_topk_eval=128,
                                                     post_nms_topk_eval=32,
                                                     min_size=2.0),
                nms=port_config.NMSConfig(max_output=20))
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, image_size=size))


@pytest.mark.parametrize("family", ["lighthead", "ssd"])
def test_cpu_rehearsal_of_chip_smoke_fast(family):
    """chip_smoke's fast phase on the CPU: MaxpoolNMS beside the exact path
    on thin models. The counters stay 0 while the expected counts follow
    from the model (B2 once a fused block, 6 a batch on the thin
    Xception); NMS's fixpoint ran in the exact path's proposal stage (or
    its SSD tail) and never in the fast one's; both paths timed in
    alternating rounds; for Light-Head the profiler's trace is read and
    the DeviceTimer times the fast batch; the 128 px check runs."""
    chip_smoke = _chip_smoke()
    cfg = (_thin_eval_lighthead() if family == "lighthead"
           else _thin(port_config.ssd_resnet50(128)))
    res = chip_smoke.run_fast(cfg, "cpu", batches=1, batch_size=2, rounds=2,
                              profile=family == "lighthead")
    # exact NMS's two kernels in the Light-Head's tail, which MaxpoolNMS
    # leaves exact; none in the SSD's
    per_batch = {"fused_sepconv": 6 if family == "lighthead" else 0,
                 "psroi_align": int(family == "lighthead"),
                 "psroi_align_backward": 0,
                 "nms_suppress": 2 if family == "lighthead" else 0}
    assert res["launches"] == dict.fromkeys(res["launches"], 0)
    assert res["expected"] == {k: 2 * v for k, v in per_batch.items()}
    chip_smoke.check_fast(family, res, family)
    assert set(res["ms"]) == {"exact", "fast"}
    if family == "lighthead":
        assert res["suppress"]["all"] > 0         # the final NMS still runs
        assert res["trace_kernels"] == [] and res["timer_ms"] > 0
        assert chip_smoke.slice_reference_check(
            chip_smoke.maxpool_nms(cfg).model, "cpu",
            ("rpn_cls", "rpn_loc")) <= chip_smoke.SLICE_REL_TOL
    else:
        assert res["suppress"] == {"all": 0, "forward": 0}
    with pytest.raises(AssertionError, match="fixpoint"):
        chip_smoke.check_fast(family, dict(res, suppress=res[
            "exact_suppress"]), family)
    assert _build.library.cache_info().currsize == 0   # nothing was built


def test_cpu_rehearsal_of_chip_smoke_dense():
    """chip_smoke's dense phase on the CPU: the thin fused model with
    dense_stages=1 expects B2 4 times a batch (stage 1's two blocks dense),
    the 128 px check runs on the dense model, and config 4's step with
    dense_stages=1 expects B1 once each way and moves every parameter."""
    chip_smoke = _chip_smoke()
    cfg = _thin_eval_lighthead()
    model = chip_smoke.slice_model(cfg.model, "cpu", dense_stages=1)
    assert not model.training
    res = chip_smoke.run_slice(cfg, "cpu", batches=1, batch_size=2,
                               model=model)
    assert res["expected"] == {"fused_sepconv": 2 * 4, "psroi_align": 2,
                               "psroi_align_backward": 0,
                               "nms_suppress": 2 * 4}
    assert chip_smoke.slice_reference_check(
        cfg.model, "cpu", ("rpn_cls", "rpn_loc"), dense_stages=1) <= (
        chip_smoke.SLICE_REL_TOL)
    train_cfg = _thin_lighthead(chip_smoke.train_config(64, batch_size=2))
    res = chip_smoke.run_train(train_cfg, "cpu", steps=1, dense_stages=1)
    assert res["expected"] == {"fused_sepconv": 0, "psroi_align": 2,
                               "psroi_align_backward": 2,
                               "nms_suppress": 2 * 2}
    assert res["moved"] == res["params"] > 0
    assert _build.library.cache_info().currsize == 0   # nothing was built


def test_cpu_rehearsal_of_chip_smoke_train_act8():
    """chip_smoke's train_act8 phase on the CPU: config 4's thin step with
    backbone_quant="act8" expects K3 once a backbone conv and the int8
    convs never, moves every parameter; the act8 conv against the plain
    one at a small stage-1 shape: output and dL/dx bitwise, dL/dk within
    the bound."""
    chip_smoke = _chip_smoke()
    cfg = _thin_lighthead(chip_smoke.train_config(64, batch_size=2))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_quant="act8"))
    res = chip_smoke.run_train(cfg, "cpu", steps=1)
    assert res["launches"] == dict.fromkeys(res["launches"], 0)
    assert res["expected"] == {"fused_sepconv": 0, "psroi_align": 2,
                               "psroi_align_backward": 2,
                               "nms_suppress": 2 * 2, "int8_conv": 0,
                               "int8_dwconv": 0, "quantize_s8": 2 * 20}
    assert res["moved"] == res["params"] > 0
    grads = chip_smoke.act8_grad_check("cpu", shape=(2, 8, 12, 12))
    assert set(grads) == {"depthwise", "pointwise"}
    assert _build.library.cache_info().currsize == 0   # nothing was built


@pytest.mark.parametrize("family", ["lighthead", "ssd"])
def test_cpu_rehearsal_of_chip_smoke_train_remat(family):
    """chip_smoke's train_remat phase on the CPU: 3 steps with
    backbone_remat_stages=2 bitwise equal to 3 without (every tensor of
    the train state), both timed, with the deterministic settings restored
    after."""
    chip_smoke = _chip_smoke()
    if family == "lighthead":
        cfg = _thin_lighthead(chip_smoke.train_config(64, batch_size=2))
    else:
        cfg = _thin_ssd_train(chip_smoke, "ssd_resnet50", 128)
    res = chip_smoke.run_remat_pair(cfg, "cpu")
    b1 = 3 if family == "lighthead" else 0
    assert res["expected"] == {"fused_sepconv": 0, "psroi_align": b1,
                               "psroi_align_backward": b1,
                               "nms_suppress": 2 * b1}
    assert res["launches"] == dict.fromkeys(res["launches"], 0)
    assert res["tensors"] > 50 and res["nondeterministic"] == []
    assert set(res["step_ms"]) == {0, 2} and min(res["step_ms"].values()) > 0
    assert not torch.are_deterministic_algorithms_enabled()
    assert not torch.backends.cudnn.deterministic


def test_chip_smoke_remat_pair_catches_a_second_stat_update(monkeypatch):
    """With the recompute's guard off, a remat step moves the running stats
    twice and the pair fails."""
    from x_detector_tpu_torch.models import layers
    chip_smoke = _chip_smoke()
    monkeypatch.setattr(layers, "_recomputing",
                        lambda: layers.contextlib.nullcontext())
    cfg = _thin_lighthead(chip_smoke.train_config(64, batch_size=2))
    with pytest.raises(AssertionError, match="differs"):
        chip_smoke.run_remat_pair(cfg, "cpu", steps=1)


def test_cpu_rehearsal_of_chip_smoke_cli_rest():
    """chip_smoke's cli_rest phase on the CPU with a thin ResNet: a
    torchvision-named .pth of seeded values grafted bit for bit by
    cli.train --pretrained, 2 steps, the TensorBoard file holding every
    scalar of metrics.jsonl; B1 expected twice each way."""
    chip_smoke = _chip_smoke()
    res = chip_smoke.run_cli_rest("cpu", extra=[
        "--image-size", "64", "--backbone-stages", "1,1,1,1",
        "--backbone-widths", "8,16,24,32", "--dtype", "float32"],
        batch_size=2, stage_sizes=(1, 1, 1, 1), widths=(8, 16, 24, 32))
    assert res["launches"] == dict.fromkeys(res["launches"], 0)
    assert res["expected"] == {"fused_sepconv": 0, "psroi_align": 2,
                               "psroi_align_backward": 2,
                               "nms_suppress": 2 * 2}
    assert res["tensors"] == 5 + 4 * (3 * 5 + 5)
    assert res["scalars"] >= 2 * 8 and len(res["losses"]) == 2
    sd = chip_smoke.torchvision_resnet50_state()
    assert sd["layer4.2.conv3.weight"].shape == (2048, 512, 1, 1)
    assert sd["fc.weight"].shape == (1000, 2048)
