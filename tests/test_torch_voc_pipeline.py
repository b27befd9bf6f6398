"""The port's real-data pipeline rehearsal
(``x_detector_tpu_torch/tools/rehearse_voc_pipeline.py``) on the CPU with
thin flags: a generated VOCdevkit of photo-sized JPEGs through
``cli.convert_voc``, ``cli.train`` (the native loader, checkpoints, a
periodic eval; bf16, the CLIs' default), ``--resume``, ``cli.evaluate``,
``cli.predict``, ``cli.export`` and a reload of the raw-RGB letterbox
program in a fresh process, every stage its own process (a ``slow`` case:
over a minute). A broken stage stops the run, which names it and exits
non-zero. The counterpart of the JAX package's
``tools/rehearse_voc_pipeline.py``, which its tests do not run."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from x_detector_tpu_torch.tools import (  # noqa: E402
    rehearse_voc_pipeline as voc)

THIN = ["--device", "cpu", "--backbone-stages", "1,1,1,1",
        "--backbone-widths", "8,16,24,32"]
STAGES = ("generate", "convert", "train", "resume", "evaluate", "predict",
          "export", "reload")


@pytest.mark.slow  # 8 fresh processes, ~70 s alone and ~95 s in tier-1
def test_every_stage_passes_with_thin_flags(tmp_path, capsys):
    """Every stage passes, the resume continues from step 6, the reloaded
    program imports no model code. (Each stage's process spends ~3.6 s
    importing torch, and the reload ~7 s in ``torch.export.load``;
    ``chip_smoke.py``'s voc_pipeline phase runs the whole chain on the
    card.)"""
    assert voc.main([*THIN, "--workdir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for stage in STAGES:
        assert f"--- {stage} passed in" in out, stage
    assert "resumed from step 6 (data position 6)" in out
    assert "artifact reload OK: boxes (1, 200, 4)" in out
    assert "no model code imported" in out
    assert out.rstrip().endswith(f"REHEARSAL PASSED ({tmp_path})")
    assert (tmp_path / "pred.png").exists()
    assert sorted(p.name for p in (tmp_path / "model" / "ckpt").glob(
        "ckpt-*.pt")) == ["ckpt-2.pt", "ckpt-4.pt", "ckpt-6.pt",
                          "ckpt-8.pt"]


@pytest.mark.parametrize("blocked, stage", [("records", "convert"),
                                            ("model", "train")])
def test_a_broken_stage_stops_the_run_and_is_named(tmp_path, capsys,
                                                   blocked, stage):
    """A file where a stage must make its directory breaks that stage: the
    run exits 1 naming it, and no later stage runs."""
    (tmp_path / blocked).write_text("not a directory")
    assert voc.main([*THIN, "--workdir", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert out.rstrip().endswith(f"FAILED at stage: {stage}")
    later = STAGES[STAGES.index(stage) + 1:]
    assert not any(f"--- {s}:" in out for s in later)
