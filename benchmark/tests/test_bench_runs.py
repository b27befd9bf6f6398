"""Whole runs of every cell on the CPU at a small size: the harness without
its look for a chip, the program in float32 (so that it agrees with the
reference to rounding), judged by each cell's own limits. A sound run is
correct; the control (the reference in fp8 in the program's place) and a
run with the timed path broken underneath are not; and no run loads JAX or
the JAX package."""

import functools
import os
import subprocess
import sys
import time
import types

import pytest
import torch

from benchmark.control import control_numbers
from benchmark.harness import core, spec
from benchmark.loops import train as train_loop
from benchmark.tests.tiny import CELLS, LISTED, load, tiny_cell

SEED = 2 ** 31 + 977


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def run(cell, seconds=0.3):
    return core.run_cell(cell.name, SEED, seconds, False,
                         torch.device("cpu"), time.perf_counter(), cell)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run(tiny_cell(name))
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    for m in load(name).end_to_end:
        if m["unit"] != "GiB":             # a card's memory: none here
            assert out["metrics"][m["name"]]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_program_in_float32(name):
    """The reference against the port at tiny widths: rounding apart."""
    checks = run(tiny_cell(name))["checks"]
    for key, c in checks.items():
        assert c["value"] < 1e-3, (key, c)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    for which, numbers in control_numbers(cell, 5, torch.device("cpu")
                                          ).items():
        assert not core.verdict(numbers, cell.limits), (which, numbers)


def _wrap_eval_fn(change):
    """``inference.build_eval_fn`` whose detect function goes through
    ``change``."""
    from x_detector_tpu_torch import inference
    build = inference.build_eval_fn

    def broken(model, cfg, device):
        detect = build(model, cfg, device)
        return lambda images: change(detect, images)
    return inference, "build_eval_fn", broken


def _half_images(detect, images):
    images = images.clone()
    images[images.shape[0] // 2:] = 0.0
    return detect(images)


def _altered_answer(detect, images):
    boxes, scores, classes, valid = detect(images)
    scores = scores.clone()
    scores[:, 0] += 0.01
    return boxes, scores, classes, valid


def _first_half(fn):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        h = out[0].shape[0] // 2
        return (torch.cat([out[0][:h], out[0][:h]]),) + tuple(out[1:])
    return wrapped


def fault_patches(fault: str) -> list:
    """(owner, attribute, replacement) that plant ``fault`` in the
    program."""
    if fault in ("half_images", "altered_answer"):
        return [_wrap_eval_fn(globals()["_" + fault])]
    if fault == "unchanged_state":
        from x_detector_tpu_torch.train.train_state import TrainState

        def no_update(self):
            self.step += 1
            return self
        return [(TrainState, "apply_gradients", no_update)]
    if fault == "half_batch_loss":
        from x_detector_tpu_torch.train import losses
        return [(losses, name, _first_half(getattr(losses, name)))
                for name in ("rpn_loss", "roi_loss_ohem")]
    if fault == "no_exchange":
        from x_detector_tpu_torch.parallel import data_parallel
        return [(data_parallel, "make_sync",
                 lambda model, group=None: (lambda metrics: metrics))]
    raise KeyError(fault)


def _faulty_rank(fault, rank, world, *args):
    """A rank of a spawned group with ``fault`` planted in its process."""
    for owner, name, value in fault_patches(fault):
        setattr(owner, name, value)
    return train_loop._rank(rank, world, *args)


def faults_of(name: str) -> list:
    cell = load(name)
    if cell.traffic["loop"] == "serve":
        return ["half_images", "altered_answer"]
    return ["unchanged_state", "half_batch_loss"] + (
        ["no_exchange"] if cell.chips > 1 else [])


FAULTS = [(c, f) for c in CELLS for f in faults_of(c)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{c}-{f}" for c, f in FAULTS])
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    if cell.chips > 1:
        monkeypatch.setattr(train_loop, "_rank",
                            functools.partial(_faulty_rank, fault))
    else:
        for owner, attr, value in fault_patches(fault):
            monkeypatch.setattr(owner, attr, value)
    out = run(cell)
    assert not out["correct"], out["checks"]


REHEARSAL = """
import sys, time, torch
sys.path.insert(0, {root!r})
from benchmark.harness import core
from benchmark.tests.tiny import tiny_cell

if __name__ == "__main__":
    torch.set_num_threads(2)
    cell = tiny_cell({name!r})
    out = core.run_cell(cell.name, 7, 0.2, False, torch.device("cpu"),
                        time.perf_counter(), cell)
    print(out["correct"], core.forbidden_modules())
"""


@pytest.mark.parametrize("name", CELLS)
def test_no_jax_in_a_run(name, tmp_path):
    """A fresh process that rehearses the cell's loop has loaded no module
    whose top-level name is jax, jaxlib, flax or x_detector_tpu."""
    script = tmp_path / "rehearse.py"
    script.write_text(REHEARSAL.format(root=str(spec.ROOT), name=name))
    p = subprocess.run([sys.executable, str(script)], capture_output=True,
        text=True,
        cwd=spec.ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"),
        timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "True []"


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "x_detector_tpu_torch_extra", sys)
    assert "x_detector_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "x_detector_tpu.config", sys)
    assert core.forbidden_modules() == ["x_detector_tpu"]


def _planted_rank(rank, world, *args):
    """A rank that loads a module named as the JAX package is."""
    if rank == world - 1:
        sys.modules["x_detector_tpu"] = types.ModuleType("x_detector_tpu")
    return train_loop._rank(rank, world, *args)


def test_a_rank_that_loads_the_jax_package_is_refused(monkeypatch, capsys):
    """The four-rank path: a module that only a rank other than the first
    loaded refuses the run (exit 3, no result line)."""
    monkeypatch.setattr(train_loop, "_rank", _planted_rank)
    out = run(tiny_cell("lhx_dp4_train_g128"))
    assert out["correct"] and out["loaded"] == ["x_detector_tpu"]
    assert core.report(out) == 3
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", LISTED)
def test_control_at_the_cells_size_on_the_card(name):
    """On a card, the control at the cell's own size fails its limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load_cell(name)
    for which, numbers in control_numbers(cell, 5, torch.device("cuda")
                                          ).items():
        assert not core.verdict(numbers, cell.limits), (which, numbers)


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = core.main(time.perf_counter(), ["--workload", LISTED[0], "--seed",
                                           "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert code != 0 and out.out == ""
