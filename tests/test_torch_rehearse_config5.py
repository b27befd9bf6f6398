"""Config 5's crash-and-resume rehearsal of the port
(``x_detector_tpu_torch/tools/rehearse_config5.py``) on the CPU: a gloo
data-parallel run, the same run hard-killed (``os._exit``) right after a
checkpoint landed, resumed, and every tensor of the train state bitwise
equal to the uninterrupted run's. The counterpart of the JAX package's
``tests/test_rehearse_config5.py``, whose 8-rank default and config 5's
literal 16 x 8 shape are ``slow`` here as there; a resume from a
checkpoint with one momentum tensor moved must fail the verdict."""

import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from x_detector_tpu_torch.tools import rehearse_config5 as rc5  # noqa: E402
from x_detector_tpu_torch.train.checkpoint import (  # noqa: E402
    CheckpointManager)


def _verdict(out: str) -> dict:
    return json.loads([line for line in out.splitlines()
                       if line.startswith("{")][-1])


def _rehearse(capfd, *argv, after_kill=None):
    rc = rc5.main(["--device", "cpu", *argv], after_kill=after_kill)
    out = capfd.readouterr().out      # the children print to the fd
    return rc, out, _verdict(out)


def test_two_ranks_crash_and_resume_bitwise(capfd):
    """2 gloo ranks, 6 steps, a checkpoint every 2, killed after step 2:
    run C's train state equals run A's in every tensor, and each child
    printed its steps (the resumed one from step 3)."""
    rc, out, verdict = _rehearse(capfd, "--devices", "2",
                                 "--per-device-batch", "1", "--steps", "6",
                                 "--ckpt-every", "2")
    assert rc == 0, out[-3000:]
    assert verdict == {"steps": 6, "killed_after": 2, "devices": 2,
                       "global_batch": 2, "grad_accum": 1,
                       "leaves": verdict["leaves"], "mismatched": 0,
                       "bitwise_identical": True}
    assert verdict["leaves"] > 100
    assert out.count("hard-killing after step 2") == 1
    assert "resumed at step 2" in out
    assert out.count("step 6: loss") == 2       # runs A and C


def _perturb_one_momentum_tensor(ckpt_dir):
    """Add 1e-3 to one momentum buffer of the newest checkpoint, in place
    (a change of one ulp can vanish: a buffer of zeros moved to a
    denormal moves no parameter)."""
    mgr = CheckpointManager(ckpt_dir)
    path = f"{ckpt_dir}/ckpt-{mgr.latest_step()}.pt"
    payload = torch.load(path, weights_only=True)
    payload["optimizer"]["state"][0]["momentum_buffer"] += 1e-3
    torch.save(payload, path)


def test_a_resume_from_a_moved_momentum_tensor_fails(capfd):
    """Run C resumed from a checkpoint whose first momentum buffer moved:
    the verdict counts mismatched tensors and the tool exits 1."""
    rc, out, verdict = _rehearse(
        capfd, "--devices", "2", "--per-device-batch", "1", "--steps", "4",
        "--ckpt-every", "2", after_kill=_perturb_one_momentum_tensor)
    assert rc == 1, out[-3000:]
    assert verdict["mismatched"] > 0
    assert verdict["bitwise_identical"] is False


def test_run_b_must_die_with_kill_exit(monkeypatch):
    """A run B that ends any other way than every rank exiting with
    KILL_EXIT is a failure of the rehearsal."""
    monkeypatch.setattr(rc5, "run_child", lambda out, args, **kw: 0)
    with pytest.raises(SystemExit, match=f"run B should die with "
                                         f"{rc5.KILL_EXIT}, rc=0"):
        rc5.main(["--device", "cpu", "--devices", "2", "--steps", "2",
                  "--ckpt-every", "1"])


@pytest.mark.parametrize("codes, killed", [
    ({0: rc5.KILL_EXIT, 1: rc5.KILL_EXIT}, True),
    ({0: rc5.KILL_EXIT}, False),
    ({0: rc5.KILL_EXIT, 1: 1}, False)])
def test_child_exits_kill_exit_only_when_every_rank_did(monkeypatch, codes,
                                                        killed):
    """``run_ranks``' failure becomes KILL_EXIT only when every rank exited
    with it; a rank that failed otherwise, or did not end, stays an
    error."""
    from x_detector_tpu_torch.parallel import mesh

    def ranks_failed(*a, **kw):
        raise mesh.RanksFailed(codes, 2)
    monkeypatch.setattr(mesh, "run_ranks", ranks_failed)
    args = rc5.parse_args(["--mode", "child", "--device", "cpu",
                           "--devices", "2", "--kill-after", "2"])
    if killed:
        assert rc5.child_main(args) == rc5.KILL_EXIT
    else:
        with pytest.raises(mesh.RanksFailed):
            rc5.child_main(args)


def test_rehearsal_configs():
    """The tiny Light-Head is the JAX tool's ``tiny_lh_dp``; ``--full-width``
    is config 5's model, and one card at 8 x 16 steps on its global batch
    of 128."""
    from x_detector_tpu_torch.config import config5
    tiny = rc5.rehearsal_config(8, 1, 1, False)
    assert (tiny.model.name, tiny.model.image_size, tiny.train.batch_size,
            tiny.train.learning_rate) == ("tiny_lh_dp", 64, 8, 1e-3)
    full = rc5.rehearsal_config(1, 8, 16, True)
    assert full == config5(1, 800, 128, 8)
    assert (full.model.name, full.train.grad_accum_steps) == (
        "lighthead_xception", 16)


@pytest.mark.slow  # 3 subprocesses of 8 gloo ranks each
def test_eight_ranks_crash_and_resume_bitwise(capfd):
    rc, out, verdict = _rehearse(capfd, "--steps", "12", "--ckpt-every", "4")
    assert rc == 0, out[-3000:]
    assert verdict["bitwise_identical"] is True
    assert verdict["devices"] == 8 and verdict["leaves"] > 100


@pytest.mark.slow  # 3 subprocesses of 16 gloo ranks, 8 images each
def test_crash_and_resume_bitwise_config5_literal_shape(capfd):
    """The JAX test's literal geometry: 16 ranks of 8 images, a global
    batch of 128."""
    rc, out, verdict = _rehearse(capfd, "--devices", "16",
                                 "--per-device-batch", "8", "--steps", "6",
                                 "--ckpt-every", "2")
    assert rc == 0, out[-3000:]
    assert verdict["bitwise_identical"] is True
    assert verdict["devices"] == 16 and verdict["global_batch"] == 128
