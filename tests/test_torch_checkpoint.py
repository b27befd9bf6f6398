"""The port's CheckpointManager: bitwise save and restore, keep-N with the
sidecar sweep, the EMA reconciliation both ways (as
``x_detector_tpu/train/checkpoint.py`` restores), the optimizer's state
without its saved hyperparameters, and the refusals."""

import dataclasses
import json
import os
import warnings

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from x_detector_tpu_torch.config import ssd_resnet50  # noqa: E402
from x_detector_tpu_torch.data.augment import (  # noqa: E402
    preprocess_batch_for_train)
from x_detector_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_batch_device)
from x_detector_tpu_torch.train.checkpoint import (  # noqa: E402
    CheckpointManager)
from x_detector_tpu_torch.train.trainer import (  # noqa: E402
    create_model_and_state, make_train_step)


def tiny_ssd(ema_decay=0.99, image_size=64, widths=(8, 16, 24, 32),
             **train):
    cfg = ssd_resnet50(image_size)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model,
                                       backbone_stages=(1, 1, 1, 1),
                                       backbone_widths=widths),
        data=dataclasses.replace(cfg.data, max_gt_boxes=8),
        train=dataclasses.replace(cfg.train, batch_size=2,
                                  ema_decay=ema_decay, **train))


def trained_state(cfg, seed=0, steps=1):
    """A CPU fp32 state after ``steps`` updates (momentum buffers exist,
    the shadow and BatchNorm stats moved)."""
    state = create_model_and_state(cfg, "cpu", seed=seed,
                                   dtype=torch.float32)
    step = make_train_step(state.model, cfg)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        raw = synthetic_batch_device(gen, 2, 76, cfg.data.max_gt_boxes)
        state, _ = step(state, preprocess_batch_for_train(gen, raw,
                                                          cfg.data))
    return state


def snapshot(state):
    """Every tensor a checkpoint must carry, by name, and the step."""
    out = {"model." + k: v.clone() for k, v in
           state.model.state_dict().items()}
    opt = state.optimizer.state_dict()["state"]
    for i, s in opt.items():
        out[f"momentum.{i}"] = s["momentum_buffer"].clone()
    for k, v in (state.ema_params or {}).items():
        out["ema." + k] = v.clone()
    return out, state.step


def assert_bitwise(a, b):
    (ta, sa), (tb, sb) = a, b
    assert sa == sb and set(ta) == set(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def test_save_then_restore_is_bitwise(tmp_path):
    """A restore into a state built from another seed gives back every
    parameter, BatchNorm statistic, momentum buffer, the shadow, the step
    and the data state, bit for bit; the files are written atomically
    (no temporary file stays) with a sidecar naming the shadow."""
    cfg = tiny_ssd()
    state = trained_state(cfg, steps=2)
    saved = snapshot(state)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(2, state, data_state={"position": 7})
    assert sorted(os.listdir(tmp_path)) == ["ckpt-2.pt", "meta-2.json"]
    assert json.loads((tmp_path / "meta-2.json").read_text()) == {
        "has_ema": True}
    assert mgr.latest_step() == 2

    fresh = create_model_and_state(cfg, "cpu", seed=5, dtype=torch.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # no reconciliation here
        restored, data_state = CheckpointManager(str(tmp_path)).restore(fresh)
    assert restored is fresh and data_state == {"position": 7}
    assert_bitwise(snapshot(restored), saved)


def test_restored_state_trains_on_as_the_saved_one(tmp_path):
    """One more step from the restored state equals one more step from the
    state that was saved, bit for bit."""
    cfg = tiny_ssd()
    state = trained_state(cfg, steps=1)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    fresh = create_model_and_state(cfg, "cpu", seed=3, dtype=torch.float32)
    restored, _ = mgr.restore(fresh)
    gen = torch.Generator().manual_seed(9)
    raw = synthetic_batch_device(gen, 2, 76, cfg.data.max_gt_boxes)
    batch = preprocess_batch_for_train(gen, raw, cfg.data)
    for s in (state, restored):
        make_train_step(s.model, cfg)(s, batch)
    assert_bitwise(snapshot(restored), snapshot(state))


def test_keep_n_and_the_sidecar_sweep(tmp_path):
    """Only the newest ``keep`` checkpoints and their sidecars stay; the
    sidecar of a step with no checkpoint and temporary files a crash left
    are swept at the next save."""
    cfg = tiny_ssd(ema_decay=0.0)
    state = create_model_and_state(cfg, "cpu", seed=0, dtype=torch.float32)
    (tmp_path / "meta-9.json").write_text('{"has_ema": false}')
    (tmp_path / "meta-3.json.tmp").write_text("{")
    (tmp_path / "ckpt-3.pt.tmp").write_bytes(b"torn")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in range(1, 6):
        mgr.save(step, state, data_state={"position": step})
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt-4.pt", "ckpt-5.pt", "meta-4.json", "meta-5.json"]
    assert mgr.all_steps() == [4, 5] and mgr.latest_step() == 5
    assert json.loads((tmp_path / "meta-5.json").read_text()) == {
        "has_ema": False}
    _, data_state = mgr.restore(state, step=4)
    assert data_state == {"position": 4}
    mgr.wait()
    mgr.close()


def test_a_shadow_is_adopted_by_a_state_without_one(tmp_path):
    """A checkpoint with an EMA shadow restores into a state made with
    ``ema_decay=0``: the shadow is adopted with JAX's warning and stays
    frozen as training goes on."""
    state = trained_state(tiny_ssd(ema_decay=0.99))
    CheckpointManager(str(tmp_path)).save(1, state)
    plain = create_model_and_state(tiny_ssd(ema_decay=0.0), "cpu", seed=4,
                                   dtype=torch.float32)
    with pytest.warns(UserWarning, match="adopting the shadow"):
        restored, _ = CheckpointManager(str(tmp_path)).restore(plain)
    assert set(restored.ema_params) == set(state.ema_params)
    for k, v in state.ema_params.items():
        assert torch.equal(restored.ema_params[k], v)
    frozen = {k: v.clone() for k, v in restored.ema_params.items()}
    for p in restored.model.parameters():
        p.grad = torch.ones_like(p)
    restored.apply_gradients()
    for k, v in frozen.items():
        assert torch.equal(restored.ema_params[k], v), k


def test_a_missing_shadow_is_reseeded_from_the_restored_params(tmp_path):
    """A checkpoint without a shadow restores into a state that expects
    one: JAX's warning, and the shadow starts as a copy of the restored
    parameters (not of the state's own initial ones)."""
    state = trained_state(tiny_ssd(ema_decay=0.0))
    CheckpointManager(str(tmp_path)).save(1, state)
    ema = create_model_and_state(tiny_ssd(ema_decay=0.99), "cpu", seed=4,
                                 dtype=torch.float32)
    with pytest.warns(UserWarning, match="re-initializing the shadow"):
        restored, _ = CheckpointManager(str(tmp_path)).restore(ema)
    for name, p in restored.model.named_parameters():
        assert torch.equal(restored.ema_params[name], p)
        assert restored.ema_params[name].data_ptr() != p.data_ptr()
        assert torch.equal(p, dict(state.model.named_parameters())[name])


def test_restore_keeps_the_states_own_optimizer_hyperparameters(tmp_path):
    """The momentum buffers come back; the learning rate and the weight
    decay of each group stay the restoring state's, and the next update
    reads its lr from the schedule at the restored step."""
    state = trained_state(tiny_ssd(learning_rate=0.5, weight_decay=0.25,
                                   warmup_steps=0), steps=1)
    CheckpointManager(str(tmp_path)).save(1, state)
    cfg = tiny_ssd(learning_rate=1e-3, weight_decay=1e-4, warmup_steps=10)
    other = create_model_and_state(cfg, "cpu", seed=4, dtype=torch.float32)
    restored, _ = CheckpointManager(str(tmp_path)).restore(other)
    groups = restored.optimizer.param_groups
    assert [g["weight_decay"] for g in groups] == [1e-4, 0.0]
    assert all(g["lr"] == 1e-3 for g in groups)       # not the saved 0.5
    for p in restored.model.parameters():
        p.grad = torch.zeros_like(p)
    restored.apply_gradients()
    assert all(g["lr"] == restored.schedule(1) for g in groups)
    assert restored.schedule(1) != 0.5 and restored.step == 2


def test_restore_at_another_image_size_and_into_another_model(tmp_path):
    """The anchor grid is not saved: a checkpoint of the 64 px model loads
    into the 96 px one, which keeps its own anchors; a checkpoint of other
    widths raises, naming the file."""
    state = trained_state(tiny_ssd())
    CheckpointManager(str(tmp_path)).save(1, state)
    assert not any("anchors" in k for k in state.model.state_dict())
    bigger = create_model_and_state(tiny_ssd(image_size=96), "cpu", seed=4,
                                    dtype=torch.float32)
    anchors = bigger.model.anchors.clone()
    restored, _ = CheckpointManager(str(tmp_path)).restore(bigger)
    assert torch.equal(restored.model.anchors, anchors)
    assert anchors.shape[0] > state.model.anchors.shape[0]
    for name, p in restored.model.named_parameters():
        assert torch.equal(p, dict(state.model.named_parameters())[name])
    wider = create_model_and_state(tiny_ssd(widths=(8, 16, 24, 40)), "cpu",
                                   seed=4, dtype=torch.float32)
    with pytest.raises(ValueError, match="ckpt-1.pt does not fit"):
        CheckpointManager(str(tmp_path)).restore(wider)


def test_restore_without_a_checkpoint_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    assert mgr.latest_step() is None and mgr.all_steps() == []
    state = create_model_and_state(tiny_ssd(), "cpu", seed=0,
                                   dtype=torch.float32)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        mgr.restore(state)
