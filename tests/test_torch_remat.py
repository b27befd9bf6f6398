"""``backbone_remat_stages`` in the port: the JAX package recomputes the
first N backbone stages in its backward (``nn.remat``); the port has no
recompute yet, so its train path refuses the field, and inference ignores
it as the JAX package's does."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_train import get_batch, small_lighthead_cfg, small_ssd_cfg  # noqa
from x_detector_tpu_torch.inference import build_eval_fn, build_model  # noqa
from x_detector_tpu_torch.train.trainer import (  # noqa: E402
    create_model_and_state, make_train_step)


def _remat(cfg, stages=2):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_remat_stages=stages))


@pytest.mark.parametrize("make_cfg", [small_lighthead_cfg, small_ssd_cfg],
                         ids=["lighthead", "ssd"])
def test_train_path_refuses_remat_and_inference_ignores_it(make_cfg):
    """create_model_and_state and make_train_step raise, naming the queue
    item that ports the recompute; a model of the same config detects as
    one without the field."""
    cfg = make_cfg()
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        create_model_and_state(_remat(cfg), "cpu", seed=0,
                               dtype=torch.float32)
    state = create_model_and_state(cfg, "cpu", seed=0, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="backbone_remat_stages=2"):
        make_train_step(state.model, _remat(cfg))
    images = torch.from_numpy(np.array(get_batch(cfg)["image"]))
    want = build_eval_fn(build_model(cfg.model, "cpu", seed=0,
                                      dtype=torch.float32), cfg, "cpu")(images)
    got = build_eval_fn(build_model(_remat(cfg).model, "cpu", seed=0,
                                    dtype=torch.float32), _remat(cfg),
                        "cpu")(images)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
