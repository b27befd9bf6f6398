"""Child process of ``tests/test_torch_multihost.py`` (not a pytest module).

One of torchrun's ranks (``python -m torch.distributed.run --standalone
--nproc-per-node N`` with ``XDET_MULTIHOST=1``): it joins the gloo group
through ``mesh.maybe_initialize_distributed("cpu")`` (``env://``), takes
the weights and the global batch that the test saved, feeds only its local
rows (``mesh.shard_rows``) to ONE data-parallel train step, prints the
(rank-averaged) loss and saves its train state.

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        tests/_torch_multihost_child.py WORK_DIR
"""

import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from x_detector_tpu_torch.config import DataConfig, ssd_resnet50  # noqa: E402


def small_ssd_cfg(batch_size: int = 2):
    """The JAX tests' ``small_ssd_cfg`` (``tests/test_train.py``) in the
    port's config classes, at a global batch of ``batch_size``."""
    base = ssd_resnet50(image_size=64)
    return dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, backbone_stages=(1, 1, 1, 1),
                                  backbone_widths=(16, 32, 48, 64)),
        data=DataConfig(image_size=64, max_gt_boxes=8),
        train=dataclasses.replace(base.train, batch_size=batch_size,
                                  learning_rate=5e-3, warmup_steps=0,
                                  weight_decay=0.0))


def main(work: str) -> None:
    import torch.distributed as dist

    from x_detector_tpu_torch.inference import build_model
    from x_detector_tpu_torch.parallel import mesh
    from x_detector_tpu_torch.parallel.data_parallel import (
        make_dp_train_step)
    from x_detector_tpu_torch.train.schedule import make_optimizer
    from x_detector_tpu_torch.train.train_state import (TrainState,
                                                        train_snapshot)

    torch.set_num_threads(1)
    if not mesh.maybe_initialize_distributed("cpu"):
        raise SystemExit("not one of torchrun's ranks with XDET_MULTIHOST=1")
    rank, world = dist.get_rank(), dist.get_world_size()
    setup = torch.load(os.path.join(work, "setup.pt"), weights_only=True)
    cfg = small_ssd_cfg(len(setup["batch"]["image"]))
    model = build_model(cfg.model, "cpu", seed=None,
                        dtype=torch.float32).train()
    model.load_state_dict(setup["weights"])
    optimizer, schedule = make_optimizer(model, cfg.train)
    state = mesh.replicate_state(TrainState.create(
        model, optimizer, schedule, ema_decay=cfg.train.ema_decay))
    step = make_dp_train_step(model, cfg)
    rows = mesh.shard_rows(cfg.train.batch_size, rank, world)
    state, metrics = step(state, {k: v[rows]
                                  for k, v in setup["batch"].items()})
    loss = metrics["total_loss"].item()
    print(f"MULTIHOST_LOSS {rank} {loss!r}", flush=True)
    torch.save({"snapshot": train_snapshot(state), "loss": loss},
               os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
