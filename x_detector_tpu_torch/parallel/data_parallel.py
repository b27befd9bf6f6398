"""The data-parallel train step: each rank steps on its shard, then the
gradients, BatchNorm running stats and metrics are averaged over the ranks
and every rank applies the same update.

The port of ``x_detector_tpu/parallel/data_parallel.py`` (BASELINE config 5:
global batch 128). The math is JAX's, which is not SyncBatchNorm's: each
rank runs the single-device ``make_grad_fn`` on its rows, in
``cfg.train.grad_accum_steps`` microbatches, normalising with its own batch
statistics; then one ``pmean`` of the gradients, of the new running stats
and of the metrics; then ``apply_gradients`` (and the EMA shadow's update)
on every rank. That is the single-device step with ``grad_accum_steps``
multiplied by the rank count, and it gives the same bits where the rank
count is a power of two (sums of two values commute exactly; a power of
two divides exactly).

The average is an explicit all-reduce after the backward, over one
flattened buffer per dtype: not ``DistributedDataParallel``, whose
``broadcast_buffers`` copies rank 0's running stats instead of averaging
them and which would reduce once per microbatch under accumulation.
The Light-Head's RPN draws are the rank's own: the caller hands each rank a
generator seeded with the rank folded in (or the draws themselves).

The whole exchange (flatten, all-reduce, division, copy back) is the span
``xd/sync`` while the profiler records.
"""

from __future__ import annotations

from typing import Callable, List

import torch
import torch.distributed as dist

from x_detector_tpu_torch.models.layers import BatchNorm2D
from x_detector_tpu_torch.parallel import mesh
from x_detector_tpu_torch.train.trainer import Metrics, make_train_step
from x_detector_tpu_torch.utils import profiling


def all_reduce_mean_(tensors: List[torch.Tensor], group=None) -> None:
    """Average ``tensors`` in place over the group's ranks: one flattened
    buffer per dtype, one all-reduce (sum) each, then a division by the
    rank count. Each all-reduce adds one to ``all_reduce_mean_.calls`` and
    its buffer's length to ``all_reduce_mean_.elements``."""
    world = dist.get_world_size(group)

    def mean(flat: torch.Tensor) -> None:
        all_reduce_mean_.calls += 1
        all_reduce_mean_.elements += flat.numel()
        dist.all_reduce(flat, group=group)
        flat.div_(world)

    mesh.flat_collective_(tensors, mean)


all_reduce_mean_.calls = 0
all_reduce_mean_.elements = 0


def make_sync(model: torch.nn.Module,
              group=None) -> Callable[[Metrics], Metrics]:
    """sync(metrics) -> metrics: the rank-averaged gradients (in
    ``.grad``), BatchNorm running stats (in the model) and metrics, in one
    ``all_reduce_mean_``."""
    params = list(model.parameters())
    stats = [t for m in model.modules() if isinstance(m, BatchNorm2D)
             for t in (m.running_mean, m.running_var)]

    def sync(metrics: Metrics) -> Metrics:
        with profiling.span("sync"):
            names = sorted(metrics)
            values = torch.stack([metrics[k].float() for k in names])
            all_reduce_mean_([p.grad for p in params] + stats + [values],
                             group)
            return dict(zip(names, values.unbind()))

    return sync


def make_dp_train_step(model: torch.nn.Module, cfg, group=None):
    """train_step(state, batch, generator=None, priorities=None) -> (state,
    metrics), with ``make_train_step``'s arguments, where ``batch`` holds
    this rank's rows (``mesh.shard_batch``) and ``generator`` or
    ``priorities`` are this rank's draws. Every rank of ``group`` must call
    it with the same state; the states stay equal."""
    return make_train_step(model, cfg, sync=make_sync(model, group))
