"""Process groups, rank devices, batch sharding and state replication.

The port of ``x_detector_tpu/parallel/mesh.py``. JAX's 1-D ``Mesh("data")``
becomes a ``torch.distributed`` process group with one rank a device: NCCL
between cards, gloo on the CPU. Each rank binds ``cuda:<local rank>``
itself; asking for more cards than are visible raises, and nothing falls
back to the CPU.

Two ways in: ``run_ranks`` starts N ranks on this machine, each a fresh
process, over ``tcp://localhost:<free port>``; with ``XDET_MULTIHOST=1``
the process is one of torchrun's ranks and
:func:`maybe_initialize_distributed` joins the group from torchrun's
environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import socket
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

GROUP_TIMEOUT_S = 1800.0    # a collective that waits longer raises
FAILURE_GRACE_S = 10.0      # for the other ranks to end after one failed


class RanksFailed(RuntimeError):
    """Ranks of :func:`run_ranks` ended with non-zero exit codes:
    ``exit_codes`` maps each to its code."""

    def __init__(self, exit_codes: Dict[int, int], world: int):
        super().__init__(f"ranks {sorted(exit_codes)} of {world} failed "
                         f"(exit codes {exit_codes})")
        self.exit_codes = dict(exit_codes)


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def maybe_initialize_distributed(device_type: str) -> bool:
    """Join torchrun's group when ``XDET_MULTIHOST=1`` (a no-op otherwise,
    or when a group exists already); returns whether a group is up."""
    if os.environ.get("XDET_MULTIHOST", "0") == "1" and (
            not dist.is_initialized()):
        dist.init_process_group(backend_for(device_type),
                                init_method="env://")
    return dist.is_initialized()


def require_devices(device_type: str, count: int) -> None:
    """Raise unless ``count`` ranks can each have their own device: on CUDA
    that many visible cards."""
    if device_type != "cuda":
        return
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < count:
        raise RuntimeError(
            f"--num-devices {count} needs {count} CUDA devices, one a rank; "
            f"{visible} visible (pass --device cpu for gloo ranks on the CPU)")


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """This rank's device, bound as the current CUDA device on a card."""
    if device_type != "cuda":
        return torch.device(device_type)
    require_devices(device_type, local_rank + 1)
    torch.cuda.set_device(local_rank)
    return torch.device("cuda", local_rank)


def local_rank() -> int:
    """The rank's index on its machine: torchrun's ``LOCAL_RANK``, else
    the global rank (``run_ranks`` keeps every rank on one machine)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def init_group(backend: str, rank: int = 0, world: int = 1,
               init_method: Optional[str] = None,
               timeout_s: float = GROUP_TIMEOUT_S) -> None:
    """Join (or, as rank 0, open) a ``backend`` group of ``world`` ranks at
    ``init_method`` (default: a free port on this machine, for a group of
    one)."""
    dist.init_process_group(
        backend, init_method=init_method or f"tcp://localhost:{free_port()}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(fn: Callable, rank: int, world: int, backend: str,
                init_method: str, timeout_s: float, args: Sequence,
                result_pipe) -> None:
    init_group(backend, rank, world, init_method, timeout_s)
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        result_pipe.send(out)


def run_ranks(fn: Callable, world: int, backend: str, args: Sequence = (),
              timeout_s: float = GROUP_TIMEOUT_S):
    """``fn(rank, world, *args)`` on ``world`` ranks of a new ``backend``
    group on this machine, each in a spawned process (``fn``, ``args`` and
    rank 0's result must pickle). Returns rank 0's result. A rank that
    fails ends the others at once and raises here; so do ranks still
    running ``timeout_s`` after another ended (a collective waits at most
    ``timeout_s`` too); a failure raises :class:`RanksFailed`. Every
    process started has ended when it returns."""
    init = f"tcp://localhost:{free_port()}"
    ctx = multiprocessing.get_context("spawn")
    receive, send = ctx.Pipe(duplex=False)
    procs = {rank: ctx.Process(target=_rank_entry, daemon=True, args=(
        fn, rank, world, backend, init, timeout_s, tuple(args), send))
        for rank in range(world)}
    for p in procs.values():
        p.start()
    result, first_end = None, None
    try:
        running = dict(procs)
        while running:
            wait = (None if first_end is None
                    else max(0.0, first_end + timeout_s - time.monotonic()))
            ready = multiprocessing.connection.wait(
                [receive] + [p.sentinel for p in running.values()],
                timeout=wait)
            if receive in ready:     # read before rank 0 can block on send
                result = receive.recv()
            if any(p.exitcode not in (None, 0) for p in running.values()):
                # a rank whose peer died fails too, maybe before the peer's
                # process has ended: give them a moment, then name them all
                grace = time.monotonic() + FAILURE_GRACE_S
                for p in running.values():
                    p.join(max(0.0, grace - time.monotonic()))
                failed = {r: p.exitcode for r, p in running.items()
                          if p.exitcode not in (None, 0)}
                raise RanksFailed(failed, world)
            for rank, p in list(running.items()):
                if p.exitcode == 0:
                    del running[rank]
                    first_end = first_end or time.monotonic()
            if running and first_end is not None and (
                    time.monotonic() > first_end + timeout_s):
                raise TimeoutError(f"ranks {sorted(running)} did not end "
                                   f"within {timeout_s} s of another")
        return result
    finally:
        for p in procs.values():
            if p.is_alive():
                p.terminate()
            p.join()
        receive.close()
        send.close()


def shard_rows(n: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of ``n``: ``r * b : (r + 1) * b``, b = n /
    world."""
    if n % world:
        raise ValueError(f"a batch of {n} does not split over {world} ranks")
    b = n // world
    return slice(rank * b, (rank + 1) * b)


def shard_batch(batch: Dict, rank: int, world: int) -> Dict:
    """This rank's rows of every entry of a global batch (arrays, tensors
    or lists with the batch on the leading axis), as JAX's single-host
    ``shard_batch`` places them."""
    rows = shard_rows(len(next(iter(batch.values()))), rank, world)
    return {k: v[rows] for k, v in batch.items()}


def flat_collective_(tensors: List[torch.Tensor], collective) -> None:
    """``collective(flat)`` on one flattened copy of ``tensors`` per dtype,
    then the result back into ``tensors``, in place: one call a dtype,
    not one a tensor."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in ts])
            collective(flat)
            offset = 0
            for t in ts:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def broadcast_(tensors: List[torch.Tensor], src: int = 0, group=None
               ) -> None:
    """Rank ``src``'s values into ``tensors`` on every rank."""
    flat_collective_(tensors, lambda flat: dist.broadcast(flat, src,
                                                          group=group))


def replicate_state(state, group=None):
    """Rank 0's parameters, buffers, momentum buffers, EMA shadow and step
    on every rank (JAX's ``replicate_state``). Every rank must hold the
    same tensors by name (a state built from one config, restored from one
    checkpoint)."""
    model = state.model
    tensors = [p for p in model.parameters()]
    tensors += [b for _, b in sorted(model.state_dict(keep_vars=True).items())
                if not isinstance(b, torch.nn.Parameter)]
    for p in model.parameters():
        buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            tensors.append(buf)
    if state.ema_params is not None:
        tensors += [state.ema_params[n] for n in sorted(state.ema_params)]
    step = torch.tensor([state.step], dtype=torch.float64,
                        device=tensors[0].device)
    broadcast_(tensors + [step], group=group)
    state.step = int(step.item())
    return state
