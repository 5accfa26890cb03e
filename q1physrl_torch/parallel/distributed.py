"""Process groups and the collectives of data-parallel training.

One process per rank, joined by ``torch.distributed``: every rank runs the
same program on its own slice of the env batch, and the ranks meet only in
the collectives below.  Under torchrun:

    torchrun --standalone --nproc_per_node=W -m q1physrl_torch.algo.train <run.yml>

each rank calls :func:`initialize` with the variables torchrun sets
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).  In a single
process with none of them set, :func:`initialize` does nothing, and every
collective here is the identity: a sum over one rank.

Only ``all_reduce`` and ``broadcast`` touch device tensors, as those are
the only collectives the gloo backend runs on CUDA tensors; the env-axis
gather is an all-reduce of a zeroed buffer into which each rank writes its
slice.  So one code path runs NCCL across cards and gloo with several ranks
on one card (NCCL refuses two ranks on one card).  The backend is chosen
by the caller: ``nccl`` for CUDA, ``gloo`` for the CPU or when asked.

Each collective counts its calls in :data:`counters`; with
:func:`time_collectives` on, it also adds its host seconds, between a
synchronization of the card before and after it.
"""

from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist

__all__ = ("initialize", "shutdown", "is_initialized", "is_multi_process",
           "process_info", "rank", "world_size", "local_rank",
           "all_reduce_sum", "all_reduce_max", "all_reduce_mean",
           "broadcast", "gather_env_axis", "barrier", "counters",
           "time_collectives", "DEFAULT_TIMEOUT")

# A hung or dead rank fails the others' next collective after this long.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)

counters = {"calls": 0, "seconds": 0.0}
_timing = {"on": False}


def initialize(backend=None, init_method=None, world_size=None, rank=None,
               timeout=DEFAULT_TIMEOUT):
    """Join the process group (a no-op when already joined).

    With no arguments and no ``RANK``/``WORLD_SIZE`` in the environment this
    is a single process, and nothing happens.  With explicit arguments, or
    under torchrun, errors propagate.  ``backend``: ``nccl`` or ``gloo``;
    None takes ``nccl`` where a card is visible and ``gloo`` elsewhere.
    ``timeout``: a ``datetime.timedelta``, or seconds.
    """
    if dist.is_initialized():
        return
    explicit = init_method is not None or world_size is not None
    if not explicit and "RANK" not in os.environ \
            and "WORLD_SIZE" not in os.environ:
        return  # a single process: run locally
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if not isinstance(timeout, datetime.timedelta):
        timeout = datetime.timedelta(seconds=timeout)
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(backend=backend, init_method=init_method or
                            "env://", timeout=timeout, **kwargs)


def shutdown():
    if dist.is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_initialized()


def is_multi_process() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank()))


def process_info() -> dict:
    return {"rank": rank(), "world_size": world_size(),
            "local_rank": local_rank(),
            "backend": dist.get_backend() if dist.is_initialized() else None}


def time_collectives(on: bool = True):
    """Add each collective's host seconds to ``counters["seconds"]``, with a
    synchronization of the card before and after it (off by default: the
    synchronizations cost the overlap of host and card)."""
    _timing["on"] = on


def _sync(x):
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def _collective(fn, x):
    counters["calls"] += 1
    if not _timing["on"]:
        fn(x)
        return x
    _sync(x)
    t0 = time.perf_counter()
    fn(x)
    _sync(x)
    counters["seconds"] += time.perf_counter() - t0
    return x


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ranks, in a new tensor (``x`` itself in a
    single process)."""
    if not dist.is_initialized():
        return x
    return _collective(dist.all_reduce, x.clone())


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    if not dist.is_initialized():
        return x
    return _collective(lambda y: dist.all_reduce(y, op=dist.ReduceOp.MAX),
                       x.clone())


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks divided by the world size."""
    return all_reduce_sum(x) / world_size()


def broadcast(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank, written into ``x``."""
    if not dist.is_initialized():
        return x
    return _collective(lambda y: dist.broadcast(y, src), x)


def gather_env_axis(x: torch.Tensor, shard, dim: int = -1) -> torch.Tensor:
    """Every rank's slice of the env axis ``dim`` joined into the global
    tensor, on every rank: an all-reduce of a zeroed buffer holding this
    rank's slice (``shard``: a :class:`mesh.EnvShard`).  Exact: each element
    is a sum of one value and zeros."""
    if x.dtype == torch.bool:  # summed as bytes: gloo sums no bools
        return gather_env_axis(x.to(torch.uint8), shard, dim).bool()
    dim = dim % x.dim()
    if x.shape[dim] != shard.local:
        raise ValueError(f"axis {dim} holds {x.shape[dim]} envs, the shard "
                         f"{shard.local}")
    shape = list(x.shape)
    shape[dim] = shard.total
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(dim, shard.start, shard.local).copy_(x)
    if not dist.is_initialized():
        return out
    return _collective(dist.all_reduce, out)


def barrier(device="cpu"):
    """Wait for every rank: an all-reduce of one element on ``device``."""
    if dist.is_initialized():
        # NCCL only enqueues the all-reduce; the host waits for it here.
        _sync(_collective(dist.all_reduce, torch.zeros(1, device=device)))
