"""Process groups, work sharding and the collectives of data parallelism.

Counterpart of icsg3d_tpu/parallel/distributed.py.  JAX drives its local
devices from one controller and joins hosts with ``jax.distributed``; the
port runs one process per card, started by ``python -m
torch.distributed.run`` (torchrun), and joins them in a torch.distributed
process group:

- ``initialize()``: ``init_process_group`` from torchrun's environment (or
  from the arguments); a no-op for a process that no launcher started, which
  then runs exactly as a single process always did.
- ``process_shard``: this process's stride of a host-side work list (the
  reference's MPI rank stride, create_matrices.py:107); writers stay
  disjoint by construction, no collectives.
- ``sync_hosts()``: a barrier (a one-element all-reduce), as in JAX.
- ``all_reduce_sum``: a differentiable all-reduce, whose backward is the
  all-reduce of the cotangents: BatchNorm's global moments use it, so each
  rank's gradient carries the other ranks' terms through them.
- ``reduce_gradients``: one all-reduce of every parameter's gradient in a
  flat buffer, divided by the world size: the global batch's gradient when
  every rank holds an equal shard of it.

Only ``all_reduce`` is used, so the collectives run on NCCL and on gloo,
whose CUDA tensors support nothing else (two ranks on one card share it
over gloo: NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable, List, Optional, Sequence, TypeVar

import torch
import torch.distributed as dist

T = TypeVar("T")

# Seconds a collective may wait for the other ranks before the run fails: a
# dead rank ends the run instead of hanging it.
DEFAULT_TIMEOUT_S = 600.0


def launched() -> bool:
    """Whether a launcher (torchrun) started this process: its environment
    names this process's rank and the world size."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def local_rank() -> Optional[int]:
    """This process's rank on its host under a launcher, else None."""
    return int(os.environ.get("LOCAL_RANK", "0")) if launched() else None


def default_backend() -> str:
    """NCCL where CUDA is available, else gloo."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: float = DEFAULT_TIMEOUT_S,
):
    """Join the process group; returns it (the default group), or None for
    a single process.

    Without arguments the rank, world size and rendezvous come from
    torchrun's environment; a process no launcher started stays a single
    process (None).  ``coordinator_address`` is ``host:port`` (TCP) or an
    init-method URL such as ``file:///path``; with it, ``num_processes``
    and ``process_id`` name the world size and this rank.  ``backend``
    None picks ``default_backend()``.  A second call returns the group the
    first one joined.
    """
    if dist.is_initialized():
        return dist.group.WORLD
    if num_processes is None and not launched():
        return None
    init_method = None  # env://: torchrun's MASTER_ADDR / MASTER_PORT
    if coordinator_address is not None:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend or default_backend(), init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        timeout=datetime.timedelta(seconds=timeout),
    )
    return dist.group.WORLD


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The default group's world size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def group_rank(group) -> int:
    """This process's rank in ``group``; 0 for None (a single process)."""
    return 0 if group is None else dist.get_rank(group)


def group_size(group) -> int:
    """The world size of ``group``; 1 for None (a single process)."""
    return 1 if group is None else dist.get_world_size(group)


def process_shard(items: Sequence[T]) -> List[T]:
    """This process's stride of a work list (i % process_count == index)."""
    pidx, pcount = process_index(), process_count()
    return [x for i, x in enumerate(items) if i % pcount == pidx]


def sync_hosts(group=None) -> None:
    """Block until every process of ``group`` (default: all) reaches this
    point; a no-op for a single process."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    one = torch.ones(1, device=dev)
    dist.all_reduce(one, group=group)
    one.item()  # waits for the collective (NCCL returns before it ends)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group``'s ranks, in place; returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum over the ranks.  Backward: the sum of the ranks'
    cotangents, the transpose of the forward (JAX's psum is its own
    transpose in the same way)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The differentiable sum of ``x`` over ``group``'s ranks."""
    return _AllReduceSum.apply(x, group)


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The differentiable mean of ``x`` over ``group``'s ranks."""
    return all_reduce_sum(x, group) / group_size(group)


def reduce_gradients(params: Iterable[torch.Tensor], group) -> None:
    """Replace each parameter's gradient by its mean over ``group``'s ranks:
    one all-reduce of a flat buffer of them all, then a division by the
    world size.  Every rank runs the same graph, so the same parameters
    have a gradient on every rank; those without one (None) stay None."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
    flat /= group_size(group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def mean_over_ranks(mets, group):
    """A dict of 0-d metric tensors (per-batch means) -> their means over
    ``group``'s ranks, in one all-reduce: the global batch's means when the
    ranks hold equal shards.  None (a single process) returns ``mets``."""
    if group is None:
        return mets
    keys = list(mets)
    flat = all_reduce_(torch.stack([mets[k].float() for k in keys]), group)
    return dict(zip(keys, (flat / group_size(group)).unbind(0)))
