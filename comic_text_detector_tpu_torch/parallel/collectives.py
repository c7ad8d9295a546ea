"""The collectives of the mesh's process group, as the losses, BatchNorm
and the train steps call them.

* :func:`all_reduce` (sum) and :func:`broadcast` are autograd functions:
  the backward of a sum over ranks is a sum of the gradients over ranks,
  so a loss whose statistics pass through them backpropagates to every
  rank's inputs.  Only these two collectives are used: gloo runs both on
  CUDA tensors as well as on CPU ones, and NCCL runs both.
* Without a group (``None``) every function here returns its input
  unchanged, so a one-process caller computes what it did before.

The mesh and the launcher are in ``parallel/mesh.py``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, group):
        ctx.src, ctx.group = src, group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.broadcast(y, dist.get_global_rank(group, src), group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        if dist.get_rank(ctx.group) != ctx.src:
            g.zero_()
        return g, None, None


def group_size(group) -> int:
    """The number of ranks in ``group`` (1 without one)."""
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks (``x`` itself without a
    group); its gradient is the sum of the ranks' gradients."""
    return x if group is None else _AllReduce.apply(x, group)


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (``x`` itself without a group);
    rank ``src`` takes the sum of the ranks' gradients, the others none."""
    return x if group is None else _Broadcast.apply(x, src, group)


def sum_shares(shares: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The sums over the group's ranks of each rank's scalar ``shares``
    (one all-reduce), each carrying the gradient of this rank's own share
    only: the value the global-batch function reports, and the term this
    rank backpropagates.  Without a group, ``shares`` unchanged."""
    if group is None:
        return list(shares)
    total = all_reduce(torch.stack([s.detach() for s in shares]), group)
    return [total[i] + (s - s.detach()) for i, s in enumerate(shares)]


@torch.no_grad()
def sum_grads(params: Sequence[torch.Tensor], group) -> None:
    """Sum the parameters' ``.grad`` over the group's ranks, in place: one
    flat buffer, one all-reduce.  Parameters without a gradient keep none
    (the ranks run the same graph, so they are the same on every rank)."""
    grads = [p.grad for p in params if p.grad is not None]
    if group is None or not grads:
        return
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))
