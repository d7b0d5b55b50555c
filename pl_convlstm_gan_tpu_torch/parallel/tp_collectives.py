"""The two collectives of a channel-sharded ConvLSTM cell, as autograd
Functions over the model group (Megatron's ``gather_from_model_parallel_
region`` and ``copy_to_model_parallel_region``).

- ``gather_h``: the forward all-gathers the ranks' h shards [..., Ch/n]
  into the full h [..., Ch] (channels last, in rank order); the backward
  takes this rank's slice of the incoming gradient, with no sum. The full h
  feeds three consumers, whose gradients all arrive complete and equal on
  every rank: the next cell's and this cell's next conv (through
  ``copy_in``), and the replicated head (directly, and through the decode
  feedback). ``torch.distributed.nn.functional.all_gather`` sums in its
  backward, which would count each of them n times.
- ``copy_in``: the identity forward; the backward sums the gradient over
  the model group. It wraps the replicated input ``concat(x, h_full)`` of
  each column-parallel conv, whose rank computes only its 4*Ch/n output
  channels and so only a partial gradient of that input.

One all-gather per cell and step in the forward, at most one all-reduce per
cell and step in the backward; ``gather_h.calls`` and ``copy_in.calls``
count them (the forward gathers and the backward all-reduces issued).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils import profiling

profiling.declare("gather_h.calls", "copy_in.calls")


class _GatherH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h: torch.Tensor, group):
        ctx.group = group
        n = dist.get_world_size(group)
        out = torch.empty((n * h.shape[0],) + tuple(h.shape[1:]),
                          dtype=h.dtype, device=h.device)
        dist.all_gather_into_tensor(out, h.contiguous(), group=group)
        profiling.count("gather_h.calls")
        # [n, ..., Ch/n] -> [..., n * Ch/n]: rank r's channels at block r
        return out.view(n, *h.shape).movedim(0, -2).reshape(
            *h.shape[:-1], n * h.shape[-1])

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        n = dist.get_world_size(ctx.group)
        rank = dist.get_rank(ctx.group)
        per = grad.shape[-1] // n
        return grad[..., rank * per:(rank + 1) * per].contiguous(), None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        profiling.count("copy_in.calls")
        return grad, None


def gather_h(h: torch.Tensor, group) -> torch.Tensor:
    """The full h [..., Ch] from this rank's shard [..., Ch/n] (see the
    module docstring for the backward)."""
    return _GatherH.apply(h, group)


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``group`` in the
    backward."""
    return _CopyIn.apply(x, group)
