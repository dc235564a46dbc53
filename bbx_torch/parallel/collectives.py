"""The cross-rank reductions of data-parallel training.

bbx gets these from GSPMD: the update's gradient all-reduce, the global
batch statistics of BatchNorm and every metric's mean over the global
batch are compiled into its one program.  The port runs them by hand, on
the default group for device tensors and on the mesh's gloo group
(`Mesh.cpu_group`) for host values:

  * `all_reduce_sum` (differentiable: the backward all-reduces the
    gradient too, so BatchNorm's batch statistics over the global batch
    give the right input gradients), `all_reduce_max`;
  * `reduce_gradients`: the parameters' gradients summed over ranks in
    one flat buffer (each rank's loss is its sum over its rows divided
    by the global minibatch size, so the sum is the global gradient;
    DistributedDataParallel would average instead);
  * `agree`: a flag any rank raised, seen by all (the trainer's stop);
  * `gather_to_primary` / `broadcast_from_primary`: CPU values to rank 0
    (the checkpoint's fleet) and from it (the eval's numbers).

Every rank must call each of them in the same order.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks forward, and the gradient summed over ranks
    backward: with y = sum_r x_r seen by every rank, each rank's x_r
    receives the sum of every rank's dL/dy."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over ranks (a new tensor), differentiable."""
    return _AllReduceSum.apply(x)


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """`x`'s elementwise maximum over ranks (a new tensor)."""
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX)
    return y


def reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum every parameter's gradient over ranks, in place, through one
    all-reduce of a flat buffer (a missing gradient counts as zeros)."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset:offset + n].view_as(g)
        offset += n


def agree(*flags: bool, group=None) -> Tuple[bool, ...]:
    """Each flag, True on every rank if any rank passes it True (one max
    over ranks on the CPU)."""
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return tuple(bool(v) for v in t.tolist())


def gather_to_primary(tensors: Dict[str, torch.Tensor], group=None
                      ) -> Optional[Dict[str, torch.Tensor]]:
    """Each rank's batch-first `tensors`, copied to the CPU, concatenated
    along dim 0 in rank order on rank 0; None on the other ranks."""
    local = {k: v.detach().cpu() for k, v in tensors.items()}
    parts = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object(local, parts, dst=0, group=group)
    if parts is None:
        return None
    return {k: torch.cat([p[k] for p in parts]) for k in local}


def broadcast_from_primary(value: Any, group=None) -> Any:
    """Rank 0's `value` (a picklable host value) on every rank."""
    box = [value]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]
