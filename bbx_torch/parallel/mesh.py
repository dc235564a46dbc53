"""The data-parallel layout of a run: counterpart of `bbx/parallel/mesh.py`.

bbx builds a `jax.sharding.Mesh` with a ``data`` axis and a ``model`` axis
kept at size 1 (the network is replicated), shards the env fleet and the
rollout over ``data`` and lets GSPMD insert the gradient all-reduce and the
cross-replica BatchNorm.  Here the ``data`` axis is the ranks of the
process group, one process a device:

  * `Mesh` records the world size, this rank, its device and the
    backend; `make_mesh` checks a config's ``mesh:`` section against the
    group (``num_data`` null or the world size, ``num_model`` 1);
  * `shard_batched_tree` keeps this rank's rows of batch-first tensors,
    and `replicate_tree` broadcasts tensors from rank 0;
  * `BatchShard` names this rank's rows of a batch that every rank draws
    at its global size, so that random draws and batch statistics follow
    the global batch (`bbx_torch.parallel.collectives`).

bbx's `batch_spec_tree` and `replicated_spec_tree` build JAX
`PartitionSpec`s, annotations that GSPMD compiles into placement; eager
PyTorch has no partitioner to read them, so they have no counterpart: the
code that would carry a spec slices (`shard_batched_tree`) or broadcasts
(`replicate_tree`) itself.
"""
from __future__ import annotations

import socket
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import torch
import torch.distributed as dist

from ..device import resolve_device
from .distributed import host_env_slice, rank, world_size

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """`world_size` ranks along the data axis (the model axis is 1), this
    process's `rank` and `device`, the group's `backend` (None in one
    process) and the gloo group that checkpoint gathers use
    (`cpu_group`: the default group under gloo, its own under nccl)."""

    world_size: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    cpu_group: Any = None

    @property
    def distributed(self) -> bool:
        return self.world_size > 1

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.world_size, MODEL_AXIS: 1}

    def num_devices(self) -> int:
        """The distinct devices the ranks run on (ranks that share a card
        count it once); collective in a group."""
        if not self.distributed:
            return 1
        if self.device.type == "cuda":
            props = torch.cuda.get_device_properties(self.device)
            mine = (socket.gethostname(), str(getattr(props, "uuid", self.device)))
        else:
            mine = (socket.gethostname(), str(self.device))
        every = [None] * self.world_size
        dist.all_gather_object(every, mine, group=self.cpu_group)
        return len(set(every))


def make_mesh(num_data: Optional[int] = None, num_model: int = 1,
              device="cuda") -> Mesh:
    """The mesh of the current process group on `device`.

    `num_data` may be None (every rank) or the world size; `num_model` must
    be 1, since the network is replicated as bbx keeps it.  In a group the
    call is collective (under nccl it forms the gloo group for gathers).
    """
    w = world_size()
    if num_model != 1:
        raise ValueError(f"mesh.num_model = {num_model}: the network is "
                         "replicated, so the model axis must be 1")
    if num_data is not None and num_data != w:
        raise ValueError(f"mesh.num_data = {num_data} but the process group "
                         f"has {w} rank(s); use null or {w}")
    dev = resolve_device(device)
    if not dist.is_initialized():
        return Mesh(1, 0, dev)
    backend = dist.get_backend()
    cpu_group = dist.new_group(backend="gloo") if backend != "gloo" else dist.group.WORLD
    return Mesh(w, rank(), dev, backend, cpu_group)


def mesh_from_config(config: Dict[str, Any], device="cuda") -> Mesh:
    """`make_mesh` from a config's ``mesh:`` section."""
    m = config.get("mesh", {}) or {}
    return make_mesh(num_data=m.get("num_data"),
                     num_model=m.get("num_model", 1) or 1, device=device)


@dataclass(frozen=True)
class BatchShard:
    """This rank's `rows` (a slice or an index tensor) of a batch of
    `total` rows that every rank draws at its global size."""

    total: int
    rows: Union[slice, torch.Tensor]

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of `x`, a tensor of the global batch."""
        return x[self.rows]


def shard_batched_tree(tree: Dict[str, torch.Tensor], num_global: int
                       ) -> Dict[str, torch.Tensor]:
    """This rank's contiguous rows (`host_env_slice`) of every batch-first
    tensor of `tree`, each of `num_global` rows."""
    start, count = host_env_slice(num_global)
    return {k: v[start:start + count] for k, v in tree.items()}


def replicate_tree(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every tensor of `tree` made equal to rank 0's, in place (nothing to
    do in one process)."""
    if world_size() > 1:
        for v in tree.values():
            dist.broadcast(v, src=0)
    return tree
