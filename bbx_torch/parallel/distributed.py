"""Process groups and each rank's shard of the env fleet: counterpart of
`bbx/parallel/distributed.py`.

bbx forms its process group with `jax.distributed.initialize` and lets
GSPMD place a contiguous shard of the env fleet on each host.  Here
`torch.distributed` forms the group (`initialize_multihost`), each rank
owns the contiguous shard `host_env_slice` gives it, and the trainer
reduces across ranks by hand (`bbx_torch.parallel.collectives`).

The collective backend is named, never guessed: ``nccl`` by default for a
CUDA device, ``gloo`` for the CPU or when asked.  NCCL refuses two ranks
on one card, so under ``nccl`` each rank runs on ``cuda:<local rank>`` and
more ranks on a node than it has cards is an error; two ranks that share
one card run ``gloo``.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device="cuda",
    local_rank: Optional[int] = None,
    local_world_size: Optional[int] = None,
    timeout_s: Optional[float] = None,
) -> bool:
    """Form the process group when running several processes.

    Returns False (and forms nothing) in a single process: no coordinator
    and no process count, given or in the environment.  The arguments come
    explicitly or from the variables `torchrun` sets: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (the coordinator, ``host:port``), ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``.  `device` is this
    rank's device; it picks the default backend and, under ``nccl``, must
    be ``cuda:<local rank>``.  Returns True once the group exists.
    """
    if dist.is_initialized():
        return True
    # From the environment, `env://`: under torchrun the agent may already
    # serve the store at MASTER_PORT, which `env://` joins as a client.
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize_multihost needs the coordinator address, the number of "
            f"processes and this process's rank; got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"rank {process_id} outside a world of {num_processes}")
    local_rank = local_rank if local_rank is not None else _env_int("LOCAL_RANK")
    local_rank = process_id if local_rank is None else local_rank
    if local_world_size is None:
        local_world_size = _env_int("LOCAL_WORLD_SIZE") or num_processes
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl":
        _check_nccl(dev, local_rank, local_world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=timeout_s) if timeout_s else None)
    return True


def _check_nccl(dev: torch.device, local_rank: int, local_world_size: int) -> None:
    """Refuse what NCCL cannot run: a CPU device, more ranks on the node
    than cards, or a rank on another card than ``cuda:<local rank>``."""
    if dev.type != "cuda":
        raise ValueError(f"backend 'nccl' runs on CUDA devices, not {dev}; "
                         "use backend 'gloo' on the CPU")
    cards = torch.cuda.device_count()
    if local_world_size > cards:
        raise ValueError(
            f"backend 'nccl' runs one rank a card: {local_world_size} ranks on "
            f"this node and {cards} card(s); ranks that share a card need "
            "backend 'gloo'")
    if dev.index is not None and dev.index != local_rank:
        raise ValueError(
            f"backend 'nccl' runs one rank a card: local rank {local_rank} asked "
            f"for {dev}, not cuda:{local_rank}; ranks that share a card need "
            "backend 'gloo'")


def world_size() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns logging and checkpoint writes."""
    return rank() == 0


def global_env_count(per_rank_envs: int) -> int:
    return per_rank_envs * world_size()


def host_env_slice(num_envs_global: int) -> tuple[int, int]:
    """(start, count) of this rank's contiguous env shard.  A fleet the
    world size does not divide is refused (bbx's would drop the rest)."""
    w = world_size()
    if num_envs_global % w:
        raise ValueError(f"num_envs {num_envs_global} is not divisible by the "
                         f"world size {w}")
    per = num_envs_global // w
    return rank() * per, per
