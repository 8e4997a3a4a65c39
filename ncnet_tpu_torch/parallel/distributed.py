"""Process groups, the port of ``ncnet_tpu/parallel/distributed.py``.

JAX initialises ``jax.distributed`` once per process and then sees every
host's devices.  The port runs one process per GPU under
``torch.distributed`` (ROADMAP D7): ``torchrun --nproc_per_node=N`` sets
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, and :func:`initialize_distributed` joins the group they
describe — NCCL for CUDA, gloo only when the caller runs on the CPU.

Usage::

    from ncnet_tpu_torch.parallel import initialize_distributed, host_shard
    initialize_distributed()                   # from torchrun's environment
    loader = DataLoader(..., **host_shard())   # this rank's input shard
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Processes in the group; 1 without one."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if is_initialized() else 0


def env_world_size() -> int:
    """``WORLD_SIZE`` as torchrun sets it (1 when unset)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_device(device=None) -> torch.device:
    """This rank's device: ``device`` when it names one (the CPU, or a
    CUDA device by index), else the CUDA device of torchrun's
    ``LOCAL_RANK``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")
    return dev


def initialize_distributed(device=None, init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group (idempotent: a second call returns).

    With no arguments the group is torchrun's (``init_method='env://'``);
    ``init_method`` (``tcp://localhost:<port>``, ``file://<path>``),
    ``world_size`` and ``rank`` name another.  The backend is NCCL, or
    gloo when ``device`` is the CPU; a CUDA rank binds its device first
    (:func:`local_device`).  ``timeout_s`` bounds every collective, so a
    rank that never arrives fails the others instead of hanging them."""
    if is_initialized():
        return
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    if backend == "nccl":
        kwargs["device_id"] = dev
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)


def shutdown_distributed() -> None:
    """Leave the process group, if one was joined."""
    if is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every rank (nothing to wait for without a group)."""
    if world_size() > 1:
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (``obj`` itself without a group)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def global_any(flag: bool, device) -> bool:
    """``flag`` OR-ed over the ranks, through a one-element tensor on
    ``device`` (CUDA under NCCL); collective: every rank must call it at
    the same point."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def host_shard() -> Dict[str, int]:
    """This rank's slice of the input pipeline:
    ``DataLoader(..., **host_shard())`` gives each rank a disjoint shard of
    every (globally seeded, identically shuffled) epoch."""
    return {"num_shards": world_size(), "shard_index": rank()}
