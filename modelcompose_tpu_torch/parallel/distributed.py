"""Multi-process initialization (counterpart of
modelcompose_tpu/parallel/distributed.py).

The JAX package calls ``jax.distributed.initialize`` once per host; the
port calls ``torch.distributed.init_process_group``, one process per GPU:
NCCL between cards, gloo on the CPU.  Under ``torchrun`` every argument
comes from the environment it sets (``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``)::

    torchrun --nproc-per-node 4 -m modelcompose_tpu_torch.serve.model_worker \\
        --tp 4 ...

Without an initialized group the port runs as one process of world 1:
the single-process case, not a fallback.  An explicit ``initialize`` that
fails raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def _init_method(coordinator_address: Optional[str]) -> str:
    """A URL for ``init_process_group``: ``host:port`` as JAX takes it
    becomes ``tcp://host:port``; a URL (``tcp://``, ``file://``) is kept;
    None reads ``MASTER_ADDR``/``MASTER_PORT``."""
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if not (addr and port):
            raise ValueError(
                "no coordinator address: pass coordinator_address or run "
                "under torchrun (MASTER_ADDR and MASTER_PORT)")
        return f"tcp://{addr}:{port}"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def _env_int(name: str, given: Optional[int]) -> int:
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise ValueError(f"{name} is not set: pass it explicitly or run "
                         "under torchrun")
    return int(os.environ[name])


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the process group.  Each argument left None comes from the
    environment torchrun sets.  ``backend`` None follows the device: NCCL
    where CUDA is available, gloo on the CPU.

    Under NCCL the process takes the card ``LOCAL_RANK`` (else its rank
    modulo the cards) as its current device, and the group is bound to it
    (``device_id``), so the world's communicator is made here, eagerly:
    NCCL otherwise makes a group's communicator at its first collective,
    which a CUDA graph capture refuses.  ``parallel.mesh.make_mesh`` makes
    the communicators of the groups it creates the same way (``warm``).

    ``timeout`` bounds every collective run eagerly, so a rank that skips
    one fails instead of hanging the group.  A collective replayed from a
    captured graph (a decode, prefill or train step under a group) is not
    watched by ``ProcessGroupNCCL``'s watchdog: a rank that stops hangs
    the others' replay.  Under ``--tp`` the leader's broadcast of each
    call's header (``parallel/serving``) stays eager, before every replay,
    so a lost follower still fails there, within ``timeout``."""
    init_method = _init_method(coordinator_address)
    world = _env_int("WORLD_SIZE", num_processes)
    rank = _env_int("RANK", process_id)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=timeout,
                            **kw)


def warm(group) -> None:
    """One collective over ``group`` (every rank of it calls this), on the
    current card under NCCL: its communicator exists from here on, before
    any capture runs a collective of the group."""
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else torch.device("cpu")
    dist.all_reduce(torch.zeros(1, device=device), group=group)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Processes in the group; 1 without one."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    """True on process 0 (checkpoint writes, logging)."""
    return rank() == 0


def local_batch_slice(global_batch: int, index: Optional[int] = None,
                      count: Optional[int] = None) -> slice:
    """This process's contiguous shard of a globally-sharded batch: the JAX
    arithmetic over (``index``, ``count``), by default this process's rank
    and the world size (a data-parallel rank and width where a mesh has a
    model axis)."""
    index = rank() if index is None else index
    count = world_size() if count is None else count
    per = global_batch // count
    start = index * per
    return slice(start, start + per)


def barrier(group=None) -> None:
    """Wait for every rank of ``group`` (the world by default); nothing
    without a process group."""
    if is_initialized():
        dist.barrier(group=group)


def shutdown() -> None:
    """Leave the process group (idempotent)."""
    if is_initialized():
        dist.destroy_process_group()
