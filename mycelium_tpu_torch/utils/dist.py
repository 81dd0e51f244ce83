"""Multi-process runs and coordinator-only IO (port of
``mycelium_tpu/utils/dist.py``).

One process a rank, joined by ``torch.distributed``: NCCL between cards,
gloo between CPU processes. Rank r runs on ``cuda:LOCAL_RANK``. The
defaults are the variables ``torchrun`` sets (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``); a caller may
pass its own rendezvous (``init_method``, for example ``file://`` or
``tcp://localhost:<port>``), world size and rank instead.

Exactly one process writes result files: every writer of the port's
drivers and CLI is behind ``is_coordinator()`` (rank 0). Without a process
group every guard passes: rank 0 of 1, and the barrier does nothing.

No fallback: a failed NCCL initialisation is an error, never a switch to
gloo or to the CPU; a rank with no card raises unless the caller asked
for the CPU.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from ..devices import DEFAULT_DEVICE, resolve


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None else int(v)


def rank_device(device=DEFAULT_DEVICE) -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK`` for a CUDA run (raises
    without a card), the CPU when the caller asked for it."""
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _env_int("LOCAL_RANK") or 0)
    return dev


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=DEFAULT_DEVICE) -> torch.device:
    """Join this process to the run's process group and return its device.

    Call it before the first tensor is made. ``backend`` defaults to NCCL
    for a CUDA run and gloo for ``device="cpu"``; ``init_method`` to
    ``env://`` (``MASTER_ADDR``/``MASTER_PORT``), ``world_size`` and
    ``rank`` to ``WORLD_SIZE`` and ``RANK``."""
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if world_size is None:
        world_size = _env_int("WORLD_SIZE")
    if rank is None:
        rank = _env_int("RANK")
    kw = {}
    if dev.type == "cuda" and backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank, **kw)
    return dev


def initialize_single(device=DEFAULT_DEVICE) -> torch.device:
    """A process group of this process alone (world size 1, a ``file://``
    store in a fresh temporary directory: no port is opened), for a
    sharded solve in a run that was not launched over several ranks."""
    store = os.path.join(tempfile.mkdtemp(prefix="myc_pg_"), "store")
    return initialize_distributed(f"file://{store}", 1, 0, device=device)


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True exactly on the process that writes result files (rank 0)."""
    return process_index() == 0


def coordinator_barrier(name: str = "io") -> None:
    """Block until every rank arrives (for example before the ranks read
    what the coordinator wrote). Does nothing in a single process.
    ``name`` labels the barrier, as in the JAX package; torch's barriers
    take no label."""
    if process_count() > 1:
        dist.barrier()
