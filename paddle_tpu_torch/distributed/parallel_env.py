"""The rank environment of a multi-process run.

Port of ``paddle_tpu/distributed/parallel_env.py`` (``get_rank``,
``get_world_size``, ``init_parallel_env``). The JAX package drives every
device from one controller; the port runs one process a rank, each on
its own device, and joins them with ``torch.distributed``: NCCL between
cards, gloo between CPU processes.

:func:`init_parallel_env` reads the launcher's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as
:func:`.spawn.spawn` and ``torchrun`` set them). A CUDA rank takes card
``LOCAL_RANK`` and raises when the host has no such card; it never moves
to the CPU on its own.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

__all__ = ["init_parallel_env", "get_rank", "get_world_size"]

_device: Optional[torch.device] = None


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def init_parallel_env(device: DeviceLike = None,
                      backend: Optional[str] = None,
                      timeout: Optional[float] = None) -> torch.device:
    """Join the process group of this run and return this rank's device.

    ``device`` is ``"cuda"`` (the default: card ``LOCAL_RANK``, NCCL) or
    ``"cpu"`` (gloo). ``timeout`` (seconds; torch's default when None)
    bounds how long a collective waits for the other ranks. A second
    call returns the device of the first."""
    global _device
    if _device is not None:
        return _device
    dev = resolve_device(device)
    local = _env_int("LOCAL_RANK", _env_int("RANK", 0))
    if dev.type == "cuda":
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                "rank with LOCAL_RANK %d needs card %d; this host has %d"
                % (local, local, torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = os.environ.get("MASTER_PORT", "29500")
        # a CUDA rank names its card: NCCL then need not guess it
        dist.init_process_group(
            backend, init_method="tcp://%s:%s" % (addr, port),
            rank=_env_int("RANK", 0), world_size=_env_int("WORLD_SIZE", 1),
            **({"device_id": dev} if dev.type == "cuda" else {}),
            **({} if timeout is None else
               {"timeout": datetime.timedelta(seconds=timeout)}))
    _device = dev
    return dev


def get_rank(group=None) -> int:
    """This process's rank (in ``group`` when given); 0 before
    :func:`init_parallel_env`."""
    if not dist.is_initialized():
        return _env_int("RANK", 0)
    return dist.get_rank(group)


def get_world_size(group=None) -> int:
    """The number of ranks (in ``group`` when given); 1 before
    :func:`init_parallel_env`."""
    if not dist.is_initialized():
        return _env_int("WORLD_SIZE", 1)
    return dist.get_world_size(group)
