"""Start one process a rank.

Port of ``paddle_tpu/distributed/spawn.py``: ``spawn(func, args,
nprocs)`` starts ``nprocs`` fresh interpreters (the ``spawn`` start
method: no forked copy of the parent's threads), gives each the
environment :func:`.parallel_env.init_parallel_env` reads, runs
``func(*args)`` in each and waits for all of them. A child that raises
or dies makes ``spawn`` raise in the parent (and the other children are
stopped). Rank r is ``LOCAL_RANK`` r: on CUDA it takes card r.
"""
from __future__ import annotations

import os
import socket

import torch
import torch.multiprocessing as mp

__all__ = ["spawn"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, func, nprocs, port, args):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(nprocs), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    try:
        func(*args)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def spawn(func, args=(), nprocs: int = -1, join: bool = True,
          daemon: bool = False):
    """Run ``func(*args)`` in ``nprocs`` processes (-1: one a visible
    card). ``func`` must be importable by name (a module-level function).
    With ``join`` (the default) returns once all have exited and raises
    if any failed; else returns the process context."""
    if nprocs == -1:
        nprocs = torch.cuda.device_count()
    if nprocs < 1:
        raise ValueError("spawn needs nprocs >= 1, got %d" % nprocs)
    return mp.start_processes(_worker, args=(func, nprocs, _free_port(), args),
                              nprocs=nprocs, join=join, daemon=daemon,
                              start_method="spawn")
