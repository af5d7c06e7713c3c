"""A ring of devices driven by one process.

The counterpart of a one-axis ``Mesh`` with ``axis_index`` and a
``ppermute`` around it, as the JAX package's ``shard_map`` bodies use
them (``fusion/overlap_mm.py``, ``distributed/pipeline/schedule.py``):
one controller holds one ``torch.device`` per rank and enqueues every
rank's work itself. Rank r's kernel stores into rank r+1's buffer
through a peer pointer, the counterpart of ``make_async_remote_copy`` to
a logical device id.

A device may repeat: ``Ring(["cpu"] * 4)`` runs the plain versions on
the host, and ``Ring(["cuda:0"] * 2)`` puts two ranks on one card, where
the "remote" store is a store into another buffer of the same card (the
same kernel and the same code path). The ring never picks a placement:
the caller names the devices.

**Peer access.** For every pair of distinct CUDA neighbours the ring
checks ``torch.cuda.can_device_access_peer`` both ways and enables peer
access from each side through the kernel library; a pair without peer
access raises (there is no detour through the host). A shift by another
step enables its pair on first use (:meth:`link`).

**Ordering across cards** (:meth:`before_writes` / :meth:`after_writes`).
A ring step writes, from rank r's current stream, into a receive buffer
that the caller allocated on the target rank's card under that card's
current stream:

* the writer's stream first waits on an event recorded on the target's
  stream after the allocation: the caching allocator may hand out memory
  whose last reads are still queued on the target's stream;
* the target's stream then waits on an event recorded on the writer's
  stream after the kernel, before anything of the target's reads the
  buffer.

Every step writes into a fresh buffer, so a writer never overwrites a
buffer that its reader is still reading, and the buffer it writes never
aliases the one being read, even when two ranks share a card. No
``record_stream`` is needed: the allocator knows only the target's stream,
and every later use of the buffer's memory on that stream comes after
the wait on the writer's event, so the memory cannot be reused before the
write has landed. On one card all ranks share one stream and the waits
are skipped.
"""
from __future__ import annotations

from typing import List, Sequence, Set, Tuple, Union

import torch

__all__ = ["Ring"]

DeviceLike = Union[str, torch.device]


def _device(d: DeviceLike) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Ring:
    """``Ring(devices)``: rank r runs on ``devices[r]``."""

    def __init__(self, devices: Sequence[DeviceLike]):
        devs = [_device(d) for d in devices]
        if not devs:
            raise ValueError("a ring needs at least one device")
        kinds = {d.type for d in devs}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError("a ring's devices are all 'cpu' or all 'cuda', "
                             "got %s" % [str(d) for d in devs])
        self._devices: List[torch.device] = devs
        self._linked: Set[Tuple[int, int]] = set()
        for r in range(self.size):
            nxt = (r + 1) % self.size
            self.link(r, nxt)
            self.link(nxt, r)

    @property
    def size(self) -> int:
        return len(self._devices)

    @property
    def devices(self) -> List[torch.device]:
        return list(self._devices)

    def device(self, r: int) -> torch.device:
        return self._devices[r % self.size]

    def __repr__(self) -> str:
        return "Ring(%s)" % [str(d) for d in self._devices]

    def link(self, src: int, dst: int) -> None:
        """Let rank ``src``'s kernels store into rank ``dst``'s memory:
        enable peer access from ``src``'s card to ``dst``'s when they are
        distinct CUDA devices; raises when the cards have no peer access."""
        a, b = self.device(src), self.device(dst)
        if a.type != "cuda" or a == b or (a.index, b.index) in self._linked:
            return
        if not torch.cuda.can_device_access_peer(a, b):
            raise RuntimeError(
                "%s has no peer access to %s: a ring step stores into its "
                "neighbour's memory, so ring neighbours need peer access "
                "(put the ranks on cards that have it, or on one card)"
                % (a, b))
        from ..incubate.nn.cuda import ring as kring

        kring.enable_peer(a.index, b.index)
        self._linked.add((a.index, b.index))

    def stream(self, r: int) -> torch.cuda.Stream:
        return torch.cuda.current_stream(self.device(r))

    def _wait(self, waiter: int, signaller: int) -> None:
        ws, ss = self.stream(waiter), self.stream(signaller)
        if ws == ss:
            return
        ev = torch.cuda.Event()
        ev.record(ss)
        ws.wait_event(ev)

    def before_writes(self, step: int) -> None:
        """Before rank r stores into rank r+step's fresh receive buffer:
        r's stream waits on the target's stream (see the module note)."""
        if self.device(0).type == "cuda":
            for r in range(self.size):
                self._wait(r, r + step)

    def after_writes(self, step: int) -> None:
        """After rank r's store into rank r+step's buffer: the target's
        stream waits on r's stream before it reads the buffer."""
        if self.device(0).type == "cuda":
            for r in range(self.size):
                self._wait(r + step, r)

    def shift_ref(self, tensors: Sequence[torch.Tensor],
                  step: int = 1) -> List[torch.Tensor]:
        """The plain ring shift on any device: rank r's tensor copied to
        rank (r + step) % size (``Tensor.to``, always a new tensor)."""
        if len(tensors) != self.size:
            raise ValueError("%d tensors for a ring of %d"
                             % (len(tensors), self.size))
        out: List[torch.Tensor] = [None] * self.size  # type: ignore
        for r, t in enumerate(tensors):
            dst = (r + step) % self.size
            out[dst] = t.to(self.device(dst), copy=True)
        return out
