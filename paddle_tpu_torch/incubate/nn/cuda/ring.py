"""Ring steps across a :class:`~paddle_tpu_torch.distributed.Ring`: K9 and
K10.

Port of the two remote-copy kernels of the JAX package:
``paddle_tpu/fusion/overlap_mm.py`` ``_pallas_mm_step`` (K9: one TP ring
step, the copy of ``buf`` to the next rank overlapped with ``buf @ w``)
and ``paddle_tpu/distributed/pipeline/transport.py``
``_pallas_shift_impl`` (K10: a ring shift by ``step``). :func:`mm_step`
and :func:`shift` launch the hand-written Hopper kernels of
``csrc/ring.cu``, one launch per rank on that rank's card, and take CUDA
tensors only; :func:`mm_step_ref` and ``Ring.shift_ref`` are the plain
PyTorch versions (the JAX ``_ppermute_step`` plus ``_chunked_rows_mm(buf,
w, 1)``, and the JAX ``ppermute``) and run on any device. The functional
layers that pick one or the other, and carry the gradient, are
``fusion/overlap_mm.py`` and ``distributed/pipeline/transport.py``.

Each rank's receive buffer is a fresh allocation on the target rank's
card; :meth:`Ring.before_writes` / :meth:`Ring.after_writes` order the
streams around the launches (see ``distributed/ring.py``).
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from . import _build

__all__ = ["mm_step", "mm_step_ref", "mm_step_plan", "shift",
           "enable_peer", "check_kernel_inputs"]

_KERNEL = "ring"
_MAX_INT = 2 ** 31 - 1


def _check_tensor(name: str, t: torch.Tensor, dev: torch.device) -> None:
    if t.device.type != "cuda":
        raise ValueError("the ring kernels take CUDA tensors, got %s on %s "
                         "(the plain versions serve the CPU)"
                         % (name, t.device))
    if t.device != dev:
        raise ValueError("%s is on %s, its rank's device is %s"
                         % (name, t.device, dev))
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError("%s must be contiguous and 16-byte aligned" % name)


def check_kernel_inputs(ring, bufs: Sequence[torch.Tensor],
                        ws: Optional[Sequence[torch.Tensor]] = None) -> None:
    """Raise ``ValueError`` on anything K9 (``ws`` given) or K10 does not
    take: one tensor a rank, each on its rank's card, contiguous and
    16-byte aligned; for K9 bf16 or f32, one type for ``buf`` and ``w``,
    ``buf`` [t, ..., k] alike on every rank, ``w`` [k, n] with k and n
    positive multiples of 8."""
    if len(bufs) != ring.size or (ws is not None and len(ws) != ring.size):
        raise ValueError("one tensor a rank: %d ranks, got %d%s"
                         % (ring.size, len(bufs), "" if ws is None
                            else " and %d" % len(ws)))
    for r, b in enumerate(bufs):
        _check_tensor("rank %d's tensor" % r, b, ring.device(r))
        if b.shape != bufs[0].shape or b.dtype != bufs[0].dtype:
            raise ValueError("every rank's tensor must be alike: rank %d "
                             "has %s %s, rank 0 %s %s"
                             % (r, tuple(b.shape), b.dtype,
                                tuple(bufs[0].shape), bufs[0].dtype))
        if b.numel() == 0:
            raise ValueError("rank %d's tensor is empty" % r)
    if ws is None:
        return
    dtype = bufs[0].dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("the ring GEMM kernel takes bf16 or f32, got %s"
                         % dtype)
    k = bufs[0].shape[-1]
    rows = bufs[0].numel() // k
    for r, w in enumerate(ws):
        _check_tensor("rank %d's w" % r, w, ring.device(r))
        if w.dtype != dtype:
            raise ValueError("w is %s, buf is %s: the kernel takes one type"
                             % (w.dtype, dtype))
        if w.dim() != 2 or w.shape[0] != k or w.shape != ws[0].shape:
            raise ValueError("w must be [k, n] with k = %d on every rank, "
                             "got %s on rank %d" % (k, tuple(w.shape), r))
    n = ws[0].shape[1]
    if k % 8 or n == 0 or n % 8:
        raise ValueError("k and n must be positive multiples of 8 (16-byte "
                         "loads), got k %d, n %d" % (k, n))
    if rows > _MAX_INT:
        raise ValueError("%d rows are past the kernel's int row index"
                         % rows)


_lib: Optional[ctypes.CDLL] = None


def _bind() -> ctypes.CDLL:
    """The kernels' library with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = _build.load(_KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ring_mm_step_launch.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.ring_mm_step_launch.restype = i
        lib.ring_mm_step_plan.argtypes = [i, i, i, i, p]
        lib.ring_mm_step_plan.restype = i
        lib.ring_shift_launch.argtypes = [p, p, ctypes.c_longlong, p]
        lib.ring_shift_launch.restype = i
        lib.ring_enable_peer.argtypes = [i, i]
        lib.ring_enable_peer.restype = i
        lib.ring_error_string.argtypes = [i]
        lib.ring_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError("%s failed: %s"
                           % (what, _bind().ring_error_string(rc).decode()))


def enable_peer(dev: int, peer: int) -> None:
    """Let kernels on card ``dev`` store into card ``peer``'s memory
    (``cudaDeviceEnablePeerAccess``; already enabled counts as done)."""
    _raise_on(_bind().ring_enable_peer(dev, peer),
              "enabling peer access from cuda:%d to cuda:%d" % (dev, peer))


def _refuse_grad(tensors: Sequence[torch.Tensor], what: str) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError("%s returns no gradient: call it under no_grad or "
                         "through its functional layer" % what)


def _recv_buffers(tensors: Sequence[torch.Tensor], ring,
                  step: int) -> List[torch.Tensor]:
    """out[(r + step) % size]: a fresh buffer like rank r's tensor on the
    target rank's card, allocated under that card's current stream."""
    out: List[torch.Tensor] = [None] * ring.size  # type: ignore
    for r, t in enumerate(tensors):
        dst = (r + step) % ring.size
        out[dst] = torch.empty_like(t, device=ring.device(dst))
    return out


def mm_step(bufs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
            ring) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One TP ring step on K9, for every rank: ``partials[r] = bufs[r] @
    ws[r]`` (``[t, ..., n]``, f32 accumulate, in the input type) and
    ``next_bufs[(r + 1) % size] = bufs[r]``, copied by rank r's kernel into
    the neighbour's memory. CUDA tensors only (see
    :func:`check_kernel_inputs`); raises when grad is enabled and an
    input requires grad (``fusion.overlap_mm`` carries the gradient).
    Each rank's launch adds one to ``mm_step.launches``."""
    check_kernel_inputs(ring, bufs, ws)
    _refuse_grad(list(bufs) + list(ws), "mm_step")
    k, n = ws[0].shape
    rows = bufs[0].numel() // k
    partials = [torch.empty(b.shape[:-1] + (n,), dtype=b.dtype,
                            device=b.device) for b in bufs]
    nexts = _recv_buffers(bufs, ring, 1)
    lib = _bind()
    ring.before_writes(1)
    for r in range(ring.size):
        dev = ring.device(r)
        with torch.cuda.device(dev):
            rc = lib.ring_mm_step_launch(
                bufs[r].data_ptr(), ws[r].data_ptr(), partials[r].data_ptr(),
                nexts[(r + 1) % ring.size].data_ptr(), rows, k, n,
                int(bufs[r].dtype == torch.bfloat16),
                ring.stream(r).cuda_stream)
        _raise_on(rc, "ring GEMM step kernel launch on %s" % dev)
        mm_step.launches += 1
    ring.after_writes(1)
    return partials, nexts


mm_step.launches = 0


def mm_step_plan(rows: int, k: int, n: int, dtype: torch.dtype,
                 device=None) -> dict:
    """How K9 lays out one rank's ``[rows, k] @ [k, n]`` step on the
    card (``device``, default the current one): ``tile`` (rows, columns
    of an output tile), ``items`` (output tiles), ``at_once`` (items that
    run together: the bf16 kernel's persistent grid, two f32 blocks an
    SM) and ``waves`` (items / at_once). Launches nothing."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        rc = _bind().ring_mm_step_plan(rows, k, n,
                                       int(dtype == torch.bfloat16), out)
    _raise_on(rc, "K9's plan")
    return dict(tile=(out[0], out[1]), items=out[2], at_once=out[3],
                waves=out[2] / out[3])


def mm_step_ref(bufs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                ring) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The plain version of :func:`mm_step` on any device: each rank's
    ``buf`` rows times its ``w`` in f32, rounded once to the input type,
    and the plain ring shift by one."""
    partials = []
    for b, w in zip(bufs, ws):
        k, n = w.shape
        out = torch.matmul(b.reshape(-1, k).float(), w.float())
        partials.append(out.to(torch.result_type(b, w))
                        .reshape(b.shape[:-1] + (n,)))
    return partials, ring.shift_ref(bufs, 1)


def shift(tensors: Sequence[torch.Tensor], ring,
          step: int = 1) -> List[torch.Tensor]:
    """Ring shift on K10: ``out[(r + step) % size] = tensors[r]``, copied
    by rank r's kernel into the target rank's memory, bit for bit. CUDA
    tensors only, one a rank, alike, contiguous and 16-byte aligned;
    raises when grad is enabled and an input requires grad
    (``distributed.pipeline.ring_shift`` carries the gradient). Each
    rank's launch adds one to ``shift.launches``."""
    check_kernel_inputs(ring, tensors)
    _refuse_grad(tensors, "shift")
    for r in range(ring.size):
        ring.link(r, r + step)
    out = _recv_buffers(tensors, ring, step)
    nbytes = tensors[0].numel() * tensors[0].element_size()
    lib = _bind()
    ring.before_writes(step)
    for r in range(ring.size):
        dev = ring.device(r)
        with torch.cuda.device(dev):
            rc = lib.ring_shift_launch(
                tensors[r].data_ptr(),
                out[(r + step) % ring.size].data_ptr(), nbytes,
                ring.stream(r).cuda_stream)
        _raise_on(rc, "ring shift kernel launch on %s" % dev)
        shift.launches += 1
    ring.after_writes(step)
    return out


shift.launches = 0
