"""Decomposed computation-collective overlap for sharded matmuls over a
ring of devices (``PADDLE_TPU_TP_OVERLAP``).

Port of ``paddle_tpu/fusion/overlap_mm.py``'s ring primitives. The JAX
functions are ``shard_map`` bodies over an ``mp`` mesh axis; here one
process drives a :class:`~paddle_tpu_torch.distributed.Ring` and every
per-rank value is a list with one tensor a rank, on that rank's device:

* :func:`all_gather_matmul` (column-parallel forward): instead of
  ``matmul(all_gather(x), w)``, rank r multiplies the block it holds
  while the next block moves one hop around the ring;
* :func:`matmul_reduce_scatter` (row-parallel forward): each rank adds
  its partial product of a destination block into an accumulator that
  rides the ring.

Both are ``torch.autograd.Function``s whose backwards are the JAX custom
VJPs: the transpose of all-gather is reduce-scatter, so
``all_gather_matmul``'s dx runs the dual :func:`_mmrs_impl` ring on
``g @ w.T`` and its dw regathers the activations (:func:`_ring_gather`)
into one 2D dot (:func:`_flat_dw`); ``matmul_reduce_scatter``'s backward
is the mirror image. :func:`sharded_all_gather_matmul` /
:func:`sharded_matmul_reduce_scatter` take global tensors and a ring and
split them as the JAX specs do.

Routing, re-derived for Hopper. On the TPU the fused ring step (K9,
``_pallas_mm_step``) ran only under ``PADDLE_TPU_TP_OVERLAP=pallas`` on a
TPU backend, and the default ring step was XLA's ``ppermute`` plus a
matmul. The port has no compiler to hand the collective to, so for CUDA
tensors every forward ring step of :func:`_agmm_impl` but the last runs
K9 (``incubate/nn/cuda/ring.py`` ``mm_step``) in every mode except
"off"; "pallas" is accepted and means the same as "on" (and "auto").
The ring steps that are ``ppermute`` + ``jnp.matmul`` in the JAX package
even under "pallas" stay :meth:`Ring.shift_ref` + ``torch.matmul``: the
last, local step of the all-gather ring, :func:`_mmrs_impl` and the
backward rings. "off" runs the serial composition (gather, then one
``torch.matmul``; matmul, then the reduce-scatter), which autograd
differentiates. CPU tensors run the plain ring step in every mode but
"off". ``quant_mode`` other than "off" (the int8 / fp8 ``qmm``) is not
ported and raises.

No row chunking. The JAX ring splits each step's local GEMM into
``PADDLE_TPU_TP_OVERLAP_CHUNKS`` row chunks so that XLA can schedule the
``ppermute`` against them. In eager PyTorch the chunks run one after
another and overlap nothing, and K9 does its copy and its GEMM in one
launch, so the port's ring multiplies each block in one call and reads
no chunk count. Each output row is one dot product either way.

Numerics: the JAX tests hold the 2-rank ring bitwise against the serial
composition. The port is held within tolerances: K9 sums in its own
order, as ``torch.matmul`` does in another.

``chunked_mm``, ``region_mm`` and ``overlap_linear`` (the GSPMD model
path, no kernel) are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import List, Sequence

import torch

from ..config import knobs

__all__ = [
    "mode", "override",
    "all_gather_matmul", "matmul_reduce_scatter",
    "sharded_all_gather_matmul", "sharded_matmul_reduce_scatter",
]

_MODES = ("auto", "on", "pallas", "off")

# Per-context override so a scope (a test, a timed run) can pin the
# overlap mode, as the JAX package's does.
_forced: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_torch_tp_overlap_forced", default=None)


# ------------------------------------------------------------------ knobs
def mode() -> str:
    """Resolved overlap mode: "on", "pallas" or "off" ("auto" -> "on").
    Every mode but "off" takes the ring; on a CUDA device its steps run
    K9 (see the module note)."""
    forced = _forced.get()
    raw = forced if forced is not None else \
        knobs.get_str("PADDLE_TPU_TP_OVERLAP").strip().lower()
    if raw not in _MODES:
        raise ValueError(
            f"PADDLE_TPU_TP_OVERLAP={raw!r}: expected one of {_MODES}")
    return "on" if raw == "auto" else raw


@contextlib.contextmanager
def override(tp_overlap: str):
    """Pin the overlap mode for the current context."""
    tok = _forced.set(tp_overlap)
    try:
        yield
    finally:
        _forced.reset(tok)


# ------------------------------------------------------------ local GEMM
def _flat_dw(x, g):
    """dw = x^T g contracted over all leading dims as ONE 2D dot."""
    k, n = x.shape[-1], g.shape[-1]
    return torch.matmul(x.reshape(-1, k).T, g.reshape(-1, n))


# ----------------------------------------------------- ring primitive cores
def _ring_gather(xs, ring) -> List[torch.Tensor]:
    """All-gather along the leading dim by ring steps (pure data
    movement): every rank gets the blocks of all ranks in rank order."""
    n = ring.size
    blocks = [[None] * n for _ in range(n)]
    buf = list(xs)
    for step in range(n):
        for r in range(n):
            blocks[r][(r - step) % n] = buf[r]
        if step < n - 1:
            buf = ring.shift_ref(buf, 1)
    return [torch.cat(b, 0) for b in blocks]


def _agmm_impl(xs, ws, ring, use_kernel) -> List[torch.Tensor]:
    """Ring all-gather-matmul forward: at step ``step`` rank r multiplies
    block (r - step) while its buffer moves one hop, so every hop rides
    inside a GEMM; with ``use_kernel`` each step but the last is one K9
    launch a rank. Returns each rank's ``[t * size, ..., n_local]``: all
    token blocks against its own weight columns."""
    from ..incubate.nn.cuda import ring as kring

    n = ring.size
    blocks = [[None] * n for _ in range(n)]
    buf = list(xs)
    for step in range(n):
        if use_kernel and step < n - 1:
            parts, nxt = kring.mm_step(buf, ws, ring)
        else:
            nxt = ring.shift_ref(buf, 1) if step < n - 1 else None
            parts = [torch.matmul(b, w) for b, w in zip(buf, ws)]
        for r in range(n):
            blocks[r][(r - step) % n] = parts[r]
        if nxt is not None:
            buf = nxt
    return [torch.cat(b, 0) for b in blocks]


def _mmrs_impl(xs, ws, ring) -> List[torch.Tensor]:
    """Ring matmul-reduce-scatter forward: the accumulator rides the ring
    while each rank adds its partial product of the block the
    accumulator will need next, in the JAX package's rank order."""
    n = ring.size
    t = xs[0].shape[0] // n

    def partial(r, block):
        return torch.matmul(xs[r][block * t:(block + 1) * t], ws[r])

    acc = [partial(r, (r + n - 1) % n) for r in range(n)]
    for step in range(1, n):
        acc = ring.shift_ref(acc, 1)
        acc = [a + partial(r, (r - step + n - 1) % n)
               for r, a in enumerate(acc)]
    return acc


# ------------------------------------------------------ serial compositions
def _serial_agmm(xs, ws, ring) -> List[torch.Tensor]:
    """``matmul(all_gather(x), w)`` on every rank."""
    return [torch.matmul(torch.cat([x.to(ring.device(r)) for x in xs], 0),
                         w) for r, w in enumerate(ws)]


def _serial_mmrs(xs, ws, ring) -> List[torch.Tensor]:
    """``psum_scatter(matmul(x, w))``: rank r sums block r of every
    rank's product, in rank order."""
    n = ring.size
    t = xs[0].shape[0] // n
    full = [torch.matmul(x, w) for x, w in zip(xs, ws)]
    out = []
    for r in range(n):
        dev = ring.device(r)
        acc = full[0][r * t:(r + 1) * t].to(dev)
        for q in range(1, n):
            acc = acc + full[q][r * t:(r + 1) * t].to(dev)
        out.append(acc)
    return out


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, use_kernel, *tensors):
        n = ring.size
        xs, ws = tensors[:n], tensors[n:]
        ctx.ring = ring
        ctx.save_for_backward(*tensors)
        return tuple(_agmm_impl(xs, ws, ring, use_kernel))

    @staticmethod
    def backward(ctx, *gs):
        ring, n = ctx.ring, ctx.ring.size
        tensors = ctx.saved_tensors
        xs, ws = tensors[:n], tensors[n:]
        gs = [g.to(x.dtype) for g, x in zip(gs, xs)]
        # dx: the transpose of all-gather is reduce-scatter -> dual ring
        dx = _mmrs_impl(gs, [w.transpose(-1, -2) for w in ws], ring)
        # dw: regather the activations, one dot
        dw = [_flat_dw(xg, g).to(w.dtype)
              for xg, g, w in zip(_ring_gather(xs, ring), gs, ws)]
        return (None, None, *dx, *dw)


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, *tensors):
        n = ring.size
        ctx.ring = ring
        ctx.save_for_backward(*tensors)
        return tuple(_mmrs_impl(tensors[:n], tensors[n:], ring))

    @staticmethod
    def backward(ctx, *gs):
        ring, n = ctx.ring, ctx.ring.size
        tensors = ctx.saved_tensors
        xs, ws = tensors[:n], tensors[n:]
        gs = [g.to(x.dtype) for g, x in zip(gs, xs)]
        # dx: the transpose of reduce-scatter is all-gather -> dual ring
        dx = _agmm_impl(gs, [w.transpose(-1, -2) for w in ws], ring, False)
        dw = [_flat_dw(x, gg).to(w.dtype)
              for x, gg, w in zip(xs, _ring_gather(gs, ring), ws)]
        return (None, *dx, *dw)


def _check_args(xs, ws, ring, quant_mode) -> None:
    if quant_mode != "off":
        raise NotImplementedError(
            "quant_mode=%r: the quantized ring GEMM is not ported yet (see "
            "ROADMAP.md)" % (quant_mode,))
    if len(xs) != ring.size or len(ws) != ring.size:
        raise ValueError("one x and one w a rank: a ring of %d, got %d and "
                         "%d" % (ring.size, len(xs), len(ws)))


# ------------------------------------------------------- public primitives
def all_gather_matmul(xs: Sequence[torch.Tensor],
                      ws: Sequence[torch.Tensor], ring, *,
                      quant_mode: str = "off") -> List[torch.Tensor]:
    """Decomposed ``matmul(all_gather(x, tiled), w)`` over ``ring``.

    ``xs[r]``: rank r's token block ``[t, ..., k]``; ``ws[r]``: its weight
    columns ``[k, n_local]``; returns each rank's ``[t * size, ...,
    n_local]``. Differentiable; see the module note for what runs where.
    """
    _check_args(xs, ws, ring, quant_mode)
    if mode() == "off":
        return _serial_agmm(xs, ws, ring)
    use_kernel = ring.device(0).type == "cuda"
    return list(_AllGatherMatmul.apply(ring, use_kernel, *xs, *ws))


def matmul_reduce_scatter(xs: Sequence[torch.Tensor],
                          ws: Sequence[torch.Tensor], ring, *,
                          quant_mode: str = "off") -> List[torch.Tensor]:
    """Decomposed ``psum_scatter(matmul(x, w), tiled)`` over ``ring``.

    ``xs[r]``: all token blocks against rank r's contraction slice
    ``[T, ..., k_local]``; ``ws[r]``: its weight rows ``[k_local, n]``;
    returns each rank's token block ``[T / size, ..., n]``.
    Differentiable.
    """
    _check_args(xs, ws, ring, quant_mode)
    if mode() == "off":
        return _serial_mmrs(xs, ws, ring)
    return list(_MatmulReduceScatter.apply(ring, *xs, *ws))


# --------------------------------------------------- global conveniences
def _split(t, ring, dim) -> List[torch.Tensor]:
    if t.shape[dim] % ring.size:
        raise ValueError("dim %d of %s does not split over a ring of %d"
                         % (dim, tuple(t.shape), ring.size))
    return [c.to(ring.device(r)).contiguous()
            for r, c in enumerate(t.chunk(ring.size, dim))]


def sharded_all_gather_matmul(x: torch.Tensor, w: torch.Tensor, *, ring,
                              quant_mode: str = "off") -> torch.Tensor:
    """Global tensors: ``x`` split over the ranks on its leading (token)
    dim, ``w`` on its last dim; returns ``x @ w`` on ``x``'s device (the
    ranks' column blocks side by side)."""
    outs = all_gather_matmul(_split(x, ring, 0), _split(w, ring, -1), ring,
                             quant_mode=quant_mode)
    return torch.cat([o.to(x.device) for o in outs], -1)


def sharded_matmul_reduce_scatter(x: torch.Tensor, w: torch.Tensor, *,
                                  ring, quant_mode: str = "off"
                                  ) -> torch.Tensor:
    """Global tensors: ``x`` split over the ranks on its last
    (contraction) dim, ``w`` on its first dim; returns ``x @ w`` on
    ``x``'s device (the ranks' token blocks one after another)."""
    outs = matmul_reduce_scatter(_split(x, ring, -1), _split(w, ring, 0),
                                 ring, quant_mode=quant_mode)
    return torch.cat([o.to(x.device) for o in outs], 0)
