"""Sort-based MoE dispatch and the block-aligned grouped GEMM.

Port of ``paddle_tpu/incubate/nn/pallas/moe_dispatch.py``'s
``sort_dispatch`` and ``grouped_matmul``. :func:`grouped_matmul` launches
the hand-written Hopper kernel K8 (``csrc/moe_dispatch.cu``) on CUDA
tensors and raises on anything else; :func:`grouped_matmul_ref` is the
plain PyTorch version of the same function (the Pallas kernel's, block by
block); both take an optional ``rows``, the real rows of each row
block, which :func:`block_rows` computes from a dispatch, to zero and
skip padding. :func:`sort_dispatch` and :func:`block_rows` are plain
PyTorch on any device. The one
dispatching, differentiable entry is :mod:`..functional.moe_dispatch`,
which takes the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["BM", "sort_dispatch", "block_rows", "grouped_matmul",
           "grouped_matmul_ref", "check_kernel_inputs"]

BM = 128       # row block: one expert per block after padding
_KERNEL = "moe_dispatch"
_MAX_BLOCKS = 65535                  # the launch grid's second axis


def _top_k(probs, k):
    """``jax.lax.top_k`` over the last axis: ties go to the lower index
    (``torch.topk`` breaks them otherwise), so a stable descending sort
    and its first k."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def sort_dispatch(x, probs, k, normalize=True):
    """Route tokens to their top-k experts by one counting sort.

    x [S, M]; probs [S, E] router probabilities. Returns the JAX
    package's dict: ``xp`` [P, M] (P = ceil(S*k/128)*128 + E*128, each
    expert's rows padded to whole 128-row blocks, pad rows zero),
    ``dest`` [S*k] int32 padded row of each (token, k) pair in pair
    order, ``weight`` [S*k] combine weights, ``block_gid`` [P/128] int32
    expert of each row block, ``group_sizes`` and ``padded_sizes`` [E]
    int32. No host synchronisation: every shape follows from S, k and E.
    """
    s, m = x.shape
    e = probs.shape[-1]
    t = s * k
    dev = x.device
    top_p, top_e = _top_k(probs, k)
    if normalize:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    flat_e = top_e.reshape(-1)
    flat_p = top_p.reshape(-1)
    # counting sort: prefix sums over the one-hot give each pair its rank
    # within its expert, in pair order. The one-hot is [E, T], so the scan
    # runs along the contiguous axis: along T of a [T, E] tensor, a GPU
    # scan walks each of the E columns with one thread.
    prefix = torch.cumsum(torch.nn.functional.one_hot(flat_e, e).T, 1,
                          dtype=torch.int32)                 # [E, T]
    counts = prefix[:, -1]
    rank = prefix.gather(0, flat_e[None])[0] - 1
    padded = (counts + BM - 1) // BM * BM
    ends = torch.cumsum(padded, 0, dtype=torch.int32)
    dest = (ends - padded)[flat_e] + rank
    p_rows = -(-t // BM) * BM + e * BM
    # row -> source pair; pad rows gather the appended zero row
    row_pair = torch.full((p_rows,), t, dtype=torch.int32, device=dev)
    row_pair[dest.long()] = torch.arange(t, dtype=torch.int32, device=dev)
    src_tok = torch.where(row_pair < t, row_pair // k, s)
    xp = torch.cat([x, x.new_zeros(1, m)])[src_tok]
    starts = torch.arange(0, p_rows, BM, dtype=torch.int32, device=dev)
    block_gid = torch.searchsorted(ends, starts, right=True) \
        .clamp_(0, e - 1).to(torch.int32)
    return {"xp": xp, "dest": dest, "weight": flat_p,
            "block_gid": block_gid, "group_sizes": counts,
            "padded_sizes": padded}


def block_rows(block_gid, group_sizes, padded_sizes):
    """Real rows of each 128-row block of :func:`sort_dispatch`'s ``xp``,
    int32 ``[P/128]`` in [0, 128], on the device of its outputs and
    without a host synchronisation: an expert's real rows come first in
    its padded span, so block i holds ``min(128, max(0, start + count -
    128 i))`` of its expert's; a block past every span holds none."""
    ends = torch.cumsum(padded_sizes, 0, dtype=torch.int32)
    real_end = (ends - padded_sizes + group_sizes)[block_gid.long()]
    starts = torch.arange(0, block_gid.numel() * BM, BM, dtype=torch.int32,
                          device=block_gid.device)
    return (real_end - starts).clamp_(0, BM).to(torch.int32)


def grouped_matmul_ref(xp, w, block_gid, *, rows=None):
    """The Pallas kernel's function on any device: row block i of
    ``xp [P, K]`` (P a multiple of 128) times ``w[block_gid[i]]`` of
    ``w [E, K, N]``, summed in f32 and rounded to xp's type once. An
    expert id outside [0, E) is clamped into it, as K8 does. With
    ``rows`` (int32 ``[P/128]``), rows of block i at or past ``rows[i]``
    are zero, as K8 makes them."""
    gids = block_gid.clamp(0, w.shape[0] - 1).tolist()
    xf = xp.float()
    out = torch.cat([xf[i * BM:(i + 1) * BM] @ w[g].float()
                     for i, g in enumerate(gids)]).to(xp.dtype)
    if rows is None:
        return out
    real = torch.arange(BM, device=rows.device) < rows[:, None]
    return torch.where(real[..., None], out.view(-1, BM, out.shape[-1]),
                       0).view_as(out)


def check_kernel_inputs(xp, w, block_gid, rows=None) -> None:
    """Raise ``ValueError`` on anything K8 does not take: it reads raw
    pointers 16 bytes at a time, so device, type, shape, layout and
    alignment are settled here."""
    if xp.device.type != "cuda":
        raise ValueError("the grouped GEMM kernel takes CUDA tensors, got "
                         "%s (the plain version serves the CPU)" % xp.device)
    if xp.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("the grouped GEMM kernel takes bf16 or f32, got %s"
                         % xp.dtype)
    if w.dtype != xp.dtype:
        raise ValueError("w is %s, xp is %s: the kernel takes one type"
                         % (w.dtype, xp.dtype))
    if xp.dim() != 2 or w.dim() != 3 or w.shape[1] != xp.shape[1]:
        raise ValueError("xp must be [P, K] and w [E, K, N], got %s and %s"
                         % (tuple(xp.shape), tuple(w.shape)))
    p, k = xp.shape
    e, _, n = w.shape
    if p == 0 or p % BM or p // BM > _MAX_BLOCKS:
        raise ValueError("P must be a positive multiple of %d and at most "
                         "%d, got %d" % (BM, BM * _MAX_BLOCKS, p))
    if k == 0 or k % 8 or n == 0 or n % 8 or e == 0:
        raise ValueError("K and N must be positive multiples of 8 (16-byte "
                         "loads) and E positive, got K %d, N %d, E %d"
                         % (k, n, e))
    if block_gid.dtype != torch.int32 or \
            tuple(block_gid.shape) != (p // BM,):
        raise ValueError("block_gid must be int32 [%d], got %s %s"
                         % (p // BM, block_gid.dtype,
                            tuple(block_gid.shape)))
    if rows is not None and (rows.dtype != torch.int32 or
                             tuple(rows.shape) != (p // BM,)):
        raise ValueError("rows must be int32 [%d], got %s %s"
                         % (p // BM, rows.dtype, tuple(rows.shape)))
    named = [("xp", xp), ("w", w), ("block_gid", block_gid)] + \
        ([] if rows is None else [("rows", rows)])
    for name, t in named[1:]:
        if t.device != xp.device:
            raise ValueError("%s is on %s, xp on %s"
                             % (name, t.device, xp.device))
    for name, t in named:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("%s must be contiguous and 16-byte aligned"
                             % name)


_lib: Optional[ctypes.CDLL] = None


def _bind() -> ctypes.CDLL:
    """The kernel's library with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = _build.load(_KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gmm_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.gmm_launch.restype = i
        lib.gmm_encode_us.argtypes = [p, p, p, i, i, i, i, i]
        lib.gmm_encode_us.restype = ctypes.c_double
        lib.gmm_error_string.argtypes = [i]
        lib.gmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def grouped_matmul(xp, w, block_gid, *, rows=None):
    """``out [P, N]``: row block i of the CUDA tensor ``xp [P, K]`` times
    ``w[block_gid[i]]`` of ``w [E, K, N]`` (bf16 or f32, one type,
    contiguous; ``block_gid`` int32 ``[P/128]`` in any order), on K8.
    ``rows`` (optional int32 ``[P/128]``, e.g. :func:`block_rows`): rows
    of block i at or past ``rows[i]`` are zero, and the kernel skips the
    work of blocks and 64-row halves that hold none below it. Raises
    ``ValueError`` on what the kernel does not take, and when grad is
    enabled and an input requires grad (the kernel has no backward:
    :func:`..functional.moe_dispatch.grouped_matmul` carries the
    gradient). Each launch adds one to ``grouped_matmul.launches``."""
    check_kernel_inputs(xp, w, block_gid, rows)
    if torch.is_grad_enabled() and (xp.requires_grad or w.requires_grad):
        raise ValueError("grouped_matmul returns no gradient: call it "
                         "under no_grad or through the functional "
                         "moe_dispatch.grouped_matmul")
    p, k = xp.shape
    e, _, n = w.shape
    out = torch.empty(p, n, dtype=xp.dtype, device=xp.device)
    lib = _bind()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        rc = lib.gmm_launch(xp.data_ptr(), w.data_ptr(),
                            block_gid.data_ptr(),
                            None if rows is None else rows.data_ptr(),
                            out.data_ptr(), p, k, n, e,
                            int(xp.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError("grouped GEMM kernel launch failed: %s"
                           % lib.gmm_error_string(rc).decode())
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
