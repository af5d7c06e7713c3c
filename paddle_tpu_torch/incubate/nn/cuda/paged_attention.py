"""Paged attention over a paged KV pool (ragged and one token a row),
and the pool writes.

Port of ``paddle_tpu/incubate/nn/pallas/paged_attention.py`` for both
layouts of the serving step. Layouts are the JAX package's:

  q:            [n_tokens, num_heads, head_dim] -- flat token axis, rows
                packed contiguously (row r owns tokens q_starts[r] ..
                q_starts[r] + query_lens[r])
  k/v_pages:    fp pool [num_kv_heads, total_pages, page_size, head_dim]
                (bf16 or f32), or int8 pool ``{"q8": int8 of that shape,
                "s": f32 [num_kv_heads, total_pages, page_size]}`` whose
                rows decode by :func:`_dequant` (value = q8 * s)
  block_tables: [n_rows, pages_per_seq] int32
  context_lens: [n_rows] int32 -- KV length INCLUDING this step's tokens
  query_lens:   [n_rows] int32 -- 1 for a decode row, the chunk length for
                a prefill row, 0 for an idle slot
  q_starts:     [n_rows] int32 -- exclusive prefix sum of query_lens
  row_of:       [n_tokens] int32 -- owning row per token, -1 for padding

:func:`ragged_paged_attention` launches a hand-written Hopper kernel
(``csrc/ragged_paged_attention.cu``): the counterpart of the TPU kernel
``_ragged_kernel`` (K4) over an fp pool, of ``_ragged_kernel_q8`` (K5)
over an int8 pool, each with its own launch count.
:func:`paged_attention` (one query token a row: ``q [n_rows, num_heads,
head_dim]``, ``context_lens [n_rows]`` keys a row) launches
``csrc/paged_attention.cu``, the counterpart of ``_decode_kernel`` (K6),
over an fp or an int8 pool, again with a count each; rows of a prefill
chunk that name the same pages share one read of them there. Every
wrapper takes CUDA tensors only and raises on anything else; the plain
PyTorch versions, :func:`ragged_paged_attention_ref` and
:func:`paged_attention_ref`, serve the CPU (the serving step's
``_ragged_attn`` and ``_paged_attn_chunk`` choose between them).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["ragged_paged_attention", "ragged_paged_attention_ref",
           "merge_partials_ref", "paged_attention", "paged_attention_ref",
           "decode_split",
           "paged_kv_write_chunk", "kv_write_slots", "kv_scatter",
           "quantize_kv_pages", "pool_shape"]

_KERNEL = "ragged_paged_attention"
_DECODE_KERNEL = "paged_attention"
_MAX_D = 256


def _dequant(q8, s, dtype=torch.float32):
    """The one int8-page decode rule (the JAX package's ``_dequant``):
    ``value = q8 * s`` with the per-row scale broadcast over the head
    dim. K5 decodes each staged key row by the same rule, in f32."""
    return q8.to(dtype) * s[..., None].to(dtype)


def _const(value: float, device) -> torch.Tensor:
    """``value`` as a 0-d f32 tensor on ``device`` (a fill, no copy from
    the host)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _quantize_rows(x):
    """Per-row symmetric int8 over the last axis (the JAX package's
    ``_quantize_rows``): ``s = max|x| / 127`` floored at 1e-8, codes
    ``round(x / s)`` clipped to +-127. ``torch.round`` rounds half to
    even, as ``jnp.round`` does, so both packages write the same codes.
    127 is a 0-d tensor on x's device: PyTorch's CUDA division by a
    Python number multiplies by its reciprocal, one rounding away from
    the division the CPU and the JAX package do."""
    xf = x.float()
    s = (xf.abs().amax(-1) / _const(127.0, x.device)).clamp_min(1e-8)
    q = torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


def quantize_kv_pages(pages):
    """A bf16/f32 pool ``[n_kv, pages, page, d]`` -> the int8 pool
    ``{"q8": int8 [n_kv, pages, page, d], "s": f32 [n_kv, pages,
    page]}``."""
    q, s = _quantize_rows(pages)
    return {"q8": q, "s": s}


def pool_shape(pages) -> Tuple[int, int, int, int]:
    """``(n_kv, total_pages, page, d)`` of an fp or int8 pool."""
    return tuple((pages["q8"] if isinstance(pages, dict) else pages).shape)


def _token_rows(q_starts: torch.Tensor, query_lens: torch.Tensor,
                n_tokens: int) -> torch.Tensor:
    """Derive the per-token owning row [T] (-1 for padding tokens) from
    per-row spans."""
    t = torch.arange(n_tokens, device=q_starts.device)
    in_row = (t[None, :] >= q_starts[:, None]) & \
        (t[None, :] < (q_starts + query_lens)[:, None])
    first = in_row.to(torch.int32).argmax(dim=0).to(torch.int32)
    return torch.where(in_row.any(dim=0), first, -1)


def paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens,
                        scale=None):
    """The plain PyTorch version of K6 (:func:`paged_attention`, same
    arguments): gather each row's pages, then masked f32 attention.
    Mirrors the JAX package's ``_xla_paged_attention``: rows with
    ``context_lens == 0`` get zeros (their softmax over nothing would be
    0/0), block-table ids are clamped into the pool, and int8 pools
    decode through :func:`_dequant`."""
    bsz, n_heads, d = q.shape
    if scale is None:
        scale = d ** -0.5
    n_kv, total_pages, page, _ = pool_shape(k_pages)
    group = n_heads // n_kv
    max_len = block_tables.shape[1] * page
    bt = block_tables.clamp(0, total_pages - 1).long()

    def gather(pages):                 # -> [b, n_kv, max_len, ...]
        g = pages[:, bt]               # [n_kv, b, pp, page, ...]
        return g.movedim(1, 0).reshape((bsz, n_kv, max_len)
                                       + tuple(pages.shape[3:]))

    def rows(pages):                   # -> [b, n_kv, max_len, d] f32
        if isinstance(pages, dict):
            return _dequant(gather(pages["q8"]), gather(pages["s"]))
        return gather(pages).float()

    qg = q.reshape(bsz, n_kv, group, d).float()
    s = torch.einsum("bkgd,bktd->bkgt", qg, rows(k_pages)) * scale
    mask = torch.arange(max_len, device=q.device)[None, None, None, :] \
        < context_lens[:, None, None, None]
    s = s.masked_fill(~mask, float("-inf"))
    w = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bkgt,bktd->bkgd", w, rows(v_pages))
    return out.reshape(bsz, n_heads, d).to(q.dtype)


def _q_starts(query_lens: torch.Tensor) -> torch.Tensor:
    return (torch.cumsum(query_lens, 0) - query_lens).to(torch.int32)


def ragged_paged_attention_ref(q, k_pages, v_pages, block_tables,
                               context_lens, query_lens, q_starts=None,
                               row_of=None, scale=None):
    """The plain PyTorch version of the kernel (the JAX package's
    ``_xla_ragged_paged_attention``): expand the ragged batch to one
    'sequence' per token with its causal prefix length and its row's
    block table, then gather-and-softmax. Padding tokens get length 0
    and so zeros. Same arguments as :func:`ragged_paged_attention`."""
    n_tokens, _, d = q.shape
    n_rows = block_tables.shape[0]
    if scale is None:
        scale = d ** -0.5
    if q_starts is None:
        q_starts = _q_starts(query_lens)
    if row_of is None:
        row_of = _token_rows(q_starts, query_lens, n_tokens)
    r = row_of.clamp(0, n_rows - 1).long()
    j = torch.arange(n_tokens, device=q.device) - q_starts[r]
    lens = context_lens[r] - query_lens[r] + j + 1
    lens = torch.where(row_of >= 0, lens.clamp_min(0), 0)
    return paged_attention_ref(q, k_pages, v_pages, block_tables[r], lens,
                               scale)


def merge_partials_ref(m, l, acc):
    """The split merge of K4 / K5 (``ragged_paged_attention_merge_kernel``)
    and of K6 (``paged_decode_merge_kernel``) in plain PyTorch. A query's
    keys fall into disjoint splits; split j leaves ``m [..., S]``, its
    largest score (-inf where it saw no key), ``l [..., S]``, its sum of
    exp(s - m), and ``acc [..., S, d]``, its sum of exp(s - m) * v.
    Returns ``sum_j e^(m_j - M) acc_j / sum_j e^(m_j -
    M) l_j`` over the splits that saw a key (M their largest m), and 0 for
    a query whose splits saw none: ``_ragged_accumulate``'s guarded -inf
    arithmetic. The kernel keeps m in log2 units (2^ for e^) and sums in
    split order."""
    mx = m.amax(-1, keepdim=True)
    seen = torch.isfinite(m)
    f = torch.where(seen, torch.exp(m - torch.where(torch.isfinite(mx), mx,
                                                    0.0)), 0.0)
    ls = (f * l).sum(-1, keepdim=True)
    out = (f[..., None] * acc).sum(-2)
    return out / torch.where(ls == 0, 1.0, ls)


def _tile_tokens(group: int) -> int:
    """Tokens per kernel block: the block holds 16 query vectors, each
    token brings ``group`` of them."""
    return max(1, 16 // group)


def _check_common(q, k_pages, v_pages, meta) -> int:
    """The checks K4, K5 and K6 share (they read raw pointers, so every
    shape, dtype, layout and alignment is settled here): q ``[rows or
    tokens, heads, d]`` bf16 or f32; fp pools of q's type, or int8 pools
    ``{"q8": int8, "s": f32}`` under a bf16 or f32 q; d a multiple of 8
    (16 over int8 pools: 16-byte row loads) and at most 256; the page
    size a multiple of 8; at most 16 query heads a kv head; ``meta``, the
    ``(name, tensor)`` pairs of the int32 metadata. Every tensor on q's
    device, contiguous, q and the pools 16-byte aligned. Returns the
    number of rows the block tables hold."""
    quant = isinstance(k_pages, dict)
    if quant != isinstance(v_pages, dict):
        raise ValueError("k and v pools must both be fp or both int8")
    if q.dim() != 3 or len(pool_shape(k_pages)) != 4:
        raise ValueError("q must be [T, heads, d] and the pools "
                         "[n_kv, pages, page, d]")
    n_tokens, n_heads, d = q.shape
    n_kv, total_pages, page, dk = pool_shape(k_pages)
    if pool_shape(v_pages) != pool_shape(k_pages) or dk != d:
        raise ValueError("k/v pools must both be [n_kv, pages, page, %d]"
                         % d)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("kernel takes bf16 or f32, got %s" % q.dtype)
    if quant:
        pools = (("k_pages.q8", k_pages["q8"]), ("k_pages.s", k_pages["s"]),
                 ("v_pages.q8", v_pages["q8"]), ("v_pages.s", v_pages["s"]))
        for name, t in pools:
            want = torch.int8 if name.endswith("q8") else torch.float32
            if t.dtype != want:
                raise ValueError("%s must be %s, got %s"
                                 % (name, want, t.dtype))
        for name, t in pools[1::2]:
            if tuple(t.shape) != (n_kv, total_pages, page):
                raise ValueError("%s must be [n_kv, pages, page]" % name)
        if d % 16:
            raise ValueError("an int8 pool's head_dim must be a multiple "
                             "of 16 (16-byte row loads), got %d" % d)
    else:
        pools = (("k_pages", k_pages), ("v_pages", v_pages))
        if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
            raise ValueError("q, k_pages and v_pages must share one dtype")
    if d > _MAX_D or d % 8:
        raise ValueError("head_dim must be a multiple of 8 and <= %d, "
                         "got %d" % (_MAX_D, d))
    if page < 8 or page % 8:
        raise ValueError("page size must be a multiple of 8, got %d"
                         % page)
    if n_heads % n_kv:
        raise ValueError("num_heads %d is not a multiple of num_kv_heads "
                         "%d" % (n_heads, n_kv))
    if n_heads // n_kv > 16:
        raise ValueError("GQA group %d exceeds the 16 query vectors of "
                         "one kernel block" % (n_heads // n_kv))
    block_tables = dict(meta)["block_tables"]
    if block_tables.dim() != 2:
        raise ValueError("block_tables must be [n_rows, pages_per_seq]")
    for name, t in meta:
        if t.dtype != torch.int32:
            raise ValueError("%s must be int32, got %s" % (name, t.dtype))
    for name, t in (("q", q),) + pools + tuple(meta):
        if t.device != q.device:
            raise ValueError("%s is on %s, q on %s"
                             % (name, t.device, q.device))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    for name, t in (("q", q),) + pools:
        if t.data_ptr() % 16:
            raise ValueError("%s must be 16-byte aligned" % name)
    return block_tables.shape[0]


def check_kernel_inputs(q, k_pages, v_pages, block_tables, context_lens,
                        query_lens, q_starts) -> None:
    """Raise ``ValueError`` on anything K4 / K5 do not take (see
    :func:`_check_common`); the per-row metadata is ``[n_rows]``."""
    meta = (("block_tables", block_tables), ("context_lens", context_lens),
            ("query_lens", query_lens), ("q_starts", q_starts))
    n_rows = _check_common(q, k_pages, v_pages, meta)
    for name, t in meta[1:]:
        if tuple(t.shape) != (n_rows,):
            raise ValueError("%s must be [%d]" % (name, n_rows))


def check_decode_inputs(q, k_pages, v_pages, block_tables,
                        context_lens) -> None:
    """Raise ``ValueError`` on anything K6 does not take (see
    :func:`_check_common`): one query token a row, so q, the block tables
    and ``context_lens`` share the row axis."""
    meta = (("block_tables", block_tables), ("context_lens", context_lens))
    n_rows = _check_common(q, k_pages, v_pages, meta)
    if q.shape[0] != n_rows or tuple(context_lens.shape) != (n_rows,):
        raise ValueError("q [%d, ...], block_tables [%d, P] and "
                         "context_lens %s must share the row axis"
                         % (q.shape[0], n_rows, tuple(context_lens.shape)))


_lib: Optional[ctypes.CDLL] = None


def _bind() -> ctypes.CDLL:
    """The kernel's library with its C signatures declared (pointers as
    ``c_void_p``: ctypes would cut an undeclared pointer to 32 bits)."""
    global _lib
    if _lib is None:
        lib = _build.load(_KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rpa_launch.argtypes = [p] * 9 + [i] * 9 + [ctypes.c_float, i, p]
        lib.rpa_launch.restype = i
        lib.rpa_q8_launch.argtypes = [p] * 11 + [i] * 9 + [ctypes.c_float,
                                                           i, p]
        lib.rpa_q8_launch.restype = i
        lib.rpa_workspace_floats.argtypes = [i] * 4
        lib.rpa_workspace_floats.restype = ctypes.c_longlong
        lib.rpa_error_string.argtypes = [i]
        lib.rpa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(q, k_pages, v_pages, block_tables, context_lens, query_lens,
            q_starts, scale):
    """Check, then launch K4 (fp pool) or K5 (int8 pool); returns the
    output and whether a kernel was launched."""
    if q.device.type != "cuda":
        raise ValueError("ragged_paged_attention takes CUDA tensors, got "
                         "%s (ragged_paged_attention_ref serves the CPU)"
                         % q.device)
    n_tokens, n_heads, d = q.shape
    if scale is None:
        scale = d ** -0.5
    if q_starts is None:
        q_starts = _q_starts(query_lens)
    check_kernel_inputs(q, k_pages, v_pages, block_tables, context_lens,
                        query_lens, q_starts)
    out = torch.zeros_like(q)          # padding tokens stay exactly zero
    n_kv, total_pages, page, _ = pool_shape(k_pages)
    n_rows, pages_per_seq = block_tables.shape
    if n_tokens == 0 or n_rows == 0:
        return out, False
    lib = _bind()
    # the split partials (m, l, acc) of long rows, sized from shapes alone
    ws = torch.empty(lib.rpa_workspace_floats(n_tokens, n_heads, d,
                                              pages_per_seq * page),
                     dtype=torch.float32, device=q.device)
    if isinstance(k_pages, dict):
        fn = lib.rpa_q8_launch
        pools = (k_pages["q8"], k_pages["s"], v_pages["q8"], v_pages["s"])
    else:
        fn = lib.rpa_launch
        pools = (k_pages, v_pages)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), *(t.data_ptr() for t in pools),
                block_tables.data_ptr(), context_lens.data_ptr(),
                query_lens.data_ptr(), q_starts.data_ptr(), out.data_ptr(),
                ws.data_ptr(), n_tokens, n_heads, n_kv, d, total_pages, page,
                n_rows, pages_per_seq, _tile_tokens(n_heads // n_kv),
                float(scale),
                int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError("ragged_paged_attention launch failed: %s"
                           % lib.rpa_error_string(rc).decode())
    return out, True


def ragged_paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                           query_lens, q_starts=None, row_of=None,
                           scale=None):
    """Attention for a RAGGED batch mixing prefill and decode rows over
    one paged KV pool, in one launch, on CUDA tensors.

    Token j of row r attends to KV positions
    ``< context_lens[r] - query_lens[r] + j + 1`` (causal within the
    chunk, full history before it). Idle rows (query_lens == 0) and
    padding tokens return zeros; block-table ids are clamped into the
    pool; the ``num_heads // num_kv_heads`` query heads of a group share
    one kv head.

    An fp pool launches K4 (bf16 or f32, contiguous, head_dim <= 256,
    page size a multiple of 8, int32 metadata) and adds one to
    ``ragged_paged_attention.launches``; an int8 pool ``{"q8": int8
    [n_kv, pages, page, d], "s": f32 [n_kv, pages, page]}`` launches K5
    (the counterpart of ``_ragged_kernel_q8``: each key row decodes as
    ``q8 * s``; q bf16 or f32, head_dim a multiple of 16) and adds one to
    ``ragged_paged_attention.launches_q8``. Anything the kernels do not
    take, CPU tensors included, raises ``ValueError``. ``row_of`` is not
    needed: the kernels read each row's span from
    ``q_starts``/``query_lens``, which must be the packed layout (q_starts
    the exclusive prefix sum of query_lens). A call is sized from shapes
    alone and never waits on the device, so it can be captured in a CUDA
    graph and replayed with new lengths; rows past one 512-key split
    leave partials in an f32 workspace that a second kernel merges
    (:func:`merge_partials_ref` is its plain version), in a fixed order:
    two calls on the same inputs give the same bits."""
    out, launched = _launch(q, k_pages, v_pages, block_tables,
                            context_lens, query_lens, q_starts, scale)
    if isinstance(k_pages, dict):
        ragged_paged_attention.launches_q8 += launched
    else:
        ragged_paged_attention.launches += launched
    return out


ragged_paged_attention.launches = 0        # K4
ragged_paged_attention.launches_q8 = 0     # K5


_decode_lib: Optional[ctypes.CDLL] = None


def _bind_decode() -> ctypes.CDLL:
    """K6's library with its C signatures declared (see :func:`_bind`)."""
    global _decode_lib
    if _decode_lib is None:
        lib = _build.load(_DECODE_KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pa_launch.argtypes = [p] * 7 + [i] * 7 + [ctypes.c_float, i, p]
        lib.pa_launch.restype = i
        lib.pa_q8_launch.argtypes = [p] * 9 + [i] * 7 + [ctypes.c_float, i,
                                                         p]
        lib.pa_q8_launch.restype = i
        lib.pa_split.argtypes = [i] * 4
        lib.pa_split.restype = i
        lib.pa_workspace_floats.argtypes = [i] * 5
        lib.pa_workspace_floats.restype = ctypes.c_longlong
        lib.pa_error_string.argtypes = [i]
        lib.pa_error_string.restype = ctypes.c_char_p
        _decode_lib = lib
    return _decode_lib


def _launch_decode(q, k_pages, v_pages, block_tables, context_lens, scale):
    """Check, then launch K6 over an fp or an int8 pool; returns the
    output and whether a kernel was launched."""
    if q.device.type != "cuda":
        raise ValueError("paged_attention takes CUDA tensors, got %s "
                         "(paged_attention_ref serves the CPU)" % q.device)
    n_rows, n_heads, d = q.shape
    if scale is None:
        scale = d ** -0.5
    check_decode_inputs(q, k_pages, v_pages, block_tables, context_lens)
    out = torch.zeros_like(q)          # rows with no key stay exactly zero
    n_kv, total_pages, page, _ = pool_shape(k_pages)
    if n_rows == 0:
        return out, False
    lib = _bind_decode()
    if isinstance(k_pages, dict):
        fn = lib.pa_q8_launch
        pools = (k_pages["q8"], k_pages["s"], v_pages["q8"], v_pages["s"])
    else:
        fn = lib.pa_launch
        pools = (k_pages, v_pages)
    pages_per_seq = block_tables.shape[1]
    with torch.cuda.device(q.device):
        # the split partials (m, l, acc) of long rows, sized from shapes
        # alone
        ws = torch.empty(lib.pa_workspace_floats(
            n_rows, n_heads, n_kv, d, pages_per_seq * page),
            dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), *(t.data_ptr() for t in pools),
                block_tables.data_ptr(), context_lens.data_ptr(),
                out.data_ptr(), ws.data_ptr(), n_rows, n_heads, n_kv, d,
                total_pages, page, pages_per_seq, float(scale),
                int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError("paged_attention launch failed: %s"
                           % lib.pa_error_string(rc).decode())
    return out, True


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    scale=None):
    """Attention of ONE query token per row over a paged KV pool, in one
    launch, on CUDA tensors (the JAX package's ``paged_attention``).

    ``q [n_rows, num_heads, head_dim]``; row r attends to its keys
    ``0 .. context_lens[r] - 1`` through ``block_tables [n_rows,
    pages_per_seq]``, cut at the table's window. Rows with
    ``context_lens == 0`` return zeros; block-table ids are clamped into
    the pool; the ``num_heads // num_kv_heads`` query heads of a group
    share one kv head.

    An fp pool launches K6 (the counterpart of ``_decode_kernel``: bf16
    or f32, contiguous, head_dim a multiple of 8 and <= 256, any page
    size that is a multiple of 8, int32 metadata, at most 16 query heads
    a kv head) and adds one to ``paged_attention.launches``; an int8 pool
    ``{"q8", "s"}`` launches the same kernel decoding each row as ``q8 *
    s`` (head_dim a multiple of 16) and adds one to
    ``paged_attention.launches_q8``. Anything the kernel does not take,
    CPU tensors included, raises ``ValueError``; the plain version,
    :func:`paged_attention_ref`, serves the CPU. A call is sized from
    shapes alone and never waits on the device, so it can be captured in
    a CUDA graph and replayed with new lengths; rows past one key split
    leave partials in an f32 workspace that a second kernel merges in a
    fixed order (:func:`merge_partials_ref` is its plain version): two
    calls on the same inputs give the same bits. Rows of one 16-query
    tile that read the same pages (a prefill chunk's) share one read of
    them (:func:`decode_split` says how a call is cut)."""
    out, launched = _launch_decode(q, k_pages, v_pages, block_tables,
                                   context_lens, scale)
    if isinstance(k_pages, dict):
        paged_attention.launches_q8 += launched
    else:
        paged_attention.launches += launched
    return out


paged_attention.launches = 0               # K6
paged_attention.launches_q8 = 0            # K6 over int8 pools


def decode_split(n_rows: int, n_heads: int, n_kv: int, window: int,
                 device=None) -> int:
    """Keys of one work item (a split) of a K6 call with ``n_rows`` rows,
    ``n_heads`` query and ``n_kv`` kv heads and a block-table window of
    ``window`` keys on the card (``device``, default the current one):
    chosen from the shapes so that the units that walk keys on their own
    (a row, or a 16-query tile of a prefill chunk's rows, a kv head) fill
    the SMs about four times over. Launches nothing."""
    with torch.cuda.device(device):
        return _bind_decode().pa_split(n_rows, n_heads, n_kv, window)


def kv_write_slots(block_tables: torch.Tensor, pos: torch.Tensor,
                   page: int, total_pages: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where a chunk of k/v rows lands in a paged pool.

    ``pos [b, g]`` are the rows' positions, ``block_tables [b, P]`` their
    pages. Rows with ``pos < 0`` or past the block-table window are
    dropped. Returns ``(rows, slots)``: the flat indices (into ``b*g``)
    of the rows kept and their flat slots (into ``total_pages*page``).
    The slots are the same for every layer's pool, so a caller that
    writes many layers computes them once; this is the one place that
    waits on the device, to learn how many rows are kept."""
    window = page * block_tables.shape[1]
    valid = ((pos >= 0) & (pos < window)).reshape(-1)
    safe = pos.clamp(0, window - 1)
    page_id = torch.gather(block_tables.clamp(0, total_pages - 1), 1,
                           (safe // page).long())
    slots = (page_id.long() * page + safe % page).reshape(-1)
    rows = valid.nonzero().reshape(-1)
    return rows, slots[rows]


def kv_scatter(pages, new: torch.Tensor, rows: torch.Tensor,
               slots: torch.Tensor) -> None:
    """Write ``new [b*g, n_kv, d]`` (rows ``rows`` of it) into ``pages``
    ``[n_kv, total_pages, page, d]`` at flat ``slots``, in place. An int8
    pool gets the rows quantized at write time (:func:`_quantize_rows`):
    codes into ``"q8"``, their scales into ``"s"``."""
    n_kv, total_pages, page, d = pool_shape(pages)
    kept = new[rows].transpose(0, 1)               # [n_kv, M, d]
    if isinstance(pages, dict):
        q8, s = _quantize_rows(kept)
        pages["q8"].view(n_kv, total_pages * page, d).index_copy_(
            1, slots, q8)
        pages["s"].view(n_kv, total_pages * page).index_copy_(1, slots, s)
        return
    flat = pages.view(n_kv, total_pages * page, d)
    flat.index_copy_(1, slots, kept.to(pages.dtype))


def paged_kv_write_chunk(k_pages, v_pages, k_new, v_new, block_tables,
                         pos):
    """Scatter a CHUNK of per-row-position k/v rows into paged pools.

    ``k/v_new [b, g, n_kv, d]`` are g tokens per row at positions
    ``pos [b, g]``; ``block_tables [b, pages_per_seq]``. Rows with
    ``pos < 0`` or past the block-table window are DROPPED (idle slots,
    padding). Pools may be fp tensors or int8 ``{"q8", "s"}`` dicts
    (rows quantized at write time, per-row scales in ``"s"``). Unlike
    the JAX version, which returns new pools, this writes the pools IN
    PLACE, so that a step never copies the whole pool; it returns the
    same ``(k_pages, v_pages)`` for the same call shape."""
    n_kv, total_pages, page, d = pool_shape(k_pages)
    b, g = pos.shape
    rows, slots = kv_write_slots(block_tables, pos, page, total_pages)
    kv_scatter(k_pages, k_new.reshape(b * g, n_kv, d), rows, slots)
    kv_scatter(v_pages, v_new.reshape(b * g, n_kv, d), rows, slots)
    return k_pages, v_pages
