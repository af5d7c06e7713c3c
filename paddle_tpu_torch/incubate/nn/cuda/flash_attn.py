"""Flash attention forward (K1) and backward (K2 fused, K3 split).

Port of ``paddle_tpu/incubate/nn/pallas/flash_attn.py``. The kernels
(``csrc/flash_attn.cu``) take ``[b, s, h, d]`` views with a unit stride on
``d`` and any other strides, so the training path passes the q/k/v slices
of its fused qkv projection without a copy:

  q [b, sq, h, d], k / v [b, sk, h, d]   bf16 or f32, head_dim 64/128/256
  out [b, sq, h, d]                     the input type
  lse [b, h, sq]                        f32 logsumexp of each query row

Causal masking is bottom-right aligned (query i sees keys <= i + sk - sq);
a row that sees no key gets out 0 and lse -1e30.

K1 takes a ``wgmma`` + TMA kernel for bf16 at head_dim 64 and 128 (the
training path) and the WMMA / FFMA kernel of K2 and K3's design for f32
and head_dim 256; both write the same out and lse.

:func:`flash_fwd`, :func:`flash_bwd_fused`, :func:`flash_bwd_split` and
:func:`flash_bwd` launch the kernels; they take CUDA tensors only and
raise ``ValueError`` on anything else. :func:`flash_attention` is the
differentiable ``[b, s, h, d]`` entry over them (the JAX
``flash_attention``), with GQA by repeating k/v. The plain PyTorch
versions (:func:`flash_fwd_ref`, :func:`flash_bwd_ref`, which work
head-major, ``[..., s, d]``, like the JAX kernels' ``[bh, s, d]``) are
what the kernels are held against; :func:`flash_attention_ref`, the XLA
composition ``_xla_attention`` of the JAX package's functional layer, is
what the functional layer runs for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_ref", "flash_fwd",
           "flash_fwd_ref", "flash_bwd", "flash_bwd_fused",
           "flash_bwd_split", "flash_bwd_ref", "uses_fused_bwd"]

_KERNEL = "flash_attn"
HEAD_DIMS = (64, 128, 256)
NEG_INF = -1e30
# the JAX package's route rule for the fused backward (its dq scratch
# cap, ``_FUSED_BWD_MAX_SEQ_D``): both packages pick K2 or K3 alike
FUSED_BWD_MAX_SEQ_D = 8192 * 128


def uses_fused_bwd(sq: int, sk: int, d: int) -> bool:
    """True when the backward takes K2 (one fused kernel), else K3."""
    return sq == sk and sq * d <= FUSED_BWD_MAX_SEQ_D


# ------------------------------------------------------------ plain versions
def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """[sq, sk] bool, True where query i may see key j (j <= i + sk - sq)."""
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril(sk - sq)


def flash_fwd_ref(q, k, v, causal: bool, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's plain version on head-major ``[..., s, d]`` tensors: returns
    ``(out [..., sq, d], lse [..., sq, 1] f32)``. f32 scores; p is
    rounded to the input type before the p.v product, as the kernel
    does; a row that sees no key gets out 0 and lse -1e30."""
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(s.shape[-2], s.shape[-1], s.device),
                          float("-inf"))
    m = s.amax(-1, keepdim=True)
    seen = torch.isfinite(m)
    p = torch.exp(s - torch.where(seen, m, 0.0))
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("...qk,...kd->...qd", p.to(v.dtype).float(),
                       v.float())
    out = acc / torch.where(l == 0, 1.0, l)
    lse = torch.where(seen, m + torch.log(l), NEG_INF)
    return out.to(q.dtype), lse


def flash_bwd_ref(q, k, v, out, lse, do, causal: bool, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's and K3's plain version on head-major ``[..., s, d]`` tensors,
    from the saved ``lse [..., sq, 1]``: p = exp(s - lse) forced to 0
    outside the mask by a select, delta = rowsum(do * out), ds = p * (dp -
    delta) * scale; p and ds rounded to the input type before the dv, dk
    and dq products. Returns ``(dq, dk, dv)`` in the input type."""
    dt = q.dtype
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    p = torch.exp(s - lse.float())
    if causal:
        p = torch.where(_causal_mask(s.shape[-2], s.shape[-1], s.device),
                        p, 0.0)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    dv = torch.einsum("...qk,...qd->...kd", p.to(dt).float(), do.float())
    dp = torch.einsum("...qd,...kd->...qk", do.float(), v.float())
    ds = (p * (dp - delta) * scale).to(dt).float()
    dk = torch.einsum("...qk,...qd->...kd", ds, q.float())
    dq = torch.einsum("...qk,...kd->...qd", ds, k.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _repeat_kv(q, k, v):
    """GQA/MQA: repeat each kv head over its group of query heads."""
    hq, hk = q.shape[2], k.shape[2]
    if hq == hk:
        return k, v
    if hq % hk:
        raise ValueError("num_heads %d is not a multiple of num_kv_heads %d"
                         % (hq, hk))
    return (k.repeat_interleave(hq // hk, dim=2),
            v.repeat_interleave(hq // hk, dim=2))


def flash_attention_ref(q, k, v, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The JAX functional layer's ``_xla_attention`` on ``[b, s, h, d]``:
    f32 scores, bottom-right causal mask filled with -1e30, softmax cast
    to the value type before the weighted sum. Differentiable by
    autograd; what the CPU path of the functional layer runs."""
    k, v = _repeat_kv(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = _causal_mask(logits.shape[-2], logits.shape[-1],
                            logits.device)
        logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


# ------------------------------------------------------------ kernels
def _check(named, q, k) -> None:
    """Raise ``ValueError`` on anything the kernels do not take: they
    read raw pointers, so device, dtype, shape, head_dim, strides and
    alignment are settled here."""
    if q.device.type != "cuda":
        raise ValueError("flash attention kernels take CUDA tensors, got %s"
                         % q.device)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q, k, v must be [b, s, h, d]")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("flash attention kernels take bf16 or f32, got %s"
                         % q.dtype)
    if d not in HEAD_DIMS:
        raise ValueError("head_dim must be one of %s, got %d"
                         % (HEAD_DIMS, d))
    if sq < 1 or sk < 1:
        raise ValueError("empty sequence: sq=%d sk=%d" % (sq, sk))
    shapes = {"q": (b, sq, h, d), "k": (b, sk, h, d), "v": (b, sk, h, d),
              "out": (b, sq, h, d), "do": (b, sq, h, d)}
    vec = 16 // q.element_size()
    for name, t in named:
        if t.device != q.device:
            raise ValueError("%s is on %s, q on %s"
                             % (name, t.device, q.device))
        if name in ("lse", "delta"):
            if t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq) \
                    or not t.is_contiguous():
                raise ValueError("%s must be contiguous f32 [%d, %d, %d]"
                                 % (name, b, h, sq))
            continue
        if tuple(t.shape) != shapes[name]:
            raise ValueError("%s must be %s, got %s"
                             % (name, shapes[name], tuple(t.shape)))
        if t.dtype != q.dtype:
            raise ValueError("%s is %s, q is %s" % (name, t.dtype, q.dtype))
        if t.stride(3) != 1 or any(t.stride(i) % vec for i in range(3)) \
                or t.data_ptr() % 16:
            raise ValueError("%s needs a unit stride on head_dim, other "
                             "strides in 16-byte steps and a 16-byte "
                             "aligned start" % name)


def _strides(*ts) -> ctypes.Array:
    """(batch, seq, head) element strides of each [b, s, h, d] tensor."""
    vals = [t.stride(i) for t in ts for i in range(3)]
    return (ctypes.c_longlong * len(vals))(*vals)


_lib: Optional[ctypes.CDLL] = None


def _bind() -> ctypes.CDLL:
    """The kernels' library with its C signatures declared (pointers as
    ``c_void_p``: ctypes would cut an undeclared pointer to 32 bits)."""
    global _lib
    if _lib is None:
        lib = _build.load(_KERNEL)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        st = ctypes.POINTER(ctypes.c_longlong)
        lib.fa_fwd.argtypes = [p] * 5 + [st] + [i] * 6 + [f, i, p]
        lib.fa_fwd.restype = i
        lib.fa_bwd.argtypes = [p] * 9 + [st] + [i] * 6 + [f, i, i, p]
        lib.fa_bwd.restype = i
        lib.fa_error_string.argtypes = [i]
        lib.fa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError("%s launch failed: %s"
                           % (what, lib.fa_error_string(rc).decode()))


def flash_fwd(q, k, v, causal: bool, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: ``(out [b, sq, h, d], lse [b, h, sq] f32)``. Launches the
    Hopper kernel (each launch adds one to ``flash_fwd.launches``) or
    raises ``ValueError``."""
    _check((("q", q), ("k", k), ("v", v)), q, k)
    b, sq, h, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    lib = _bind()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), _strides(q, k, v, out),
                        b, h, sq, k.shape[1], d, int(causal), float(scale),
                        int(q.dtype == torch.bfloat16), stream)
    _raise_on(lib, rc, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def _delta(out, do) -> torch.Tensor:
    """rowsum(do * out) in f32, [b, h, sq]: the JAX package also takes
    it outside its kernels."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _launch_bwd(q, k, v, out, lse, do, causal, scale, fused):
    _check((("q", q), ("k", k), ("v", v), ("out", out), ("do", do),
            ("lse", lse)), q, k)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    delta = _delta(out, do)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    # K2 adds every k tile's share of dq into an f32 workspace
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device) \
        if fused else torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _bind()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fa_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        _strides(q, k, v, do, dq, dk, dv), b, h, sq, sk, d,
                        int(causal), float(scale),
                        int(q.dtype == torch.bfloat16), int(fused), stream)
    _raise_on(lib, rc, "flash_bwd_fused" if fused else "flash_bwd_split")
    return dq.to(q.dtype), dk, dv


def flash_bwd_fused(q, k, v, out, lse, do, causal: bool, scale: float):
    """K2: ``(dq, dk, dv)`` in one kernel from the saved ``out`` and
    ``lse [b, h, sq]``. Launches the Hopper kernel (each launch adds one
    to ``flash_bwd_fused.launches``) or raises ``ValueError``. dq is
    summed with atomics, so its last bits change from run to run."""
    grads = _launch_bwd(q, k, v, out, lse, do, causal, scale, fused=True)
    flash_bwd_fused.launches += 1
    return grads


flash_bwd_fused.launches = 0


def flash_bwd_split(q, k, v, out, lse, do, causal: bool, scale: float):
    """K3: the same gradients from two kernels (dk/dv over k tiles, then
    dq over q tiles), no atomics. One call adds one to
    ``flash_bwd_split.launches``; raises ``ValueError`` as K2 does."""
    grads = _launch_bwd(q, k, v, out, lse, do, causal, scale, fused=False)
    flash_bwd_split.launches += 1
    return grads


flash_bwd_split.launches = 0


def flash_bwd(q, k, v, out, lse, do, causal: bool, scale: float):
    """The backward on the JAX package's route: K2 when ``sq == sk`` and
    ``sq * d <= 8192 * 128``, else K3."""
    fn = flash_bwd_fused if uses_fused_bwd(q.shape[1], k.shape[1],
                                           q.shape[3]) else flash_bwd_split
    return fn(q, k, v, out, lse, do, causal, scale)


class _FlashAttention(torch.autograd.Function):
    """K1 forward; K2 or K3 backward from the saved (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        # autograd may hand over an expanded or strided gradient
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do.contiguous(),
                               ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention on ``[b, s, h, d]`` tensors, differentiable through
    the backward kernels; CUDA tensors only. k/v may have fewer heads
    (GQA/MQA: they are repeated over each group, and autograd sums their
    gradients back). The default scale is ``d ** -0.5``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    k, v = _repeat_kv(q, k, v)
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale))
