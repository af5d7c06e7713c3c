"""The port's Hopper kernels against their plain versions.

K4 (ragged paged attention) and K1/K2/K3 (flash attention forward, fused
backward, split backward). These tests need an NVIDIA Hopper GPU
(``cuda`` marker) and skip elsewhere. The file imports neither JAX nor
the JAX package, so it also runs on a machine that has only PyTorch,
from the repository root::

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py

The K4 inputs (``MIXES``, ``_setup``) are shared with
tests/test_torch_paged_attention.py, which holds the plain version
against the JAX package on the CPU. K4 tolerances: rtol=atol=2e-4 in f32
(online against direct softmax, other summation orders), 2e-2 in bf16
(the kernel's output type, one rounding of an f32 result). Flash
tolerances hold each row (a query's out or dq, a key's dk or dv: the last
axis) on its own: the largest |got - want| in the row, in units of that
row's RMS of want, so that the small values of a late causal row count
as much as the large ones of an early row. See ``FLASH_TOL``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.incubate.nn.cuda import flash_attn as fa
from paddle_tpu_torch.incubate.nn.cuda import paged_attention as tpa

# name -> (query_lens, context_lens, n_heads, n_kv, n_pad)
MIXES = {
    "all_decode": ([1, 1, 1], [9, 33, 17], 4, 4, 0),
    "all_prefill": ([7, 20, 5], [7, 20, 5], 4, 4, 0),
    "mixed": ([1, 12, 1, 6], [25, 12, 40, 30], 4, 4, 0),
    "idle_rows": ([1, 0, 8, 0], [14, 0, 8, 0], 4, 4, 0),
    "padding": ([1, 12, 1, 6], [25, 12, 40, 30], 4, 4, 5),
    "gqa2": ([1, 9, 1], [22, 9, 31], 4, 2, 2),
}


def _setup(query_lens, context_lens, n_heads, n_kv, n_pad, d=32, page=16,
           pages_per_seq=4, seed=0):
    rng = np.random.RandomState(seed)
    n_rows = len(query_lens)
    total_pages = n_rows * pages_per_seq + 1
    n_tokens = int(np.sum(query_lens)) + n_pad
    q = rng.randn(n_tokens, n_heads, d).astype(np.float32)
    kp = rng.randn(n_kv, total_pages, page, d).astype(np.float32)
    vp = rng.randn(n_kv, total_pages, page, d).astype(np.float32)
    # shuffled page ids exercise the indirection; the unused tail slots
    # hold out-of-range ids, which both sides clamp into the pool
    bt = (1 + rng.permutation(n_rows * pages_per_seq)
          .reshape(n_rows, pages_per_seq)).astype(np.int32)
    for r, c in enumerate(context_lens):
        bt[r, -(-c // page):] = [-3, total_pages + 7][r % 2]
    ql = np.asarray(query_lens, np.int32)
    cl = np.asarray(context_lens, np.int32)
    return q, kp, vp, bt, cl, ql


def _cuda(arrays, dtype):
    q, kp, vp, bt, cl, ql = [torch.from_numpy(a).cuda() for a in arrays]
    return q.to(dtype), kp.to(dtype), vp.to(dtype), bt, cl, ql


def _need_hopper():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU to build and run the kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_hopper_kernel_matches_ref(mix, dtype):
    _need_hopper()
    ql, cl, nh, nkv, pad = MIXES[mix]
    arrays = _setup(ql, cl, nh, nkv, pad, seed=21)
    q, kp, vp, bt, cl, ql = _cuda(arrays, getattr(torch, dtype))
    before = tpa.ragged_paged_attention.launches
    got = tpa.ragged_paged_attention(q, kp, vp, bt, cl, ql)
    torch.cuda.synchronize()
    assert tpa.ragged_paged_attention.launches == before + 1
    want = tpa.ragged_paged_attention_ref(q, kp, vp, bt, cl, ql)
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert (got[int(ql.sum()):] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_hopper_kernel_head_dims(d):
    _need_hopper()
    ql, cl, nh, nkv, pad = MIXES["padding"]
    arrays = _setup(ql, cl, nh, nkv, pad, d=d, seed=22)
    case = _cuda(arrays, torch.bfloat16)
    got = tpa.ragged_paged_attention(*case)
    want = tpa.ragged_paged_attention_ref(*case)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_hopper_wrapper_raises_instead_of_falling_back():
    _need_hopper()
    ql, cl, nh, nkv, pad = MIXES["mixed"]
    case = _cuda(_setup(ql, cl, nh, nkv, pad), torch.float16)
    before = tpa.ragged_paged_attention.launches
    with pytest.raises(ValueError):
        tpa.ragged_paged_attention(*case)
    assert tpa.ragged_paged_attention.launches == before


# ------------------------------------------------------------ K1, K2, K3
# largest error of a row in units of its RMS (see _row_err). f32: exact
# f32 products summed in other orders (K2's dq by atomics in a changing
# order); read at <= 3.5e-6 on an H100, and 3.1e-4 on dq's first causal
# row, whose exact value is zero. bf16: p and ds rounded to bf16 at a
# running rather than the final row max, and bf16 outputs; read at 0.019
# to 0.035 on an H100, here and in chip_smoke.py, while a 64-key tile left
# out of a late causal row reads 1.6 (test below). lse, f32 from the same
# f32 scores: read at <= 1.9e-6.
FLASH_TOL = {"float32": 1e-3, "bfloat16": 6e-2}
LSE_ATOL = 1e-4
# name -> (b, sq, sk, h): s not a multiple of any tile; sq < sk takes
# the bottom-right causal offset
FLASH_SHAPES = {"ragged": (2, 200, 200, 3), "sq_lt_sk": (2, 77, 200, 3)}


def _flash_inputs(b, sq, sk, h, d, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(s):
        return torch.randn(b, s, h, d, generator=g, device="cuda").to(dtype)

    return mk(sq), mk(sk), mk(sk), mk(sq)          # q, k, v, do


def _head_major(*xs):
    return [x.transpose(1, 2) for x in xs]


def _ref_fwd(q, k, v, causal, scale):
    out, lse = fa.flash_fwd_ref(*_head_major(q, k, v), causal, scale)
    return out.transpose(1, 2), lse[..., 0]


def _ref_bwd(q, k, v, out, lse, do, causal, scale):
    grads = fa.flash_bwd_ref(*_head_major(q, k, v, out), lse[..., None],
                             do.transpose(1, 2), causal, scale)
    return _head_major(*grads)


def _row_err(got, want):
    """Max abs error, and the largest error of a row (the last axis) in
    units of that row's RMS of ``want``, or of 1% of the whole tensor's
    RMS where that is larger: a row whose exact value is zero (dq of the
    first query under causal attention) holds only rounding noise."""
    w = want.float()
    err = (got.float() - w).abs()
    floor = 1e-2 * w.square().mean().sqrt().item() + 1e-30
    rms = w.square().mean(-1, keepdim=True).sqrt().clamp_min(floor)
    return err.max().item(), (err / rms).max().item()


def _assert_close(got, want, tol, what):
    assert bool(torch.isfinite(got).all()), "%s: non-finite" % what
    err, rel = _row_err(got, want)
    # shown with -rP: the readings the limits were set from
    print("%s: max abs err %.3g, %.3g of its row's RMS" % (what, err, rel))
    assert rel <= tol, "%s: max abs err %.3g, %.3g of its row's RMS > %g" \
        % (what, err, rel, tol)


def _assert_lse_close(got, want):
    assert bool(torch.isfinite(got).all()), "lse: non-finite"
    err = (got - want).abs().max().item()
    print("lse: max abs err %.3g" % err)
    assert err <= LSE_ATOL, "lse: max abs err %.3g > %g" % (err, LSE_ATOL)


def test_row_check_rejects_a_dropped_late_tile():
    """The bf16 limit passes a second rounding of the same attention but
    fails one that leaves out a 64-key tile for the last 64 queries of a
    1024-token causal sequence, whose outputs are ~20x smaller than the
    first rows' (plain versions, on the CPU)."""
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(1, 2, 1024, 128, generator=g) for _ in range(3))
    scale = 128 ** -0.5
    want, _ = fa.flash_fwd_ref(*(x.bfloat16() for x in (q, k, v)), True,
                               scale)
    again, _ = fa.flash_fwd_ref(q, k, v, True, scale)
    _assert_close(again.bfloat16(), want, FLASH_TOL["bfloat16"], "rounding")
    keep = torch.ones(1024, dtype=torch.bool)
    keep[896:960] = False              # keys the last 64 queries then miss
    late, _ = fa.flash_fwd_ref(q[:, :, 960:], k[:, :, keep], v[:, :, keep],
                               True, scale)
    broken = torch.cat([again[:, :, :960], late], dim=2).bfloat16()
    rel = _row_err(broken, want)[1]
    print("dropped tile: %.3g of its row's RMS" % rel)
    assert rel > 3 * FLASH_TOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(FLASH_SHAPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_fwd_matches_ref(dtype, d, causal, shape):
    _need_hopper()
    b, sq, sk, h = FLASH_SHAPES[shape]
    q, k, v, _ = _flash_inputs(b, sq, sk, h, d, getattr(torch, dtype))
    scale = d ** -0.5
    before = fa.flash_fwd.launches
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + 1
    want_out, want_lse = _ref_fwd(q, k, v, causal, scale)
    tol = FLASH_TOL[dtype]
    _assert_close(out, want_out, tol, "out")
    _assert_lse_close(lse, want_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["ragged-fused", "ragged-split",
                                   "sq_lt_sk-split"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_matches_ref(dtype, d, causal, route):
    _need_hopper()
    shape, kernel = route.split("-")
    b, sq, sk, h = FLASH_SHAPES[shape]
    q, k, v, do = _flash_inputs(b, sq, sk, h, d, getattr(torch, dtype),
                                seed=1)
    scale = d ** -0.5
    out, lse = _ref_fwd(q, k, v, causal, scale)
    fn = fa.flash_bwd_fused if kernel == "fused" else fa.flash_bwd_split
    before = fn.launches
    got = fn(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = _ref_bwd(q, k, v, out, lse, do, causal, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_close(g, w, FLASH_TOL[dtype], name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_autograd_gqa_strided(dtype):
    """The differentiable entry on q/k/v sliced out of one fused
    [b, s, 3, h, d] projection (strided, no copy), with 4 query heads on
    2 kv heads, against the plain versions on k/v repeated over each
    group, from the same saved out and lse, with dk and dv summed back
    over the group."""
    _need_hopper()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(2)
    b, s, h, hk, d = 2, 150, 4, 2, 64
    qkv = torch.randn(b, s, 3, h, d, generator=g, device="cuda").to(dt)
    q = qkv[:, :, 0].detach().requires_grad_()
    kv = torch.randn(b, s, 2, hk, d, generator=g, device="cuda").to(dt)
    k = kv[:, :, 0].detach().requires_grad_()
    v = kv[:, :, 1].detach().requires_grad_()
    do = torch.randn(b, s, h, d, generator=g, device="cuda").to(dt)
    fwd0, bwd0 = fa.flash_fwd.launches, fa.flash_bwd_fused.launches
    out = fa.flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_fused.launches) == \
        (fwd0 + 1, bwd0 + 1)
    scale = d ** -0.5
    qd, kr, vr = (x.detach().repeat_interleave(h // x.shape[2], dim=2)
                  for x in (q, k, v))
    want_out, _ = _ref_fwd(qd, kr, vr, True, scale)
    saved_out, saved_lse = fa.flash_fwd(qd, kr, vr, True, scale)
    dq, dk, dv = _ref_bwd(qd, kr, vr, saved_out, saved_lse, do, True, scale)
    want = [dq] + [x.float().reshape(b, s, hk, h // hk, d).sum(3)
                   for x in (dk, dv)]
    tol = FLASH_TOL[dtype]
    _assert_close(out, want_out, tol, "out")
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _assert_close(a, w, tol, name)


@pytest.mark.cuda
def test_flash_bwd_route_rule():
    """K2 for sq == sk with sq*d <= 8192*128, K3 otherwise: a short
    square case, sq < sk, and a square case past the length cap."""
    _need_hopper()
    cases = [((1, 128, 128, 2, 64), "fused"), ((1, 64, 128, 2, 64), "split"),
             ((1, 4160, 4160, 1, 256), "split")]
    for (b, sq, sk, h, d), kernel in cases:
        q, k, v, do = _flash_inputs(b, sq, sk, h, d, torch.bfloat16, seed=3)
        scale = d ** -0.5
        out, lse = fa.flash_fwd(q, k, v, True, scale)
        counts = (fa.flash_bwd_fused.launches, fa.flash_bwd_split.launches)
        got = fa.flash_bwd(q, k, v, out, lse, do, True, scale)
        torch.cuda.synchronize()
        grew = (fa.flash_bwd_fused.launches - counts[0],
                fa.flash_bwd_split.launches - counts[1])
        assert grew == ((1, 0) if kernel == "fused" else (0, 1)), (sq, sk, d)
        want = _ref_bwd(q, k, v, out, lse, do, True, scale)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            _assert_close(g, w, FLASH_TOL["bfloat16"], name)


@pytest.mark.cuda
def test_flash_wrapper_raises_instead_of_falling_back():
    _need_hopper()
    counts = (fa.flash_fwd.launches, fa.flash_bwd_fused.launches,
              fa.flash_bwd_split.launches)
    q, k, v, do = _flash_inputs(1, 64, 64, 2, 64, torch.float16)
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k, v, True, 0.125)
    lse = torch.zeros(1, 2, 64, device="cuda")
    with pytest.raises(ValueError):
        fa.flash_bwd(q, k, v, q, lse, do, True, 0.125)
    q, k, v, do = _flash_inputs(1, 64, 64, 2, 96, torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k, v, True, 96 ** -0.5)
    with pytest.raises(ValueError):
        fa.flash_bwd(q, k, v, q, lse, do, True, 96 ** -0.5)
    assert (fa.flash_fwd.launches, fa.flash_bwd_fused.launches,
            fa.flash_bwd_split.launches) == counts
