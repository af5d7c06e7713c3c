"""The port's ragged paged attention against the JAX package's.

The same numpy inputs go through the JAX ``ragged_paged_attention`` (its
Pallas kernels run in interpret mode, and its XLA composition) and the
port's plain PyTorch version, in f32 on the CPU, over fp pools and over
int8 ``{"q8", "s"}`` pools. Tolerance rtol=atol=2e-4, the repo's own for
ragged attention (tests/test_paged_attention.py): the online softmax of
the kernel and the direct softmax of the composition sum in different
orders. The int8 pool writes are compared exactly: the same codes, and
the same f32 scales to within 1 ulp (both divide an f32 max by 127).
The Hopper kernels themselves are held against the plain version in
tests/test_torch_kernels_cuda.py, on the card.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.incubate.nn.cuda import paged_attention as tpa
from test_torch_kernels_cuda import MIXES, _setup

# tiny shapes: one torch thread a test process (more only contend
# with the other pytest-xdist workers for the cores)
torch.set_num_threads(1)

# the pallas package exports a function of the module's own name
jpa = importlib.import_module(
    "paddle_tpu.incubate.nn.pallas.paged_attention")

TOL = dict(rtol=2e-4, atol=2e-4)

def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_ref_matches_jax_pallas_kernel(mix):
    ql, cl, nh, nkv, pad = MIXES[mix]
    q, kp, vp, bt, cl, ql = _setup(ql, cl, nh, nkv, pad, seed=13)
    want = np.asarray(jpa.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(cl), jnp.asarray(ql), interpret=True, use_kernel=True))
    got = tpa.ragged_paged_attention_ref(*_torch(q, kp, vp, bt, cl, ql))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got.numpy()[int(ql.sum()):], 0.0)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_ref_matches_jax_xla_composition(mix):
    ql, cl, nh, nkv, pad = MIXES[mix]
    q, kp, vp, bt, cl, ql = _setup(ql, cl, nh, nkv, pad, seed=14)
    # use_kernel=False: the jitted wrapper's _xla_ragged_paged_attention
    want = np.asarray(jpa.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(cl), jnp.asarray(ql), use_kernel=False))
    got = tpa.ragged_paged_attention_ref(*_torch(q, kp, vp, bt, cl, ql))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _q8_pools(kp, vp):
    """The same fp pools quantized by each package's own write rule."""
    jk, jv = (jpa.quantize_kv_pages(jnp.asarray(p)) for p in (kp, vp))
    tk, tv = (tpa.quantize_kv_pages(torch.from_numpy(p)) for p in (kp, vp))
    return (jk, jv), (tk, tv)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_q8_ref_matches_jax_pallas_kernel(mix):
    """Over int8 pools (GQA group 2 and idle rows among the mixes) the
    plain version matches ``_ragged_kernel_q8``, interpreted."""
    ql, cl, nh, nkv, pad = MIXES[mix]
    q, kp, vp, bt, cl, ql = _setup(ql, cl, nh, nkv, pad, seed=23)
    (jk, jv), (tk, tv) = _q8_pools(kp, vp)
    want = np.asarray(jpa.ragged_paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(cl),
        jnp.asarray(ql), interpret=True, use_kernel=True))
    got = tpa.ragged_paged_attention_ref(torch.from_numpy(q), tk, tv,
                                         *_torch(bt, cl, ql))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got.numpy()[int(ql.sum()):], 0.0)


@pytest.mark.parametrize("mix", ["mixed", "gqa2"])
def test_q8_ref_matches_jax_xla_composition(mix):
    ql, cl, nh, nkv, pad = MIXES[mix]
    q, kp, vp, bt, cl, ql = _setup(ql, cl, nh, nkv, pad, seed=24)
    (jk, jv), (tk, tv) = _q8_pools(kp, vp)
    want = np.asarray(jpa.ragged_paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(cl),
        jnp.asarray(ql), use_kernel=False))
    got = tpa.ragged_paged_attention_ref(torch.from_numpy(q), tk, tv,
                                         *_torch(bt, cl, ql))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _assert_pools_equal(got, want):
    np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(want["q8"]))
    np.testing.assert_array_max_ulp(got["s"].numpy(), np.asarray(want["s"]),
                                    maxulp=1)


def test_quantize_kv_pages_matches_jax():
    """Codes, scales, and the 1e-8 floor of an all-zero row; values on
    exact half steps of their scale exercise round-half-to-even."""
    rng = np.random.RandomState(25)
    pages = rng.randn(2, 5, 4, 16).astype(np.float32)
    pages[0, 1, 2] = 0.0                                 # floored scale
    pages[1, 3, 0] = np.arange(16) * 0.5 - 3.75          # halves
    pages[1, 3, 0, -1] = 127.0 / 2                       # s = 0.5
    _assert_pools_equal(tpa.quantize_kv_pages(torch.from_numpy(pages)),
                        jpa.quantize_kv_pages(jnp.asarray(pages)))
    q, s = tpa._quantize_rows(torch.from_numpy(pages))
    assert s[0, 1, 2].item() == np.float32(1e-8)
    np.testing.assert_array_equal(                       # ties to even
        q[1, 3, 0, :8].numpy(), np.round(pages[1, 3, 0, :8] / 0.5))
    deq = tpa._dequant(q, s).numpy()
    np.testing.assert_allclose(deq, pages, rtol=0,
                               atol=float(s.max()) / 2 + 1e-7)


def test_q8_paged_kv_write_chunk_matches_jax():
    rng = np.random.RandomState(26)
    n_kv, total_pages, page, d = 2, 9, 4, 16
    b, g = 3, 5
    fp = rng.randn(n_kv, total_pages, page, d).astype(np.float32)
    k_new = rng.randn(b, g, n_kv, d).astype(np.float32)
    v_new = rng.randn(b, g, n_kv, d).astype(np.float32)
    bt = np.asarray([[3, 1], [7, 2], [5, 8]], np.int32)
    pos = np.asarray([[0, 1, 2, 3, 4],
                      [5, -1, 9, 6, -1],
                      [2, 3, 4, 5, 7]], np.int32)
    jk, jv = jpa.paged_kv_write_chunk(
        jpa.quantize_kv_pages(jnp.asarray(fp)),
        jpa.quantize_kv_pages(jnp.asarray(-fp)), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(bt), jnp.asarray(pos))
    tk = tpa.quantize_kv_pages(torch.from_numpy(fp))
    tv = tpa.quantize_kv_pages(torch.from_numpy(-fp))
    gk, gv = tpa.paged_kv_write_chunk(tk, tv, *_torch(k_new, v_new, bt, pos))
    assert gk is tk and gv is tv            # written in place
    _assert_pools_equal(gk, jk)
    _assert_pools_equal(gv, jv)


def test_explicit_row_of_and_q_starts_match_derived():
    ql, cl, nh, nkv, pad = MIXES["padding"]
    q, kp, vp, bt, cl, ql = _setup(ql, cl, nh, nkv, pad, seed=16)
    qs = np.concatenate([[0], np.cumsum(ql)[:-1]]).astype(np.int32)
    row_of = np.full(q.shape[0], -1, np.int32)
    for r in range(len(ql)):
        row_of[qs[r]:qs[r] + ql[r]] = r
    a = tpa.ragged_paged_attention_ref(*_torch(q, kp, vp, bt, cl, ql))
    b = tpa.ragged_paged_attention_ref(
        *_torch(q, kp, vp, bt, cl, ql), q_starts=torch.from_numpy(qs),
        row_of=torch.from_numpy(row_of))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _split_partials(q, kp, vp, bt, cl, ql, cuts):
    """Every token's visible keys of the plain version cut into the
    splits [cuts[j], cuts[j + 1]) (empty ones included): per split its
    largest score m (-inf where it saw no key), l = sum exp(s - m) and
    acc = sum exp(s - m) v, f32, as the kernel's blocks leave them."""
    n_tokens, n_heads, d = q.shape
    n_kv, _, page, _ = kp.shape
    qs = np.concatenate([[0], np.cumsum(ql)[:-1]])
    rows = np.full(n_tokens, -1)
    for r in range(len(ql)):
        rows[qs[r]:qs[r] + ql[r]] = r
    r = np.clip(rows, 0, len(ql) - 1)
    lens = np.where(rows >= 0, cl[r] - ql[r] + np.arange(n_tokens) - qs[r]
                    + 1, 0)
    window = bt.shape[1] * page
    pages = np.clip(bt[r], 0, kp.shape[1] - 1)     # [T, P]
    k = kp[:, pages].reshape(n_kv, n_tokens, window, d)
    v = vp[:, pages].reshape(n_kv, n_tokens, window, d)
    group = n_heads // n_kv
    k, v = (torch.from_numpy(x).repeat_interleave(group, 0).transpose(0, 1)
            for x in (k, v))                       # [T, heads, L, d]
    s = torch.einsum("thd,thld->thl", torch.from_numpy(q), k) * d ** -0.5
    key = torch.arange(window)
    seen = key[None, :] < torch.from_numpy(lens)[:, None]
    m, l, acc = [], [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        mask = (seen & (key >= a) & (key < b))[:, None, :]
        sj = s.masked_fill(~mask, float("-inf"))
        mj = sj.amax(-1)
        p = torch.where(mask, torch.exp(sj - torch.where(
            torch.isfinite(mj), mj, 0.0)[..., None]), 0.0)
        m.append(mj)
        l.append(p.sum(-1))
        acc.append(torch.einsum("thl,thld->thd", p, v))
    return torch.stack(m, -1), torch.stack(l, -1), torch.stack(acc, -2)


@pytest.mark.parametrize("mix", ["mixed", "gqa2"])
def test_merged_split_partials_match_ref_and_jax(mix):
    """The split merge that K4 / K5's second kernel implements
    (``merge_partials_ref``): the plain version's keys cut at arbitrary
    points, empty splits among them, merge back to
    ``ragged_paged_attention_ref`` within 1e-6 in f32, and so match the
    JAX kernel, interpreted."""
    ql, cl, nh, nkv, pad = MIXES[mix]
    q, kp, vp, bt, cl, ql = _setup(ql, cl, nh, nkv, pad, seed=15)
    want = tpa.ragged_paged_attention_ref(*_torch(q, kp, vp, bt, cl, ql))
    for cuts in ([0, 64], [0, 0, 7, 7, 20, 33, 64], [0, 16, 17, 40, 64, 64]):
        got = tpa.merge_partials_ref(
            *_split_partials(q, kp, vp, bt, cl, ql, cuts))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
    jax_out = np.asarray(jpa.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(cl), jnp.asarray(ql), interpret=True, use_kernel=True))
    np.testing.assert_allclose(got.numpy(), jax_out, **TOL)
    np.testing.assert_array_equal(got.numpy()[int(ql.sum()):], 0.0)


def test_token_rows_matches_jax():
    ql = np.asarray([3, 0, 2, 1], np.int32)
    qs = np.asarray([0, 3, 3, 5], np.int32)
    want = np.asarray(jpa._token_rows(jnp.asarray(qs), jnp.asarray(ql), 9))
    got = tpa._token_rows(torch.from_numpy(qs), torch.from_numpy(ql), 9)
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_kv_write_chunk_matches_jax():
    rng = np.random.RandomState(3)
    n_kv, total_pages, page, d = 2, 9, 4, 8
    b, g, P = 3, 5, 2
    kp = rng.randn(n_kv, total_pages, page, d).astype(np.float32)
    vp = rng.randn(n_kv, total_pages, page, d).astype(np.float32)
    k_new = rng.randn(b, g, n_kv, d).astype(np.float32)
    v_new = rng.randn(b, g, n_kv, d).astype(np.float32)
    bt = np.asarray([[3, 1], [7, 2], [5, 8]], np.int32)
    # row 0 in window, row 1 has padding (-1) and a position past the
    # window (P * page = 8), row 2 straddles its two pages
    pos = np.asarray([[0, 1, 2, 3, 4],
                      [5, -1, 9, 6, -1],
                      [2, 3, 4, 5, 7]], np.int32)
    wk, wv = jpa.paged_kv_write_chunk(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(bt), jnp.asarray(pos))
    tk, tv = _torch(kp.copy(), vp.copy())
    gk, gv = tpa.paged_kv_write_chunk(tk, tv, *_torch(k_new, v_new, bt, pos))
    assert gk is tk and gv is tv            # written in place
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    # dropped rows really left their would-be slots alone
    assert (gk.numpy() != kp).any(axis=-1).sum() == n_kv * 12


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "page", "contiguous",
                                 "int64_meta", "group"])
def test_kernel_input_checks_raise(bad):
    q, kp, vp, bt, cl, ql = _setup([1, 3], [5, 3], 4, 4, 0, d=32)
    q, kp, vp, bt, cl, ql = _torch(q, kp, vp, bt, cl, ql)
    qs = torch.tensor([0, 1], dtype=torch.int32)
    if bad == "dtype":
        q, kp, vp = q.half(), kp.half(), vp.half()
    elif bad == "head_dim":
        q = torch.zeros(4, 4, 264)
        kp = vp = torch.zeros(4, 9, 16, 264)
    elif bad == "page":
        kp = vp = torch.zeros(4, 9, 12, 32)
    elif bad == "contiguous":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "int64_meta":
        cl = cl.long()
    elif bad == "group":
        q = torch.zeros(4, 32, 32)
        kp = vp = torch.zeros(1, 9, 16, 32)
    with pytest.raises(ValueError):
        tpa.check_kernel_inputs(q, kp, vp, bt, cl, ql, qs)


def test_kernel_input_checks_accept_engine_inputs():
    q, kp, vp, bt, cl, ql = _torch(*_setup([1, 3], [5, 3], 4, 2, 1))
    qs = torch.tensor([0, 1], dtype=torch.int32)
    tpa.check_kernel_inputs(q, kp, vp, bt, cl, ql, qs)
    k8, v8 = tpa.quantize_kv_pages(kp), tpa.quantize_kv_pages(vp)
    tpa.check_kernel_inputs(q, k8, v8, bt, cl, ql, qs)
    tpa.check_kernel_inputs(q.bfloat16(), k8, v8, bt, cl, ql, qs)


@pytest.mark.parametrize("bad", ["mixed_pools", "q8_dtype", "s_dtype",
                                 "s_shape", "head_dim16", "q_dtype"])
def test_q8_kernel_input_checks_raise(bad):
    q, kp, vp, bt, cl, ql = _torch(*_setup([1, 3], [5, 3], 4, 2, 0, d=32))
    qs = torch.tensor([0, 1], dtype=torch.int32)
    k8, v8 = tpa.quantize_kv_pages(kp), tpa.quantize_kv_pages(vp)
    if bad == "mixed_pools":
        v8 = vp
    elif bad == "q8_dtype":
        k8 = {"q8": k8["q8"].to(torch.uint8), "s": k8["s"]}
    elif bad == "s_dtype":
        v8 = {"q8": v8["q8"], "s": v8["s"].bfloat16()}
    elif bad == "s_shape":
        k8 = {"q8": k8["q8"], "s": k8["s"][..., None]}
    elif bad == "head_dim16":
        q = torch.zeros(4, 4, 40)
        k8 = v8 = tpa.quantize_kv_pages(torch.zeros(2, 9, 16, 40))
    elif bad == "q_dtype":
        q = q.half()
    with pytest.raises(ValueError):
        tpa.check_kernel_inputs(q, k8, v8, bt, cl, ql, qs)
