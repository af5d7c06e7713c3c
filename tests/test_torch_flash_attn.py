"""The port's flash attention against the JAX package's, on the CPU.

The Pallas kernels K1 (``_flash_fwd``), K2 (``_flash_bwd_fused``) and K3
(``_flash_bwd_split``) run interpreted with 64-row blocks, as the JAX
package's own tests run them; the port's plain versions (what the
Hopper kernels are held against on the card, and, for the composition,
what the functional layer runs for CPU tensors) see the same numpy
inputs. Everything is f32, and
every comparison holds within atol 1e-4 (the same arithmetic summed in
other orders; blockwise online softmax against a direct one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.nn.functional.flash_attention import _xla_attention
from paddle_tpu.incubate.nn.pallas import flash_attn as jfa
import paddle_tpu_torch
from paddle_tpu_torch.incubate.nn.cuda import flash_attn as fa
from paddle_tpu_torch.incubate.nn.cuda.flash_attn import flash_attention_ref
from paddle_tpu_torch.incubate.nn.functional import (
    flash_attention, scaled_dot_product_attention)

# tiny shapes: one torch thread a test process (more only contend
# with the other pytest-xdist workers for the cores)
torch.set_num_threads(1)

ATOL = 1e-4
BLOCK = 64
# name -> (bh, sq, sk, d)
SHAPES = {"square": (4, 128, 128, 32), "sq_lt_sk": (4, 64, 128, 32)}


def _arrays(shape, seed=0):
    bh, sq, sk, d = shape
    rng = np.random.RandomState(seed)
    return [rng.randn(bh, s, d).astype(np.float32) for s in (sq, sk, sk, sq)]


def _t(*arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fwd_ref_matches_pallas_k1(shape, causal):
    q, k, v, _ = _arrays(SHAPES[shape])
    scale = q.shape[-1] ** -0.5
    out, lse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, scale, BLOCK, BLOCK, True)
    got_out, got_lse = fa.flash_fwd_ref(*_t(q, k, v), causal, scale)
    _close(got_out, out, "out")
    _close(got_lse, lse, "lse")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bwd_ref_matches_pallas_k2_k3(shape, causal):
    q, k, v, do = _arrays(SHAPES[shape], seed=1)
    scale = q.shape[-1] ** -0.5
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    out, lse = jfa._flash_fwd(jq, jk, jv, causal, scale, BLOCK, BLOCK, True)
    want = fa.flash_bwd_ref(*_t(q, k, v, out, lse, do), causal, scale)
    nq, nk = q.shape[1] // BLOCK, k.shape[1] // BLOCK
    kernels = [jfa._flash_bwd_split]
    if q.shape[1] == k.shape[1]:
        kernels.append(jfa._flash_bwd_fused)
    for kernel in kernels:
        grads = kernel(jq, jk, jv, out, lse, jdo, causal, scale, BLOCK,
                       BLOCK, nq, nk, True)
        for name, g, w in zip(("dq", "dk", "dv"), grads, want):
            _close(w, g, "%s %s" % (kernel.__name__, name))


@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_128_two_key_tiles_match_pallas_k2_k3(causal):
    """head_dim 128 at s 256, two of the Hopper backward's 128-key tiles:
    the plain backward, its pre-pass's plain version (``delta_ref``) and
    the autograd entry's CPU path against the interpreted K2 and K3 and
    the JAX package's delta."""
    rng = np.random.RandomState(4)
    b, s, h, d = 1, 256, 2, 128
    q, k, v, do = (rng.randn(b, s, h, d).astype(np.float32)
                   for _ in range(4))

    def bh(x):                                   # [b, s, h, d] -> [bh, s, d]
        return x.transpose(0, 2, 1, 3).reshape(b * h, s, d)

    def bshd(x):                                 # and back
        return np.asarray(x).reshape(b, h, s, d).transpose(0, 2, 1, 3)

    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(bh(x)) for x in (q, k, v, do))
    out, lse = jfa._flash_fwd(jq, jk, jv, causal, scale, BLOCK, BLOCK, True)
    n = s // BLOCK
    wants = [kernel(jq, jk, jv, out, lse, jdo, causal, scale, BLOCK, BLOCK,
                    n, n, True)
             for kernel in (jfa._flash_bwd_fused, jfa._flash_bwd_split)]
    got = fa.flash_bwd_ref(*_t(bh(q), bh(k), bh(v), out, lse, bh(do)),
                           causal, scale)
    for kname, want in zip(("K2", "K3"), wants):
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            _close(g, w, "%s %s" % (kname, name))
    want_delta = jnp.sum(jdo * out, axis=-1).reshape(b, h, s)
    _close(fa.delta_ref(*_t(bshd(out), do)), want_delta, "delta")
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    o, _ = flash_attention(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    _close(o.detach(), bshd(out), "out")
    for name, g, w in zip(("dq", "dk", "dv"), grads, wants[0]):
        _close(g, bshd(w), "autograd " + name)


def test_route_rule_matches_jax():
    """The port picks K2 exactly where the JAX package picks its fused
    backward."""
    for sq, sk, d in ((1024, 1024, 128), (8192, 8192, 128),
                      (8320, 8320, 128), (4096, 4096, 256),
                      (4224, 4224, 256), (512, 1024, 64)):
        want = sq == sk and sq * d <= jfa._FUSED_BWD_MAX_SEQ_D
        assert fa.uses_fused_bwd(sq, sk, d) == want, (sq, sk, d)


def _jax_vjp(q, k, v, do, causal):
    def f(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, causal=causal, block_q=BLOCK,
                                   block_k=BLOCK, interpret=True)

    out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    return (out,) + vjp(jnp.asarray(do))


@pytest.mark.parametrize("case", ["causal", "full", "gqa_causal"])
def test_flash_attention_autograd_matches_pallas_vjp(case):
    """The port's functional flash attention on CPU tensors (the plain
    composition under autograd), against jax.vjp through the interpreted
    Pallas kernels and against the XLA composition."""
    causal = case != "full"
    hk = 2 if case == "gqa_causal" else 4
    rng = np.random.RandomState(2)
    b, s, h, d = 2, 128, 4, 32
    q = rng.randn(b, s, h, d).astype(np.float32)
    k, v = (rng.randn(b, s, hk, d).astype(np.float32) for _ in range(2))
    do = rng.randn(b, s, h, d).astype(np.float32)
    want = _jax_vjp(q, k, v, do, causal)
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out, _ = flash_attention(tq, tk, tv, causal=causal)
    got = (out,) + torch.autograd.grad(out, (tq, tk, tv),
                                       torch.from_numpy(do))
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        _close(g.detach(), w, name)
    kr, vr = (np.repeat(x, h // hk, axis=2) for x in (k, v))
    _close(out.detach(), _xla_attention(q, kr, vr, causal), "vs xla")


@pytest.mark.parametrize("causal", [True, False])
def test_functional_cpu_path_is_the_xla_composition(causal):
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 96, 4, 32).astype(np.float32) for _ in range(3))
    want = _xla_attention(q, k, v, causal)
    out, none = flash_attention(*_t(q, k, v), causal=causal)
    assert none is None
    _close(out, want)
    _close(scaled_dot_product_attention(*_t(q, k, v), is_causal=causal),
           want)
    _close(fa.flash_attention_ref(*_t(q, k, v), causal=causal), want)


def test_functional_refuses_what_is_not_ported():
    """An explicit ``attn_mask`` is not ported and raises. Attention
    dropout is: it drops the attention output, as the JAX package does
    (``tests/test_torch_dropout.py`` holds it against the JAX model)."""
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        scaled_dot_product_attention(q, q, q, attn_mask=torch.ones(8, 8))
    x = torch.randn(3, 1, 8, 2, 32,
                    generator=torch.Generator().manual_seed(0))
    plain = flash_attention_ref(x[0], x[1], x[2], causal=True)
    paddle_tpu_torch.seed(1)
    out, _ = flash_attention(x[0], x[1], x[2], dropout=0.1, causal=True)
    keep = out != 0
    assert 0 < int(keep.sum()) < out.numel()
    assert torch.equal(out[keep], (plain / 0.9)[keep])
    paddle_tpu_torch.seed(1)
    again, _ = flash_attention(x[0], x[1], x[2], dropout=0.1, causal=True)
    assert torch.equal(again, out)
    out, _ = flash_attention(q, q, q, dropout=0.1, training=False)
    assert out.shape == q.shape


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only: on the CPU they raise
    and launch nothing (the functional layer picks the plain version)."""
    q = torch.zeros(1, 8, 2, 64)
    lse = torch.zeros(1, 2, 8)
    counts = (fa.flash_fwd.launches, fa.flash_bwd_fused.launches,
              fa.flash_bwd_split.launches, fa.bwd_preprocess.launches)
    calls = [lambda: fa.flash_fwd(q, q, q, True, 0.125),
             lambda: fa.flash_bwd(q, q, q, q, lse, q, True, 0.125),
             lambda: fa.bwd_preprocess(q, q, lse),
             lambda: fa.flash_bwd_split(q, q, q, q, lse, q, True, 0.125),
             lambda: fa.flash_attention(q, q, q, causal=True)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert (fa.flash_fwd.launches, fa.flash_bwd_fused.launches,
            fa.flash_bwd_split.launches, fa.bwd_preprocess.launches) == counts
