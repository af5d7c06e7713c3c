"""The port's row norms (K7's plain versions and the dispatching,
differentiable entries) against the JAX package's.

The same numpy inputs (f32) go through the JAX package's Pallas norm
kernels, run in interpret mode off the TPU as tests/test_pallas_kernels.py
runs them, and through the port on the CPU. Forward: rtol=1e-6 with
atol=1e-6 on outputs of unit scale (f32 statistics summed in other
orders; the absolute part covers LayerNorm's x - mu where x is within
rounding of mu). Gradients against ``jax.vjp`` of the same kernels: 1e-5
(the vjp of the same composition, summed in other orders). The Hopper
kernel itself is held against the plain versions in
tests/test_torch_kernels_cuda.py, on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.incubate.nn.functional import fused_ops as jfused
from paddle_tpu.incubate.nn.pallas import norms as pnorms
from paddle_tpu_torch.incubate.nn.cuda import norms as tn
from paddle_tpu_torch.incubate.nn.functional import fused_ops as tfused

FWD = dict(rtol=1e-6, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)


def _inputs(n, d, seed):
    rng = np.random.RandomState(seed)
    x = (1.5 * rng.randn(n, d) + 0.3).astype(np.float32)
    w = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    b = (0.1 * rng.randn(d)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("n", [40, 600])     # one block; three, ragged
def test_rms_ref_matches_pallas_kernel(n, bias):
    x, w, b = _inputs(n, 256, seed=n + bias)
    jb = jnp.asarray(b) if bias else None
    want = np.asarray(pnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), jb,
                                      eps=1e-5))
    got = tn.rms_norm_ref(*map(torch.from_numpy, (x, w)),
                          torch.from_numpy(b) if bias else None, 1e-5)
    np.testing.assert_allclose(got.numpy(), want, **FWD)


@pytest.mark.parametrize("n", [40, 600])
def test_ln_ref_matches_pallas_kernel(n):
    x, w, b = _inputs(n, 128, seed=7 + n)
    want = np.asarray(pnorms.layer_norm(*map(jnp.asarray, (x, w, b)),
                                        eps=1e-5))
    got = tn.layer_norm_ref(*map(torch.from_numpy, (x, w, b)), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, **FWD)


def test_dispatch_takes_the_plain_version_on_the_cpu():
    x, w, b = map(torch.from_numpy, _inputs(9, 64, seed=3))
    counts = (tn.rms_norm.launches, tn.layer_norm.launches)
    torch.testing.assert_close(tfused.rms_norm(x, w, b, 1e-6),
                               tn.rms_norm_ref(x, w, b, 1e-6), rtol=0, atol=0)
    torch.testing.assert_close(tfused.layer_norm(x, w, b, 1e-5),
                               tn.layer_norm_ref(x, w, b, 1e-5), rtol=0,
                               atol=0)
    assert (tn.rms_norm.launches, tn.layer_norm.launches) == counts


@pytest.mark.parametrize("kind", ["rms", "rms_bias", "ln"])
def test_grads_match_jax_vjp(kind):
    x, w, b = _inputs(12, 128, seed=11)
    g = np.random.RandomState(12).randn(12, 128).astype(np.float32)
    if kind == "ln":
        jfn = lambda x_, w_, b_: pnorms.layer_norm(x_, w_, b_, eps=1e-5)
        tfn = lambda x_, w_, b_: tfused.layer_norm(x_, w_, b_, 1e-5)
        args = (x, w, b)
    elif kind == "rms_bias":
        jfn = lambda x_, w_, b_: pnorms.rms_norm(x_, w_, b_, eps=1e-5)
        tfn = lambda x_, w_, b_: tfused.rms_norm(x_, w_, b_, 1e-5)
        args = (x, w, b)
    else:
        jfn = lambda x_, w_: pnorms.rms_norm(x_, w_, eps=1e-5)
        tfn = lambda x_, w_: tfused.rms_norm(x_, w_, None, 1e-5)
        args = (x, w)
    out, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    tout = tfn(*leaves)
    got = torch.autograd.grad(tout, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), **FWD)
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), **GRAD)


def test_grad_of_x_only():
    """A weight that needs no gradient gets none, and x's matches."""
    x, w, _ = _inputs(5, 64, seed=13)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w)
    tfused.rms_norm(tx, tw, None, 1e-6).square().sum().backward()
    want = jax.grad(lambda a: jnp.sum(pnorms.rms_norm(
        a, jnp.asarray(w), eps=1e-6) ** 2))(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), **GRAD)
    assert tw.grad is None


@pytest.mark.parametrize("with_norm_bias", [False, True])
def test_fused_rms_norm_bias_residual_matches_jax(monkeypatch,
                                                  with_norm_bias):
    """``bias`` then ``residual`` are added before the norm, and the sum
    comes back beside the output; the JAX side takes its Pallas kernel
    (forced, interpreted)."""
    monkeypatch.setattr(jfused, "_FORCE_PALLAS", True)
    rng = np.random.RandomState(17)
    x, r = (rng.randn(2, 7, 128).astype(np.float32) for _ in range(2))
    bias, w, nb = (rng.randn(128).astype(np.float32) for _ in range(3))
    nbias = nb if with_norm_bias else None
    jout, jsum = jfused.fused_rms_norm(
        pt.to_tensor(x), pt.to_tensor(w),
        None if nbias is None else pt.to_tensor(nbias), epsilon=1e-6,
        bias=pt.to_tensor(bias), residual=pt.to_tensor(r))
    tout, tsum = tfused.fused_rms_norm(
        torch.from_numpy(x), torch.from_numpy(w),
        None if nbias is None else torch.from_numpy(nbias), epsilon=1e-6,
        bias=torch.from_numpy(bias), residual=torch.from_numpy(r))
    np.testing.assert_allclose(tsum.numpy(), jsum.numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(tout.numpy(), jout.numpy(), **FWD)


def test_fused_rms_norm_plain_and_leading_axis_match_jax():
    """No residual returns the output alone; ``begin_norm_axis=1``
    normalises over the trailing two axes (the JAX XLA path)."""
    rng = np.random.RandomState(19)
    x = rng.randn(3, 4, 32).astype(np.float32)
    w1 = rng.randn(32).astype(np.float32)
    w2 = rng.randn(4, 32).astype(np.float32)
    want = jfused.fused_rms_norm(pt.to_tensor(x), pt.to_tensor(w1),
                                 epsilon=1e-6)
    got = tfused.fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w1),
                                epsilon=1e-6)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD)
    want = jfused.fused_rms_norm(pt.to_tensor(x), pt.to_tensor(w2),
                                 epsilon=1e-6, begin_norm_axis=1)
    got = tfused.fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w2),
                                epsilon=1e-6, begin_norm_axis=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD)


def _to(a, dtype):
    """numpy f32 -> (JAX array, torch tensor) of ``dtype``, rounded alike
    (both round to nearest even from the same f32 values)."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rms", "rms_bias", "ln"])
def test_fused_ref_matches_jax_fused(monkeypatch, kind, dtype):
    """K7's fused plain version (``bias`` added to x, then ``residual``,
    then the norm) against the JAX ``fused_rms_norm`` (its Pallas kernel,
    forced and interpreted) / ``fused_layer_norm``: the sum bitwise, the
    output within FWD."""
    monkeypatch.setattr(jfused, "_FORCE_PALLAS", True)
    rng = np.random.RandomState(23 + len(kind))
    y, r = (rng.randn(2, 7, 128).astype(np.float32) for _ in range(2))
    bias, w, nb = (rng.randn(128).astype(np.float32) for _ in range(3))
    (jy, ty), (jr, tr), (jbias, tbias), (jw, tw), (jnb, tnb) = (
        _to(a, dtype) for a in (y, r, bias, w, nb))
    if kind == "ln":
        jout, jsum = jfused.fused_layer_norm(
            pt.to_tensor(jy), pt.to_tensor(jw), pt.to_tensor(jnb),
            epsilon=1e-5, bias=pt.to_tensor(jbias),
            residual=pt.to_tensor(jr))
        tout, tsum = tn.layer_norm_ref(ty, tw, tnb, 1e-5, bias=tbias,
                                       residual=tr)
    else:
        with_nb = kind == "rms_bias"
        jout, jsum = jfused.fused_rms_norm(
            pt.to_tensor(jy), pt.to_tensor(jw),
            pt.to_tensor(jnb) if with_nb else None, epsilon=1e-5,
            bias=pt.to_tensor(jbias), residual=pt.to_tensor(jr))
        tout, tsum = tn.rms_norm_ref(ty, tw, tnb if with_nb else None,
                                     1e-5, bias=tbias, residual=tr)
    assert tsum.dtype == tout.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(tsum.float().numpy(),
                                  np.asarray(jsum.numpy(), np.float32))
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.numpy(), np.float32), **FWD)


def test_fused_layer_norm_matches_jax():
    """The port's ``fused_layer_norm`` against the JAX one: with a
    residual (the sum back, bitwise), without one, with
    ``begin_norm_axis=1`` (the trailing two axes) and with no weight or
    norm bias."""
    rng = np.random.RandomState(29)
    x, r = (rng.randn(3, 4, 32).astype(np.float32) for _ in range(2))
    w2, b2 = (rng.randn(4, 32).astype(np.float32) for _ in range(2))
    w1, b1, bias = (rng.randn(32).astype(np.float32) for _ in range(3))
    jt, tt = pt.to_tensor, torch.from_numpy
    jout, jsum = jfused.fused_layer_norm(jt(x), jt(w1), jt(b1), 1e-5,
                                         bias=jt(bias), residual=jt(r))
    tout, tsum = tfused.fused_layer_norm(tt(x), tt(w1), tt(b1), 1e-5,
                                         bias=tt(bias), residual=tt(r))
    np.testing.assert_array_equal(tsum.numpy(), jsum.numpy())
    np.testing.assert_allclose(tout.numpy(), jout.numpy(), **FWD)
    for args, kw in (((w1, b1), {}), ((w2, b2), dict(begin_norm_axis=1)),
                     ((None, None), {})):
        want = jfused.fused_layer_norm(
            jt(x), *(None if a is None else jt(a) for a in args), 1e-5, **kw)
        got = tfused.fused_layer_norm(
            tt(x), *(None if a is None else tt(a) for a in args), 1e-5, **kw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD)


def _ragged_step(cfg, dt, seed):
    """One ragged step's inputs for an adapter of ``cfg``: a prefill row
    of 9 tokens, a decode row at position 13, two tokens of padding;
    pools of type ``dt``."""
    g = torch.Generator().manual_seed(seed)
    n_kv = getattr(cfg, "num_kv_heads", cfg.num_heads)
    L, hd, page, n_pages = cfg.num_layers, cfg.head_dim, 8, 8
    ql = torch.tensor([9, 1], dtype=torch.int32)
    cl = torch.tensor([9, 14], dtype=torch.int32)
    qs = torch.tensor([0, 9], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (12,), generator=g,
                         dtype=torch.int32)
    pos = torch.tensor(list(range(9)) + [13, -1, -1], dtype=torch.int32)
    row_of = torch.tensor([0] * 9 + [1, -1, -1], dtype=torch.int32)
    bt = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32)

    def pools():
        return [0.5 * torch.randn(n_kv, n_pages, page, hd, generator=g)
                .to(dt) for _ in range(L)]
    return (toks, pos, row_of, qs, ql, cl), pools(), pools(), bt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gpt", "llama"])
def test_adapter_fused_updates_equal_unfused(monkeypatch, arch, dtype):
    """The adapters' ``_forward`` with each residual update fused into
    the norm after it gives bitwise the logits and K/V of the unfused
    composition (the update's adds as PyTorch runs them, then the norm):
    the fused form rounds each add as PyTorch does."""
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         generation, gpt_tiny, llama_tiny)

    dt = getattr(torch, dtype)
    model = (GPTForCausalLM(gpt_tiny(), device="cpu", dtype=dt)
             if arch == "gpt" else
             LlamaForCausalLM(llama_tiny(), device="cpu", dtype=dt))
    ad = model.decode_adapter()
    meta, kp, vp, bt = _ragged_step(model.config, dt, seed=31)
    got = ad.ragged_chunk(ad.weights, *meta, [p.clone() for p in kp],
                          [p.clone() for p in vp], bt)
    ln, rms = generation._ln, generation._rms
    monkeypatch.setattr(
        generation, "_add_ln", lambda y, bias, res, w, b, eps: (
            ln(res + (y if bias is None else y + bias), w, b, eps),
            res + (y if bias is None else y + bias)))
    monkeypatch.setattr(generation, "_add_rms", lambda y, res, w, eps: (
        rms(res + y, w, eps), res + y))
    want = ad.ragged_chunk(ad.weights, *meta, [p.clone() for p in kp],
                           [p.clone() for p in vp], bt)
    live = meta[1] >= 0
    assert torch.equal(got[0][live], want[0][live])
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_fused_grads_are_the_plain_composition(kind):
    """With a gradient wanted, the fused entries differentiate the plain
    composition (PyTorch's adds, then the norm's vjp), as the JAX
    package's custom vjp does: the same gradients within GRAD (the
    norm's vjp and the sum's cotangent are added in another order)."""
    rng = np.random.RandomState(37)
    y, r = (rng.randn(5, 64).astype(np.float32) for _ in range(2))
    bias, w, nb = (rng.randn(64).astype(np.float32) for _ in range(3))
    g_out, g_sum = (rng.randn(5, 64).astype(np.float32) for _ in range(2))
    fused = tfused.fused_layer_norm if kind == "ln" else \
        tfused.fused_rms_norm
    ref = tn.layer_norm_ref if kind == "ln" else tn.rms_norm_ref

    def grads(fn):
        leaves = [torch.from_numpy(a).requires_grad_()
                  for a in (y, r, bias, w, nb)]
        out, s = fn(*leaves)
        return torch.autograd.grad((out, s), leaves, (
            torch.from_numpy(g_out), torch.from_numpy(g_sum)))

    got = grads(lambda y_, r_, b_, w_, nb_: fused(
        y_, w_, nb_, 1e-5, bias=b_, residual=r_))
    want = grads(lambda y_, r_, b_, w_, nb_: ref(
        y_, w_, nb_, 1e-5, bias=b_, residual=r_))
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), e.numpy(), **GRAD)
