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
