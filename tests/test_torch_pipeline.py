"""The port's compiled pipeline (``paddle_tpu_torch/distributed/pipeline``
over a ``Ring`` of CPU devices) against the JAX package's
``CompiledPipeline`` on 2 and 4 of the virtual CPU devices that
tests/conftest.py sets up, on the same numpy parameters and batches.

Two models: the contract of
``tests/test_pipeline_device_transport.py::TestCompiledPipeline``
(``tanh(h @ W + b)`` stages, MSE loss, 3 SGD steps), and a tiny version
of ``bench.py``'s multichip transformer (2 blocks a stage, embeddings
through ``pre_fn``, a tied-in head loss over ``extra_params``), whose
PyTorch side is ``paddle_tpu_torch/models/pipeline_gpt.py``, which
``chip_smoke.py`` drives at full width. The loss of every step and every parameter after it are held
at rtol 1e-5 (atol 1e-6 for parameters: biases start at zero and move by
learning-rate-sized steps), which also holds the gradients to the
learning rate's scale; ``loss_and_grads`` is held against the port's own
first step (its loss, and the step's update over the learning rate).
Also: the ring shift's plain version and its backward (the shift by
``size - 1``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.distributed.pipeline import CompiledPipeline as JaxPipeline
from paddle_tpu_torch.distributed import Ring
from paddle_tpu_torch.distributed.pipeline import (CompiledPipeline,
                                                   ring_shift)
from paddle_tpu_torch.incubate.nn.cuda import ring as kring
from paddle_tpu_torch.models import pipeline_gpt
from paddle_tpu_torch.optimizer import SGD

LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


def _assert_same_params(jpipe, tpipe, what):
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(jpipe.params),
                                   jax.tree_util.tree_leaves(tpipe.params))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   err_msg="%s stacked leaf %d" % (what, i),
                                   **PARAM_TOL)
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(jpipe.extra),
                                   jax.tree_util.tree_leaves(tpipe.extra))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   err_msg="%s extra leaf %d" % (what, i),
                                   **PARAM_TOL)


def _run_both(jpipe, tpipe, x, y, steps, what):
    """``steps`` SGD steps of both pipelines; returns the port's losses."""
    losses = []
    for i in range(steps):
        jl = float(jpipe.step(x, y))
        losses.append(float(tpipe.step(x, y)))
        assert abs(losses[-1] - jl) <= LOSS_RTOL * abs(jl), \
            (what, i, losses[-1], jl)
        _assert_same_params(jpipe, tpipe, "%s step %d" % (what, i))
    return losses


# ------------------------------------------- the tanh / MSE contract
def _jax_stage(p, h):
    return jnp.tanh(h @ p[0] + p[1])


def _torch_stage(p, h):
    return torch.tanh(h @ p[0] + p[1])


@pytest.mark.parametrize("S", [2, 4])
def test_tanh_pipeline_matches_jax(S):
    M, mb, d, lr = 4, 2, 8, 0.1
    rng = np.random.RandomState(0)
    stacked = [(rng.randn(S, d, d) * 0.4).astype(np.float32),
               (rng.randn(S, d) * 0.1).astype(np.float32)]
    x = rng.randn(M * mb, d).astype(np.float32)
    y = rng.randn(M * mb, d).astype(np.float32)
    jpipe = JaxPipeline(_jax_stage, stacked,
                        lambda _e, h, ym: jnp.mean((h - ym) ** 2),
                        num_stages=S, num_micro=M,
                        optimizer=pt.optimizer.SGD(learning_rate=lr))
    tpipe = CompiledPipeline(_torch_stage, stacked,
                             lambda _e, h, ym: ((h - ym) ** 2).mean(),
                             num_stages=S, num_micro=M, optimizer=SGD(lr),
                             devices=["cpu"] * S)
    # loss_and_grads is the step without its update: the first step moves
    # every parameter by -lr times those gradients
    loss, grads, _ = tpipe.loss_and_grads(x, y)
    before = tpipe.params
    assert float(loss) == _run_both(jpipe, tpipe, x, y, 1, "tanh S=%d" % S)[0]
    for i, (b, a) in enumerate(zip(before, tpipe.params)):
        want = torch.stack([g[i].detach() for g in grads])
        torch.testing.assert_close((b - a) / lr, want, rtol=1e-4, atol=1e-5,
                                   msg="stage grads leaf %d" % i)
    _run_both(jpipe, tpipe, x, y, 2, "tanh S=%d" % S)


# -------------------------------------- bench.py's transformer, tiny
def _jax_fns(heads):
    """bench.py _multichip_result's stage_fn / pre_fn / loss_fn."""
    def _ln(x, wt, bs):
        mu = x.mean(-1, keepdims=True)
        var = ((x - mu) ** 2).mean(-1, keepdims=True)
        return (x - mu) * jax.lax.rsqrt(var + 1e-5) * wt + bs

    def _blk(p, x):
        ln1w, ln1b, wqkv, bqkv, wo, bo, ln2w, ln2b, w1, b1, w2, b2 = p
        b, s, d = x.shape
        hd = d // heads
        q, k, v = jnp.split(_ln(x, ln1w, ln1b) @ wqkv + bqkv, 3, axis=-1)

        def sp(t):
            return t.reshape(b, s, heads, hd).transpose(0, 2, 1, 3)

        att = (sp(q) @ sp(k).transpose(0, 1, 3, 2)) * (1.0 / np.sqrt(hd))
        att = jnp.where(np.tril(np.ones((s, s), bool)), att, -1e9)
        o = (jax.nn.softmax(att, -1) @ sp(v)).transpose(0, 2, 1, 3)
        x = x + o.reshape(b, s, d) @ wo + bo
        z = _ln(x, ln2w, ln2b)
        return x + jax.nn.gelu(z @ w1 + b1) @ w2 + b2

    def stage_fn(params, x):
        for i in range(params[0].shape[0]):
            x = _blk([a[i] for a in params], x)
        return x

    def pre_fn(ex, ids):
        return ex["wte"][ids] + ex["wpe"][None, :]

    def loss_fn(ex, hh, ym):
        z = _ln(hh, ex["lnfw"], ex["lnfb"]) @ ex["head"]
        lp = jax.nn.log_softmax(z.astype(jnp.float32), -1)
        return -jnp.take_along_axis(lp, ym[..., None], -1).mean()

    return stage_fn, pre_fn, loss_fn


@pytest.mark.parametrize("S", [2, 4])
def test_tiny_bench_transformer_matches_jax(S):
    hidden, heads, vocab, seq, B, M, mb, lr = 32, 4, 64, 8, 2, 4, 1, 0.01
    blocks, extra, rng = pipeline_gpt.weights(S * B, hidden, vocab, seq)
    stacked = pipeline_gpt.stack(blocks, S)
    ids = rng.integers(0, vocab, (M * mb, seq))
    labels = rng.integers(0, vocab, (M * mb, seq))
    jstage, jpre, jloss = _jax_fns(heads)
    jpipe = JaxPipeline(jstage, stacked, jloss, num_stages=S, num_micro=M,
                        optimizer=pt.optimizer.SGD(learning_rate=lr),
                        extra_params=extra, pre_fn=jpre)
    tstage, tpre, tloss = pipeline_gpt.functions(heads)
    tpipe = CompiledPipeline(tstage, stacked, tloss, num_stages=S,
                             num_micro=M, optimizer=SGD(lr),
                             extra_params=extra, pre_fn=tpre,
                             devices=Ring(["cpu"] * S))
    x, y = ids.astype(np.int32), labels.astype(np.int32)
    for i in range(2):
        jl = float(jpipe.step(x, y))
        tl = float(tpipe.step(torch.from_numpy(ids),
                              torch.from_numpy(labels)))
        assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (i, tl, jl)
        _assert_same_params(jpipe, tpipe, "transformer S=%d step %d"
                            % (S, i))


# ---------------------------------------------------------- ring shift
@pytest.mark.parametrize("size", [1, 2, 4])
def test_ring_shift_and_its_backward(size):
    ring = Ring(["cpu"] * size)
    xs = [torch.full((2, 3), float(r)).requires_grad_() for r in
          range(size)]
    before = kring.shift.launches
    out = ring_shift(xs, ring)
    for r in range(size):
        assert torch.equal(out[r], xs[(r - 1) % size].detach())
    # the backward sends rank j's gradient to rank j - 1: the shift by
    # size - 1
    gs = [torch.full((2, 3), 10.0 + r) for r in range(size)]
    grads = torch.autograd.grad(out, xs, gs)
    for r in range(size):
        assert torch.equal(grads[r], gs[(r + 1) % size])
    assert kring.shift.launches == before
    ref = ring.shift_ref([x.detach() for x in xs], size - 1)
    for r in range(size):
        assert torch.equal(ref[r], xs[(r + 1) % size].detach())


def test_ring_rules():
    assert Ring(["cpu"] * 3).size == 3
    with pytest.raises(ValueError):
        Ring([])
    with pytest.raises(ValueError):
        Ring(["cpu", "meta"])


def test_pipeline_options_not_ported():
    stacked = [np.zeros((2, 4, 4), np.float32)]
    for kw in (dict(dp=2), dict(bucket_bytes=1 << 20)):
        with pytest.raises(NotImplementedError):
            CompiledPipeline(_torch_stage, stacked, lambda e, h, y: h.sum(),
                             num_stages=2, num_micro=2, devices=["cpu"] * 2,
                             **kw)
