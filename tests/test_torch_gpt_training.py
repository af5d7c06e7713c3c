"""The port's GPT training path against the JAX package's, on gpt_tiny.

Both packages hold the same f32 weights (the JAX model's, carried over by
``params_from_paddle_tpu``) and see the same numpy batch. On the CPU the
port's attention is the plain composition (``_xla_attention``), which is
also what the JAX model runs off the TPU. Tolerances, all f32 over 2
layers with the same arithmetic in other summation orders:

* losses: rtol 1e-5;
* parameters after 1 and 3 AdamW steps: atol 2e-6 (lr 1e-3; the update
  is a ratio m / sqrt(v) of equal-but-reordered sums);
* with bf16 first moments: atol 5e-5 (a moment that lands on a bf16
  rounding boundary may round the other way, moving that step's update
  by ~lr * 2^-8 * |m / sqrt(v)|; it stays 20x below one step's lr);
* the key third of each ``qkv_proj.bias``: atol 3 * lr. Its gradient is
  zero in exact arithmetic (softmax does not change when one constant is
  added to every score of a row), so both packages feed Adam rounding
  noise there, and m / (sqrt(v) + eps) of noise is anything in [-1, 1];
* the global gradient norm: rtol 1e-6;
* with ``recompute`` (``recompute_interval`` 1, 2 and -2): every gradient
  against the JAX model's under ``jax.checkpoint``, rtol 1e-4 and atol
  1e-6, and against the same port model without recompute, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.observability.health import grad_health as jax_grad_health
from paddle_tpu_torch.convert import (opt_state_from_paddle_tpu,
                                      params_from_paddle_tpu)
from paddle_tpu_torch.fusion import lm_head_chunked_ce
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.observability import grad_health
from paddle_tpu_torch.optimizer import AdamW

B, S = 2, 64


def _batch(vocab, seed=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, S)).astype(np.int64)
    labels = rng.randint(0, vocab, (B, S)).astype(np.int64)
    labels[0, :5] = -100                  # ignored tokens
    return ids, labels


def _np(x):
    return np.array(x, copy=True)


def _jax_model(chunks, seed=11, **kw):
    pt.seed(seed)
    return pt.models.GPTForCausalLM(pt.models.gpt_tiny(
        dropout=0.0, attention_dropout=0.0, lm_ce_chunks=chunks, **kw))


def _port_model(jm, chunks):
    tm = GPTForCausalLM(gpt_tiny(lm_ce_chunks=chunks), device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(
        {k: v.numpy() for k, v in jm.state_dict().items()}))
    return tm


@pytest.mark.parametrize("chunks", [0, 4])
def test_forward_loss_matches_jax(chunks):
    jm = _jax_model(chunks)
    tm = _port_model(jm, chunks)
    ids, labels = _batch(tm.config.vocab_size)
    want = float(jm(pt.to_tensor(ids), labels=pt.to_tensor(labels)).numpy())
    got = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    logits = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(logits.detach().numpy(),
                               jm(pt.to_tensor(ids)).numpy(), atol=1e-5)


@pytest.mark.parametrize("interval", [1, 2, -2])
def test_recompute_grads_match_jax(interval):
    jm = _jax_model(4, recompute=True, recompute_interval=interval)
    ids, labels = _batch(jm.config.vocab_size)
    loss = jm(pt.to_tensor(ids), labels=pt.to_tensor(labels))
    loss.backward()
    want = {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}
    got = {}
    for recompute in (True, False):
        tm = GPTForCausalLM(gpt_tiny(lm_ce_chunks=4, recompute=recompute,
                                     recompute_interval=interval),
                            device="cpu")
        tm.load_state_dict(params_from_paddle_tpu(
            {k: v.numpy() for k, v in jm.state_dict().items()}))
        names, params = zip(*tm.named_parameters())
        tl = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        got[recompute] = dict(zip(names, (g.numpy() for g in
                                          torch.autograd.grad(tl, params))))
    assert got[True].keys() == want.keys()
    for n, w in want.items():
        np.testing.assert_allclose(got[True][n], w, rtol=1e-4, atol=1e-6,
                                   err_msg=n)
        np.testing.assert_array_equal(got[True][n], got[False][n], err_msg=n)


def test_chunked_ce_invariant_to_chunk_count():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 24, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(50, 16).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 50, (2, 24)))
    labels[1, 3:9] = -100
    results = []
    for chunks in (1, 2, 3, 8):
        xc, wc = x.clone().requires_grad_(), w.clone().requires_grad_()
        loss = lm_head_chunked_ce(xc, wc, labels, chunks,
                                  transpose_weight=True)
        loss.backward()
        results.append((loss.item(), xc.grad, wc.grad))
    # against the plain cross entropy of the full logits
    xf, wf = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.nn.functional.cross_entropy(
        (xf @ wf.t()).reshape(-1, 50), labels.reshape(-1))
    want.backward()
    for loss, gx, gw in results:
        np.testing.assert_allclose(loss, want.item(), rtol=1e-6)
        torch.testing.assert_close(gx, xf.grad, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(gw, wf.grad, rtol=1e-5, atol=1e-6)


def test_grad_health_matches_jax():
    rng = np.random.RandomState(5)
    grads = [rng.randn(*s).astype(np.float32)
             for s in ((3, 7), (11,), (2, 3, 4))]
    want = float(jax_grad_health([jnp.asarray(g) for g in grads]))
    got = grad_health([torch.from_numpy(g) for g in grads])
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    grads[1][4] = np.nan
    assert not torch.isfinite(grad_health(
        [torch.from_numpy(g) for g in grads]))


OPT = {"factored_f32": dict(factored_v=True, moment_dtype="float32"),
       "factored_bf16": dict(factored_v=True, moment_dtype="bfloat16")}
PARAM_ATOL = {"factored_f32": 2e-6, "factored_bf16": 5e-5}


def _jax_state(jm):
    return {k: _np(v.numpy()) for k, v in jm.state_dict().items()}


def _port_state(tm):
    return {k: v.detach().numpy().copy() for k, v in tm.state_dict().items()}


def _steps(kind):
    """step() then run_steps(2) in each package: per package, the loss
    and parameters after step 1 and after step 3."""
    jm = _jax_model(4)
    tm = _port_model(jm, 4)
    ids, labels = _batch(tm.config.vocab_size)
    jopt = pt.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                              parameters=jm.parameters(), **OPT[kind])
    jstep = pt.jit.TrainStep(jm, jopt, grad_clip_norm=1.0)
    tstep = TrainStep(tm, AdamW(learning_rate=1e-3, weight_decay=0.01,
                                **OPT[kind]), grad_clip_norm=1.0,
                      device="cpu")
    jb = (pt.to_tensor(ids), pt.to_tensor(labels))
    jl1 = float(jstep(*jb).numpy())
    jp1 = _jax_state(jm)
    jl3 = float(jstep.run_steps(2, *jb).numpy())
    tl1 = float(tstep(ids, labels))
    tp1 = _port_state(tm)
    tl3 = float(tstep.run_steps(2, ids, labels))
    return (jl1, jp1, jl3, _jax_state(jm)), (tl1, tp1, tl3, _port_state(tm))


@pytest.mark.parametrize("kind", sorted(OPT))
def test_train_steps_match_jax(kind):
    (jl1, jp1, jl3, jp3), (tl1, tp1, tl3, tp3) = _steps(kind)
    np.testing.assert_allclose(tl1, jl1, rtol=1e-5)
    np.testing.assert_allclose(tl3, jl3, rtol=1e-5)
    assert tl3 < tl1                      # same batch: the loss falls
    for want, got in ((jp1, tp1), (jp3, tp3)):
        _assert_params_close(got, want, PARAM_ATOL[kind])


def _assert_params_close(got, want, atol, lr=1e-3):
    for k, v in want.items():
        g = got[k]
        if k.endswith("attn.qkv_proj.bias"):
            h = v.shape[0] // 3               # [q | k | v] thirds
            np.testing.assert_allclose(g[h:2 * h], v[h:2 * h], atol=3 * lr,
                                       err_msg=k + " (key third)")
            g, v = np.delete(g, np.s_[h:2 * h]), np.delete(v, np.s_[h:2 * h])
        np.testing.assert_allclose(g, v, atol=atol, err_msg=k)


def test_resume_from_jax_state():
    """Two JAX steps, then the third step of each package from the JAX
    run's parameters and optimizer state."""
    jm = _jax_model(4)
    ids, labels = _batch(jm.config.vocab_size)
    jopt = pt.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                              parameters=jm.parameters(), factored_v=True,
                              moment_dtype="bfloat16")
    jstep = pt.jit.TrainStep(jm, jopt, grad_clip_norm=1.0)
    jstep.run_steps(2, pt.to_tensor(ids), pt.to_tensor(labels))
    params2 = _jax_state(jm)
    state2 = {k: [_np(e) for e in v] if isinstance(v, (list, tuple))
              else _np(v) for k, v in jstep.opt_state.items()}
    want = float(jstep(pt.to_tensor(ids), pt.to_tensor(labels)).numpy())
    want_params = _jax_state(jm)

    tm = GPTForCausalLM(gpt_tiny(lm_ce_chunks=4), device="cpu")
    tstep = TrainStep(tm, AdamW(learning_rate=1e-3, weight_decay=0.01,
                                factored_v=True, moment_dtype="bfloat16"),
                      grad_clip_norm=1.0, device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(params2))
    tstep.restore_state(opt_state_from_paddle_tpu(state2))
    assert tstep.opt_state["m"][0].dtype == torch.bfloat16
    assert float(tstep.opt_state["t"]) == 2.0
    got = float(tstep(ids, labels))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params_close(_port_state(tm), want_params,
                         PARAM_ATOL["factored_bf16"])


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        GPTForCausalLM(gpt_tiny())
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    with pytest.raises(RuntimeError):
        TrainStep(tm, AdamW())
