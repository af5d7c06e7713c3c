"""The port's training options against the JAX package's, on gpt_tiny:
learning-rate schedulers, 8-bit Adam moments, gradient merge, the health
policies, ``TrainStep.run_steps_stream`` and ``ChunkPrefetcher``.

Each JAX reference run (a compiled ``TrainStep``) is built once per
module in a fixture and shared by the tests that read it. Both packages
hold the same f32 weights and see the same numpy batches. Tolerances:

* schedulers: exact (both are the same Python float arithmetic);
* losses rtol 1e-5 and parameters ``PARAM_ATOL`` of
  ``test_torch_gpt_training.py`` (f32 factored moments: 2e-6; the key
  third of each ``qkv_proj.bias`` at 3 lr, as there), under a schedule
  and with gradient merge;
* the 8-bit codes without noise: bitwise, and the absmax too. Three
  8-bit AdamW updates with the JAX noise swapped in, on the same
  parameters and gradients: parameters within 1e-5 (read 1.2e-7) and
  the codes equal in all but ``Q8_CODE_FRACTION`` of them, each within
  one code (read: all equal; the f32 moments before the encoding may
  differ in the last bit, fused multiply-adds against JAX's separate
  roundings, which can move a value across a code boundary of ``scale *
  |x / absmax| ** 0.25``);
* the same in a TrainStep on gpt_tiny: losses rtol 1e-5; parameters
  within 1e-5 in all but ``Q8_PARAM_FRACTION`` of them and all within 3
  lr; codes equal in all but ``Q8_MODEL_CODE_FRACTION``. Here the
  gradients differ in their summation order, and a gradient that cancels
  to a few Adam eps (the tied head's rows of tokens that are not in the
  batch) keeps only a few correct digits, which the dense 8-bit second
  moment turns into an update of another size and the 4th-root
  companding into codes up to 12 apart (read after three steps: 168 of
  560640 parameters beyond 1e-5, at most 1.3e-4; 1041 of 1125376 codes
  differ);
* the skip policy: every parameter and state entry bitwise unchanged.
"""
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.observability import health as jax_health
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu.optimizer.optimizers import _q8_dequantize as jax_deq
from paddle_tpu.optimizer.optimizers import _q8_quantize as jax_q8
from paddle_tpu_torch.convert import (opt_state_from_paddle_tpu,
                                      params_from_paddle_tpu)
from paddle_tpu_torch.jit import ChunkPrefetcher, TrainStep
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.observability import health
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.optimizer import lr
from paddle_tpu_torch.optimizer.optimizers import (_q8_dequantize,
                                                   _q8_quantize)

# tiny shapes: one torch thread a test process (more only contend
# with the other pytest-xdist workers for the cores)
torch.set_num_threads(1)

B, S = 2, 64
LR = 1e-3
PARAM_ATOL = 2e-6           # test_torch_gpt_training.py, factored_f32
Q8_PARAM_ATOL = 1e-5
Q8_CODE_FRACTION = 1e-3
Q8_MODEL_CODE_FRACTION = 2e-3
Q8_PARAM_FRACTION = 1e-3
Q8_PARAM_BOUND = 3 * LR


# ------------------------------------------------------------ schedulers
SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(64, 10, learning_rate=1.0),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, 0.93),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, 0.05),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, 0.1),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, 25, power=2.0),
    "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(
        0.1, 13, end_lr=1e-3, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.1, 10, 0.0, 0.1),
    "LinearWarmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, 30), 10, 1e-3, 0.1),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([10, 30],
                                                 [0.1, 0.05, 0.01]),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, 25, eta_min=1e-3),
    "StepDecay": lambda m: m.StepDecay(0.1, 7, 0.5),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, [5, 20, 40], 0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.1, patience=2, cooldown=1, factor=0.5, threshold=1e-3),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, 50),
    "OneCycleLR_linear": lambda m: m.OneCycleLR(0.1, 50,
                                                anneal_strategy="linear"),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, 5, mode="triangular2"),
    "CyclicLR_exp": lambda m: m.CyclicLR(0.01, 0.1, 4, 6,
                                         mode="exp_range", exp_gamma=0.97),
    "LinearLR": lambda m: m.LinearLR(0.1, 20),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, 5, T_mult=2, eta_min=1e-4),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.1, lambda e: 0.97),
}


def _metric(i):
    """ReduceOnPlateau's metric sequence: falls, stalls, falls again."""
    return 10.0 - i if i < 8 or 20 <= i < 30 else 3.0 + 0.01 * (i % 3)


def _run(sched, steps, start=0):
    out = []
    for i in range(start, start + steps):
        out.append(sched())
        if isinstance(sched, (lr.ReduceOnPlateau, jax_lr.ReduceOnPlateau)):
            sched.step(_metric(i))
        else:
            sched.step()
    return out


def test_every_scheduler_is_ported():
    names = {n for n in jax_lr.__all__ if n != "LRScheduler"}
    assert len(names) == 17
    assert names == {n for n in lr.__all__ if n != "LRScheduler"}
    assert names <= {n.split("_")[0] for n in SCHEDULERS}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_jax(name):
    want = _run(SCHEDULERS[name](jax_lr), 60)
    got = _run(SCHEDULERS[name](lr), 60)
    assert got == want
    assert len(set(got)) > 1


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_state_dict_resumes(name):
    ref = SCHEDULERS[name](lr)
    first = _run(ref, 20)
    again = SCHEDULERS[name](lr)
    again.set_state_dict(ref.state_dict())
    assert _run(again, 40, start=20) == _run(ref, 40, start=20)
    jax_ref = SCHEDULERS[name](jax_lr)
    assert _run(jax_ref, 60) == first + _run(SCHEDULERS[name](lr), 60)[20:]


def test_optimizers_take_a_scheduler():
    sched = lr.StepDecay(0.1, 2, 0.5)
    for opt in (AdamW(sched), SGD(sched)):
        assert opt.get_lr() == 0.1
        with pytest.raises(RuntimeError, match="LRScheduler"):
            opt.set_lr(0.2)
    sched.step()
    sched.step()
    assert AdamW(sched).get_lr() == 0.05
    params = [torch.ones(3)]
    new, _ = SGD(sched).update(params, [torch.ones(3)], {})
    np.testing.assert_array_equal(new[0].numpy(), np.full(3, 0.95,
                                                           np.float32))
    opt = AdamW(0.1)
    opt.set_lr(0.2)
    assert opt.get_lr() == 0.2


# ---------------------------------------------------------- shared runs
def _batch(vocab, seed=3, batch=B):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (batch, S)).astype(np.int64)
    labels = rng.randint(0, vocab, (batch, S)).astype(np.int64)
    labels[0, :5] = -100                  # ignored tokens
    return ids, labels


def _jax_model(seed=11):
    pt.seed(seed)
    return pt.models.GPTForCausalLM(pt.models.gpt_tiny(
        dropout=0.0, attention_dropout=0.0, lm_ce_chunks=4))


def _port_model(jm):
    tm = GPTForCausalLM(gpt_tiny(lm_ce_chunks=4), device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(
        {k: v.numpy() for k, v in jm.state_dict().items()}))
    return tm


def _np(x):
    return np.array(x, copy=True)


def _jax_params(jm):
    return {k: _np(v.numpy()) for k, v in jm.state_dict().items()}


def _port_params(tm):
    return {k: v.detach().numpy().copy() for k, v in tm.state_dict().items()}


def _jax_state(step):
    return {k: [_np(e) for e in v] if isinstance(v, (list, tuple))
            else _np(v) for k, v in step.opt_state.items()}


def _host(e):
    """A state entry on the host (bf16 as f32: exact)."""
    return (e.float() if e.dtype == torch.bfloat16 else e).numpy().copy()


def _port_state(step):
    return {k: [_host(e) for e in v] if isinstance(v, list) else _host(v)
            for k, v in step.opt_state.items()}


def _assert_params_close(got, want, atol):
    for k, v in want.items():
        g = got[k]
        if k.endswith("attn.qkv_proj.bias"):
            h = v.shape[0] // 3               # [q | k | v] thirds
            np.testing.assert_allclose(g[h:2 * h], v[h:2 * h], atol=3 * LR,
                                       err_msg=k + " (key third)")
            g, v = np.delete(g, np.s_[h:2 * h]), np.delete(v, np.s_[h:2 * h])
        np.testing.assert_allclose(g, v, atol=atol, err_msg=k)


def _sched(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(LR, 6), 2, 1e-4, LR)


def _scaled_loss(model, ids, labels, scale):
    """The LM loss times ``scale[0]`` (inf makes a non-finite step)."""
    return model(ids, labels=labels) * scale[0]


@pytest.fixture(scope="module")
def sched_runs():
    """Both packages: AdamW (f32 factored moments) under LinearWarmup(
    CosineAnnealingDecay), step() x 2 with scheduler.step() between,
    then run_steps_stream(3) on three fresh batches. Returns per package
    the losses, the parameters after each stage, the scheduler."""
    jm = _jax_model()
    tm = _port_model(jm)
    vocab = tm.config.vocab_size
    batches = [_batch(vocab, seed=s) for s in (3, 4)]
    stacked = [np.stack(x) for x in zip(*(_batch(vocab, seed=s)
                                         for s in (5, 6, 7)))]
    out = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            sched = _sched(jax_lr)
            step = pt.jit.TrainStep(jm, pt.optimizer.AdamW(
                learning_rate=sched, weight_decay=0.01,
                parameters=jm.parameters(), factored_v=True),
                grad_clip_norm=1.0)
            run = (lambda *b: float(step(*(pt.to_tensor(x)
                                           for x in b)).numpy()))
            stream = (lambda *b: float(step.run_steps_stream(3, *b)
                                       .numpy()))
            params = lambda: _jax_params(jm)     # noqa: E731
        else:
            sched = _sched(lr)
            step = TrainStep(tm, AdamW(sched, weight_decay=0.01,
                                       factored_v=True),
                             grad_clip_norm=1.0, device="cpu")
            run = lambda *b: float(step(*b))          # noqa: E731
            stream = lambda *b: float(step.run_steps_stream(3, *b))  # noqa
            params = lambda: _port_params(tm)    # noqa: E731
        losses, snaps, lrs = [], [], []
        for b in batches:
            lrs.append(sched())
            losses.append(run(*b))
            snaps.append(params())
            sched.step()
        losses.append(stream(*stacked))
        snaps.append(params())
        out[pkg] = (losses, snaps, sched, lrs)
    return out


def test_scheduled_steps_match_jax(sched_runs):
    (jl, jp, jsched, jlrs), (tl, tp, tsched, tlrs) = (sched_runs["jax"],
                                                      sched_runs["port"])
    assert tlrs == jlrs and len(set(tlrs)) == 2
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for want, got in zip(jp, tp):
        _assert_params_close(got, want, PARAM_ATOL)
    assert tsched.state_dict() == jsched.state_dict()
    assert tsched.last_epoch == 5


def test_stream_takes_the_schedule_and_restores_it_on_failure():
    tm = GPTForCausalLM(gpt_tiny(lm_ce_chunks=4), device="cpu")
    sched = _sched(lr)
    step = TrainStep(tm, AdamW(sched), device="cpu")
    seen = []
    update = step.optimizer.update
    step.optimizer.update = lambda p, g, s, lr, **kw: (
        seen.append(lr), update(p, g, s, lr=lr, **kw))
    stacked = [np.stack(x) for x in zip(*(_batch(1024, seed=s)
                                         for s in (5, 6, 7)))]
    step.run_steps_stream(3, *stacked)
    want = [float(np.float32(v)) for v in _run(_sched(lr), 3)]
    assert seen == want
    before = sched.state_dict()
    bad = [a.copy() for a in stacked]
    bad[0][2, 0, 0] = 10 ** 6                 # out of the vocabulary
    with pytest.raises(IndexError):
        step.run_steps_stream(3, *bad)
    assert sched.state_dict() == before
    step.run_steps_stream(3, *stacked, lrs=np.full(3, 1e-4, np.float32))
    assert seen[-3:] == [float(np.float32(1e-4))] * 3
    assert sched.state_dict() == before


def test_stream_argument_errors_match_jax():
    tm = GPTForCausalLM(gpt_tiny(lm_ce_chunks=4), device="cpu")
    step = TrainStep(tm, AdamW(LR), device="cpu", accumulate_steps=2)
    ids, labels = _batch(1024, batch=4)
    with pytest.raises(ValueError, match=r"run_steps_stream\(3\): stacked "
                       r"arrays need leading dim 3, got \(2, 4, 64\)"):
        step.run_steps_stream(3, np.stack([ids, ids]), np.stack([labels,
                                                                 labels]))
    with pytest.raises(ValueError, match=r"lrs must have shape \(2,\), "
                       r"got \(3,\)"):
        step.run_steps_stream(2, np.stack([ids, ids]),
                              np.stack([labels, labels]), lrs=[1.0] * 3)
    with pytest.raises(ValueError, match="gradient merge: batch dim 3 is "
                       "not divisible by accumulate_steps=2"):
        step.run_steps_stream(2, np.stack([ids[:3]] * 2),
                              np.stack([labels[:3]] * 2))
    with pytest.raises(ValueError, match="run_steps_stream needs n >= 1"):
        step.run_steps_stream(0, ids, labels)


def test_run_steps_holds_the_learning_rate():
    tm = GPTForCausalLM(gpt_tiny(lm_ce_chunks=4), device="cpu")
    sched = _sched(lr)
    step = TrainStep(tm, AdamW(sched), device="cpu")
    seen = []
    update = step.optimizer.update
    step.optimizer.update = lambda p, g, s, lr, **kw: (
        seen.append(lr), update(p, g, s, lr=lr, **kw))
    step.run_steps(3, *_batch(1024))
    assert seen == [sched()] * 3 and sched.last_epoch == 0


# ------------------------------------------------------- gradient merge
@pytest.fixture(scope="module")
def merge_runs():
    """Both packages, accumulate_steps=2 over batches of 4: two steps;
    the losses and the parameters after each."""
    jm = _jax_model()
    tm = _port_model(jm)
    batches = [_batch(tm.config.vocab_size, seed=s, batch=4) for s in (3, 4)]
    kw = dict(weight_decay=0.01, factored_v=True)
    jstep = pt.jit.TrainStep(jm, pt.optimizer.AdamW(
        learning_rate=LR, parameters=jm.parameters(), **kw),
        grad_clip_norm=1.0, accumulate_steps=2)
    tstep = TrainStep(tm, AdamW(LR, **kw), grad_clip_norm=1.0,
                      accumulate_steps=2, device="cpu")
    out = {"jax": ([], []), "port": ([], [])}
    for b in batches:
        out["jax"][0].append(float(jstep(*(pt.to_tensor(x)
                                           for x in b)).numpy()))
        out["jax"][1].append(_jax_params(jm))
        out["port"][0].append(float(tstep(*b)))
        out["port"][1].append(_port_params(tm))
    return out


def test_gradient_merge_matches_jax(merge_runs):
    (jl, jp), (tl, tp) = merge_runs["jax"], merge_runs["port"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for want, got in zip(jp, tp):
        _assert_params_close(got, want, PARAM_ATOL)


def test_gradient_merge_is_the_mean_of_the_micro_batches():
    """accumulate_steps=2 on a batch of 4 gives the loss and (f32)
    gradients of the mean over its two halves."""
    tm = GPTForCausalLM(gpt_tiny(lm_ce_chunks=4), device="cpu")
    ids, labels = (torch.from_numpy(x) for x in _batch(1024, batch=4))
    step = TrainStep(tm, AdamW(LR), accumulate_steps=2, device="cpu")
    loss, grads = step._loss_and_grads((ids, labels))
    ps = list(tm.parameters())
    halves = [torch.autograd.grad(tm(ids[i:i + 2], labels=labels[i:i + 2]),
                                  ps) for i in (0, 2)]
    losses = [tm(ids[i:i + 2], labels=labels[i:i + 2]) for i in (0, 2)]
    assert loss.dtype == torch.float32
    torch.testing.assert_close(loss, (losses[0] + losses[1]).detach() / 2,
                               rtol=0, atol=0)
    for g, a, b in zip(grads, *halves):
        torch.testing.assert_close(g, (a + b) / 2, rtol=0, atol=0)


def test_gradient_merge_refuses_a_batch_that_does_not_divide():
    tm = GPTForCausalLM(gpt_tiny(lm_ce_chunks=4), device="cpu")
    step = TrainStep(tm, AdamW(LR), accumulate_steps=2, device="cpu")
    ids, labels = _batch(1024, batch=3)
    with pytest.raises(ValueError, match="gradient merge: batch dim 3 is "
                       "not divisible by accumulate_steps=2"):
        step(ids, labels)


# --------------------------------------------------------------- health
@pytest.fixture
def policy():
    """Set both packages' health policy for the steps a test builds."""
    def set_policy(p):
        health.configure(p)
        jax_health.configure(p)
    yield set_policy
    set_policy("off")


SCALES = (np.ones(1, np.float32), np.full(1, np.inf, np.float32),
          np.ones(1, np.float32))


@pytest.fixture(scope="module")
def skip_runs():
    """Both packages under the skip policy, with a ``loss_fn`` whose loss
    is multiplied by inf on step 2 of 3: parameters and optimizer state
    after each step, and the warnings."""
    health.configure("skip")
    jax_health.configure("skip")
    try:
        jm = _jax_model()
        tm = _port_model(jm)
        ids, labels = _batch(tm.config.vocab_size)
        kw = dict(weight_decay=0.01, factored_v=True,
                  moment_dtype="bfloat16")
        jstep = pt.jit.TrainStep(
            jm, pt.optimizer.AdamW(learning_rate=LR,
                                   parameters=jm.parameters(), **kw),
            loss_fn=_scaled_loss, grad_clip_norm=1.0)
        tstep = TrainStep(tm, AdamW(LR, **kw), loss_fn=_scaled_loss,
                          grad_clip_norm=1.0, device="cpu")
        out = {"jax": ([], [], []), "port": ([], [], [])}
        for scale in SCALES:
            for pkg, step, params, state in (
                    ("jax", jstep, lambda: _jax_params(jm), _jax_state),
                    ("port", tstep, lambda: _port_params(tm), _port_state)):
                with warnings.catch_warnings(record=True) as w:
                    warnings.simplefilter("always")
                    if pkg == "jax":
                        step(pt.to_tensor(ids), pt.to_tensor(labels),
                             pt.to_tensor(scale))
                    else:
                        step(ids, labels, scale)
                out[pkg][0].append(params())
                out[pkg][1].append(state(step))
                out[pkg][2].append([str(x.message) for x in w])
    finally:
        health.configure("off")
        jax_health.configure("off")
    return out


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        for x, y in zip(*((v if isinstance(v, list) else [v])
                          for v in (a[k], b[k]))):
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_skip_keeps_params_and_state_as_jax_does(skip_runs):
    for pkg in ("jax", "port"):
        params, states, warned = skip_runs[pkg]
        for k in params[0]:
            np.testing.assert_array_equal(params[1][k], params[0][k],
                                          err_msg="%s %s" % (pkg, k))
        assert all(not np.array_equal(params[2][k], params[1][k])
                   for k in params[0] if k.endswith(".weight"))
        _assert_state_equal(states[1], states[0])
        assert float(states[2]["t"]) == 2.0
        assert warned[0] == [] and warned[2] == []
        assert len(warned[1]) == 1 and "non-finite grad at step 1" in \
            warned[1][0] and "update discarded" in warned[1][0]
    for want, got in zip(skip_runs["jax"][0], skip_runs["port"][0]):
        _assert_params_close(got, want, 5e-5)     # bf16 m: PARAM_ATOL


def test_raise_policy_raises(policy):
    policy("raise")
    tm = GPTForCausalLM(gpt_tiny(lm_ce_chunks=4), device="cpu")
    step = TrainStep(tm, AdamW(LR), loss_fn=_scaled_loss, device="cpu")
    ids, labels = _batch(1024)
    step(ids, labels, SCALES[0])
    with pytest.raises(health.NonFiniteError,
                       match="non-finite grad at step 1"):
        step(ids, labels, SCALES[1])


def test_warn_policy_warns_and_applies_the_update(policy):
    policy("warn")
    tm = GPTForCausalLM(gpt_tiny(lm_ce_chunks=4), device="cpu")
    step = TrainStep(tm, AdamW(LR), loss_fn=_scaled_loss, device="cpu")
    ids, labels = _batch(1024)
    before = _port_params(tm)
    with pytest.warns(UserWarning, match="non-finite grad at step 0.*"
                      "policy=warn"):
        step(ids, labels, SCALES[1])
    after = _port_params(tm)
    assert float(step.opt_state["t"]) == 1.0
    assert any(not np.array_equal(after[k], before[k]) for k in before)


def test_policy_is_captured_when_the_step_is_built(policy):
    policy("skip")
    tm = GPTForCausalLM(gpt_tiny(lm_ce_chunks=4), device="cpu")
    step = TrainStep(tm, AdamW(LR), loss_fn=_scaled_loss, device="cpu")
    policy("off")
    ids, labels = _batch(1024)
    before = _port_params(tm)
    with pytest.warns(UserWarning):
        health.configure("warn")
        step(ids, labels, SCALES[1])
    assert float(step.opt_state["t"]) == 0.0
    for k, v in before.items():
        np.testing.assert_array_equal(_port_params(tm)[k], v)


def test_stream_records_every_gnorm_in_order(policy, monkeypatch):
    policy("skip")
    tm = GPTForCausalLM(gpt_tiny(lm_ce_chunks=4), device="cpu")
    step = TrainStep(tm, AdamW(LR), loss_fn=_scaled_loss, device="cpu")
    ids, labels = _batch(1024)
    step(ids, labels, SCALES[0])
    seen = []
    record = health.record_step

    def spy(gnorm, source="grad", step=None):
        seen.append((step, gnorm))
        return record(gnorm, source, step)

    monkeypatch.setattr(health, "record_step", spy)
    norms = []
    grad_health = health.grad_health
    monkeypatch.setattr(health, "grad_health",
                        lambda g, *a: norms.append(grad_health(g, *a))
                        or norms[-1])
    with pytest.warns(UserWarning, match="non-finite grad at step 2"):
        step.run_steps_stream(3, *(np.stack([x] * 3) for x in (ids, labels)),
                              np.stack(SCALES))
    assert [s for s, _ in seen] == [1, 2, 3]
    assert [math.isfinite(g) for _, g in seen] == [True, False, True]
    assert [g for _, g in seen][::2] == [float(n) for n in norms][::2]
    assert float(step.opt_state["t"]) == 3.0


def test_health_module_matches_jax(monkeypatch):
    for value in ("warn", " SKIP ", "raise", "loud", ""):
        monkeypatch.setenv("PADDLE_TPU_HEALTH", value)
        assert health._env_policy() == jax_health._env_policy()
    monkeypatch.delenv("PADDLE_TPU_HEALTH")
    assert health._env_policy() == "off"
    assert health.policy is health.get_policy
    with pytest.raises(ValueError, match="health policy must be one of"):
        health.configure("loud")
    assert health.record_step(1.5) is True
    assert not health.enabled()


# ------------------------------------------------------- 8-bit moments
@pytest.mark.parametrize("signed", [True, False], ids=["m", "v"])
@pytest.mark.parametrize("n", [256, 700, 3], ids=["one", "ragged", "short"])
def test_q8_codes_match_jax(signed, n):
    rng = np.random.RandomState(n)
    x = (rng.randn(n) * 10.0 ** rng.uniform(-6, 1, n)).astype(np.float32)
    if not signed:
        x = np.abs(x)
    x[n // 2] = 0.0
    jq, jax_ = jax_q8(jnp.asarray(x), signed=signed)
    q, ax = _q8_quantize(torch.from_numpy(x), signed)
    assert q.dtype == (torch.int8 if signed else torch.uint8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ax.numpy(), np.asarray(jax_))
    got = _q8_dequantize(q, ax, (n,), signed)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_deq(jq, jax_, (n,), signed)))
    jq, _ = jax_q8(jnp.asarray(x), signed=signed,
                   key=jax.random.PRNGKey(0))
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), q.shape,
                                      jnp.float32))
    q, _ = _q8_quantize(torch.from_numpy(x), signed, torch.from_numpy(u))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def _jax_noise(shape, step, index, signed, device):
    """The JAX 8-bit update's noise: fold_in(fold_in(PRNGKey(0x51ab), t),
    i), split into (k_m, k_v), uniform."""
    kb = jax.random.fold_in(jax.random.PRNGKey(0x51ab), int(step))
    k_m, k_v = jax.random.split(jax.random.fold_in(kb, index))
    u = jax.random.uniform(k_m if signed else k_v, tuple(shape), jnp.float32)
    return torch.from_numpy(np.array(u)).to(device)


Q8_SHAPES = ((700,), (64, 48), (3, 5, 40), (256,))


@pytest.fixture(scope="module")
def q8_updates():
    """Three 8-bit AdamW updates of each package's functional update on
    the same f32 parameters and gradients (magnitudes over 1e-9 to 1;
    the port with the JAX noise): parameters and state after each."""
    rng = np.random.RandomState(7)
    params = [rng.randn(*s).astype(np.float32) for s in Q8_SHAPES]
    grads = [[(rng.randn(*s) * 10.0 ** rng.uniform(-9, 0, s)).astype(
        np.float32) for s in Q8_SHAPES] for _ in range(3)]
    jopt = pt.optimizer.AdamW(learning_rate=LR, weight_decay=0.01,
                              moment_quant="8bit")
    jp = [jnp.asarray(p) for p in params]
    js = jopt.init_state(jp)
    opt = AdamW(LR, weight_decay=0.01, moment_quant="8bit")
    opt._q8_noise = _jax_noise
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = opt.init_state(tp)
    out = {"jax": ([], []), "port": ([], [])}
    for g in grads:
        jp, js = jopt.update(jp, [jnp.asarray(x) for x in g], js, lr=LR)
        out["jax"][0].append([_np(p) for p in jp])
        out["jax"][1].append({k: [_np(e) for e in v] if isinstance(
            v, list) else _np(v) for k, v in js.items()})
        opt.update(tp, [torch.from_numpy(x) for x in g], ts, lr=LR)
        out["port"][0].append([p.numpy().copy() for p in tp])
        out["port"][1].append({k: [_host(e) for e in v] if isinstance(
            v, list) else _host(v) for k, v in ts.items()})
    return out


def _code_flips(got, want, most=None):
    """(codes that differ, codes) over m and v; each differs by at most
    ``most`` codes when given."""
    off = total = 0
    for key in ("m", "v"):
        for a, b in zip(got[key], want[key]):
            assert a.dtype == b.dtype and a.shape == b.shape
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert most is None or diff.max() <= most, key
            off += int((diff > 0).sum())
            total += a.size
    return off, total


def test_q8_updates_match_jax(q8_updates):
    (jp, js), (tp, ts) = q8_updates["jax"], q8_updates["port"]
    assert sorted(ts[0]) == sorted(js[0]) == ["m", "m_ax", "t", "v", "v_ax"]
    for step in range(3):
        for i, (a, b) in enumerate(zip(tp[step], jp[step])):
            np.testing.assert_allclose(a, b, rtol=0, atol=Q8_PARAM_ATOL,
                                       err_msg="step %d param %d"
                                       % (step, i))
        off, total = _code_flips(ts[step], js[step], most=1)
        assert off <= Q8_CODE_FRACTION * total, (step, off, total)
        for key in ("m_ax", "v_ax"):
            for a, b in zip(ts[step][key], js[step][key]):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)


def test_q8_update_resumes_from_jax_state(q8_updates):
    """The JAX state after two updates, through ``convert``, into a
    port optimizer: its third update lands on JAX's."""
    (jp, js), _ = q8_updates["jax"], q8_updates["port"]
    rng = np.random.RandomState(7)
    [rng.randn(*s) for s in Q8_SHAPES]
    grads = [[(rng.randn(*s) * 10.0 ** rng.uniform(-9, 0, s)).astype(
        np.float32) for s in Q8_SHAPES] for _ in range(3)]
    opt = AdamW(LR, weight_decay=0.01, moment_quant="8bit")
    opt._q8_noise = _jax_noise
    params = [torch.from_numpy(p.copy()) for p in jp[1]]
    state = opt_state_from_paddle_tpu(js[1])
    assert state["m"][0].dtype == torch.int8
    assert state["v"][0].dtype == torch.uint8
    assert tuple(state["m_ax"][0].shape)[1:] == (1,)
    opt.update(params, [torch.from_numpy(x) for x in grads[2]], state,
               lr=LR)
    for a, b in zip(params, jp[2]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=Q8_PARAM_ATOL)
    assert float(state["t"]) == 3.0


@pytest.fixture(scope="module")
def q8_runs():
    """Three 8-bit AdamW steps of each package in a TrainStep on gpt_tiny
    (the port with the JAX noise): losses, parameters and state after
    each."""
    jm = _jax_model()
    tm = _port_model(jm)
    ids, labels = _batch(tm.config.vocab_size)
    jstep = pt.jit.TrainStep(jm, pt.optimizer.AdamW(
        learning_rate=LR, weight_decay=0.01, parameters=jm.parameters(),
        moment_quant="8bit"), grad_clip_norm=1.0)
    opt = AdamW(LR, weight_decay=0.01, moment_quant="8bit")
    opt._q8_noise = _jax_noise
    tstep = TrainStep(tm, opt, grad_clip_norm=1.0, device="cpu")
    out = {"jax": ([], [], []), "port": ([], [], [])}
    for _ in range(3):
        out["jax"][0].append(float(jstep(pt.to_tensor(ids),
                                         pt.to_tensor(labels)).numpy()))
        out["jax"][1].append(_jax_params(jm))
        out["jax"][2].append(_jax_state(jstep))
        out["port"][0].append(float(tstep(ids, labels)))
        out["port"][1].append(_port_params(tm))
        out["port"][2].append(_port_state(tstep))
    return out


def _assert_params_mostly_close(got, want, what):
    """Within Q8_PARAM_ATOL but for Q8_PARAM_FRACTION of the elements,
    all within Q8_PARAM_BOUND."""
    off = total = 0
    for k, v in want.items():
        d = np.abs(got[k] - v)
        assert d.max() <= Q8_PARAM_BOUND, (what, k, d.max())
        off += int((d > Q8_PARAM_ATOL).sum())
        total += v.size
    assert off <= Q8_PARAM_FRACTION * total, (what, off, total)


def test_q8_steps_match_jax(q8_runs):
    (jl, jp, js), (tl, tp, ts) = q8_runs["jax"], q8_runs["port"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for step in range(3):
        _assert_params_mostly_close(tp[step], jp[step], "step %d" % step)
        off, total = _code_flips(ts[step], js[step])
        assert off <= Q8_MODEL_CODE_FRACTION * total, (step, off, total)


def test_q8_state_resumes_from_jax(q8_runs):
    """The JAX run's parameters and 8-bit state after two steps, through
    ``convert`` and ``restore_state``; the port's third step lands on
    JAX's."""
    tm = GPTForCausalLM(gpt_tiny(lm_ce_chunks=4), device="cpu")
    opt = AdamW(LR, weight_decay=0.01, moment_quant="8bit")
    opt._q8_noise = _jax_noise
    step = TrainStep(tm, opt, grad_clip_norm=1.0, device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(q8_runs["jax"][1][1]))
    step.restore_state(opt_state_from_paddle_tpu(q8_runs["jax"][2][1]))
    assert step.opt_state["m"][0].dtype == torch.int8
    assert float(step.opt_state["t"]) == 2.0
    loss = float(step(*_batch(tm.config.vocab_size)))
    np.testing.assert_allclose(loss, q8_runs["jax"][0][2], rtol=1e-5)
    _assert_params_mostly_close(_port_params(tm), q8_runs["jax"][1][2],
                                "resumed")


def test_q8_moments_are_one_byte_an_element():
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    state = AdamW(moment_quant="8bit").init_state(list(tm.parameters()))
    n = sum(p.numel() for p in tm.parameters())
    codes = sum(q.numel() for q in state["m"] + state["v"])
    assert n * 2 <= codes < n * 2 + 512 * len(state["m"])
    assert all(q.shape[1] == 256 for q in state["m"])


def test_q8_noise_comes_from_the_optimizer_generator():
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    ids, labels = _batch(1024)
    runs = []
    for _ in range(2):
        torch.manual_seed(0)
        m = GPTForCausalLM(gpt_tiny(), device="cpu")
        m.load_state_dict(tm.state_dict())
        step = TrainStep(m, AdamW(LR, moment_quant="8bit"), device="cpu")
        torch.manual_seed(123 + len(runs))     # the global RNG is not used
        step(ids, labels)
        runs.append(_port_state(step))
    for a, b in zip(runs[0]["v"], runs[1]["v"]):
        np.testing.assert_array_equal(a, b)


def test_q8_option_rules_match_jax():
    with pytest.raises(ValueError, match="factored_v and moment_quant are "
                       "exclusive"):
        AdamW(moment_quant="8bit", factored_v=True)
    with pytest.raises(ValueError, match="unknown mode"):
        AdamW(moment_quant="4bit")
    with pytest.raises(ValueError):
        pt.optimizer.AdamW(moment_quant="8bit", factored_v=True)


# ------------------------------------------------------ ChunkPrefetcher
def test_prefetcher_stacks_and_drops_the_partial_group():
    rng = np.random.RandomState(0)
    batches = [(rng.randint(0, 9, (2, 5)), torch.from_numpy(rng.randn(2)))
               for _ in range(7)]
    pf = ChunkPrefetcher(iter(batches), 3)
    chunks = list(pf)
    assert len(chunks) == 2
    for c, group in zip(chunks, (batches[:3], batches[3:6])):
        np.testing.assert_array_equal(c[0], np.stack([b[0] for b in group]))
        np.testing.assert_array_equal(c[1], np.stack([b[1].numpy()
                                                      for b in group]))
    with pytest.raises(StopIteration):
        next(pf)
    single = list(ChunkPrefetcher(iter([np.ones(2)] * 4), 2))
    assert len(single) == 2 and single[0][0].shape == (2, 2)
    with pytest.raises(ValueError, match="chunk size must be >= 1"):
        ChunkPrefetcher(iter([]), 0)


def test_prefetcher_surfaces_source_errors():
    def source():
        yield (np.zeros(3),)
        yield (np.zeros(3),)
        raise KeyError("bad batch")

    pf = ChunkPrefetcher(source(), 2)
    assert next(pf)[0].shape == (2, 3)
    with pytest.raises(KeyError, match="bad batch"):
        next(pf)
    with pytest.raises(KeyError):
        next(pf)


def test_prefetcher_close_stops_the_thread():
    def endless():
        while True:
            yield (np.zeros(4),)

    pf = ChunkPrefetcher(endless(), 2, depth=1)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_feeds_run_steps_stream():
    tm = GPTForCausalLM(gpt_tiny(lm_ce_chunks=4), device="cpu")
    step = TrainStep(tm, AdamW(_sched(lr)), device="cpu")
    pf = ChunkPrefetcher((_batch(1024, seed=s) for s in range(7)), 3)
    losses = [float(step.run_steps_stream(3, *c)) for c in pf]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert step.optimizer._learning_rate.last_epoch == 6


# ----------------------------------------------------------- entry point
def test_training_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    with pytest.raises(RuntimeError):
        TrainStep(tm, AdamW(_sched(lr)), accumulate_steps=2)
    with pytest.raises(NotImplementedError, match="mesh"):
        TrainStep(tm, AdamW(), mesh=object(), device="cpu")
