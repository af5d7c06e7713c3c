"""Dropout in the port (``nn.functional.dropout``, ``fusion.dropout_add``,
attention dropout, GPT's dropout sites, the random streams) against the
JAX package's, on gpt_tiny.

The masks are random in both packages but from different generators, so
the training-mode comparison records the JAX run's masks (a wrapper
around ``jax.random.bernoulli`` while the JAX model runs eagerly) and
replays them through the port's one mask draw
(``nn.functional.common.dropout_mask``), in the order both packages draw
them: the embeddings, then per block the attention output, the
attention branch and the MLP branch. Tolerances, f32 over 2 layers:
losses rtol 1e-5, logits atol 1e-5, every gradient rtol 1e-4 and atol
1e-6 (those of ``test_torch_gpt_training.py``). Recompute against no
recompute, and ``dropout_add`` against its unfused composition: bit for
bit.
"""
import math

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch
from paddle_tpu_torch.convert import params_from_paddle_tpu
from paddle_tpu_torch.core import random as prandom
from paddle_tpu_torch.fusion import dropout_add
from paddle_tpu_torch.incubate.nn.cuda.flash_attn import flash_attention_ref
from paddle_tpu_torch.incubate.nn.functional import (
    flash_attention, scaled_dot_product_attention)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.nn.functional import common, dropout
from paddle_tpu_torch.optimizer import AdamW

# tiny shapes: one torch thread a test process (more only contend
# with the other pytest-xdist workers for the cores)
torch.set_num_threads(1)

B, S = 2, 64
P = 0.1


def _batch(vocab, seed=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, S)).astype(np.int64)
    labels = rng.randint(0, vocab, (B, S)).astype(np.int64)
    labels[0, :5] = -100                  # ignored tokens
    return ids, labels


def _config(**kw):
    return gpt_tiny(dropout=P, attention_dropout=P, lm_ce_chunks=4, **kw)


def _grads(model, ids, labels):
    names, params = zip(*model.named_parameters())
    loss = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    return loss.item(), dict(zip(names, (g.numpy() for g in
                                         torch.autograd.grad(loss, params))))


# ------------------------------------------------------------ functional
def test_p0_and_eval_are_the_identity():
    x = torch.randn(4, 8, 3)
    assert dropout(x, 0.0) is x
    assert dropout(x, 0.5, training=False) is x
    assert torch.equal(dropout_add(x, 2 * x, 0.3, training=False), 3 * x)
    assert torch.equal(dropout_add(x, 2 * x, 0.0), 3 * x)
    q, k, v = torch.randn(3, 2, 16, 4, 8).unbind(0)
    want = flash_attention_ref(q, k, v, causal=True)
    out, none = flash_attention(q, k, v, dropout=0.5, causal=True,
                                training=False)
    assert none is None and torch.equal(out, want)


def test_keep_rate_is_one_minus_p():
    n, p = 65536, 0.3
    paddle_tpu_torch.seed(0)
    kept = float((dropout(torch.ones(n), p) != 0).float().mean())
    assert abs(kept - (1 - p)) <= 4 * math.sqrt(p * (1 - p) / n)
    rows = dropout(torch.ones(512, 64), p, axis=0)
    whole = (rows != 0).all(1) | (rows == 0).all(1)
    assert bool(whole.all())
    kept = float((rows[:, 0] != 0).float().mean())
    assert abs(kept - (1 - p)) <= 4 * math.sqrt(p * (1 - p) / 512)


def test_kept_entries_are_upscaled_and_carry_the_gradient():
    p = 0.25
    x = torch.randn(64, 64, requires_grad=True)
    y = dropout(x, p)
    keep = y != 0
    assert 0 < int(keep.sum()) < x.numel()
    assert torch.equal(y[keep], (x / (1 - p))[keep])
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(g, torch.where(keep, torch.tensor(1 / (1 - p)),
                                      torch.tensor(0.0)))
    z = dropout(x.detach(), p, mode="downscale_in_infer")
    assert torch.equal(z[z != 0], x.detach()[z != 0])
    half = dropout(torch.ones(8, 8, dtype=torch.bfloat16), 0.5)
    assert half.dtype == torch.bfloat16
    assert set(half.unique().tolist()) <= {0.0, 2.0}


def test_dropout_add_is_the_unfused_composition_bitwise():
    y, r = torch.randn(2, 2, 64, 32).unbind(0)
    g = prandom.generator("cpu")
    state = g.get_state()
    fused = dropout_add(y, r, 0.2)
    g.set_state(state)
    plain = r + dropout(y, 0.2)
    assert torch.equal(fused, plain)
    assert not torch.equal(fused, r + y)


def test_draws_come_from_the_port_generators():
    x = torch.ones(1000)
    runs = []
    for global_seed in (0, 1):
        torch.manual_seed(global_seed)       # the global RNG is not read
        paddle_tpu_torch.seed(5)
        runs.append(dropout(x, 0.5))
    assert torch.equal(runs[0], runs[1])
    g = torch.Generator().manual_seed(9)
    default = prandom.generator("cpu").get_state()
    with prandom.rng_guard(g):
        a = dropout(x, 0.5)
    assert torch.equal(prandom.generator("cpu").get_state(), default)
    with prandom.rng_guard(torch.Generator().manual_seed(9)):
        assert torch.equal(dropout(x, 0.5), a)
    assert not torch.equal(a, runs[0])


# ------------------------------------------------------------ GPT vs JAX
@pytest.fixture(scope="module")
def jax_run():
    """The JAX GPT with dropout and attention dropout 0.1, trained one
    forward and backward eagerly with every mask recorded; and its eval
    logits."""
    pt.seed(11)
    jm = pt.models.GPTForCausalLM(pt.models.gpt_tiny(
        dropout=P, attention_dropout=P, lm_ce_chunks=4))
    ids, labels = _batch(jm.config.vocab_size)
    bernoulli = jax.random.bernoulli
    masks = []

    def recorded(key, p=0.5, shape=None, mode="low"):
        out = bernoulli(key, p, shape)
        masks.append((float(p), np.asarray(out)))
        return out

    jax.random.bernoulli = recorded
    try:
        loss = jm(pt.to_tensor(ids), labels=pt.to_tensor(labels))
        loss.backward()
    finally:
        jax.random.bernoulli = bernoulli
    grads = {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}
    weights = {k: np.array(v.numpy(), copy=True)
               for k, v in jm.state_dict().items()}
    jm.eval()
    logits = np.asarray(jm(pt.to_tensor(ids)).numpy())
    return dict(weights=weights, ids=ids, labels=labels,
                loss=float(loss.numpy()), grads=grads, masks=masks,
                logits=logits)


def _port_model(weights, **kw):
    tm = GPTForCausalLM(_config(**kw), device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(weights))
    return tm


def test_eval_logits_match_jax(jax_run):
    tm = _port_model(jax_run["weights"]).eval()
    logits = tm(torch.from_numpy(jax_run["ids"]))
    np.testing.assert_allclose(logits.detach().numpy(), jax_run["logits"],
                               atol=1e-5)


def test_jax_masks_replayed_give_jax_loss_and_grads(jax_run, monkeypatch):
    masks = list(jax_run["masks"])
    L = 2
    assert len(masks) == 1 + 3 * L
    assert all(p == pytest.approx(1 - P) for p, _ in masks)
    shapes = []

    def replayed(shape, p, device):
        keep_p, mask = masks.pop(0)
        shapes.append(tuple(shape))
        assert tuple(shape) == mask.shape and keep_p == pytest.approx(1 - p)
        return torch.from_numpy(mask).to(device)

    monkeypatch.setattr(common, "dropout_mask", replayed)
    tm = _port_model(jax_run["weights"])
    loss, grads = _grads(tm, jax_run["ids"], jax_run["labels"])
    assert not masks
    h, heads = tm.config.hidden_size, tm.config.num_heads
    assert shapes == [(B, S, h)] + [(B, S, heads, h // heads), (B, S, h),
                                    (B, S, h)] * L
    np.testing.assert_allclose(loss, jax_run["loss"], rtol=1e-5)
    assert grads.keys() == jax_run["grads"].keys()
    for n, want in jax_run["grads"].items():
        np.testing.assert_allclose(grads[n], want, rtol=1e-4, atol=1e-6,
                                   err_msg=n)


def test_training_is_random_and_seeded(jax_run):
    tm = _port_model(jax_run["weights"])
    ids, labels = (torch.from_numpy(x) for x in (jax_run["ids"],
                                                 jax_run["labels"]))
    losses = []
    for s in (1, 1, 2):
        paddle_tpu_torch.seed(s)
        losses.append(tm(ids, labels=labels).item())
    assert losses[0] == losses[1] != losses[2]
    plain = tm.eval()(ids, labels=labels).item()
    assert losses[0] != plain


@pytest.mark.parametrize("interval", [1, -2])
def test_recompute_replays_the_masks(jax_run, interval):
    """Grads with recompute equal grads without it, bit for bit, under
    one seed: a recomputed block draws its forward's masks again, and
    the generator ends where it would without recompute."""
    runs, ends = [], []
    for recompute in (True, False):
        tm = _port_model(jax_run["weights"], recompute=recompute,
                         recompute_interval=interval)
        assert any(b.recompute for b in tm.gpt.h) == recompute
        paddle_tpu_torch.seed(7)
        runs.append(_grads(tm, jax_run["ids"], jax_run["labels"]))
        ends.append(prandom.generator("cpu").get_state())
    (l_on, g_on), (l_off, g_off) = runs
    assert l_on == l_off
    for n, g in g_off.items():
        np.testing.assert_array_equal(g_on[n], g, err_msg=n)
    assert torch.equal(ends[0], ends[1])


def test_recompute_replays_the_masks_from_another_thread(jax_run):
    """The backward (and with it the recompute) on a thread other than
    the forward's, as the autograd engine runs a CUDA backward: the
    masks still replay, inside a TrainStep-like guard and outside."""
    import threading

    ids, labels = (torch.from_numpy(x) for x in (jax_run["ids"],
                                                 jax_run["labels"]))
    grads = []
    for recompute, guard in ((False, None), (True, None), (False, 4),
                             (True, 4)):
        tm = _port_model(jax_run["weights"], recompute=recompute)
        params = list(tm.parameters())
        paddle_tpu_torch.seed(7)
        gen = torch.Generator().manual_seed(guard or 0)
        if guard is None:
            loss = tm(ids, labels=labels)
            out = []
            worker = threading.Thread(target=lambda: out.append(
                torch.autograd.grad(loss, params)))
            worker.start()
            worker.join()
        else:
            with prandom.rng_guard(gen):
                loss = tm(ids, labels=labels)
                out = []
                worker = threading.Thread(target=lambda: out.append(
                    torch.autograd.grad(loss, params)))
                worker.start()
                worker.join()
        grads.append(out[0])
    for on, off in ((grads[1], grads[0]), (grads[3], grads[2])):
        for a, b in zip(on, off):
            assert torch.equal(a, b)


def test_train_step_draws_from_its_own_generator(jax_run):
    ids, labels = jax_run["ids"], jax_run["labels"]
    runs = []
    for seed in (4, 4, 5):
        tm = _port_model(jax_run["weights"], recompute=True)
        default = prandom.generator("cpu").get_state()
        step = TrainStep(tm, AdamW(1e-3), device="cpu", seed=seed)
        runs.append([float(step(ids, labels)) for _ in range(2)])
        assert torch.equal(prandom.generator("cpu").get_state(), default)
    assert runs[0] == runs[1] and runs[0] != runs[2]
    assert runs[0][0] != runs[0][1]


def test_the_other_options_still_raise():
    tm = GPTForCausalLM(_config(sequence_parallel_mode="ring"), device="cpu")
    ids = torch.zeros(1, 8, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tm(ids)
    # KV caches and a masked SDPA with dropout are ported: they run, in
    # training too, and the masked SDPA draws its dropout
    tm = GPTForCausalLM(_config(), device="cpu")
    logits, caches = tm(ids, caches=tm.init_caches(1))
    assert logits.shape == (1, 8, tm.config.vocab_size)
    assert caches[0][0].shape[1] == 8
    q = torch.ones(1, 8, 2, 4)
    out = scaled_dot_product_attention(q, q, q, attn_mask=torch.ones(8, 8),
                                       dropout_p=P)
    kept = scaled_dot_product_attention(q, q, q, attn_mask=torch.ones(8, 8))
    assert out.shape == q.shape and not torch.equal(out, kept)
