"""The port's MoE GPT training path against the JAX package's, on
gpt_tiny with 4 experts (top-2 GShard routing, capacity factor 1.25,
aux weight 0.01).

Both packages hold the same f32 weights (the JAX model's, carried over by
``params_from_paddle_tpu``) and see the same numpy inputs. Tolerances,
all f32:

* ``fused_moe_mlp``'s y against the JAX fused route and against its
  one-hot einsum fallback (``fusion.override(fusion="off")``): rtol 1e-5,
  atol 1e-6 (the same routing and slots; the expert products and the
  combine round in other orders, an ulp or so); the aux loss (the same
  expression over the same f32 gates, ~1.0) within two f32 ulps, rtol
  2.5e-7 (read: one ulp, 1.19e-7: the means over the tokens sum in
  another order);
* losses (the LM loss plus 0.01 x each block's aux): rtol 1e-5;
* every gradient: rtol 1e-4, atol 1e-6;
* ``recompute=True`` (``recompute_interval`` 1, 2, 3, -2 and -3 on 4
  layers) against the same port model without it: equal, bit for bit;
* parameters after 1 and 3 AdamW steps (lr 1e-3): atol 2e-6, with bf16
  first moments 5e-5, and the key third of ``qkv_proj.bias`` 3 x lr (its
  exact gradient is zero, so both packages step it by rounding noise; see
  ``test_torch_gpt_training.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import fusion as jfusion
from paddle_tpu_torch.convert import (opt_state_from_paddle_tpu,
                                      params_from_paddle_tpu)
from paddle_tpu_torch.fusion.moe import fused_moe_mlp, gshard_top2
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.optimizer import AdamW

# tiny shapes: one torch thread a test process (more only contend
# with the other pytest-xdist workers for the cores)
torch.set_num_threads(1)

B, S, E = 2, 64, 4
LR = 1e-3


def _batch(vocab, seed=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, S)).astype(np.int64)
    labels = rng.randint(0, vocab, (B, S)).astype(np.int64)
    labels[0, :5] = -100                  # ignored tokens
    return ids, labels


def _jax_model(seed=31, num_layers=2, **kw):
    pt.seed(seed)
    return pt.models.GPTForCausalLM(dataclasses.replace(pt.models.gpt_tiny(
        dropout=0.0, attention_dropout=0.0, moe_num_experts=E, **kw),
        num_layers=num_layers))


def _port_model(jm, **kw):
    cfg = dataclasses.replace(gpt_tiny(moe_num_experts=E, **kw),
                              num_layers=jm.config.num_layers)
    tm = GPTForCausalLM(cfg, device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(
        {k: v.numpy() for k, v in jm.state_dict().items()}))
    return tm


def _jax_loss_and_grads(jm, ids, labels):
    loss = jm(pt.to_tensor(ids), labels=pt.to_tensor(labels))
    loss.backward()
    return float(loss.numpy()), {n: np.asarray(p.grad._data)
                                 for n, p in jm.named_parameters()}


def _port_loss_and_grads(tm, ids, labels):
    names, params = zip(*tm.named_parameters())
    loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, params)
    return loss.item(), {n: g.numpy() for n, g in zip(names, grads)}


@pytest.mark.parametrize("factor", [1.25, 0.25], ids=["cap1.25", "cap0.25"])
@pytest.mark.parametrize("route", ["on", "off"])
def test_fused_moe_mlp_matches_jax(route, factor):
    """y and aux against the JAX ``GPTMoEMLP`` on its fused route and on
    its one-hot einsum fallback; at capacity factor 0.25 (8 slots an
    expert for 128 choices) tokens are dropped, and a token that lost
    both choices reads exactly 0."""
    pt.seed(5)
    cfg = pt.models.gpt_tiny(moe_num_experts=E, moe_capacity_factor=factor)
    layer = pt.models.gpt.GPTMoEMLP(cfg)
    rng = np.random.RandomState(6)
    x = rng.randn(B, 32, cfg.hidden_size).astype(np.float32)
    with jfusion.override(fusion=route):
        want = layer(pt.to_tensor(x)).numpy()
    want_aux = float(layer.last_aux_loss.numpy())
    w = {n: torch.from_numpy(np.array(p.numpy()))
         for n, p in layer.named_parameters()}
    cap = max(4, int(factor * B * 32 * 2 / E))
    y, aux = fused_moe_mlp(torch.from_numpy(x), w["gate_weight"], w["w1"],
                           w["b1"], w["w2"], w["b2"], E, cap)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-6)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(aux.item(), want_aux, rtol=2.5e-7, atol=0)
    dropped = int((y.reshape(-1, cfg.hidden_size) == 0).all(-1).sum())
    if factor < 1:
        assert 0 < dropped < B * 32
    else:
        assert dropped == 0


@pytest.mark.parametrize("factor", [1.25, 0.25], ids=["cap1.25", "cap0.25"])
def test_routing_slots(factor):
    """``gshard_top2``'s slots: every kept slot used once, an expert's
    first choices in token order from position 0, then its second
    choices, the dropped ones at the trash slot E * cap with gate 0, and
    the kept gates of a token summing to 1."""
    rng = np.random.RandomState(8)
    n = 96
    cap = max(4, int(factor * n * 2 / E))
    logits = torch.from_numpy(rng.randn(n, E).astype(np.float32))
    slot1, slot2, g1, g2, _ = gshard_top2(logits, E, cap)
    order = torch.argsort(-torch.softmax(logits, -1), dim=-1, stable=True)
    trash = E * cap
    kept = torch.cat([slot1[slot1 < trash], slot2[slot2 < trash]])
    assert kept.unique().numel() == kept.numel()
    for e in range(E):
        first = (order[:, 0] == e).nonzero()[:, 0]
        second = (order[:, 1] == e).nonzero()[:, 0]
        want = torch.arange(first.numel() + second.numel()) + e * cap
        want = torch.where(want < (e + 1) * cap, want, trash)
        got = torch.cat([slot1[first], slot2[second]])
        assert torch.equal(got, want), e
    for slot, g in ((slot1, g1), (slot2, g2)):
        assert bool((g[slot == trash] == 0).all())
    both = (slot1 < trash) | (slot2 < trash)
    torch.testing.assert_close(
        (g1 + g2)[both], torch.ones(int(both.sum())), rtol=0, atol=1e-6)
    assert (factor < 1) == bool((slot2 == trash).any())


@pytest.mark.parametrize("chunks", [0, 4])
def test_forward_loss_matches_jax(chunks):
    jm = _jax_model(lm_ce_chunks=chunks)
    tm = _port_model(jm, lm_ce_chunks=chunks)
    ids, labels = _batch(tm.config.vocab_size)
    want = float(jm(pt.to_tensor(ids), labels=pt.to_tensor(labels)).numpy())
    got = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    # the aux term is really in it: 0.01 x a load-balance loss near 1 a
    # block
    no_aux = GPTForCausalLM(gpt_tiny(moe_num_experts=E, lm_ce_chunks=chunks,
                                     moe_aux_weight=0.0), device="cpu")
    no_aux.load_state_dict(tm.state_dict())
    bare = no_aux(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert 0.01 < got.item() - bare.item() < 0.1


@pytest.mark.parametrize("recompute,interval", [
    (False, 1), (True, 1), (True, 2), (True, -2)],
    ids=["plain", "rc1", "rc2", "rc-2"])
def test_grads_match_jax(recompute, interval):
    """Every gradient (the aux loss threaded out of the JAX
    ``jax.checkpoint`` blocks, and out of the port's checkpoints)."""
    kw = dict(lm_ce_chunks=4, recompute=recompute,
              recompute_interval=interval)
    jm = _jax_model(**kw)
    tm = _port_model(jm, **kw)
    ids, labels = _batch(tm.config.vocab_size)
    jl, jg = _jax_loss_and_grads(jm, ids, labels)
    tl, tg = _port_loss_and_grads(tm, ids, labels)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tg.keys() == jg.keys()
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], rtol=1e-4, atol=1e-6,
                                   err_msg=n)


@pytest.fixture(scope="module")
def four_layers():
    """A 4-layer JAX model (its weights), the batch, and the port's loss
    and grads without recompute: what every recompute case is held to."""
    jm = _jax_model(num_layers=4)
    ids, labels = _batch(1024, seed=5)
    return jm, ids, labels, _port_loss_and_grads(_port_model(jm), ids,
                                                 labels)


@pytest.mark.parametrize("interval,chosen", [
    (1, [True, True, True, True]), (2, [True, False, True, False]),
    (-2, [True, False, True, False]), (3, [True, True, False, True]),
    (-3, [True, False, False, True])])
def test_recompute_equals_plain(four_layers, interval, chosen):
    jm, ids, labels, plain = four_layers
    rc = _port_model(jm, recompute=True, recompute_interval=interval)
    assert [blk.recompute for blk in rc.gpt.h] == chosen
    got = _port_loss_and_grads(rc, ids, labels)
    assert got[0] == plain[0]
    for n, g in plain[1].items():
        np.testing.assert_array_equal(got[1][n], g, err_msg=n)


OPT = {"factored_f32": dict(factored_v=True, moment_dtype="float32"),
       "factored_bf16": dict(factored_v=True, moment_dtype="bfloat16")}
PARAM_ATOL = {"factored_f32": 2e-6, "factored_bf16": 5e-5}


def _assert_params_close(got, want, atol):
    assert got.keys() == want.keys()
    for k, v in want.items():
        g = got[k]
        if k.endswith("attn.qkv_proj.bias"):
            h = v.shape[0] // 3               # [q | k | v] thirds
            np.testing.assert_allclose(g[h:2 * h], v[h:2 * h], atol=3 * LR,
                                       err_msg=k + " (key third)")
            g, v = np.delete(g, np.s_[h:2 * h]), np.delete(v, np.s_[h:2 * h])
        np.testing.assert_allclose(g, v, atol=atol, err_msg=k)


def _jax_state(jm):
    return {k: np.array(v.numpy(), copy=True)
            for k, v in jm.state_dict().items()}


def _port_state(tm):
    return {k: v.detach().numpy().copy() for k, v in tm.state_dict().items()}


def _steppers(kind, **kw):
    jm = _jax_model(lm_ce_chunks=4, **kw)
    tm = _port_model(jm, lm_ce_chunks=4, **kw)
    jopt = pt.optimizer.AdamW(learning_rate=LR, weight_decay=0.01,
                              parameters=jm.parameters(), **OPT[kind])
    jstep = pt.jit.TrainStep(jm, jopt, grad_clip_norm=1.0)
    tstep = TrainStep(tm, AdamW(learning_rate=LR, weight_decay=0.01,
                                **OPT[kind]), grad_clip_norm=1.0,
                      device="cpu")
    return jm, tm, jstep, tstep


@pytest.mark.parametrize("kind", sorted(OPT))
def test_train_steps_match_jax(kind):
    """step() then run_steps(2) in each package, with recompute: the
    loss and every parameter after step 1 and after step 3; the factored
    second moment of a 3-D expert weight keeps the JAX layout (vr [E],
    vc [h * ffn])."""
    jm, tm, jstep, tstep = _steppers(kind, recompute=True)
    ids, labels = _batch(tm.config.vocab_size)
    jb = (pt.to_tensor(ids), pt.to_tensor(labels))
    jl1 = float(jstep(*jb).numpy())
    jp1 = _jax_state(jm)
    jl3 = float(jstep.run_steps(2, *jb).numpy())
    tl1 = float(tstep(ids, labels))
    tp1 = _port_state(tm)
    tl3 = float(tstep.run_steps(2, ids, labels))
    np.testing.assert_allclose(tl1, jl1, rtol=1e-5)
    np.testing.assert_allclose(tl3, jl3, rtol=1e-5)
    assert tl3 < tl1                      # same batch: the loss falls
    _assert_params_close(tp1, jp1, PARAM_ATOL[kind])
    _assert_params_close(_port_state(tm), _jax_state(jm), PARAM_ATOL[kind])
    names = [n for n, _ in tm.named_parameters()]
    i = names.index("gpt.h.0.mlp.w1")
    cfg = tm.config
    for key, want in (("vr", (E,)),
                      ("vc", (cfg.hidden_size * cfg.intermediate_size,)),
                      ("v", (0,))):
        assert tuple(tstep.opt_state[key][i].shape) == want
        assert tuple(np.shape(jstep.opt_state[key][i])) == want
    np.testing.assert_allclose(tstep.opt_state["vr"][i].numpy(),
                               np.asarray(jstep.opt_state["vr"][i]),
                               rtol=1e-4)


def test_resume_from_jax_state():
    """Two JAX steps, then the third step of each package from the JAX
    run's parameters and optimizer state (3-D expert moments included)."""
    jm, _, jstep, _ = _steppers("factored_bf16")
    ids, labels = _batch(jm.config.vocab_size)
    jstep.run_steps(2, pt.to_tensor(ids), pt.to_tensor(labels))
    params2 = _jax_state(jm)
    state2 = {k: [np.array(e, copy=True) for e in v]
              if isinstance(v, (list, tuple)) else np.array(v, copy=True)
              for k, v in jstep.opt_state.items()}
    want = float(jstep(pt.to_tensor(ids), pt.to_tensor(labels)).numpy())
    want_params = _jax_state(jm)

    tm = GPTForCausalLM(gpt_tiny(moe_num_experts=E, lm_ce_chunks=4),
                        device="cpu")
    tstep = TrainStep(tm, AdamW(learning_rate=LR, weight_decay=0.01,
                                **OPT["factored_bf16"]),
                      grad_clip_norm=1.0, device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(params2))
    tstep.restore_state(opt_state_from_paddle_tpu(state2))
    got = float(tstep(ids, labels))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params_close(_port_state(tm), want_params,
                         PARAM_ATOL["factored_bf16"])


def test_training_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        GPTForCausalLM(gpt_tiny(moe_num_experts=E, recompute=True))
    tm = GPTForCausalLM(gpt_tiny(moe_num_experts=E), device="cpu")
    with pytest.raises(RuntimeError):
        TrainStep(tm, AdamW())
