"""The port's Llama training path against the JAX package's, on
llama_tiny (2 layers, 4 query heads over 2 kv heads, RMSNorm, RoPE,
SwiGLU, untied head).

Both packages hold the same f32 weights (the JAX model's, carried over by
``params_from_paddle_tpu``) and see the same numpy batch. On the CPU the
port's attention is the plain composition and its RMSNorm K7's plain
version, which is also what the JAX model runs off the TPU (its fused
route: ``add_rms_norm``, ``swiglu_linear``). Tolerances, all f32 over 2
layers with the same arithmetic in other summation orders:

* RoPE: atol 1e-6 (angles of |x| < 64 from two libraries' pow and cos);
* the fused epilogues: atol 1e-6;
* logits: atol 1e-5; losses: rtol 1e-5;
* every gradient: atol 1e-6 and rtol 1e-4 (elements of |g| ~ 1e-3 summed
  over 128 tokens in another order);
* ``recompute=True`` against the same port model without it: equal, bit
  for bit (the CPU runs the same operations again);
* parameters after 1 and 3 AdamW steps (lr 1e-3): atol 1e-5. One
  RMSNorm weight's first gradient is 4.9e-8, a few times Adam's eps
  (1e-8), where the step's ratio g / (|g| + eps) moves by eps / (|g| +
  eps)^2 per unit of g: the 1e-9 difference of a reordered sum moves it
  by 0.003, the parameter by 2.7e-6 (every other element within 2e-6).
  With bf16 first moments atol 5e-5 (a moment on a bf16 rounding
  boundary may round the other way; see ``test_torch_gpt_training.py``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import fusion as jfusion
from paddle_tpu.incubate.nn.functional import (
    fused_rotary_position_embedding as jax_rope)
from paddle_tpu_torch.convert import params_from_paddle_tpu
from paddle_tpu_torch.fusion import add_rms_norm, swiglu_linear
from paddle_tpu_torch.incubate.nn.functional import (
    fused_rotary_position_embedding)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.optimizer import AdamW

# tiny shapes: one torch thread a test process (more only contend
# with the other pytest-xdist workers for the cores)
torch.set_num_threads(1)

B, S = 2, 64


def _batch(vocab, seed=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, S)).astype(np.int64)
    labels = rng.randint(0, vocab, (B, S)).astype(np.int64)
    labels[1, :7] = -100                  # ignored tokens
    return ids, labels


def _jax_model(seed=21, **kw):
    pt.seed(seed)
    return pt.models.LlamaForCausalLM(pt.models.llama_tiny(**kw))


def _port_model(jm, **kw):
    tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu")
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


@pytest.mark.parametrize("neox", [True, False], ids=["neox", "pairwise"])
@pytest.mark.parametrize("with_pid", [False, True], ids=["table", "pid"])
def test_rope_matches_jax(neox, with_pid):
    rng = np.random.RandomState(7)
    q = rng.randn(2, 24, 4, 32).astype(np.float32)
    k = rng.randn(2, 24, 2, 32).astype(np.float32)
    pid = (rng.randint(0, 60, (2, 24)).astype(np.int64) if with_pid
           else None)
    want = jax_rope(pt.to_tensor(q), pt.to_tensor(k), None,
                    position_ids=None if pid is None else pt.to_tensor(pid),
                    use_neox_rotary_style=neox, rotary_emb_base=500.0)
    got = fused_rotary_position_embedding(
        torch.from_numpy(q), torch.from_numpy(k), None,
        position_ids=None if pid is None else torch.from_numpy(pid),
        use_neox_rotary_style=neox, rotary_emb_base=500.0)
    assert want[2] is None and got[2] is None
    for w, g in zip(want[:2], got[:2]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6)


def test_rope_rounds_once_to_the_input_type():
    """A bf16 input is rotated in f32 and rounded back to bf16 once;
    precomputed sin / cos tables are not ported and raise."""
    rng = np.random.RandomState(8)
    xb = torch.from_numpy(rng.randn(1, 16, 2, 8).astype(np.float32)) \
        .bfloat16()
    out = fused_rotary_position_embedding(xb)[0]
    assert out.dtype == torch.bfloat16
    want = fused_rotary_position_embedding(xb.float())[0].bfloat16()
    assert torch.equal(out, want)
    with pytest.raises(NotImplementedError):
        fused_rotary_position_embedding(xb, sin=torch.zeros(16, 8),
                                        cos=torch.ones(16, 8))


def test_fused_epilogues_match_jax():
    rng = np.random.RandomState(9)
    y, r = (rng.randn(3, 5, 32).astype(np.float32) for _ in range(2))
    w = (1 + 0.1 * rng.randn(32)).astype(np.float32)
    jn, jr = jfusion.add_rms_norm(pt.to_tensor(y), pt.to_tensor(r),
                                  pt.to_tensor(w), 1e-5)
    tn, tr = add_rms_norm(*(torch.from_numpy(a) for a in (y, r, w)), 1e-5)
    np.testing.assert_allclose(tn.numpy(), jn.numpy(), atol=1e-6)
    np.testing.assert_array_equal(tr.numpy(), jr.numpy())
    wg, wu = (0.2 * rng.randn(32, 48).astype(np.float32) for _ in range(2))
    want = jfusion.swiglu_linear(pt.to_tensor(y), pt.to_tensor(wg),
                                 pt.to_tensor(wu))
    got = swiglu_linear(*(torch.from_numpy(a) for a in (y, wg, wu)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    with pytest.raises(NotImplementedError):
        swiglu_linear(*(torch.from_numpy(a) for a in (y, wg, wu)),
                      quant_mode="int8")


@pytest.mark.parametrize("chunks", [0, 4])
def test_forward_loss_matches_jax(chunks):
    jm = _jax_model(lm_ce_chunks=chunks)
    tm = _port_model(jm, lm_ce_chunks=chunks)
    ids, labels = _batch(tm.config.vocab_size)
    want = float(jm(pt.to_tensor(ids), labels=pt.to_tensor(labels)).numpy())
    got = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    logits = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(logits.detach().numpy(),
                               jm(pt.to_tensor(ids)).numpy(), atol=1e-5)


@pytest.mark.parametrize("recompute", [False, True],
                         ids=["plain", "recompute"])
def test_grads_match_jax(recompute):
    """Every gradient, with the JAX model under ``recompute`` too (its
    blocks under ``jax.checkpoint``)."""
    jm = _jax_model(lm_ce_chunks=4, recompute=recompute)
    tm = _port_model(jm, lm_ce_chunks=4, recompute=recompute)
    ids, labels = _batch(tm.config.vocab_size)
    jl, jg = _jax_loss_and_grads(jm, ids, labels)
    tl, tg = _port_loss_and_grads(tm, ids, labels)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tg.keys() == jg.keys()
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], rtol=1e-4, atol=1e-6,
                                   err_msg=n)


def test_recompute_equals_plain():
    jm = _jax_model()
    ids, labels = _batch(1024, seed=5)
    plain = _port_loss_and_grads(_port_model(jm), ids, labels)
    rc = _port_model(jm, recompute=True)
    assert all(blk.recompute for blk in rc.llama.layers)
    got = _port_loss_and_grads(rc, ids, labels)
    assert got[0] == plain[0]
    for n, g in plain[1].items():
        np.testing.assert_array_equal(got[1][n], g, err_msg=n)


OPT = {"factored_f32": dict(factored_v=True, moment_dtype="float32"),
       "factored_bf16": dict(factored_v=True, moment_dtype="bfloat16")}
PARAM_ATOL = {"factored_f32": 1e-5, "factored_bf16": 5e-5}


@pytest.mark.parametrize("kind", sorted(OPT))
def test_train_steps_match_jax(kind):
    """step() then run_steps(2) in each package, with recompute: the loss
    and every parameter after step 1 and after step 3."""
    jm = _jax_model(lm_ce_chunks=4, recompute=True)
    tm = _port_model(jm, lm_ce_chunks=4, recompute=True)
    ids, labels = _batch(tm.config.vocab_size)
    jopt = pt.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                              parameters=jm.parameters(), **OPT[kind])
    jstep = pt.jit.TrainStep(jm, jopt, grad_clip_norm=1.0)
    tstep = TrainStep(tm, AdamW(learning_rate=1e-3, weight_decay=0.01,
                                **OPT[kind]), grad_clip_norm=1.0,
                      device="cpu")
    jb = (pt.to_tensor(ids), pt.to_tensor(labels))
    jl1 = float(jstep(*jb).numpy())
    jp1 = {k: np.array(v.numpy(), copy=True)
           for k, v in jm.state_dict().items()}
    jl3 = float(jstep.run_steps(2, *jb).numpy())
    tl1 = float(tstep(ids, labels))
    tp1 = {k: v.detach().numpy().copy() for k, v in tm.state_dict().items()}
    tl3 = float(tstep.run_steps(2, ids, labels))
    np.testing.assert_allclose(tl1, jl1, rtol=1e-5)
    np.testing.assert_allclose(tl3, jl3, rtol=1e-5)
    assert tl3 < tl1                      # same batch: the loss falls
    jp3 = {k: np.array(v.numpy(), copy=True)
           for k, v in jm.state_dict().items()}
    tp3 = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    for want, got in ((jp1, tp1), (jp3, tp3)):
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, atol=PARAM_ATOL[kind],
                                       err_msg=k)


def test_unported_options_raise():
    # without an sp mesh the ring and ulysses modes are the gspmd model,
    # as in the JAX package (its sp_attention returns None there)
    ids = torch.arange(8, dtype=torch.long)[None]
    logits = [LlamaForCausalLM(llama_tiny(sequence_parallel_mode=mode),
                               device="cpu")(ids)
              for mode in ("gspmd", "ring", "ulysses")]
    assert all(torch.equal(x, logits[0]) for x in logits[1:])
    # KV caches are ported: the cached form runs
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    logits, _ = tm(ids, caches=tm.init_caches(1))
    assert logits.shape == (1, 8, tm.config.vocab_size)


def test_training_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        LlamaForCausalLM(llama_tiny(recompute=True))
    tm = LlamaForCausalLM(llama_tiny(recompute=True), device="cpu")
    with pytest.raises(RuntimeError):
        TrainStep(tm, AdamW())
