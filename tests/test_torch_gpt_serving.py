"""The port's GPT serving path against the JAX package's, on gpt_tiny.

Both packages hold the same f32 weights (the JAX model's, carried over
by ``params_from_paddle_tpu``) and see the same numpy inputs. Logits of
one packed ragged step agree within atol=1e-4 (f32, the same arithmetic
summed in other orders over 2 layers); greedy token streams are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models.generation import _sample as jax_sample
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.convert import params_from_paddle_tpu
from paddle_tpu_torch.incubate.nn.cuda import paged_attention as tpa
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.models.generation import _sample
from paddle_tpu_torch.serving import ServingEngine

# tiny shapes: one torch thread a test process (more only contend
# with the other pytest-xdist workers for the cores)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    pt.seed(11)
    jm = pt.models.GPTForCausalLM(
        pt.models.gpt_tiny(dropout=0.0, attention_dropout=0.0))
    jm.eval()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    tm.load_state_dict(params_from_paddle_tpu(state))
    return jm, tm


def _generate(jm, prompt, max_new):
    out = jm.generate(pt.to_tensor(np.asarray([prompt], np.int64)),
                      max_new_tokens=max_new).numpy()
    return out[0].tolist()


def _drain(eng, cap=500):
    n = 0
    while eng.step() and n < cap:
        n += 1
    assert n < cap, "engine failed to drain"


def test_params_carry_over(models):
    jm, tm = models
    jstate = jm.state_dict()
    tstate = tm.state_dict()
    assert set(jstate) == set(tstate)
    for k, v in jstate.items():
        np.testing.assert_array_equal(tstate[k].numpy(), v.numpy())


def test_ragged_chunk_logits_match_jax(models):
    jm, tm = models
    rng = np.random.RandomState(7)
    cfg = tm.config
    n_kv, hd, L = cfg.num_heads, cfg.head_dim, cfg.num_layers
    page, n_pages, P = 8, 40, 8
    # rows: decode (history 20), prefill chunk of 10 at position 8,
    # idle slot, decode (history 4); then 3 padding tokens
    ql = np.asarray([1, 10, 0, 1], np.int32)
    cl = np.asarray([21, 18, 0, 5], np.int32)
    qs = np.asarray([0, 2, 12, 1], np.int32)
    T = 15
    toks = np.zeros(T, np.int32)
    pos = np.full(T, -1, np.int32)
    row_of = np.full(T, -1, np.int32)
    for r in range(4):
        n = ql[r]
        toks[qs[r]:qs[r] + n] = rng.randint(0, cfg.vocab_size, n)
        pos[qs[r]:qs[r] + n] = np.arange(cl[r] - n, cl[r])
        row_of[qs[r]:qs[r] + n] = r
    bt = rng.permutation(n_pages)[:4 * P].reshape(4, P).astype(np.int32)
    kp = [0.5 * rng.randn(n_kv, n_pages, page, hd).astype(np.float32)
          for _ in range(L)]
    vp = [0.5 * rng.randn(n_kv, n_pages, page, hd).astype(np.float32)
          for _ in range(L)]

    jad = jm.decode_adapter()
    jl, jkp, jvp = jad.ragged_chunk(
        jad.weights, *map(jnp.asarray, (toks, pos, row_of, qs, ql, cl)),
        tuple(map(jnp.asarray, kp)), tuple(map(jnp.asarray, vp)),
        jnp.asarray(bt))
    tad = tm.decode_adapter()
    tl, tkp, tvp = tad.ragged_chunk(
        tad.weights, *map(torch.from_numpy, (toks, pos, row_of, qs, ql, cl)),
        tuple(torch.from_numpy(a.copy()) for a in kp),
        tuple(torch.from_numpy(a.copy()) for a in vp), torch.from_numpy(bt))
    live = pos >= 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               rtol=0, atol=1e-4)
    for a, b in zip(tkp + tvp, jkp + jvp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def _serve(eng, prompts, max_new, then=()):
    """Submit ``prompts``, drain; then submit ``then`` and drain again
    (its prompts can hit the prefix cache of the first wave)."""
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    _drain(eng)
    rids += [eng.submit(p, max_new_tokens=max_new) for p in then]
    reqs = [eng._requests[r] for r in rids]
    _drain(eng)
    return [eng.result(r) for r in rids], reqs


def test_engine_prefix_hit_matches_jax_engine_and_generate(models):
    jm, tm = models
    rng = np.random.RandomState(0)
    V = tm.config.vocab_size
    p0, p1, p2 = (rng.randint(0, V, n).tolist() for n in (21, 7, 13))
    p3 = p0[:16] + rng.randint(0, V, 5).tolist()     # shares 2 blocks
    knobs = dict(max_slots=4, block_size=8, num_blocks=64, prefill_chunk=8)
    eng = ServingEngine(tm, device="cpu", **knobs)
    got, reqs = _serve(eng, [p0, p1, p2], 6, then=[p3])
    assert reqs[3].num_cached == 16                   # prefix-cache hit
    assert eng.ragged_steps > 0
    assert eng.prefill_tokens == 21 + 7 + 13 + 5
    eng.shutdown()                                     # asserts no leaks
    jeng = JaxEngine(jm, **knobs)
    want, _ = _serve(jeng, [p0, p1, p2], 6, then=[p3])
    jeng.shutdown()
    assert got == want
    assert got == [_generate(jm, p, 6) for p in (p0, p1, p2, p3)]


def test_engine_preemption_matches_jax_engine_and_generate(models):
    jm, tm = models
    rng = np.random.RandomState(3)
    V = tm.config.vocab_size
    prompts = [rng.randint(0, V, 4).tolist() for _ in range(2)]
    # 4 blocks of 4: both admit, growth exhausts the pool and the
    # younger request is evicted, recomputed, and still matches
    knobs = dict(max_slots=2, block_size=4, num_blocks=4, prefill_chunk=4,
                 enable_prefix_cache=False, watermark=0.0)
    eng = ServingEngine(tm, device="cpu", **knobs)
    got, _ = _serve(eng, prompts, 12)
    assert eng.scheduler.preemptions >= 1
    eng.shutdown()
    jeng = JaxEngine(jm, **knobs)
    want, _ = _serve(jeng, prompts, 12)
    jeng.shutdown()
    assert got == want
    assert got == [_generate(jm, p, 12) for p in prompts]


def test_engine_streams_and_stats(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", max_slots=2, block_size=8,
                        num_blocks=16, prefill_chunk=8)
    eng.warmup()
    assert eng.stats().free_blocks == 16
    rid = eng.submit([1, 2, 3], max_new_tokens=4)
    st = eng.stats()
    assert st.queue_depth == 1 and len(st.inflight) == 1
    eng.start()
    assert len(list(eng.stream(rid))) == 4
    eng.shutdown()


def test_sample_greedy_and_per_row():
    rng = np.random.RandomState(5)
    lg = torch.from_numpy(rng.randn(4, 64).astype(np.float32))
    greedy = lg.argmax(-1).to(torch.int32)
    g = torch.Generator().manual_seed(3)
    assert torch.equal(_sample(lg, g, 0.0, 1.0), greedy)
    assert torch.equal(_sample(lg, g, torch.zeros(4), torch.ones(4)), greedy)
    t = torch.tensor([0.0, 1.0, 0.0, 1.3])
    out = _sample(lg, g, t, torch.tensor([1.0, 0.9, 0.5, 1.0]))
    assert out.dtype == torch.int32
    assert out[0] == greedy[0] and out[2] == greedy[2]
    # the greedy lane agrees with the JAX sampler's
    jout = np.asarray(jax_sample(jnp.asarray(lg.numpy()),
                                 jax.random.PRNGKey(0), jnp.zeros(4),
                                 jnp.ones(4)))
    np.testing.assert_array_equal(greedy.numpy(), jout)
    # a nucleus this small keeps only the top token, at any temperature
    tiny = _sample(lg, g, torch.full((4,), 1.5), torch.full((4,), 1e-6))
    assert torch.equal(tiny, greedy)
    # the engine's generator makes draws reproducible
    a = _sample(lg, torch.Generator().manual_seed(9), 1.0, 0.9)
    b = _sample(lg, torch.Generator().manual_seed(9), 1.0, 0.9)
    assert torch.equal(a, b)


def test_entry_points_refuse_cpu_fallback(models):
    _, tm = models
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(tm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTForCausalLM(gpt_tiny())
    # the full-sequence forward runs on the CPU model (plain attention),
    # and so does its KV-cache form
    assert tm(torch.zeros(1, 4, dtype=torch.long)).shape == \
        (1, 4, tm.config.vocab_size)
    logits, caches = tm(torch.zeros(1, 4, dtype=torch.long),
                        caches=tm.init_caches(1))
    assert logits.shape == (1, 4, tm.config.vocab_size)
    assert len(caches) == tm.config.num_layers
    assert tpa.ragged_paged_attention.launches == 0


# ------------------------------------------------- the ragged="off" layout
def _k6_counts():
    return (tpa.paged_attention.launches, tpa.paged_attention.launches_q8,
            tpa.ragged_paged_attention.launches,
            tpa.ragged_paged_attention.launches_q8)


def test_off_engine_prefix_hit_matches_jax_engine_and_generate(models):
    """The two-program layout: one prefill chunk, then one decode batch a
    step, through ``paged_chunk``, token for token as the JAX engine's
    off layout and ``generate()``."""
    jm, tm = models
    rng = np.random.RandomState(0)
    V = tm.config.vocab_size
    p0, p1, p2 = (rng.randint(0, V, n).tolist() for n in (21, 7, 13))
    p3 = p0[:16] + rng.randint(0, V, 5).tolist()     # shares 2 blocks
    knobs = dict(max_slots=4, block_size=8, num_blocks=64, prefill_chunk=8,
                 ragged="off")
    counts = _k6_counts()
    eng = ServingEngine(tm, device="cpu", **knobs)
    got, reqs = _serve(eng, [p0, p1, p2], 6, then=[p3])
    assert reqs[3].num_cached == 16                   # prefix-cache hit
    assert eng.ragged_steps == 0
    # chunks of 8: 3 + 1 + 2 + 1 (p3's 5 uncached tokens)
    assert eng.prefill_steps == 7 and eng.decode_steps > 0
    assert eng.prefill_tokens == 21 + 7 + 13 + 5
    assert eng.decode_tokens == 4 * 5                 # 1st token: prefill
    assert _k6_counts() == counts                     # plain on the CPU
    eng.shutdown()                                     # asserts no leaks
    jeng = JaxEngine(jm, **knobs)
    want, _ = _serve(jeng, [p0, p1, p2], 6, then=[p3])
    jeng.shutdown()
    assert got == want
    assert got == [_generate(jm, p, 6) for p in (p0, p1, p2, p3)]


def test_off_engine_preemption_matches_jax_engine_and_generate(models):
    jm, tm = models
    rng = np.random.RandomState(3)
    V = tm.config.vocab_size
    prompts = [rng.randint(0, V, 4).tolist() for _ in range(2)]
    knobs = dict(max_slots=2, block_size=4, num_blocks=4, prefill_chunk=4,
                 enable_prefix_cache=False, watermark=0.0, ragged="off")
    eng = ServingEngine(tm, device="cpu", **knobs)
    got, _ = _serve(eng, prompts, 12)
    assert eng.scheduler.preemptions >= 1
    assert eng.ragged_steps == 0
    eng.shutdown()
    jeng = JaxEngine(jm, **knobs)
    want, _ = _serve(jeng, prompts, 12)
    jeng.shutdown()
    assert got == want
    assert got == [_generate(jm, p, 12) for p in prompts]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_off_and_on_layouts_stream_the_same_tokens(models, kv_quant):
    _, tm = models
    rng = np.random.RandomState(4)
    V = tm.config.vocab_size
    prompts = [rng.randint(0, V, n).tolist() for n in (19, 3, 30, 9, 12)]
    outs = {}
    for ragged in ("on", "off"):
        eng = ServingEngine(tm, device="cpu", max_slots=3, block_size=8,
                            num_blocks=32, prefill_chunk=8, ragged=ragged,
                            kv_quant=kv_quant)
        outs[ragged], _ = _serve(eng, prompts[:3], 7, then=prompts[3:])
        assert (eng.ragged_steps > 0) == (ragged == "on")
        assert (eng.decode_steps > 0) == (ragged == "off")
        eng.shutdown()
    assert outs["off"] == outs["on"]


def test_off_engine_warmup_and_stream(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", max_slots=2, block_size=8,
                        num_blocks=16, prefill_chunk=8, ragged="off")
    eng.warmup()
    assert eng.stats().free_blocks == 16
    assert (eng.prefill_steps, eng.decode_steps) == (1, 1)
    rid = eng.submit([1, 2, 3], max_new_tokens=4)
    eng.start()
    assert len(list(eng.stream(rid))) == 4
    eng.shutdown()
    assert eng.ragged_steps == 0
