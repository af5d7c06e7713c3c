"""The port's Llama serving path against the JAX package's, on llama_tiny
(2 layers, 4 query heads over 2 kv heads, RMSNorm, RoPE, SwiGLU, untied
head), over fp and int8 KV pools.

Both packages hold the same f32 weights (the JAX model's, carried over
by ``params_from_paddle_tpu``) and see the same numpy inputs. Logits of
one packed ragged step agree within atol=1e-4 (f32, the same arithmetic
summed in other orders over 2 layers); the fp pools written by the step
within 1e-5; the int8 pools' codes within one step of 1 (a k row that
lands within rounding of a half step may round either way) and their
scales within rtol 1e-5. Greedy token streams are equal.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models.generation import _rope as jax_rope
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.convert import params_from_paddle_tpu
from paddle_tpu_torch.incubate.nn.cuda import norms as tn
from paddle_tpu_torch.incubate.nn.cuda import paged_attention as tpa
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     llama2_7B, llama_tiny)
from paddle_tpu_torch.models.generation import _rope, _rope_angles
from paddle_tpu_torch.serving import EngineConfig, ServingEngine

# tiny shapes: one torch thread a test process (more only contend
# with the other pytest-xdist workers for the cores)
torch.set_num_threads(1)

# the pallas package exports a function of the module's own name
jpa = importlib.import_module(
    "paddle_tpu.incubate.nn.pallas.paged_attention")


@pytest.fixture(scope="module")
def models():
    pt.seed(12)
    jm = pt.models.LlamaForCausalLM(pt.models.llama_tiny())
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    tm.load_state_dict(params_from_paddle_tpu(state))
    return jm, tm


def test_config_rules_match_jax():
    for kw in ({}, {"num_kv_heads": 8}, {"hidden_size": 5120,
                                          "num_heads": 40}):
        j, t = pt.models.llama.LlamaConfig(**kw), LlamaConfig(**kw)
        assert (t.num_kv_heads, t.intermediate_size, t.head_dim) == \
            (j.num_kv_heads, j.intermediate_size, j.head_dim)
    for name in ("llama_tiny", "llama2_7B"):
        j = getattr(pt.models, name)()
        t = {"llama_tiny": llama_tiny, "llama2_7B": llama2_7B}[name]()
        # the port's fields only: the JAX training options (recompute,
        # lm_ce_chunks, sequence_parallel_mode) come with Llama training
        assert vars(t) == {k: getattr(j, k) for k in vars(t)}, name


def test_params_carry_over(models):
    jm, tm = models
    jstate = jm.state_dict()
    tstate = tm.state_dict()
    assert len(jstate) == 21                 # 2 x 9 + embed, norm, head
    assert set(jstate) == set(tstate)
    for k, v in jstate.items():
        np.testing.assert_array_equal(tstate[k].numpy(), v.numpy())


def test_forward_is_not_ported(models):
    """The full-sequence forward trains since Llama training was ported;
    its KV-cache form runs too: GQA caches of num_kv_heads panels grow by
    each call's tokens."""
    _, tm = models
    logits, caches = tm(torch.zeros(1, 4, dtype=torch.long),
                        caches=tm.init_caches(1))
    assert logits.shape == (1, 4, tm.config.vocab_size)
    assert caches[0][0].shape == (1, 4, tm.config.num_kv_heads,
                                  tm.config.head_dim)


def test_rope_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(6, 4, 32).astype(np.float32)
    pos = np.asarray([0, 1, 17, 255, 4000, 3], np.int32)
    # as the JAX ragged_chunk calls it: x [T, 1, h, d], pos [T, 1]
    want = np.asarray(jax_rope(jnp.asarray(x)[:, None],
                               jnp.asarray(pos)[:, None], 10000.0))[:, 0]
    got = _rope(torch.from_numpy(x),
                *_rope_angles(torch.from_numpy(pos), 32, 10000.0))
    # angles up to 4000 rad: cos/sin of large f32 arguments differ by an
    # ulp or so between the two libraries
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def _step_inputs(cfg, rng, quant):
    n_kv, hd, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    page, n_pages, P = 8, 40, 8
    # rows: decode (history 20), prefill chunk of 10 at position 8, idle
    # slot, decode (history 4); then 3 padding tokens
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
    if quant:
        jk = tuple(jpa.quantize_kv_pages(jnp.asarray(a)) for a in kp)
        jv = tuple(jpa.quantize_kv_pages(jnp.asarray(a)) for a in vp)
        tk = tuple(tpa.quantize_kv_pages(torch.from_numpy(a)) for a in kp)
        tv = tuple(tpa.quantize_kv_pages(torch.from_numpy(a)) for a in vp)
    else:
        jk, jv = tuple(map(jnp.asarray, kp)), tuple(map(jnp.asarray, vp))
        tk = tuple(torch.from_numpy(a.copy()) for a in kp)
        tv = tuple(torch.from_numpy(a.copy()) for a in vp)
    return (toks, pos, row_of, qs, ql, cl), bt, (jk, jv), (tk, tv)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_ragged_chunk_logits_match_jax(models, kv_quant):
    jm, tm = models
    rng = np.random.RandomState(7)
    meta, bt, (jk, jv), (tk, tv) = _step_inputs(tm.config, rng, kv_quant)
    jad = jm.decode_adapter()
    jl, jkp, jvp = jad.ragged_chunk(jad.weights, *map(jnp.asarray, meta),
                                    jk, jv, jnp.asarray(bt))
    tad = tm.decode_adapter()
    counts = (tpa.ragged_paged_attention.launches,
              tpa.ragged_paged_attention.launches_q8, tn.rms_norm.launches)
    tl, tkp, tvp = tad.ragged_chunk(tad.weights,
                                    *map(torch.from_numpy, meta), tk, tv,
                                    torch.from_numpy(bt))
    assert (tpa.ragged_paged_attention.launches,
            tpa.ragged_paged_attention.launches_q8,
            tn.rms_norm.launches) == counts    # the CPU takes plain versions
    live = meta[1] >= 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               rtol=0, atol=1e-4)
    for a, b in zip(tkp + tvp, jkp + jvp):
        if kv_quant is None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5)
            continue
        codes = a["q8"].numpy().astype(int) - np.asarray(b["q8"]).astype(int)
        assert np.abs(codes).max() <= 1
        np.testing.assert_allclose(a["s"].numpy(), np.asarray(b["s"]),
                                   rtol=1e-5, atol=0)


def _drain(eng, cap=500):
    n = 0
    while eng.step() and n < cap:
        n += 1
    assert n < cap, "engine failed to drain"


def _serve(eng, prompts, max_new, then=()):
    """Submit ``prompts``, drain; then submit ``then`` and drain again
    (its prompts can hit the prefix cache of the first wave)."""
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    _drain(eng)
    rids += [eng.submit(p, max_new_tokens=max_new) for p in then]
    reqs = [eng._requests[r] for r in rids]
    _drain(eng)
    return [eng.result(r) for r in rids], reqs


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_engine_prefix_hit_matches_jax_engine(models, kv_quant):
    jm, tm = models
    rng = np.random.RandomState(0)
    V = tm.config.vocab_size
    p0, p1, p2 = (rng.randint(0, V, n).tolist() for n in (21, 7, 13))
    p3 = p0[:16] + rng.randint(0, V, 5).tolist()     # shares 2 blocks
    knobs = dict(max_slots=4, block_size=8, num_blocks=64, prefill_chunk=8,
                 kv_quant=kv_quant)
    eng = ServingEngine(tm, device="cpu", **knobs)
    if kv_quant:
        assert eng._kp[0]["q8"].dtype == torch.int8
    got, reqs = _serve(eng, [p0, p1, p2], 6, then=[p3])
    assert reqs[3].num_cached == 16                   # prefix-cache hit
    assert eng.prefill_tokens == 21 + 7 + 13 + 5
    eng.shutdown()                                     # asserts no leaks
    jeng = JaxEngine(jm, **knobs)
    want, _ = _serve(jeng, [p0, p1, p2], 6, then=[p3])
    jeng.shutdown()
    assert got == want


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_engine_preemption_matches_jax_engine(models, kv_quant):
    jm, tm = models
    rng = np.random.RandomState(3)
    V = tm.config.vocab_size
    prompts = [rng.randint(0, V, 4).tolist() for _ in range(2)]
    # 4 blocks of 4: both admit, growth exhausts the pool and the
    # younger request is evicted, recomputed, and still matches
    knobs = dict(max_slots=2, block_size=4, num_blocks=4, prefill_chunk=4,
                 enable_prefix_cache=False, watermark=0.0,
                 kv_quant=kv_quant)
    eng = ServingEngine(tm, device="cpu", **knobs)
    got, _ = _serve(eng, prompts, 12)
    assert eng.scheduler.preemptions >= 1
    eng.shutdown()
    jeng = JaxEngine(jm, **knobs)
    want, _ = _serve(jeng, prompts, 12)
    jeng.shutdown()
    assert got == want


def test_int8_engine_serves_gpt_too():
    """The engine is model-generic: GPT over int8 pools streams the same
    greedy tokens as GPT over fp pools, on this short prompt."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny

    m = GPTForCausalLM(gpt_tiny(), device="cpu", seed=3)
    outs = []
    for q in (None, "int8"):
        eng = ServingEngine(m, device="cpu", max_slots=2, block_size=8,
                            num_blocks=16, prefill_chunk=8, kv_quant=q)
        outs.append(_serve(eng, [[5, 9, 11, 2, 7, 1, 3]], 4)[0])
        eng.shutdown()
    assert outs[0] == outs[1]


def test_kv_quant_is_none_or_int8():
    with pytest.raises(ValueError, match="kv_quant"):
        EngineConfig(kv_quant="fp8")
    assert EngineConfig(kv_quant="int8").kv_quant == "int8"


# ------------------------------------------------- the ragged="off" layout
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_off_engine_prefix_hit_matches_jax_engine(models, kv_quant):
    """The two-program layout over fp and int8 pools (GQA, K6's plain
    version on the CPU), token for token as the JAX engine's off layout."""
    jm, tm = models
    rng = np.random.RandomState(0)
    V = tm.config.vocab_size
    p0, p1, p2 = (rng.randint(0, V, n).tolist() for n in (21, 7, 13))
    p3 = p0[:16] + rng.randint(0, V, 5).tolist()     # shares 2 blocks
    knobs = dict(max_slots=4, block_size=8, num_blocks=64, prefill_chunk=8,
                 kv_quant=kv_quant, ragged="off")
    counts = (tpa.paged_attention.launches, tpa.paged_attention.launches_q8)
    eng = ServingEngine(tm, device="cpu", **knobs)
    got, reqs = _serve(eng, [p0, p1, p2], 6, then=[p3])
    assert reqs[3].num_cached == 16                   # prefix-cache hit
    assert eng.ragged_steps == 0 and eng.prefill_steps == 7
    assert eng.prefill_tokens == 21 + 7 + 13 + 5
    assert (tpa.paged_attention.launches,
            tpa.paged_attention.launches_q8) == counts
    eng.shutdown()                                     # asserts no leaks
    jeng = JaxEngine(jm, **knobs)
    want, _ = _serve(jeng, [p0, p1, p2], 6, then=[p3])
    jeng.shutdown()
    assert got == want


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_off_engine_preemption_matches_jax_engine(models, kv_quant):
    jm, tm = models
    rng = np.random.RandomState(3)
    V = tm.config.vocab_size
    prompts = [rng.randint(0, V, 4).tolist() for _ in range(2)]
    knobs = dict(max_slots=2, block_size=4, num_blocks=4, prefill_chunk=4,
                 enable_prefix_cache=False, watermark=0.0,
                 kv_quant=kv_quant, ragged="off")
    eng = ServingEngine(tm, device="cpu", **knobs)
    got, _ = _serve(eng, prompts, 12)
    assert eng.scheduler.preemptions >= 1
    eng.shutdown()
    jeng = JaxEngine(jm, **knobs)
    want, _ = _serve(jeng, prompts, 12)
    jeng.shutdown()
    assert got == want


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
        eng.shutdown()
    assert outs["off"] == outs["on"]
