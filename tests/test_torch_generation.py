"""The port's decode entry points against the JAX package's: ``generate``,
``beam_search`` and ``speculative_generate`` over fp, int8 and int4
weights and fp or int8 KV caches, on GPT and Llama (GQA 2), the
quantizers behind them, the incremental ``forward(caches=...)``, SDPA's
masked path and the adapters' dense-cache steps.

Both packages hold the same f32 weights (the JAX model's, carried over
by ``params_from_paddle_tpu``) and see the same numpy inputs. The fp
cases run at 128 wide (``gpt_tiny``, ``llama_tiny``); the quantized ones
at 256 wide, since ``_quantize_tree`` leaves every weight with a dim
under 256 in full precision (the test asserts the trees hold codes; a
ragged int4 in-dim is held in ``test_quantizers_match_jax_bitwise``).
Each JAX reference run is compiled once per module (``jax_runs``, or one
program for a chain of calls) and shared by the cases that read it; the
JAX quantization runs eagerly, as ``generate`` runs it (jitted, XLA
rounds its divisions apart). Tolerances, f32, the same arithmetic summed
in other orders over 2 layers:

* greedy, beam and speculative tokens EQUAL (far from any argmax tie at
  these seeds); speculative decoding's stats equal; the quantizers'
  codes and scales bit for bit;
* ``forward(caches=...)`` logits within atol 1e-4 and the returned
  caches within 1e-5, at past 0 (causal prompt), at s > 1 with past > 0
  (the JAX offset mask; the port's bottom-right causal attention) and at
  one token;
* SDPA with a bool or a float ``attn_mask`` within 1e-5 of the JAX
  composition;
* the adapters' ``prefill`` / ``step`` / ``chunk_step`` logits within
  1e-4; int8 caches: scales within rtol 1e-5 and codes within 1 of each
  other (a value that lands within rounding of a half step may round
  either way), at most 1% of them off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.nn.functional import (
    scaled_dot_product_attention as jax_sdpa)
import paddle_tpu_torch
from paddle_tpu_torch.convert import params_from_paddle_tpu
from paddle_tpu_torch.incubate.nn.cuda import flash_attn as fa
from paddle_tpu_torch.incubate.nn.cuda import norms as tn
from paddle_tpu_torch.incubate.nn.functional import (
    scaled_dot_product_attention)
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, beam_search,
                                     generate, gpt_tiny, llama_tiny,
                                     speculative_generate)
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.nn.functional.common import dropout_mask

# tiny shapes: one torch thread a test process (more only contend
# with the other pytest-xdist workers for the cores)
torch.set_num_threads(1)

LOGITS_ATOL = 1e-4
CACHE_ATOL = 1e-5

# name -> (seed, JAX config, port config). The "q" models are 256 wide
# (vocab and ffn too), the least width _quantize_tree quantizes at, so
# that every matmul weight but Llama's k / v (256 x 128) takes codes and
# the JAX package's eager quantization meets few shapes
_QGPT = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
             intermediate_size=256, max_position_embeddings=64)
_QLLAMA = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
               num_kv_heads=2, intermediate_size=256,
               max_position_embeddings=64)
MODELS = {
    "gpt": (11, lambda: pt.models.gpt_tiny(dropout=0.0,
                                            attention_dropout=0.0),
            lambda: gpt_tiny()),
    "gpt_q": (21, lambda: JaxGPTConfig(dropout=0.0, attention_dropout=0.0,
                                       **_QGPT),
              lambda: GPTConfig(**_QGPT)),
    "gpt_draft": (23, lambda: pt.models.gpt_tiny(dropout=0.0,
                                                  attention_dropout=0.0),
                  lambda: gpt_tiny()),
    "llama": (13, lambda: pt.models.llama_tiny(), lambda: llama_tiny()),
    "llama_q": (5, lambda: JaxLlamaConfig(**_QLLAMA),
                lambda: LlamaConfig(**_QLLAMA)),
}


def _build(name):
    seed, jcfg, tcfg = MODELS[name]
    pt.seed(seed)
    llama = name.startswith("llama")
    jm = (pt.models.LlamaForCausalLM if llama else pt.models.GPTForCausalLM)(
        jcfg())
    jm.eval()
    tm = (LlamaForCausalLM if llama else GPTForCausalLM)(tcfg(),
                                                          device="cpu")
    tm.load_state_dict(params_from_paddle_tpu(
        {k: v.numpy() for k, v in jm.state_dict().items()}))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _build(name)
        return cache[name]
    return get


def _ids(vocab, shape, seed):
    return np.random.RandomState(seed).randint(0, vocab, shape) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def jax_runs():
    """Each JAX reference run once a module: key -> its numpy result."""
    cache = {}

    def get(key, fn):
        if key not in cache:
            cache[key] = fn()
        return cache[key]
    return get


# ------------------------------------------------------------ quantizers
def _weights(shape, seed):
    # values spread over decades, a column of zeros (the 1e-8 floor) and
    # exact ties at half steps of the codes
    rng = np.random.RandomState(seed)
    w = (rng.randn(*shape) * 10.0 ** rng.uniform(-3, 0, shape)) \
        .astype(np.float32)
    w[:, 3] = 0.0
    w[:, 5] = np.arange(shape[0]) % 5 - 2.0
    return w


@pytest.mark.parametrize("kind", ["int8", "int4", "int4_ragged", "kv"])
def test_quantizers_match_jax_bitwise(kind):
    """``_quantize_w`` (per channel), ``_quantize_w4`` (groups of 128; a
    ragged in-dim falls back to int8) and ``_quantize_kv`` (per position
    and head): codes and scales bit for bit, dtypes too."""
    import jax.numpy as jnp

    if kind == "kv":
        x = _weights((48, 16), 1).reshape(2, 3, 8, 16)   # [b, nh, T, hd]
        want = jgen._quantize_kv(jnp.asarray(x))
        got = tgen._quantize_kv(torch.from_numpy(x))
    else:
        shape = (200, 256) if kind == "int4_ragged" else (256, 96)
        w = _weights(shape, 2)
        fn = "_quantize_w" if kind == "int8" else "_quantize_w4"
        want = getattr(jgen, fn)(jnp.asarray(w))
        got = getattr(tgen, fn)(torch.from_numpy(w))
    assert set(got) == set(want) == ({"q4i8", "s4"} if kind == "int4"
                                     else {"q8", "s"})
    for key, v in want.items():
        assert str(got[key].dtype).split(".")[-1] == str(v.dtype), key
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      np.asarray(v, np.float32),
                                      err_msg=key)
    if kind == "int4":
        assert int(got["q4i8"].abs().max()) == 7


@pytest.mark.parametrize("name", ["gpt_q", "llama_q"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_trees_match_jax(models, name, bits):
    """The trees ``generate`` serves from, cached on the models: the same
    leaves quantized (codes and scales bit for bit), the same left in
    full precision, the tied / untied head int8 in int4 mode."""
    jm, tm = models(name)
    attr = "_gen_quant_w" if bits == 8 else "_gen_quant_w4"
    jq = jgen._quantized_weights(jm, jm.decode_adapter().weights, bits)
    tq = tgen._quantized_weights(tm, tm.decode_adapter().weights, bits)
    assert getattr(tm, attr) is tq
    kinds = []

    def walk(j, t, path):
        if isinstance(j, dict) and ("q8" in j or "q4i8" in j):
            assert set(j) == set(t), path
            kinds.append(("q8" if "q8" in j else "q4i8", path))
            for k in j:
                np.testing.assert_array_equal(
                    t[k].float().numpy(), np.asarray(j[k], np.float32),
                    err_msg=path + k)
        elif isinstance(j, dict):
            assert set(j) == set(t), path
            for k in j:
                walk(j[k], t[k], path + k + ".")
        elif isinstance(j, (list, tuple)):
            for i, (a, b) in enumerate(zip(j, t)):
                walk(a, b, path + str(i) + ".")
        elif j is not None:
            assert not isinstance(t, dict), path
    walk(jq, tq, "")
    got = dict((p, k) for k, p in kinds)
    assert got["lm_head."] == "q8"
    assert "q4i8" not in got.values() if bits == 8 else \
        "q4i8" in got.values()
    if name == "llama_q":
        # 256 x 128: left in full precision
        assert "layers.0.k_w." not in got and "layers.0.q_w." in got


# ------------------------------------------------------------ generate
GEN_CASES = {
    # name -> (model, weight_quant, kv_cache_quant, prompt shape)
    "gpt-fp": ("gpt", None, None, (2, 7)),
    "gpt-w8": ("gpt_q", "int8", None, (3, 9)),
    "gpt-w4-kv8": ("gpt_q", "int4", "int8", (3, 9)),
    "llama-fp": ("llama", None, None, (2, 7)),
    "llama-w8-kv8": ("llama_q", "int8", "int8", (2, 11)),
    "llama-w4": ("llama_q", "int4", None, (2, 11)),
}
NEW = 8


def _jax_generate(jax_runs, jm, key, ids, **kw):
    return jax_runs(("gen", key), lambda: jm.generate(
        pt.to_tensor(ids), **kw).numpy())


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generate_matches_jax(models, jax_runs, case):
    name, wq, kvq, shape = GEN_CASES[case]
    jm, tm = models(name)
    ids = _ids(tm.config.vocab_size, shape, 3)
    kw = dict(max_new_tokens=NEW, weight_quant=wq, kv_cache_quant=kvq)
    want = _jax_generate(jax_runs, jm, case, ids, **kw)
    got = tm.generate(ids, **kw)
    assert got.dtype == torch.int32 and got.shape == (shape[0], NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    # the module function is the method, and a second call (the cached
    # quantized tree) gives the same tokens
    np.testing.assert_array_equal(generate(tm, torch.from_numpy(ids), **kw),
                                  want)


def test_generate_eos_clamps_as_jax(models, jax_runs):
    jm, tm = models("gpt")
    ids = _ids(1024, GEN_CASES["gpt-fp"][3], 3)
    free = _jax_generate(jax_runs, jm, "gpt-fp", ids, max_new_tokens=NEW,
                         weight_quant=None, kv_cache_quant=None)
    eos = int(free[0, 2])
    want = _jax_generate(jax_runs, jm, "eos", ids, max_new_tokens=NEW,
                         eos_token_id=eos)
    got = tm.generate(ids, max_new_tokens=NEW, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    # row 0 stops at its first eos and holds it; before it, the free run
    first = int(np.flatnonzero(got[0] == eos)[0])
    assert first <= 2 and (got[0, first:] == eos).all()
    np.testing.assert_array_equal(got[0, :first], free[0, :first])


def _nucleus(logits, temperature, top_p):
    """The tokens the sampler may draw: those whose probability mass
    before them (sorted descending, ties by lower id) is under top_p."""
    p = torch.softmax(logits.double() / temperature, -1)
    sp, idx = torch.sort(p, descending=True, stable=True)
    keep = (torch.cumsum(sp, -1) - sp) < top_p
    return [set(idx[r][keep[r]].tolist()) for r in range(p.shape[0])]


def test_sampling_stays_in_the_nucleus_and_follows_the_seed(models):
    """Temperature + top-p draws: every token lies in the nucleus of the
    model's distribution given the tokens drawn before it (the logits
    replayed through the cached forward); one seed gives the same tokens,
    another seed others; temperature 1 without top-p samples."""
    import paddle_tpu_torch

    _, tm = models("gpt")
    ids = _ids(1024, (3, 6), 5)
    t, p = 0.8, 0.5
    paddle_tpu_torch.seed(7)
    a = tm.generate(ids, max_new_tokens=6, temperature=t, top_p=p)
    paddle_tpu_torch.seed(7)
    b = tm.generate(ids, max_new_tokens=6, temperature=t, top_p=p)
    paddle_tpu_torch.seed(8)
    c = tm.generate(ids, max_new_tokens=6, temperature=t, top_p=p)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():
        seq = torch.cat([torch.from_numpy(ids), a], 1).long()
        lg = tm(seq)                         # [3, 12, V]
    for j in range(a.shape[1]):
        allowed = _nucleus(lg[:, ids.shape[1] - 1 + j], t, p)
        for r in range(3):
            assert int(a[r, j]) in allowed[r], (r, j)
    greedy = tm.generate(ids, max_new_tokens=6)
    assert not torch.equal(tm.generate(ids, max_new_tokens=6,
                                       temperature=1.0), greedy)


# ------------------------------------------------------------ beam search
BEAM_CASES = {
    # name -> (model, weight_quant, kv_cache_quant, beams, length_penalty)
    "gpt-fp-lp0": ("gpt", None, None, 4, 0.0),
    "gpt-w8-kv8-lp1": ("gpt_q", "int8", "int8", 3, 1.0),
    "gpt-w4-kv8-lp0": ("gpt_q", "int4", "int8", 3, 0.0),
}


@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_beam_search_matches_jax(models, jax_runs, case):
    name, wq, kvq, K, lp = BEAM_CASES[case]
    jm, tm = models(name)
    ids = _ids(tm.config.vocab_size, (2, 6), 11)
    kw = dict(max_new_tokens=6, num_beams=K, length_penalty=lp,
              weight_quant=wq, kv_cache_quant=kvq)
    want = jax_runs(("beam", case), lambda: jm.beam_search(
        pt.to_tensor(ids), **kw).numpy())
    got = beam_search(tm, ids, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tm.beam_search(ids, **kw).numpy(), want)


def test_beam_of_one_is_greedy_and_eos_freezes_beams(models):
    """The port's own contracts: one beam is ``generate``'s greedy
    stream (every quant tier), and with an eos every beam that emitted
    it continues with eos only."""
    _, tm = models("gpt_q")
    ids = _ids(256, (2, 6), 12)
    for kw in ({}, {"weight_quant": "int4", "kv_cache_quant": "int8"}):
        assert torch.equal(tm.beam_search(ids, max_new_tokens=6,
                                          num_beams=1, **kw),
                           tm.generate(ids, max_new_tokens=6, **kw))
    free = tm.beam_search(ids, max_new_tokens=6, num_beams=3)
    eos = int(free[0, 1])
    got = tm.beam_search(ids, max_new_tokens=6, num_beams=3,
                         eos_token_id=eos)
    for row in got.numpy():
        hits = np.flatnonzero(row == eos)
        if hits.size:
            assert (row[hits[0]:] == eos).all()


# ------------------------------------------------------------ speculative
SPEC_CASES = {
    # name -> (model, draft, extra keywords)
    "draft_layers": ("gpt", None, dict(gamma=3, draft_layers=1)),
    "draft_model": ("gpt", "gpt_draft", dict(gamma=4)),
    "int8_eos": ("gpt_q", None, dict(gamma=2, draft_layers=1,
                                     weight_quant="int8",
                                     kv_cache_quant="int8")),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_speculative_matches_jax(models, jax_runs, case):
    """Tokens and stats equal JAX's, per-row acceptance over a batch of
    different prompts, and equal to the port's own greedy stream of the
    same tier (the exact-greedy contract)."""
    name, draft, kw = SPEC_CASES[case]
    jm, tm = models(name)
    kw = dict(kw, max_new_tokens=12, return_stats=True)
    ids = _ids(tm.config.vocab_size, (3, 9), 7)
    if draft:
        jd, td = models(draft)
        jkw, tkw = dict(kw, draft_model=jd), dict(kw, draft_model=td)
    else:
        jkw = tkw = kw
    tiers = {k: kw.get(k) for k in ("weight_quant", "kv_cache_quant")}
    if case == "int8_eos":
        greedy = tm.generate(ids, max_new_tokens=12, **tiers).numpy()
        kw["eos_token_id"] = jkw["eos_token_id"] = \
            tkw["eos_token_id"] = int(greedy[0, 4])

    def run():
        toks, stats = pt.models.speculative_generate(jm, pt.to_tensor(ids),
                                                     **jkw)
        return toks.numpy(), stats
    want, want_stats = jax_runs(("spec", case), run)
    got, stats = speculative_generate(tm, ids, **tkw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats == want_stats
    assert stats["iterations"] >= 1
    assert 0.0 <= stats["mean_accepted"] <= kw["gamma"]
    greedy = tm.generate(ids, max_new_tokens=12, **tiers,
                         eos_token_id=kw.get("eos_token_id")).numpy()
    np.testing.assert_array_equal(got.numpy(), greedy)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_kv_write_rows_drops_past_the_end(quant):
    """``_kv_write_rows`` drops positions at or past the cache's end, as
    the JAX scatter's ``mode="drop"`` does (held against a loop that
    writes only the positions inside): rows wholly inside, partly past
    and wholly past the end."""
    rng = np.random.RandomState(4)
    T = 6
    cache = torch.from_numpy(rng.randn(3, 2, T, 4).astype(np.float32))
    k = torch.from_numpy(rng.randn(3, 3, 2, 4).astype(np.float32))
    pos = torch.tensor([[1, 2, 3], [4, 5, 6], [6, 7, 8]])
    if quant:
        cache = tgen._quantize_kv(cache)
        rows = tgen._quantize_kv(k)
        want = {key: v.clone() for key, v in cache.items()}
    else:
        rows, want = {"x": k}, {"x": cache.clone()}
    for r in range(3):
        for j in range(3):
            if pos[r, j] < T:
                for key in want:
                    want[key][r, :, pos[r, j]] = rows[key][r, j]
    got = tgen._kv_write_rows(cache, k, pos)
    for key in want:
        assert torch.equal(got if key == "x" else got[key], want[key])


# ------------------------------------------------------------ errors
ERRORS = {
    "overlong": ("gpt", "generate", dict(max_new_tokens=8), 250),
    "kv_quant": ("gpt", "generate", dict(kv_cache_quant="int4"), 4),
    "weight_quant": ("gpt", "generate", dict(weight_quant="int2"), 4),
    "beam_kv_quant": ("gpt", "beam_search", dict(kv_cache_quant="fp8"), 4),
    "no_draft": ("gpt", "speculative_generate", {}, 4),
    "both_drafts": ("gpt", "speculative_generate",
                    dict(draft_layers=1, draft_model="gpt"), 4),
    "draft_layers": ("gpt", "speculative_generate",
                     dict(draft_layers=99), 4),
    "gamma": ("gpt", "speculative_generate",
              dict(draft_layers=1, gamma=0), 4),
    "spec_kv_quant": ("gpt", "speculative_generate",
                      dict(draft_layers=1, kv_cache_quant="int4"), 4),
    "draft_vocab": ("gpt", "speculative_generate",
                    dict(draft_model="llama_q"), 4),
    "spec_overlong": ("gpt", "speculative_generate",
                      dict(draft_layers=1, max_new_tokens=30), 220),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_match_jax(models, case):
    """Every argument the reference refuses raises ``ValueError`` with
    the reference's text, before any work."""
    name, fn, kw, plen = ERRORS[case]
    jm, tm = models(name)
    ids = np.zeros((1, plen), np.int32)
    jkw, tkw = dict(kw), dict(kw)
    if "draft_model" in kw:
        jkw["draft_model"], tkw["draft_model"] = models(kw["draft_model"])
    with pytest.raises(ValueError) as want:
        getattr(pt.models, fn)(jm, pt.to_tensor(ids), **jkw)
    with pytest.raises(ValueError) as got:
        getattr(tgen, fn)(tm, ids, **tkw)
    assert str(got.value) == str(want.value)


def test_kernel_calls_take_what_the_kernels_take(models, monkeypatch):
    """Every norm (K7) and attention (K1) call that decoding makes, on
    the CPU, passes the layout rules of the kernels it takes on the card
    (the plain versions take any layout, so a view that the kernels
    refuse would show only there): norms on contiguous rows and
    residuals, attention on unit-stride head dims in 16-byte steps."""
    import importlib

    fo = importlib.import_module(
        "paddle_tpu_torch.incubate.nn.functional.fused_ops")
    ffa = importlib.import_module(
        "paddle_tpu_torch.incubate.nn.functional.flash_attention")
    norm, attention = fo._forward, ffa._attention
    seen = {"norm": 0, "attention": 0}

    def checked_norm(kind, x, w, b, eps, bias=None, residual=None):
        assert x.is_contiguous() and w.is_contiguous() and w.dim() == 1
        assert residual is None or (residual.is_contiguous()
                                    and residual.shape == x.shape)
        assert bias is None or bias.shape == x.shape[-1:]
        seen["norm"] += 1
        return norm(kind, x, w, b, eps, bias, residual)

    def checked_attention(q, k, v, causal):
        for t in (q, k, v):
            assert t.stride(-1) == 1 and all(
                t.stride(i) % 4 == 0 for i in range(3))
        seen["attention"] += 1
        return attention(q, k, v, causal)

    monkeypatch.setattr(fo, "_forward", checked_norm)
    monkeypatch.setattr(ffa, "_attention", checked_attention)
    for name in ("gpt_q", "llama_q"):
        _, tm = models(name)
        ids = _ids(256, (2, 5), 9)
        for kw in ({}, {"weight_quant": "int4", "kv_cache_quant": "int8"}):
            tm.generate(ids, max_new_tokens=3, **kw)
            tm.beam_search(ids, max_new_tokens=3, num_beams=2, **kw)
            speculative_generate(tm, ids, max_new_tokens=3, draft_layers=1,
                                 **kw)
        with torch.no_grad():
            lg, caches = tm(torch.from_numpy(ids).long(),
                            caches=tm.init_caches(2))
            tm(lg[:, -1].argmax(-1)[:, None], caches=caches)
    assert seen["norm"] > 0 and seen["attention"] > 0


def test_decoding_runs_where_the_model_is():
    """Without a GPU a model wanted on the card (no device given) is not
    made, so nothing decodes there; a CPU model decodes on the CPU
    through the plain versions, launching no kernel."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTForCausalLM(gpt_tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(llama_tiny())
    counts = (fa.flash_fwd.launches, tn.rms_norm.launches,
              tn.layer_norm.launches)
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.int32)
    assert tm.generate(ids, max_new_tokens=2).device.type == "cpu"
    assert tm.beam_search(ids, max_new_tokens=2, num_beams=2) \
        .device.type == "cpu"
    assert speculative_generate(tm, ids, max_new_tokens=2,
                                draft_layers=1).device.type == "cpu"
    assert (fa.flash_fwd.launches, tn.rms_norm.launches,
            tn.layer_norm.launches) == counts


# ------------------------------------------------------------ forward
# the three calls of one incremental run: (name, first token, last)
REGIMES = (("past0", 0, 5), ("offset_mask", 5, 8), ("one_token", 8, 9))


@pytest.fixture(scope="module")
def chains(models):
    """Each model's incremental run over the same 9 tokens in both
    packages: per regime the logits and the caches after it."""
    out = {}

    def get(name):
        if name in out:
            return out[name]
        jm, tm = models(name)
        ids = np.random.RandomState(0).randint(
            0, tm.config.vocab_size, (2, 9)).astype(np.int32)

        def chain(ids):
            # the three calls in one program: one compile
            caches, outs = jm.init_caches(2), []
            with pt.no_grad():
                for _, a, b in REGIMES:
                    lg, caches = jm(Tensor(ids[:, a:b]), caches=caches)
                    outs.append((lg._data, [(k._data, v._data)
                                            for k, v in caches]))
            return outs
        jouts = jax.jit(chain)(ids)
        tc = tm.init_caches(2)
        runs = {}
        with torch.no_grad():
            for (regime, a, b), (jl, jc) in zip(REGIMES, jouts):
                tl, tc = tm(torch.from_numpy(ids[:, a:b]).long(), caches=tc)
                runs[regime] = (np.asarray(jl), [tuple(map(np.asarray, c))
                                                 for c in jc], tl, tc)
        out[name] = ids, runs
        return out[name]
    return get


@pytest.mark.parametrize("regime", [r[0] for r in REGIMES])
@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_forward_with_caches_matches_jax(chains, name, regime):
    _, runs = chains(name)
    jl, jc, tl, tc = runs[regime]
    np.testing.assert_allclose(tl.numpy(), jl, atol=LOGITS_ATOL, rtol=0)
    assert len(tc) == len(jc)
    for (tk, tv), (jk, jv) in zip(tc, jc):
        assert tk.shape == jk.shape
        np.testing.assert_allclose(tk.numpy(), jk, atol=CACHE_ATOL, rtol=0)
        np.testing.assert_allclose(tv.numpy(), jv, atol=CACHE_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_cached_forward_continues_the_full_forward(models, chains, name):
    """The incremental logits are the full-sequence forward's at the same
    positions (the same model, one call over the 9 tokens)."""
    _, tm = models(name)
    ids, runs = chains(name)
    with torch.no_grad():
        full = tm(torch.from_numpy(ids).long())
    for regime, a, b in REGIMES:
        np.testing.assert_allclose(runs[regime][2].numpy(),
                                   full[:, a:b].numpy(), atol=LOGITS_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_eager_cached_loop_equals_generate(models, name):
    """Greedy ``generate`` equals the step-by-step eager decode through
    ``forward(caches=...)`` (the reference's own contract,
    tests/test_generation.py), the caches growing a token a call."""
    _, tm = models(name)
    ids = np.random.RandomState(1).randint(
        0, tm.config.vocab_size, (2, 7)).astype(np.int32)
    got = tm.generate(ids, max_new_tokens=6).numpy()
    ref = []
    with torch.no_grad():
        caches = tm.init_caches(2)
        logits, caches = tm(torch.from_numpy(ids).long(), caches=caches)
        for i in range(6):
            tok = logits[:, -1].argmax(-1)
            ref.append(tok.numpy())
            if i < 5:
                logits, caches = tm(tok[:, None], caches=caches)
                assert caches[0][0].shape[1] == 8 + i
    np.testing.assert_array_equal(got, np.stack(ref, 1))


# ------------------------------------------------------------ masked SDPA
def _qkv(seed, b=2, sq=5, sk=7, h=3, d=8):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for s in (sq, sk, sk)]


MASKS = {
    # name -> mask of [b, h, sq, sk] scores (broadcast)
    "bool_offset": lambda: np.arange(7)[None, :] <= np.arange(5)[:, None]
    + 2,
    "bool_per_row": lambda: np.random.RandomState(3).rand(2, 1, 5, 7) > 0.3,
    "float": lambda: np.random.RandomState(4).randn(1, 3, 5, 7)
    .astype(np.float32),
}


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_sdpa_with_a_mask_matches_jax(mask):
    q, k, v = _qkv(0)
    m = MASKS[mask]()
    want = jax_sdpa(*(pt.to_tensor(a) for a in (q, k, v)),
                    attn_mask=pt.to_tensor(m)).numpy()
    got = scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        attn_mask=torch.from_numpy(np.asarray(m)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_sdpa_mask_dropout_drops_probabilities():
    """With a mask, dropout drops the softmax's probabilities (the
    reference's masked path), drawn from the port's generator: the output
    is the masked composition over the kept probabilities / (1 - p),
    reproducible under one seed, other under another, and the mask's
    dropout is off outside training."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1))
    m = torch.from_numpy(MASKS["bool_offset"]())
    p = 0.4
    paddle_tpu_torch.seed(3)
    got = scaled_dot_product_attention(q, k, v, attn_mask=m, dropout_p=p)
    paddle_tpu_torch.seed(3)
    keep = dropout_mask((2, 3, 5, 7), p, "cpu")
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * 8 ** -0.5
    w = torch.softmax(torch.where(m, logits, -1e9), -1)
    w = torch.where(keep, w / (1 - p), 0.0)
    want = torch.einsum("bhqk,bkhd->bqhd", w, v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=0)
    paddle_tpu_torch.seed(4)
    other = scaled_dot_product_attention(q, k, v, attn_mask=m, dropout_p=p)
    assert not torch.equal(got, other)
    plain = scaled_dot_product_attention(q, k, v, attn_mask=m, dropout_p=p,
                                         training=False)
    np.testing.assert_allclose(plain.numpy(), torch.einsum(
        "bhqk,bkhd->bqhd", torch.softmax(torch.where(m, logits, -1e9), -1),
        v).numpy(), atol=1e-6, rtol=0)


# ------------------------------------------------------------ adapters
def _close_caches(got, want):
    for g, w in zip(got, want):
        if isinstance(w, dict):
            np.testing.assert_allclose(g["s"].numpy(), np.asarray(w["s"]),
                                       rtol=1e-5, atol=0)
            diff = np.abs(g["q8"].numpy().astype(np.int32)
                          - np.asarray(w["q8"], np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=CACHE_ATOL, rtol=0)


@pytest.mark.parametrize("name,kv", [("llama", "int8")])
def test_adapter_steps_match_jax(models, name, kv):
    """``prefill`` (plen 6 into 16 slots), ``step`` at position 6 and
    ``chunk_step`` of 3 tokens at per-row positions (row 1's last one,
    16, past the cache: dropped), each against the JAX adapter's on its
    own outputs: logits and every cache. Llama over int8 caches: GQA
    repeats of the int8 panels and RoPE at per-row positions (GPT's
    chunk step and int8 caches meet JAX's in the speculative tests of
    tests/test_torch_generation.py, token for token)."""
    jm, tm = models(name)
    jad, tad = jm.decode_adapter(), tm.decode_adapter()
    jw, tw = jad.weights, tad.weights
    quant, total = kv == "int8", 16
    rng = np.random.RandomState(2)
    V = tm.config.vocab_size
    ids = rng.randint(0, V, (2, 6)).astype(np.int32)
    tok = rng.randint(0, V, (2,)).astype(np.int32)
    toks = rng.randint(0, V, (2, 3)).astype(np.int32)
    pos = np.array([[7, 8, 9], [14, 15, 16]], np.int32)

    mask = np.arange(total) <= 6

    def jchain(w):
        # the three calls in one program: one compile
        x, ck, cv = jad.prefill(w, ids, total, kv_quant=quant)
        outs = [(jad.logits(w, x[:, -1]), ck, cv)]
        outs.append(jad.step(w, tok, jnp.int32(6), ck, cv, mask))
        outs.append(jad.chunk_step(w, toks, pos, *outs[-1][1:]))
        return outs
    want = jax.jit(jchain)(jw)

    x, tck, tcv = tad.prefill(tw, torch.from_numpy(ids), total,
                              kv_quant=quant)
    got = [(tad.logits(tw, x[:, -1]), tck, tcv)]
    got.append(tad.step(tw, torch.from_numpy(tok), 6, tck, tcv,
                        torch.from_numpy(mask)))
    # the step wrote its row in place: compare its caches before the chunk
    _close_caches(tck + tcv, want[1][1] + want[1][2])
    got.append(tad.chunk_step(tw, torch.from_numpy(toks),
                              torch.from_numpy(pos).long(), tck, tcv))
    assert got[2][0].shape == (2, 3, V)
    for (tl, _, _), (jl, _, _) in zip(got, want):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGITS_ATOL, rtol=0)
    _close_caches(tck + tcv, want[2][1] + want[2][2])
