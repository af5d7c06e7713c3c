"""The port's paged decode attention (K6's plain version) and the
adapters' ``paged_chunk`` (the step of the two-program ``ragged="off"``
serving layout) against the JAX package's, on the CPU.

The same numpy inputs go through both packages in f32. The plain
``paged_attention_ref`` is held against the JAX Pallas ``_decode_kernel``
(interpret mode, as tests/test_paged_attention.py runs it) over fp pools
and against ``_xla_paged_attention`` over int8 pools (the JAX package
sends int8 pools there), within rtol=atol=2e-4, the JAX tests' own
tolerance (online against direct softmax). ``paged_chunk`` logits of a
decode batch with idle rows and of a prefill chunk with padding agree
within atol=1e-4 (the ragged step's limit: the same f32 arithmetic summed
in other orders over 2 layers); the pools they write as the ragged
tests hold them. The engine's off-layout streams are held in
tests/test_torch_gpt_serving.py and tests/test_torch_llama_serving.py;
the Hopper kernel itself against the plain version in
tests/test_torch_kernels_cuda.py, on the card.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu_torch.convert import params_from_paddle_tpu
from paddle_tpu_torch.incubate.nn.cuda import norms as tn
from paddle_tpu_torch.incubate.nn.cuda import paged_attention as tpa
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_tiny, llama_tiny)
from paddle_tpu_torch.models.generation import _paged_attn_chunk
from paddle_tpu_torch.serving import EngineConfig
from test_torch_kernels_cuda import DECODE_MIXES, _decode_setup

# tiny shapes: one torch thread a test process (more only contend
# with the other pytest-xdist workers for the cores)
torch.set_num_threads(1)

# the pallas package exports a function of the module's own name
jpa = importlib.import_module(
    "paddle_tpu.incubate.nn.pallas.paged_attention")
jgen = importlib.import_module("paddle_tpu.models.generation")

TOL = dict(rtol=2e-4, atol=2e-4)


def _np(*arrays, to=torch.from_numpy):
    return [to(a) for a in arrays]


@pytest.mark.parametrize("mix", sorted(DECODE_MIXES))
def test_ref_matches_jax_pallas_decode_kernel(mix):
    """MHA and GQA 2 / 4, contexts shorter than a page, empty rows,
    out-of-range block ids, one block table shared by a prefill chunk's
    rows."""
    lens, nh, nkv, shared = DECODE_MIXES[mix]
    q, kp, vp, bt, cl = _decode_setup(lens, nh, nkv, shared, seed=51)
    want = np.asarray(jpa.paged_attention(
        *_np(q, kp, vp, bt, cl, to=jnp.asarray), interpret=True,
        use_kernel=True))
    got = tpa.paged_attention_ref(*_np(q, kp, vp, bt, cl)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[cl == 0] == 0).all()


@pytest.mark.parametrize("mix", ["decode", "gqa4", "short"])
def test_ref_matches_jax_xla_composition(mix):
    lens, nh, nkv, shared = DECODE_MIXES[mix]
    q, kp, vp, bt, cl = _decode_setup(lens, nh, nkv, shared, seed=52)
    want = np.asarray(jpa.paged_attention(
        *_np(q, kp, vp, bt, cl, to=jnp.asarray), use_kernel=False))
    got = tpa.paged_attention_ref(*_np(q, kp, vp, bt, cl)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mix", sorted(DECODE_MIXES))
def test_q8_ref_matches_jax_xla_composition(mix):
    """Over int8 pools, each package quantizing the same fp pools by its
    own write rule (the same codes: test_torch_paged_attention.py)."""
    lens, nh, nkv, shared = DECODE_MIXES[mix]
    q, kp, vp, bt, cl = _decode_setup(lens, nh, nkv, shared, seed=53)
    jk, jv = (jpa.quantize_kv_pages(jnp.asarray(p)) for p in (kp, vp))
    tk, tv = (tpa.quantize_kv_pages(torch.from_numpy(p)) for p in (kp, vp))
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(cl)))
    got = tpa.paged_attention_ref(torch.from_numpy(q), tk, tv,
                                  *_np(bt, cl)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[cl == 0] == 0).all()


def test_paged_attn_chunk_matches_jax():
    """The chunk attention of both layouts' shapes: a [1, g] prefill chunk
    with padding at position -1 and a [b, 1] decode batch with an idle
    row, q [b, g, heads, d]."""
    rng = np.random.RandomState(54)
    n_kv, nh, d, page, n_pages = 2, 4, 32, 8, 20
    kp = rng.randn(n_kv, n_pages, page, d).astype(np.float32)
    vp = rng.randn(n_kv, n_pages, page, d).astype(np.float32)
    for pos in (np.asarray([[5, 6, 7, 8, 9, 10, -1, -1]], np.int32),
                np.asarray([[17], [-1], [3], [30]], np.int32)):
        b, g = pos.shape
        q = rng.randn(b, g, nh, d).astype(np.float32)
        bt = rng.permutation(n_pages)[:b * 4].reshape(b, 4).astype(np.int32)
        want = np.asarray(jgen._paged_attn_chunk(
            *_np(q, kp, vp, bt, pos, to=jnp.asarray), d))
        got = _paged_attn_chunk(*_np(q, kp, vp, bt, pos), d).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        assert (got[pos < 0] == 0).all()


def test_decode_input_checks():
    lens, nh, nkv, _ = DECODE_MIXES["gqa2"]
    q, kp, vp, bt, cl = _np(*_decode_setup(lens, nh, nkv))
    tpa.check_decode_inputs(q, kp, vp, bt, cl)
    k8, v8 = tpa.quantize_kv_pages(kp), tpa.quantize_kv_pages(vp)
    tpa.check_decode_inputs(q.bfloat16(), k8, v8, bt, cl)
    bad = {
        "dtype": (q.half(), kp.half(), vp.half(), bt, cl),
        "int64_lens": (q, kp, vp, bt, cl.long()),
        "rows": (q[:-1], kp, vp, bt, cl),
        "lens_rows": (q, kp, vp, bt, cl[:-1]),
        "page": (q, kp[:, :, :12].contiguous(), vp[:, :, :12].contiguous(),
                 bt, cl),
        "head_dim": (torch.zeros(4, 4, 264), torch.zeros(2, 9, 16, 264),
                     torch.zeros(2, 9, 16, 264), bt, cl),
        "group": (torch.zeros(4, 34, 32), kp[:1], vp[:1], bt, cl),
        "contiguous": (q.transpose(0, 1).contiguous().transpose(0, 1), kp,
                       vp, bt, cl),
        "mixed_pools": (q, k8, vp, bt, cl),
        "q8_head_dim": (torch.zeros(4, 4, 40),
                        tpa.quantize_kv_pages(torch.zeros(2, 9, 16, 40)),
                        tpa.quantize_kv_pages(torch.zeros(2, 9, 16, 40)),
                        bt, cl),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            tpa.check_decode_inputs(*args)
        print(name, "raises")


def test_decode_wrapper_raises_on_cpu_tensors():
    """K6's wrapper takes CUDA tensors only: ``_paged_attn_chunk`` picks
    the plain version for CPU tensors, never the wrapper."""
    lens, nh, nkv, _ = DECODE_MIXES["decode"]
    q, kp, vp, bt, cl = _np(*_decode_setup(lens, nh, nkv))
    before = (tpa.paged_attention.launches, tpa.paged_attention.launches_q8)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention(q, kp, vp, bt, cl)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention(q, tpa.quantize_kv_pages(kp),
                            tpa.quantize_kv_pages(vp), bt, cl)
    assert (tpa.paged_attention.launches,
            tpa.paged_attention.launches_q8) == before


def test_ragged_knob_takes_auto_on_off():
    assert EngineConfig(ragged="off").ragged == "off"
    assert EngineConfig(ragged="ON").ragged == "on"
    with pytest.raises(ValueError, match="auto|on|off"):
        EngineConfig(ragged="bogus")


# ------------------------------------------------------------ paged_chunk
@pytest.fixture(scope="module")
def models():
    pt.seed(11)
    jg = pt.models.GPTForCausalLM(
        pt.models.gpt_tiny(dropout=0.0, attention_dropout=0.0))
    pt.seed(12)
    jl = pt.models.LlamaForCausalLM(pt.models.llama_tiny())
    out = {}
    for name, jm, tm in (("gpt", jg, GPTForCausalLM(gpt_tiny(),
                                                     device="cpu")),
                         ("llama", jl, LlamaForCausalLM(llama_tiny(),
                                                        device="cpu"))):
        jm.eval()
        state = {k: v.numpy() for k, v in jm.state_dict().items()}
        tm.load_state_dict(params_from_paddle_tpu(state))
        out[name] = (jm, tm)
    return out


def _chunk_inputs(cfg, rng, kind, quant):
    """A [4, 1] decode batch (histories 20, 4 and 9, one idle row) or a
    [1, 12] prefill chunk at positions 8..17 with two padding tokens,
    over random pools of 40 pages of 8."""
    n_kv = getattr(cfg, "num_kv_heads", cfg.num_heads)
    hd, L, page, n_pages, P = cfg.head_dim, cfg.num_layers, 8, 40, 8
    if kind == "decode":
        pos = np.asarray([[20], [-1], [4], [9]], np.int32)
    else:
        pos = np.full((1, 12), -1, np.int32)
        pos[0, :10] = np.arange(8, 18)
    b, g = pos.shape
    toks = rng.randint(0, cfg.vocab_size, (b, g)).astype(np.int32)
    bt = rng.permutation(n_pages)[:b * P].reshape(b, P).astype(np.int32)
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
    return (toks, pos, bt), (jk, jv), (tk, tv)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("model", ["gpt", "llama"])
def test_paged_chunk_logits_match_jax(models, model, kv_quant, kind):
    jm, tm = models[model]
    rng = np.random.RandomState(55)
    (toks, pos, bt), (jk, jv), (tk, tv) = _chunk_inputs(tm.config, rng,
                                                        kind, kv_quant)
    jad = jm.decode_adapter()
    jl, jkp, jvp = jad.paged_chunk(jad.weights, jnp.asarray(toks),
                                   jnp.asarray(pos), jk, jv, jnp.asarray(bt))
    tad = tm.decode_adapter()
    counts = (tpa.paged_attention.launches, tpa.paged_attention.launches_q8,
              tn.rms_norm.launches, tn.layer_norm.launches)
    tl, tkp, tvp = tad.paged_chunk(tad.weights, *_np(toks, pos), tk, tv,
                                   torch.from_numpy(bt))
    assert (tpa.paged_attention.launches, tpa.paged_attention.launches_q8,
            tn.rms_norm.launches, tn.layer_norm.launches) == counts
    assert tkp is tk and tvp is tv              # written in place
    live = pos >= 0
    assert tl.shape == toks.shape + (tm.config.vocab_size,)
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


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("model,kv_quant", [("gpt", None),
                                            ("llama", "int8")])
def test_paged_chunk_hands_k6_inputs_it_takes(models, model, kv_quant,
                                              kind):
    """Every attention call of ``paged_chunk`` passes K6's input checks:
    the kernel reads raw pointers, so the card refuses, for one, a
    prefill chunk's block table broadcast to its rows without a copy
    (stride 0, not contiguous)."""
    _, tm = models[model]
    rng = np.random.RandomState(56)
    (toks, pos, bt), _, (tk, tv) = _chunk_inputs(tm.config, rng, kind,
                                                 kv_quant)
    rows = []

    def checked(q, kp, vp, block_tables, lens, scale):
        tpa.check_decode_inputs(q, kp, vp, block_tables, lens)
        rows.append(q.shape[0])
        return tpa.paged_attention_ref(q, kp, vp, block_tables, lens, scale)

    tad = tm.decode_adapter()
    tad.paged_chunk(tad.weights, *_np(toks, pos), tk, tv,
                    torch.from_numpy(bt), attn=checked)
    assert rows == [toks.size] * tm.config.num_layers
