"""The port's MoE path (``sort_dispatch``, K8's plain version
``grouped_matmul_ref``, ``moe_ffn_sorted`` and the serving op
``fused_moe``) against the JAX package's, on the CPU.

The same numpy inputs (f32) go through both packages. ``sort_dispatch``
must equal the JAX one in every integer field and in ``xp`` (a gather),
and its combine weights must be within 1 f32 ulp (the top-k renormalising
sum may add in another order), ties included: the port breaks top-k ties
toward the lower expert, as ``jax.lax.top_k`` does and ``torch.topk``
does not. ``grouped_matmul_ref`` is held against the Pallas kernel in
interpret mode (as tests/test_moe_dispatch.py runs it) at rtol=atol=1e-5
(one f32 product summed in another order, values of unit scale).
``moe_ffn_sorted`` and ``fused_moe`` are held against the JAX package's
Pallas-interpret and ``ragged_dot`` routes at rtol=atol=2e-5 (two f32
products and the combine, summed in other orders), gradients against
``jax.grad`` of the ragged route at rtol=atol=1e-4 (the vjp of the same
composition, its products summed in other orders over the whole batch).
``moe_ffn_sorted`` passes both products the dispatch's row counts
(``block_rows``, which the JAX function has no counterpart of): they are
held against the rows the JAX ``sort_dispatch`` fills, and the plain
version with them must equal it without them on a dispatch's ``xp``.
The Hopper kernel itself is held against the plain version in
tests/test_torch_kernels_cuda.py, on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.incubate.nn.pallas import moe_dispatch as jmoe
from paddle_tpu_torch.convert import params_from_paddle_tpu
from paddle_tpu_torch.incubate.nn.cuda import moe_dispatch as tk
from paddle_tpu_torch.incubate.nn.functional import fused_moe
from paddle_tpu_torch.incubate.nn.functional import moe_dispatch as tmoe

REF = dict(rtol=1e-5, atol=1e-5)
FFN = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
INT_FIELDS = ("dest", "block_gid", "group_sizes", "padded_sizes")


def _softmax(a):
    a = a - a.max(-1, keepdims=True)
    return np.exp(a) / np.exp(a).sum(-1, keepdims=True)


def _probs(case, s, e, rng):
    """Router probabilities [s, e] (f32) of one routing case."""
    if case == "random":
        return _softmax(rng.randn(s, e)).astype(np.float32)
    p = np.full((s, e), 1e-5, np.float32)
    if case == "ties":
        # rows of equal values, one clear winner with the rest tied, and
        # pairs tied at the k boundary
        p[0::3] = 1.0 / e
        p[1::3, 3 % e] = 0.9
        p[2::3, [1, e - 1]] = 0.4
        return p
    if case == "one_expert":
        # every token to expert 2; the second choice is a tie of the rest
        return _softmax(np.where(np.arange(e) == 2, 10.0, -10.0)[None]
                        .repeat(s, 0)).astype(np.float32)
    if case == "empty_experts":
        # only experts 1 and e - 2 receive tokens
        logits = rng.randn(s, e) - 30.0
        logits[:, [1, e - 2]] += 30.0
        return _softmax(logits).astype(np.float32)
    raise ValueError(case)


DISPATCH = {
    # name: (S, M, E, k, routing, normalize)
    "k2": (64, 16, 4, 2, "random", True),
    "k2_unnormalized": (64, 16, 4, 2, "random", False),
    "k1": (100, 8, 4, 1, "random", True),
    "k3_e8": (100, 8, 8, 3, "random", True),
    "ties_k2": (48, 8, 8, 2, "ties", True),
    "one_expert_k2": (96, 8, 4, 2, "one_expert", True),
    "one_expert_k1": (96, 8, 4, 1, "one_expert", True),
    "empty_experts": (70, 8, 8, 2, "empty_experts", True),
}


def _dispatch_inputs(name, seed=0):
    s, m, e, k, routing, normalize = DISPATCH[name]
    rng = np.random.RandomState(seed)
    x = rng.randn(s, m).astype(np.float32)
    return x, _probs(routing, s, e, rng), k, normalize


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_sort_dispatch_equals_jax(name):
    x, probs, k, normalize = _dispatch_inputs(name)
    want = jmoe.sort_dispatch(jnp.asarray(x), jnp.asarray(probs), k,
                              normalize=normalize)
    got = tk.sort_dispatch(torch.from_numpy(x), torch.from_numpy(probs), k,
                           normalize=normalize)
    assert set(got) == set(want)
    for f in INT_FIELDS:
        assert got[f].dtype == torch.int32, f
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]),
                                      err_msg=f)
    np.testing.assert_array_equal(got["xp"].numpy(), np.asarray(want["xp"]))
    np.testing.assert_array_max_ulp(got["weight"].numpy(),
                                    np.asarray(want["weight"]), maxulp=1)


def test_tie_case_fails_under_torch_topk():
    """The tie-heavy routing picks other experts under ``torch.topk``
    than under ``jax.lax.top_k``: the case above tests the tie rule."""
    _, probs, k, _ = _dispatch_inputs("ties_k2")
    want = np.asarray(jax.lax.top_k(jnp.asarray(probs), k)[1])
    naive = torch.topk(torch.from_numpy(probs), k).indices.numpy()
    assert (naive != want).any()
    np.testing.assert_array_equal(
        tk._top_k(torch.from_numpy(probs), k)[1].numpy(), want)


@pytest.mark.parametrize("n", [768, 40])
def test_grouped_matmul_ref_matches_pallas_kernel(n):
    """A non-monotone block map (the kernel's semantics are per block,
    not ragged_dot's expert-contiguous groups); N = 768 is the column
    count whose last 256 columns the Pallas grid once dropped."""
    rng = np.random.RandomState(n)
    e, kdim = 4, 64 if n == 768 else 24
    gid = np.array([2, 0, 3, 3, 1, 0], np.int32)
    xp = rng.randn(len(gid) * tk.BM, kdim).astype(np.float32)
    w = (rng.randn(e, kdim, n) / np.sqrt(kdim)).astype(np.float32)
    want = np.asarray(jmoe.grouped_matmul(
        jnp.asarray(xp), jnp.asarray(w), jnp.asarray(gid), impl="pallas",
        interpret=True))
    got = tk.grouped_matmul_ref(*map(torch.from_numpy, (xp, w, gid)))
    assert got.shape == (len(gid) * tk.BM, n)
    np.testing.assert_allclose(got.numpy(), want, **REF)


def test_grouped_matmul_ref_clamps_expert_ids():
    """An id outside [0, E) reads the nearest expert, as K8 does."""
    rng = np.random.RandomState(1)
    gid = np.array([5, -2, 1], np.int32)
    xp = rng.randn(3 * tk.BM, 16).astype(np.float32)
    w = rng.randn(3, 16, 8).astype(np.float32)
    got = tk.grouped_matmul_ref(*map(torch.from_numpy, (xp, w, gid)))
    want = np.concatenate([xp[i * tk.BM:(i + 1) * tk.BM] @ w[g]
                           for i, g in enumerate(np.clip(gid, 0, 2))])
    np.testing.assert_allclose(got.numpy(), want, **REF)


@pytest.mark.parametrize("name", ["k2", "k3_e8", "one_expert_k2",
                                  "empty_experts"])
def test_block_rows_count_the_jax_dispatch(name):
    """``block_rows`` counts, for each 128-row block, the rows the JAX
    ``sort_dispatch`` filled from a (token, k) pair (its ``dest``): all
    pairs on one expert and experts with no pair included."""
    x, probs, k, normalize = _dispatch_inputs(name)
    want = jmoe.sort_dispatch(jnp.asarray(x), jnp.asarray(probs), k,
                              normalize=normalize)
    d = tk.sort_dispatch(torch.from_numpy(x), torch.from_numpy(probs), k,
                         normalize=normalize)
    rows = tk.block_rows(d["block_gid"], d["group_sizes"],
                         d["padded_sizes"])
    n_blocks = d["block_gid"].numel()
    counted = np.bincount(np.asarray(want["dest"]) // tk.BM,
                          minlength=n_blocks)
    assert rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), counted)
    # and they are each block's first rows
    filled = np.zeros(n_blocks * tk.BM, bool)
    filled[np.asarray(want["dest"])] = True
    first = np.arange(tk.BM)[None] < counted[:, None]
    np.testing.assert_array_equal(filled.reshape(n_blocks, tk.BM), first)


@pytest.mark.parametrize("name", ["k2", "one_expert_k2", "empty_experts"])
def test_grouped_matmul_ref_row_counts_keep_dispatch_output(name):
    """On ``sort_dispatch``'s xp (pad rows zero) the plain version with
    the dispatch's row counts equals it without them, element for
    element."""
    x, probs, k, normalize = _dispatch_inputs(name)
    d = tk.sort_dispatch(torch.from_numpy(x), torch.from_numpy(probs), k,
                         normalize=normalize)
    rows = tk.block_rows(d["block_gid"], d["group_sizes"],
                         d["padded_sizes"])
    w = torch.from_numpy(np.random.RandomState(2).randn(
        probs.shape[1], x.shape[1], 24).astype(np.float32))
    full = tk.grouped_matmul_ref(d["xp"], w, d["block_gid"])
    got = tk.grouped_matmul_ref(d["xp"], w, d["block_gid"], rows=rows)
    assert (rows < tk.BM).any()
    torch.testing.assert_close(got, full, rtol=0, atol=0)


def test_grouped_matmul_ref_row_counts_zero_the_rest():
    """Rows of block i at or past ``rows[i]`` are zero (counts below 0
    or past 128 clamp), the rest as without counts."""
    rng = np.random.RandomState(3)
    gid = np.array([1, 0, 2, 1, 0], np.int32)
    counts = np.array([0, 64, 128, -3, 200], np.int32)
    xp = rng.randn(len(gid) * tk.BM, 16).astype(np.float32)
    w = rng.randn(3, 16, 8).astype(np.float32)
    got = tk.grouped_matmul_ref(*map(torch.from_numpy, (xp, w, gid)),
                                rows=torch.from_numpy(counts)).numpy()
    want = np.concatenate([xp[i * tk.BM:(i + 1) * tk.BM] @ w[g]
                           for i, g in enumerate(gid)])
    keep = (np.arange(tk.BM)[None] < np.clip(counts, 0, tk.BM)[:, None])
    want = want * keep.reshape(-1, 1)
    np.testing.assert_allclose(got, want, **REF)


def _ffn_inputs(s, m, e, dff, activation, routing, bias, seed):
    rng = np.random.RandomState(seed)
    h = 2 * dff if activation == "swiglu" else dff
    x = rng.randn(s, m).astype(np.float32)
    probs = _probs(routing, s, e, rng)
    w1 = (0.3 * rng.randn(e, m, h)).astype(np.float32)
    w2 = (0.3 * rng.randn(e, dff, m)).astype(np.float32)
    b1 = (0.1 * rng.randn(e, h)).astype(np.float32) if bias else None
    b2 = (0.1 * rng.randn(e, m)).astype(np.float32) if bias else None
    return x, probs, w1, w2, b1, b2


FFN_CASES = {
    # name: (S, M, E, dff, k, activation, routing, normalize, bias)
    "swiglu": (64, 32, 4, 48, 2, "swiglu", "random", True, False),
    "unnormalized_bias": (64, 32, 4, 48, 2, "swiglu", "random", False,
                          True),
    "gelu_bias": (40, 16, 4, 24, 2, "gelu", "random", True, True),
    "relu": (40, 16, 4, 24, 2, "relu", "random", True, False),
    "k1_extreme_imbalance": (96, 16, 4, 24, 1, "swiglu", "one_expert",
                             True, False),
    "k2_all_on_one_expert": (96, 16, 4, 24, 2, "swiglu", "one_expert",
                             True, False),
    "ties": (48, 16, 8, 24, 2, "swiglu", "ties", True, False),
}


@pytest.mark.parametrize("impl", ["pallas", "ragged"])
@pytest.mark.parametrize("name", sorted(FFN_CASES))
def test_moe_ffn_sorted_matches_jax(name, impl):
    s, m, e, dff, k, act, routing, normalize, bias = FFN_CASES[name]
    x, probs, w1, w2, b1, b2 = _ffn_inputs(s, m, e, dff, act, routing, bias,
                                           seed=len(name))
    jb = [None if b is None else jnp.asarray(b) for b in (b1, b2)]
    want = np.asarray(jmoe.moe_ffn_sorted(
        *map(jnp.asarray, (x, probs, w1, w2)), k=k, activation=act,
        normalize=normalize, b1=jb[0], b2=jb[1], impl=impl,
        interpret=True))
    tb = [None if b is None else torch.from_numpy(b) for b in (b1, b2)]
    before = tk.grouped_matmul.launches
    got = tmoe.moe_ffn_sorted(*map(torch.from_numpy, (x, probs, w1, w2)),
                              k=k, activation=act, normalize=normalize,
                              b1=tb[0], b2=tb[1])
    assert tk.grouped_matmul.launches == before    # the CPU takes no kernel
    assert got.shape == (s, m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FFN)


def test_moe_ffn_sorted_passes_row_counts(monkeypatch):
    """Both products of ``moe_ffn_sorted`` get the dispatch's row
    counts (so K8 skips padding on the card), with biases too."""
    x, probs, w1, w2, b1, b2 = _ffn_inputs(40, 16, 4, 24, "swiglu",
                                           "empty_experts", True, seed=7)
    seen = []
    plain = tmoe.grouped_matmul

    def spy(xp, w, block_gid, *, rows=None):
        seen.append(rows)
        return plain(xp, w, block_gid, rows=rows)

    monkeypatch.setattr(tmoe, "grouped_matmul", spy)
    tx, tp = torch.from_numpy(x), torch.from_numpy(probs)
    tmoe.moe_ffn_sorted(tx, tp, *map(torch.from_numpy, (w1, w2)), k=2,
                        b1=torch.from_numpy(b1), b2=torch.from_numpy(b2))
    d = tk.sort_dispatch(tx, tp, 2)
    want = tk.block_rows(d["block_gid"], d["group_sizes"],
                         d["padded_sizes"])
    assert len(seen) == 2
    for rows in seen:
        assert torch.equal(rows, want)


def test_moe_ffn_sorted_gradients_match_jax():
    """x, probs, w1 and w2 gradients of a weighted sum of the output
    against ``jax.grad`` of the ragged route (differentiable off the
    TPU), with biases."""
    x, probs, w1, w2, b1, b2 = _ffn_inputs(64, 32, 4, 48, "swiglu",
                                           "random", True, seed=5)
    cot = np.random.RandomState(6).randn(64, 32).astype(np.float32)

    def jloss(xx, pp, a, b):
        out = jmoe.moe_ffn_sorted(xx, pp, a, b, k=2, b1=jnp.asarray(b1),
                                  b2=jnp.asarray(b2), impl="ragged")
        return jnp.sum(out * jnp.asarray(cot))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, probs, w1, w2)))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, probs, w1, w2)]
    out = tmoe.moe_ffn_sorted(*leaves, k=2, b1=torch.from_numpy(b1),
                              b2=torch.from_numpy(b2))
    (out * torch.from_numpy(cot)).sum().backward()
    for name, t, g in zip(("x", "probs", "w1", "w2"), leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   err_msg=name, **GRAD)


def _op_weights(b, s, dm, dff, e, bias3d, seed, dtype=np.float32):
    """The op's arguments in the JAX package's layouts, as numpy; the
    weights in ``dtype`` (f32, or bf16 through jnp)."""
    rng = np.random.RandomState(seed)
    cast = (lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))) \
        if dtype == "bfloat16" else (lambda a: a.astype(np.float32))
    state = {
        "gate": cast(rng.randn(dm, e)),
        "ffn1": cast(0.3 * rng.randn(e, dm, 2 * dff)),
        "ffn2": cast(0.3 * rng.randn(e, dff, dm)),
    }
    if bias3d:
        state["ffn1_bias"] = cast(0.1 * rng.randn(e, 1, 2 * dff))
        state["ffn2_bias"] = cast(0.1 * rng.randn(e, 1, dm))
    x = rng.randn(b, s, dm).astype(np.float32)
    return x, state


FUSED = {
    # name: (gate: "weight" | "logits", bias [E, 1, .], top-k, normalize)
    "weight_gate": ("weight", False, 2, True),
    "logits_gate": ("logits", False, 2, True),
    "bias_e1": ("weight", True, 2, True),
    "top1_unnormalized": ("weight", False, 1, False),
}


@pytest.mark.parametrize("name", sorted(FUSED))
def test_fused_moe_matches_jax(name):
    gate, bias3d, k, norm = FUSED[name]
    b, s, dm, dff, e = 2, 24, 16, 24, 4
    x, state = _op_weights(b, s, dm, dff, e, bias3d, seed=len(name))
    if gate == "logits":        # precomputed router logits, [b, s, E]
        state["gate"] = np.random.RandomState(9).randn(b, s, e) \
            .astype(np.float32)
    tw = params_from_paddle_tpu(state)
    jf = pt.incubate.nn.functional
    names = ("gate", "ffn1", "ffn2")
    want = jf.fused_moe(
        pt.to_tensor(x), *(pt.to_tensor(state[n]) for n in names),
        ffn1_bias=pt.to_tensor(state["ffn1_bias"]) if bias3d else None,
        ffn2_bias=pt.to_tensor(state["ffn2_bias"]) if bias3d else None,
        moe_topk=k, norm_topk_prob=norm).numpy()
    got = fused_moe(torch.from_numpy(x), *(tw[n] for n in names),
                    ffn1_bias=tw.get("ffn1_bias"),
                    ffn2_bias=tw.get("ffn2_bias"), moe_topk=k,
                    norm_topk_prob=norm)
    assert got.shape == (b, s, dm)
    np.testing.assert_allclose(got.numpy(), want, **FFN)


def test_fused_moe_weights_carry_over_bit_for_bit():
    """bf16 weights of the JAX op through ``params_from_paddle_tpu``:
    the same bits, and the op on them (in f32 on both sides) agrees."""
    x, state = _op_weights(1, 20, 16, 24, 4, True, seed=3,
                           dtype="bfloat16")
    tw = params_from_paddle_tpu(state)
    for n, a in state.items():
        assert tw[n].dtype == torch.bfloat16, n
        np.testing.assert_array_equal(
            tw[n].view(torch.int16).numpy(), a.view(np.int16), err_msg=n)
    names = ("gate", "ffn1", "ffn2", "ffn1_bias", "ffn2_bias")
    want = np.asarray(pt.incubate.nn.functional.fused_moe(
        pt.to_tensor(x), *(pt.to_tensor(jnp.asarray(state[n], jnp.float32))
                           for n in names[:3]),
        ffn1_bias=pt.to_tensor(jnp.asarray(state[names[3]], jnp.float32)),
        ffn2_bias=pt.to_tensor(jnp.asarray(state[names[4]],
                                           jnp.float32))).numpy())
    got = fused_moe(torch.from_numpy(x), *(tw[n].float() for n in names[:3]),
                    ffn1_bias=tw[names[3]].float(),
                    ffn2_bias=tw[names[4]].float())
    np.testing.assert_allclose(got.numpy(), want, **FFN)


@pytest.mark.parametrize("quant", ["weight_only_int8", "w4a8"])
def test_fused_moe_quant_raises(quant):
    x, state = _op_weights(1, 4, 8, 8, 2, False, seed=0)
    tw = params_from_paddle_tpu(state)
    with pytest.raises(NotImplementedError):
        fused_moe(torch.from_numpy(x), tw["gate"], tw["ffn1"], tw["ffn2"],
                  quant_method=quant)


def test_grouped_matmul_dispatch():
    """CPU tensors take the plain version (no launch), CUDA tensors the
    kernel, any other device raises."""
    xp = torch.randn(tk.BM, 8)
    w = torch.randn(2, 8, 16)
    gid = torch.tensor([1], dtype=torch.int32)
    before = tk.grouped_matmul.launches
    torch.testing.assert_close(tmoe.grouped_matmul(xp, w, gid),
                               xp @ w[1], rtol=1e-6, atol=1e-6)
    assert tk.grouped_matmul.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        tmoe.grouped_matmul(xp.to("meta"), w.to("meta"), gid.to("meta"))
