"""The port's sharded training step against the JAX one on the same mesh.

The JAX ``TrainStep(mesh=..., fsdp_axis=..., batch_specs=...)`` runs on
conftest's virtual CPU devices; the port's runs in spawned gloo ranks,
one process a rank (``tests/_torch_mesh_workers.py``, torch only), from
the JAX model's weights and on the same batch: 4 x 32 tokens, the
ignored labels spread unevenly over the rows. Models: ``gpt_tiny`` and
``llama_tiny`` with recompute and ``lm_ce_chunks=4``; AdamW (lr 1e-3,
weight decay 0.01, bf16 first moment, factored second moment), clip 1.0;
meshes dp 2 x mp 2 with ``fsdp_axis="dp"``, dp 4 with ``fsdp_axis="dp"``
and mp 2. One spawn of 4 ranks runs every 4-rank mesh and the unit
checks, one of 2 ranks the mp 2 mesh, both while this process runs the
JAX steps.

Tolerances, all f32 but the bf16 first moment, as in
``test_torch_gpt_training.py``: losses of each of 3 steps rtol 1e-5;
parameters after 3 steps atol 5e-5 (a moment on a bf16 rounding boundary
may round the other way), the key third of GPT's ``qkv_proj.bias`` atol
3 lr (its gradient is zero in exact arithmetic, so Adam normalises
rounding noise); ``m`` within one bf16 step (atol 2^-7 max |m| a
tensor, the step of bf16's 8-bit significand at the largest entry; the
key-bias third excluded); ``vr`` / ``vc``
(sums of g^2 in f32) rtol 1e-4 with atol 1e-6 of the tensor's max. The
mesh runs against the port's own one-process run: the same bounds. The
pieces: the vocab-parallel CE and embedding, the per-head qkv split, the
row-parallel bias, the factored statistics on row and column splits, the
global grad norm (rtol 1e-6 / 1e-5 in f32) and the bitwise round trip
of ``convert``'s shard and gather helpers.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed import ProcessMesh as JaxMesh
from paddle_tpu_torch.distributed import ProcessMesh, spawn
from paddle_tpu_torch.distributed.sharding import Layout, param_layout
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForCausalLM, gpt_tiny, llama_tiny,
                                     LlamaForCausalLM)
from paddle_tpu_torch.optimizer import AdamW

import _torch_mesh_workers as W

torch.set_num_threads(1)

CASES = [(mesh, kind) for mesh in W.MESHES for kind in W.MODELS]
SEEDS = {"gpt": 11, "llama": 12}


def _jax_model(kind):
    pt.seed(SEEDS[kind])
    if kind == "gpt":
        return pt.models.GPTForCausalLM(pt.models.gpt_tiny(
            dropout=0.0, attention_dropout=0.0, recompute=True,
            lm_ce_chunks=4))
    return pt.models.LlamaForCausalLM(pt.models.llama_tiny(
        recompute=True, lm_ce_chunks=4))


def _batch():
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 1024, (4, 32)).astype(np.int64)
    labels = rng.randint(0, 1024, (4, 32)).astype(np.int64)
    labels[0, :11] = -100                 # dp rank 0 of 2 or 4
    labels[1, 20:] = -100
    labels[3, :2] = -100
    return ids, labels


def _f32(x):
    return np.asarray(x).astype(np.float32)


def _jax_run(mesh_name, kind):
    """The JAX step on the same mesh: the loss of each of 3 steps, the
    parameters and m / vr / vc after them."""
    shape, names, fsdp = W.MESHES[mesh_name]
    jm = _jax_model(kind)
    ids, labels = _batch()
    opt = pt.optimizer.AdamW(learning_rate=W.LR, weight_decay=0.01,
                             parameters=jm.parameters(), factored_v=True,
                             moment_dtype="bfloat16")
    mesh = JaxMesh(np.arange(int(np.prod(shape))).reshape(shape),
                   dim_names=list(names))
    step = pt.jit.TrainStep(jm, opt, mesh=mesh, fsdp_axis=fsdp,
                            grad_clip_norm=1.0,
                            batch_specs=[("dp", None), ("dp", None)])
    jb = (pt.to_tensor(ids), pt.to_tensor(labels))
    losses = [float(step(*jb).numpy()) for _ in range(W.STEPS)]
    step.sync_params_to_model()
    out = {"losses": np.array(losses)}
    out.update({k: _f32(v.numpy()) for k, v in jm.state_dict().items()})
    for key in ("m", "vr", "vc"):
        for i, e in enumerate(step.opt_state[key]):
            out["%s:%d" % (key, i)] = _f32(e)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything both packages computed: {"jax": {(mesh, kind): ...},
    "port": {...}, "one": {kind: ...}, plus the workers' other files}."""
    out = tmp_path_factory.mktemp("mesh")
    ids, labels = _batch()
    np.savez(out / "batch.npz", ids=ids, labels=labels)
    weights = {}
    for kind in W.MODELS:
        weights[kind] = {k: _f32(v.numpy())
                         for k, v in _jax_model(kind).state_dict().items()}
        np.savez(out / ("weights_%s.npz" % kind), **weights[kind])
    # the ranks run while this process runs the JAX steps and the
    # one-process reference
    ranks = [spawn(W.run_ranks, (str(out), n), nprocs=n, join=False)
             for n in (4, 2)]
    res = {"jax": {c: _jax_run(*c) for c in CASES}, "weights": weights,
           "one": {}}
    for kind in W.MODELS:
        losses, m, step = W.train(kind, weights[kind], (ids, labels))
        one = {"losses": np.array(losses)}
        one.update({k: v.detach().numpy() for k, v in
                    m.state_dict().items()})
        one.update(W.flat_state({k: [e.float().numpy() for e in v]
                                 for k, v in step.opt_state.items()
                                 if isinstance(v, list)}))
        res["one"][kind] = one
    for ctx in ranks:
        while not ctx.join():
            pass
    res["files"] = {p.stem: dict(np.load(p)) for p in out.glob("*.npz")
                    if not p.stem.startswith(("weights", "batch"))}
    return res


@pytest.mark.parametrize("mesh,kind", CASES)
def test_mesh_step_matches_jax_on_the_same_mesh(runs, mesh, kind):
    got = runs["files"]["%s_%s" % (mesh, kind)]
    want = runs["jax"][(mesh, kind)]
    W.assert_run_close(got, want, list(runs["weights"][kind]))
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("mesh,kind", CASES)
def test_mesh_step_matches_one_process(runs, mesh, kind):
    W.assert_run_close(runs["files"]["%s_%s" % (mesh, kind)],
                      runs["one"][kind], list(runs["weights"][kind]))


@pytest.mark.parametrize("kind", W.MODELS)
def test_run_steps_on_a_mesh(runs, kind):
    """One step, then run_steps(2), on dp 2 x mp 2: the last loss and
    the parameters of three single steps."""
    got = runs["files"]["chained_" + kind]
    want = runs["files"]["dp2mp2_" + kind]
    np.testing.assert_allclose(got["losses"][-1], want["losses"][-1],
                               rtol=1e-6)
    for name in runs["weights"][kind]:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("kind", W.MODELS)
def test_gradient_merge_on_a_mesh(runs, kind):
    """accumulate_steps=2 on dp 2 x mp 2 (each global micro-batch split
    over dp, as the JAX step splits it) against the one-process run."""
    ids, labels = _batch()
    losses, m, _ = W.train(kind, runs["weights"][kind], (ids, labels),
                           accumulate=2)
    got = runs["files"]["accumulate_" + kind]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for name, p in m.state_dict().items():
        g = W.key_third(name, got[name])[1]
        w = W.key_third(name, p.numpy())[1]
        np.testing.assert_allclose(g, w, atol=5e-5, err_msg=name)


def test_vocab_parallel_ce_and_embedding(runs):
    u = runs["files"]["units4"]
    np.testing.assert_allclose(u["loss"][0], u["loss"][1], rtol=1e-6)
    np.testing.assert_allclose(u["dx"], u["dx_want"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(u["dw"], u["dw_want"], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(u["emb"], u["emb_want"])


def test_qkv_head_split_and_row_parallel_bias(runs):
    u = runs["files"]["units2"]
    assert bool(u["qkv_heads"])
    np.testing.assert_allclose(u["attn"], u["attn_want"], rtol=1e-5,
                               atol=1e-6)
    # a bias added on each of the 2 ranks would be off by the bias
    assert np.abs(u["bias"]).max() > 1e-2


@pytest.mark.parametrize("split", ["rows", "cols", "both", "repl"])
def test_factored_v_on_shards(runs, split):
    u = runs["files"]["units4"]
    np.testing.assert_allclose(u["p_" + split], u["p_want_" + split],
                               rtol=1e-6, atol=1e-6)
    if "vr_" + split in u:
        for key in ("vr_", "vc_"):
            np.testing.assert_allclose(u[key + split],
                                       u[key.replace("_", "_want_") + split],
                                       rtol=1e-6)


def test_global_grad_norm_counts_replicated_once(runs):
    norm = runs["files"]["units4"]["norm"]
    np.testing.assert_allclose(norm[0], norm[1], rtol=1e-6)


def test_semi_auto_surface(runs):
    u = runs["files"]["units4"]
    back, moved, summed, full = u["semi"]
    np.testing.assert_array_equal(back, full)
    np.testing.assert_array_equal(moved, full)
    np.testing.assert_array_equal(summed, full)
    assert tuple(u["local_shape"]) == (2, 3)


def test_collectives(runs):
    """Rank 0's results: all_reduce (sum, max), all_gather, broadcast
    from rank 2, reduce_scatter (rank 0's piece: sum over ranks of 10 r)."""
    np.testing.assert_array_equal(runs["files"]["units4"]["coll"],
                                  [6, 6, 3, 0, 1, 2, 3, 2, 60, 60])


def test_convert_round_trip_through_the_ranks(runs):
    assert bool(runs["files"]["units4"]["convert_round_trip"])


@pytest.mark.parametrize("kind", W.MODELS)
def test_layouts_round_trip_offline(kind):
    """Every parameter cut into the four pieces of dp 2 x mp 2 with FSDP
    and put together again: bitwise (no collective)."""
    mesh = ProcessMesh(np.arange(4).reshape(2, 2), ["dp", "mp"])
    m = W.port_model(kind)
    for name, p in m.named_parameters():
        lay = param_layout(p, mesh, "dp")
        full = p.detach()
        pieces = [lay.piece(full, c).clone() for c in mesh.all_coords()]
        assert all(tuple(x.shape) == lay.local_shape for x in pieces), name
        assert torch.equal(lay.assemble(pieces), full), name
    qkv = param_layout(m.gpt.h[0].attn.qkv_proj.weight, mesh, "dp") \
        if kind == "gpt" else None
    if qkv is not None:
        assert qkv.spec == ("dp", "mp") and qkv.parts == (1, 3)


def _mesh(shape, names):
    return ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape), names)


UNPORTED = {
    "fsdp over sp": lambda: (GPTForCausalLM(gpt_tiny(), device="cpu"),
                             dict(mesh=_mesh((2, 2), ["dp", "sp"]),
                                  fsdp_axis="sp")),
    "ep axis": lambda: (GPTForCausalLM(gpt_tiny(), device="cpu"),
                        dict(mesh=_mesh((2, 2), ["ep", "mp"]))),
    "pp x mp": lambda: (GPTForCausalLM(gpt_tiny(), device="cpu"),
                        dict(mesh=_mesh((2, 2), ["pp", "mp"]))),
    "fsdp over mp": lambda: (GPTForCausalLM(gpt_tiny(), device="cpu"),
                             dict(mesh=_mesh((2, 2), ["dp", "mp"]),
                                  fsdp_axis="mp")),
    "moe": lambda: (GPTForCausalLM(gpt_tiny(moe_num_experts=4),
                                   device="cpu"),
                    dict(mesh=_mesh((2,), ["dp"]))),
    "dropout": lambda: (GPTForCausalLM(gpt_tiny(dropout=0.1),
                                       device="cpu"),
                        dict(mesh=_mesh((2,), ["dp"]))),
    "8-bit moments": lambda: (GPTForCausalLM(gpt_tiny(), device="cpu"),
                              dict(mesh=_mesh((2,), ["dp"]),
                                   optimizer=AdamW(moment_quant="8bit"))),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_mesh_options_raise(case):
    model, kw = UNPORTED[case]()
    opt = kw.pop("optimizer", AdamW())
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TrainStep(model, opt, device="cpu", **kw)


def test_tp_overlap_on_a_mesh_raises(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TP_OVERLAP", "on")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TrainStep(GPTForCausalLM(gpt_tiny(), device="cpu"), AdamW(),
                  mesh=_mesh((2,), ["mp"]), device="cpu")


def test_kv_heads_must_divide_by_mp():
    with pytest.raises(ValueError, match="num_kv_heads"):
        TrainStep(LlamaForCausalLM(llama_tiny(), device="cpu"), AdamW(),
                  mesh=_mesh((4,), ["mp"]), device="cpu")


def test_run_steps_stream_on_a_mesh_raises(runs):
    assert bool(runs["files"]["units4"]["stream_raises"])


def test_mesh_needs_the_process_group():
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        TrainStep(GPTForCausalLM(gpt_tiny(), device="cpu"), AdamW(),
                  mesh=_mesh((2,), ["dp"]), device="cpu")


def test_layout_refuses_an_uneven_split():
    with pytest.raises(ValueError):
        Layout(_mesh((4,), ["mp"]), (6, 8), ("mp", None))
