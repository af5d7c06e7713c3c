"""The port's sequence parallelism against the JAX package's.

The functions: ``ring_attention_sharded`` / ``ulysses_attention_sharded``
of ``paddle_tpu_torch.distributed.sequence_parallel`` over gloo groups of
2 and 4 ranks against the JAX ones over meshes of 2 and 4 of conftest's
virtual CPU devices, at the JAX tests' shapes (b 2, s 64, h 8, d 16, f32
from numpy seed 0): outputs, causal and full, within atol / rtol 2e-5
(the JAX tests' bound against their reference), and the grads of
sum(out^2) within 1e-4.

The whole slice: the port's ``TrainStep`` on a mesh with an ``sp`` axis
against the JAX ``TrainStep`` on the same mesh and batch
(``batch_specs=[("dp", "sp")] * 2``), from the JAX model's weights, 3
steps of AdamW (bf16 m, factored v), clip 1.0: ``gpt_tiny`` on dp 2 x sp
2 with FSDP over dp in each of gspmd, ring and ulysses; ``llama_tiny``
(GQA, 2 kv heads) on sp 2 x mp 2 in ulysses (its kv heads repeated:
one a rank over mp does not split over sp) and on sp 4 in ring. The
bounds are those of ``tests/test_torch_mesh_training.py``'s note: losses
rtol 1e-5, parameters atol 5e-5, m within one bf16 step, vr / vc rtol
1e-4; none is loosened. Each run is also held to the port's own
one-process run (one a model kind: without an sp group the modes are
one model), gradient merge (``accumulate_steps=2``) on the GPT
ring run to the one-process run with it, and ``run_steps`` on it to
three single steps. Every rank runs in one spawn of
4 (``tests/_torch_sp_workers.py``, torch only) while this process runs
the JAX side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as pt
from paddle_tpu.distributed import ProcessMesh as JaxMesh
from paddle_tpu.distributed.sequence_parallel import (
    ring_attention_sharded, ulysses_attention_sharded)
from paddle_tpu_torch.distributed import ProcessMesh, spawn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_tiny, llama_tiny)
from paddle_tpu_torch.optimizer import AdamW

import _torch_mesh_workers as W
import _torch_sp_workers as S

torch.set_num_threads(1)

SEEDS = {"gpt": 11, "llama": 12}
JAX_FUNCTIONS = {"ring": ring_attention_sharded,
                 "ulysses": ulysses_attention_sharded}


def _jax_model(kind, mode):
    pt.seed(SEEDS[kind])
    if kind == "gpt":
        return pt.models.GPTForCausalLM(pt.models.gpt_tiny(
            dropout=0.0, attention_dropout=0.0, recompute=True,
            lm_ce_chunks=4, sequence_parallel_mode=mode))
    return pt.models.LlamaForCausalLM(pt.models.llama_tiny(
        recompute=True, lm_ce_chunks=4, sequence_parallel_mode=mode))


def _batch():
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 1024, (4, 32)).astype(np.int64)
    labels = rng.randint(0, 1024, (4, 32)).astype(np.int64)
    labels[0, :11] = -100
    labels[1, 20:] = -100
    labels[3, :2] = -100
    return ids, labels


def _qkv():
    rng = np.random.RandomState(0)
    return {x: rng.randn(2, 64, 8, 16).astype(np.float32) for x in "qkv"}


def _f32(x):
    return np.asarray(x).astype(np.float32)


def _jax_functions(qkv):
    """The JAX ring / ulysses outputs and causal grads: one jitted
    program a mesh size."""
    q, k, v = (jnp.asarray(qkv[x]) for x in "qkv")

    def every(mesh):
        def fn(q, k, v):
            res = {}
            for name, f in JAX_FUNCTIONS.items():
                for causal in (True, False):
                    res["%s_out_%d" % (name, causal)] = f(
                        q, k, v, mesh, "sp", causal=causal)
                grads = jax.grad(lambda q, k, v: (f(
                    q, k, v, mesh, "sp", causal=True) ** 2).sum(),
                    argnums=(0, 1, 2))(q, k, v)
                res.update({"%s_d%s" % (name, x): g
                            for x, g in zip("qkv", grads)})
            return res
        return jax.jit(fn)

    out = {}
    for n in S.SP_SIZES:
        got = every(Mesh(np.array(jax.devices()[:n]), ("sp",)))(q, k, v)
        out.update({key.replace("_", "%d_" % n, 1): np.asarray(val)
                    for key, val in got.items()})
    return out


def _jax_run(name, jm):
    """The JAX step of model ``jm`` on the run's mesh: the loss of each
    of 3 steps, the parameters and m / vr / vc after them."""
    shape, names, fsdp = S.RUNS[name][2:]
    ids, labels = _batch()
    opt = pt.optimizer.AdamW(learning_rate=W.LR, weight_decay=0.01,
                             parameters=jm.parameters(), factored_v=True,
                             moment_dtype="bfloat16")
    mesh = JaxMesh(np.arange(int(np.prod(shape))).reshape(shape),
                   dim_names=list(names))
    step = pt.jit.TrainStep(jm, opt, mesh=mesh, fsdp_axis=fsdp,
                            grad_clip_norm=1.0,
                            batch_specs=[("dp", "sp"), ("dp", "sp")])
    jb = (pt.to_tensor(ids), pt.to_tensor(labels))
    out = {"losses": np.array([float(step(*jb).numpy())
                               for _ in range(W.STEPS)])}
    step.sync_params_to_model()
    out.update({k: _f32(v.numpy()) for k, v in jm.state_dict().items()})
    for key in ("m", "vr", "vc"):
        for i, e in enumerate(step.opt_state[key]):
            out["%s:%d" % (key, i)] = _f32(e)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": {run: ...}, "jax_fn": {...}, "weights": {kind: ...},
    "files": the ranks' files (rank 0's one-process runs among them)}."""
    out = tmp_path_factory.mktemp("sp")
    ids, labels = _batch()
    np.savez(out / "batch.npz", ids=ids, labels=labels)
    qkv = _qkv()
    np.savez(out / "qkv.npz", **qkv)
    # every run's model (one seed a kind: the modes share the weights)
    models = {name: _jax_model(*S.RUNS[name][:2]) for name in S.RUNS}
    weights = {}
    for name, jm in models.items():
        kind = S.RUNS[name][0]
        if kind not in weights:
            weights[kind] = {k: _f32(v.numpy())
                             for k, v in jm.state_dict().items()}
            np.savez(out / ("weights_%s.npz" % kind), **weights[kind])
    # the ranks run while this process runs the JAX side
    ctx = spawn(S.run_ranks, (str(out),), nprocs=4, join=False)
    res = {"jax_fn": _jax_functions(qkv), "weights": weights,
           "jax": {name: _jax_run(name, jm) for name, jm in models.items()}}
    while not ctx.join():
        pass
    res["files"] = {p.stem: dict(np.load(p)) for p in out.glob("*.npz")
                    if not p.stem.startswith(("weights", "batch", "qkv"))}
    return res


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", S.SP_SIZES)
@pytest.mark.parametrize("fn", sorted(S.FUNCTIONS))
def test_attention_matches_jax(runs, fn, n, causal):
    key = "%s%d_out_%d" % (fn, n, causal)
    np.testing.assert_allclose(runs["files"]["functions"][key],
                               runs["jax_fn"][key], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("n", S.SP_SIZES)
@pytest.mark.parametrize("fn", sorted(S.FUNCTIONS))
def test_attention_grads_match_jax(runs, fn, n):
    for x in "qkv":
        key = "%s%d_d%s" % (fn, n, x)
        np.testing.assert_allclose(runs["files"]["functions"][key],
                                   runs["jax_fn"][key], atol=1e-4,
                                   rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("name", sorted(S.RUNS))
def test_sp_step_matches_jax_on_the_same_mesh(runs, name):
    got = runs["files"][name]
    W.assert_run_close(got, runs["jax"][name],
                       list(runs["weights"][S.RUNS[name][0]]))
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("name", sorted(S.RUNS))
def test_sp_step_matches_one_process(runs, name):
    kind = S.RUNS[name][0]
    W.assert_run_close(runs["files"][name], runs["files"]["one_" + kind],
                       list(runs["weights"][kind]))


def test_gradient_merge_on_an_sp_mesh(runs):
    """accumulate_steps=2 on dp 2 x sp 2, ring: each global micro-batch
    split over dp and each row over sp, against the one-process run."""
    got, want = runs["files"]["accumulate"], runs["files"]["one_accumulate"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for name in runs["weights"]["gpt"]:
        np.testing.assert_allclose(W.key_third(name, got[name])[1],
                                   W.key_third(name, want[name])[1],
                                   atol=5e-5, err_msg=name)


def test_run_steps_on_an_sp_mesh(runs):
    """One step, then run_steps(2), on dp 2 x sp 2, ring: the last loss
    and the parameters of three single steps."""
    got, want = runs["files"]["chained"], runs["files"][S.ACCUMULATE]
    np.testing.assert_allclose(got["losses"][-1], want["losses"][-1],
                               rtol=1e-6)
    for name in runs["weights"]["gpt"]:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_p2p_and_all_to_all_collectives(runs):
    """Rank r's all_to_all results (10 j + r from rank j), what it
    received by recv from r - 1, and by batch_isend_irecv from r - 1 and
    r + 1."""
    coll = runs["files"]["collectives"]["coll"]
    for r in range(4):
        np.testing.assert_array_equal(
            coll[r], [r, 10 + r, 20 + r, 30 + r, (r - 1) % 4, (r - 1) % 4,
                      (r + 1) % 4])


@pytest.mark.parametrize("kind", W.MODELS)
def test_ring_and_ulysses_without_a_mesh_are_gspmd(kind):
    """No sp group (one device, eager): the modes fall back to the
    model's usual attention, as the JAX package's do (its sp_attention
    returns None there): the logits equal gspmd's."""
    ids = torch.from_numpy(_batch()[0][:2])
    logits = {mode: W.port_model(kind, sequence_parallel_mode=mode)(ids)
              for mode in ("gspmd", "ring", "ulysses")}
    for mode in ("ring", "ulysses"):
        assert torch.equal(logits[mode], logits["gspmd"])


def test_sequence_must_split_over_sp(runs):
    assert bool(runs["files"]["uneven"]["raised"])


def _mesh(shape, names):
    return ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape), names)


def test_ulysses_heads_must_divide_by_sp():
    """gpt_tiny's 4 heads over mp 2 leave 2, which sp 4 cannot split."""
    model = GPTForCausalLM(gpt_tiny(sequence_parallel_mode="ulysses"),
                           device="cpu")
    with pytest.raises(ValueError, match="ulysses"):
        TrainStep(model, AdamW(), mesh=_mesh((4, 2), ["sp", "mp"]),
                  device="cpu")


def test_sp_mesh_needs_the_process_group():
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        TrainStep(LlamaForCausalLM(llama_tiny(sequence_parallel_mode="ring"),
                                   device="cpu"), AdamW(),
                  mesh=_mesh((2,), ["sp"]), device="cpu")
