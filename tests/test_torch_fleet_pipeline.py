"""The port's fleet hybrid-parallel leg against the JAX package.

Every case runs the port's fleet API over gloo ranks (one spawn of 4, then
one of 2, from ``tests/_torch_fleet_workers.py``, torch only, while this
process runs the JAX side) and holds it against the JAX package's
single-process reference on the same numpy weights and batch: JAX ``nn``
layers run in sequence with the JAX ``SGD`` / ``AdamW`` ``step()``, the
reference the JAX fleet tests themselves compare against. Bounds are the
JAX tests': losses rtol 2e-4 / atol 1e-5, parameters atol 5e-5 (each
rank's pieces against the same pieces of the reference's whole
matrices).

The cases: ``test_hybrid_tp_pp.py``'s model at mp 2 x pp 2;
``test_pipeline_parallel.py``'s under 1F1B, interleave (VPP 2) and
zero-bubble at pp 2; a ``PipelineLayer`` of the port's ``GPTBlock``s at
pp 2 with ``accumulate_steps`` 2 (``BASELINE.md`` #4) and at dp 2 x pp 2;
a ``gpt_tiny``-width Megatron stack of mp layers (vocabulary-parallel
embedding, column / row-parallel attention and MLP, parallel cross
entropy) at pp 2 x mp 2 through ``HybridParallelOptimizer`` with
``ClipGradByGlobalNorm(1.0)`` and gradient merge (k 2), with dense AdamW
against the JAX one and with factored v against the port's own
one-process run; the mp layers alone against full-matrix JAX layers;
and ``HybridCommunicateGroup``'s answers against the JAX class's for
every layout the cases use.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.distributed.collective as jax_collective
import paddle_tpu.distributed.parallel_env as jax_parallel_env
from paddle_tpu.distributed.fleet.topology import (
    CommunicateTopology as JaxTopology,
    HybridCommunicateGroup as JaxHCG)
from paddle_tpu.models.gpt import GPTBlock as JaxGPTBlock
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu_torch.distributed import fleet, spawn

import _torch_fleet_workers as W

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=2e-4, atol=1e-5)
PARAM_ATOL = 5e-5
PIPELINES = ["tp_pp", "pp_1f1b", "pp_interleave", "pp_zb", "gpt_pp2",
             "gpt_dp2pp2", "megatron"]
# AdamW normalises every gradient, so the port's and the JAX package's
# rounding apart (one ulp of a gradient near 0 can turn an update of
# lr) shows in single weights of the GPT blocks after 6 steps at lr 3e-3
# (the port on one process without the pipeline: 9.4e-5 on one head
# weight of 4096): their parameters are held to the JAX ones by each
# tensor's relative L2, and element by element (atol PARAM_ATOL) to the
# port's one-process run of the same modules and micro-batches, which
# isolates the pipeline
ADAM_NOISE = ("gpt_pp2", "gpt_dp2pp2")
TENSOR_RTOL = 1e-4
ONE_PROCESS = ADAM_NOISE + ("megatron_factored",)


def _np(t):
    return np.asarray(t.numpy(), dtype=np.float32)


def _jax_state(layers):
    """{run_function.{i}.{name}: numpy} of JAX layers in sequence."""
    return {"run_function.%d.%s" % (i, k): _np(v)
            for i, layer in enumerate(layers)
            for k, v in layer.state_dict().items()}


def _set(layers, state):
    for i, layer in enumerate(layers):
        for k, p in layer.named_parameters():
            p.set_value(state["run_function.%d.%s" % (i, k)])


# ------------------------------------------------------------ the cases
def _tp_pp_data():
    c = W.TP_PP
    rng = np.random.RandomState(7)
    data = {}
    for i in range(c["blocks"]):
        data["run_function.%d.col.weight" % i] = \
            rng.randn(c["d"], c["h"]).astype(np.float32) * 0.3
        data["run_function.%d.row.weight" % i] = \
            rng.randn(c["h"], c["d"]).astype(np.float32) * 0.3
    rng = np.random.RandomState(1)
    data["x"] = rng.randn(4, c["d"]).astype(np.float32)
    data["y"] = rng.randn(4, c["d"]).astype(np.float32) * 0.1
    return data


class _JaxBlock(pt.nn.Layer):
    def __init__(self, d, h):
        super().__init__()
        self.col = pt.nn.Linear(d, h, bias_attr=False)
        self.row = pt.nn.Linear(h, d, bias_attr=False)

    def forward(self, x):
        return x + self.row(self.col(x).tanh())


def _pp_data(n):
    pt.seed(42)
    layers = [pt.nn.Linear(W.PP["d"], W.PP["d"]) for _ in range(n)]
    data = _jax_state(layers)
    rng = np.random.RandomState(0)
    data["x"] = rng.randn(8, W.PP["d"]).astype(np.float32)
    data["y"] = rng.randn(8, W.PP["d"]).astype(np.float32) * 0.1
    return data


def _jax_gpt_layers():
    c = W.GPT
    cfg = JaxGPTConfig(vocab_size=c["vocab"], hidden_size=c["hidden"],
                       num_layers=c["layers"], num_heads=c["heads"],
                       max_position_embeddings=c["seq"], dropout=0.0,
                       attention_dropout=0.0)

    class EmbedIn(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = pt.nn.Embedding(c["vocab"], c["hidden"])

        def forward(self, ids):
            return self.emb(ids)

    return ([EmbedIn()] + [JaxGPTBlock(cfg, i) for i in range(c["layers"])]
            + [pt.nn.Linear(c["hidden"], c["vocab"])])


def _gpt_data():
    pt.seed(3)
    data = _jax_state(_jax_gpt_layers())
    rng = np.random.RandomState(0)
    shape = (W.GPT["batch"], W.GPT["seq"])
    data["x"] = rng.randint(0, W.GPT["vocab"], shape).astype(np.int64)
    data["y"] = rng.randint(0, W.GPT["vocab"], shape).astype(np.int64)
    return data


class _JaxEmbed(pt.nn.Layer):
    def __init__(self, c):
        super().__init__()
        self.wte = pt.nn.Embedding(c["vocab"], c["hidden"])
        self.wpe = pt.nn.Embedding(c["seq"], c["hidden"])

    def forward(self, ids):
        pos = pt.to_tensor(np.arange(ids.shape[1])[None])
        return self.wte(ids) + self.wpe(pos)


class _JaxHead(pt.nn.Layer):
    def __init__(self, c):
        super().__init__()
        self.ln_f = pt.nn.LayerNorm(c["hidden"], c["eps"])
        self.proj = pt.nn.Linear(c["hidden"], c["vocab"], bias_attr=False)

    def forward(self, x):
        return self.proj(self.ln_f(x))


def _jax_megatron_layers():
    c = W.MEGATRON
    cfg = JaxGPTConfig(vocab_size=c["vocab"], hidden_size=c["hidden"],
                       num_layers=c["layers"], num_heads=c["heads"],
                       intermediate_size=c["ffn"],
                       max_position_embeddings=c["seq"], dropout=0.0,
                       attention_dropout=0.0, layer_norm_eps=c["eps"])
    return ([_JaxEmbed(c)] + [JaxGPTBlock(cfg, i) for i in range(c["layers"])]
            + [_JaxHead(c)])


def _megatron_data():
    c = W.MEGATRON
    pt.seed(5)
    data = _jax_state(_jax_megatron_layers())
    rng = np.random.RandomState(4)
    shape = (c["steps"], c["batch"], c["seq"])
    data["x"] = rng.randint(0, c["vocab"], shape).astype(np.int64)
    data["y"] = rng.randint(0, c["vocab"], shape).astype(np.int64)
    data["per_step"] = np.array(1)
    return data


# ----------------------------------------------------- JAX references
def _jax_train(layers, data, opt, loss_fn, steps, merge=1):
    """The JAX layers in sequence, one optimizer step a batch (or every
    ``merge`` batches, each loss / merge), then the last batch's loss
    forward only: (losses, whole parameters)."""
    _set(layers, data)
    per_step = "per_step" in data
    losses = []
    for i in range(steps + 1):
        j = min(i, steps - 1)
        x = pt.to_tensor(data["x"][j] if per_step else data["x"])
        y = pt.to_tensor(data["y"][j] if per_step else data["y"])
        for layer in layers:
            x = layer(x)
        loss = loss_fn(x, y)
        losses.append(float(loss))
        if i == steps:
            break
        (loss / merge if merge > 1 else loss).backward()
        if (i + 1) % merge == 0:
            opt.step()
            opt.clear_grad()
    return np.array(losses), _jax_state(layers)


def _params(layers):
    return [p for layer in layers for p in layer.parameters()]


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _jax_ce(logits, labels):
    return pt.nn.functional.cross_entropy(
        logits.reshape([-1, logits.shape[-1]]), labels.reshape([-1])).mean()


def _reference(name, data):
    if name == "tp_pp":
        c = W.TP_PP
        layers = [_JaxBlock(c["d"], c["h"]) for _ in range(c["blocks"])]
        return _jax_train(layers, data, pt.optimizer.SGD(
            parameters=_params(layers), learning_rate=c["lr"]), _mse,
            c["steps"])
    if name.startswith("pp_"):
        n = sum(1 for k in data if k.endswith(".weight"))
        layers = [pt.nn.Linear(W.PP["d"], W.PP["d"]) for _ in range(n)]
        return _jax_train(layers, data, pt.optimizer.SGD(
            parameters=_params(layers), learning_rate=W.PP["lr"]), _mse,
            W.PP["steps"])
    if name.startswith("gpt"):
        layers = _jax_gpt_layers()
        return _jax_train(layers, data, pt.optimizer.AdamW(
            learning_rate=W.GPT["lr"], parameters=_params(layers)),
            _jax_ce, W.GPT["steps"])
    c = W.MEGATRON
    layers = _jax_megatron_layers()
    return _jax_train(layers, data, pt.optimizer.AdamW(
        learning_rate=c["lr"], parameters=_params(layers),
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0)), _jax_ce, c["steps"],
        merge=c["k_steps"])


def _jax_mp_layers(d):
    """The full-matrix JAX layers' outputs and the gradients of
    sum(out * c)."""
    out = {}

    def t(a, grad=False):
        x = pt.to_tensor(a)
        x.stop_gradient = not grad
        return x

    def linear(w, b):
        layer = pt.nn.Linear(*w.shape)
        layer.weight.set_value(w)
        layer.bias.set_value(b)
        return layer

    def record(tag, y, inputs, layers):
        (y * t(d[tag + "_c"])).sum().backward()
        out[tag + "_out"] = _np(y)
        for name, x in inputs.items():
            out["%s_d%s" % (tag, name)] = _np(x.grad)
        for lname, layer in layers.items():
            for pname, p in layer.named_parameters():
                out["%s_d%s.%s" % (tag, lname, pname)] = _np(p.grad)

    x = t(d["col_x"], True)
    col = linear(d["col_w"], d["col_b"])
    record("col", col(x), {"x": x}, {"col": col})
    x = t(d["mlp_x"], True)
    c1, r1 = linear(d["col_w"], d["col_b"]), linear(d["row_w"], d["row_b"])
    record("mlp", r1(c1(x).tanh()), {"x": x}, {"col": c1, "row": r1})
    x = t(d["row_x"], True)
    r2 = linear(d["row_w"], d["row_b"])
    record("row", r2(x), {"x": x}, {"row": r2})
    emb = pt.nn.Embedding(32, 8)
    emb.weight.set_value(d["emb_w"])
    record("emb", emb(t(d["ids"])), {}, {"emb": emb})
    logits = t(d["logits"], True)
    loss = pt.nn.functional.cross_entropy(logits, t(d["labels"]),
                                          reduction="none")
    record("ce", loss.reshape([4, 6]), {"logits": logits}, {})
    return out


def _jax_topology(strategy_dims, rank, monkeypatch):
    """The JAX HybridCommunicateGroup's answers on ``rank`` (its
    process groups replaced by placeholders: only ranks are read)."""
    dp, mp, pp = strategy_dims

    class Env:
        def __init__(self):
            self.rank, self.world_size = rank, dp * mp * pp

    monkeypatch.setattr(jax_parallel_env, "ParallelEnv", Env)
    monkeypatch.setattr(jax_collective, "new_group",
                        lambda ranks=None, **kw: object())
    h = JaxHCG(JaxTopology(["data", "pipe", "sharding", "sep", "model"],
                           [dp, pp, 1, 1, mp]))
    return dict(
        dp_rank=h.get_data_parallel_rank(),
        mp_rank=h.get_model_parallel_rank(), stage=h.get_stage_id(),
        pipe_rank=h.get_pipe_parallel_rank(),
        sizes=[h.get_data_parallel_world_size(),
               h.get_model_parallel_world_size(),
               h.get_pipe_parallel_world_size()],
        groups=[h._dp_group, h._mp_group, h._pp_group],
        src=[h.get_data_parallel_group_src_rank(),
             h.get_model_parallel_group_src_rank()],
        prev=h._pp_prev_rank, next=h._pp_next_rank,
        first=h.is_first_stage(), last=h.is_last_stage(),
        mode=h.get_parallel_mode())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("fleet")
    data = {"tp_pp": _tp_pp_data(), "pp": _pp_data(W.PP["layers"]),
            "pp_interleave": _pp_data(W.PP["interleave_layers"]),
            "gpt": _gpt_data(), "megatron": _megatron_data(),
            "mp_layers": W.mp_layers_data()}
    for name, arrays in data.items():
        np.savez(out / (name + ".npz"), **arrays)
    # the two worlds one after the other (at most four ranks beside the
    # tier-1 run's other workers), each while this process runs half of
    # the JAX side
    def join(ctx):
        while not ctx.join():
            pass

    ctx = spawn(W.run_world, (str(out), 4), nprocs=4, join=False)
    refs = {}
    for name in PIPELINES:
        src = W.DATA[name]
        if src not in refs:     # gpt_pp2 and gpt_dp2pp2 share one
            refs[src] = _reference(name, data[src])
        if name == "gpt_pp2":
            join(ctx)
            ctx = spawn(W.run_world, (str(out), 2), nprocs=2, join=False)
    res = {"data": data, "jax": {name: refs[W.DATA[name]]
                                 for name in PIPELINES},
           "jax_mp": _jax_mp_layers(data["mp_layers"]),
           "one_process": {name: W.one_process(name, data[W.DATA[name]])
                           for name in ONE_PROCESS}}
    join(ctx)
    res["files"] = {p.stem: dict(np.load(p)) for p in out.glob("*_r*.npz")}
    res["json"] = {p.stem: json.loads(p.read_text())
                   for p in out.glob("*_r*.json")}
    return res


def _ranks(runs, name):
    return {int(k.rsplit("_r", 1)[1]): v for k, v in runs["files"].items()
            if k.rsplit("_r", 1)[0] == name}


def _piece(full, where, parts):
    axis, rank, size = (int(v) for v in where)
    if axis < 0:
        return full
    m = full.shape[axis] // (size * parts)
    x = np.moveaxis(full, axis, 0)
    x = x.reshape((parts, size, m) + x.shape[1:])[:, rank]
    return np.moveaxis(x.reshape((parts * m,) + x.shape[2:]), 0, axis)


def _losses(runs, name):
    """The step losses of the last stage, averaged over dp replicas."""
    got = [r["losses"] for r in _ranks(runs, name).values()
           if len(r["losses"])]
    return np.mean(got, axis=0)


@pytest.mark.parametrize("name", PIPELINES)
def test_pipeline_losses_match_jax(runs, name):
    """Every train_batch loss and (but for the interleaved schedule)
    eval_batch's loss after them."""
    want = runs["jax"][name][0]
    got = _losses(runs, name)
    np.testing.assert_allclose(got, want[:len(got)], **LOSS_TOL)
    assert len(got) == len(want) - (name == "pp_interleave")


def _check_pieces(runs, name, want, tensor_rtol=None):
    """Every rank's pieces against those of the whole ``want``: element
    by element within PARAM_ATOL, or by relative L2 within
    ``tensor_rtol``; every parameter seen."""
    seen = set()
    for rank, rec in _ranks(runs, name).items():
        for key in [k[2:] for k in rec if k.startswith("p:")]:
            parts = 3 if "qkv_proj" in key else 1
            got, ref = rec["p:" + key], _piece(want[key], rec["w:" + key],
                                                parts)
            msg = "%s rank %d" % (key, rank)
            if tensor_rtol is None:
                np.testing.assert_allclose(got, ref, rtol=0,
                                           atol=PARAM_ATOL, err_msg=msg)
            else:
                rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
                assert rel <= tensor_rtol, (msg, rel)
            seen.add(key)
    assert seen == {k for k in want if k.startswith("run_function.")}


@pytest.mark.parametrize("name", PIPELINES)
def test_pipeline_parameters_match_jax(runs, name):
    _check_pieces(runs, name, runs["jax"][name][1],
                  TENSOR_RTOL if name in ADAM_NOISE else None)


@pytest.mark.parametrize("name", ONE_PROCESS)
def test_pipeline_matches_one_process(runs, name):
    """The pipeline against the same modules on one process."""
    losses, want = runs["one_process"][name]
    np.testing.assert_allclose(_losses(runs, name), losses, **LOSS_TOL)
    _check_pieces(runs, name, want)


@pytest.mark.parametrize("name", PIPELINES)
def test_pipeline_trains(runs, name):
    losses = _losses(runs, name)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_recompute_replays_dropout_masks():
    """fleet.recompute: the recomputed forward draws the forward's
    dropout masks (the port's generators, which torch.utils.checkpoint
    does not stash): gradients equal the plain run's, and the draws
    after it see the same stream."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.nn.functional import dropout

    w = torch.randn(16, 16, dtype=torch.float64)
    x0 = torch.randn(4, 16, dtype=torch.float64)

    def run(recomputed):
        seed(7)
        x = x0.clone().requires_grad_()
        f = lambda t: dropout(torch.tanh(t @ w), 0.5)  # noqa: E731
        y = fleet.recompute(f, x) if recomputed else f(x)
        (y * y).sum().backward()
        return x.grad, dropout(torch.ones(64, dtype=torch.float64), 0.5)

    (g0, after0), (g1, after1) = run(False), run(True)
    torch.testing.assert_close(g1, g0, rtol=0, atol=0)
    torch.testing.assert_close(after1, after0, rtol=0, atol=0)


def test_recompute_sequential_matches_plain():
    """recompute_sequential over 3 segments of 5 layers: the output and
    every gradient as without recompute."""
    torch.manual_seed(0)
    layers = [torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.Tanh())
              for _ in range(5)]
    x0 = torch.randn(4, 8)

    def run(recomputed):
        x = x0.clone().requires_grad_()
        y = fleet.recompute_sequential({"segments": 3}, layers, x) \
            if recomputed else torch.nn.Sequential(*layers)(x)
        y.square().sum().backward()
        grads = [x.grad] + [p.grad.clone() for p in
                            torch.nn.ModuleList(layers).parameters()]
        for p in torch.nn.ModuleList(layers).parameters():
            p.grad = None
        return y.detach(), grads

    (y0, g0), (y1, g1) = run(False), run(True)
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_hybrid_parallel_util_and_worker_queries(runs):
    """On dp 2: gradients averaged over the group (f32 and f64, a
    bucket a gradient), a parameter broadcast from the group's first
    rank, and worker_num / worker_index / is_first_worker."""
    for rank in range(2):
        got = runs["json"]["util_r%d" % rank]
        assert got["grads"] == [[1.5] * 5, [30.0] * 6, [-1.5] * 4]
        assert got["weight"] == [7.0] * 4
        assert got["worker"] == [2, rank, rank == 0]


def test_pipeline_p2p_bytes(runs):
    """1F1B at pp 2: a stage sends one activation (stage 0) or one
    gradient (stage 1) a micro-batch, 4 x 2 x 8 f32 each."""
    for rec in _ranks(runs, "pp_1f1b").values():
        assert int(rec["p2p_bytes"]) == W.PP["steps"] * \
            W.PP["accumulate"] * 2 * W.PP["d"] * 4


MP_CASES = ["col", "mlp", "row", "emb", "ce"]


@pytest.mark.parametrize("case", MP_CASES)
def test_mp_layers_match_full_matrices(runs, case):
    want = runs["jax_mp"]
    for rank, rec in _ranks(runs, "mp_layers").items():
        r = int(rec["mp_rank"])
        for key in [k for k in want if k.startswith(case + "_")]:
            full = want[key]
            got = rec[key]
            if got.shape != full.shape:
                # a piece: this rank's part of the split dim
                axis = next(a for a in range(full.ndim)
                            if got.shape[a] != full.shape[a])
                full = np.split(full, 2, axis)[r]
            np.testing.assert_allclose(got, full, rtol=1e-5, atol=1e-5,
                                       err_msg="%s rank %d" % (key, rank))


@pytest.mark.parametrize("layout", sorted(W.TOPOLOGIES))
def test_hybrid_communicate_group_matches_jax(runs, layout, monkeypatch):
    dims = W.TOPOLOGIES[layout]
    for rank in range(int(np.prod(dims))):
        got = runs["json"]["topo_%s_r%d" % (layout, rank)]
        want = _jax_topology(dims, rank, monkeypatch)
        assert got == json.loads(json.dumps(want)), (layout, rank)


def test_fleet_raises_for_unported_strategy():
    s = fleet.DistributedStrategy()
    s.amp = True
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fleet.init(is_collective=True, strategy=s, device="cpu")
    s = fleet.DistributedStrategy()
    s.hybrid_configs["sep_degree"] = 2
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        s.check()
