"""The port's group sharding (ZeRO stages 1-3) and fleet's sharding axis
over two gloo ranks.

One spawn of two ranks (``tests/_torch_sharding_workers.py``, torch
only) runs every case from the parent's weights while the parent runs
the references:

- ``tests/test_hybrid_tp_pp.py``'s MLP under ``group_sharded_parallel``
  at ``os``, ``os_g`` and ``p_g_os`` (SGD 0.1, 4 steps, rank r's data
  from ``RandomState(100 + r)``) against the JAX package's MLP in one
  process that averages the two ranks' gradients (run here, eager),
  within the JAX test's rtol 2e-4 / atol 1e-5, every step; the ranks' parameters bitwise equal; stage 1's
  inner optimizer holding its part only, stage 2 dropping the gradients
  a rank does not own during the backward, stage 3's parameters being
  flat pieces between steps and its ``state_dict`` whole;
- ``bert_tiny`` at ``os_g``, the same batch on both ranks
  (``tests/test_baseline_alignment.py``'s), against the JAX package's
  one-process AdamW run on the same weights (run here, in this
  process, by its ``TrainStep``): the losses within rtol 2e-4;
- fleet with ``sharding_degree`` 2 at stage 1 and stage 2
  (``ShardingParallel``, ``HybridParallelOptimizer``), AdamW with a
  global-norm clip that every step engages, against the JAX package's
  AdamW and ``ClipGradByGlobalNorm`` in one process that clips the
  averaged gradients by their whole norm: the sharding group sums the
  parts' squared norms;
- the errors: a second stage-3 wrapper of one optimizer, gradient merge
  with stage 2, an unknown level, offload.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as jpt
from paddle_tpu import nn as jnn
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import BertForPreTraining as JBertForPreTraining
from paddle_tpu.models import BertPretrainingCriterion as JCriterion
from paddle_tpu.models import bert_tiny as jbert_tiny
from paddle_tpu.nn import initializer as jinit

import paddle_tpu_torch as pt
from paddle_tpu_torch import device
from paddle_tpu_torch.distributed import fleet, spawn
from paddle_tpu_torch.distributed.fleet import sharding_optimizer
from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
from paddle_tpu_torch.models import BertForPreTraining, bert_tiny

import _torch_sharding_workers as W

torch.set_num_threads(1)

RANKS = 2
TOL = dict(rtol=2e-4, atol=1e-5)        # tests/test_hybrid_tp_pp.py's
BERT_RTOL = 2e-4                        # tests/test_baseline_alignment.py's


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t.numpy())


def bert_init():
    """Numpy weights of bert_tiny (norms near 1, biases near 0, matrices
    at Xavier's scale), under the JAX state-dict names."""
    rng = np.random.RandomState(7)
    pt.seed(0)
    out = {}
    for name, t in BertForPreTraining(bert_tiny()).state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("bias"):
            a = 0.1 * rng.randn(*shape)
        elif len(shape) == 1:
            a = 1.0 + 0.1 * rng.randn(*shape)
        else:
            a = rng.randn(*shape) * np.sqrt(2.0 / sum(shape))
        out[name] = a.astype(np.float32)
    return out


def jax_mean_grad_run(opt_of):
    """The MLP in the JAX package (eager), one process: every step, both
    ranks' batches, their gradients averaged (as
    ``tests/test_hybrid_tp_pp.py``'s reference does), then
    ``opt_of(params)``'s step. Returns each rank's losses, the parameters
    after each step and the averaged gradients' norm of each step."""
    model = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))
    model.set_state_dict(_mlp_init())
    params = model.parameters()
    opt = opt_of(params)
    batches = [W.mlp_batches(r) for r in range(RANKS)]
    losses, states, norms = [], [], []
    for step in range(W.MLP_STEPS):
        grads, row = [], []
        for r in range(RANKS):
            model.clear_gradients()
            loss = (model(jpt.to_tensor(batches[r][step])) ** 2).mean()
            loss.backward()
            row.append(float(_np(loss)))
            grads.append([p.grad._data for p in params])
        mean = [sum(gs) / RANKS for gs in zip(*grads)]
        for p, g in zip(params, mean):
            p.grad._data = g
        norms.append(float(np.sqrt(sum(float((_np(p.grad) ** 2).sum())
                                       for p in params))))
        opt.step()
        opt.clear_grad()
        losses.append(row)
        states.append({k: _np(v) for k, v in model.state_dict().items()})
    return dict(losses=np.array(losses), states=states, norms=norms)


_MLP_INIT = {}


def _mlp_init():
    if not _MLP_INIT:
        pt.seed(11)
        _MLP_INIT.update(W.flat_state(W.mlp().state_dict()))
    return _MLP_INIT


@pytest.fixture(scope="module")
def jax_zero_init():
    mp = pytest.MonkeyPatch()
    for cls in (jinit.Constant, jinit.Uniform, jinit.XavierNormal,
                jinit.Normal):
        mp.setattr(cls, "__call__", lambda self, shape, dtype=jnp.float32:
                   jnp.asarray(np.zeros(tuple(shape), np.float32)).astype(
                       dtype))
    yield
    mp.undo()


def jax_bert_losses(init):
    """The JAX package's one-process AdamW run of bert_tiny (dropout 0)
    from ``init`` on the workers' batch, compiled whole by its
    ``TrainStep`` (its eager steps compile op by op: ~12 s against ~4)."""
    cfg = jbert_tiny(**W.BERT_CFG)
    model = JBertForPreTraining(cfg)
    model.set_state_dict(init)
    crit = JCriterion(cfg.vocab_size)
    opt = jpt.optimizer.AdamW(learning_rate=W.BERT_LR,
                              parameters=model.parameters())
    step = JTrainStep(model, opt, loss_fn=lambda m, ids, mlm, nsp: crit(
        *m(ids), mlm, nsp))
    return np.array([float(_np(step(*W.bert_batch())))
                     for _ in range(W.BERT_STEPS)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_zero_init):
    """Start the ranks, run the references beside them, then collect the
    ranks' files."""
    out = tmp_path_factory.mktemp("sharding")
    prev = device._current
    pt.set_device("cpu")
    try:
        bert = bert_init()
        np.savez(out / "init.npz",
                 **{"mlp." + k: v for k, v in _mlp_init().items()},
                 **{"bert." + k: v for k, v in bert.items()})
        ctx = spawn(W.run, (str(out),), nprocs=RANKS, join=False)
        ref = {"sgd": jax_mean_grad_run(lambda ps: jpt.optimizer.SGD(
            parameters=ps, learning_rate=W.MLP_LR))}
        ref["fleet"] = jax_mean_grad_run(lambda ps: jpt.optimizer.AdamW(
            learning_rate=W.FLEET_LR, parameters=ps,
            grad_clip=jpt.nn.ClipGradByGlobalNorm(W.CLIP)))
        ref["bert"] = jax_bert_losses(bert)
        while not ctx.join():
            pass
    finally:
        pt.set_device(prev)
    ranks = []
    for r in range(RANKS):
        with open(out / ("sharding_r%d.json" % r)) as f:
            meta = json.load(f)
        data = np.load(out / ("sharding_r%d.npz" % r))
        meta["arrays"] = {k: data[k] for k in data.files}
        ranks.append(meta)
    return dict(ranks=ranks, ref=ref)


def states_of(rank, tag, steps):
    a = rank["arrays"]
    return [{k.split("/", 2)[2]: v for k, v in a.items()
             if k.startswith("%s/%d/" % (tag, i))} for i in range(steps)]


def check_against(runs, tag, ref):
    """Every rank's losses and parameters after every step against the
    one-process ``ref``; the ranks' parameters bitwise equal."""
    states = [states_of(rk, tag, W.MLP_STEPS) for rk in runs["ranks"]]
    for r, rk in enumerate(runs["ranks"]):
        np.testing.assert_allclose(rk["arrays"][tag + "/losses"],
                                   ref["losses"][:, r], **TOL)
        for step, (got, want) in enumerate(zip(states[r], ref["states"])):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(
                    got[k], want[k], err_msg="%s step %d %s rank %d"
                    % (tag, step + 1, k, r), **TOL)
    for a, b in zip(*states):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("level", W.LEVELS)
def test_level_matches_one_process_mean_gradients(runs, level):
    check_against(runs, level, runs["ref"]["sgd"])
    moved = runs["ref"]["sgd"]["states"]
    assert not np.allclose(moved[0]["0.weight"], _mlp_init()["0.weight"])


def test_stage1_inner_optimizer_keeps_its_part(runs):
    parts = [set(rk["os"]["local"]) for rk in runs["ranks"]]
    assert parts[0].isdisjoint(parts[1])
    assert parts[0] | parts[1] == set(range(4))
    # greedy by size: the 8 x 16 weight alone, then 16 x 4, 16 and 4
    # go to the lighter rank
    assert parts == [{0}, {1, 2, 3}]
    assert [rk["os"]["grads_held"] for rk in runs["ranks"]] == [[True] * 4
                                                                ] * 2


def test_stage2_drops_the_gradients_a_rank_does_not_own(runs):
    for rk in runs["ranks"]:
        held = rk["os_g"]["grads_held"]
        assert held == [i in rk["os_g"]["local"] for i in range(4)]
    assert sorted(sum((rk["os_g"]["local"] for rk in runs["ranks"]), [])
                  ) == [0, 1, 2, 3]


def test_stage3_pieces_between_steps_and_whole_state_dict(runs):
    whole = {k: v.size for k, v in _mlp_init().items()}
    pieces = [-(-n // RANKS) for n in whole.values()]
    for rk in runs["ranks"]:
        info = rk["p_g_os"]
        assert info["piece_sizes"] == pieces
        assert info["piece_sizes_after"] == pieces
        assert info["state_keys"] == list(whole)
        assert info["grads_held"] == [True] * 4
    last = states_of(runs["ranks"][0], "p_g_os", W.MLP_STEPS)[-1]
    assert {k: v.size for k, v in last.items()} == whole


def test_bert_tiny_os_g_matches_jax_one_process(runs):
    want = runs["ref"]["bert"]
    assert np.all(np.isfinite(want)) and want[-1] < want[0]
    for rk in runs["ranks"]:
        np.testing.assert_allclose(rk["arrays"]["bert_os_g/losses"], want,
                                   rtol=BERT_RTOL, atol=0)


@pytest.mark.parametrize("stage", W.FLEET_STAGES)
def test_fleet_sharding_with_the_group_clip(runs, stage):
    ref = runs["ref"]["fleet"]
    assert min(ref["norms"]) > W.CLIP          # every step clips
    check_against(runs, "fleet_%d" % stage, ref)
    for rk in runs["ranks"]:
        info = rk["fleet_%d" % stage]
        assert info["model"] == "ShardingParallel"
        assert info["optimizer"] == ("AdamW" if stage == 1 else
                                     "GroupShardedOptimizerStage2")
        assert info["inner_after"] == ("DygraphShardingOptimizer"
                                       if stage == 1 else
                                       "GroupShardedOptimizerStage2")


@pytest.fixture
def one_process_fleet(monkeypatch):
    monkeypatch.setattr(fleet.fleet, "_fleet", None)
    monkeypatch.setattr(fleet.fleet, "_hcg", None)
    prev = device._current
    pt.set_device("cpu")
    yield
    pt.set_device(prev)


def test_errors(one_process_fleet):
    model = W.mlp()
    opt = pt.optimizer.SGD(parameters=model.parameters(), learning_rate=0.1)
    with pytest.raises(ValueError, match="unknown sharding level"):
        group_sharded_parallel(model, opt, "p_os")
    with pytest.raises(NotImplementedError, match="offload"):
        group_sharded_parallel(model, opt, "os_g", offload=True)
    wrapped, opt3, _ = group_sharded_parallel(model, opt, "p_g_os")
    assert isinstance(wrapped, sharding_optimizer.GroupShardedStage3)
    with pytest.raises(RuntimeError, match="already routed"):
        sharding_optimizer.GroupShardedStage3(W.mlp(), opt3)
    s = fleet.DistributedStrategy()
    s.sharding = True
    s.sharding_configs = {"stage": 2}
    s.gradient_merge = True
    s.gradient_merge_configs = {"k_steps": 2}
    fleet.init(is_collective=True, strategy=s, device="cpu")
    with pytest.raises(ValueError, match="gradient_merge cannot compose"):
        fleet.distributed_optimizer(pt.optimizer.SGD(
            parameters=W.mlp().parameters(), learning_rate=0.1))
