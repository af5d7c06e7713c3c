"""Rank code of ``tests/test_torch_group_sharded.py``.

Runs in the processes that ``paddle_tpu_torch.distributed.spawn`` starts
(gloo, CPU), so it imports torch and the port only: no JAX, and not the
tests' conftest. :func:`run` trains, in turn, from the parent's weights
(``init.npz``):

- ``tests/test_hybrid_tp_pp.py``'s MLP (Linear 8-16, Tanh, Linear 16-4,
  SGD 0.1, 4 steps, the mean of the output's squares, rank r's batches
  of 8 x 8 from ``np.random.RandomState(100 + r)``) under
  ``group_sharded_parallel`` at each level, ``os``, ``os_g`` and
  ``p_g_os``;
- ``bert_tiny`` (dropout 0) at ``os_g`` with AdamW 5e-3, 3 steps, the
  same batch on both ranks (``tests/test_baseline_alignment.py``'s);
- the MLP through fleet with ``sharding_degree`` 2 at stage 1 and stage
  2, AdamW 1e-2 with ``ClipGradByGlobalNorm(CLIP)``, a bound the
  gradients' norm exceeds, so every step clips.

Each run records its losses, its parameters after every step (stage 3:
through the wrapper's ``state_dict``) and what the sharding did (the
parts, a non-owned gradient after the backward, the pieces between
steps). Each rank writes ``sharding_r<rank>.npz`` and ``.json``.
"""
import json
import os

import numpy as np
import torch
import torch.distributed as dist

import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import fleet, init_parallel_env
from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
from paddle_tpu_torch.models import (BertForPreTraining,
                                     BertPretrainingCriterion, bert_tiny)

LEVELS = ("os", "os_g", "p_g_os")
MLP_STEPS = 4
MLP_LR = 0.1
BERT_STEPS = 3
BERT_LR = 5e-3
BERT_CFG = dict(hidden_dropout=0.0, attention_dropout=0.0)
FLEET_STAGES = (1, 2)
FLEET_LR = 1e-2
CLIP = 0.05


def mlp():
    return pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.Tanh(),
                            pt.nn.Linear(16, 4))


def mlp_batches(rank):
    rng = np.random.RandomState(100 + rank)
    return [rng.randn(8, 8).astype(np.float32) for _ in range(MLP_STEPS)]


def mlp_loss(model, x):
    return (model(pt.to_tensor(x)) ** 2).mean()


def bert_batch():
    """``tests/test_baseline_alignment.py``'s batch: ids, MLM labels (4 a
    row), NSP labels, the same on every rank."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, bert_tiny().vocab_size, (2, 16)).astype(np.int32)
    mlm = np.full((2, 16), -100, np.int64)
    mlm[:, :4] = rng.randint(0, bert_tiny().vocab_size, (2, 4))
    nsp = rng.randint(0, 2, (2,)).astype(np.int32)
    return ids, mlm, nsp


def bert_loss(model, crit, batch):
    ids, mlm, nsp = batch
    scores, rel = model(pt.to_tensor(ids))
    return crit(scores, rel, pt.to_tensor(mlm), pt.to_tensor(nsp))


def load(model, init, prefix):
    model.set_state_dict({k[len(prefix):]: init[k] for k in init.files
                          if k.startswith(prefix)})


def flat_state(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


def train(model_w, opt, loss_of, batches, state_of, probe=None):
    """Steps of ``model_w`` (loss, backward, ``opt.step``, clear): the
    losses and the state after each step (``state_of()``); ``probe()``
    after the first backward."""
    losses, states = [], []
    for i, b in enumerate(batches):
        loss = loss_of(model_w, b)
        loss.backward()
        if i == 0 and probe is not None:
            probe()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        states.append(state_of())
    return losses, states


def mlp_level(level, init, rank, meta):
    model = mlp()
    load(model, init, "mlp.")
    inner = pt.optimizer.SGD(parameters=model.parameters(),
                             learning_rate=MLP_LR)
    model_w, opt, _ = group_sharded_parallel(model, inner, level)
    info = {}
    params = model.parameters()

    def probe():
        # after the first backward: which gradients a rank still holds
        info["grads_held"] = [p.grad is not None for p in params]

    if level == "os":
        info["local"] = [i for i, p in enumerate(params)
                         if any(p is q for q in inner._parameter_list)]
    elif level == "os_g":
        info["local"] = [i for i, p in enumerate(params)
                         if opt._param_owner[id(p)] == opt._rank]
    else:
        info["piece_sizes"] = [p.numel() for p in params]
    losses, states = train(
        model_w, opt, mlp_loss, mlp_batches(rank),
        lambda: flat_state(model_w.state_dict() if level == "p_g_os"
                           else model.state_dict()), probe)
    if level == "p_g_os":
        info["piece_sizes_after"] = [p.numel() for p in params]
        info["state_keys"] = list(states[-1])
    meta[level] = info
    return losses, states


def bert_os_g(init):
    model = BertForPreTraining(bert_tiny(**BERT_CFG))
    load(model, init, "bert.")
    crit = BertPretrainingCriterion(model.config.vocab_size)
    inner = pt.optimizer.AdamW(learning_rate=BERT_LR,
                               parameters=model.parameters())
    model_w, opt, _ = group_sharded_parallel(model, inner, "os_g")
    batch = bert_batch()
    return train(model_w, opt, lambda m, b: bert_loss(m, crit, b),
                 [batch] * BERT_STEPS, lambda: {})[0]


def fleet_stage(stage, init, rank, meta):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                        "sharding_degree": dist.get_world_size()}
    s.sharding = True
    s.sharding_configs = {"stage": stage}
    fleet.init(is_collective=True, strategy=s, device="cpu")
    model = mlp()
    load(model, init, "mlp.")
    opt = pt.optimizer.AdamW(learning_rate=FLEET_LR,
                             parameters=model.parameters(),
                             grad_clip=pt.nn.ClipGradByGlobalNorm(CLIP))
    model_w = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)
    meta["fleet_%d" % stage] = {
        "model": type(model_w).__name__,
        "optimizer": type(opt._inner_opt).__name__}
    losses, states = train(model_w, opt, mlp_loss, mlp_batches(rank),
                           lambda: flat_state(model.state_dict()))
    meta["fleet_%d" % stage]["inner_after"] = type(opt._inner_opt).__name__
    fleet.fleet._hcg = None
    return losses, states


def run(out):
    torch.set_num_threads(1)
    init_parallel_env("cpu")
    rank = dist.get_rank()
    pt.set_device("cpu")
    init = np.load(os.path.join(out, "init.npz"))
    arrays, meta = {}, {}

    def keep(tag, losses, states=()):
        arrays[tag + "/losses"] = np.array(losses)
        for i, st in enumerate(states):
            for k, v in st.items():
                arrays["%s/%d/%s" % (tag, i, k)] = v

    for level in LEVELS:
        keep(level, *mlp_level(level, init, rank, meta))
    keep("bert_os_g", bert_os_g(init))
    for stage in FLEET_STAGES:
        keep("fleet_%d" % stage, *fleet_stage(stage, init, rank, meta))
    np.savez(os.path.join(out, "sharding_r%d.npz" % rank), **arrays)
    with open(os.path.join(out, "sharding_r%d.json" % rank), "w") as f:
        json.dump(meta, f)
