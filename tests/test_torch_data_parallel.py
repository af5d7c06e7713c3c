"""The port's ``DataParallel`` over two gloo ranks.

``tests/test_baseline_workloads.py`` #2 (ResNet-18 under pure data
parallelism, SGD, 2 x 3 x 32 x 32 a rank, 3 steps) in two processes
(``tests/_torch_dp_workers.py``, torch only), against one process that
runs the two ranks' batches in turn and averages their gradients: the
ranks' parameters are bitwise equal after every step (the JAX test's
hash) and equal to the one-process run's within 1e-6 (the same ops on
the same values; the mean of two gradients is the same sum either way).
Rank 1 starts from other weights than rank 0: the wrap-time broadcast
makes them equal. The buckets (4 MB here) cover every parameter, in
reverse registration order, and each is flushed once a step by the
gradient-ready hooks.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import device
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.vision.models import resnet18

import _torch_dp_workers as W

torch.set_num_threads(1)

RANKS = 2
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the ranks, run the one-process reference beside them, then
    collect the ranks' files."""
    out = tmp_path_factory.mktemp("dp")
    prev = device._current
    pt.set_device("cpu")
    try:
        pt.seed(0)
        model = resnet18(num_classes=W.CLASSES)
        init = {k: v.detach().numpy().copy()
                for k, v in model.state_dict().items()}
        np.savez(out / "init.npz", **init)
        ctx = spawn(W.run, (str(out),), nprocs=RANKS, join=False)
        ref = reference(model)
        while not ctx.join():
            pass
    finally:
        pt.set_device(prev)
    ranks = []
    for r in range(RANKS):
        with open(out / ("dp_r%d.json" % r)) as f:
            meta = json.load(f)
        data = np.load(out / ("dp_r%d.npz" % r))
        meta["state"] = {k: data[k] for k in data.files if k != "losses"}
        meta["losses"] = data["losses"]
        ranks.append(meta)
    return dict(ranks=ranks, ref=ref, init=init)


def reference(model):
    """One process: every step, each rank's batch through the model in
    turn (their gradients kept apart), the mean of the two, SGD."""
    opt = pt.optimizer.SGD(parameters=model.parameters(),
                           learning_rate=W.LR)
    loss_fn = pt.nn.CrossEntropyLoss()
    per_rank = [W.batches(r) for r in range(RANKS)]
    losses = []
    for step in range(W.STEPS):
        grads, step_losses = [], []
        for r in range(RANKS):
            x, y = per_rank[r][step]
            model.clear_gradients()
            loss = loss_fn(model(pt.to_tensor(x)), pt.to_tensor(y))
            loss.backward()
            step_losses.append(float(loss.detach()))
            grads.append([p.grad.clone() for p in model.parameters()])
        for p, *gs in zip(model.parameters(), *grads):
            p.grad = sum(gs) / RANKS
        opt.step()
        opt.clear_grad()
        losses.append(step_losses)
    return dict(losses=np.array(losses),
                params={k: v.detach().numpy()
                        for k, v in model.named_parameters()})


def test_ranks_bitwise_equal_after_every_step(runs):
    hashes = [r["hashes"] for r in runs["ranks"]]
    assert len(hashes[0]) == W.STEPS + 1
    assert hashes[0] == hashes[1]
    assert len(set(hashes[0])) == W.STEPS + 1      # every step moved


def test_ranks_match_one_process_averaging(runs):
    ref = runs["ref"]
    for r, rank in enumerate(runs["ranks"]):
        np.testing.assert_allclose(rank["losses"], ref["losses"][:, r], **TOL)
        for name, want in ref["params"].items():
            assert np.all(np.isfinite(want)), name
            np.testing.assert_allclose(rank["state"][name], want,
                                       err_msg=name, **TOL)


def test_wrap_broadcasts_rank0_parameters(runs):
    first = [r["hashes"][0] for r in runs["ranks"]]
    start = W.param_hash(torch.from_numpy(runs["init"][k])
                         for k in runs["ref"]["params"])
    assert first == [start] * RANKS
    assert runs["ranks"][0]["before_wrap"] == start
    assert runs["ranks"][1]["before_wrap"] != start


def test_buckets_cover_every_parameter_in_reverse_order(runs):
    meta = runs["ranks"][0]
    n_params = len(runs["ref"]["params"])
    assert meta["buckets"] > 1
    assert sum(meta["bucket_sizes"]) == n_params
    assert meta["flushes"] == meta["buckets"] * W.STEPS


def test_one_rank_is_the_layer_itself():
    prev = device._current
    pt.set_device("cpu")
    try:
        layer = pt.nn.Linear(3, 2)
        dp = pt.DataParallel(layer)
        assert dp._reducer is None
        assert dp.parameters() == layer.parameters()
        assert set(dp.state_dict()) == {"weight", "bias"}
        x = pt.to_tensor(np.ones((4, 3), np.float32))
        torch.testing.assert_close(dp(x), layer(x))
        assert dp.scale_loss(x) is x
        dp.apply_collective_grads()
    finally:
        pt.set_device(prev)
