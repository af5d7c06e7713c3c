"""Rank code of ``tests/test_torch_data_parallel.py``.

Runs in the processes that ``paddle_tpu_torch.distributed.spawn`` starts
(gloo, CPU), so it imports torch and the port only: no JAX, and not the
tests' conftest. :func:`run` trains ``tests/test_baseline_workloads.py``
#2's model under ``DataParallel`` (ResNet-18, 4 classes, SGD lr 0.01,
rank r's batches of 2 x 3 x 32 x 32 from ``np.random.RandomState(r)``,
3 steps). Rank 0 starts from the parent's weights (``init.npz``), the
other ranks from other seeds, so the wrap-time broadcast is what makes
them equal. Each rank writes ``dp_r<rank>.npz`` (its parameters after
the last step, its losses) and ``dp_r<rank>.json`` (a hash of its
parameters before the wrap, after it and after every step, the buckets
and their flushes).
"""
import hashlib
import json
import os

import numpy as np
import torch
import torch.distributed as dist

import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import init_parallel_env
from paddle_tpu_torch.vision.models import resnet18

STEPS = 3
BATCH = (2, 3, 32, 32)
CLASSES = 4
LR = 0.01
BUCKET_MB = 4       # ResNet-18's 44.7 MB of f32 grads in several buckets


def batches(rank):
    """Rank ``rank``'s batches, as the JAX test draws them."""
    rng = np.random.RandomState(rank)
    return [(rng.randn(*BATCH).astype(np.float32),
             rng.randint(0, CLASSES, (BATCH[0],)).astype(np.int64))
            for _ in range(STEPS)]


def param_hash(params):
    return hashlib.sha1(b"".join(
        p.detach().numpy().tobytes() for p in params)).hexdigest()


def run(out):
    torch.set_num_threads(1)
    init_parallel_env("cpu")
    rank = dist.get_rank()
    pt.set_device("cpu")
    pt.seed(100 + rank)
    model = resnet18(num_classes=CLASSES)
    if rank == 0:
        init = np.load(os.path.join(out, "init.npz"))
        model.set_state_dict({k: init[k] for k in init.files})
    before = param_hash(model.parameters())
    dp = pt.DataParallel(model, comm_buffer_size=BUCKET_MB)
    opt = pt.optimizer.SGD(parameters=dp.parameters(), learning_rate=LR)
    loss_fn = pt.nn.CrossEntropyLoss()
    hashes, losses = [param_hash(dp.parameters())], []
    for x, y in batches(rank):
        loss = loss_fn(dp(pt.to_tensor(x)), pt.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        hashes.append(param_hash(dp.parameters()))
    red = dp._reducer
    np.savez(os.path.join(out, "dp_r%d.npz" % rank), losses=losses,
             **{k: v.detach().numpy() for k, v in
                dp.state_dict().items()})
    with open(os.path.join(out, "dp_r%d.json" % rank), "w") as f:
        json.dump({"before_wrap": before, "hashes": hashes, "buckets": len(red.buckets),
                   "bucket_sizes": [len(b) for b in red.buckets],
                   "flushes": red.flushes}, f)
