"""Rank code of ``tests/test_torch_sequence_parallel.py``.

Runs in the processes that ``paddle_tpu_torch.distributed.spawn``
starts (gloo, CPU), so it imports torch and the port only: no JAX, and
not the tests' conftest. :func:`run_ranks` runs the sequence-parallel
attention functions on the global q / k / v of ``qkv.npz`` over groups
of 2 and 4 ranks, the point-to-point and all-to-all collectives, and
every run of :data:`RUNS` from the JAX model's weights and batch
(``weights_*.npz``, ``batch.npz``); rank 0 writes what it gathered to
``out``, and the one-process references run one a rank.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch.convert import gather_opt_state, gather_params
from paddle_tpu_torch.distributed import (ProcessMesh, collective,
                                          init_parallel_env)
from paddle_tpu_torch.distributed.sequence_parallel import (
    ring_attention_sharded, ulysses_attention_sharded)
from paddle_tpu_torch.jit import TrainStep

import _torch_mesh_workers as W

# name: (model, sequence_parallel_mode, mesh shape, axis names, fsdp axis)
RUNS = {
    "gpt_gspmd_dp2sp2": ("gpt", "gspmd", (2, 2), ("dp", "sp"), "dp"),
    "gpt_ring_dp2sp2": ("gpt", "ring", (2, 2), ("dp", "sp"), "dp"),
    "gpt_ulysses_dp2sp2": ("gpt", "ulysses", (2, 2), ("dp", "sp"), "dp"),
    "llama_ulysses_sp2mp2": ("llama", "ulysses", (2, 2), ("sp", "mp"),
                             None),
    "llama_ring_sp4": ("llama", "ring", (4,), ("sp",), None),
}
# the run repeated with accumulate_steps=2, and with run_steps
ACCUMULATE = "gpt_ring_dp2sp2"
# the one-process references, file: (run, accumulate_steps). Without an
# sp group the three modes are one model, so a model kind has one.
REFERENCES = {"one_gpt": ("gpt_gspmd_dp2sp2", 1),
              "one_llama": ("llama_ulysses_sp2mp2", 1),
              "one_accumulate": (ACCUMULATE, 2)}
FUNCTIONS = {"ring": ring_attention_sharded,
             "ulysses": ulysses_attention_sharded}
SP_SIZES = (2, 4)


def train(name, weights, batch, on_mesh=True, accumulate=1,
          chained=False):
    """The run's STEPS steps (one call each, or one step and then
    ``run_steps`` with ``chained``), on its mesh or (``on_mesh=False``)
    in one process; returns (losses, model, step)."""
    kind, mode, shape, names, fsdp = RUNS[name]
    m = W.port_model(kind, weights, sequence_parallel_mode=mode)
    mesh = ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape),
                       names) if on_mesh else None
    step = TrainStep(m, W.optimizer(), mesh=mesh,
                     fsdp_axis=fsdp if on_mesh else None,
                     grad_clip_norm=1.0, accumulate_steps=accumulate,
                     device="cpu", batch_specs=[("dp", "sp")] * 2
                     if on_mesh else None)
    if chained:
        losses = [float(step(*batch)),
                  float(step.run_steps(W.STEPS - 1, *batch))]
    else:
        losses = [float(step(*batch)) for _ in range(W.STEPS)]
    return losses, m, step


def one_process(name, weights, batch, accumulate=1):
    """The run in one process: losses, parameters, m / vr / vc."""
    losses, m, step = train(name, weights, batch, on_mesh=False,
                            accumulate=accumulate)
    one = {"losses": np.array(losses)}
    one.update({k: v.detach().numpy() for k, v in m.state_dict().items()})
    one.update(W.flat_state({k: [e.float().numpy() for e in v]
                             for k, v in step.opt_state.items()
                             if isinstance(v, list)}))
    return one


def functions(out):
    """ring / ulysses on groups of 2 and 4 ranks: the global outputs
    (causal and full) and the grads of sum(out^2) (causal)."""
    qkv = np.load(os.path.join(out, "qkv.npz"))
    res = {}
    for n in SP_SIZES:
        group = collective.new_group(range(n))
        if dist.get_rank() >= n:
            continue
        for fname, fn in FUNCTIONS.items():
            for causal in (True, False):
                q, k, v = (torch.from_numpy(qkv[x]).requires_grad_()
                           for x in "qkv")
                o = fn(q, k, v, group, causal=causal)
                res["%s%d_out_%d" % (fname, n, causal)] = o.detach().numpy()
                if causal:
                    (o ** 2).sum().backward()
                    for x, t in zip("qkv", (q, k, v)):
                        res["%s%d_d%s" % (fname, n, x)] = t.grad.numpy()
    return res


def collectives():
    """all_to_all, send / recv around the ring of 4 and
    batch_isend_irecv both ways: this rank's results."""
    r, n = dist.get_rank(), dist.get_world_size()
    got = collective.all_to_all(
        [], [torch.tensor([10.0 * r + i]) for i in range(n)])
    buf = torch.empty(1)
    if r % 2 == 0:
        collective.send(torch.tensor([float(r)]), (r + 1) % n)
        collective.recv(buf, (r - 1) % n)
    else:
        collective.recv(buf, (r - 1) % n)
        collective.send(torch.tensor([float(r)]), (r + 1) % n)
    left, right = torch.empty(1), torch.empty(1)
    ops = [collective.P2POp(collective.isend, torch.tensor([float(r)]),
                            (r + 1) % n),
           collective.P2POp(collective.isend, torch.tensor([float(r)]),
                            (r - 1) % n),
           collective.P2POp(collective.irecv, left, (r - 1) % n),
           collective.P2POp(collective.irecv, right, (r + 1) % n)]
    for req in collective.batch_isend_irecv(ops):
        req.wait()
    return np.concatenate([torch.cat(got), buf, left, right])


def run_ranks(out):
    torch.set_num_threads(1)
    init_parallel_env("cpu")
    batch = tuple(np.load(os.path.join(out, "batch.npz"))[k]
                  for k in ("ids", "labels"))
    weights = {k: dict(np.load(os.path.join(out, "weights_%s.npz" % k)))
               for k in W.MODELS}
    W.save(out, "functions", **functions(out))
    mine = collectives()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    W.save(out, "collectives", coll=np.stack(every))
    for name in RUNS:
        losses, m, step = train(name, weights[RUNS[name][0]], batch)
        W.save(out, name, losses=np.array(losses), **gather_params(m),
               **W.flat_state(gather_opt_state(step)))
    try:                               # 30 tokens a row over sp 4
        step(*(b[:, :30] for b in batch))
        raised = False
    except ValueError as e:
        raised = "sp=4" in str(e)
    W.save(out, "uneven", raised=np.array(raised))
    losses, m, _ = train(ACCUMULATE, weights[RUNS[ACCUMULATE][0]], batch,
                         accumulate=2)
    W.save(out, "accumulate", losses=np.array(losses), **gather_params(m))
    losses, m, _ = train(ACCUMULATE, weights[RUNS[ACCUMULATE][0]], batch,
                         chained=True)
    W.save(out, "chained", losses=np.array(losses), **gather_params(m))
    # the one-process references, one a rank
    refs = sorted(REFERENCES)
    if dist.get_rank() < len(refs):
        name, accumulate = REFERENCES[refs[dist.get_rank()]]
        np.savez(os.path.join(out, refs[dist.get_rank()] + ".npz"),
                 **one_process(name, weights[RUNS[name][0]], batch,
                               accumulate=accumulate))


# ----------------------------------------------------------- on two cards
def cuda_sp2(out):
    """The 2-layer f32 Llama at Llama-2 7B's width, 3 steps on an sp 2
    mesh of two cards (NCCL) in ring and then ulysses mode, each against
    the same steps on one card (rank 0 alone, first): the K1 / K2 / K3
    launches of each run and the gathered parameters."""
    import dataclasses

    from paddle_tpu_torch.incubate.nn.cuda import flash_attn as fa
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7B
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    init_parallel_env()
    rng = np.random.RandomState(0)
    batches = [tuple(rng.randint(0, 32000, (2, 512)) for _ in range(2))
               for _ in range(W.STEPS)]

    def run(mode, mesh):
        cfg = dataclasses.replace(
            llama2_7B(recompute=True, lm_ce_chunks=4,
                      sequence_parallel_mode=mode), num_layers=2)
        m = LlamaForCausalLM(cfg, generator=torch.Generator(
            device="cuda").manual_seed(0))
        step = TrainStep(m, AdamW(learning_rate=1e-4, weight_decay=0.01,
                                  factored_v=True), mesh=mesh,
                         grad_clip_norm=1.0)
        for f in (fa.flash_fwd, fa.flash_bwd_fused, fa.flash_bwd_split):
            f.launches = 0
        losses = np.array([float(step(*b)) for b in batches])
        launches = np.array([fa.flash_fwd.launches,
                             fa.flash_bwd_fused.launches,
                             fa.flash_bwd_split.launches])
        return losses, launches, m

    saved = {}
    if dist.get_rank() == 0:
        losses, _, m = run("gspmd", None)
        saved["ref_losses"] = losses
        saved.update({"ref:" + k: v.detach().cpu().numpy()
                      for k, v in m.named_parameters()})
        del m
    dist.barrier()
    for mode in ("ring", "ulysses"):
        losses, launches, m = run(mode, ProcessMesh([0, 1], ["sp"]))
        saved[mode + "_losses"] = losses
        saved[mode + "_launches"] = launches
        saved.update({"%s:%s" % (mode, k): v
                      for k, v in gather_params(m).items()})
        del m
    W.save(out, "cuda_sp2", **saved)
