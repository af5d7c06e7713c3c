"""Rank code of ``tests/test_torch_fleet_pipeline.py``.

Runs in the processes that ``paddle_tpu_torch.distributed.spawn``
starts (gloo, CPU), so it imports torch and the port only: no JAX, and
not the tests' conftest. :func:`run_world` joins the gloo group and
runs every job of :data:`JOBS` for its world size in order, each with
its own ``fleet.init``; each rank writes ``<job>_r<rank>.npz`` (its
losses on the last stage, its pieces of the parameters, keyed as the
one-process ``PipelineLayer`` keys the whole ones, and where each piece
sits) or ``<job>_r<rank>.json``. The weights and batches come from the
parent's files (``<job>.npz``: ``run_function.{i}.{name}`` full
matrices, ``x``, ``y``).

The stage classes of the Megatron GPT pipeline (:class:`Embed`,
:class:`MegatronBlock`, :class:`Head`) are the fleet user's model of
``chip_smoke.py`` phase 9g at ``gpt_tiny``'s width; their parameter
names are the JAX ``GPTBlock``'s, so the JAX model's ``state_dict``
maps onto them.
"""
import json
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from paddle_tpu_torch.convert import fleet_params
from paddle_tpu_torch.distributed import fleet, init_parallel_env
from paddle_tpu_torch.distributed.fleet import (
    ColumnParallelLinear, LayerDesc, ParallelCrossEntropy, PipelineLayer,
    PipelineParallel, PipelineParallelWithInterleave,
    PipelineParallelZeroBubble, RowParallelLinear, VocabParallelEmbedding)
from paddle_tpu_torch.distributed.fleet.mp_layers import is_distributed
from paddle_tpu_torch.incubate.nn.functional import \
    scaled_dot_product_attention
from paddle_tpu_torch.models.gpt import GPTBlock, GPTConfig
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import SGD, AdamW

# the JAX tests' models: test_hybrid_tp_pp.py (TP_PP), test_pipeline_
# parallel.py (PP), test_baseline_workloads.py #4 (GPT)
TP_PP = dict(d=8, h=16, blocks=2, steps=5, lr=0.05, accumulate=2)
PP = dict(d=8, layers=4, interleave_layers=8, steps=8, lr=0.01,
          accumulate=4)
GPT = dict(vocab=128, hidden=32, layers=4, heads=4, seq=16, batch=4,
           steps=6, lr=3e-3, accumulate=2)
# the Megatron stack at gpt_tiny's width, merged over 2 train_batch calls
MEGATRON = dict(vocab=1024, hidden=128, heads=4, ffn=512, layers=2,
                seq=32, batch=4, steps=4, lr=1e-3, accumulate=2,
                k_steps=2, eps=1e-5)
QKV_PARTS = {"attn.qkv_proj.weight": 3, "attn.qkv_proj.bias": 3}
SCHEDULES = {"1f1b": PipelineParallel,
             "interleave": PipelineParallelWithInterleave,
             "zb": PipelineParallelZeroBubble}


# ---------------------------------------------------------------- stages
class Embed(nn.Module):
    """The embedding stage: the vocabulary-parallel table plus the
    position table (replicated)."""

    def __init__(self, vocab, hidden, max_pos, device="cpu", dtype=None):
        super().__init__()
        self.wte = VocabParallelEmbedding(vocab, hidden, device=device,
                                          dtype=dtype)
        self.wpe = nn.Embedding(max_pos, hidden, device=device, dtype=dtype)

    def forward(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)
        return self.wte(ids) + self.wpe(pos)[None]


class _Attention(nn.Module):
    def __init__(self, hidden, heads, device, dtype):
        super().__init__()
        self.head_dim = hidden // heads
        self.qkv_proj = ColumnParallelLinear(hidden, 3 * hidden,
                                             has_bias=True,
                                             gather_output=False,
                                             device=device, dtype=dtype)
        self.out_proj = RowParallelLinear(hidden, hidden, has_bias=True,
                                          input_is_parallel=True,
                                          device=device, dtype=dtype)

    def forward(self, x):
        b, s = x.shape[:2]
        qkv = self.qkv_proj(x).reshape(b, s, 3, -1, self.head_dim)
        out = scaled_dot_product_attention(qkv[:, :, 0], qkv[:, :, 1],
                                           qkv[:, :, 2], is_causal=True)
        return self.out_proj(out.reshape(b, s, -1))


class _MLP(nn.Module):
    def __init__(self, hidden, ffn, device, dtype):
        super().__init__()
        self.fc1 = ColumnParallelLinear(hidden, ffn, has_bias=True,
                                        gather_output=False, device=device,
                                        dtype=dtype)
        self.fc2 = RowParallelLinear(ffn, hidden, has_bias=True,
                                     input_is_parallel=True, device=device,
                                     dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class MegatronBlock(nn.Module):
    """Pre-LN GPT block of mp layers: this rank's heads of attention
    (the port's SDPA: K1 / K2 on the card) and its part of the MLP."""

    def __init__(self, hidden, heads, ffn, eps, device="cpu", dtype=None):
        super().__init__()
        self.ln_1 = nn.LayerNorm(hidden, eps, device=device, dtype=dtype)
        self.attn = _Attention(hidden, heads, device, dtype)
        self.ln_2 = nn.LayerNorm(hidden, eps, device=device, dtype=dtype)
        self.mlp = _MLP(hidden, ffn, device, dtype)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Head(nn.Module):
    """The last stage's final LayerNorm and the vocabulary-parallel
    logits (the loss: :func:`parallel_ce`)."""

    def __init__(self, hidden, vocab, eps, device="cpu", dtype=None):
        super().__init__()
        self.ln_f = nn.LayerNorm(hidden, eps, device=device, dtype=dtype)
        self.proj = ColumnParallelLinear(hidden, vocab, has_bias=False,
                                         gather_output=False, device=device,
                                         dtype=dtype)

    def forward(self, x):
        return self.proj(self.ln_f(x))


def parallel_ce(logits, labels):
    return ParallelCrossEntropy()(logits, labels).mean()


def megatron_descs(cfg, device="cpu", dtype=None):
    return ([LayerDesc(Embed, cfg["vocab"], cfg["hidden"], cfg["seq"],
                       device=device, dtype=dtype)]
            + [LayerDesc(MegatronBlock, cfg["hidden"], cfg["heads"],
                         cfg["ffn"], cfg["eps"], device=device, dtype=dtype)
               for _ in range(cfg["layers"])]
            + [LayerDesc(Head, cfg["hidden"], cfg["vocab"], cfg["eps"],
                         device=device, dtype=dtype)])


class Block(nn.Module):
    """test_hybrid_tp_pp.py's block: x + row(tanh(col(x)))."""

    def __init__(self, d, h):
        super().__init__()
        self.col = ColumnParallelLinear(d, h, has_bias=False,
                                        gather_output=False, device="cpu")
        self.row = RowParallelLinear(h, d, has_bias=False,
                                     input_is_parallel=True, device="cpu")

    def forward(self, x):
        return x + self.row(torch.tanh(self.col(x)))


class PipeGPTBlock(GPTBlock):
    """The port's GPTBlock as a pipeline layer (its output alone)."""

    def forward(self, x):
        return super().forward(x)[0]


class EmbedIn(nn.Module):
    def __init__(self, vocab, hidden):
        super().__init__()
        self.emb = nn.Embedding(vocab, hidden)

    def forward(self, ids):
        return self.emb(ids)


def gpt_ce(logits, labels):
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def mse(out, y):
    return ((out - y) ** 2).mean()


# ------------------------------------------------------------------ jobs
def _strategy(dp=1, mp=1, pp=1, accumulate=1, k_steps=1):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp}
    s.pipeline_configs = {"accumulate_steps": accumulate}
    if k_steps > 1:
        s.gradient_merge = True
        s.gradient_merge_configs = {"k_steps": k_steps, "avg": True}
    return s


def _pieces(pipe):
    """This rank's parameters keyed by the whole model's names, each
    with (split axis or -1, mp rank, mp size)."""
    out, where = {}, {}
    for j, i in enumerate(pipe.layer_indices):
        layer = pipe.run_function[j]
        for name, p in layer.named_parameters():
            key = "run_function.%d.%s" % (i, name)
            out[key] = p.detach().float().cpu().numpy().copy()
            rank = size = 0
            if is_distributed(p):
                mod = next(m for m in layer.modules() if any(
                    q is p for q in m.parameters(recurse=False)))
                rank, size = mod.rank, mod.world_size
            where[key] = [getattr(p, "split_axis", -1) if size else -1,
                          rank, size]
    return out, where


def _train(job, data, descs, strategy, opt_fn, loss_fn, steps, schedule,
           vpp=None, parts=None, dp_cut=False, device="cpu"):
    """The job's pipeline from the full weights in ``data``: ``steps``
    train_batch calls on (x, y) (each dp replica its rows), then (but
    for the interleaved schedule, whose chunks have no flat forward)
    eval_batch on the last batch, its loss after the steps'; returns the
    rank's record, with the K1 / K2 launches of the calls on a card."""
    from paddle_tpu_torch.incubate.nn.cuda import flash_attn as fa

    fleet.init(is_collective=True, strategy=strategy, device=device)
    hcg = fleet.get_hybrid_communicate_group()
    pipe = PipelineLayer(descs, loss_fn=loss_fn,
                         num_virtual_pipeline_stages=vpp)
    pipe.load_state_dict(fleet_params(data, pipe, parts))
    model = SCHEDULES[schedule](pipe, hcg, strategy)
    opt = fleet.distributed_optimizer(opt_fn(pipe.parameters()))
    # "per_step": a batch a train_batch call (x, y stacked [steps, ...])
    xs, ys = (data["x"], data["y"]) if "per_step" in data else \
        ([data["x"]] * steps, [data["y"]] * steps)
    if dp_cut:
        n, r = hcg.get_data_parallel_world_size(), \
            hcg.get_data_parallel_rank()
        m = xs[0].shape[0] // n
        xs = [x[r * m:(r + 1) * m] for x in xs]
        ys = [y[r * m:(r + 1) * m] for y in ys]
    losses = []
    fa.flash_fwd.launches = fa.flash_bwd_fused.launches = 0
    for x, y in zip(xs, ys):
        loss = model.train_batch((x, y), opt)
        if loss is not None:
            losses.append(float(loss))
    rec = {"p2p_bytes": model.p2p_bytes,
           "launches": np.array([fa.flash_fwd.launches,
                                 fa.flash_bwd_fused.launches])}
    if schedule != "interleave":
        # the trained model's loss on the last batch, forward only
        loss = model.eval_batch((xs[-1], ys[-1]))
        if loss is not None:
            losses.append(float(loss))
    params, where = _pieces(pipe)
    rec.update(losses=np.array(losses), stage=hcg.get_stage_id(),
               dp_rank=hcg.get_data_parallel_rank())
    rec.update({"p:" + k: v for k, v in params.items()})
    rec.update({"w:" + k: np.array(v) for k, v in where.items()})
    return rec


def job_tp_pp(data):
    c = TP_PP
    return _train("tp_pp", data, [LayerDesc(Block, c["d"], c["h"])
                                  for _ in range(c["blocks"])],
                  _strategy(mp=2, pp=2, accumulate=c["accumulate"]),
                  lambda ps: SGD(learning_rate=c["lr"], parameters=ps),
                  mse, c["steps"], "1f1b")


def _job_pp(schedule):
    def job(data):
        c = PP
        n = c["interleave_layers"] if schedule == "interleave" \
            else c["layers"]
        descs = [LayerDesc(ColumnParallelLinear, c["d"], c["d"],
                           has_bias=True, device="cpu") for _ in range(n)]
        return _train("pp_" + schedule, data, descs,
                      _strategy(pp=2, accumulate=c["accumulate"]),
                      lambda ps: SGD(learning_rate=c["lr"], parameters=ps),
                      mse, c["steps"], schedule,
                      vpp=2 if schedule == "interleave" else None)
    return job


def _gpt_descs():
    c = GPT
    cfg = GPTConfig(vocab_size=c["vocab"], hidden_size=c["hidden"],
                    num_layers=c["layers"], num_heads=c["heads"],
                    max_position_embeddings=c["seq"])
    return ([LayerDesc(EmbedIn, c["vocab"], c["hidden"])]
            + [LayerDesc(PipeGPTBlock, cfg, i, device="cpu")
               for i in range(c["layers"])]
            + [LayerDesc(ColumnParallelLinear, c["hidden"], c["vocab"],
                         has_bias=True, device="cpu")])


def _job_gpt(dp):
    def job(data):
        c = GPT
        return _train("gpt", data, _gpt_descs(),
                      _strategy(dp=dp, pp=2, accumulate=c["accumulate"]),
                      lambda ps: AdamW(learning_rate=c["lr"], parameters=ps),
                      gpt_ce, c["steps"], "1f1b", dp_cut=dp > 1)
    return job


def _job_megatron(factored):
    def job(data):
        c = MEGATRON
        return _train(
            "megatron", data, megatron_descs(c),
            _strategy(mp=2, pp=2, accumulate=c["accumulate"],
                      k_steps=c["k_steps"]),
            lambda ps: AdamW(learning_rate=c["lr"], parameters=ps,
                             factored_v=factored,
                             grad_clip=ClipGradByGlobalNorm(1.0)),
            parallel_ce, c["steps"], "1f1b", parts=QKV_PARTS)
    return job


def job_mp_layers(data, device="cpu"):
    """The mp layers alone at mp 2 on this rank's pieces of the full
    matrices: outputs and the gradients of sum(out * c)."""
    fleet.init(is_collective=True, strategy=_strategy(mp=2), device=device)
    hcg = fleet.get_hybrid_communicate_group()
    r = hcg.get_model_parallel_rank()
    out = {}

    def t(name, grad=False):
        return torch.tensor(data[name], device=device, requires_grad=grad)

    def load(layer, **full):
        with torch.no_grad():
            for name, arr in full.items():
                p = getattr(layer, name)
                a = getattr(p, "split_axis", None)
                src = torch.from_numpy(arr)
                p.copy_(src.chunk(2, a)[r] if a is not None else src)
        return layer

    def host(x):
        return x.detach().cpu().numpy()

    def record(tag, y, inputs, layers):
        (y * t(tag + "_c")).sum().backward()
        out[tag + "_out"] = host(y)
        for name, x in inputs.items():
            out["%s_d%s" % (tag, name)] = host(x.grad)
        for lname, layer in layers.items():
            for pname, p in layer.named_parameters():
                out["%s_d%s.%s" % (tag, lname, pname)] = host(p.grad)

    # column, gathered
    x = t("col_x", True)
    col = load(ColumnParallelLinear(8, 16, has_bias=True,
                                    gather_output=True, device=device),
               weight=data["col_w"], bias=data["col_b"])
    record("col", col(x), {"x": x}, {"col": col})
    # column (not gathered) into row (input parallel): Megatron's MLP
    x = t("mlp_x", True)
    c1 = load(ColumnParallelLinear(8, 16, has_bias=True,
                                   gather_output=False, device=device),
              weight=data["col_w"], bias=data["col_b"])
    r1 = load(RowParallelLinear(16, 8, has_bias=True,
                                input_is_parallel=True, device=device),
              weight=data["row_w"], bias=data["row_b"])
    mlp = fleet.distributed_model(torch.nn.Sequential(c1, torch.nn.Tanh(),
                                                      r1))
    assert type(mlp).__name__ == "TensorParallel"
    record("mlp", mlp(x), {"x": x}, {"col": c1, "row": r1})
    # row, splitting a replicated input itself
    x = t("row_x", True)
    r2 = load(RowParallelLinear(16, 8, has_bias=True,
                                input_is_parallel=False, device=device),
              weight=data["row_w"], bias=data["row_b"])
    record("row", r2(x), {"x": x}, {"row": r2})
    # vocabulary-parallel embedding
    emb = load(VocabParallelEmbedding(32, 8, device=device),
               weight=data["emb_w"])
    record("emb", emb(t("ids")), {}, {"emb": emb})
    # cross entropy over vocabulary-split logits
    logits = t("logits").chunk(2, -1)[r].contiguous().requires_grad_()
    loss = ParallelCrossEntropy()(logits, t("labels"))
    record("ce", loss, {"logits": logits}, {})
    out["mp_rank"] = np.array(r)
    return out


def job_topology(strategy):
    """The port's HybridCommunicateGroup's answers on this rank."""
    def job(data):
        fleet.init(is_collective=True, strategy=strategy, device="cpu")
        h = fleet.get_hybrid_communicate_group()
        return {"json": dict(
            dp_rank=h.get_data_parallel_rank(),
            mp_rank=h.get_model_parallel_rank(),
            stage=h.get_stage_id(), pipe_rank=h.get_pipe_parallel_rank(),
            sizes=[h.get_data_parallel_world_size(),
                   h.get_model_parallel_world_size(),
                   h.get_pipe_parallel_world_size()],
            groups=[h._dp_group, h._mp_group, h._pp_group],
            src=[h.get_data_parallel_group_src_rank(),
                 h.get_model_parallel_group_src_rank()],
            prev=h.get_p2p_prev_rank(), next=h.get_p2p_next_rank(),
            first=h.is_first_stage(), last=h.is_last_stage(),
            mode=h.get_parallel_mode())}
    return job


def mp_layers_data():
    """The mp layers' case: full matrices, inputs, cotangents."""
    rng = np.random.RandomState(9)

    def f(*s):
        return rng.randn(*s).astype(np.float32)

    return dict(col_w=f(8, 16) * 0.3, col_b=f(16) * 0.1,
                row_w=f(16, 8) * 0.3, row_b=f(8) * 0.1, col_x=f(4, 8),
                col_c=f(4, 16), mlp_x=f(4, 8), mlp_c=f(4, 8), row_x=f(4, 16),
                row_c=f(4, 8), emb_w=f(32, 8), ids=rng.randint(0, 32, (4, 6)),
                emb_c=f(4, 6, 8), logits=f(4, 6, 32) * 2.0,
                labels=rng.randint(0, 32, (4, 6)), ce_c=f(4, 6))


def mp_layers_reference(d):
    """The same layers as full matrices on one process (plain torch,
    f32): outputs and the gradients of sum(out * c)."""
    out = {}

    def t(name, grad=False):
        return torch.tensor(d[name], requires_grad=grad)

    def record(tag, y, leaves):
        (y * t(tag + "_c")).sum().backward()
        out[tag + "_out"] = y.detach().numpy()
        for name, x in leaves.items():
            out["%s_d%s" % (tag, name)] = x.grad.numpy()

    cw, cb, rw, rb = (t(k, True) for k in ("col_w", "col_b", "row_w",
                                           "row_b"))
    x = t("col_x", True)
    record("col", x @ cw + cb, {"x": x, "col.weight": cw, "col.bias": cb})
    for a in (cw, cb):
        a.grad = None
    x = t("mlp_x", True)
    record("mlp", torch.tanh(x @ cw + cb) @ rw + rb,
           {"x": x, "col.weight": cw, "col.bias": cb, "row.weight": rw,
            "row.bias": rb})
    for a in (rw, rb):
        a.grad = None
    x = t("row_x", True)
    record("row", x @ rw + rb, {"x": x, "row.weight": rw, "row.bias": rb})
    ew = t("emb_w", True)
    record("emb", ew[torch.from_numpy(d["ids"])], {"emb.weight": ew})
    logits = t("logits", True)
    record("ce", F.cross_entropy(logits.reshape(-1, 32), torch.from_numpy(
        d["labels"]).reshape(-1), reduction="none").reshape(4, 6),
        {"logits": logits})
    return out


# the Megatron stack on two cards (K1 / K2 at head_dim 64, f32)
MEGATRON_CUDA = dict(MEGATRON, hidden=256, ffn=1024, steps=3, k_steps=1)


def megatron_data(cfg, seed):
    """Whole weights of the Megatron stack (the port's one-process
    modules from ``paddle_tpu_torch.seed(seed)``) and a batch a step."""
    import paddle_tpu_torch

    paddle_tpu_torch.seed(seed)
    pipe = PipelineLayer(megatron_descs(cfg))
    data = {k: v.detach().numpy().copy()
            for k, v in pipe.state_dict().items()}
    rng = np.random.RandomState(seed)
    shape = (cfg["steps"], cfg["batch"], cfg["seq"])
    data["x"] = rng.randint(0, cfg["vocab"], shape).astype(np.int64)
    data["y"] = rng.randint(0, cfg["vocab"], shape).astype(np.int64)
    data["per_step"] = np.array(1)
    return data


def one_process(name, data, device="cpu"):
    """The job's modules on one process (pp 1, mp 1, dp 1: no group;
    ``fleet.init`` on one rank), through ``PipelineParallel`` over the
    same micro-batches (a dp 2 run's 2 x accumulate_steps): losses and
    whole parameters (and eval_batch's loss after the steps)."""
    if name.startswith("megatron"):
        c = MEGATRON_CUDA if name == "megatron_cuda" else MEGATRON
        strategy = _strategy(accumulate=c["accumulate"], k_steps=c["k_steps"])
        descs, loss_fn, parts = megatron_descs(c, device), parallel_ce, \
            QKV_PARTS

        def opt(ps):
            return AdamW(learning_rate=c["lr"], parameters=ps,
                         factored_v=True,
                         grad_clip=ClipGradByGlobalNorm(1.0))
        batches = list(zip(data["x"], data["y"]))
    else:
        c = GPT
        dp = 2 if name == "gpt_dp2pp2" else 1
        strategy = _strategy(accumulate=c["accumulate"] * dp)
        descs, loss_fn, parts = _gpt_descs(), gpt_ce, None

        def opt(ps):
            return AdamW(learning_rate=c["lr"], parameters=ps)
        batches = [(data["x"], data["y"])] * c["steps"]
    try:
        fleet.init(is_collective=True, strategy=strategy, device=device)
        hcg = fleet.get_hybrid_communicate_group()
        pipe = PipelineLayer(descs, loss_fn=loss_fn)
        pipe.load_state_dict(fleet_params(data, pipe, parts))
        model = PipelineParallel(pipe, hcg, strategy)
        optimizer = fleet.distributed_optimizer(opt(pipe.parameters()))
        losses = [float(model.train_batch(b, optimizer)) for b in batches]
        losses.append(float(model.eval_batch(batches[-1])))
        return np.array(losses), {k: v.detach().cpu().numpy().copy()
                                  for k, v in pipe.state_dict().items()}
    finally:
        fleet.fleet._hcg = None


def cuda_fleet(out):
    """Two cards, one rank a card (NCCL): the mp layers at mp 2, then
    the Megatron stack (f32, head_dim 64) in 1F1B on pp 2."""
    torch.backends.cuda.matmul.allow_tf32 = False
    init_parallel_env()
    rank = dist.get_rank()
    res = job_mp_layers(mp_layers_data(), device="cuda")
    np.savez(os.path.join(out, "mp_layers_r%d.npz" % rank), **res)
    c = MEGATRON_CUDA
    rec = _train("megatron_cuda", dict(np.load(os.path.join(
        out, "megatron_cuda.npz"))), megatron_descs(c, "cuda"),
        _strategy(pp=2, accumulate=c["accumulate"]),
        lambda ps: AdamW(learning_rate=c["lr"], parameters=ps,
                         factored_v=True,
                         grad_clip=ClipGradByGlobalNorm(1.0)),
        parallel_ce, c["steps"], "1f1b", parts=QKV_PARTS, device="cuda")
    np.savez(os.path.join(out, "megatron_cuda_r%d.npz" % rank), **rec)


def job_util(data):
    """``hybrid_parallel_util`` on dp 2: the gradients of two dtypes
    averaged over buckets of one gradient each, a parameter broadcast
    from the group's first rank; and the worker queries."""
    from paddle_tpu_torch.distributed.fleet import hybrid_parallel_util as u

    fleet.init(is_collective=True, strategy=_strategy(dp=2), device="cpu")
    hcg = fleet.get_hybrid_communicate_group()
    r = dist.get_rank()
    params = [nn.Parameter(torch.full((5,), r + 1.0)),
              nn.Parameter(torch.full((3, 2), 10.0 * (r + 1),
                                      dtype=torch.float64)),
              nn.Parameter(torch.full((4,), r - 1.0))]
    for i, p in enumerate(params):
        p.grad = p.detach() * (i + 1)
    u.fused_allreduce_gradients_with_group(
        params, hcg.get_data_parallel_group(), bucket_bytes=8)
    layer = nn.Linear(2, 2)
    with torch.no_grad():
        layer.weight.fill_(r + 7.0)
    u.broadcast_dp_parameters(layer, hcg)
    return {"json": dict(
        grads=[p.grad.flatten().tolist() for p in params],
        weight=layer.weight.flatten().tolist(),
        worker=[fleet.worker_num(), fleet.worker_index(),
                fleet.is_first_worker()])}


# world size -> [(job, function)], run in this order on every rank
TOPOLOGIES = {"dp1mp2pp2": (1, 2, 2), "dp2mp1pp2": (2, 1, 2),
              "dp2mp2pp1": (2, 2, 1), "dp1mp1pp2": (1, 1, 2),
              "dp1mp2pp1": (1, 2, 1)}
JOBS = {
    2: [("mp_layers", job_mp_layers), ("pp_1f1b", _job_pp("1f1b")),
        ("pp_interleave", _job_pp("interleave")), ("pp_zb", _job_pp("zb")),
        ("gpt_pp2", _job_gpt(1)), ("util", job_util)]
    + [("topo_" + k, job_topology(_strategy(*v))) for k, v in
       TOPOLOGIES.items() if np.prod(v) == 2],
    4: [("tp_pp", job_tp_pp), ("gpt_dp2pp2", _job_gpt(2)),
        ("megatron", _job_megatron(False)),
        ("megatron_factored", _job_megatron(True))]
    + [("topo_" + k, job_topology(_strategy(*v))) for k, v in
       TOPOLOGIES.items() if np.prod(v) == 4],
}
# the file of weights and batch a job reads
DATA = {"pp_1f1b": "pp", "pp_zb": "pp", "pp_interleave": "pp_interleave",
        "gpt_pp2": "gpt", "gpt_dp2pp2": "gpt", "megatron": "megatron",
        "megatron_factored": "megatron", "tp_pp": "tp_pp",
        "mp_layers": "mp_layers"}


def run_world(out, world):
    """Every job of ``JOBS[world]`` on this rank (spawned, gloo)."""
    torch.set_num_threads(1)
    init_parallel_env("cpu")
    rank = dist.get_rank()
    for name, job in JOBS[world]:
        src = DATA.get(name)
        data = dict(np.load(os.path.join(out, src + ".npz"))) if src \
            else {}
        res = job(data)
        path = os.path.join(out, "%s_r%d" % (name, rank))
        if "json" in res:
            with open(path + ".json", "w") as f:
                json.dump(res["json"], f)
        else:
            np.savez(path + ".npz", **res)
        dist.barrier()
