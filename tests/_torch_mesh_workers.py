"""Rank code of ``tests/test_torch_mesh_training.py``.

Runs in the processes that ``paddle_tpu_torch.distributed.spawn``
starts (gloo, CPU), so it imports torch and the port only: no JAX, and
not the tests' conftest. :func:`run_ranks` trains every mesh of its
world size from the JAX model's weights and batch (``weights_*.npz``,
``batch.npz`` in ``out``) and checks the pieces of the sharded path on
inputs of its own; rank 0 writes what it gathered to ``out``.
"""
import json
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from paddle_tpu_torch.convert import (state_layout, gather_opt_state,
                                      gather_params, shard_opt_state,
                                      shard_params)
from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.distributed import (Partial, ProcessMesh, Replicate,
                                          Shard, init_parallel_env,
                                          reshard, shard_tensor,
                                          unshard_dtensor)
from paddle_tpu_torch.distributed.sharding import (Layout, copy_to,
                                                   vocab_parallel_embedding)
from paddle_tpu_torch.fusion import lm_head_chunked_ce
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_tiny, llama_tiny)
from paddle_tpu_torch.models.gpt import GPTAttention
from paddle_tpu_torch.observability import grad_health
from paddle_tpu_torch.optimizer import AdamW

# name: (mesh shape, axis names, fsdp axis)
MESHES = {"dp2mp2": ((2, 2), ("dp", "mp"), "dp"),
          "dp4": ((4,), ("dp",), "dp"),
          "mp2": ((2,), ("mp",), None)}
MODELS = ("gpt", "llama")
STEPS = 3
LR = 1e-3


def make_mesh(name):
    shape, names, _ = MESHES[name]
    return ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape), names)


def port_model(kind, weights=None, **config):
    """``gpt_tiny`` / ``llama_tiny`` with recompute and 4 CE chunks (and
    ``config``'s options), the JAX model's ``weights`` loaded."""
    if kind == "gpt":
        m = GPTForCausalLM(gpt_tiny(recompute=True, lm_ce_chunks=4,
                                    **config), device="cpu")
    else:
        m = LlamaForCausalLM(llama_tiny(recompute=True, lm_ce_chunks=4,
                                        **config), device="cpu")
    if weights is not None:
        m.load_state_dict({k: torch.from_numpy(v) for k, v in
                           weights.items()})
    return m


def optimizer():
    return AdamW(learning_rate=LR, weight_decay=0.01, factored_v=True,
                 moment_dtype="bfloat16")


def train(kind, weights, batch, mesh=None, fsdp=None, accumulate=1,
          chained=False):
    """STEPS steps (one call each, or one step and then ``run_steps``
    with ``chained``); returns (losses, model, step)."""
    m = port_model(kind, weights)
    step = TrainStep(m, optimizer(), mesh=mesh, fsdp_axis=fsdp,
                     grad_clip_norm=1.0, accumulate_steps=accumulate,
                     device="cpu", batch_specs=None if mesh is None
                     else [("dp", None), ("dp", None)])
    if chained:
        losses = [float(step(*batch)),
                  float(step.run_steps(STEPS - 1, *batch))]
    else:
        losses = [float(step(*batch)) for _ in range(STEPS)]
    return losses, m, step


def flat_state(state):
    out = {}
    for key in ("m", "vr", "vc"):
        for i, e in enumerate(state[key]):
            out["%s:%d" % (key, i)] = e
    return out


def key_third(name, v):
    """(the bias's key third, the rest) for GPT's qkv bias, else
    (None, v)."""
    if not name.endswith("attn.qkv_proj.bias"):
        return None, v
    h = v.shape[0] // 3
    return v[h:2 * h], np.delete(v, np.s_[h:2 * h])


def assert_run_close(got, want, names):
    """Losses, parameters, m, vr and vc of two runs within the bounds of
    ``tests/test_torch_mesh_training.py``'s note."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for i, name in enumerate(names):
        g_key, g = key_third(name, got[name])
        w_key, w = key_third(name, want[name])
        np.testing.assert_allclose(g, w, atol=5e-5, err_msg=name)
        if g_key is not None:
            np.testing.assert_allclose(g_key, w_key, atol=3 * LR,
                                       err_msg=name + " (key third)")
        gm, wm = key_third(name, got["m:%d" % i])[1], \
            key_third(name, want["m:%d" % i])[1]
        np.testing.assert_allclose(gm, wm, atol=2.0 ** -7 * np.abs(wm).max(),
                                   err_msg="m of " + name)
        for key in ("vr", "vc"):
            w = want["%s:%d" % (key, i)]
            if w.size:
                np.testing.assert_allclose(
                    got["%s:%d" % (key, i)], w, rtol=1e-4,
                    atol=1e-6 * np.abs(w).max(), err_msg=key + " " + name)


def save(out, name, **arrays):
    if dist.get_rank() == 0:
        np.savez(os.path.join(out, name + ".npz"), **arrays)


# ------------------------------------------------------------------ units
def _full(shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=dtype)


def unit_vocab_parallel(mesh):
    """The vocab-parallel embedding and CE on dp 2 x mp 2, the ignored
    labels all in dp rank 0's rows: loss, dx, dw against the plain ones
    on the whole batch."""
    B, S, H, V = 4, 6, 8, 20
    x = _full((B, S, H), 1)
    w = _full((V, H), 2)
    labels = torch.randint(0, V, (B, S), generator=torch.Generator()
                           .manual_seed(3))
    labels[0, :5] = -100
    labels[1, 1:4] = -100            # dp rank 0 holds rows 0-1
    ids = labels.clamp_min(0)
    mp, dp = mesh.group("mp"), mesh.group("dp")
    r = mesh.coord("dp")
    rows = slice(2 * r, 2 * r + 2)
    wl = Layout(mesh, (V, H), ("mp", None))
    xs = x[rows].clone().requires_grad_()
    ws = wl.local(w).requires_grad_()
    loss = lm_head_chunked_ce(copy_to(xs, mp), ws, labels[rows], 2,
                              transpose_weight=True, mp_group=mp,
                              batch_group=dp)
    loss.backward()
    emb = vocab_parallel_embedding(ids[rows], ws, mp)
    xf, wf = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = F.cross_entropy((xf @ wf.t()).reshape(-1, V), labels.reshape(-1))
    want.backward()
    dx = Layout(mesh, (B, S, H), ("dp", None, None)).gather(xs.grad)
    out = dict(loss=np.array([loss.item(), want.item()]),
               dx=dx.numpy(), dx_want=xf.grad.numpy(),
               emb=emb.detach().numpy(),
               emb_want=F.embedding(ids[rows], w).numpy())
    # dw: summed over dp by hand (the step's FSDP / dp reduction)
    dist.all_reduce(ws.grad, group=dp)
    out.update(dw=wl.gather(ws.grad).numpy(), dw_want=wf.grad.numpy())
    return out


def unit_qkv_and_bias(mesh):
    """GPT's attention on mp 2: each rank's qkv columns are its heads of
    each of q, k and v; the attention with its row-parallel out_proj
    (bias added once) equals the whole one."""
    cfg = gpt_tiny()
    torch.manual_seed(0)
    full = GPTAttention(cfg, device="cpu")
    with torch.no_grad():
        for p in full.parameters():
            p.copy_(_full(p.shape, 7 + p.numel() % 97) * 0.1)
    x = _full((2, 10, cfg.hidden_size), 5)
    want = full(x)
    local = GPTAttention(cfg, device="cpu")
    local.load_state_dict(full.state_dict())
    mp = mesh.group("mp")
    r, n = mesh.coord("mp"), mesh.get_dim_size("mp")
    h, heads, d = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    per = heads // n
    ok = True
    for name, p in local.named_parameters():
        lay = Layout(mesh, p.shape, p.dist_spec, p.dist_parts)
        with torch.no_grad():
            p.data = lay.local(p.data)
        if name == "qkv_proj.weight":
            ok &= torch.equal(p.reshape(h, 3, per, d), full.qkv_proj.weight
                              .reshape(h, 3, heads, d)[:, :, r * per:
                                                       (r + 1) * per])
    local.mp_group = local.out_proj.mp_group = mp
    got = local(x)
    return dict(qkv_heads=np.array(ok), attn=got.detach().numpy(),
                attn_want=want.detach().numpy(),
                bias=full.out_proj.bias.detach().numpy())


def unit_factored_and_norm(mesh):
    """AdamW's factored statistics on a matrix split on its rows (over
    dp) and on its columns (over mp), a replicated vector beside them,
    and the global grad norm counting the replicated vector once:
    against the whole matrices' update."""
    shapes = {"rows": ((8, 6), ("dp", None)), "cols": ((8, 6), (None, "mp")),
              "both": ((8, 6), ("dp", "mp")), "repl": ((6,), (None,))}
    params, grads, lays, full_p, full_g = [], [], [], [], []
    for i, (shape, spec) in enumerate(shapes.values()):
        p, g = _full(shape, 20 + i), _full(shape, 40 + i)
        lay = Layout(mesh, shape, spec)
        params.append(lay.local(p))
        grads.append(lay.local(g))
        lays.append(lay)
        full_p.append(p.clone())
        full_g.append(g.clone())
    opt = AdamW(learning_rate=0.1, factored_v=True)
    state = opt.init_state(params)
    shards = [(mesh.group_of(lay.spec[:1]), mesh.group_of(lay.spec[1:]))
              for lay in lays]
    groups = [mesh.group_of(lay.spec) for lay in lays]
    norm = grad_health(grads, groups)
    for _ in range(2):
        opt.update(params, grads, state, shards=shards)
    ref = AdamW(learning_rate=0.1, factored_v=True)
    rstate = ref.init_state(full_p)
    for _ in range(2):
        ref.update(full_p, full_g, rstate)
    out = dict(norm=np.array([norm.item(), grad_health(full_g).item()]))
    for i, (name, lay) in enumerate(zip(shapes, lays)):
        out["p_" + name] = lay.gather(params[i]).numpy()
        out["p_want_" + name] = full_p[i].numpy()
        if lay.spec and len(lay.shape) == 2:
            out["vr_" + name] = lay.rows().gather(state["vr"][i]).numpy()
            out["vc_" + name] = lay.cols().gather(state["vc"][i]).numpy()
            out["vr_want_" + name] = rstate["vr"][i].numpy()
            out["vc_want_" + name] = rstate["vc"][i].numpy()
    return out


def unit_semi_auto(mesh):
    """shard_tensor / unshard_dtensor / reshard, a Partial tensor among
    them."""
    full = _full((4, 6), 9)
    t = shard_tensor(full, mesh, [Shard(0), Shard(1)])
    back = unshard_dtensor(t)
    moved = unshard_dtensor(reshard(t, mesh, [Replicate(), Shard(0)]))
    part = reshard(t, mesh, [Partial(), Replicate()])
    summed = unshard_dtensor(part)
    return dict(semi=np.stack([back.numpy(), moved.numpy(),
                               summed.numpy(), full.numpy()]),
                local_shape=np.array(t.shape))


def unit_collectives():
    """The Paddle-style collectives on the 4 ranks: each rank's result
    (rank 0's written; the test checks them against arithmetic)."""
    r = dist.get_rank()
    t = collective.all_reduce(torch.full((2,), float(r)))
    top = collective.all_reduce(torch.tensor([float(r)]), op="max")
    got = collective.all_gather([], torch.tensor([float(r)]))
    b = collective.broadcast(torch.tensor([float(r)]), 2)
    out = collective.reduce_scatter(torch.empty(2), [
        torch.full((2,), float(10 * r + i)) for i in range(4)])
    collective.barrier()
    return dict(coll=np.concatenate([t, top, torch.cat(got), b, out]))


def unit_convert(mesh, weights):
    """The JAX weights sliced into this rank's pieces (shard_params) and
    gathered back (gather_params), bitwise; the optimizer state too."""
    m = port_model("gpt")
    step = TrainStep(m, optimizer(), mesh=mesh, fsdp_axis="dp",
                     device="cpu")
    m.load_state_dict(shard_params(weights, m))
    back = gather_params(m)
    same = all(np.array_equal(back[k], weights[k]) for k in weights)
    full_state = {"t": np.float32(2.0)}
    rng = np.random.RandomState(0)
    for key in ("m", "v", "vr", "vc"):
        full_state[key] = []
        for p, e in zip(step._params, step.opt_state[key]):
            lay = state_layout(key, p, e)
            full_state[key].append(rng.randn(*(
                lay.shape if lay is not None else e.shape)).astype(
                np.float32))
    step.restore_state(shard_opt_state(full_state, step))
    got = gather_opt_state(step)
    for key in ("v", "vr", "vc"):
        same &= all(np.array_equal(a, b) for a, b in zip(got[key],
                                                          full_state[key]))
    # m is bf16 in the step: the round trip is the bf16 rounding
    same &= all(np.array_equal(a, torch.from_numpy(b).bfloat16().float()
                               .numpy()) for a, b in zip(got["m"],
                                                         full_state["m"]))
    try:
        step.run_steps_stream(1, *(np.stack([a]) for a in (
            np.zeros((4, 8), np.int64),) * 2))
        raised = False
    except NotImplementedError as e:
        raised = "ROADMAP.md" in str(e)
    return dict(convert_round_trip=np.array(same),
                stream_raises=np.array(raised))


# ------------------------------------------------------------------- main
def run_ranks(out, world):
    torch.set_num_threads(1)
    init_parallel_env("cpu")
    batch = tuple(np.load(os.path.join(out, "batch.npz"))[k]
                  for k in ("ids", "labels"))
    weights = {k: dict(np.load(os.path.join(out, "weights_%s.npz" % k)))
               for k in MODELS}
    for name, (shape, _, fsdp) in MESHES.items():
        if int(np.prod(shape)) != world:
            continue
        for kind in MODELS:
            losses, m, step = train(kind, weights[kind], batch,
                                    make_mesh(name), fsdp)
            save(out, "%s_%s" % (name, kind), losses=np.array(losses),
                  **gather_params(m), **flat_state(gather_opt_state(step)))
    if world == 4:
        mesh = make_mesh("dp2mp2")
        for kind in MODELS:
            # run_steps and gradient merge on the mesh
            losses, m, _ = train(kind, weights[kind], batch, mesh, "dp",
                                 chained=True)
            save(out, "chained_%s" % kind, losses=np.array(losses),
                  **gather_params(m))
            losses, m, _ = train(kind, weights[kind], batch, mesh, "dp",
                                 accumulate=2)
            save(out, "accumulate_%s" % kind, losses=np.array(losses),
                  **gather_params(m))
        units = {}
        for fn in (unit_vocab_parallel, unit_factored_and_norm,
                   unit_semi_auto):
            units.update(fn(mesh))
        units.update(unit_convert(mesh, weights["gpt"]))
        units.update(unit_collectives())
        save(out, "units4", **units)
    if world == 2:
        save(out, "units2", **unit_qkv_and_bias(make_mesh("mp2")))
    if dist.get_rank() == 0:
        with open(os.path.join(out, "done_%d.json" % world), "w") as f:
            json.dump({"world": world}, f)


# ----------------------------------------------------------- on two cards
def cuda_mp2(out):
    """The 2-layer f32 GPT at GPT-3 1.3B's width, 3 steps on an mp 2
    mesh of two cards (NCCL; K1 / K2 on each rank's 8 heads) against the
    same steps on one card (rank 0 alone, first)."""
    import dataclasses

    from paddle_tpu_torch.incubate.nn.cuda import flash_attn as fa
    from paddle_tpu_torch.models import gpt3_1p3B

    torch.backends.cuda.matmul.allow_tf32 = False
    init_parallel_env()
    cfg = dataclasses.replace(gpt3_1p3B(recompute=True, lm_ce_chunks=4),
                              num_layers=2)
    # a new batch a step: on one batch repeated the model learns it in
    # two steps, and the small losses' relative difference reads rounding
    rng = np.random.RandomState(0)
    batches = [tuple(rng.randint(0, cfg.vocab_size, (2, 256))
                     for _ in range(2)) for _ in range(STEPS)]

    def model():
        return GPTForCausalLM(cfg, generator=torch.Generator(
            device="cuda").manual_seed(0))

    def opt():
        return AdamW(learning_rate=1e-4, weight_decay=0.01, factored_v=True)

    saved = {}
    if dist.get_rank() == 0:
        m = model()
        step = TrainStep(m, opt(), grad_clip_norm=1.0)
        saved["ref_losses"] = np.array([float(step(*b)) for b in batches])
        saved.update({"ref:" + k: v.detach().cpu().numpy()
                      for k, v in m.named_parameters()})
        del m, step
    dist.barrier()
    m = model()
    step = TrainStep(m, opt(), mesh=ProcessMesh([0, 1], ["mp"]),
                     grad_clip_norm=1.0)
    fa.flash_fwd.launches = fa.flash_bwd_fused.launches = 0
    saved["losses"] = np.array([float(step(*b)) for b in batches])
    saved["launches"] = np.array([fa.flash_fwd.launches,
                                  fa.flash_bwd_fused.launches])
    saved.update(gather_params(m))
    save(out, "cuda_mp2", **saved)
