"""Model wrappers of a hybrid-parallel run and the pipeline engine.

Port of ``paddle_tpu/distributed/fleet/meta_parallel.py``, one process
a rank over ``torch.distributed`` (NCCL on cards, gloo on the CPU):

- :class:`TensorParallel`: broadcasts the parameters the model-parallel
  ranks share (and the data-parallel replicas') from the group's first
  rank; :class:`ShardingParallel` broadcasts the parameters over the
  sharding group.
- :class:`LayerDesc` / :class:`SharedLayerDesc` and
  :class:`PipelineLayer`: a sequential model cut into stages, uniformly
  by layer count over ``num_stages x num_virtual_pipeline_stages``
  virtual stages; this rank builds only the layers of its stage (with
  virtual stages, of ``stage_id + k * num_stages`` for each k), and with
  ``recompute_interval = k > 0`` every k-th of them runs under
  :func:`.recompute.recompute` in training.
- :class:`PipelineParallel`: 1F1B over micro-batches (warm-up, steady
  phase, cool-down). A channel (peer, tag) exchanges its shape and dtype
  once through the default group's store; every transfer after that is
  a bare tensor. Every point-to-point operation goes through
  ``batch_isend_irecv``; in the steady phase each send is paired with
  the receive that follows it in one call, so both ends of a link post
  the same operations in the same order (solitary sends in 1F1B's
  opposite orders would deadlock NCCL, as they deadlock the XLA queues
  of the JAX package). Losses are divided by the micro-batch count and
  only the last stage returns the step's loss. A stage input that got no
  gradient sends zeros upstream.
- :class:`PipelineParallelWithInterleave`: the Megatron interleaved
  order over ``v`` chunks a rank, activations flowing around the ring of
  stages. Its per-link operation order differs between the two ends, so
  each direction of a link has a process group of its own (a FIFO, as
  the JAX package's buffered transport is) and sends are left in flight
  until the step's end.
- :class:`PipelineParallelZeroBubble` (ZB-H1): each backward split into
  B (the input's gradient, shipped upstream at once) and a deferred W
  (the weights' gradients): two ``torch.autograd.grad`` walks over a
  graph the first retains.

Gradients: the engine takes them with ``torch.autograd.grad`` and adds
them into an f32 ``p.main_grad`` a parameter (the mesh ``TrainStep``'s
f32 accumulation: a bf16 ``.grad`` summed in place over the micro-batches
would round away low-order bits); the eager optimizers, the clip and the
data-parallel all-reduce read it (``optimizer.optimizers.grad_of``).
``train_batch`` averages them over ``dp``, steps the optimizer and
clears them.
"""
from __future__ import annotations

import pickle
from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..collective import P2POp, batch_isend_irecv, irecv, isend, new_group
from .distributed_strategy import unported
from .hybrid_parallel_util import (_broadcast_parameters,
                                   fused_allreduce_gradients)

__all__ = ["TensorParallel", "ShardingParallel", "LayerDesc",
           "SharedLayerDesc",
           "PipelineLayer", "PipelineParallel",
           "PipelineParallelWithInterleave", "PipelineParallelZeroBubble"]


class _MetaParallelBase(nn.Module):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        self._prepare_for_model()

    def _prepare_for_model(self):
        pass

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    load_state_dict = set_state_dict

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True):
        return self._layers.named_parameters(prefix, recurse,
                                             remove_duplicate)


class TensorParallel(_MetaParallelBase):
    """The model of an mp run: its shared parameters broadcast over mp
    (the mp-split ones stay each rank's own) and over dp."""

    def _prepare_for_model(self):
        hcg = self._hcg
        _broadcast_parameters(self._layers, hcg.get_model_parallel_group(),
                              hcg.get_model_parallel_group_src_rank(), True)
        _broadcast_parameters(self._layers, hcg.get_data_parallel_group(),
                              hcg.get_data_parallel_group_src_rank(), False)


class ShardingParallel(_MetaParallelBase):
    """The model of a group-sharding run: its parameters broadcast over
    the sharding group from the group's first rank."""

    def _prepare_for_model(self):
        hcg = self._hcg
        _broadcast_parameters(self._layers, hcg.get_sharding_parallel_group(),
                              hcg.get_sharding_parallel_group_src_rank(),
                              False)


class LayerDesc:
    """A layer to build later, on the stage that holds it."""

    def __init__(self, layer_cls, *inputs, **kwargs):
        self.layer_cls = layer_cls
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.inputs, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_cls, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(nn.Module):
    """This rank's stage of a sequential model: ``layers`` (LayerDescs
    or modules) cut uniformly by count over the virtual stages, the
    first ``n % (stages x v)`` virtual stages one layer longer.
    ``run_function`` holds the built layers in order; ``layer_indices``
    their indices in ``layers``."""

    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        from .fleet import get_hybrid_communicate_group

        if seg_method != "uniform":
            raise unported("seg_method=%r (uniform only)" % (seg_method,))
        hcg = get_hybrid_communicate_group()
        self._loss_fn = loss_fn
        self._num_stages = num_stages or (
            hcg.get_pipe_parallel_world_size() if hcg else 1)
        self._stage_id = hcg.get_stage_id() if hcg else 0
        self._recompute_interval = recompute_interval
        self._num_virtual = num_virtual_pipeline_stages or 1
        self.descs = list(layers)
        n = len(self.descs)
        total = self._num_stages * self._num_virtual
        per = [n // total + (i < n % total) for i in range(total)]
        starts = [0]
        for k in per:
            starts.append(starts[-1] + k)
        self.segment_parts = starts
        built, self.layer_indices, self._chunk_bounds = [], [], []
        for k in range(self._num_virtual):
            vs = self._stage_id + k * self._num_stages
            first = len(built)
            for i in range(starts[vs], starts[vs + 1]):
                d = self.descs[i]
                built.append(d.build_layer() if isinstance(d, LayerDesc)
                             else d)
                self.layer_indices.append(i)
            self._chunk_bounds.append((first, len(built)))
        self.run_function = nn.ModuleList(built)

    def get_num_virtual_stages(self):
        return self._num_virtual

    def get_stage_from_index(self, layer_idx):
        for vs in range(self._num_stages * self._num_virtual):
            if self.segment_parts[vs] <= layer_idx \
                    < self.segment_parts[vs + 1]:
                return vs % self._num_stages
        return self._num_stages - 1

    def _run(self, x, start, end):
        from .recompute import recompute

        k = self._recompute_interval
        for i in range(start, end):
            layer = self.run_function[i]
            if k > 0 and i % k == 0 and self.training:
                x = recompute(layer, x)
            else:
                x = layer(x)
        return x

    def forward_chunk(self, x, chunk_id: int):
        return self._run(x, *self._chunk_bounds[chunk_id])

    def forward(self, x):
        if self._num_virtual > 1:
            raise RuntimeError(
                "PipelineLayer with num_virtual_pipeline_stages>1 holds "
                "non-contiguous chunks; drive it with "
                "PipelineParallelWithInterleave (forward_chunk), not the "
                "flat forward")
        return self._run(x, 0, len(self.run_function))


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.rsplit(".", 1)[-1])


class PipelineParallel(_MetaParallelBase):
    """1F1B over ``pipeline_configs["accumulate_steps"]`` micro-batches
    (the batch cut along dim 0)."""

    _instances = 0

    def __init__(self, layers, hcg, strategy=None):
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel expects a PipelineLayer")
        if type(self) is PipelineParallel \
                and layers.get_num_virtual_stages() > 1:
            raise ValueError(
                "layers were built with num_virtual_pipeline_stages>1; "
                "use PipelineParallelWithInterleave")
        super().__init__(layers, hcg, strategy)
        self.num_stages = hcg.get_pipe_parallel_world_size()
        self.stage_id = hcg.get_stage_id()
        self.pp_group = hcg.get_pipe_parallel_group()
        self.prev_rank = hcg.get_p2p_prev_rank()
        self.next_rank = hcg.get_p2p_next_rank()
        self.is_first = hcg.is_first_stage()
        self.is_last = hcg.is_last_stage()
        self.global_rank = hcg.get_global_rank()
        cfg = strategy.pipeline_configs if strategy is not None else {}
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
        self._params = [p for p in layers.parameters() if p.requires_grad]
        first = next(layers.parameters(), None)
        self._device = first.device if first is not None else \
            torch.device("cpu")
        # channel meta of (peer, tag), exchanged once through the store
        self._send_meta_known = {}
        self._recv_meta = {}
        # the construction count scopes the store keys: a second pipeline
        # over the same ranks does not read the first one's meta (every
        # rank builds its pipelines in the same order)
        PipelineParallel._instances += 1
        self._meta_nonce = PipelineParallel._instances
        self.p2p_bytes = 0          # bytes this rank has sent
        if self.pp_group is not None:
            # the group's communicator made now, by every member at once
            dist.all_reduce(torch.zeros(1, device=self._device),
                            group=self.pp_group)

    def _prepare_for_model(self):
        hcg = self._hcg
        _broadcast_parameters(self._layers, hcg.get_data_parallel_group(),
                              hcg.get_data_parallel_group_src_rank(), False)

    # ---------------------------------------------------------------- p2p
    def _meta_key(self, src, dst, tag):
        return "ppmeta/i%d/%d->%d/%s" % (self._meta_nonce, src, dst, tag)

    def _ensure_send_meta(self, t: torch.Tensor, peer, tag: str):
        cur = (tuple(t.shape), str(t.dtype))
        known = self._send_meta_known.get((peer, tag))
        if known is None:
            dist.distributed_c10d._get_default_store().set(
                self._meta_key(self.global_rank, peer, tag),
                pickle.dumps(cur))
            self._send_meta_known[(peer, tag)] = cur
        elif known != cur:
            raise ValueError(
                "pipeline p2p channel (%s, %r) was established with meta "
                "%s but is now asked to carry %s; use a distinct tag per "
                "boundary shape" % (peer, tag, known, cur))

    def _recv_buffer(self, peer, tag: str) -> torch.Tensor:
        """An empty tensor of the channel's shape and dtype (the first
        call waits for the sender's meta)."""
        if (peer, tag) not in self._recv_meta:
            self._recv_meta[(peer, tag)] = pickle.loads(
                dist.distributed_c10d._get_default_store().get(
                    self._meta_key(peer, self.global_rank, tag)))
        shape, dtype = self._recv_meta[(peer, tag)]
        return torch.empty(shape, dtype=_dtype(dtype), device=self._device)

    def _p2p(self, send=None, recv=None, group=None):
        """Post ``send = (tensor, peer, tag)`` and ``recv = (peer, tag)``
        in one ``batch_isend_irecv`` and wait; returns the received
        tensor (a leaf that requires grad) or None."""
        group = self.pp_group if group is None else group
        ops, buf = [], None
        if send is not None:
            t, peer, tag = send
            t = t.detach().contiguous()
            self._ensure_send_meta(t, peer, tag)
            ops.append(P2POp(isend, t, peer, group))
            self.p2p_bytes += t.numel() * t.element_size()
        if recv is not None:
            buf = self._recv_buffer(*recv)
            ops.append(P2POp(irecv, buf, recv[0], group))
        for work in batch_isend_irecv(ops):
            work.wait()
        return None if buf is None else buf.requires_grad_()

    def _send_tensor(self, t, dst, tag="fwd"):
        self._p2p(send=(t, dst, tag))

    def _recv_tensor(self, src, tag="fwd"):
        return self._p2p(recv=(src, tag))

    def _sendrecv_tensor(self, t, peer, send_tag, recv_tag):
        return self._p2p(send=(t, peer, send_tag), recv=(peer, recv_tag))

    # ---------------------------------------------------------- compute
    def _loss_of(self, out, label, num_micro, scaler):
        if scaler is not None:
            raise unported("a grad scaler (fleet amp)")
        loss_fn = self._layers._loss_fn
        if loss_fn is not None and label is not None:
            out = loss_fn(out, label)
        return out / num_micro

    def _compute_fwd(self, i, x, micro_inputs, losses, scaler, num_micro):
        out = self._layers.forward(x)
        if self.is_last:
            out = self._loss_of(out, micro_inputs[i][1], num_micro, scaler)
            losses.append(out)
        return out

    def _first_input(self, i, micro_inputs):
        return micro_inputs[i][0]

    @staticmethod
    @torch.no_grad()
    def _accumulate(params, grads):
        """Add ``grads`` into the parameters' f32 ``main_grad``."""
        for p, g in zip(params, grads):
            if g is None:
                continue
            if getattr(p, "main_grad", None) is None:
                p.main_grad = g.to(torch.float32, copy=True)
            else:
                p.main_grad.add_(g)

    def _backward(self, out, x, grad, params=None, retain=False):
        """d ``out`` (times ``grad``) by the stage input ``x`` (when it
        takes a gradient) and ``params``; the parameters' part added to
        their ``main_grad``. Returns the input's gradient (zeros where
        the input got none), or None."""
        params = self._params if params is None else params
        wants_x = x is not None and x.requires_grad
        grads = torch.autograd.grad(
            [out], ([x] if wants_x else []) + params,
            None if grad is None else [grad], retain_graph=retain,
            allow_unused=True)
        self._accumulate(params, grads[1:] if wants_x else grads)
        if not wants_x:
            return None
        return grads[0] if grads[0] is not None else torch.zeros_like(x)

    @staticmethod
    def _sum_losses(losses):
        if not losses:
            return None
        total = losses[0].detach()
        for loss in losses[1:]:
            total = total + loss.detach()
        return total

    # ---------------------------------------------------------- schedule
    def _run_1f1b(self, micro_inputs, fwd, bwd, post_slot=None):
        """Warm-up, steady phase and cool-down of the 1F1B family:
        ``fwd(i, x) -> out`` and ``bwd(i, grad) -> upstream grad or
        None`` compute; ``post_slot(n_bwd_done)`` runs after each steady
        slot (zero-bubble's deferred W)."""
        num_micro = self.accumulate_steps
        num_warmup = min(self.num_stages - self.stage_id - 1, num_micro)
        num_steady = num_micro - num_warmup

        fwd_i = bwd_i = 0
        for _ in range(num_warmup):
            x = self._first_input(fwd_i, micro_inputs) if self.is_first \
                else self._recv_tensor(self.prev_rank, "fwd")
            out = fwd(fwd_i, x)
            if not self.is_last:
                self._send_tensor(out, self.next_rank, "fwd")
            fwd_i += 1

        x = None
        if num_steady > 0:
            x = self._first_input(fwd_i, micro_inputs) if self.is_first \
                else self._recv_tensor(self.prev_rank, "fwd")
        for k in range(num_steady):
            out = fwd(fwd_i, x)
            fwd_i += 1
            grad = None if self.is_last else self._sendrecv_tensor(
                out, self.next_rank, "fwd", "bwd")
            gx = bwd(bwd_i, grad)
            bwd_i += 1
            last_iter = k == num_steady - 1
            if self.is_first:
                x = None if last_iter \
                    else self._first_input(fwd_i, micro_inputs)
            elif last_iter:
                self._send_tensor(gx, self.prev_rank, "bwd")
            else:
                x = self._sendrecv_tensor(gx, self.prev_rank, "bwd", "fwd")
            if post_slot is not None:
                post_slot(bwd_i)
        while bwd_i < num_micro:
            grad = None if self.is_last else \
                self._recv_tensor(self.next_rank, "bwd")
            gx = bwd(bwd_i, grad)
            bwd_i += 1
            if gx is not None:
                self._send_tensor(gx, self.prev_rank, "bwd")

    def forward_backward_pipeline(self, data, scaler=None):
        """One 1F1B pass over the micro-batches of ``data``; the
        gradients land in ``main_grad``. Returns the loss on the last
        stage, else None."""
        num_micro = self.accumulate_steps
        micro_inputs = self._split_micro(data, num_micro)
        inputs: List[Optional[torch.Tensor]] = []
        outputs: List[Optional[torch.Tensor]] = []
        losses = []

        def fwd(i, x):
            out = self._compute_fwd(i, x, micro_inputs, losses, scaler,
                                    num_micro)
            inputs.append(x)
            outputs.append(out)
            return out

        def bwd(i, grad):
            gx = self._backward(outputs[i], inputs[i], grad)
            outputs[i] = inputs[i] = None   # live activations: the window
            return gx

        self._run_1f1b(micro_inputs, fwd, bwd)
        return self._sum_losses(losses)

    def _split_micro(self, data, num_micro):
        """``[(input, label)]`` a micro-batch, each cut along dim 0 on
        the stage's device (numpy arrays or tensors)."""
        def cut(a):
            if a is None:
                return [None] * num_micro
            t = torch.as_tensor(a).to(self._device)
            if t.shape[0] % num_micro:
                raise ValueError("batch dim %d does not split into %d "
                                 "micro-batches" % (t.shape[0], num_micro))
            return list(t.chunk(num_micro))
        if isinstance(data, (tuple, list)):
            return list(zip(cut(data[0]),
                            cut(data[1] if len(data) > 1 else None)))
        return list(zip(cut(data), cut(None)))

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One optimizer step on ``data`` (``(inputs, labels)``, the
        whole batch of this data-parallel replica): the pipeline pass,
        the gradients averaged over ``dp``, ``optimizer.step()`` and
        ``clear_grad()``. Returns the loss on the last stage, else
        None."""
        self._layers.train()
        loss = self.forward_backward_pipeline(data, scaler)
        fused_allreduce_gradients(self._params, self._hcg)
        optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        """The forward of every micro-batch through the stages; the
        last stage returns the loss."""
        self._layers.eval()
        num_micro = self.accumulate_steps
        micro_inputs = self._split_micro(data, num_micro)
        losses = []
        for i in range(num_micro):
            x = self._first_input(i, micro_inputs) if self.is_first \
                else self._recv_tensor(self.prev_rank, "fwd")
            out = self._compute_fwd(i, x, micro_inputs, losses, None,
                                    num_micro)
            if not self.is_last:
                self._send_tensor(out, self.next_rank, "fwd")
        return self._sum_losses(losses)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)


class PipelineParallelWithInterleave(PipelineParallel):
    """Interleaved 1F1B (virtual pipeline stages): ``v`` chunks a rank,
    virtual stage ``chunk * p + stage``; activations go rank r -> r + 1
    around the ring, gradients back. The iteration order is Megatron's
    and the same on every rank."""

    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers, hcg, strategy)
        self.num_chunks = layers.get_num_virtual_stages()
        if self.num_stages < 2:
            raise ValueError("the interleaved schedule passes activations "
                             "around a ring of stages: it needs pp >= 2")
        if self.accumulate_steps % self.num_stages != 0:
            raise ValueError(
                "interleaved schedule needs accumulate_steps divisible by "
                "pp degree (%d %% %d)" % (self.accumulate_steps,
                                          self.num_stages))
        ranks = hcg._pp_group           # this rank's stages, in order
        p = len(ranks)
        self._ring_next = ranks[(self.stage_id + 1) % p]
        self._ring_prev = ranks[(self.stage_id - 1) % p]
        # a group a direction of every ring link, made by every rank in
        # the same order; this rank keeps those of its two out-links'
        # and in-links' directions
        self._edge = {}
        for line in hcg.topology().get_comm_list("pipe"):
            for s in range(p):
                src, dst = line[s], line[(s + 1) % p]
                for link in ((src, dst), (dst, src)):
                    if link in self._edge:
                        continue
                    group = new_group(sorted(link))
                    self._edge[link] = group \
                        if self.global_rank in link else None
        self._pending = []

    def _virt(self, k):
        """iteration index -> (chunk_id, microbatch_id); Megatron
        order."""
        p, v = self.num_stages, self.num_chunks
        return (k // p) % v, (k // (p * v)) * p + k % p

    def _send_async(self, t, dst, tag):
        """Start sending ``t`` on the link's direction group; the send
        completes when the peer receives, waited at the step's end."""
        t = t.detach().contiguous()
        self._ensure_send_meta(t, dst, tag)
        self.p2p_bytes += t.numel() * t.element_size()
        group = self._edge[(self.global_rank, dst)]
        self._pending += batch_isend_irecv([P2POp(isend, t, dst, group)])

    def _recv_from(self, src, tag):
        buf = self._recv_buffer(src, tag)
        group = self._edge[(src, self.global_rank)]
        for work in batch_isend_irecv([P2POp(irecv, buf, src, group)]):
            work.wait()
        return buf.requires_grad_()

    def forward_backward_pipeline(self, data, scaler=None):
        p, v = self.num_stages, self.num_chunks
        num_micro = self.accumulate_steps
        total = num_micro * v
        micro_inputs = self._split_micro(data, num_micro)
        inputs = [[None] * num_micro for _ in range(v)]
        outputs = [[None] * num_micro for _ in range(v)]
        chunk_params = [[q for q in self._layers.run_function[a:b]
                         .parameters() if q.requires_grad]
                        for a, b in self._layers._chunk_bounds]
        losses = []

        def is_first_vs(chunk):
            return chunk == 0 and self.stage_id == 0

        def is_last_vs(chunk):
            return chunk == v - 1 and self.stage_id == p - 1

        def fwd_step(k):
            chunk, micro = self._virt(k)
            vs = chunk * p + self.stage_id
            if is_first_vs(chunk):
                x = micro_inputs[micro][0]
            else:
                # the channel of the virtual edge vs - 1 -> vs
                x = self._recv_from(self._ring_prev, "fwd%d" % (vs - 1))
            out = self._layers.forward_chunk(x, chunk)
            if is_last_vs(chunk):
                out = self._loss_of(out, micro_inputs[micro][1], num_micro,
                                    scaler)
                losses.append(out)
            else:
                self._send_async(out, self._ring_next, "fwd%d" % vs)
            inputs[chunk][micro] = x
            outputs[chunk][micro] = out

        def bwd_step(k):
            chunk, micro = self._virt(k)
            chunk = v - 1 - chunk
            vs = chunk * p + self.stage_id
            grad = None if is_last_vs(chunk) else self._recv_from(
                self._ring_next, "bwd%d" % (vs + 1))
            gx = self._backward(outputs[chunk][micro], inputs[chunk][micro],
                                grad, chunk_params[chunk])
            outputs[chunk][micro] = inputs[chunk][micro] = None
            if not is_first_vs(chunk):
                self._send_async(gx, self._ring_prev, "bwd%d" % vs)

        warmup = min((p - self.stage_id - 1) * 2 + (v - 1) * p, total)
        fwd_k = bwd_k = 0
        for _ in range(warmup):
            fwd_step(fwd_k)
            fwd_k += 1
        for _ in range(total - warmup):
            fwd_step(fwd_k)
            fwd_k += 1
            bwd_step(bwd_k)
            bwd_k += 1
        while bwd_k < total:
            bwd_step(bwd_k)
            bwd_k += 1
        for work in self._pending:
            work.wait()
        self._pending = []
        return self._sum_losses(losses)


class PipelineParallelZeroBubble(PipelineParallel):
    """Zero-bubble 1F1B (ZB-H1): a micro-batch's backward is B, the
    stage input's gradient (what the stage before waits on, sent at
    once), then later W, the weights' gradients, deferred by up to
    ``num_stages - stage_id`` slots and into the cool-down."""

    def forward_backward_pipeline(self, data, scaler=None):
        num_micro = self.accumulate_steps
        micro_inputs = self._split_micro(data, num_micro)
        inputs: List[Optional[torch.Tensor]] = []
        outputs: List[Optional[torch.Tensor]] = []
        pending_w = []      # (out, grad) a micro-batch, graph retained
        losses = []

        def fwd(i, x):
            out = self._compute_fwd(i, x, micro_inputs, losses, scaler,
                                    num_micro)
            inputs.append(x)
            outputs.append(out)
            return out

        def b_walk(i, grad):
            """B: the input's gradient alone, the graph kept for W."""
            out, x = outputs[i], inputs[i]
            gx = None
            if x is not None and x.requires_grad:
                (gx,) = torch.autograd.grad(
                    [out], [x], None if grad is None else [grad],
                    retain_graph=True, allow_unused=True)
                if gx is None:
                    gx = torch.zeros_like(x)
            pending_w.append((out, grad))
            outputs[i] = inputs[i] = None
            return gx

        def w_step(i):
            """W: the weights' gradients of micro-batch i, into
            main_grad; frees its graph."""
            out, grad = pending_w[i]
            grads = torch.autograd.grad(
                [out], self._params, None if grad is None else [grad],
                allow_unused=True)
            self._accumulate(self._params, grads)
            pending_w[i] = None

        w_done = [0]

        def post_slot(b_done):
            # ZB-H1: one deferred W a steady slot keeps memory flat
            if b_done - w_done[0] > self.num_stages - self.stage_id:
                w_step(w_done[0])
                w_done[0] += 1

        self._run_1f1b(micro_inputs, fwd, b_walk, post_slot=post_slot)
        while w_done[0] < num_micro:        # W fills the cool-down bubble
            w_step(w_done[0])
            w_done[0] += 1
        return self._sum_losses(losses)
