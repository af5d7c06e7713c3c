"""ServingEngine: continuous-batching inference over paged KV pools.

Port of ``paddle_tpu/serving/engine.py`` in both of its layouts. The
engine owns the physical KV pools (per layer, ``[n_kv, num_blocks,
block_size, head_dim]`` in the model's dtype, or with ``kv_quant="int8"``
int8 ``{"q8", "s"}`` pools of that shape with one f32 scale per row, on
the model's device), a
:class:`BlockManager` for the page index space and a :class:`Scheduler`
for slots. In the default ragged layout (``ragged="auto"`` or ``"on"``)
each :meth:`ServingEngine.step` runs ONE ragged step whose flat
``[token_budget]`` token axis packs every RUNNING slot's decode token
next to as many prefill-chunk tokens as fit, so mixed prefill + decode
traffic costs one step per scheduler tick. Rows join and leave by mask
(``query_lens == 0`` = idle slot, position ``-1`` = padding). On the
card every layer's attention is one launch of a Hopper ragged
paged-attention kernel (K4 over fp pools, K5 over int8 pools). The
two-program layout (``ragged="off"``) runs up to two steps a tick, in
the JAX engine's order: one ``[1, prefill_chunk]`` chunk of the oldest
prefilling request, then one ``[max_slots, 1]`` decode batch; on the
card each layer's attention in either is one launch of the Hopper
paged-decode kernel K6 (over fp or int8 pools).

Requests stream tokens through per-request queues:
``rid = engine.submit(prompt)``, ``for tok in engine.stream(rid)``.
``engine.start()`` runs the step loop on a background thread; tests may
instead call ``engine.step()`` directly for determinism.

Not ported yet (ROADMAP.md): disaggregated handoff, the cluster KV
hooks, the retry / fault-injection machinery around the step, and the
observability spans and request log.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import knobs as _knobs
from ..device import DeviceLike, resolve_device
from ..incubate.nn.cuda.paged_attention import quantize_kv_pages
from ..models.generation import _sample
from .block_manager import BlockManager
from .scheduler import (CANCELLED, FINISHED, PREFILL, RUNNING,
                        PrefillChunk, Request, Scheduler)

__all__ = ["ServingEngine", "RequestError", "EngineConfig",
           "RequestDescriptor", "EngineStats"]


@dataclasses.dataclass(frozen=True)
class RequestDescriptor:
    """Replayable snapshot of one in-flight request. Greedy decoding is
    deterministic, so ``prompt + generated`` resubmitted with
    ``remaining`` new tokens on an engine holding the same weights
    continues the same stream."""
    rid: int
    prompt: Tuple[int, ...]
    generated: Tuple[int, ...]
    remaining: int
    temperature: float
    top_p: float
    eos_id: Optional[int]
    deadline: Optional[float]          # absolute time.monotonic()
    state: str


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """Lock-held health snapshot (see :meth:`ServingEngine.stats`)."""
    free_blocks: int
    total_blocks: int
    watermark_blocks: int
    block_size: int
    queue_depth: int                   # waiting for a slot
    prefilling: int
    running: int
    active_slots: int
    max_slots: int
    ragged_steps: int
    inflight: Tuple[RequestDescriptor, ...]

    def can_admit(self, n_blocks: int) -> bool:
        """Mirror of ``BlockManager.can_allocate`` over the snapshot."""
        return self.free_blocks - self.watermark_blocks >= n_blocks


class RequestError(RuntimeError):
    """A stream ended abnormally (cancelled / deadline / shutdown)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class EngineConfig:
    """Resolved engine knobs (ctor args win over env vars)."""

    def __init__(self, max_slots=None, block_size=None, num_blocks=None,
                 prefill_chunk=None, max_seq_len=None, kv_quant=None,
                 watermark=0.01, enable_prefix_cache=True, seed=0,
                 ragged=None, token_budget=None):
        self.max_slots = max_slots or _knobs.get_int(
            "PADDLE_TPU_SERVE_SLOTS")
        self.block_size = block_size or _knobs.get_int(
            "PADDLE_TPU_SERVE_BLOCK_SIZE")
        self.num_blocks = num_blocks or _knobs.get_int(
            "PADDLE_TPU_SERVE_NUM_BLOCKS")
        self.prefill_chunk = prefill_chunk or _knobs.get_int(
            "PADDLE_TPU_SERVE_PREFILL_CHUNK")
        self.max_seq_len = max_seq_len
        self.kv_quant = kv_quant        # None | "int8"
        self.watermark = watermark
        self.enable_prefix_cache = enable_prefix_cache
        self.seed = seed
        self.ragged = (ragged or _knobs.get_str(
            "PADDLE_TPU_SERVE_RAGGED")).lower()
        # token axis of the ragged step: decode rows + prefill chunk
        # tokens packed per step (clamped to >= max_slots in the engine)
        self.token_budget = token_budget or _knobs.get_int(
            "PADDLE_TPU_SERVE_TOKEN_BUDGET",
            default=self.max_slots + self.prefill_chunk)
        if self.kv_quant not in (None, "int8"):
            raise ValueError("kv_quant must be None or 'int8'")
        if self.ragged not in ("auto", "on", "off"):
            raise ValueError("PADDLE_TPU_SERVE_RAGGED must be auto|on|off")
        if self.token_budget <= 0:
            raise ValueError("token_budget must be > 0")


class ServingEngine:
    """Continuous-batching engine over one model.

    ``device`` defaults to ``cuda`` (``"cpu"`` only when asked for, and
    then every step runs the plain PyTorch versions of the kernels); it
    must be the device the model's weights live on. Plain integer counters:
    ``ragged_steps`` (ragged steps dispatched), ``prefill_steps`` and
    ``decode_steps`` (the two programs of ``ragged="off"``),
    ``decode_tokens`` and ``prefill_tokens`` (tokens those steps
    computed)."""

    def __init__(self, model, device: DeviceLike = None, **knobs):
        self.device = resolve_device(device)
        cfg = EngineConfig(**knobs)
        self.config = cfg
        ad = model.decode_adapter()
        # the weights travel as an argument of every step, so the
        # adapter itself holds none
        self._w, ad.weights = ad.weights, None
        self._ad = ad
        wdev = self._w["wte"].device
        if wdev != self.device:
            raise ValueError("model weights are on %s, engine device is %s"
                             % (wdev, self.device))
        model_max = getattr(getattr(model, "config", None),
                            "max_position_embeddings", 2048)
        self.max_seq_len = min(cfg.max_seq_len or model_max, model_max)
        self.pages_per_seq = -(-self.max_seq_len // cfg.block_size)

        self.manager = BlockManager(
            cfg.num_blocks, cfg.block_size, watermark=cfg.watermark,
            enable_prefix_cache=cfg.enable_prefix_cache)
        self.scheduler = Scheduler(self.manager, cfg.max_slots,
                                   cfg.prefill_chunk, self.max_seq_len)

        shape = (ad.num_kv_heads, cfg.num_blocks, cfg.block_size,
                 ad.head_dim)
        kvd = self._w["wte"].dtype

        def pool():
            zeros = torch.zeros(shape, dtype=kvd, device=self.device)
            return zeros if cfg.kv_quant is None else \
                quantize_kv_pages(zeros)

        self._kp = tuple(pool() for _ in range(ad.num_layers))
        self._vp = tuple(pool() for _ in range(ad.num_layers))

        self._gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        self._ragged = cfg.ragged != "off"      # auto -> on
        self.ragged_steps = 0
        self.prefill_steps = 0
        self.decode_steps = 0
        self.decode_tokens = 0
        self.prefill_tokens = 0
        # the flat token axis must cover the worst-case decode rows
        # (max_slots - 1 running + 1 prefill slot needing >= 1 token)
        self._token_budget = max(cfg.token_budget, cfg.max_slots)

        self._lock = threading.RLock()
        self._wakeup = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._requests: Dict[int, Request] = {}  # guarded by: _lock
        self._streams: Dict[int, "queue.Queue"] = {}  # guarded by: _lock

    # ----------------------------------------------------- public intake
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               temperature: float = 0.0, top_p: float = 1.0,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None) -> int:
        """Queue a request; returns its rid for stream()/cancel()."""
        prompt = [int(t) for t in prompt]
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError(
                "prompt %d + max_new_tokens %d exceeds max_seq_len %d"
                % (len(prompt), max_new_tokens, self.max_seq_len))
        now = time.monotonic()
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      temperature=float(temperature), top_p=float(top_p),
                      eos_id=eos_id, arrival=now,
                      deadline=None if deadline_s is None
                      else now + deadline_s)
        with self._lock:
            self._requests[req.rid] = req
            self._streams[req.rid] = queue.Queue()
            self.scheduler.add(req)
        self._wakeup.set()
        return req.rid

    def stream(self, rid: int) -> Iterator[int]:
        """Per-token iterator; raises RequestError on abnormal end."""
        with self._lock:
            q = self._streams[rid]
        while True:
            kind, val = q.get()
            if kind == "tok":
                yield val
            elif val in ("eos", "length"):
                return
            else:
                raise RequestError(val)

    def cancel(self, rid: int, reason: str = "cancelled") -> None:
        with self._lock:
            req = self._requests.get(rid)
            if req is None:
                return
            self.scheduler.cancel(req, reason)
            self._end_stream(req, reason)

    def result(self, rid: int) -> List[int]:
        """Convenience: drain the whole stream into a list."""
        return list(self.stream(rid))

    # ----------------------------------------------------- health/stats
    def _descriptor(self, req: Request) -> RequestDescriptor:
        return RequestDescriptor(
            rid=req.rid, prompt=tuple(req.prompt),
            generated=tuple(req.generated), remaining=req.remaining,
            temperature=req.temperature, top_p=req.top_p,
            eos_id=req.eos_id, deadline=req.deadline, state=req.state)

    def stats(self) -> EngineStats:
        """Thread-safe health snapshot: free/watermark blocks, slot and
        queue occupancy, and replayable descriptors of every in-flight
        request, all read under one lock hold."""
        with self._lock:
            prefilling = running = 0
            for r in self.scheduler.slots.values():
                if r.state == RUNNING:
                    running += 1
                elif r.state == PREFILL:
                    prefilling += 1
            inflight = tuple(
                self._descriptor(r) for r in self._requests.values()
                if r.state not in (FINISHED, CANCELLED))
            return EngineStats(
                free_blocks=self.manager.num_free(),
                total_blocks=self.manager.num_blocks,
                watermark_blocks=self.manager.watermark_blocks,
                block_size=self.manager.block_size,
                queue_depth=len(self.scheduler.waiting),
                prefilling=prefilling,
                running=running,
                active_slots=self.scheduler.num_active(),
                max_slots=self.config.max_slots,
                ragged_steps=self.ragged_steps,
                inflight=inflight)

    # ------------------------------------------------------------ warmup
    def warmup(self, token: int = 0) -> None:
        """Run one tiny request through the engine before real traffic,
        so the first user request pays for no kernel build. The 1-token
        prompt registers nothing in the prefix cache (only full blocks
        are hashed) and the pool drains back to empty."""
        if self._thread is not None:
            raise RuntimeError("warmup() must run before start()")
        rid = self.submit([int(token)], max_new_tokens=2)
        steps = 0
        while self.step():
            steps += 1
            if steps > 64:
                raise RuntimeError("warmup failed to drain")
        list(self.stream(rid))      # queue already holds the end
        with self._lock:
            self._requests.pop(rid, None)
            self._streams.pop(rid, None)

    # ------------------------------------------------------- step engine
    def step(self) -> bool:
        """One scheduler round. Ragged layout (the default): admit, then
        ONE ragged step covering every decode row plus packed prefill
        chunks. Off layout: admit, one prefill chunk, one decode batch
        (a request whose last chunk ran emits its first token and then
        decodes in the same round, as in the JAX engine). Returns False
        when there was nothing to do."""
        with self._lock:
            self._expire_deadlines()
            admitted = self.scheduler.admit()
            if self._ragged:
                self.scheduler.ensure_decode_blocks()
                worked = self._run_ragged()
            else:
                chunk = self.scheduler.next_prefill()
                if chunk is not None:
                    self._run_prefill(chunk)
                self.scheduler.ensure_decode_blocks()
                running = self.scheduler.running()
                if running:
                    self._run_decode(running)
                worked = chunk is not None or bool(running)
            return bool(admitted or worked)

    def _run_ragged(self) -> bool:
        """Build and run ONE ragged mixed batch: every RUNNING slot
        contributes its decode token, then PREFILL slots pack prompt
        chunks into the remaining token budget (oldest first). All
        arrays have fixed padded shapes -- [token_budget] tokens,
        [max_slots] rows (row index == slot index)."""
        cfg = self.config
        R = cfg.max_slots
        T = self._token_budget
        P = self.pages_per_seq
        running = self.scheduler.running()
        chunks = self.scheduler.next_prefills(T - len(running))
        if not running and not chunks:
            return False
        # every int32 input in one host buffer: one copy to the device
        ints = np.zeros(3 * T + 3 * R + R * P, np.int32)
        toks, pos, row_of = (ints[i * T:(i + 1) * T] for i in range(3))
        qs, ql, cl = (ints[3 * T + i * R:3 * T + (i + 1) * R]
                      for i in range(3))
        bt = ints[3 * T + 3 * R:].reshape(R, P)
        pos[:] = -1
        row_of[:] = -1
        temp = np.zeros(R, np.float32)
        top_p = np.ones(R, np.float32)
        cursor = 0
        for req in running:
            s = req.slot
            qs[s] = cursor
            ql[s] = 1
            cl[s] = req.total_len()
            toks[cursor] = req.generated[-1]
            pos[cursor] = req.decode_pos()
            row_of[cursor] = s
            temp[s] = req.temperature
            top_p[s] = req.top_p
            bt[s, :len(req.blocks)] = req.blocks
            cursor += 1
        for ch in chunks:
            req = ch.req
            s = req.slot
            n = len(ch.tokens)
            qs[s] = cursor
            ql[s] = n
            cl[s] = ch.start + n
            toks[cursor:cursor + n] = ch.tokens
            pos[cursor:cursor + n] = np.arange(ch.start, ch.start + n)
            row_of[cursor:cursor + n] = s
            temp[s] = req.temperature
            top_p[s] = req.top_p
            bt[s, :len(req.blocks)] = req.blocks
            cursor += n
        n_prefill = cursor - len(running)
        dev = torch.from_numpy(ints).to(self.device)
        d_toks, d_pos, d_row_of = (dev[i * T:(i + 1) * T] for i in range(3))
        d_qs, d_ql, d_cl = (dev[3 * T + i * R:3 * T + (i + 1) * R]
                            for i in range(3))
        d_bt = dev[3 * T + 3 * R:].view(R, P)
        lg, self._kp, self._vp = self._ad.ragged_chunk(
            self._w, d_toks, d_pos, d_row_of, d_qs, d_ql, d_cl, self._kp,
            self._vp, d_bt)
        last = (d_qs + d_ql - 1).clamp(0, T - 1).long()
        if temp.any():
            floats = torch.from_numpy(np.concatenate([temp, top_p])) \
                .to(self.device)
            t_arg, p_arg = floats[:R], floats[R:]
        else:                           # all greedy: the argmax lane
            t_arg, p_arg = 0.0, None
        nxt = _sample(lg[last], self._gen, t_arg, p_arg)
        out = nxt.cpu().numpy()
        self.ragged_steps += 1
        self.decode_tokens += len(running)
        self.prefill_tokens += n_prefill
        for req in running:
            if req.state == RUNNING:     # not cancelled mid-step
                self._emit(req, int(out[req.slot]))
        for ch in chunks:
            req = ch.req
            if req.state != PREFILL:     # cancelled mid-step
                continue
            req.prefilled = ch.start + len(ch.tokens)
            if not ch.last:
                continue
            # the first token emits in the SAME step the final chunk
            # completes; a preempted request re-prefills but already
            # streamed its first token, so its TTFT stamp stays
            if req.first_token_at is None:
                req.first_token_at = time.monotonic()
            req.state = RUNNING
            self._emit(req, int(out[req.slot]))
        return True

    def _run_prefill(self, chunk: PrefillChunk) -> None:
        """The off layout's prefill program: one chunk of one request as
        a [1, prefill_chunk] row (padding at position -1) over its block
        table; samples the chunk's last real token. The request turns
        RUNNING and emits that token once its last chunk has run."""
        req, cfg = chunk.req, self.config
        C, P = cfg.prefill_chunk, self.pages_per_seq
        n = len(chunk.tokens)
        ints = np.zeros(2 * C + P, np.int32)   # toks, pos, block table
        ints[C:2 * C] = -1
        ints[:n] = chunk.tokens
        ints[C:C + n] = np.arange(chunk.start, chunk.start + n)
        ints[2 * C:2 * C + len(req.blocks)] = req.blocks
        dev = torch.from_numpy(ints).to(self.device)
        lg, self._kp, self._vp = self._ad.paged_chunk(
            self._w, dev[:C].view(1, C), dev[C:2 * C].view(1, C), self._kp,
            self._vp, dev[2 * C:].view(1, P))
        if req.temperature == 0.0:      # the argmax lane
            t_arg, p_arg = 0.0, None
        else:
            t_arg = torch.tensor([req.temperature], device=self.device)
            p_arg = torch.tensor([req.top_p], device=self.device)
        nxt = int(_sample(lg[0, n - 1][None], self._gen, t_arg, p_arg)[0])
        self.prefill_steps += 1
        self.prefill_tokens += n
        req.prefilled = chunk.start + n
        if chunk.last:
            # a preempted request re-prefills but already streamed its
            # first token: its TTFT stamp stays
            if req.first_token_at is None:
                req.first_token_at = time.monotonic()
            req.state = RUNNING
            self._emit(req, nxt)

    def _run_decode(self, running: List[Request]) -> None:
        """The off layout's decode program: every RUNNING slot's last
        token as a [max_slots, 1] batch, idle slots at position -1, each
        row sampled with its own temperature and top_p."""
        S, P = self.config.max_slots, self.pages_per_seq
        ints = np.zeros(2 * S + S * P, np.int32)   # toks, pos, tables
        toks, pos = ints[:S], ints[S:2 * S]
        bt = ints[2 * S:].reshape(S, P)
        pos[:] = -1
        temp = np.zeros(S, np.float32)
        top_p = np.ones(S, np.float32)
        for req in running:
            s = req.slot
            toks[s] = req.generated[-1]
            pos[s] = req.decode_pos()
            temp[s] = req.temperature
            top_p[s] = req.top_p
            bt[s, :len(req.blocks)] = req.blocks
        dev = torch.from_numpy(ints).to(self.device)
        lg, self._kp, self._vp = self._ad.paged_chunk(
            self._w, dev[:S].view(S, 1), dev[S:2 * S].view(S, 1), self._kp,
            self._vp, dev[2 * S:].view(S, P))
        if temp.any():
            floats = torch.from_numpy(np.concatenate([temp, top_p])) \
                .to(self.device)
            t_arg, p_arg = floats[:S], floats[S:]
        else:                           # all greedy: the argmax lane
            t_arg, p_arg = 0.0, None
        out = _sample(lg[:, 0], self._gen, t_arg, p_arg).cpu().numpy()
        self.decode_steps += 1
        self.decode_tokens += len(running)
        for req in running:
            if req.state == RUNNING:     # not cancelled mid-step
                self._emit(req, int(out[req.slot]))

    def _emit(self, req: Request, tok: int) -> None:
        req.generated.append(tok)
        req.remaining -= 1
        q = self._streams.get(req.rid)
        if q is not None:
            q.put(("tok", tok))
        if req.eos_id is not None and tok == req.eos_id:
            self.scheduler.finish(req, "eos")
            self._end_stream(req, "eos")
        elif req.remaining <= 0:
            self.scheduler.finish(req, "length")
            self._end_stream(req, "length")

    def _end_stream(self, req: Request, reason: str) -> None:
        q = self._streams.get(req.rid)
        if q is not None:
            q.put(("end", reason))

    def _expire_deadlines(self) -> None:
        now = time.monotonic()
        for req in list(self._requests.values()):
            if req.deadline is not None and now > req.deadline and \
                    req.state not in (FINISHED, CANCELLED):
                self.scheduler.cancel(req, "deadline")
                self._end_stream(req, "deadline")

    # -------------------------------------------------- lifecycle/thread
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                if not self.step():
                    self._wakeup.wait(timeout=0.01)
                    self._wakeup.clear()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="serving-engine")
        self._thread.start()

    def shutdown(self, check_leaks: bool = True) -> None:
        """Stop the loop, cancel outstanding requests, and verify the
        block pool drained (every page free or prefix-cached)."""
        self._stop.set()
        self._wakeup.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        with self._lock:
            for req in list(self._requests.values()):
                if req.state not in (FINISHED, CANCELLED):
                    self.scheduler.cancel(req, "shutdown")
                    self._end_stream(req, "shutdown")
            if check_leaks:
                self.manager.assert_all_free()
