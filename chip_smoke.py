#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one NVIDIA GPU and check it end to end.

Run from the repository root, on a machine with a CUDA GPU and the CUDA
toolkit (``nvcc``)::

    python3 chip_smoke.py

Phases, in order; a failure in any of them raises and exits non-zero:

1. the card's name and power limit, as ``nvidia-smi`` gives them;
2. build every kernel of the port from its sources (one ``nvcc`` per
   source, all started together) and print the build seconds and
   ``ptxas``'s register / shared-memory report;
3. K4: hold the ragged paged-attention kernel against its plain PyTorch
   version on the card at the serving path's shapes (bf16, page 16,
   head_dim 128, 16 heads, 8 rows, a 136-token axis), in several prefill
   / decode mixes, and time the kernel, the plain version, a library call
   computing the same function (``scaled_dot_product_attention`` over
   pre-gathered K/V, timed only) and the least time the card could take
   (``bound``);
4. K1, K2, K3: hold the flash-attention forward, fused backward and split
   backward against their plain versions at the training shapes (b 8,
   s 1024, 16 heads, d 128, bf16, causal) and at sq < sk, a ragged s,
   full attention, d 64 and 256, and a sequence past the fused
   backward's cap (the split route); time each at the training shapes
   beside its plain version, the library's flash attention (forward:
   ``scaled_dot_product_attention``; backward: its aten backward op; both
   timed only) and its bound;
5. train GPT-3 1.3B (bf16, random weights from seed 0, full width and
   depth) as ``bench.py`` configures it: batch 8 x 1024 tokens, AdamW
   (lr 1e-4, weight decay 0.01, bf16 first moment, factored second
   moment), grad clip 1.0, ``lm_ce_chunks=8``. Under no_grad at full
   depth, the first step's loss, every layer's attention output and the
   final hidden states, and on a 2-layer model of the same width the
   global grad norm and three parameters' grads, are held against the
   same computation through the plain attention; then a warm-up step and
   timed steps on one batch, whose loss must fall, with K1 and K2
   launched once per layer per step; prints tokens/s, the median step,
   MFU (``bench.py``'s flops count against 989 TFLOP/s) and peak memory;
6. serve GPT-3 1.3B (bf16, random weights from seed 0, full width) with
   ``ServingEngine(max_slots=8, block_size=16, num_blocks=2048,
   prefill_chunk=128)``: 12 greedy requests of 64-1024 prompt tokens, two
   of them sharing a 512-token prefix, 32 new tokens each. The first
   step's logits are held against the same step through the plain
   attention; every stream must reach its length, the prefix cache must
   hit, ``shutdown()`` must find no leaked block, and the kernel must
   have launched once per layer per step;
7. profiles (torch.profiler) of engine steps and of training steps:
   device busy share and the kernels with the most device time;
8. one JSON line listing every ported kernel with its numbers;
9. last line: ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA device is present.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet, at 700 W
BF16_FLOPS_PER_S = 989e12       # dense bf16 tensor-core peak, same source
KERNEL_TOL = dict(rtol=2e-2, atol=2e-2)     # bf16 output, f32 inside
# bf16 logits of |x| <= ~4 after 24 layers: the kernel and the plain
# version round the same f32 attention to bf16 from other summation
# orders, a 1-ulp difference that compounds; a first run at 5e-2 saw 14
# of 6.8M logits off by up to 0.06 (a few bf16 ulps at |x| ~ 4)
# (argmax agreement is printed, not checked: random weights leave the top
# logits of a 50304-word vocabulary within bf16 noise of each other)
LOGITS_TOL = dict(rtol=5e-2, atol=1e-1)
# flash kernels vs plain versions, row by row (a query's out or dq, a
# key's dk or dv): the largest |got - want| in a row, in units of that
# row's RMS of want (see row_err), so that the small values of a late
# causal row are held as tightly as the large ones of an early row (bf16
# outputs, p and ds rounded to bf16 at a running rather than the final
# row max). Read at 0.019-0.035 on an H100 in every case below and in
# every layer of the training check; a 64-key tile left out of a late
# causal row reads 1.6 (tests/test_torch_kernels_cuda.py). lse (f32, from
# the same f32 scores): read at <= 1.9e-6.
FLASH_ROW_TOL = 6e-2
FLASH_LSE_ATOL = 1e-4
# training phase, kernels vs plain attention (bf16 weights and
# activations; the two attentions round p to bf16 at different places).
# Full depth, no_grad: the first-step loss (~11.24 at init; read 5.6e-5
# apart on an H100) within 1e-3 absolute; every layer's attention output
# on its own q/k/v within FLASH_ROW_TOL; the final hidden states, token by
# token, in relative L2 (read at most 0.0165, while a model whose
# attention returns zeros is 0.76-0.85 away: printed beside it).
# 2-layer model: the global grad norm (read 2.3e-5 apart) within 1e-3 of
# it, three grads in relative L2 (read 0.0076-0.0083).
TRAIN_LOSS_ATOL = 1e-3
TRAIN_HIDDEN_RTOL = 4e-2
TRAIN_GRAD_RTOL = 2e-2
TRAIN_GNORM_RTOL = 1e-3
TRAIN_STEPS = 6


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


def cuda_ms(fn, iters, warmup=2):
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back
    calls, between CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


# ------------------------------------------------------------ phase 3
def make_case(rng, gen, ql, cl, n_heads, n_kv, n_tokens=136, d=128,
              page=16, max_len=2048, dev="cuda"):
    """One ragged batch on the card: bf16 q and pools from ``gen``,
    metadata from ``rng``; shuffled page ids, and out-of-range ids in
    each row's unused block-table tail (the kernel clamps them)."""
    n_rows = len(ql)
    P = max_len // page
    total_pages = n_rows * P + 1
    q = torch.randn(n_tokens, n_heads, d, generator=gen, device=dev)
    kp = torch.randn(n_kv, total_pages, page, d, generator=gen, device=dev)
    vp = torch.randn(n_kv, total_pages, page, d, generator=gen, device=dev)
    bt = (1 + rng.permutation(n_rows * P)).reshape(n_rows, P)
    for r, c in enumerate(cl):
        bt[r, -(-c // page):] = [-1, total_pages + 5][r % 2]
    ql = np.asarray(ql, np.int32)
    qs = (np.cumsum(ql) - ql).astype(np.int32)
    ints = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
            for a in (bt, cl, ql, qs)]
    return (q.bfloat16(), kp.bfloat16(), vp.bfloat16(), *ints)


def work_of(case):
    """Bytes the function must move (each input read once, the output
    written once) and the flops it must do, for this case's data."""
    q, kp, _, bt, cl, ql, _ = case
    n_tokens, n_heads, d = q.shape
    n_kv = kp.shape[0]
    window = bt.shape[1] * kp.shape[2]
    cl_h = cl.cpu().numpy().astype(np.int64)
    ql_h = ql.cpu().numpy().astype(np.int64)
    live = ql_h > 0
    kv_bytes = int(np.minimum(cl_h[live], window).sum()) * n_kv * d * 2 * 2
    q_bytes = int(ql_h.sum()) * n_heads * d * 2
    out_bytes = n_tokens * n_heads * d * 2
    meta = 4 * (bt.numel() + 3 * cl.numel())
    keys = 0                           # (token, key) pairs attended
    for c, n in zip(cl_h[live], ql_h[live]):
        lim = np.minimum(c - n + np.arange(1, n + 1), window)
        keys += int(np.maximum(lim, 0).sum())
    flops = keys * n_heads * d * 4     # q.k and p.v, 2 flops a mac each
    return kv_bytes + q_bytes + out_bytes + meta, flops


def sdpa_inputs(case):
    """Per-row padded q [R, h, Qmax, d] and gathered K/V [R, h, L, d]
    with a boolean bottom-right causal mask, for the library yardstick."""
    q, kp, vp, bt, cl, ql, qs = case
    n_heads, d = q.shape[1], q.shape[2]
    n_kv, total_pages, page, _ = kp.shape
    rows = [r for r in range(len(ql)) if int(ql[r]) > 0]
    qmax = max(int(ql[r]) for r in rows)
    L = bt.shape[1] * page
    qp = q.new_zeros(len(rows), n_heads, qmax, d)
    mask = torch.zeros(len(rows), 1, qmax, L, dtype=torch.bool,
                       device=q.device)
    for i, r in enumerate(rows):
        s, n, c = int(qs[r]), int(ql[r]), int(cl[r])
        qp[i, :, :n] = q[s:s + n].transpose(0, 1)
        lim = c - n + torch.arange(1, n + 1, device=q.device)
        key = torch.arange(L, device=q.device)
        mask[i, 0, :n] = key[None] < lim[:, None]
    bt_live = bt[rows].clamp(0, total_pages - 1).long()

    def gather(pages):
        g = pages[:, bt_live].movedim(1, 0).reshape(len(rows), n_kv, L, d)
        return g.repeat_interleave(n_heads // n_kv, dim=1)

    return qp, gather(kp), gather(vp), mask


def kernel_phase(card):
    from paddle_tpu_torch.incubate.nn.cuda.paged_attention import (
        ragged_paged_attention, ragged_paged_attention_ref)

    rng = np.random.RandomState(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    decode_cl = [2048] + rng.randint(1, 2049, 7).tolist()
    mixes = {
        # name: (query_lens, context_lens, n_heads, n_kv)
        "decode": ([1] * 8, decode_cl, 16, 16),
        "mixed": ([128] + [1] * 7,
                  [640] + rng.randint(1, 2049, 7).tolist(), 16, 16),
        "idle_rows": ([1, 0, 1, 0, 37, 0, 1, 0],
                      [300, 0, 1500, 0, 37, 0, 2048, 0], 16, 16),
        "padding": ([60, 1, 1, 1, 0, 0, 0, 0],
                    [60, 17, 999, 2048, 0, 0, 0, 0], 16, 16),
        "gqa4": ([100] + [1] * 7,
                 [612] + rng.randint(1, 2049, 7).tolist(), 16, 4),
    }
    results = {}
    for name, (ql, cl, nh, nkv) in mixes.items():
        case = make_case(rng, gen, ql, cl, nh, nkv)
        got = ragged_paged_attention(*case)
        want = ragged_paged_attention_ref(*case)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **KERNEL_TOL)
        n_live = int(sum(ql))
        check(bool((got[n_live:] == 0).all()),
              "%s: padding tokens are not exactly zero" % name)
        check(bool(torch.isfinite(got).all()), "%s: non-finite" % name)
        ms = cuda_ms(lambda: ragged_paged_attention(*case), iters=20)
        plain_ms = cuda_ms(lambda: ragged_paged_attention_ref(*case),
                           iters=3, warmup=1)
        qp, kg, vg, mask = sdpa_inputs(case)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = cuda_ms(lambda: sdpa(qp, kg, vg, attn_mask=mask),
                             iters=10)
        del qp, kg, vg, mask
        nbytes, flops = work_of(case)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        results[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, flops=flops)
        print("K4 %-9s T=%d rows=%d heads=%d/%d: max_abs_err=%.3g "
              "kernel=%.4f ms plain=%.4f ms sdpa=%.4f ms bound=%.4f ms "
              "(%s, %.1f MB, %.2f GFLOP) [%s]"
              % (name, case[0].shape[0], len(ql), nh, nkv, err, ms,
                 plain_ms, library_ms, bound_ms,
                 results[name]["bound_by"], nbytes / 1e6, flops / 1e9,
                 card), flush=True)
        del case, got, want
    return results


# ------------------------------------------------------------ phase 4
FLASH_SRC = "paddle_tpu_torch/incubate/nn/csrc/flash_attn.cu"
FLASH_PALLAS = "paddle_tpu/incubate/nn/pallas/flash_attn.py"
# name -> (b, sq, sk, h, d, causal); "train" is the training path's shape
FLASH_CASES = {
    "train": (8, 1024, 1024, 16, 128, True),
    "sq_lt_sk": (2, 300, 1024, 16, 128, True),
    "ragged_s": (2, 1000, 1000, 16, 128, True),
    "full": (2, 1024, 1024, 16, 128, False),
    "d64": (2, 512, 512, 16, 64, True),
    "d256": (2, 512, 512, 8, 256, True),
    # sq * d > 8192 * 128: the backward takes K3 (heads cut so that the
    # plain version's [s, s] f32 tiles fit)
    "split_route": (1, 8320, 8320, 2, 128, True),
}


def visible_pairs(sq, sk, causal):
    """(query, key) pairs a head attends: bottom-right causal or full."""
    if not causal:
        return sq * sk
    lim = np.clip(np.arange(sq) + (sk - sq) + 1, 0, sk)
    return int(lim.sum())


def flash_work(b, sq, sk, h, d, causal, backward):
    """Bytes each kernel must move (every input read once, every output
    written once, bf16 tensors, f32 lse) and the flops of the function:
    4*d per visible pair forward (q.k and p.v), 10*d backward (s, dv,
    dp, dk, dq; K3 recomputes s and dp in its second kernel, which the
    bound does not count)."""
    qo = b * sq * h * d * 2
    kv = b * sk * h * d * 2
    lse = b * h * sq * 4
    pairs = visible_pairs(sq, sk, causal) * b * h
    if not backward:               # q, k, v in; out, lse out
        return qo + 2 * kv + qo + lse, 4 * d * pairs
    # q, k, v, out, do, lse in; dq, dk, dv out
    return 3 * qo + 2 * kv + lse + qo + 2 * kv, 10 * d * pairs


def bound_of(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def row_err(got, want):
    """Max abs error, and the largest error of a row (the last axis) in
    units of that row's RMS of ``want``, or of 1% of the whole tensor's
    RMS where that is larger: a row whose exact value is zero (dq of the
    first query under causal attention) holds only rounding noise."""
    w = want.float()
    err = (got.float() - w).abs()
    floor = 1e-2 * w.square().mean().sqrt().item() + 1e-30
    rms = w.square().mean(-1, keepdim=True).sqrt().clamp_min(floor)
    return err.max().item(), (err / rms).max().item()


def rel_l2(got, want, dim=None):
    """||got - want|| / ||want||, over ``dim`` (all of it by default);
    the largest when ``dim`` leaves several."""
    g, w = got.float(), want.float()
    if dim is None:
        return ((g - w).norm() / w.norm()).item()
    return ((g - w).norm(dim=dim) / w.norm(dim=dim)).max().item()


def flash_kernel_phase(card):
    from paddle_tpu_torch.incubate.nn.cuda import flash_attn as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    for name, (b, sq, sk, h, d, causal) in FLASH_CASES.items():
        def mk(s):
            return torch.randn(b, s, h, d, generator=gen,
                               device="cuda").bfloat16()

        q, k, v, do = mk(sq), mk(sk), mk(sk), mk(sq)
        hm = [x.transpose(1, 2) for x in (q, k, v, do)]  # [b, h, s, d]
        scale = d ** -0.5
        out, lse = fa.flash_fwd(q, k, v, causal, scale)
        ref_out, ref_lse = fa.flash_fwd_ref(*hm[:3], causal, scale)
        ref_grads = [g.transpose(1, 2) for g in fa.flash_bwd_ref(
            *hm[:3], ref_out, ref_lse, hm[3], causal, scale)]
        ref_out, ref_lse = ref_out.transpose(1, 2), ref_lse[..., 0]
        # the backward kernels see the plain forward's out and lse
        fused = fa.uses_fused_bwd(sq, sk, d)
        counts = (fa.flash_bwd_fused.launches, fa.flash_bwd_split.launches)
        grads = {("K2" if fused else "K3"): fa.flash_bwd(
            q, k, v, ref_out, ref_lse, do, causal, scale)}
        check((fa.flash_bwd_fused.launches - counts[0],
               fa.flash_bwd_split.launches - counts[1])
              == ((1, 0) if fused else (0, 1)),
              "%s: the backward took the wrong route" % name)
        if fused:
            grads["K3"] = fa.flash_bwd_split(q, k, v, ref_out, ref_lse, do,
                                             causal, scale)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()) and
              bool(torch.isfinite(lse).all()), "%s K1: non-finite" % name)
        lse_err = (lse - ref_lse).abs().max().item()
        check(lse_err <= FLASH_LSE_ATOL, "%s K1: lse max abs err %.4g > %g"
              % (name, lse_err, FLASH_LSE_ATOL))
        errs = {"K1": [row_err(out, ref_out)]}
        for kname, gs in grads.items():
            errs[kname] = [row_err(g, w) for g, w in zip(gs, ref_grads)]
            check(all(bool(torch.isfinite(g).all()) for g in gs),
                  "%s %s: non-finite gradient" % (name, kname))
        for kname, pairs in errs.items():
            err, rel = max(e for e, _ in pairs), max(r for _, r in pairs)
            errs[kname] = (err, rel)
            check(rel <= FLASH_ROW_TOL, "%s %s: max abs err %.4g, %.4g of "
                  "its row's RMS > %g" % (name, kname, err, rel,
                                          FLASH_ROW_TOL))
        print("flash %-11s b=%d sq=%d sk=%d h=%d d=%d causal=%d: %s; K1 lse "
              "max_abs_err %.3g [%s]"
              % (name, b, sq, sk, h, d, causal, ", ".join(
                  "%s max_abs_err %.4g (%.3e of its row's RMS)" % (kk, e, r)
                  for kk, (e, r) in errs.items()), lse_err, card),
              flush=True)
        if name == "train":
            results = time_flash(fa, q, k, v, do, hm, ref_out, ref_lse,
                                 causal, scale, errs, card)
        del q, k, v, do, hm, out, lse, ref_out, ref_lse, ref_grads, grads
        torch.cuda.empty_cache()
    return results


def time_flash(fa, q, k, v, do, hm, out, lse, causal, scale, errs, card):
    """K1, K2, K3 at the training shapes: kernel, plain and library ms
    (CUDA events) and the bound, per kernel."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    lse4 = lse[..., None]                          # [b, h, sq, 1]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    aten = torch.ops.aten
    lib_out, lib_lse, cq, ck, mq, mk_, seed, offs, _ = \
        aten._scaled_dot_product_flash_attention(
            *hm[:3], 0.0, causal, False, scale=scale)
    times = {
        "K1": (cuda_ms(lambda: fa.flash_fwd(q, k, v, causal, scale), 20),
               cuda_ms(lambda: fa.flash_fwd_ref(*hm[:3], causal, scale),
                       3, warmup=1),
               cuda_ms(lambda: sdpa(*hm[:3], is_causal=causal), 20)),
        "K2": (cuda_ms(lambda: fa.flash_bwd_fused(
                   q, k, v, out, lse, do, causal, scale), 10),
               cuda_ms(lambda: fa.flash_bwd_ref(
                   *hm[:3], out.transpose(1, 2), lse4, hm[3], causal,
                   scale), 3, warmup=1),
               cuda_ms(lambda: aten._scaled_dot_product_flash_attention_backward(
                   hm[3], *hm[:3], lib_out, lib_lse, cq, ck, mq, mk_, 0.0,
                   causal, seed, offs, scale=scale), 10)),
    }
    times["K3"] = (cuda_ms(lambda: fa.flash_bwd_split(
        q, k, v, out, lse, do, causal, scale), 10),) + times["K2"][1:]
    leaves = [x.detach().clone().requires_grad_() for x in hm[:3]]

    def sdpa_fwd_bwd():
        o = sdpa(*leaves, is_causal=causal)
        torch.autograd.grad(o, leaves, hm[3])

    fwd_bwd_ms = cuda_ms(sdpa_fwd_bwd, 10)
    res = {}
    for kname, (ms, plain_ms, library_ms) in times.items():
        nbytes, flops = flash_work(b, sq, sk, h, d, causal,
                                   backward=kname != "K1")
        bound_ms, bound_by = bound_of(nbytes, flops)
        res[kname] = dict(max_abs_err=errs[kname][0], ms=ms,
                          plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          bytes=nbytes, flops=flops)
        print("%s train shape: kernel=%.4f ms plain=%.4f ms library=%.4f "
              "ms bound=%.4f ms (%s, %.1f MB, %.2f GFLOP) [%s]"
              % (kname, ms, plain_ms, library_ms, bound_ms, bound_by,
                 nbytes / 1e6, flops / 1e9, card), flush=True)
    print("library scaled_dot_product_attention forward + backward: %.4f "
          "ms [%s]" % (fwd_bwd_ms, card), flush=True)
    return res


# ------------------------------------------------------------ phase 5
def train_config(num_layers=24):
    """bench.py's headline configuration (its depth cut when asked)."""
    from paddle_tpu_torch.models import gpt3_1p3B

    return dataclasses.replace(gpt3_1p3B(lm_ce_chunks=8, recompute=False),
                               num_layers=num_layers)


def train_batch(vocab, batch=8, seq=1024):
    """bench.py's batch: token ids and (independent) labels from numpy."""
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, vocab, (batch, seq))).cuda()
    labels = torch.from_numpy(rng.integers(0, vocab, (batch, seq))).cuda()
    return ids, labels


def plain_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                    is_causal=False, training=True, name=None):
    """The model's attention call through the plain composition."""
    from paddle_tpu_torch.incubate.nn.cuda.flash_attn import (
        flash_attention_ref)

    return flash_attention_ref(query, key, value, causal=is_causal)


def with_attention(fn, attention):
    """Run ``fn()`` with the GPT blocks' attention replaced."""
    from paddle_tpu_torch.models import gpt as gpt_module

    kernel = gpt_module.scaled_dot_product_attention
    gpt_module.scaled_dot_product_attention = attention
    out = fn()
    gpt_module.scaled_dot_product_attention = kernel
    return out


def no_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                 is_causal=False, training=True, name=None):
    """Attention that returns zeros: how far attention moves the model."""
    return torch.zeros_like(query)


def train_check(card):
    """Kernels against the plain attention: at full depth under no_grad
    the first-step loss, every layer's attention output on that layer's
    own q/k/v, and the final hidden states; then the grads of a 2-layer
    model of full width."""
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.models import gpt as gpt_module
    from paddle_tpu_torch.observability import grad_health

    cfg = train_config()
    model = GPTForCausalLM(
        cfg, dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(0))
    ids, labels = train_batch(cfg.vocab_size)
    kernel = gpt_module.scaled_dot_product_attention
    layer_errs = []

    def compared(query, key, value, **kw):
        out = kernel(query, key, value, **kw)
        layer_errs.append(row_err(out, plain_attention(query, key, value,
                                                       **kw)))
        return out

    with torch.no_grad():
        got = model(ids, labels=labels).item()
        want = with_attention(lambda: model(ids, labels=labels).item(),
                              plain_attention)
        hidden = with_attention(lambda: model.gpt(ids), compared)
        plain = with_attention(lambda: model.gpt(ids), plain_attention)
        bare = with_attention(lambda: model.gpt(ids), no_attention)
    check(bool(torch.isfinite(hidden).all()), "non-finite hidden states")
    h_err = rel_l2(hidden, plain, dim=-1)
    moved = ((bare.float() - plain.float()).norm(dim=-1) /
             plain.float().norm(dim=-1))
    a_err, a_rel = (max(e[i] for e in layer_errs) for i in (0, 1))
    print("train: %d layers, no_grad: first-step loss, kernels %.6f vs "
          "plain attention %.6f (diff %.3g); attention output of every "
          "layer on its own q/k/v: max_abs_err %.4g (%.3e of its row's "
          "RMS); final hidden states: largest per-token relative L2 %.4g "
          "(%d tokens); attention moves them by %.4g (median token; "
          "least %.4g)" % (cfg.num_layers, got, want, got - want, a_err,
                           a_rel, h_err, ids.numel(), moved.median().item(),
                           moved.min().item()), flush=True)
    check(len(layer_errs) == cfg.num_layers, "attention ran %d times, not "
          "once per layer" % len(layer_errs))
    check(np.isfinite(got) and abs(got - want) <= TRAIN_LOSS_ATOL,
          "first-step loss %r vs plain %r" % (got, want))
    check(a_rel <= FLASH_ROW_TOL, "a layer's attention output is off by "
          "%.4g of its row's RMS > %g" % (a_rel, FLASH_ROW_TOL))
    check(h_err <= TRAIN_HIDDEN_RTOL, "hidden states off by %.4g of their "
          "norm > %g" % (h_err, TRAIN_HIDDEN_RTOL))
    del model, hidden, plain, bare, moved
    torch.cuda.empty_cache()

    cfg2 = train_config(num_layers=2)
    model = GPTForCausalLM(
        cfg2, dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(1))
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]

    def grads():
        return torch.autograd.grad(model(ids, labels=labels), params)

    got = grads()
    want = with_attention(grads, plain_attention)
    gn, wn = grad_health(got).item(), grad_health(want).item()
    check(np.isfinite(gn) and abs(gn - wn) <= TRAIN_GNORM_RTOL * wn,
          "2-layer grad norm %r vs plain %r" % (gn, wn))
    msg = []
    for pname in ("gpt.h.0.attn.qkv_proj.weight", "gpt.h.1.mlp.fc1.weight",
                  "gpt.wte.weight"):
        i = names.index(pname)
        err = (got[i].float() - want[i].float()).abs().max().item()
        rel = rel_l2(got[i], want[i])
        check(rel <= TRAIN_GRAD_RTOL, "%s grad: relative L2 error %.4g > %g"
              % (pname, rel, TRAIN_GRAD_RTOL))
        msg.append("%s relative L2 %.4g, max_abs_err %.4g (max |g| %.4g)"
                   % (pname, rel, err, want[i].float().abs().max().item()))
    print("train: 2-layer grads, kernels vs plain attention: norm %.6f vs "
          "%.6f; %s" % (gn, wn, "; ".join(msg)), flush=True)
    del model, params, got, want
    torch.cuda.empty_cache()


def train_phase(card):
    """The training main path: K1/K2 counts set to 0 just before the
    timed steps and read just after."""
    from paddle_tpu_torch.incubate.nn.cuda import flash_attn as fa
    from paddle_tpu_torch.incubate.nn.cuda import paged_attention as pa
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = train_config()
    t0 = time.perf_counter()
    model = GPTForCausalLM(
        cfg, dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(0))
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                moment_dtype="bfloat16", factored_v=True)
    step = TrainStep(model, opt, grad_clip_norm=1.0)
    ids, labels = train_batch(cfg.vocab_size)
    first = step(ids, labels).item()              # warm-up step
    torch.cuda.synchronize()
    print("train: gpt3_1p3B bf16 built, warm-up step in %.2f s, loss %.4f"
          % (time.perf_counter() - t0, first), flush=True)

    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd.launches = 0
    fa.flash_bwd_fused.launches = 0
    fa.flash_bwd_split.launches = 0
    pa.ragged_paged_attention.launches = 0
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(loss.item())
    launches = {"K1": fa.flash_fwd.launches,
                "K2": fa.flash_bwd_fused.launches,
                "K3": fa.flash_bwd_split.launches,
                "K4": pa.ragged_paged_attention.launches}
    peak = torch.cuda.max_memory_allocated()

    n_layers = cfg.num_layers
    check(launches["K1"] == TRAIN_STEPS * n_layers and
          launches["K2"] == TRAIN_STEPS * n_layers and
          launches["K3"] == 0 and launches["K4"] == 0,
          "training launches %s, want K1 = K2 = %d x %d" %
          (launches, TRAIN_STEPS, n_layers))
    check(all(np.isfinite(losses)), "non-finite loss %s" % losses)
    check(losses[-1] < first, "loss did not fall: %s" % ([first] + losses))
    b, s = ids.shape
    tokens_s = b * s * TRAIN_STEPS / sum(step_s)
    n_params = sum(p.numel() for p in model.parameters())
    flops_per_token = 6 * n_params + 6 * n_layers * cfg.hidden_size * s
    mfu = tokens_s * flops_per_token / BF16_FLOPS_PER_S
    print("train: %d steps of %d x %d tokens, losses %s; %.1f tokens/s, "
          "median step %.2f ms, MFU %.4f (%d params, %.4g flops/token, "
          "against 989 TFLOP/s), peak memory %.2f GB; launches %s [%s]"
          % (TRAIN_STEPS, b, s, ["%.4f" % x for x in losses], tokens_s,
             1e3 * statistics.median(step_s), mfu, n_params,
             flops_per_token, peak / 1e9, launches, card), flush=True)
    return launches, step, (ids, labels)


# ------------------------------------------------------------ phase 6
def traffic(vocab, seed=0, n=12, shared=512, new_tokens=32):
    """Seeded prompts of 64-1024 tokens; the first and the last share a
    ``shared``-token prefix, so the last one (admitted after the first
    has finished) hits the prefix cache."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(64, 1025, n)
    prompts = [rng.randint(0, vocab, int(k)).tolist() for k in lens]
    prefix = rng.randint(0, vocab, shared).tolist()
    for i in (0, n - 1):
        prompts[i] = prefix + rng.randint(
            0, vocab, int(rng.randint(1, 1025 - shared))).tolist()
    return prompts, new_tokens


def engine_phase(card):
    from paddle_tpu_torch.incubate.nn.cuda.paged_attention import (
        ragged_paged_attention, ragged_paged_attention_ref)
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3B
    from paddle_tpu_torch.serving import ServingEngine

    cfg = gpt3_1p3B()
    t0 = time.perf_counter()
    model = GPTForCausalLM(
        cfg, dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(0))
    eng = ServingEngine(model, max_slots=8, block_size=16, num_blocks=2048,
                        prefill_chunk=128)
    eng.warmup()
    torch.cuda.synchronize()
    print("engine: gpt3_1p3B bf16 (%d layers, hidden %d, %d heads, vocab "
          "%d) built and warmed up in %.2f s"
          % (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
             cfg.vocab_size, time.perf_counter() - t0), flush=True)

    # keep the first step's inputs and logits for the plain-path check
    ad = eng._ad
    first = {}
    real_chunk = ad.ragged_chunk

    def keep_first(w, *args, attn=None):
        out = real_chunk(w, *args, attn=attn)
        if not first:
            toks, pos, row_of, qs, ql, cl, _, _, bt = args
            first["args"] = [t.clone() for t in
                             (toks, pos, row_of, qs, ql, cl)]
            first["bt"] = bt.clone()
            first["logits"] = out[0].clone()
        return out

    ad.ragged_chunk = keep_first
    prompts, new_tokens = traffic(cfg.vocab_size)

    # ---- the main path: counts set to 0 just before, read just after
    ragged_paged_attention.launches = 0
    steps0 = eng.ragged_steps
    t_start = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    step_s = []
    while True:
        t = time.perf_counter()
        if not eng.step():
            break
        step_s.append(time.perf_counter() - t)
    wall = time.perf_counter() - t_start
    launches = ragged_paged_attention.launches
    steps = eng.ragged_steps - steps0
    # ----
    ad.ragged_chunk = real_chunk

    reqs = [eng._requests[r] for r in rids]
    outs = [eng.result(r) for r in rids]
    for o in outs:
        check(len(o) == new_tokens, "a stream ended at %d tokens" % len(o))
        check(all(0 <= t < cfg.vocab_size for t in o), "token out of vocab")
    hit = reqs[-1].num_cached
    check(hit > 0, "the shared prefix did not hit the prefix cache")
    check(steps > 0 and launches == steps * cfg.num_layers,
          "kernel launches %d != ragged_steps %d x %d layers"
          % (launches, steps, cfg.num_layers))
    eng.shutdown()                     # raises on a leaked block
    ttft = [r.first_token_at - r.arrival for r in reqs]
    n_tok = sum(len(o) for o in outs)
    print("engine: %d requests (%d prompt tokens, %d prefix-cache hit "
          "tokens), %d steps, %d tokens out in %.3f s = %.1f tok/s, "
          "median step %.2f ms, TTFT median %.1f ms max %.1f ms, kernel "
          "launches %d [%s]"
          % (len(prompts), sum(map(len, prompts)), hit, steps, n_tok, wall,
             n_tok / wall, 1e3 * statistics.median(step_s),
             1e3 * statistics.median(ttft), 1e3 * max(ttft), launches,
             card), flush=True)

    # the first step again through the plain attention, on fresh pools:
    # the step started every row at position 0, so it read only the K/V
    # it wrote itself
    toks, pos, row_of, qs, ql, cl = first["args"]
    check(bool((cl == ql).all()), "first step carried earlier context")
    kp = tuple(torch.zeros_like(p) for p in eng._kp)
    vp = tuple(torch.zeros_like(p) for p in eng._vp)
    ref, _, _ = ad.ragged_chunk(eng._w, toks, pos, row_of, qs, ql, cl, kp,
                                vp, first["bt"],
                                attn=ragged_paged_attention_ref)
    live = pos >= 0
    got, want = first["logits"][live].float(), ref[live].float()
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    err = (got - want).abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print("engine: first step (%d tokens) logits vs plain attention: "
          "max_abs_err %.4g (max |logit| %.3g), argmax agreement %.4f"
          % (int(live.sum()), err, want.abs().max().item(), agree),
          flush=True)
    torch.testing.assert_close(got, want, **LOGITS_TOL)
    return launches


# kernel-name fragments -> group, first match wins
PROFILE_GROUPS = (
    ("flash K1-K3", ("flash_fwd_kernel", "flash_bwd_")),
    ("K4", ("ragged_paged_attention_kernel",)),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("copies and casts", ("copy",)),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)


def print_profile(prof, wall_us, what, card):
    """Device busy share over ``wall_us`` and the kernels with the most
    device time, from a torch.profiler run."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        print("profile %s: the profiler recorded no device time: not "
              "measured" % what)
        return
    print("profile %s: %.1f ms wall, device busy %.1f ms (%.1f%%), idle "
          "%.1f%% [%s]" % (what, wall_us / 1e3, busy_us / 1e3,
                           100 * busy_us / wall_us,
                           100 * (1 - busy_us / wall_us), card))
    groups = {}
    for e in kernels:
        g = next((name for name, pat in PROFILE_GROUPS
                  if any(x in e.key for x in pat)), "other")
        groups[g] = groups.get(g, 0) + e.self_device_time_total
    print("profile %s: by group: %s" % (what, ", ".join(
        "%s %.2f ms (%.1f%%)" % (g, us / 1e3, 100 * us / busy_us)
        for g, us in sorted(groups.items(), key=lambda kv: -kv[1]))))
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:12]:
        print("profile %s: %7.2f ms %5.1f%% %6d calls  %s"
              % (what, e.self_device_time_total / 1e3,
                 100 * e.self_device_time_total / busy_us, e.count,
                 e.key[:100]))
    sys.stdout.flush()


def profile_phase(card):
    """Where an engine step's device time goes: a fresh engine serves 8
    new requests under torch.profiler. Runs after the main path."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3B
    from paddle_tpu_torch.serving import ServingEngine

    cfg = gpt3_1p3B()
    model = GPTForCausalLM(
        cfg, dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(0))
    eng = ServingEngine(model, max_slots=8, block_size=16, num_blocks=2048,
                        prefill_chunk=128)
    eng.warmup()
    prompts, new_tokens = traffic(cfg.vocab_size, seed=1, n=8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
        steps = 0
        while eng.step():
            steps += 1
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    for r in rids:
        eng.result(r)
    eng.shutdown()
    print_profile(prof, wall_us, "serve(%d steps)" % steps, card)


def train_profile(step, batch, card, steps=2):
    """Where a training step's device time goes: ``steps`` more steps of
    the training phase's TrainStep under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(*batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    print_profile(prof, wall_us, "train(%d steps)" % steps, card)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    from paddle_tpu_torch.incubate.nn.cuda import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain versions
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    secs = _build.build_all()
    print("build: %s in %.2f s" % (", ".join(_build.SOURCES), secs))
    for name in _build.SOURCES:
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line or \
                    "Function properties" in line:
                print("ptxas %s: %s" % (name, line.strip()))
    sys.stdout.flush()

    k4 = kernel_phase(card)
    flash = flash_kernel_phase(card)
    train_check(card)
    train_launches, step, batch = train_phase(card)
    train_profile(step, batch, card)
    del step, batch
    torch.cuda.empty_cache()
    launches = engine_phase(card)
    profile_phase(card)

    at = k4["mixed"]
    kernels = [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "paddle_tpu_torch/incubate/nn/csrc/"
                  "ragged_paged_attention.cu",
        "replaces": "paddle_tpu/incubate/nn/pallas/paged_attention.py:263",
        "status": "ported",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in k4.values()),
        "ms": at["ms"], "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
        "library_ms": at["library_ms"],
        "at": "mixed: one 128-token prefill chunk + 7 decode rows, "
              "136-token axis, bf16, 16 heads, d 128, page 16",
        "mixes": k4}]
    for kname, name, line in (("K1", "flash_fwd", 53),
                              ("K2", "flash_bwd_fused", 279),
                              ("K3", "flash_bwd_split", 168)):
        r = flash[kname]
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SRC,
            "replaces": "%s:%d" % (FLASH_PALLAS, line), "status": "ported",
            "launches": train_launches[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "at": "training shapes: b 8, s 1024, 16 heads, d 128, bf16, "
                  "causal"})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
