#!/usr/bin/env python3
"""Drive paddle_tpu_torch on NVIDIA GPUs and check it end to end.

Run from the repository root, on a machine with a CUDA GPU and the CUDA
toolkit (``nvcc``)::

    python3 chip_smoke.py                 # every phase, on one card
    python3 chip_smoke.py --phases ring   # phases 1, 2 (ring.cu), 4d, 9b, 9c
    python3 chip_smoke.py --phases mesh   # phases 1, 2 (K1-K3, K7), 9e, 9f
    python3 chip_smoke.py --phases sp     # phases 1, 2 (K1-K3, K7), 5b, 9f

Phases 9e (sharded training) and 9f (sequence parallelism) spawn one
process a card, four at most, both in one spawn: their full-width runs
need four cards (``--phases mesh`` or ``--phases sp`` on four cards runs
them alone); on fewer they run their f32 checks only (on mp 2 / sp 2 on
two or three cards, a one-rank mesh on one) and say so.

The ring phases (4d, 9b, 9c) put rank r of a ring on card r % n (n
cards) when every pair of ring neighbours has peer access, else every
rank on card 0; with one card, both ranks of a ring share it.

Phases, in order; a failure in any of them raises and exits non-zero:

1. the card's name and power limit, as ``nvidia-smi`` gives them;
2. build every kernel of the port from its sources (one ``nvcc`` per
   source, all started together) and print the build seconds and
   ``ptxas``'s register / shared-memory report;
3. K4: hold the ragged paged-attention kernel against its plain PyTorch
   version on the card at GPT-3 1.3B's serving shapes (bf16, page 16,
   head_dim 128, 16 heads, 8 rows, a 136-token axis), in several prefill
   / decode mixes (8 decode rows at 2048 keys among them), and time the
   kernel, the plain version, a library call computing the same function
   (``scaled_dot_product_attention`` over pre-gathered K/V, timed only)
   and the least time the card could take (``bound``);
4. K5 and K7: the same for K5 over int8 pools at Llama-2 7B's serving
   shapes (32 heads, d 128, bf16 q; GQA groups 4 and 8, d 64, and 8 decode
   rows at 4096 keys over a 4096-key window too; K4's time on the bf16
   pool of each mix beside it), and for K7's RMSNorm
   (with and without a bias) and LayerNorm, bf16 and f32, d 4096 and
   2048, on 1, 12, 136, 8192 and 1001 rows, and its fused form (the
   serving steps' residual update and the norm after it, its sum bitwise
   PyTorch's adds) on 12 and 136 rows (library: ``F.rms_norm`` /
   ``F.layer_norm``, timed only, also back to back beside K7's call),
   with the form and blocks each case takes;
4b. K6: hold the paged-decode kernel (one query token a row) over bf16,
   f32 and int8 pools (bf16 q over int8: the K6-q8 route) against its
   plain version, in the two shapes the ``ragged="off"`` layout calls it
   with: a decode batch (8 rows, contexts of 64-1056, two rows empty) and
   a prefill chunk (128 rows of one sequence at positions 896-1023 over
   one block table, 20 rows of padding), plus contexts shorter than a
   page; at Llama-2 7B's (32 heads, d 128) and GPT-3 1.3B's (16 heads)
   shapes, GQA groups 4 and 8, d 64 and page 128; and the mixes of the
   kernel's page sharing: a prefill chunk whose rows' table slots past
   their own pages hold garbage, 16 rows alternating between two tables,
   padding rows inside the chunk's tiles, and decode rows of 2048-4096
   keys over many key splits; bitwise equal across two launches; time K6
   and K6-q8 beside the plain version, ``scaled_dot_product_attention``
   over K/V gathered per row (timed only), K4 / K5 on the same work as
   one ragged call, and the bound, with the call's key split and items;
4c. K8: hold the MoE grouped GEMM against its plain version on inputs
   from a real ``sort_dispatch`` of seed-0 routing: ``bench.py``'s MoE
   step (8192 tokens x 2048, 8 experts, SwiGLU dff 2816, top-2, bf16: P
   17408, K 2048 x N 5632 and K 2816 x N 2048), Mixtral-8x7B's widths
   (hidden 4096, dff 14336, 8 experts, top-2) at a decode batch of 8
   tokens and a 2048-token prefill, the same in f32 at a reduced size,
   and edges in bf16 and f32 (N 768, a ragged N, K past the last full K
   tile, a non-monotone block map with ids out of range, all pairs on
   one expert, empty experts), each with and without row counts (the
   dispatch's own, as ``moe_ffn_sorted`` passes them, or counts of 0,
   1, 63, 64, 65, 128 and clamped values), and bitwise equal across two
   launches; time the main shapes with and without the dispatch's row
   counts beside the plain version, a library call computing the same
   function (``torch._grouped_mm`` in bf16, per-expert ``torch.matmul``
   in f32; timed only) and the bound, with TFLOP/s, GB/s and the host
   time a bf16 call takes (tensor-map encoding, the whole wrapper);
4d. K9 and K10: hold the TP ring step (the copy of ``buf`` into the next
   rank's memory, bit-exact; ``buf @ w``, f32 rtol = atol = 2e-4, bf16
   rows within 4e-2 of their RMS) at ``bench.py``'s TP shape (T 16384,
   K 4096, N 1024 over mp 2 and 4 ranks; f32 and bf16) and at edges (N
   200, K 200, a 3-D buffer, 100 rows, two ranks on one card), and the
   ring shift (bit-exact, by 1 and by size - 1) at the pipeline's
   boundary tensor [1, 1024, 2048] in f32 and bf16 over 2 and 4 ranks
   and at odd sizes, against their plain versions; K9 bitwise equal
   across two launches; time each main shape beside its plain version, a
   library yardstick (``torch.matmul`` with the copy as ``copy_`` on a
   side stream; ``copy_``; timed only) and the bound (operations, HBM
   bytes, NVLink bytes), K9 with its tile, items and waves, with the
   ranks on one card and, where there are cards with peer access, one a
   card; on distinct cards also K10's launch alone and ``copy_`` by CUDA
   events on the sending card (with one card: "not measured");
5. K1, K2, K3: hold the flash-attention forward, fused backward and split
   backward against their plain versions at the training shapes (GPT-3
   1.3B's b 8, s 1024, 16 heads, d 128, Llama-2 7B's b 2, s 4096, 32
   heads, d 128, and ``bench.py``'s seq-2048 sub-bench's b 4, s 2048, 16
   heads, d 128; bf16, causal) and at sq < sk, a ragged s, full
   attention, d 64 and 256, and a sequence past the fused backward's cap
   (the split route); time each at the three training shapes beside its
   plain version, the library's flash attention (forward:
   ``scaled_dot_product_attention``; backward: its aten backward op; both
   timed only) and its bound, and K3 again at the split route's shape
   (where the backward takes it) beside aten's backward and the bound;
5b. K1, K2, K3 at the sequence-parallel shapes of phase 9f, Llama-2 7B's
   attention (32 heads, d 128, bf16, causal) at 1 x 16384: the ring's
   loop over 4 parts without the ring (K1 on each rank's own part,
   causal, and on the earlier ones, merged by their lse in f32; K2 on
   each from the merged out and lse, the gradients summed), K1, K2 and
   K3 at the gspmd mode's sq < sk (4096 queries over 8192 and 16384
   keys), K1 / K3 at ulysses's shape (8 heads over the whole sequence)
   and over the whole sequence and all 32 heads (the one-card run's
   attention), each against the plain versions (run a few heads at a
   time) within the kernel gates; times of the ring's parts, of K1 / K3
   over the whole sequence and at ulysses's shape, beside aten's flash
   attention and the bound;
6. train six paths (bf16, random weights from seed 0, full width and
   depth), one after another, each model freed before the next: GPT-3 1.3B as
   ``bench.py`` configures it (batch 8 x 1024 tokens,
   ``lm_ce_chunks=8``); Llama-2 7B with block recompute (``llama2_7B(
   recompute=True, lm_ce_chunks=8)``: 32 layers, h 4096, 32 heads, ffn
   11008, vocab 32000, untied head) on 2 x 4096 tokens; MoE GPT at
   ``bench.py``'s MoE widths (``gpt3_1p3B(moe_num_experts=8,
   intermediate_size=2816, lm_ce_chunks=8)``, top-2, capacity 1.25, no
   recompute) on 8 x 1024. Each with AdamW (lr 1e-4, weight decay 0.01,
   bf16 first moment, factored second moment) and grad clip 1.0. Every
   layer's attention output on its own q/k/v (and every Llama norm on its
   own input) is held against the plain version; the model-level
   readings, on a 2-layer model of full width the global grad norm and
   three or four parameters' grads, and under no_grad at full depth the
   first step's loss and the final hidden states, are held against the
   same computation in f32 through the plain versions: the kernels may
   be at most 1.25x as far from it as the plain bf16 run (MoE GPT: the
   tokens routed differently by the runs are counted); Llama's 2-layer
   grads with recompute also against the same model without it;
   then a warm-up step and timed steps on one batch, whose loss must
   fall, with every kernel's launches equal to the count derived from the
   model (``step_launches``: K1 L, or 2L with recompute, K2 L, K3 0, K7
   4L + 1 for Llama, 0 for GPT, K4 and K8 0); prints tokens/s, the
   median step, MFU (``bench.py``'s 6N + 6 L h s flops a token against
   989 TFLOP/s, N the MoE experts at 2/E) and peak memory. Then the
   training options of a real run, on GPT-3 1.3B: ``bench.py``'s seq-2048
   sub-bench (4 x 2048, checked as above); its streaming sub-bench
   (fresh 8 x 1024 batches from a seeded numpy generator, stacked by a
   ``ChunkPrefetcher`` into ``run_steps_stream`` chunks of 4 under a
   linear warm-up + cosine schedule: every step's learning rate must be
   the schedule's; ``of_headline`` is its tokens/s over the same-batch
   ``run_steps`` in the same call); and dropout and attention dropout
   0.1, block recompute, 8-bit AdamW moments, gradient merge of 2
   micro-batches of 8 x 1024 and the skip health policy, where on a
   2-layer copy at full width every mask a recomputed block draws is the
   forward's and the grads with recompute on and off are equal (bit for
   bit through the plain versions), a step with a non-finite loss leaves
   every parameter and state tensor bit for bit as it was and warns, the
   launches are K1 (L + recomputed blocks) and K2 L a micro-batch, and
   the 8-bit moments' bytes and a step under the skip policy and under
   none (in turns) are printed. Each of the three checks every layer's
   attention against the plain version;
7. serve GPT-3 1.3B (bf16, bf16 KV pools) and then Llama-2 7B (bf16,
   int8 KV pools), both with random weights from seed 0 at full width and
   depth, each with ``ServingEngine(max_slots=8, block_size=16,
   num_blocks=2048, prefill_chunk=128)``: 12 greedy requests of 64-1024
   prompt tokens, two of them sharing a 512-token prefix, 32 new tokens
   each; Llama again on seeds 1 and 2 (its own weights and trace each).
   The first step's logits and final hidden states are held against the
   same step through the plain versions of every kernel, and the
   residual stream's drift between the two is printed layer by layer;
   every stream must reach its length, the prefix cache must hit,
   ``shutdown()`` must find no leaked block, and each step must have
   launched, per layer, K4 once and K7's LayerNorm twice (GPT) or K5 once
   and K7's RMSNorm twice (Llama), plus one norm before the head, all but
   the first of them in the fused form (the residual update, then the
   norm); the first step's elementwise launches are counted around it
   and again with the updates unfused (4L more for GPT, 2L for Llama);
7b. the two-program layout, ``ServingEngine(..., ragged="off")``, on the
   same seed-0 models (no new initialisation) and trace, GPT-3 1.3B over
   bf16 pools and Llama-2 7B over int8 pools: every model pass (a
   prefill chunk or a decode batch) launches K6 (GPT) or K6-q8 (Llama)
   once a layer and K7 2L + 1 times (2L fused), K4 and K5 never; the
   first prefill chunk and the first decode batch with two live rows are
   held against the same step through the plain versions of every
   kernel, and their elementwise launches counted, as in 7;
   K6's launches are printed split into prefill chunks and decode
   batches; the share of greedy tokens equal to the ragged layout's
   stream is printed, not checked;
8. profiles (torch.profiler) of each training path's steps and of
   engine steps of both models in both layouts: device busy share and
   the kernels with the most device time; for training also the time of
   every kernel but the GEMMs and K1-K3 split by the operation that
   launched them (AdamW's update, LayerNorm, RMSNorm, gelu, SwiGLU's
   silu, MoE routing, the chunked lm-head CE, other), from the
   profiler's tree of CPU operations, and Llama's recompute (every
   kernel a block's forward launches again in the backward) by group;
9a. the MoE path at ``bench.py``'s configuration (bf16, random weights
   from seed 0): ``fused_moe`` on x [1, 8192, 2048] with a [2048, 8]
   router weight launches K8 twice, and is held against the same op
   through K8's plain version and, on 256 tokens, against a dense f32
   reference that shares no code with ``sort_dispatch``; then
   ``bench.py``'s timing (``moe_ffn_sorted`` chained 8 and 24 times,
   step = (t24 - t8) / 16; K8 with the dispatch's row counts): step ms,
   TFLOP/s by its flops count against 989, peak memory;
9d. (after 9a) the decode paths. K1 at a prefill's shape (b 8, s 128,
   16 heads, d 128, causal) and at one query a row over a 320-key cache
   (b 8), held against the plain version and timed a call in a CUDA
   graph beside it, aten's SDPA and the bound. Then ``bench.py``'s decode
   sub-bench on GPT-3 1.3B (bf16, random weights from seed 0, 8 prompts
   of 128 tokens from ``np.random.default_rng(2)``): ``generate`` in
   tiers bf16, int8_kv8 and int4_kv8 over its two-point window (64 and
   192 new tokens, each after a warm-up call: ms a step = (t192 - t64) /
   128), tokens/s, the bound of a step (the served weights and the
   whole 320-slot cache read once over 3.35 TB/s), peak memory and the
   quantized tree's bytes; each tier's prefill and first-step logits
   held within LOGITS_TOL against the same calls through the plain
   versions of K1 and K7, 16 decode steps profiled (busy share, copies
   and casts a step: the weight dequantization); a 64-token greedy
   generate launches K1 L and K7 (2L + 1) a token, every count 0 just
   before it, and its agreement with the plain versions' stream is
   printed; ``speculative_generate`` (int8 weights and KV, gamma 4, 6
   draft layers, 128 new: tokens/s raw, ``mean_accepted``); on a 2-layer
   copy at full width in f32, bit for bit: speculative tokens equal
   ``generate``'s (fp and int8_kv8), the eager ``forward(caches=...)``
   loop's equal ``generate``'s with K1 launched L a call, and
   ``generate`` and ``beam_search`` equal the plain versions'. Then
   Llama-2 7B (bf16, seed 0): ``generate`` at b 8 in bf16 and int8_kv8
   over a 64-step window (16 -> 80 new), its launches, ``beam_search``
   (4 beams, b 2, 32 new) seconds, and the same exact checks on its
   2-layer f32 copy;
9b. the TP path at ``bench.py``'s ``_tp_overlap_result`` configuration
   (f32, x [16384, 4096], w [4096, 1024]), mp 2 then 4:
   ``sharded_all_gather_matmul`` and autograd of ``sum(out)`` launch K9
   size x (size - 1) times forward and never backward, out, dx and dw
   within rtol = atol = 1e-4 of the serial composition (gather, then
   ``torch.matmul``), ``sharded_matmul_reduce_scatter`` likewise; then
   ``bench.py``'s timing: the serial step against the ring, and the
   speedup;
9c. the compiled pipeline at ``bench.py``'s ``_multichip_result`` device
   leg (GPT-3 1.3B widths, bench.py's pure-function transformer, 8
   micro-batches of 1 x 1024, SGD 0.01, f32, weights from
   ``np.random.default_rng(0)``): S 2 (12 blocks a stage on two cards, 4
   when the stages share one), and S 4 at 6 a stage on four cards; the
   first loss and stage 0's gradients held against the same blocks run
   one after another on one card (1e-4), then a warm-up and 4 timed
   steps whose loss must fall, K10 launched S (M+S-1) + S (M+S-2) times a
   step; tokens/s, ``bench.py``'s MFU formula against 67 TFLOP/s f32,
   peak memory a card;
9e. (after 9c) sharded training, ``TrainStep(mesh=..., fsdp_axis="dp")``
   one process a card (``distributed.spawn``, NCCL): on four cards,
   Llama-2 7B (BASELINE #5: dp 2 x mp 2, recompute, bf16, AdamW bf16 m
   and factored v, clip 1.0, 4 x 4096 tokens, 4 steps) against one card
   (rank 0 alone first, the same weights and batch: the first loss within
   MESH_LOSS_RTOL, each later one within MESH_LATER_LOSS_RTOL of the
   card's, the parameters within MESH_PARAM_RTOL in relative L2 and their
   difference within MESH_UPDATE_RTOL of the card's update), and GPT-3
   13B (mp 2 x dp 2, recompute, bf16, 8 x 2048, 4 steps: finite,
   falling losses); before them, 2-layer f32 copies of both at full width, 3 steps on a
   new batch each, on each run's mesh against one card (losses and every
   gathered weight, m, vr and vc within MESH_EXACT_RTOL, biases within
   MESH_BIAS_RTOL, the qkv bias's key third within 3 lr). Each rank's K1
   / K2 (and Llama's K7) launches must equal ``step_launches``; printed
   beside the card: tokens/s, median step, MFU (6N + 6 L h s flops a
   token against 989 TFLOP/s times the cards), every card's peak memory,
   NCCL's share of rank 0's device time over one more profiled step;
9f. (in 9e's spawn, after it) sequence parallelism, ``TrainStep`` on
   meshes with an ``sp`` axis: on four cards Llama-2 7B (bf16,
   recompute, 8 CE chunks, AdamW bf16 m and factored v, clip 1.0, lr
   1e-4) on 1 x 16384 tokens, 4 steps, in ring mode on sp 4 (K1 / K2 on
   4096-token parts) and in ulysses mode on sp 2 x mp 2 (K1 / K3 on 8
   heads over 16384), both against one run on one card (rank 0 alone
   first, kept for both) within 9e's bf16 bounds; before them 2-layer
   f32 copies at full width on 4 x 512 tokens, 3 steps, against one card
   within MESH_EXACT_RTOL: gspmd on dp 2 x sp 2 with FSDP over dp
   (GPT-3 1.3B), ring on sp 4 and ulysses on sp 2 x mp 2 (Llama-2 7B).
   Every rank's K1 / K2 / K3 / K7 launches must equal its own count
   (``mesh_step_launches``: the ring's rank r runs r + 1 parts); printed
   as in 9e, with each rank's median step, its device time outside NCCL
   over the profiled step, and the ranks' skew ((max - min) / max of
   it);
9. one JSON line with the six training paths' numbers, one with the
   MoE numbers, one with the serving numbers, one with the decode
   numbers, one with the mesh numbers, one with the TP and pipeline
   numbers, then one listing every ported kernel with its numbers
   (``--phases ring``: the last two only; ``--phases mesh`` / ``sp``:
   one line with the mesh numbers, and with ``sp`` phase 5b's);
10. last line: ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA device is present.
"""
import argparse
import dataclasses
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet, at 700 W
BF16_FLOPS_PER_S = 989e12       # dense bf16 tensor-core peak, same source
F32_FLOPS_PER_S = 67e12         # f32 outside the tensor cores, same source
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
# K1 in f32 (FFMA, f32 p) at one query a row, as the 2-layer f32 copies'
# cached forward loops call it: as tests/test_torch_kernels_cuda.py's f32
# limit, 1e-3 of a row's RMS; the same rows with the last key left out
# are printed beside it and must read above it.
FLASH_F32_ROW_TOL = 1e-3
# training phase, kernels vs plain versions (bf16 weights and
# activations; the two round p, and Llama's norms, at different places).
# Held directly: every layer's attention output on its own q/k/v within
# FLASH_ROW_TOL, every Llama norm call on its own input within NORM_REL.
# The model-level readings (the first-step loss and the final hidden
# states at full depth under no_grad; a 2-layer model's global grad norm
# and three or four grads) are held against the same computation in f32
# through the plain versions, the weights cast: the kernels' error
# against it may exceed the plain bf16 run's by TRAIN_VS_PLAIN, plus a
# floor. bf16's own error is what sets the scale: over Llama-2 7B's 32
# layers two correct bf16 runs are 0.068 apart token by token at most
# (median 0.050), its 2-layer grads 0.013-0.024, each run 0.017-0.033
# from f32; in MoE GPT routing is discontinuous (bf16 router logits: a
# near tie of the second and third gate goes either way), so 5564 of 8192
# tokens took other experts in some layer of the two runs, whose 2-layer
# grads are 0.08-0.16 apart and each 0.09-0.19 from f32 (an H100; the
# kernels no farther than the plain run: 0.93-1.06x). GPT-3 1.3B read:
# loss 2.4e-5 apart, hidden 0.0166, grads 0.0076-0.0083.
# For Llama the 2-layer grads with recompute are also held against the
# same model without it: the same kernels, but K2's dq atomics (relative
# L2 within TRAIN_GRAD_RTOL, the norm within TRAIN_GNORM_RTOL).
TRAIN_VS_PLAIN = 1.25
TRAIN_GRAD_RTOL = 2e-2
TRAIN_GNORM_RTOL = 1e-3
# the floors: the first-step loss 1e-3 absolute and the grad norm 1e-3
# relative (GPT-3 1.3B's kernels vs plain limits when the plain run was
# the reference; MoE GPT's grad norm read 1.03e-3 from f32 against the
# plain run's 6.7e-4), the hidden states and the grads 2e-3 relative L2
TRAIN_FLOOR = {"loss": 1e-3, "hidden": 2e-3, "grad": 2e-3,
               "gnorm": TRAIN_GNORM_RTOL}
TRAIN_STEPS = 6
# K5 against its plain version, row by row (see row_err): both decode the
# same int8 rows to the same f32 values; the difference is the online
# against the direct softmax and the bf16 output's rounding. Also held,
# for K4 and K5, on every layer's attention of the serving steps' first
# step on its own inputs.
PAGED_ROW_TOL = 6e-2
# K7 against its plain versions, element by element: |got - want| <=
# rel * |want| + NORM_ROW_FLOOR * RMS of want's row. bf16: rel 2^-7, one
# bf16 ulp (f32 values that differ in the last bits may round to either
# side of a boundary); f32: rel 1e-5. The row floor, far below either,
# covers LayerNorm's x - mu where x is within rounding of mu.
NORM_REL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
NORM_ROW_FLOOR = 1e-6
# serving, first step through the kernels vs the plain versions of every
# kernel (attention and norms): final hidden states and logits per token
# in relative L2 (the head is linear after a norm, so the two read alike),
# printed beside how far a step whose attention returns zeros is, and the
# logits element by element. GPT-3 1.3B, bf16 pools, read on an H100:
# hidden 0.0145, logits 0.0149 (relative L2) and 0.0703 (max abs).
SERVE_HIDDEN_RTOL = 4e-2
# Llama-2 7B over int8 pools, read on an H100 with seeds 0, 1 and 2
# (weights and trace): hidden 0.0547 / 0.0537 / 0.0529 while attention
# moves them by 1.37; logits 0.0546 / 0.0537 / 0.0529 (relative L2) and
# 0.332 / 0.344 / 0.336 (max abs, |logit| <= 6.69). The residual stream's
# drift grows layer by layer from 0.004 after layer 0 (a bf16 ulp) to
# those values, and reads 0.048-0.050 for the same step over bf16 pools:
# bf16 roundings of the two paths accumulating over 32 layers, not int8
# code flips. Limits ~1.5x the largest reading; each layer's attention
# and each norm on its own inputs is held tightly beside them
# (PAGED_ROW_TOL, NORM_REL).
LLAMA_HIDDEN_RTOL = 8e-2
# The decode phase holds the same model's prefill last-row and first-step
# logits (bf16 KV cache and int8_kv8) to the same max-abs limit: read on
# an H100, 0.3438 / 0.3047 (bf16) and 0.3696 / 0.375 (int8_kv8) max abs;
# 0.0577 / 0.0494 and 0.0647 / 0.0558 relative L2, beside those of
# GPT-3 1.3B there, 0.0141-0.0159, held to SERVE_HIDDEN_RTOL.
LLAMA_LOGITS_TOL = dict(rtol=0, atol=0.5)
# relative L2 of the Llama decode logits: ~1.5x the largest reading above
LLAMA_DECODE_LOGITS_RTOL = 1e-1
SERVE_ENGINE = dict(max_slots=8, block_size=16, num_blocks=2048,
                    prefill_chunk=128)


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


def graph_ms(fn, iters=20, reps=10):
    """Device milliseconds per call of ``fn``: ``iters`` calls captured
    in one CUDA graph, replayed ``reps`` times between CUDA events. A
    replay launches the calls without the host, so where a call's host
    time exceeds its device time (a norm at a serving step's 136 rows)
    this reads the device's time per call, the gaps between a graph's
    kernels included; back-to-back calls from the host (``cuda_ms``)
    read the host's time instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (iters * reps)


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
    written once) and the flops it must do, for this case's data. A key
    row of an int8 pool is d codes and one f32 scale."""
    q, kp, _, bt, cl, ql, _ = case
    n_tokens, n_heads, d = q.shape
    quant = isinstance(kp, dict)
    n_kv, _, page, _ = (kp["q8"] if quant else kp).shape
    row_bytes = d + 4 if quant else d * kp.element_size()
    window = bt.shape[1] * page
    cl_h = cl.cpu().numpy().astype(np.int64)
    ql_h = ql.cpu().numpy().astype(np.int64)
    live = ql_h > 0
    kv_bytes = int(np.minimum(cl_h[live], window).sum()) * n_kv * \
        row_bytes * 2
    q_bytes = int(ql_h.sum()) * n_heads * d * q.element_size()
    out_bytes = n_tokens * n_heads * d * q.element_size()
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
        # every row at GPT-3's 2048-token context: four splits a row
        "long": ([1] * 8, [2048] * 8, 16, 16),
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
        # device time a call in a CUDA graph: a wrapper call costs more
        # host time than the kernels' device time (host_ms: back to back)
        ms = graph_ms(lambda: ragged_paged_attention(*case))
        host_ms = cuda_ms(lambda: ragged_paged_attention(*case), iters=20)
        plain_ms = cuda_ms(lambda: ragged_paged_attention_ref(*case),
                           iters=3, warmup=1)
        qp, kg, vg, mask = sdpa_inputs(case)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = graph_ms(lambda: sdpa(qp, kg, vg, attn_mask=mask))
        del qp, kg, vg, mask
        nbytes, flops = work_of(case)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        results[name] = dict(
            max_abs_err=err, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, flops=flops)
        print("K4 %-9s T=%d rows=%d heads=%d/%d: max_abs_err=%.3g "
              "kernel=%.4f ms (graph; %.4f ms back to back) plain=%.4f ms "
              "sdpa=%.4f ms (graph) bound=%.4f ms (%s, %.1f MB, %.2f GFLOP) "
              "[%s]"
              % (name, case[0].shape[0], len(ql), nh, nkv, err, ms, host_ms,
                 plain_ms, library_ms, bound_ms,
                 results[name]["bound_by"], nbytes / 1e6, flops / 1e9,
                 card), flush=True)
        del case, got, want
    return results


# ------------------------------------------------------------ phase 4
def q8_case(case):
    """The same batch over int8 pools: the bf16 pools quantized by the
    engine's write rule (one f32 scale per key row)."""
    from paddle_tpu_torch.incubate.nn.cuda.paged_attention import (
        quantize_kv_pages)

    q, kp, vp, *meta = case
    return (q, quantize_kv_pages(kp), quantize_kv_pages(vp), *meta)


def q8_kernel_phase(card):
    """K5 against its plain version at the Llama-2 7B serving shapes (32
    heads, d 128, page 16, bf16 q, int8 pools, a 136-token axis of 8
    rows), in K4's prefill / decode mixes plus GQA groups 4 and 8, d 64
    and 8 decode rows at 4096 keys; times K5 and K4 over the bf16 pool of
    the same mix (a call in a CUDA graph), the plain version, SDPA over
    pre-gathered and pre-dequantized K/V (timed only, in a CUDA graph),
    and the bound."""
    from paddle_tpu_torch.incubate.nn.cuda.paged_attention import (
        _dequant, ragged_paged_attention, ragged_paged_attention_ref)

    rng = np.random.RandomState(2)
    gen = torch.Generator(device="cuda").manual_seed(2)
    decode_cl = [2048] + rng.randint(1, 2049, 7).tolist()
    mixes = {
        # name: (query_lens, context_lens, n_heads, n_kv, head_dim)
        "decode": ([1] * 8, decode_cl, 32, 32, 128),
        "mixed": ([128] + [1] * 7,
                  [640] + rng.randint(1, 2049, 7).tolist(), 32, 32, 128),
        "idle_rows": ([1, 0, 1, 0, 37, 0, 1, 0],
                      [300, 0, 1500, 0, 37, 0, 2048, 0], 32, 32, 128),
        "padding": ([60, 1, 1, 1, 0, 0, 0, 0],
                    [60, 17, 999, 2048, 0, 0, 0, 0], 32, 32, 128),
        "gqa4": ([100] + [1] * 7,
                 [612] + rng.randint(1, 2049, 7).tolist(), 32, 8, 128),
        "gqa8": ([100] + [1] * 7,
                 [612] + rng.randint(1, 2049, 7).tolist(), 32, 4, 128),
        "d64": ([128] + [1] * 7,
                [640] + rng.randint(1, 2049, 7).tolist(), 32, 32, 64),
        # every row at Llama-2's 4096-token context, a 4096-key window
        "long": ([1] * 8, [4096] * 8, 32, 32, 128, 4096),
    }
    results = {}
    for name, (ql, cl, nh, nkv, d, *window) in mixes.items():
        fp = make_case(rng, gen, ql, cl, nh, nkv, d=d,
                       max_len=window[0] if window else 2048)
        case = q8_case(fp)
        n_live = int(sum(ql))
        before = (ragged_paged_attention.launches,
                  ragged_paged_attention.launches_q8)
        got = ragged_paged_attention(*case)
        want = ragged_paged_attention_ref(*case)
        torch.cuda.synchronize()
        check((ragged_paged_attention.launches,
               ragged_paged_attention.launches_q8)
              == (before[0], before[1] + 1),
              "%s: the int8 pools did not launch K5 alone" % name)
        check(bool(torch.isfinite(got).all()), "K5 %s: non-finite" % name)
        check(bool((got[n_live:] == 0).all()),
              "K5 %s: padding tokens are not exactly zero" % name)
        err, rel = row_err(got[:n_live], want[:n_live])
        check(rel <= PAGED_ROW_TOL, "K5 %s: max abs err %.4g, %.4g of its "
              "row's RMS > %g" % (name, err, rel, PAGED_ROW_TOL))
        # device time a call in a CUDA graph, as in phase 3
        ms = graph_ms(lambda: ragged_paged_attention(*case))
        host_ms = cuda_ms(lambda: ragged_paged_attention(*case), iters=20)
        plain_ms = cuda_ms(lambda: ragged_paged_attention_ref(*case),
                           iters=3, warmup=1)
        k4_ms = graph_ms(lambda: ragged_paged_attention(*fp))
        deq = [_dequant(p["q8"], p["s"]).bfloat16() for p in case[1:3]]
        qp, kg, vg, mask = sdpa_inputs((case[0], *deq, *case[3:]))
        del deq
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = graph_ms(lambda: sdpa(qp, kg, vg, attn_mask=mask))
        del qp, kg, vg, mask
        nbytes, flops = work_of(case)
        bound_ms, bound_by = bound_of(nbytes, flops)
        results[name] = dict(
            max_abs_err=err, row_err=rel, ms=ms, host_ms=host_ms,
            plain_ms=plain_ms, library_ms=library_ms, k4_bf16_ms=k4_ms,
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)
        print("K5 %-9s T=%d rows=%d heads=%d/%d d=%d: max_abs_err=%.3g "
              "(%.3e of its row's RMS) kernel=%.4f ms (graph; %.4f ms back "
              "to back) plain=%.4f ms sdpa=%.4f ms (graph) K4 on the bf16 "
              "pool=%.4f ms (graph) bound=%.4f ms (%s, %.1f MB, %.2f GFLOP) "
              "[%s]"
              % (name, case[0].shape[0], len(ql), nh, nkv, d, err, rel, ms,
                 host_ms, plain_ms, library_ms, k4_ms, bound_ms, bound_by,
                 nbytes / 1e6, flops / 1e9, card), flush=True)
        del fp, case, got, want
        torch.cuda.empty_cache()
    return results


def norm_ratio(got, want, rel):
    """Largest |got - want| over its allowance, rel * |want| plus
    NORM_ROW_FLOOR of the RMS of want's row (<= 1 passes)."""
    w = want.float()
    rms = w.square().mean(-1, keepdim=True).sqrt()
    allow = rel * w.abs() + NORM_ROW_FLOOR * rms + 1e-30
    return ((got.float() - w).abs() / allow).max().item()


# K7's cases: name -> (norm kind, the fused form's adds: None, "res" or
# "bias+res"); the fused forms are the serving adapters' residual updates
# (Llama: the residual alone; GPT: the linear's bias, then the residual)
NORM_KINDS = {"rms": ("rms", None), "rms_bias": ("rms_bias", None),
              "ln": ("ln", None), "rms+res": ("rms", "res"),
              "ln+bias+res": ("ln", "bias+res")}
NORM_ROWS = (1, 12, 136, 8192, 1001)
NORM_FUSED_ROWS = (12, 136)


def norm_phase(card):
    """K7 against its plain versions: RMSNorm with and without a bias
    and LayerNorm, bf16 and f32, at d 4096 (Llama-2 7B) and 2048 (GPT-3
    1.3B), on 1 and 12 rows (decode batches), 136 (a serving step's token
    axis), 8192 (a training batch) and 1001 (ragged); and the fused form
    the serving adapters call (the residual update, then the norm) at 12
    and 136 rows, its sum bitwise equal to PyTorch's adds. Times each
    beside its plain version, the library call (``F.rms_norm`` /
    ``F.layer_norm``, timed only; none computes RMSNorm plus a bias, or
    the fused form, in one call) and the bytes bound. At a serving step's
    rows a call's host time exceeds its device time, so the kernel, plain
    and library times are device times per call in a CUDA graph
    (``graph_ms``); ``call_ms`` and ``library_call_ms`` are a call back
    to back from the host (CUDA events), what an eager caller pays. Prints
    the form (a block a row or persistent) and the blocks each case
    takes."""
    from paddle_tpu_torch.incubate.nn.cuda import norms as kn

    F = torch.nn.functional
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        for d in (4096, 2048):
            g = torch.Generator(device="cuda").manual_seed(d)
            w = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")) \
                .to(dtype)
            b = (0.1 * torch.randn(d, generator=g, device="cuda")).to(dtype)
            lin_b = (0.1 * torch.randn(d, generator=g, device="cuda")) \
                .to(dtype)
            for n in NORM_ROWS:
                x = (1.5 * torch.randn(n, d, generator=g, device="cuda")
                     + 0.3).to(dtype)
                res = (1.5 * torch.randn(n, d, generator=g, device="cuda")
                       ).to(dtype)
                for kind, (base, adds) in NORM_KINDS.items():
                    if adds is not None and n not in NORM_FUSED_ROWS:
                        continue
                    results[norm_name(kind, dtype, d, n)] = norm_case(
                        kn, F, kind, base, adds, x, w, b, lin_b, res, card)
    return results


def norm_name(kind, dtype, d, n):
    return "%s %s d %d n %d" % (kind, str(dtype)[6:], d, n)


def norm_case(kn, F, kind, base, adds, x, w, b, lin_b, res, card):
    """One K7 case (see :func:`norm_phase`): checked, timed, printed."""
    n, d = x.shape
    dtype = x.dtype
    kw = {} if adds is None else dict(
        residual=res, bias=lin_b if adds == "bias+res" else None)
    if base == "ln":
        fn, ref, args = kn.layer_norm, kn.layer_norm_ref, (x, w, b, 1e-5)
        lib = lambda: F.layer_norm(x, (d,), w, b, 1e-5)
    else:
        bias = b if base == "rms_bias" else None
        fn, ref, args = kn.rms_norm, kn.rms_norm_ref, (x, w, bias, 1e-5)
        lib = None if bias is not None else \
            (lambda: F.rms_norm(x, (d,), w, 1e-5))
    if adds is not None:
        lib = None
    name = norm_name(kind, dtype, d, n)
    got, want = fn(*args, **kw), ref(*args, **kw)
    torch.cuda.synchronize()
    if adds is not None:
        (got, got_sum), (want, want_sum) = got, want
        check(torch.equal(got_sum, want_sum), "K7 %s: the sum is not "
              "bitwise PyTorch's adds" % name)
    check(bool(torch.isfinite(got).all()), "K7 %s: non-finite" % name)
    ratio = norm_ratio(got, want, NORM_REL[dtype])
    err = (got.float() - want.float()).abs().max().item()
    check(ratio <= 1.0, "K7 %s: error %.3g of its allowance" % (name, ratio))
    call_ms = cuda_ms(lambda: fn(*args, **kw), iters=50)
    ms = graph_ms(lambda: fn(*args, **kw))
    plain_ms = graph_ms(lambda: ref(*args, **kw))
    library_ms = None if lib is None else graph_ms(lib)
    library_call_ms = None if lib is None else cuda_ms(lib, iters=50)
    form, blocks, threads, vecs = kn.plan(n, d, base, dtype,
                                          residual=adds is not None)
    # each input read once, each output written once: x (or y and the
    # residual), out (and the sum), w, the norm bias, the added bias
    rows = 2 if adds is None else 4
    vectors = 1 + (base != "rms") + (adds == "bias+res")
    nbytes = (rows * n * d + vectors * d) * x.element_size()
    bound_ms, bound_by = bound_of(
        nbytes, 4 * n * d, BF16_FLOPS_PER_S
        if dtype == torch.bfloat16 else F32_FLOPS_PER_S)
    print("K7 %-30s: max_abs_err %.3g (%.3g of its allowance) kernel=%.4f "
          "ms (a call back to back %.4f ms) plain=%.4f ms library=%s (a "
          "call back to back %s) bound=%.4f ms (%s, %.2f MB); %s, %d blocks "
          "of %d threads x %d vectors%s [%s]"
          % (name, err, ratio, ms, call_ms, plain_ms,
             "none" if library_ms is None else "%.4f ms" % library_ms,
             "none" if library_call_ms is None else "%.4f ms"
             % library_call_ms, bound_ms, bound_by, nbytes / 1e6, form,
             blocks, threads, vecs,
             "" if adds is None else "; sum bitwise PyTorch's adds", card),
          flush=True)
    return dict(max_abs_err=err, ratio=ratio, ms=ms, call_ms=call_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                library_call_ms=library_call_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, form=form, blocks=blocks,
                threads=threads, vectors=vecs)


# ----------------------------------------------------------- phase 4b
# K6 against its plain version: bf16 pools within KERNEL_TOL and int8
# pools within PAGED_ROW_TOL of a row's RMS, the limits K4 and K5 are held
# to in phases 3 and 4; f32 pools within rtol = atol = 2e-4, K4's f32
# limit in tests/test_torch_kernels_cuda.py (online against direct
# softmax, other summation orders).
DECODE_F32_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_SRC = "paddle_tpu_torch/incubate/nn/csrc/paged_attention.cu"


def decode_case(rng, gen, lens, n_heads, n_kv, d=128, page=16,
                shared=False, dtype=torch.bfloat16, dev="cuda"):
    """One K6 batch on the card: q and pools from ``gen``; one query
    token a row with ``lens`` keys each. Shuffled page ids; a row's
    unused block-table tail (all of an empty row's) holds out-of-range
    ids, which the kernel clamps. With ``shared`` every row reads one
    block table, the rows of an off-layout prefill chunk (True: garbage
    only in an empty row's table; "tails": in every row's slots past its
    own pages, each row its own), or ("two") rows alternate between two
    tables."""
    n_rows = len(lens)
    P = -(-max(lens) // page) + 1
    n_tables = {False: n_rows, "two": 2}.get(shared, 1)
    total_pages = n_tables * P + 1
    q = torch.randn(n_rows, n_heads, d, generator=gen, device=dev)
    kp = torch.randn(n_kv, total_pages, page, d, generator=gen, device=dev)
    vp = torch.randn(n_kv, total_pages, page, d, generator=gen, device=dev)
    bt = (1 + rng.permutation(n_tables * P)).reshape(n_tables, P)
    bt = bt[np.arange(n_rows) % n_tables]
    for r, c in enumerate(lens):
        if shared is not True or c == 0:
            bt[r, -(-c // page):] = [-1 - r, total_pages + 5 + r][r % 2]
    bt, cl = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
              for a in (bt, lens))
    return q.to(dtype), kp.to(dtype), vp.to(dtype), bt, cl


def decode_work(case):
    """Bytes K6 must move and the flops it must do for this case's data:
    each distinct K/V row once (a page that several rows of one prefill
    chunk share counts once; an int8 row is d codes and an f32 scale),
    q, out and the metadata; 4 d flops a (query head, key). Also the
    row-by-row bytes (sum of the rows' K/V), what a kernel that shares no
    page between rows reads."""
    q, kp, _, bt, cl = case
    n_rows, n_heads, d = q.shape
    quant = isinstance(kp, dict)
    n_kv, _, page, _ = (kp["q8"] if quant else kp).shape
    row_bytes = d + 4 if quant else d * kp.element_size()
    lens = np.minimum(cl.cpu().numpy().astype(np.int64), bt.shape[1] * page)
    bt_h = bt.cpu().numpy().astype(np.int64).clip(0, None)
    slots = [bt_h[r, np.arange(n) // page] * page + np.arange(n) % page
             for r, n in enumerate(lens) if n > 0]
    distinct = len(np.unique(np.concatenate(slots))) if slots else 0
    kv_bytes = distinct * n_kv * row_bytes * 2
    io = 2 * n_rows * n_heads * d * q.element_size() + \
        4 * (bt.numel() + cl.numel())
    flops = 4 * d * n_heads * int(lens.sum())
    rowwise = int(lens.sum()) * n_kv * row_bytes * 2
    return kv_bytes + io, flops, rowwise + io


def decode_as_ragged(case):
    """The same work as one K4 / K5 call: each live decode row a ragged
    row of one token; a prefill chunk (live rows on one table, each one
    key longer than the one before) one ragged row whose tokens are the
    chunk's live rows."""
    q, kp, vp, bt, cl = case
    live = (cl > 0).nonzero().reshape(-1)
    steps = cl[live] - cl[live[:1]] - torch.arange(len(live), device=q.device)
    if len(live) > 1 and bool((bt[live] == bt[live[:1]]).all()) and \
            bool((steps == 0).all()):
        n = len(live)
        meta = (bt[live[:1]], cl[live[-1:]], torch.tensor(
            [n], dtype=torch.int32, device=q.device))
    else:
        meta = (bt, cl, (cl > 0).to(torch.int32))
    return (q[live].contiguous(), kp, vp) + meta


def decode_sdpa_inputs(case):
    """q [R, h, 1, d] and K/V [R, h, L, d] gathered per live row (GQA kv
    heads repeated), with a boolean key mask: the library yardstick."""
    q, kp, vp, bt, cl = case
    n_rows, n_heads, d = q.shape
    n_kv, total_pages, page, _ = kp.shape
    live = (cl > 0).nonzero().reshape(-1)
    L = bt.shape[1] * page
    mask = (torch.arange(L, device=q.device)[None]
            < cl[live][:, None])[:, None, None]
    bt_live = bt[live].clamp(0, total_pages - 1).long()

    def gather(pages):
        g = pages[:, bt_live].movedim(1, 0).reshape(len(live), n_kv, L, d)
        return g.repeat_interleave(n_heads // n_kv, dim=1)

    return q[live][:, :, None], gather(kp), gather(vp), mask


def decode_kernel_phase(card):
    """K6 against its plain version on the card, over bf16, f32 and int8
    pools (bf16 q over int8), in the off layout's two shapes of call: a
    decode batch (8 rows, contexts drawn from the trace's 64-1056, two
    rows empty, garbage block ids in their tables) and a prefill chunk
    (128 rows of one sequence at positions 896-1023 over one block table,
    the last 20 rows padding of length 0), plus contexts shorter than a
    page; at Llama-2 7B's shapes (32 / 32 heads, d 128), GPT-3 1.3B's
    (16 / 16), GQA groups 4 and 8, d 64 and page 128; and the page-sharing
    mixes (a prefill chunk with garbage past each row's pages, two tables
    in one 16-row tile, padding rows inside the tiles, decode rows of
    2048-4096 keys). Each call twice, bitwise equal. Times K6 and K6-q8
    beside the plain version, a library call (SDPA over K/V gathered per
    row, timed only), K4 / K5 on the same work as one ragged call, and
    the bound, and prints the call's key split and items (row-wise: a
    shared tile counts each row). The kernels and the library call are
    timed per call in a CUDA graph (``graph_ms``: a call's host time
    exceeds a decode batch's device time), the plain version back to back
    from the host."""
    from paddle_tpu_torch.incubate.nn.cuda import paged_attention as pa

    rng = np.random.RandomState(4)
    gen = torch.Generator(device="cuda").manual_seed(4)
    decode_lens = rng.randint(64, 1057, 8)
    decode_lens[[2, 5]] = 0
    decode_lens = decode_lens.tolist()
    prefill_lens = list(range(897, 1005)) + [0] * 20
    long_lens = rng.randint(2048, 4097, 8).tolist()
    mixes = {
        # name: (lens, n_heads, n_kv, head_dim, page, shared)
        "decode": (decode_lens, 32, 32, 128, 16, False),
        "prefill": (prefill_lens, 32, 32, 128, 16, True),
        "short": ([3, 15, 1, 9, 0, 12, 7, 14], 32, 32, 128, 16, False),
        "gpt_decode": (decode_lens, 16, 16, 128, 16, False),
        "gpt_prefill": (prefill_lens, 16, 16, 128, 16, True),
        "gqa4": (decode_lens, 32, 8, 128, 16, False),
        "gqa8": (decode_lens, 32, 4, 128, 16, False),
        "d64": (decode_lens, 32, 32, 64, 16, False),
        "page128": (decode_lens, 32, 32, 128, 128, False),
        # page sharing: rows that see the same pages share one read
        "prefill_tails": (prefill_lens, 32, 32, 128, 16, "tails"),
        "two_tables": (list(range(897, 913)), 32, 32, 128, 16, "two"),
        "empty_in_tile": ([c if i % 5 else 0 for i, c in
                           enumerate(range(897, 1025))], 32, 32, 128, 16,
                          True),
        "long": (long_lens, 32, 32, 128, 16, False),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {}
    for name, (lens, nh, nkv, d, page, shared) in mixes.items():
        fp = decode_case(rng, gen, lens, nh, nkv, d, page, shared)
        live = fp[4] > 0
        f32 = tuple(t.float() for t in fp[:3]) + fp[3:]
        got32 = pa.paged_attention(*f32)
        torch.testing.assert_close(got32, pa.paged_attention_ref(*f32),
                                   **DECODE_F32_TOL)
        q8 = q8_case(fp)
        res = {}
        for route, case in (("K6", fp), ("K6-q8", q8)):
            before = (pa.paged_attention.launches,
                      pa.paged_attention.launches_q8)
            got = pa.paged_attention(*case)
            want = pa.paged_attention_ref(*case)
            torch.cuda.synchronize()
            grew = (pa.paged_attention.launches - before[0],
                    pa.paged_attention.launches_q8 - before[1])
            check(grew == ((1, 0) if route == "K6" else (0, 1)),
                  "K6 %s: launches grew by %s" % (name, grew))
            check(bool(torch.isfinite(got).all()), "%s %s: non-finite"
                  % (route, name))
            check(bool((got[~live] == 0).all()),
                  "%s %s: empty rows are not exactly zero" % (route, name))
            check(torch.equal(got, pa.paged_attention(*case)),
                  "%s %s: two launches differ" % (route, name))
            err, rel = row_err(got[live], want[live])
            if route == "K6":
                torch.testing.assert_close(got.float(), want.float(),
                                           **KERNEL_TOL)
            else:
                check(rel <= PAGED_ROW_TOL, "K6-q8 %s: max abs err %.4g, "
                      "%.4g of its row's RMS > %g"
                      % (name, err, rel, PAGED_ROW_TOL))
            ragged = decode_as_ragged(case)
            same = pa.ragged_paged_attention(*ragged)
            torch.testing.assert_close(got[live].float(), same.float(),
                                       **KERNEL_TOL)
            # a call's host time (~0.05 ms) exceeds a small batch's device
            # time: the kernels and the library call are timed in a CUDA
            # graph (device time per call), the plain version from the host
            ms = graph_ms(lambda: pa.paged_attention(*case))
            call_ms = cuda_ms(lambda: pa.paged_attention(*case), iters=20)
            plain_ms = cuda_ms(lambda: pa.paged_attention_ref(*case),
                               iters=3, warmup=1)
            ragged_ms = graph_ms(lambda: pa.ragged_paged_attention(*ragged))
            if route == "K6":
                lib_case = case
            else:
                lib_case = (case[0],) + tuple(
                    pa._dequant(p["q8"], p["s"]).bfloat16()
                    for p in case[1:3]) + case[3:]
            qs, kg, vg, mask = decode_sdpa_inputs(lib_case)
            del lib_case
            library_ms = graph_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask))
            del qs, kg, vg, mask
            nbytes, flops, rowwise = decode_work(case)
            bound_ms, bound_by = bound_of(nbytes, flops)
            window = case[3].shape[1] * page
            split = pa.decode_split(len(lens), nh, nkv, window)
            items = dict(split=split, splits=-(-window // split),
                         items=len(lens) * nkv * -(-window // split),
                         live_items=nkv * sum(-(-min(c, window) // split)
                                              for c in lens))
            res[route] = dict(
                max_abs_err=err, row_err=rel, ms=ms, call_ms=call_ms,
                plain_ms=plain_ms,
                library_ms=library_ms, ragged_ms=ragged_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                rowwise_bytes=rowwise, flops=flops, **items)
            print("%-5s %-13s rows=%d heads=%d/%d d=%d page=%d: max_abs_err="
                  "%.3g (%.3e of its row's RMS), bitwise equal across "
                  "launches; kernel=%.4f ms (a call back to back %.4f ms) "
                  "plain=%.4f ms sdpa=%.4f ms %s on the same work=%.4f ms "
                  "bound=%.4f ms (%s, %.1f MB distinct, %.1f MB row by row, "
                  "%.3f GFLOP); %d-key splits x %d, %d items, %d live row "
                  "by row [%s]"
                  % (route, name, len(lens), nh, nkv, d, page, err, rel, ms,
                     call_ms, plain_ms, library_ms,
                     "K4" if route == "K6" else "K5", ragged_ms, bound_ms,
                     bound_by, nbytes / 1e6, rowwise / 1e6, flops / 1e9,
                     split, items["splits"], items["items"],
                     items["live_items"], card), flush=True)
            del got, want, same, ragged
        err32 = (got32.float() - pa.paged_attention_ref(*f32)).abs().max()
        res["K6 f32"] = dict(max_abs_err=err32.item())
        print("K6    %-13s f32 pools: max_abs_err=%.3g (limit rtol = atol = "
              "2e-4) [%s]" % (name, err32.item(), card), flush=True)
        results[name] = res
        del fp, f32, q8, got32
        torch.cuda.empty_cache()
    return results


# ----------------------------------------------------------- phase 4c
MOE_SRC = "paddle_tpu_torch/incubate/nn/csrc/moe_dispatch.cu"
# K8 against its plain version. bf16 row by row (see row_err): the two sum
# the same bf16 products in f32 and round once, so they differ where the
# two f32 sums straddle a bf16 rounding boundary: one bf16 ulp, at most
# 2^-7 of a row's largest value, which in a Gaussian row of a few thousand
# values is up to ~5x the row's RMS: 0.04 of the RMS. Read on an H100 at
# 0.0002-0.0289 (bench.py's ffn2 the largest). A column or a K tile left
# out reads 0.3 or more. f32 (FFMA against an f32 matmul summed in another
# order): rtol = atol = 2e-4, read at most 2.3e-6.
GMM_ROW_TOL = 4e-2
GMM_F32_TOL = dict(rtol=2e-4, atol=2e-4)
# bench.py's _bench_moe step: 8192 tokens x 2048, 8 experts, SwiGLU dff
# 2816, top-2, bf16, weights 0.02 x N(0, 1)
MOE_BENCH = dict(tokens=8192, hidden=2048, dff=2816, experts=8, topk=2)
# Mixtral-8x7B-v0.1's layer widths (Mistral AI's config.json: hidden_size
# 4096, intermediate_size 14336, num_local_experts 8,
# num_experts_per_tok 2)
MIXTRAL = dict(hidden=4096, dff=14336, experts=8, topk=2)


def moe_problem(tokens, hidden, dff, experts, seed=0, dtype=torch.bfloat16,
                **_):
    """Seeded tokens, router weight and expert weights on the card, in
    the JAX op's layouts: x [S, M], gate [M, E], w1 [E, M, 2 dff], w2
    [E, dff, M]; 0.02 x N(0, 1) weights as bench.py draws them."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape, scale=0.02):
        return (scale * torch.randn(*shape, generator=g, device="cuda")) \
            .to(dtype)

    x = draw(tokens, hidden, scale=1.0)
    return (x, draw(hidden, experts), draw(experts, hidden, 2 * dff),
            draw(experts, dff, hidden))


def moe_routing(x, gate, k):
    """The op's router (``fused_moe``: softmax in f32 of ``x @ gate``)
    and the sort_dispatch of its top-k."""
    from paddle_tpu_torch.incubate.nn.cuda import moe_dispatch as kmd

    probs = torch.softmax((x @ gate).float(), -1)
    return probs, kmd.sort_dispatch(x, probs, k)


def gmm_work(xp, w, gid, group_sizes=None):
    """Bytes and flops the grouped product needs on these inputs: the real
    rows of xp (every row when the map does not come from sort_dispatch),
    the weights of the experts that have real rows, the output's real
    rows; 2 K N flops a real row."""
    p, k = xp.shape
    e, _, n = w.shape
    if group_sizes is None:
        real = p
        touched = len(set(gid.clamp(0, e - 1).tolist()))
    else:
        real = int(group_sizes.sum())
        touched = int((group_sizes > 0).sum())
    nbytes = (real * k + touched * k * n + real * n) * xp.element_size() \
        + gid.numel() * 4
    return nbytes, 2 * real * k * n, real, touched


def gmm_library(xp, w, gid):
    """One PyTorch call computing the same function, timed only and never
    called by the port: ``torch._grouped_mm`` over the padded groups for
    bf16, per-expert ``torch.matmul`` over them for f32 (``_grouped_mm``
    takes bf16 only). The groups are sort_dispatch's: nondecreasing block
    ids, so each expert's rows are contiguous."""
    from paddle_tpu_torch.incubate.nn.cuda import moe_dispatch as kmd

    e = w.shape[0]
    sizes = torch.bincount(gid.long(), minlength=e) * kmd.BM
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    if xp.dtype == torch.bfloat16:
        return lambda: torch._grouped_mm(xp, w, offs=offs)
    ends = offs.tolist()
    spans = list(zip([0] + ends[:-1], ends))
    return lambda: torch.cat([xp[a:b] @ w[i] for i, (a, b) in
                              enumerate(spans)])


def gmm_host_costs(xp, w, gid, rows, iters=200):
    """Host microseconds a bf16 K8 call spends before its kernel runs:
    encoding its three TMA tensor maps (in C, the mean of ``iters``
    encodings), and a whole wrapper call (checks, encodings, launch)
    timed by the host clock over calls that only enqueue."""
    from paddle_tpu_torch.incubate.nn.cuda import moe_dispatch as kmd

    p, k = xp.shape
    e, _, n = w.shape
    out = torch.empty(p, n, dtype=xp.dtype, device=xp.device)
    encode_us = kmd._bind().gmm_encode_us(xp.data_ptr(), w.data_ptr(),
                                          out.data_ptr(), p, k, n, e, iters)
    check(encode_us >= 0, "K8: a tensor map did not encode")
    torch.cuda.synchronize()
    calls = 20
    t0 = time.perf_counter()
    for _ in range(calls):
        kmd.grouped_matmul(xp, w, gid, rows=rows)
    call_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return encode_us, call_us


def gmm_case_check(name, xp, w, gid, card, group_sizes=None, timed=True,
                   rows=None, dispatched=True):
    """One K8 call against its plain version, bitwise equal across two
    launches (and its time, the plain version's, the library call's and
    the bound's when ``timed``). With ``rows`` the call with them is held
    against the plain version with them; when they are a dispatch's own
    counts (``dispatched``, as ``moe_ffn_sorted`` passes them: pad rows
    are zero) it must also equal the call without them, and both are
    timed. Returns the K8 output and the readings."""
    from paddle_tpu_torch.incubate.nn.cuda import moe_dispatch as kmd

    before = kmd.grouped_matmul.launches
    got = kmd.grouped_matmul(xp, w, gid, rows=rows)
    want = kmd.grouped_matmul_ref(xp, w, gid, rows=rows)
    torch.cuda.synchronize()
    grew = kmd.grouped_matmul.launches - before
    check(grew == 1, "K8 %s: launches grew by %d" % (name, grew))
    check(bool(torch.isfinite(got).all()), "K8 %s: non-finite" % name)
    err, rel = row_err(got, want)
    if xp.dtype == torch.float32:
        torch.testing.assert_close(got, want, **GMM_F32_TOL)
    else:
        check(rel <= GMM_ROW_TOL, "K8 %s: max abs err %.4g, %.4g of its "
              "row's RMS > %g" % (name, err, rel, GMM_ROW_TOL))
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    check(torch.equal(got.view(bits),
                      kmd.grouped_matmul(xp, w, gid, rows=rows).view(bits)),
          "K8 %s: two launches differ" % name)
    if rows is not None and dispatched:
        check(torch.equal(got, kmd.grouped_matmul(xp, w, gid)),
              "K8 %s: the row counts changed the output" % name)
    p, k = xp.shape
    e, _, n = w.shape
    res = dict(max_abs_err=err, row_err=rel, P=p, K=k, N=n, E=e,
               dtype=str(xp.dtype)[6:], row_counts=rows is not None)
    if not timed:
        print("K8 %-22s P=%d K=%d N=%d E=%d %s: max_abs_err=%.3g (%.3e of "
              "its row's RMS), bitwise equal across launches [%s]"
              % (name, p, k, n, e, res["dtype"], err, rel, card),
              flush=True)
        return got, res
    del want
    ms = cuda_ms(lambda: kmd.grouped_matmul(xp, w, gid, rows=rows),
                 iters=20)
    all_rows_ms = ms if rows is None else \
        cuda_ms(lambda: kmd.grouped_matmul(xp, w, gid), iters=20)
    plain_ms = cuda_ms(lambda: kmd.grouped_matmul_ref(xp, w, gid, rows=rows),
                       iters=3, warmup=1)
    library_ms = cuda_ms(gmm_library(xp, w, gid), iters=20)
    nbytes, flops, real, touched = gmm_work(xp, w, gid, group_sizes)
    bound_ms, bound_by = bound_of(
        nbytes, flops, BF16_FLOPS_PER_S if xp.dtype == torch.bfloat16
        else F32_FLOPS_PER_S)
    res.update(ms=ms, all_rows_ms=all_rows_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, flops=flops, real_rows=real,
               experts_touched=touched, tflops=flops / ms / 1e9,
               gb_per_s=nbytes / ms / 1e6,
               padding_blocks=None if rows is None
               else int((rows == 0).sum()))
    line = "K8 %-22s P=%d K=%d N=%d E=%d %s (%d real rows, %d experts" % (
        name, p, k, n, e, res["dtype"], real, touched)
    if rows is not None:
        line += ", %d of %d blocks padding only" % (res["padding_blocks"],
                                                   rows.numel())
    line += "): max_abs_err=%.3g (%.3e of its row's RMS) kernel=%.4f ms " \
            "(%.1f TFLOP/s, %.1f GB/s)" % (err, rel, ms, res["tflops"],
                                           res["gb_per_s"])
    if rows is not None:
        line += " without counts=%.4f ms" % all_rows_ms
    if xp.dtype == torch.bfloat16:
        res["encode_us"], res["host_us"] = gmm_host_costs(xp, w, gid, rows)
        line += " (host: %.2f us to encode the tensor maps, %.1f us a " \
                "call)" % (res["encode_us"], res["host_us"])
    print(line + " plain=%.4f ms library=%.4f ms bound=%.4f ms (%s, %.1f "
          "MB, %.1f GFLOP) [%s]"
          % (plain_ms, library_ms, bound_ms, bound_by, nbytes / 1e6,
             flops / 1e9, card), flush=True)
    return got, res


def swiglu(h):
    g, u = h.chunk(2, dim=-1)
    return torch.nn.functional.silu(g) * u


def moe_kernel_phase(card):
    """K8 against its plain version on the card, on inputs from a real
    sort_dispatch of seed-0 routing: bench.py's MoE step (bf16; P 17408,
    K 2048 x N 5632 then K 2816 x N 2048); Mixtral-8x7B's widths as the
    op serves them, a decode batch of 8 tokens (P 1152, mostly padding
    blocks) and a 2048-token prefill (P 5120), K 4096 x N 28672 then K
    14336 x N 4096; the same routing in f32 at a reduced size; and edges
    in bf16 and f32: N 768, a ragged N, K not a multiple of the K tile, a
    non-monotone block map with ids out of range, all pairs on one
    expert, empty experts, each also with row counts. Each product's
    second input is the first's output through SwiGLU. Times the main
    shapes with and without the dispatch's row counts (CUDA events, back
    to back: a call takes a quarter of a millisecond or more) beside the
    plain version, the library call and the bound."""
    from paddle_tpu_torch.incubate.nn.cuda import moe_dispatch as kmd

    results = {}

    def both(tag, x, gate, w1, w2, k):
        _, d = moe_routing(x, gate, k)
        gs = d["group_sizes"]
        rows = kmd.block_rows(d["block_gid"], gs, d["padded_sizes"])
        h, results[tag + " ffn1"] = gmm_case_check(
            tag + " ffn1", d["xp"], w1, d["block_gid"], card, gs, rows=rows)
        h = swiglu(h).contiguous()
        _, results[tag + " ffn2"] = gmm_case_check(
            tag + " ffn2", h, w2, d["block_gid"], card, gs, rows=rows)

    x, gate, w1, w2 = moe_problem(**MOE_BENCH)
    both("bench", x, gate, w1, w2, MOE_BENCH["topk"])
    del x, gate, w1, w2
    small = dict(MOE_BENCH, tokens=1024, hidden=512, dff=704)
    both("f32 reduced", *moe_problem(**small, dtype=torch.float32),
         small["topk"])
    mx = dict(MIXTRAL, tokens=2048)
    x, gate, w1, w2 = moe_problem(**mx)
    both("mixtral prefill", x, gate, w1, w2, MIXTRAL["topk"])
    both("mixtral decode", x[:8].contiguous(), gate, w1, w2,
         MIXTRAL["topk"])
    del x, gate, w1, w2
    torch.cuda.empty_cache()

    g = torch.Generator(device="cuda").manual_seed(5)
    edges = {
        # name: (K, N, block map, E, top-k, experts that get tokens)
        "n768": (64, 768, [0, 1, 2, 3], 4, 0, None),
        "ragged_n": (96, 200, [1, 0, 2], 4, 0, None),
        "k_tail": (200, 136, [2, 2, 0, 1], 4, 0, None),
        "non_monotone": (64, 256, [2, 0, 3, 3, 1, 0, 5, -2], 4, 0, None),
        "all_on_one_expert": (128, 256, 300, 4, 1, [2]),
        "empty_experts": (128, 256, 300, 8, 2, [1, 6]),
    }
    for dtype in (torch.bfloat16, torch.float32):
        for name, (kd, n, spec, e, k, live) in edges.items():
            w = (torch.randn(e, kd, n, generator=g, device="cuda")
                 / kd ** 0.5).to(dtype)
            if k == 0:
                gid = torch.tensor(spec, dtype=torch.int32, device="cuda")
                xp = torch.randn(len(spec) * kmd.BM, kd, generator=g,
                                 device="cuda").to(dtype)
                # counts with blocks and 64-row halves of no real row
                counts = torch.tensor([0, 1, 63, 64, 65, 128, 200, -3],
                                      dtype=torch.int32,
                                      device="cuda")[:len(spec)]
            else:
                mask = torch.full((e,), -30.0, device="cuda")
                mask[live] = 0.0
                logits = torch.randn(spec, e, generator=g, device="cuda")
                xs = torch.randn(spec, kd, generator=g, device="cuda")
                d = kmd.sort_dispatch(xs.to(dtype),
                                      torch.softmax(logits + mask, -1), k)
                check(int(d["group_sizes"][live].sum()) == spec * k,
                      "K8 %s: the routing missed its experts" % name)
                xp, gid = d["xp"], d["block_gid"]
                counts = kmd.block_rows(gid, d["group_sizes"],
                                        d["padded_sizes"])
            tag = "%s %s" % (name, str(dtype)[6:])
            _, results[tag] = gmm_case_check(tag, xp, w, gid, card,
                                             timed=False)
            _, results[tag + " counts"] = gmm_case_check(
                tag + " counts", xp, w, gid, card, timed=False, rows=counts,
                dispatched=k > 0)
    return results


# ------------------------------------------------------------ phase 5
FLASH_SRC = "paddle_tpu_torch/incubate/nn/csrc/flash_attn.cu"
FLASH_PALLAS = "paddle_tpu/incubate/nn/pallas/flash_attn.py"
# name -> (b, sq, sk, h, d, causal); "train" is GPT training's shape,
# "llama_train" Llama-2 7B training's (s * d at half K2's cap), "seq2048"
# bench.py's seq-2048 sub-bench's (GPT-3 1.3B on 4 x 2048)
FLASH_CASES = {
    "train": (8, 1024, 1024, 16, 128, True),
    "llama_train": (2, 4096, 4096, 32, 128, True),
    "seq2048": (4, 2048, 2048, 16, 128, True),
    "sq_lt_sk": (2, 300, 1024, 16, 128, True),
    "ragged_s": (2, 1000, 1000, 16, 128, True),
    "full": (2, 1024, 1024, 16, 128, False),
    "d64": (2, 512, 512, 16, 64, True),
    "d256": (2, 512, 512, 8, 256, True),
    # sq * d > 8192 * 128: the backward takes K3 (heads cut so that the
    # plain version's [s, s] f32 tiles fit)
    "split_route": (1, 8320, 8320, 2, 128, True),
}


# the shapes phase 5 times (the first is the kernels line's own)
TIMED_FLASH = ("train", "llama_train", "seq2048")


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


def bound_of(nbytes, flops, flops_per_s=BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
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
    timed = {}
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
        if name in TIMED_FLASH:
            timed[name] = time_flash(fa, q, k, v, do, hm, ref_out, ref_lse,
                                     causal, scale, errs, card, name)
        elif name == "split_route":
            split = time_split_route(fa, q, k, v, do, hm, ref_out, ref_lse,
                                     causal, scale, errs["K3"][0], card)
        del q, k, v, do, hm, out, lse, ref_out, ref_lse, ref_grads, grads
        torch.cuda.empty_cache()
    results = timed["train"]
    for kname, r in results.items():
        for other in TIMED_FLASH[1:]:
            r[other] = timed[other][kname]
    results["K3"]["split_route"] = split
    return results


def aten_flash_bwd(hm, causal, scale):
    """A call of aten's flash-attention backward on head-major q, k, v, do
    (after its own forward): the library yardstick of K2 and K3."""
    aten = torch.ops.aten
    lib_out, lib_lse, cq, ck, mq, mk_, seed, offs, _ = \
        aten._scaled_dot_product_flash_attention(
            *hm[:3], 0.0, causal, False, scale=scale)
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        hm[3], *hm[:3], lib_out, lib_lse, cq, ck, mq, mk_, 0.0, causal, seed,
        offs, scale=scale)


def time_split_route(fa, q, k, v, do, hm, out, lse, causal, scale, err,
                     card):
    """K3 where the backward takes it (FLASH_CASES["split_route"]): kernel
    and library ms (CUDA events) and the bound (the plain version is not
    timed at this shape)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    ms = cuda_ms(lambda: fa.flash_bwd_split(q, k, v, out, lse, do, causal,
                                            scale), 10)
    library_ms = cuda_ms(aten_flash_bwd(hm, causal, scale), 10)
    nbytes, flops = flash_work(b, sq, sk, h, d, causal, backward=True)
    bound_ms, bound_by = bound_of(nbytes, flops)
    print("K3 split-route shape (b %d, s %d, %d heads, d %d): kernel=%.4f "
          "ms library=%.4f ms bound=%.4f ms (%s, %.1f MB, %.2f GFLOP) [%s]"
          % (b, sq, h, d, ms, library_ms, bound_ms, bound_by, nbytes / 1e6,
             flops / 1e9, card), flush=True)
    return dict(max_abs_err=err, ms=ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                flops=flops, shape=[b, sq, sk, h, d])


def time_flash(fa, q, k, v, do, hm, out, lse, causal, scale, errs, card,
               name):
    """K1, K2, K3 at a training shape: kernel, plain and library ms
    (CUDA events) and the bound, per kernel."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    lse4 = lse[..., None]                          # [b, h, sq, 1]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    aten_bwd = aten_flash_bwd(hm, causal, scale)
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
               cuda_ms(aten_bwd, 10)),
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
        print("%s %s shape: kernel=%.4f ms plain=%.4f ms library=%.4f "
              "ms bound=%.4f ms (%s, %.1f MB, %.2f GFLOP) [%s]"
              % (kname, name, ms, plain_ms, library_ms, bound_ms, bound_by,
                 nbytes / 1e6, flops / 1e9, card), flush=True)
    print("library scaled_dot_product_attention forward + backward, %s "
          "shape: %.4f ms [%s]" % (name, fwd_bwd_ms, card), flush=True)
    return res


# ----------------------------------------------------------- phase 5b
# The sequence-parallel shapes of K1-K3: Llama-2 7B's attention (32
# heads, d 128, bf16, causal) at 1 x 16384 tokens, the sequence of phase
# 9f, cut into SP_PARTS parts as the ring cuts it over sp 4.
SP_SEQ = 16384
SP_HEADS = 32
SP_PARTS = 4
# ulysses on sp 2 x mp 2: 32 heads / mp 2 / sp 2 a rank, whole sequence
SP_ULYSSES_HEADS = 8
# heads a plain-version call takes at 16384 keys: its [h, s, s] f32
# scores and probabilities are 2.1 GB a head-pair
PLAIN_HEADS = 2


def by_heads(fn, *ts):
    """``fn`` on PLAIN_HEADS heads at a time of head-major ``[b, h, s,
    d]`` tensors, its outputs put together on the head axis."""
    outs = [fn(*(t[:, i:i + PLAIN_HEADS] for t in ts))
            for i in range(0, ts[0].shape[1], PLAIN_HEADS)]
    return [torch.cat(x, 1) for x in zip(*outs)]


def plain_flash(fa, q, k, v, do, causal, scale):
    """The plain versions of K1 and K2 / K3 on ``[b, s, h, d]`` tensors,
    a few heads at a time: (out, lse [b, h, sq], [dq, dk, dv])."""
    hm = [x.transpose(1, 2) for x in (q, k, v, do)]
    out, lse = by_heads(lambda *t: fa.flash_fwd_ref(*t, causal, scale),
                        *hm[:3])
    grads = by_heads(lambda *t: fa.flash_bwd_ref(*t, causal, scale),
                     hm[0], hm[1], hm[2], out, lse, hm[3])
    return (out.transpose(1, 2), lse[..., 0].contiguous(),
            [g.transpose(1, 2) for g in grads])


def grad_errs(got, want):
    """(max abs error, largest of a row in units of its RMS) over dq, dk,
    dv."""
    pairs = [row_err(g, w) for g, w in zip(got, want)]
    return max(e for e, _ in pairs), max(r for _, r in pairs)


def sp_kernel_phase(card):
    """Phase 5b: the ring's loop over K / V parts without the ring (every
    sp rank's work, one after another on one card), K1 / K2 / K3 at the
    gspmd mode's sq < sk, and K1 / K3 at ulysses's shape, each against
    the plain versions; times of the ring's parts, of K1 / K3 over the
    whole sequence (the one-card run's attention) and at ulysses's
    shape, beside aten's flash attention and the bound."""
    from paddle_tpu_torch.distributed.sequence_parallel import merge_parts
    from paddle_tpu_torch.incubate.nn.cuda import flash_attn as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, S, h, d, P = 1, SP_SEQ, SP_HEADS, 128, SP_PARTS
    s = S // P
    scale = d ** -0.5
    q, k, v, do = (torch.randn(b, S, h, d, generator=gen, device="cuda")
                   .bfloat16() for _ in range(4))
    want_out, want_lse, want_grads = plain_flash(fa, q, k, v, do, True,
                                                 scale)

    def part(x, i):
        return x[:, i * s:(i + 1) * s]

    def ring_fwd():
        """Every rank's parts: K1 on its own part (causal) and on each
        earlier one (full), merged by their lse in f32, cast once."""
        outs, lses = [], []
        for r in range(P):
            out = lse = None
            for c in range(r + 1):
                out, lse = merge_parts(out, lse, *fa.flash_fwd(
                    part(q, r), part(k, c), part(v, c), c == r, scale))
            outs.append(out.to(q.dtype))
            lses.append(lse)
        return torch.cat(outs, 1), torch.cat(lses, 2)

    def ring_bwd(out, lse):
        """K2 on every (rank, part) pair from the merged out and lse, the
        parts' gradients summed in f32."""
        grads = [torch.zeros(b, S, h, d, device="cuda") for _ in range(3)]
        for r in range(P):
            rows = lse[..., r * s:(r + 1) * s].contiguous()
            for c in range(r + 1):
                dq, dk, dv = fa.flash_bwd(part(q, r), part(k, c), part(v, c),
                                          part(out, r), rows, part(do, r),
                                          c == r, scale)
                part(grads[0], r).add_(dq)
                part(grads[1], c).add_(dk)
                part(grads[2], c).add_(dv)
        return grads

    counts = (fa.flash_fwd.launches, fa.flash_bwd_fused.launches,
              fa.flash_bwd_split.launches)
    out, lse = ring_fwd()
    grads = ring_bwd(out, lse)
    torch.cuda.synchronize()
    pairs = P * (P + 1) // 2
    check((fa.flash_fwd.launches - counts[0],
           fa.flash_bwd_fused.launches - counts[1],
           fa.flash_bwd_split.launches - counts[2]) == (pairs, pairs, 0),
          "ring parts: K1 / K2 / K3 launched other than %d / %d / 0 times"
          % (pairs, pairs))
    res = {"ring": dict(parts=P, pairs=pairs, shape=[b, S, h, d])}
    errs = {"K1": row_err(out, want_out), "K2": grad_errs(grads, want_grads)}
    lse_err = (lse - want_lse).abs().max().item()
    res["ring"].update(lse_max_abs_err=lse_err)
    del grads
    # gspmd on sp 4: rank r's 4096 queries over the (r + 1) 4096 keys
    # up to its own, bottom-right causal (ranks 1 and 3); K2 called
    # directly, K3 as the backward's route takes it
    for r in (1, 3):
        sk = (r + 1) * s
        name = "sq_lt_sk %d/%d" % (s, sk)
        qr, dor, kr, vr = part(q, r), part(do, r), k[:, :sk], v[:, :sk]
        w_out, w_lse, w_grads = plain_flash(fa, qr, kr, vr, dor, True,
                                            scale)
        check(not fa.uses_fused_bwd(s, sk, d), name + ": routed to K2")
        o, l = fa.flash_fwd(qr, kr, vr, True, scale)
        torch.cuda.synchronize()
        errs[name + " K1"] = row_err(o, w_out)
        lse_err = max(lse_err, (l - w_lse).abs().max().item())
        for kname, fn in (("K2", fa.flash_bwd_fused),
                          ("K3", fa.flash_bwd_split)):
            errs["%s %s" % (name, kname)] = grad_errs(
                fn(qr, kr, vr, w_out, w_lse, dor, True, scale), w_grads)
        del w_out, w_lse, w_grads
    # ulysses on sp 2 x mp 2: 8 heads over the whole sequence, contiguous
    # as the all-to-all leaves them; the plain versions are the whole
    # run's first 8 heads
    hu = SP_ULYSSES_HEADS
    qu, ku, vu, dou, ou = (x[:, :, :hu].contiguous()
                           for x in (q, k, v, do, want_out))
    lu = want_lse[:, :hu].contiguous()
    check(not fa.uses_fused_bwd(S, S, d), "ulysses: routed to K2")
    o, l = fa.flash_fwd(qu, ku, vu, True, scale)
    torch.cuda.synchronize()
    errs["ulysses K1"] = row_err(o, ou)
    lse_err = max(lse_err, (l - lu).abs().max().item())
    errs["ulysses K3"] = grad_errs(fa.flash_bwd(qu, ku, vu, ou, lu, dou,
                                                True, scale),
                                   [g[:, :, :hu] for g in want_grads])
    # the one-card run's attention: K1 and K3 over the whole sequence and
    # all 32 heads (the same route check as ulysses's: s and d are equal)
    o, l = fa.flash_fwd(q, k, v, True, scale)
    torch.cuda.synchronize()
    errs["whole K1"] = row_err(o, want_out)
    lse_err = max(lse_err, (l - want_lse).abs().max().item())
    del o, l
    errs["whole K3"] = grad_errs(fa.flash_bwd(q, k, v, want_out, want_lse,
                                              do, True, scale), want_grads)
    print("sp kernels (Llama-2 7B attention, 1 x %d, %d heads, d %d, bf16, "
          "causal): %s; lse max_abs_err %.3g [%s]" % (
              S, h, d, ", ".join("%s max_abs_err %.4g (%.3e of its row's "
                                 "RMS)" % (kk, e, r)
                                 for kk, (e, r) in errs.items()),
              lse_err, card), flush=True)
    check(lse_err <= FLASH_LSE_ATOL, "sp kernels: lse max abs err %.4g > %g"
          % (lse_err, FLASH_LSE_ATOL))
    for kname, (e, r) in errs.items():
        check(r <= FLASH_ROW_TOL, "sp kernels %s: max abs err %.4g, %.4g of "
              "its row's RMS > %g" % (kname, e, r, FLASH_ROW_TOL))
    res["errors"] = {kk: dict(max_abs_err=e, row_rms=r)
                     for kk, (e, r) in errs.items()}
    res["lse_max_abs_err"] = lse_err
    del want_grads
    torch.cuda.empty_cache()
    # times: the ring's parts, one after another (all four ranks' work);
    # K1 / K3 at ulysses's shape and over the whole sequence, beside aten's
    # flash attention and the bound
    hm = [x.transpose(1, 2) for x in (q, k, v, do)]
    hmu = [x.transpose(1, 2) for x in (qu, ku, vu, dou)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {"ring K1 parts": cuda_ms(ring_fwd, 5),
             "ring K2 parts": cuda_ms(lambda: ring_bwd(out, lse), 3)}
    for where, hh, (qx, kx, vx, dox, ox, lx), hmx, reps in (
            ("ulysses", hu, (qu, ku, vu, dou, ou, lu), hmu, (10, 5)),
            ("whole", h, (q, k, v, do, want_out, want_lse), hm, (5, 3))):
        rows = {}
        for kname, n, kernel, library in (
                ("K1", reps[0], lambda: fa.flash_fwd(qx, kx, vx, True, scale),
                 lambda: sdpa(*hmx[:3], is_causal=True)),
                ("K3", reps[1], lambda: fa.flash_bwd(qx, kx, vx, ox, lx, dox,
                                                     True, scale),
                 aten_flash_bwd(hmx, True, scale))):
            ms, library_ms = cuda_ms(kernel, n), cuda_ms(library, n)
            nbytes, flops = flash_work(b, S, S, hh, d, True,
                                       backward=kname != "K1")
            bound_ms, bound_by = bound_of(nbytes, flops)
            rows[kname] = dict(
                max_abs_err=errs["%s %s" % (where, kname)][0], ms=ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops, shape=[b, S, S, hh, d])
            print("%s %s shape (b %d, s %d, %d heads, d %d): kernel=%.4f ms "
                  "library=%.4f ms bound=%.4f ms (%s, %.1f MB, %.2f GFLOP) "
                  "[%s]" % (kname, where, b, S, hh, d, ms, library_ms,
                            bound_ms, bound_by, nbytes / 1e6, flops / 1e9,
                            card), flush=True)
        res[where] = rows
    res["times_ms"] = times
    print("sp times (1 x %d, %d heads): %s [%s]" % (
        S, h, ", ".join("%s %.4f ms" % kv for kv in times.items()), card),
        flush=True)
    return res


# ------------------------------------------------------------ phase 6
# The training main paths: name -> (model class, config factory and its
# options, batch b x s). GPT-3 1.3B as bench.py's headline run; Llama-2 7B
# as BASELINE.md's workload #5 (block recompute) at bench.py's 8192 tokens
# a step, in 2 x 4096; MoE GPT at bench.py's MoE widths (8 experts, ffn
# 2816, top-2, capacity 1.25) and the headline batch. All bf16, random
# weights from a generator on the card seeded 0, full width and depth.
TRAIN_PATHS = {
    "gpt3_1p3B": ("GPTForCausalLM", "gpt3_1p3B", dict(lm_ce_chunks=8),
                  (8, 1024)),
    "llama2_7B": ("LlamaForCausalLM", "llama2_7B",
                  dict(recompute=True, lm_ce_chunks=8), (2, 4096)),
    "gpt3_1p3B_moe": ("GPTForCausalLM", "gpt3_1p3B",
                      dict(moe_num_experts=8, intermediate_size=2816,
                           lm_ce_chunks=8), (8, 1024)),
    # bench.py's seq-2048 sub-bench: the headline's model on 4 x 2048
    "gpt3_1p3B_seq2048": ("GPTForCausalLM", "gpt3_1p3B",
                          dict(lm_ce_chunks=8), (4, 2048)),
    # bench.py's streaming sub-bench: fresh 8 x 1024 batches a step through
    # a ChunkPrefetcher into run_steps_stream, under a warm-up + cosine
    # schedule (stream_phase)
    "gpt3_1p3B_stream": ("GPTForCausalLM", "gpt3_1p3B",
                         dict(lm_ce_chunks=8), (8, 1024)),
    # the options of a real pretraining run: hidden and attention dropout
    # 0.1, block recompute, 8-bit Adam moments, gradient merge of 2
    # micro-batches of the headline's 8 x 1024, the skip health policy
    # (options_phase)
    "gpt3_1p3B_options": ("GPTForCausalLM", "gpt3_1p3B",
                          dict(lm_ce_chunks=8, dropout=0.1,
                               attention_dropout=0.1, recompute=True),
                          (16, 1024)),
}
STREAM_CHUNK = 4        # steps a run_steps_stream chunk
STREAM_CHUNKS = 2       # timed chunks (after a warm-up chunk)
OPTIONS_ACCUMULATE = 2  # micro-batches a step of the options path
# the 2-layer check's parameters whose grads are held one by one
TRAIN_GRADS = {
    "gpt3_1p3B": ("gpt.h.0.attn.qkv_proj.weight", "gpt.h.1.mlp.fc1.weight",
                  "gpt.wte.weight"),
    "llama2_7B": ("llama.layers.0.self_attn.q_proj.weight",
                  "llama.layers.1.mlp.gate_proj.weight",
                  "llama.layers.1.input_layernorm.weight",
                  "llama.embed_tokens.weight"),
    "gpt3_1p3B_moe": ("gpt.h.0.attn.qkv_proj.weight", "gpt.h.1.mlp.w1",
                      "gpt.h.0.mlp.gate_weight", "gpt.wte.weight"),
    "gpt3_1p3B_seq2048": ("gpt.h.0.attn.qkv_proj.weight",
                          "gpt.h.1.mlp.fc1.weight", "gpt.wte.weight"),
    "gpt3_1p3B_options": ("gpt.h.0.attn.qkv_proj.weight",
                          "gpt.h.1.mlp.fc1.weight", "gpt.wte.weight"),
}


def train_config(path, num_layers=None):
    """The path's configuration (its depth cut when asked)."""
    from paddle_tpu_torch import models

    _, factory, kw, _ = TRAIN_PATHS[path]
    cfg = getattr(models, factory)(**kw)
    return cfg if num_layers is None else \
        dataclasses.replace(cfg, num_layers=num_layers)


def train_model(path, num_layers=None, seed=0, dtype=torch.bfloat16,
                **overrides):
    """The path's model on the card (bf16 unless asked), weights drawn
    from a generator there seeded ``seed``."""
    from paddle_tpu_torch import models

    cfg = dataclasses.replace(train_config(path, num_layers), **overrides)
    return getattr(models, TRAIN_PATHS[path][0])(
        cfg, dtype=dtype,
        generator=torch.Generator(device="cuda").manual_seed(seed))


def train_batch(vocab, batch=8, seq=1024):
    """bench.py's batch: token ids and (independent) labels from numpy."""
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, vocab, (batch, seq))).cuda()
    labels = torch.from_numpy(rng.integers(0, vocab, (batch, seq))).cuda()
    return ids, labels


def model_module(model):
    """The models module whose names a model's blocks call: its attention
    (and Llama's norms) are swapped there by name."""
    import importlib

    return importlib.import_module(type(model).__module__)


def trunk(model):
    """The model's embeddings, blocks and final norm: the hidden states."""
    return model.llama if hasattr(model, "llama") else model.gpt


def plain_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                    is_causal=False, training=True, name=None):
    """The model's attention call through the plain composition, with
    the attention dropout the functional layer applies to its output."""
    from paddle_tpu_torch.incubate.nn.cuda.flash_attn import (
        flash_attention_ref)
    from paddle_tpu_torch.nn.functional import common

    out = flash_attention_ref(query, key, value, causal=is_causal)
    if dropout_p > 0.0 and training:
        out = common.dropout(out, dropout_p)
    return out


def plain_rms_norm(x, weight, bias=None, eps=1e-6):
    """Llama's RMSNorm call through K7's plain version (autograd)."""
    from paddle_tpu_torch.incubate.nn.cuda import norms

    return norms.rms_norm_ref(x, weight, bias, eps)


def plain_add_rms_norm(y, residual, weight, epsilon=1e-6):
    """Llama's residual add + RMSNorm through K7's plain version."""
    from paddle_tpu_torch.incubate.nn.cuda import norms

    return norms.rms_norm_ref(y, weight, None, epsilon, residual=residual)


def no_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                 is_causal=False, training=True, name=None):
    """Attention that returns zeros: how far attention moves the model."""
    return torch.zeros_like(query)


def plain_hooks(model):
    """The plain version of every kernel the model's blocks call, by the
    name they call it by."""
    hooks = {"scaled_dot_product_attention": plain_attention}
    if hasattr(model, "llama"):
        hooks.update(rms_norm=plain_rms_norm,
                     add_rms_norm=plain_add_rms_norm)
    return hooks


def patched(fn, module, hooks):
    """Run ``fn()`` with the names ``hooks`` gives replaced in ``module``,
    restored after it."""
    saved = {k: getattr(module, k) for k in hooks}
    for k, v in hooks.items():
        setattr(module, k, v)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def with_hooks(fn, model, **hooks):
    """Run ``fn()`` with names of the model's module replaced."""
    return patched(fn, model_module(model), hooks)


def compared_hooks(model, layer_errs, norm_errs):
    """The model's kernels as its blocks call them, each call also held
    against its plain version on the same inputs: attention row by row
    (``row_err`` into ``layer_errs``), the norms element by element
    (``norm_ratio`` into ``norm_errs``; the fused residual sum must be
    PyTorch's add bit for bit)."""
    module = model_module(model)
    attn = module.scaled_dot_product_attention

    def attention(query, key, value, **kw):
        out = attn(query, key, value, **kw)
        layer_errs.append(row_err(out, plain_attention(query, key, value,
                                                       **kw)))
        return out

    hooks = {"scaled_dot_product_attention": attention}
    if hasattr(model, "llama"):
        rms, add = module.rms_norm, module.add_rms_norm

        def rms_norm(x, weight, bias=None, eps=1e-6):
            out = rms(x, weight, bias, eps)
            norm_errs.append(norm_ratio(out, plain_rms_norm(
                x, weight, bias, eps), NORM_REL[x.dtype]))
            return out

        def add_rms_norm(y, residual, weight, epsilon=1e-6):
            out, s = add(y, residual, weight, epsilon)
            want, want_s = plain_add_rms_norm(y, residual, weight, epsilon)
            check(torch.equal(s, want_s), "a fused residual sum differs "
                  "from PyTorch's add")
            norm_errs.append(norm_ratio(out, want, NORM_REL[y.dtype]))
            return out, s

        hooks.update(rms_norm=rms_norm, add_rms_norm=add_rms_norm)
    return hooks


def routed(fn, choices):
    """``fn()`` with every MoE block's expert choices, (first, second)
    of every token (E where dropped), appended to ``choices`` (a dense
    model appends nothing)."""
    from paddle_tpu_torch.fusion import moe

    route = moe.gshard_top2

    def recorded(logits, num_experts, capacity):
        out = route(logits, num_experts, capacity)
        choices.append(torch.stack([out[0] // capacity,
                                    out[1] // capacity], -1))
        return out

    moe.gshard_top2 = recorded
    try:
        return fn()
    finally:
        moe.gshard_top2 = route


def within_plain(err, plain_err, floor):
    """The kernels' error against the f32 run may exceed the plain bf16
    run's by TRAIN_VS_PLAIN, plus ``floor``."""
    return np.isfinite(err) and err <= TRAIN_VS_PLAIN * plain_err + floor


def train_check(card, path, model=None):
    """Kernels against the plain versions (attention; Llama's norms too)
    and both against f32 (see TRAIN_VS_PLAIN): the grads of a 2-layer
    model of full width, and for a recomputing path the same grads with
    recompute off; then at full depth under no_grad the first-step loss,
    every layer's attention output on that layer's own q/k/v (and every
    norm on its own input), and the final hidden states. ``model``: the
    path's full model when the caller keeps it (for the training phase),
    else one is built and freed."""
    from paddle_tpu_torch.observability import grad_health

    b, s = TRAIN_PATHS[path][3]
    cfg = train_config(path, num_layers=2)
    ids, labels = train_batch(cfg.vocab_size, b, s)
    small = train_model(path, num_layers=2, seed=1)
    ref = train_model(path, num_layers=2, seed=1, dtype=torch.float32)
    ref.load_state_dict(small.state_dict())
    names = [n for n, _ in small.named_parameters()]

    def grads(m, **hooks):
        ps = list(m.parameters())
        return with_hooks(lambda: torch.autograd.grad(
            m(ids, labels=labels), ps), m, **hooks)

    runs = {"kernels": grads(small), "plain": grads(small,
                                                   **plain_hooks(small)),
            "f32": grads(ref, **plain_hooks(ref))}
    del ref
    norms = {k: grad_health(g).item() for k, g in runs.items()}
    gn_err = {k: abs(norms[k] - norms["f32"]) / norms["f32"]
              for k in ("kernels", "plain")}
    check(within_plain(gn_err["kernels"], gn_err["plain"],
                       TRAIN_FLOOR["gnorm"]),
          "%s: 2-layer grad norm %r, plain %r, f32 %r"
          % (path, norms["kernels"], norms["plain"], norms["f32"]))
    msg = []
    for pname in TRAIN_GRADS[path]:
        i = names.index(pname)
        k, p = (rel_l2(runs[x][i], runs["f32"][i]) for x in ("kernels",
                                                              "plain"))
        check(within_plain(k, p, TRAIN_FLOOR["grad"]), "%s %s grad: "
              "relative L2 %.4g from f32, the plain run's %.4g" % (path,
                                                                  pname, k,
                                                                  p))
        msg.append("%s %.4g / %.4g from f32, %.4g apart" % (
            pname, k, p, rel_l2(runs["kernels"][i], runs["plain"][i])))
    print("train %s: 2-layer grads, kernels / plain: norm %.6f / %.6f "
          "(f32 %.6f); relative L2 %s [%s]" % (path, norms["kernels"],
                                               norms["plain"], norms["f32"],
                                               "; ".join(msg), card),
          flush=True)
    if cfg.recompute:
        again = train_model(path, num_layers=2, seed=1, recompute=False)
        again.load_state_dict(small.state_dict())
        off = grads(again)
        gn = grad_health(off).item()
        check(abs(norms["kernels"] - gn) <= TRAIN_GNORM_RTOL * gn,
              "%s: 2-layer grad norm %r, %r with recompute off"
              % (path, norms["kernels"], gn))
        msg = []
        for pname in TRAIN_GRADS[path]:
            i = names.index(pname)
            rel = rel_l2(runs["kernels"][i], off[i])
            check(rel <= TRAIN_GRAD_RTOL, "%s %s grad: relative L2 %.4g "
                  "from recompute off > %g" % (path, pname, rel,
                                               TRAIN_GRAD_RTOL))
            msg.append("%s %.4g" % (pname, rel))
        print("train %s: 2-layer grads, recompute on / off: norm %.6f / "
              "%.6f; relative L2 %s [%s]" % (path, norms["kernels"], gn,
                                             "; ".join(msg), card),
              flush=True)
        del again, off
    del small, runs
    torch.cuda.empty_cache()

    cfg = train_config(path)
    owned = model is None
    if owned:
        model = train_model(path)
    ref = train_model(path, dtype=torch.float32)
    ref.load_state_dict(model.state_dict())
    layer_errs, norm_errs = [], []
    routes = {"kernels": [], "plain": [], "f32": []}
    hooks = plain_hooks(model)
    with torch.no_grad():
        loss = {"kernels": model(ids, labels=labels).item(),
                "plain": with_hooks(lambda: model(ids, labels=labels).item(),
                                    model, **hooks),
                "f32": with_hooks(lambda: ref(ids, labels=labels).item(),
                                  ref, **plain_hooks(ref))}
        hidden = {
            "kernels": routed(lambda: with_hooks(
                lambda: trunk(model)(ids), model,
                **compared_hooks(model, layer_errs, norm_errs)),
                routes["kernels"]),
            "plain": routed(lambda: with_hooks(lambda: trunk(model)(ids),
                                               model, **hooks),
                            routes["plain"]),
            "f32": routed(lambda: with_hooks(lambda: trunk(ref)(ids), ref,
                                             **plain_hooks(ref)),
                          routes["f32"])}
        bare = with_hooks(lambda: trunk(model)(ids), model,
                          scaled_dot_product_attention=no_attention)
    del ref
    want = hidden["f32"].float()

    def per_token(h, w=want):
        return ((h.float() - w).norm(dim=-1) / w.norm(dim=-1)).flatten()

    err = {k: per_token(hidden[k]) for k in ("kernels", "plain")}
    stats = {k: (e.median().item(), rel_l2(hidden[k], want), e.max().item())
             for k, e in err.items()}
    apart = per_token(hidden["kernels"], hidden["plain"].float())
    moved = per_token(bare, hidden["plain"].float())
    a_err, a_rel = (max(e[i] for e in layer_errs) for i in (0, 1))

    def rerouted(a, b_):
        return int(torch.stack([(x != y).any(-1) for x, y in zip(
            routes[a], routes[b_])]).any(0).sum())

    print("train %s: %d layers, no_grad: first-step loss, kernels %.6f, "
          "plain %.6f, f32 %.6f; attention output of every layer on its "
          "own q/k/v: max_abs_err %.4g (%.3e of its row's RMS)%s; final "
          "hidden states, per-token relative L2 from f32 (median, all "
          "tokens, largest): kernels %.4g / %.4g / %.4g, plain %.4g / %.4g "
          "/ %.4g; kernels from plain: median %.4g, largest %.4g (%d "
          "tokens%s); attention moves them by %.4g (median token; least "
          "%.4g) [%s]"
          % (path, cfg.num_layers, loss["kernels"], loss["plain"],
             loss["f32"], a_err, a_rel,
             "; every norm on its own input: %.3g of its allowance (%d "
             "calls)" % (max(norm_errs), len(norm_errs)) if norm_errs
             else "", *stats["kernels"], *stats["plain"],
             apart.median().item(), apart.max().item(), ids.numel(),
             "; routed differently in some layer: kernels / plain %d, "
             "kernels / f32 %d, plain / f32 %d" % (
                 rerouted("kernels", "plain"), rerouted("kernels", "f32"),
                 rerouted("plain", "f32")) if routes["kernels"] else "",
             moved.median().item(), moved.min().item(), card), flush=True)
    L = cfg.num_layers
    check(len(layer_errs) == L, "%s: attention ran %d times, not once per "
          "layer" % (path, len(layer_errs)))
    check(not hasattr(model, "llama") or len(norm_errs) == 2 * L + 1,
          "%s: %d norm calls, not 2L + 1" % (path, len(norm_errs)))
    check(a_rel <= FLASH_ROW_TOL, "%s: a layer's attention output is off "
          "by %.4g of its row's RMS > %g" % (path, a_rel, FLASH_ROW_TOL))
    check(not norm_errs or max(norm_errs) <= 1.0, "%s: a norm is off by "
          "%.3g of its allowance" % (path, max(norm_errs or [0])))
    check(all(np.isfinite(v) for v in loss.values()) and within_plain(
        abs(loss["kernels"] - loss["f32"]), abs(loss["plain"] - loss["f32"]),
        TRAIN_FLOOR["loss"]), "%s: first-step loss %r, plain %r, f32 %r"
        % (path, loss["kernels"], loss["plain"], loss["f32"]))
    check(bool(torch.isfinite(hidden["kernels"]).all()),
          "%s: non-finite hidden states" % path)
    for i, what in enumerate(("median", "all tokens")):
        check(within_plain(stats["kernels"][i], stats["plain"][i],
                           TRAIN_FLOOR["hidden"]),
              "%s: hidden states %.4g from f32 (%s), the plain run's %.4g"
              % (path, stats["kernels"][i], what, stats["plain"][i]))
    del hidden, want, bare, err, apart, moved
    if owned:
        del model
    torch.cuda.empty_cache()


def training_kernels():
    """The kernels a training path may launch, by name: (wrapper,
    counter)."""
    from paddle_tpu_torch.incubate.nn.cuda import flash_attn as fa
    from paddle_tpu_torch.incubate.nn.cuda import moe_dispatch as md
    from paddle_tpu_torch.incubate.nn.cuda import norms
    from paddle_tpu_torch.incubate.nn.cuda import paged_attention as pa

    return {"K1": (fa.flash_fwd, "launches"),
            "K2": (fa.flash_bwd_fused, "launches"),
            "K3": (fa.flash_bwd_split, "launches"),
            "K4": (pa.ragged_paged_attention, "launches"),
            "K7 rms_norm": (norms.rms_norm, "launches"),
            "K7 rms_norm fused": (norms.rms_norm, "launches_fused"),
            "K7 layer_norm": (norms.layer_norm, "launches"),
            "K8": (md.grouped_matmul, "launches")}


def step_launches(model, micro=1):
    """The launches one training step of ``model`` over ``micro``
    micro-batches (gradient merge) must make: a micro-batch's forward runs
    K1 once a layer, its backward K2 once a layer (s * d is under K2's
    cap: never K3), and a recomputed block (``recompute``: every Llama
    block) its forward again in the backward, K1 included. Llama's
    norms are K7's RMSNorm: two a block (the input norm, and the
    post-attention norm after the residual add, which under a gradient is
    autograd's add and K7's plain form) and the final norm, 2L + 1 in the
    forward and two more a recomputed block; K7's backward is the plain
    version's vjp, no launch. GPT's LayerNorm is PyTorch's (no K7), and
    its MoE FFN runs batched products over capacity slots (no K8)."""
    blocks = model.llama.layers if hasattr(model, "llama") else model.gpt.h
    L = len(blocks)
    rc = sum(bool(blk.recompute) for blk in blocks)
    want = {k: 0 for k in training_kernels()}
    want.update({"K1": L + rc, "K2": L})
    if hasattr(model, "llama"):
        want["K7 rms_norm"] = 2 * L + 1 + 2 * rc
    return {k: micro * n for k, n in want.items()}


def active_params(model):
    """N of bench.py's 6N + 6 L h s: every parameter, a MoE block's
    experts (w1, b1, w2, b2) at top-k / E = 2 / E (the share of them a
    token runs through)."""
    n = 0.0
    for name, p in model.named_parameters():
        share = 1.0
        if ".mlp." in name and name.rsplit(".", 1)[-1] in ("w1", "b1",
                                                            "w2", "b2"):
            share = 2.0 / model.config.moe_num_experts
        n += share * p.numel()
    return n


def train_phase(card, path="gpt3_1p3B", model=None):
    """A training main path: a warm-up step, then TRAIN_STEPS timed
    steps on one batch, every kernel count set to 0 just before the
    timed steps and read just after. ``model``: the path's full model
    (train_check's), else one is built."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    cfg = train_config(path)
    b, s = TRAIN_PATHS[path][3]
    t0 = time.perf_counter()
    if model is None:
        model = train_model(path)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                moment_dtype="bfloat16", factored_v=True)
    step = TrainStep(model, opt, grad_clip_norm=1.0)
    ids, labels = train_batch(cfg.vocab_size, b, s)
    first = step(ids, labels).item()              # warm-up step
    torch.cuda.synchronize()
    print("train %s: bf16 built, warm-up step in %.2f s, loss %.4f"
          % (path, time.perf_counter() - t0, first), flush=True)

    kernels = training_kernels()
    torch.cuda.reset_peak_memory_stats()
    for fn, attr in kernels.values():
        setattr(fn, attr, 0)
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(loss.item())
    launches = {k: getattr(fn, attr) for k, (fn, attr) in kernels.items()}
    peak = torch.cuda.max_memory_allocated()

    want = {k: TRAIN_STEPS * n for k, n in step_launches(model).items()}
    check(launches == want, "%s: training launches %s, want %s (%d steps)"
          % (path, launches, want, TRAIN_STEPS))
    check(all(np.isfinite(losses)), "%s: non-finite loss %s" % (path,
                                                                 losses))
    check(losses[-1] < first, "%s: loss did not fall: %s"
          % (path, [first] + losses))
    res = train_rates(path, model, b * s * TRAIN_STEPS, step_s, peak,
                      card, losses=[first] + losses, launches=launches)
    print_rates(path, res, "%d steps of %d x %d tokens" % (TRAIN_STEPS, b,
                                                           s))
    return res, step, (ids, labels)


def train_rates(path, model, tokens, step_s, peak, card, **more):
    """tokens/s over the timed steps, the median step, MFU by bench.py's
    formula (6N + 6 L h s flops a token against 989 TFLOP/s, N the MoE
    experts at 2/E) and peak memory, with ``more``."""
    cfg = train_config(path)
    s = TRAIN_PATHS[path][3][1]
    tokens_s = tokens / sum(step_s)
    n_params = sum(p.numel() for p in model.parameters())
    n_active = active_params(model)
    flops_per_token = 6 * n_active + 6 * cfg.num_layers * cfg.hidden_size * s
    return dict(tokens_s=tokens_s, median_step_ms=1e3 * statistics.median(
        step_s), mfu=tokens_s * flops_per_token / BF16_FLOPS_PER_S,
        peak_gb=peak / 1e9, params=n_params, active_params=n_active,
        flops_per_token=flops_per_token, batch=list(TRAIN_PATHS[path][3]),
        layers=cfg.num_layers, card=card, **more)


def print_rates(path, res, what):
    print("train %s: %s, losses %s; %.1f tokens/s, median step %.2f ms, "
          "MFU %.4f (tokens/s x (6N + 6 L h s) / 989 TFLOP/s, N = %d of %d "
          "params%s, %.4g flops/token), peak memory %.2f GB; launches %s "
          "[%s]" % (path, what, ["%.4f" % x for x in res["losses"]],
                    res["tokens_s"], res["median_step_ms"], res["mfu"],
                    res["active_params"], res["params"],
                    ": the experts at 2/E" if res["active_params"] !=
                    res["params"] else "", res["flops_per_token"],
                    res["peak_gb"], res["launches"], res["card"]),
          flush=True)


def zero_counts():
    """Every training kernel's count set to 0; returns a function that
    reads them."""
    kernels = training_kernels()
    for fn, attr in kernels.values():
        setattr(fn, attr, 0)
    return lambda: {k: getattr(fn, attr) for k, (fn, attr) in
                    kernels.items()}


def timed_calls(fn, n):
    """``fn()`` ``n`` times, each between synchronisations: (the loss
    each returns, as floats; the seconds each took)."""
    losses, secs = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(loss.item())
    return losses, secs


def attention_check(card, path, model, ids):
    """Every layer's attention output on its own q/k/v against the plain
    version, in one forward of the model's trunk at full depth under
    no_grad (in eval mode: dropout, which acts after the kernel, is off;
    the kernel sees what it sees in training)."""
    layer_errs = []
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            with_hooks(lambda: trunk(model)(ids), model,
                       **compared_hooks(model, layer_errs, []))
    finally:
        model.train(was)
    L = train_config(path).num_layers
    a_err, a_rel = (max(e[i] for e in layer_errs) for i in (0, 1))
    print("train %s: %d layers on %d x %d tokens, attention output of every "
          "layer on its own q/k/v: max_abs_err %.4g (%.3e of its row's RMS) "
          "[%s]" % (path, L, ids.shape[0], ids.shape[1], a_err, a_rel, card),
          flush=True)
    check(len(layer_errs) == L, "%s: attention ran %d times, not once per "
          "layer" % (path, len(layer_errs)))
    check(a_rel <= FLASH_ROW_TOL, "%s: a layer's attention output is off "
          "by %.4g of its row's RMS > %g" % (path, a_rel, FLASH_ROW_TOL))
    return a_err


def stream_schedule():
    """The streaming path's schedule: linear warm-up over 4 steps, then
    cosine decay over the 8 after it."""
    from paddle_tpu_torch.optimizer import lr

    return lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, T_max=8),
                           warmup_steps=4, start_lr=1e-5, end_lr=1e-4)


def stream_phase(card, path, model):
    """bench.py's streaming sub-bench: fresh 8 x 1024 batches from a
    seeded numpy generator (ids as labels, as bench.py feeds them), n a
    chunk, stacked by a ChunkPrefetcher on its thread and trained by
    ``run_steps_stream(n)`` under ``stream_schedule()``: a warm-up chunk,
    then the same-batch ``run_steps(n)`` (the headline's loop, timed
    here in the same call), then STREAM_CHUNKS timed stream chunks with
    every kernel count set to 0 just before and read just after. The
    learning rate each step used must be the schedule's."""
    from paddle_tpu_torch.jit import ChunkPrefetcher, TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    cfg = train_config(path)
    b, s = TRAIN_PATHS[path][3]
    n = STREAM_CHUNK
    rng = np.random.default_rng(1)

    def source():
        for _ in range(n * (1 + STREAM_CHUNKS)):
            x = rng.integers(0, cfg.vocab_size, (b, s))
            yield x, x

    feed = ChunkPrefetcher(source(), n)
    attention_check(card, path, model, torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s))).cuda())
    t0 = time.perf_counter()
    sched = stream_schedule()
    step = TrainStep(model, AdamW(sched, weight_decay=0.01,
                                  moment_dtype="bfloat16", factored_v=True),
                     grad_clip_norm=1.0)
    used = []
    update = step.optimizer.update

    def recording(params, grads, state, lr=None, **kw):
        used.append(lr)
        return update(params, grads, state, lr=lr, **kw)

    step.optimizer.update = recording
    try:
        first = step.run_steps_stream(n, *next(feed)).item()
        torch.cuda.synchronize()
        print("train %s: bf16 built, warm-up chunk of %d steps in %.2f s, "
              "loss %.4f" % (path, n, time.perf_counter() - t0, first),
              flush=True)
        ids, labels = train_batch(cfg.vocab_size, b, s)
        _, same_s = timed_calls(lambda: step.run_steps(n, ids, labels),
                                STREAM_CHUNKS)
        torch.cuda.reset_peak_memory_stats()
        read = zero_counts()
        losses, chunk_s = timed_calls(
            lambda: step.run_steps_stream(n, *next(feed)), STREAM_CHUNKS)
        launches = read()
        peak = torch.cuda.max_memory_allocated()
        check(next(feed, None) is None, "%s: the prefetcher has batches "
              "left" % path)
    finally:
        feed.close()
        del step.optimizer.update
    ref = stream_schedule()
    want = []
    for _ in range(n * (1 + STREAM_CHUNKS)):
        want.append(ref())
        ref.step()
    f32 = [float(np.float32(x)) for x in want]
    got = dict(warmup=used[:n], same_batch=used[n:n + n * STREAM_CHUNKS],
               stream=used[n + n * STREAM_CHUNKS:])
    check(got["warmup"] == f32[:n] and got["stream"] == f32[n:] and
          got["same_batch"] == [want[n]] * (n * STREAM_CHUNKS),
          "%s: learning rates %s, the schedule's %s" % (path, used, want))
    check(sched.last_epoch == n * (1 + STREAM_CHUNKS),
          "%s: the schedule is at step %d" % (path, sched.last_epoch))
    steps = n * STREAM_CHUNKS
    want_launches = {k: steps * c for k, c in step_launches(model).items()}
    check(launches == want_launches, "%s: training launches %s, want %s "
          "(%d steps)" % (path, launches, want_launches, steps))
    check(all(np.isfinite([first] + losses)), "%s: non-finite loss %s"
          % (path, [first] + losses))
    check(losses[-1] < first, "%s: loss did not fall: %s"
          % (path, [first] + losses))
    res = train_rates(path, model, b * s * steps,
                      [x / n for x in chunk_s for _ in range(n)], peak, card,
                      losses=[first] + losses, launches=launches,
                      learning_rates=got["warmup"] + got["stream"])
    same_tokens_s = b * s * n * STREAM_CHUNKS / sum(same_s)
    res.update(same_batch_tokens_s=same_tokens_s,
               of_headline=res["tokens_s"] / same_tokens_s,
               chunk=n, chunks=STREAM_CHUNKS)
    print_rates(path, res, "%d chunks of %d fresh %d x %d batches" % (
        STREAM_CHUNKS, n, b, s))
    print("train %s: of_headline %.3f (fresh data %.1f tokens/s, the same "
          "batch through run_steps(%d) %.1f tokens/s in this call); learning "
          "rates as the schedule's: %s [%s]"
          % (path, res["of_headline"], res["tokens_s"], n, same_tokens_s,
             ["%.4g" % x for x in res["learning_rates"]], card), flush=True)
    return res, step, (ids, labels)


def mask_replay_check(card, path, micro):
    """On a 2-layer copy of the path's model at full width (bf16), with
    dropout: every dropout mask a recomputed block draws in the backward
    is the mask it drew in the forward, and the forward's draws equal
    those of the same model without recompute, all bit for bit under one
    seed; the losses too, and the grads through the plain versions (every
    operation deterministic); through the kernels the grads are held
    within TRAIN_GRAD_RTOL (K2 reduce-adds dq in any order)."""
    import paddle_tpu_torch
    from paddle_tpu_torch.nn.functional import common
    from paddle_tpu_torch.observability import grad_health

    b, s = TRAIN_PATHS[path][3]
    cfg = train_config(path, num_layers=2)
    ids, labels = train_batch(cfg.vocab_size, b // micro, s)
    on = train_model(path, num_layers=2, seed=1)
    off = train_model(path, num_layers=2, seed=1, recompute=False)
    off.load_state_dict(on.state_dict())

    def run(m, hooks):
        drawn = []
        draw = common.dropout_mask

        def recorded(shape, p, device):
            keep = draw(shape, p, device)
            drawn.append(keep)
            return keep

        common.dropout_mask = recorded
        try:
            paddle_tpu_torch.seed(3)
            ps = list(m.parameters())

            def loss_and_grads():
                loss = m(ids, labels=labels)
                return loss.detach(), torch.autograd.grad(loss, ps)

            loss, grads = with_hooks(loss_and_grads, m, **hooks)
        finally:
            common.dropout_mask = draw
        return loss, grads, drawn

    L = cfg.num_layers
    for kind, hooks in (("plain", plain_hooks(on)), ("kernels", {})):
        l_on, g_on, d_on = run(on, hooks)
        l_off, g_off, d_off = run(off, hooks)
        forward = d_on[:1 + 3 * L]
        again = d_on[1 + 3 * L:]
        check(len(d_off) == 1 + 3 * L and len(again) == 3 * L,
              "%s: %d / %d dropout draws with recompute on / off"
              % (path, len(d_on), len(d_off)))
        check(all(torch.equal(x, y) for x, y in zip(forward, d_off)),
              "%s: the forward's masks differ with recompute on" % path)
        for j in range(L):       # the backward recomputes the last first
            redo = again[3 * (L - 1 - j):3 * (L - j)]
            check(all(torch.equal(x, y) for x, y in zip(
                redo, forward[1 + 3 * j:4 + 3 * j])),
                "%s: block %d's recompute drew other masks" % (path, j))
        check(torch.equal(l_on, l_off), "%s (%s): loss %r with recompute, "
              "%r without" % (path, kind, l_on.item(), l_off.item()))
        if kind == "plain":
            same = all(torch.equal(x, y) for x, y in zip(g_on, g_off))
            check(same, "%s: plain grads differ with recompute on" % path)
            print("train %s: 2-layer copy, dropout %g / attention %g: the "
                  "%d masks of a step replayed bit for bit by recompute; "
                  "loss and every grad (plain versions) equal bit for bit "
                  "with recompute on and off [%s]"
                  % (path, cfg.dropout, cfg.attention_dropout, len(d_off),
                     card), flush=True)
            continue
        gn_on, gn_off = grad_health(g_on).item(), grad_health(g_off).item()
        rel = max(rel_l2(x, y) for x, y in zip(g_on, g_off))
        check(abs(gn_on - gn_off) <= TRAIN_GNORM_RTOL * gn_off and
              rel <= TRAIN_GRAD_RTOL, "%s: kernels' grads with recompute on "
              "/ off: norm %r / %r, relative L2 up to %.4g"
              % (path, gn_on, gn_off, rel))
        print("train %s: 2-layer copy through the kernels: loss equal bit "
              "for bit with recompute on and off, grad norm %.6f / %.6f, "
              "largest relative L2 of a grad %.4g [%s]"
              % (path, gn_on, gn_off, rel, card), flush=True)
    del on, off
    torch.cuda.empty_cache()


def state_bytes(state):
    return sum(e.numel() * e.element_size() for v in state.values()
               for e in (v if isinstance(v, list) else [v]))


def options_phase(card, path, model):
    """The options of a real pretraining run on GPT-3 1.3B: dropout and
    attention dropout 0.1, block recompute, AdamW with 8-bit moments,
    gradient merge over OPTIONS_ACCUMULATE micro-batches of 8 x 1024, the
    skip health policy. Checks each layer's attention, the masks' replay
    (mask_replay_check), the launches of TRAIN_STEPS timed steps (per
    micro-batch K1 L + recomputed blocks, K2 L), and that a step whose
    loss is non-finite leaves every parameter and state tensor bit for
    bit as it was and warns; times the skip policy's sync against a step
    under the policy off, in turns."""
    import warnings

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.observability import health
    from paddle_tpu_torch.optimizer import AdamW

    cfg = train_config(path)
    b, s = TRAIN_PATHS[path][3]
    k = OPTIONS_ACCUMULATE
    ids, labels = train_batch(cfg.vocab_size, b, s)
    attention_check(card, path, model, ids[:b // k])
    mask_replay_check(card, path, k)

    def opt():
        return AdamW(learning_rate=1e-4, weight_decay=0.01,
                     moment_quant="8bit")

    t0 = time.perf_counter()
    health.configure("skip")
    try:
        step = TrainStep(model, opt(), grad_clip_norm=1.0,
                         accumulate_steps=k)
        first = step(ids, labels).item()
        torch.cuda.synchronize()
        print("train %s: bf16 built, warm-up step in %.2f s, loss %.4f"
              % (path, time.perf_counter() - t0, first), flush=True)
        torch.cuda.reset_peak_memory_stats()
        read = zero_counts()
        losses, step_s = timed_calls(lambda: step(ids, labels), TRAIN_STEPS)
        launches = read()
        peak = torch.cuda.max_memory_allocated()
        want = {n: TRAIN_STEPS * c for n, c in step_launches(
            model, micro=k).items()}
        check(launches == want, "%s: training launches %s, want %s (%d "
              "steps of %d micro-batches)" % (path, launches, want,
                                              TRAIN_STEPS, k))
        check(all(np.isfinite([first] + losses)), "%s: non-finite loss %s"
              % (path, [first] + losses))
        check(losses[-1] < first, "%s: loss did not fall: %s"
              % (path, [first] + losses))

        # the skip policy: a non-finite step writes nothing
        params = [p.detach().clone() for p in model.parameters()]
        state = {key: [e.clone() for e in v] if isinstance(v, list)
                 else v.clone() for key, v in step.opt_state.items()}
        step.loss_fn = lambda m, x, y: m(x, labels=y) * float("inf")
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            step(ids, labels)
        step.loss_fn = None
        kept = all(torch.equal(p, q) for p, q in zip(params,
                                                     model.parameters()))
        kept_state = all(torch.equal(x, y) for key, v in state.items()
                         for x, y in zip(v if isinstance(v, list) else [v],
                                         step.opt_state[key] if isinstance(
                                             v, list) else
                                         [step.opt_state[key]]))
        messages = [str(w.message) for w in warned]
        check(kept and kept_state and len(messages) == 1 and
              "update discarded" in messages[0],
              "%s: a non-finite step: parameters kept %s, state kept %s, "
              "warnings %s" % (path, kept, kept_state, messages))
        del params, state
        print("train %s: a step whose loss is inf left every parameter and "
              "every optimizer state tensor (t included) bit for bit as it "
              "was and warned: %s [%s]" % (path, messages[0], card),
              flush=True)

        # the skip policy's host read against no policy, in turns
        health.configure("off")
        plain_step = TrainStep(model, opt(), grad_clip_norm=1.0,
                               accumulate_steps=k)
        health.configure("skip")
        plain_step(ids, labels)
        turns = {"skip": [], "off": []}
        for name in ("skip", "off", "off", "skip"):
            run = step if name == "skip" else plain_step
            turns[name] += timed_calls(lambda: run(ids, labels), 1)[1]
        del plain_step
    finally:
        health.configure("off")
    n = sum(p.numel() for p in model.parameters())
    q8 = state_bytes({key: step.opt_state[key] for key in ("m", "m_ax", "v",
                                                            "v_ax")})
    res = train_rates(path, model, b * s * TRAIN_STEPS, step_s, peak, card,
                      losses=[first] + losses, launches=launches,
                      accumulate_steps=k,
                      moments_gb=q8 / 1e9, bf16_m_f32_v_gb=n * 6 / 1e9,
                      skip_step_ms=[1e3 * x for x in turns["skip"]],
                      off_step_ms=[1e3 * x for x in turns["off"]])
    print_rates(path, res, "%d steps of %d x %d tokens in %d micro-batches"
                % (TRAIN_STEPS, b, s, k))
    print("train %s: 8-bit moments %.3f GB (codes and absmax) against %.3f "
          "GB for bf16 m + f32 v; a step under the skip policy %s ms, under "
          "no policy %s ms (in turns) [%s]"
          % (path, res["moments_gb"], res["bf16_m_f32_v_gb"],
             ["%.2f" % x for x in res["skip_step_ms"]],
             ["%.2f" % x for x in res["off_step_ms"]], card), flush=True)
    return res, step, (ids, labels)


# ------------------------------------------------------------ phase 7
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


def serving_kernels():
    """The serving path's kernel counts by name: (wrapper, attribute)."""
    from paddle_tpu_torch.incubate.nn.cuda import norms
    from paddle_tpu_torch.incubate.nn.cuda import paged_attention as pa

    return {"K4": (pa.ragged_paged_attention, "launches"),
            "K5": (pa.ragged_paged_attention, "launches_q8"),
            "K6": (pa.paged_attention, "launches"),
            "K6-q8": (pa.paged_attention, "launches_q8"),
            "K7 rms_norm": (norms.rms_norm, "launches"),
            "K7 layer_norm": (norms.layer_norm, "launches"),
            "K7 rms_norm fused": (norms.rms_norm, "launches_fused"),
            "K7 layer_norm fused": (norms.layer_norm, "launches_fused")}


def serving_counts():
    return {k: getattr(fn, attr)
            for k, (fn, attr) in serving_kernels().items()}


def snapshot_step(kp, vp, bt, pos, page):
    """Copies of the pool pages a step's rows read (the first
    ``ceil((max pos + 1) / page)`` columns of their block tables) as
    compact pools, and the block tables renumbered into them: what a
    rerun of the step needs once the engine has reused its pages."""
    from paddle_tpu_torch.incubate.nn.cuda.paged_attention import (
        pool_shape)

    n_pages = -(-(int(pos.max()) + 1) // page)
    total = pool_shape(kp[0])[1]
    used = torch.unique(bt[:, :n_pages].clamp(0, total - 1))
    compact = torch.zeros(total, dtype=torch.int32, device=bt.device)
    compact[used.long()] = torch.arange(len(used), dtype=torch.int32,
                                        device=bt.device)

    def sub(p):
        if isinstance(p, dict):
            return {k: v[:, used].clone() for k, v in p.items()}
        return p[:, used].clone()

    return ([sub(p) for p in kp], [sub(p) for p in vp],
            compact[bt.clamp(0, total - 1).long()].contiguous())


def serve_main_path(eng, prompts, new_tokens):
    """The serving main path: every kernel count set to 0 just before the
    trace is submitted and read just after the engine drains. Keeps a
    record of the steps the plain-path check reruns (``first``): the
    ragged layout's first step; the off layout's first prefill chunk and
    its first decode batch with at least two live rows, each with copies
    of the pool pages it reads. A record holds the step as a function of
    ``(kp, vp, bt, attn)``, its inputs, logits and final hidden states
    (the residual stream before the last norm), per token. Counts K6's
    launches by the kind of pass that made them (``by_kind``: prefill
    chunk or decode batch), from its counters around each pass."""
    from paddle_tpu_torch.incubate.nn.cuda import paged_attention as pa
    from paddle_tpu_torch.models import generation

    ad = eng._ad
    first = {}
    grab = {}
    by_kind = {}
    real_ragged, real_paged, real_logits = (ad.ragged_chunk, ad.paged_chunk,
                                            ad.logits)

    def keep_logits(w, x, h=None):
        if grab:
            grab["hidden"] = x.clone()
        return real_logits(w, x, h)

    def keep_ragged(w, *args, attn=None):
        if "ragged" not in first:
            grab["on"] = True
        out = real_ragged(w, *args, attn=attn)
        if grab:
            toks, pos, row_of, qs, ql, cl, _, _, bt = args
            toks, pos, row_of, qs, ql, cl, bt = (
                t.clone() for t in (toks, pos, row_of, qs, ql, cl, bt))
            check(bool((cl == ql).all()),
                  "first step carried earlier context")
            first["ragged"] = dict(
                kind="ragged", pos=pos, bt=bt, pools=None, fresh=True,
                logits=out[0].clone(), hidden=grab.pop("hidden"),
                step=lambda kp, vp, bt, attn: ad.ragged_chunk(
                    eng._w, toks, pos, row_of, qs, ql, cl, kp, vp, bt,
                    attn=attn),
                slots=lambda kp, bt: generation._ragged_slots(
                    kp, bt, row_of, pos)[1])
            grab.clear()
        return out

    def keep_paged(w, toks, pos, kp, vp, bt, attn=None):
        kind = "prefill" if toks.shape[1] > 1 else "decode"
        if kind not in first and (kind == "prefill"
                                  or int((pos >= 0).sum()) >= 2):
            grab["on"] = True
        before = (pa.paged_attention.launches,
                  pa.paged_attention.launches_q8)
        out = real_paged(w, toks, pos, kp, vp, bt, attn=attn)
        tally = by_kind[kind]
        tally["K6"] += pa.paged_attention.launches - before[0]
        tally["K6-q8"] += pa.paged_attention.launches_q8 - before[1]
        if grab:
            toks, pos, bt = toks.clone(), pos.clone(), bt.clone()
            kpc, vpc, btc = snapshot_step(kp, vp, bt, pos,
                                          eng.config.block_size)
            first[kind] = dict(
                kind=kind, pos=pos.reshape(-1), bt=btc, pools=(kpc, vpc),
                fresh=kind == "prefill" and int(pos[0, 0]) == 0,
                logits=out[0].reshape(-1, out[0].shape[-1]).clone(),
                hidden=grab.pop("hidden"),
                step=lambda kp, vp, bt, attn: ad.paged_chunk(
                    eng._w, toks, pos, kp, vp, bt, attn=attn),
                slots=lambda kp, bt: generation._chunk_slots(
                    kp, bt, pos)[1])
            grab.clear()
        return out

    ad.ragged_chunk, ad.paged_chunk = keep_ragged, keep_paged
    ad.logits = keep_logits
    kernels = serving_kernels()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts set to 0 just before, read just after
    for fn, attr in kernels.values():
        setattr(fn, attr, 0)
    by_kind.update((kind, {"K6": 0, "K6-q8": 0})
                   for kind in ("prefill", "decode"))
    steps0 = (eng.ragged_steps, eng.prefill_steps, eng.decode_steps)
    t_start = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    step_s = []
    while True:
        t = time.perf_counter()
        if not eng.step():
            break
        step_s.append(time.perf_counter() - t)
    wall = time.perf_counter() - t_start
    launches = serving_counts()
    programs = [now - then for now, then in zip(
        (eng.ragged_steps, eng.prefill_steps, eng.decode_steps), steps0)]
    # ----
    peak = torch.cuda.max_memory_allocated()
    del ad.ragged_chunk, ad.paged_chunk, ad.logits   # the class's again
    reqs = [eng._requests[r] for r in rids]
    outs = [eng.result(r) for r in rids]
    # model passes: ragged steps, or prefill chunks + decode batches
    return dict(reqs=reqs, outs=outs, step_s=step_s, wall=wall,
                launches=launches, steps=sum(programs), programs=programs,
                by_kind=by_kind, peak=peak, first=first)


def check_served(run, prompts, new_tokens, vocab, want_launches, what,
                 card):
    """Streams, prefix hit and kernel counts of a served trace; prints
    the end-to-end numbers."""
    outs, reqs, steps = run["outs"], run["reqs"], run["steps"]
    for o in outs:
        check(len(o) == new_tokens, "a stream ended at %d tokens" % len(o))
        check(all(0 <= t < vocab for t in o), "token out of vocab")
    hit = reqs[-1].num_cached
    ttft = [r.first_token_at - r.arrival for r in reqs]
    n_tok = sum(len(o) for o in outs)
    print("engine %s: %d requests (%d prompt tokens, %d prefix-cache hit "
          "tokens), %d model passes (ragged, prefill, decode programs: %s) "
          "in %d engine steps, %d tokens out in %.3f s = %.1f tok/s, median "
          "engine step %.2f ms, TTFT median %.1f ms max %.1f ms, peak "
          "memory %.2f GB, kernel launches %s [%s]"
          % (what, len(prompts), sum(map(len, prompts)), hit, steps,
             run["programs"], len(run["step_s"]), n_tok,
             run["wall"], n_tok / run["wall"],
             1e3 * statistics.median(run["step_s"]),
             1e3 * statistics.median(ttft), 1e3 * max(ttft),
             run["peak"] / 1e9, run["launches"], card), flush=True)
    check(hit > 0, "the shared prefix did not hit the prefix cache")
    want = {k: per_step * steps for k, per_step in want_launches.items()}
    check(steps > 0 and run["launches"] == want,
          "%s: kernel launches %s, want %s (%d model passes)"
          % (what, run["launches"], want, steps))
    return dict(tok_s=n_tok / run["wall"], steps=steps,
                programs=run["programs"], engine_steps=len(run["step_s"]),
                median_step_ms=1e3 * statistics.median(run["step_s"]),
                ttft_median_ms=1e3 * statistics.median(ttft),
                peak_gb=run["peak"] / 1e9)


NORM_HOOKS = ("_rms", "_ln", "_add_rms", "_add_ln")


def kernel_norms():
    """The serving steps' norms as the adapters call them (K7 on the
    card), by their names in ``models/generation.py``."""
    from paddle_tpu_torch.models import generation

    return {k: getattr(generation, k) for k in NORM_HOOKS}


def plain_norms():
    """The same four functions through K7's plain versions."""
    from paddle_tpu_torch.incubate.nn.cuda import norms

    return {"_rms": lambda x, w, eps: norms.rms_norm_ref(x, w, None, eps),
            "_ln": norms.layer_norm_ref,
            "_add_rms": lambda y, res, w, eps: norms.rms_norm_ref(
                y, w, None, eps, residual=res),
            "_add_ln": lambda y, bias, res, w, b, eps: norms.layer_norm_ref(
                y, w, b, eps, bias=bias, residual=res)}


def rerun_first_step(eng, first, attn, norms, pools=None, plain=False):
    """A recorded step (``first``, see :func:`serve_main_path`) again
    with ``attn`` for attention and ``norms`` for the norms (the four
    functions of :func:`kernel_norms`, by name; the fused residual
    updates ``_add_rms`` / ``_add_ln`` return the norm and the sum), over
    ``pools`` (``(kp, vp, block_tables)``), else the record's copies of
    the pages it reads, else the engine's pools (the ragged first step
    started every row at position 0, so it reads only the K/V it writes
    itself, into the same slots). Every rerun writes the step's own K/V
    before it reads them. Returns the logits, the final hidden states,
    each layer's K rows as written at the step's slots, and the residual
    stream as each norm received it (a layer's input, its state after
    attention, ..., the final hidden states: the sums of the fused
    updates). With ``plain``, fails if a kernel count moved: a
    substitution that missed would otherwise run the kernels on the plain
    side."""
    from paddle_tpu_torch.incubate.nn.cuda.paged_attention import pool_shape
    from paddle_tpu_torch.models import generation

    ad = eng._ad
    kept = {}
    real_logits = ad.logits

    def keep_logits(w, x, h=None):
        kept["hidden"] = x
        return real_logits(w, x, h)

    stream = []

    def recorded(name, norm):
        def fn(*args):
            got = norm(*args)
            stream.append(got[1] if name.startswith("_add") else args[0])
            return got
        return fn

    if pools is None:
        pools = first["pools"] + (first["bt"],) if first["pools"] \
            else (eng._kp, eng._vp, first["bt"])
    kp, vp, bt = pools
    counts = serving_counts()
    ad.logits = keep_logits
    try:
        logits, kp, _ = patched(
            lambda: first["step"](kp, vp, bt, attn), generation,
            {name: recorded(name, norms[name]) for name in NORM_HOOKS})
    finally:
        del ad.logits
    if plain:
        torch.cuda.synchronize()
        check(serving_counts() == counts, "the plain rerun launched "
              "kernels: counts %s, before it %s" % (serving_counts(), counts))
    n_kv, total, page, d = pool_shape(kp[0])
    slots = first["slots"](kp, bt)
    written = [(p["q8"] if isinstance(p, dict) else p)
               .reshape(n_kv, total * page, d)[:, slots].clone() for p in kp]
    return (logits.reshape(-1, logits.shape[-1]), kept["hidden"], written,
            stream)


def elementwise_per_pass(eng, first):
    """Elementwise launches of one model pass, counted around it: the
    recorded step (``first``) again through the kernels under a dispatch
    mode that counts the aten operations tagged pointwise (each one
    kernel launch on the card; K4-K7 are no aten operations), then again
    with every fused residual update taken apart into PyTorch's adds and
    the plain-form K7 launch, as the adapters computed it before the
    fused form. Returns (fused count, unfused count, fused by op)."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.by_op = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if torch.Tag.pointwise in func.tags:
                self.by_op[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    kern = kernel_norms()

    def add_rms(y, res, w, eps):
        s = res + y
        return kern["_rms"](s, w, eps), s

    def add_ln(y, bias, res, w, b, eps):
        s = res + (y if bias is None else y + bias)
        return kern["_ln"](s, w, b, eps), s

    counts = []
    for norms in (kern, dict(kern, _add_rms=add_rms, _add_ln=add_ln)):
        with Count() as c:
            rerun_first_step(eng, first, None, norms)
        counts.append(c.by_op)
    return sum(counts[0].values()), sum(counts[1].values()), counts[0]


def first_step_check(eng, first, logits_tol, hidden_rtol, what):
    """A recorded step's logits and final hidden states through the
    kernels against the same step through the plain versions of every
    kernel (attention and norms): the logits element by element within
    ``logits_tol``, the logits and the hidden states token by token in
    relative L2 within ``hidden_rtol``, printed beside how far attention
    moves the hidden states. The step is also run again through the
    kernels with every kernel call held against its plain version on the
    same inputs (each layer's attention on its own q and pools, each norm
    on its own x); the residual stream of the two reruns is compared at
    every layer's input, and the K rows they write: what one layer's
    rounding difference turns into after all of them. The attention is
    K4 / K5 for a ragged step, K6 for a prefill chunk or decode batch of
    the off layout. Counts the elementwise launches of the step (see
    :func:`elementwise_per_pass`)."""
    from paddle_tpu_torch.incubate.nn.cuda import paged_attention as pa

    if first["kind"] == "ragged":
        kernel, plain = pa.ragged_paged_attention, \
            pa.ragged_paged_attention_ref
    else:
        kernel, plain = pa.paged_attention, pa.paged_attention_ref
    pos = first["pos"]
    page = eng.config.block_size
    n_pages = -(-(int(pos.max()) + 1) // page)

    def plain_attn(q, kp, vp, bt, *args, **kw):
        # the step's keys all lie in its rows' first n_pages pages: cut
        # the gather of the plain version to them
        return plain(q, kp, vp, bt[:, :n_pages], *args, **kw)

    def no_attn(q, *args, **kw):
        return torch.zeros_like(q)

    errs = {"attention": [], "norm": [], "sum": 0}

    def compared_attn(q, kp, vp, bt, *args, **kw):
        out = kernel(q, kp, vp, bt, *args, **kw)
        errs["attention"].append(
            row_err(out, plain_attn(q, kp, vp, bt, *args, **kw))[1])
        return out

    def compared(name, kernel, plain):
        # a fused update's sum must be bitwise the plain version's adds
        def fn(*args):
            got, want = kernel(*args), plain(*args)
            if name.startswith("_add"):
                errs["sum"] += int(not torch.equal(got[1], want[1]))
                out, want = got[0], want[0]
            else:
                out = got
            errs["norm"].append(norm_ratio(out, want, NORM_REL[out.dtype]))
            return got
        return fn

    kern, plain_n = kernel_norms(), plain_norms()
    again, _, k_kernel, s_kernel = rerun_first_step(
        eng, first, compared_attn,
        {k: compared(k, kern[k], plain_n[k]) for k in NORM_HOOKS})
    ref, ref_h, k_plain, s_plain = rerun_first_step(
        eng, first, plain_attn, plain_n, plain=True)
    _, bare_h, _, _ = rerun_first_step(eng, first, no_attn, plain_n,
                                       plain=True)
    if k_kernel[0].dtype == torch.int8:
        flips = [(a != b).float().mean().item()
                 for a, b in zip(k_kernel, k_plain)]
        written = "K codes written that differ: %.3g%% in layer 0, %.3g%% " \
            "in the last, %.3g%% at most" % (100 * flips[0],
                                             100 * flips[-1], 100 * max(flips))
    else:
        rel = [rel_l2(a, b) for a, b in zip(k_kernel, k_plain)]
        written = "K rows written: relative L2 %.3g in layer 0, %.3g in " \
            "the last" % (rel[0], rel[-1])
    if k_kernel[0].dtype == torch.int8 and first["fresh"]:
        # the same step over bf16 pools holding only the step's pages:
        # how far the two paths drift without int8 codes to flip (a step
        # that reads earlier context has no bf16 copy of it)
        kp0 = (first["pools"] or (eng._kp,))[0][0]
        n_kv, total, _, d = pa.pool_shape(kp0)
        used = torch.unique(first["bt"][:, :n_pages].clamp(0, total - 1))
        compact = torch.zeros(total, dtype=torch.int32, device=used.device)
        compact[used.long()] = torch.arange(len(used), dtype=torch.int32,
                                            device=used.device)
        bt16 = compact[first["bt"].clamp(0, total - 1).long()]
        dt = eng._w["wte"].dtype

        def bf16_pools():
            return [torch.zeros(n_kv, len(used), page, d, dtype=dt,
                                device=used.device)
                    for _ in range(2 * len(eng._kp))]

        p16 = bf16_pools()
        _, h16, _, _ = rerun_first_step(eng, first, None, kern,
                                        (p16[::2], p16[1::2], bt16))
        p16 = bf16_pools()
        _, h16_ref, _, _ = rerun_first_step(
            eng, first, plain_attn, plain_n, (p16[::2], p16[1::2], bt16),
            plain=True)
        del p16
        e16 = ((h16 - h16_ref).float().norm(dim=-1)
               / h16_ref.float().norm(dim=-1))[pos >= 0]
        written += "; over bf16 pools the same step's final hidden states " \
            "differ by %.4g (largest token; median %.3g)" % (
                e16.max().item(), e16.median().item())
    live = pos >= 0
    got, want = first["logits"][live].float(), ref[live].float()
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    err = (got - want).abs().max().item()
    excess = ((got - want).abs() - logits_tol["atol"]
              - logits_tol["rtol"] * want.abs()).max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    h, h_ref, h_bare = (x[live].float() for x in
                        (first["hidden"], ref_h, bare_h))
    h_err = ((h - h_ref).norm(dim=-1) / h_ref.norm(dim=-1))
    moved = ((h_bare - h_ref).norm(dim=-1) / h_ref.norm(dim=-1))
    att_max, norm_max = max(errs["attention"]), max(errs["norm"])
    logits_rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
    # the residual stream, kernels vs plain, at each layer's input and at
    # the final norm: largest per-token relative L2
    check(len(s_kernel) == len(s_plain), "the two reruns normed %d and %d "
          "times" % (len(s_kernel), len(s_plain)))
    drift = [((a[live].float() - b[live].float()).norm(dim=-1)
              / b[live].float().norm(dim=-1)).max().item()
             for a, b in zip(s_kernel[::2], s_plain[::2])]
    print("engine %s: first step, residual stream kernels vs plain (largest "
          "token's relative L2) at the input of layer 0, 1, ... and at the "
          "final norm: %s" % (what, " ".join("%.3g" % x for x in drift)))
    print("engine %s: first step (%d tokens) again through the kernels, each "
          "call against its plain version on its own inputs: %d attention "
          "calls, largest error %.4g of its row's RMS; %d norm calls, largest "
          "error %.3g of its allowance; %s; its logits repeat the main path's "
          "to %.3g" % (what, int(live.sum()), len(errs["attention"]), att_max,
                       len(errs["norm"]), norm_max, written,
                       (again - first["logits"]).abs().max().item()))
    print("engine %s: first step through the kernels vs the plain versions: "
          "logits max_abs_err %.4g (max |logit| %.3g, largest excess over "
          "atol %g + rtol %g of %.3g; largest per-token relative L2 %.4g), "
          "argmax agreement %.4f; final hidden "
          "states: largest per-token relative L2 %.4g (median %.3g); "
          "attention moves them by %.4g (median token; least %.4g)"
          % (what, err, want.abs().max().item(), logits_tol["atol"],
             logits_tol["rtol"], excess, logits_rel, agree,
             h_err.max().item(),
             h_err.median().item(), moved.median().item(),
             moved.min().item()), flush=True)
    check(att_max <= PAGED_ROW_TOL, "a layer's attention is off by %.4g of "
          "its row's RMS > %g" % (att_max, PAGED_ROW_TOL))
    check(norm_max <= 1.0, "a norm is off by %.3g of its allowance"
          % norm_max)
    check(errs["sum"] == 0, "%d fused residual updates' sums are not "
          "bitwise PyTorch's adds" % errs["sum"])
    check(bool(torch.isfinite(h).all()), "non-finite hidden states")
    check(h_err.max().item() <= hidden_rtol, "hidden states off by %.4g of "
          "their norm > %g" % (h_err.max().item(), hidden_rtol))
    check(logits_rel <= hidden_rtol, "logits off by %.4g of their norm > %g"
          % (logits_rel, hidden_rtol))
    torch.testing.assert_close(got, want, **logits_tol)
    fused, unfused, by_op = elementwise_per_pass(eng, first)
    # the unfused updates add the residual, and a linear's bias first
    drop = sum(2 + sum(W.get(k) is not None for k in ("out_b", "fc2_b"))
               for W in eng._w["layers"])
    print("engine %s: elementwise launches of the pass, counted around it: "
          "%d (%s); with each residual update taken apart into PyTorch's "
          "adds and the norm (the unfused composition): %d, %d more"
          % (what, fused, ", ".join("%s %d" % kv for kv in
                                    sorted(by_op.items())), unfused,
             unfused - fused), flush=True)
    check(unfused - fused == drop, "%s: fusing the residual updates saved "
          "%d elementwise launches a pass, not %d" % (what, unfused - fused,
                                                      drop))
    return dict(elementwise_launches=fused,
                elementwise_launches_unfused=unfused,
                logits_err=err, logits_rel_l2=logits_rel,
                hidden_rel_l2=h_err.max().item(),
                moved_median=moved.median().item(),
                attention_row_err=att_max, norm_ratio=norm_max,
                stream_drift=drift)


def engine_phase(card):
    """GPT-3 1.3B serving over bf16 pools: K4 once per layer per step,
    K7's LayerNorm twice per layer and once before the head. Returns the
    numbers, the model (for the off layout and the profile) and the
    streams."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3B
    from paddle_tpu_torch.serving import ServingEngine

    cfg = gpt3_1p3B()
    t0 = time.perf_counter()
    model = GPTForCausalLM(
        cfg, dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(0))
    eng = ServingEngine(model, **SERVE_ENGINE)
    eng.warmup()
    torch.cuda.synchronize()
    print("engine: gpt3_1p3B bf16 (%d layers, hidden %d, %d heads, vocab "
          "%d) built and warmed up in %.2f s"
          % (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
             cfg.vocab_size, time.perf_counter() - t0), flush=True)
    prompts, new_tokens = traffic(cfg.vocab_size)
    run = serve_main_path(eng, prompts, new_tokens)
    L = cfg.num_layers
    res = check_served(run, prompts, new_tokens, cfg.vocab_size,
                       {"K4": L, "K5": 0, "K6": 0, "K6-q8": 0,
                        "K7 rms_norm": 0, "K7 layer_norm": 2 * L + 1,
                        "K7 rms_norm fused": 0,
                        "K7 layer_norm fused": 2 * L},
                       "gpt3_1p3B", card)
    eng.shutdown()                     # raises on a leaked block
    res.update(first_step_check(eng, run["first"]["ragged"], LOGITS_TOL,
                                SERVE_HIDDEN_RTOL, "gpt3_1p3B"))
    res["launches"] = run["launches"]
    return res, model, run["outs"]


def llama_engine_phase(card, seeds=(0, 1, 2)):
    """Llama-2 7B (bf16, full width and depth) serving over int8 pools:
    per step K5 once per layer and K7's RMSNorm twice per layer and once
    before the head. The main path runs on weights and traffic from seed
    0; each further seed serves its own weights and trace the same way,
    so that the first step's limits rest on more than one reading.
    Returns seed 0's numbers (the others under ``"seeds"``), seed 0's
    model (for the off layout and the profile) and its streams."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7B
    from paddle_tpu_torch.serving import ServingEngine

    cfg = llama2_7B()
    L = cfg.num_layers
    res = None
    for seed in seeds:
        what = "llama2_7B int8" + (" seed %d" % seed if seed else "")
        t0 = time.perf_counter()
        model = LlamaForCausalLM(
            cfg, dtype=torch.bfloat16,
            generator=torch.Generator(device="cuda").manual_seed(seed))
        n_params = sum(p.numel() for p in model.parameters())
        eng = ServingEngine(model, kv_quant="int8", **SERVE_ENGINE)
        pool_bytes = sum(t.numel() * t.element_size()
                         for p in eng._kp + eng._vp for t in p.values())
        eng.warmup()
        torch.cuda.synchronize()
        print("engine: %s bf16 (%d layers, hidden %d, %d heads / %d kv, ffn "
              "%d, vocab %d, %d parameters) with int8 KV pools of %.2f GB, "
              "built and warmed up in %.2f s"
              % (what, cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                 cfg.num_kv_heads, cfg.intermediate_size, cfg.vocab_size,
                 n_params, pool_bytes / 1e9, time.perf_counter() - t0),
              flush=True)
        prompts, new_tokens = traffic(cfg.vocab_size, seed=seed)
        run = serve_main_path(eng, prompts, new_tokens)
        r = check_served(run, prompts, new_tokens, cfg.vocab_size,
                         {"K4": 0, "K5": L, "K6": 0, "K6-q8": 0,
                          "K7 rms_norm": 2 * L + 1, "K7 layer_norm": 0,
                          "K7 rms_norm fused": 2 * L,
                          "K7 layer_norm fused": 0},
                         what, card)
        eng.shutdown()                 # raises on a leaked block
        r.update(first_step_check(eng, run["first"]["ragged"],
                                  LLAMA_LOGITS_TOL, LLAMA_HIDDEN_RTOL, what))
        r["launches"] = run["launches"]
        if res is None:
            res, kept, outs = dict(r, seeds={}), model, run["outs"]
        else:
            res["seeds"][seed] = r
        del eng, run, model
        torch.cuda.empty_cache()
    return res, kept, outs


def off_engine_phase(card, model, what, ragged_outs, per_pass, logits_tol,
                     hidden_rtol, **knobs):
    """The two-program layout (``ragged="off"``) on a model the ragged
    phase built, with its engine's knobs: the same 12-request trace (seed
    0). Each prefill chunk and each decode batch is one model pass, which
    launches ``per_pass`` kernels (K6 or K6-q8 once a layer, K7 2L + 1
    times; never K4 or K5). The first prefill chunk and the first decode
    batch with two live rows are held against the same step through the
    plain versions of every kernel. Prints, and does not check, the share
    of greedy tokens equal to the ragged layout's stream: random bf16
    weights leave the top logits within rounding of each other."""
    from paddle_tpu_torch.serving import ServingEngine

    vocab = model.config.vocab_size
    t0 = time.perf_counter()
    eng = ServingEngine(model, ragged="off", **knobs, **SERVE_ENGINE)
    eng.warmup()
    torch.cuda.synchronize()
    print("engine: %s, ragged=off, warmed up in %.2f s"
          % (what, time.perf_counter() - t0), flush=True)
    prompts, new_tokens = traffic(vocab)
    run = serve_main_path(eng, prompts, new_tokens)
    res = check_served(run, prompts, new_tokens, vocab, per_pass, what,
                       card)
    check(run["programs"][0] == 0 and min(run["programs"][1:]) > 0,
          "%s: programs run %s (ragged, prefill, decode)"
          % (what, run["programs"]))
    # K6's launches by the pass that made them, as counted around each
    # pass: a prefill chunk of rows that share a table or a decode batch
    # of rows with a table each
    route = "K6" if per_pass["K6"] else "K6-q8"
    split = {"prefill_steps": run["by_kind"]["prefill"][route],
             "decode_steps": run["by_kind"]["decode"][route]}
    other = "K6-q8" if route == "K6" else "K6"
    check(sum(split.values()) == run["launches"][route]
          and run["by_kind"]["prefill"][other] == 0
          and run["by_kind"]["decode"][other] == 0,
          "%s: K6 launches by pass %s do not add up to the counts %s"
          % (what, run["by_kind"], run["launches"]))
    for key, n in zip(split, run["programs"][1:]):
        check(split[key] == per_pass[route] * n,
              "%s: %s launched %d times in %d %s, not %d a pass"
              % (what, route, split[key], n, key, per_pass[route]))
    res["launches_by_program"] = {route: split}
    print("engine %s: %s launched %d times in %d prefill chunks "
          "(prefill_steps) and %d times in %d decode batches "
          "(decode_steps), as counted around each pass [%s]"
          % (what, route, split["prefill_steps"], run["programs"][1],
             split["decode_steps"], run["programs"][2], card), flush=True)
    eng.shutdown()                     # raises on a leaked block
    for kind in ("prefill", "decode"):
        check(kind in run["first"], "%s: no %s step to check" % (what, kind))
        res[kind] = first_step_check(eng, run["first"][kind], logits_tol,
                                     hidden_rtol, "%s %s" % (what, kind))
    same = sum(a == b for o, r in zip(run["outs"], ragged_outs)
               for a, b in zip(o, r))
    total = sum(len(o) for o in run["outs"])
    res["greedy_share_equal_to_ragged"] = same / total
    print("engine %s: %d of %d greedy tokens (%.4f) equal the ragged "
          "layout's stream (printed, not checked)"
          % (what, same, total, same / total), flush=True)
    res["launches"] = run["launches"]
    return res


# kernel-name fragments -> group, first match wins
PROFILE_GROUPS = (
    ("flash K1-K3", ("flash_fwd_", "flash_bwd_")),
    # K4 / K5 and the merge of their split partials, by the pool's flag
    ("K5", ("ragged_paged_attention_kernel<__nv_bfloat16, true",
            "ragged_paged_attention_kernel<float, true",
            "ragged_paged_attention_merge_kernel<__nv_bfloat16, true",
            "ragged_paged_attention_merge_kernel<float, true")),
    ("K4", ("ragged_paged_attention_kernel",
            "ragged_paged_attention_merge_kernel")),
    ("K6-q8", ("paged_decode_kernel<__nv_bfloat16, true",
               "paged_decode_kernel<float, true")),
    ("K6", ("paged_decode_kernel",)),
    ("K7", ("row_norm_kernel",)),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("copies and casts", ("copy",)),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)


def print_profile(prof, wall_us, what, card):
    """Device busy share over ``wall_us`` and the kernels with the most
    device time, from a torch.profiler run."""
    # (the record_function scopes of train_profile also show on the
    # device's timeline: they are ranges, not kernels)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and e.key not in TRAIN_SCOPES]
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
        g = group_of(e.key)
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


def profile_phase(card, model, what, **knobs):
    """Where an engine step's device time goes: a fresh engine on
    ``model`` serves 8 new requests of 16 new tokens under
    torch.profiler. Runs after the main paths."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, **knobs)
    eng.warmup()
    prompts, new_tokens = traffic(model.config.vocab_size, seed=1, n=8,
                                  new_tokens=16)
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
    print_profile(prof, wall_us, "serve %s (%d steps)" % (what, steps),
                  card)


# training's kernels other than the GEMMs and K1-K3, by the operation
# that launched them: a name fragment of the launching CPU operation or of
# one of its ancestors (lower case), first match wins. AdamW's update,
# the chunked CE's forward, MoE routing and a block's recompute run inside
# the record_function scopes TRAIN_SCOPES that train_profile opens; the
# CE's and K7's backward are their autograd nodes.
TRAIN_SCOPES = ("AdamW.update", "ChunkedLMHeadCE.forward",
                "MoE.gshard_top2", "block recompute")
TRAIN_SOURCES = (
    ("AdamW", ("adamw.update",)),
    ("chunked CE", ("chunkedlmheadce",)),
    ("MoE routing", ("moe.gshard_top2",)),
    ("LayerNorm", ("layer_norm",)),
    ("RMSNorm", ("rownorm", "rms_norm")),
    ("gelu", ("gelu",)),
    ("SwiGLU silu", ("silu",)),
)
NOT_SPLIT = ("GEMM (cuBLAS)", "flash K1-K3")


def group_of(kernel_name):
    return next((name for name, pat in PROFILE_GROUPS
                 if any(x in kernel_name for x in pat)), "other")


def print_elementwise_split(prof, steps, card, what):
    """The device time of every kernel but the GEMMs and K1-K3 (the
    elementwise, reduction, copy and other groups) split by
    TRAIN_SOURCES, from the profiler's tree of CPU operations (each CPU
    operation lists the kernels it launched)."""
    split, total = {}, 0.0
    for evt in prof.events():
        if not evt.kernels:
            continue
        names, e = [], evt
        while e is not None:
            names.append(e.name.lower())
            e = e.cpu_parent
        chain = " ".join(names)
        src = next((name for name, pat in TRAIN_SOURCES
                    if any(x in chain for x in pat)), "other")
        for kern in evt.kernels:
            if group_of(kern.name) not in NOT_SPLIT and \
                    kern.name not in TRAIN_SCOPES:
                split[src] = split.get(src, 0.0) + kern.duration
                total += kern.duration
    if total == 0:
        print("profile train %s: elementwise split: no kernel linked to a "
              "CPU operation: not measured" % what)
        return
    print("profile train %s: kernels other than %s, %.2f ms a step, by "
          "launching operation: %s [%s]" % (what, " and ".join(NOT_SPLIT),
                                            total / 1e3 / steps, ", ".join(
              "%s %.2f ms (%.1f%%)" % (k, us / 1e3 / steps, 100 * us / total)
              for k, us in sorted(split.items(), key=lambda kv: -kv[1])),
                                  card), flush=True)


def print_scope_split(prof, scope, steps, card, what):
    """The device time of every kernel launched inside the
    record_function ``scope`` (any depth), by PROFILE_GROUPS."""
    groups, total = {}, 0.0
    for evt in prof.events():
        if not evt.kernels:
            continue
        e = evt.cpu_parent
        while e is not None and e.name != scope:
            e = e.cpu_parent
        if e is None:
            continue
        for kern in evt.kernels:
            if kern.name in TRAIN_SCOPES:
                continue
            g = group_of(kern.name)
            groups[g] = groups.get(g, 0.0) + kern.duration
            total += kern.duration
    if total == 0:
        print("profile train %s: %s: no kernel linked to it: not measured"
              % (what, scope))
        return
    print("profile train %s: %s: %.2f ms a step: %s [%s]" % (
        what, scope, total / 1e3 / steps, ", ".join(
            "%s %.2f ms" % (g, us / 1e3 / steps)
            for g, us in sorted(groups.items(), key=lambda kv: -kv[1])),
        card), flush=True)


def train_profile(step, batch, card, what, steps=2):
    """Where a training step's device time goes: ``steps`` more steps of
    the training phase's TrainStep under torch.profiler, with AdamW's
    update, the chunked CE's forward, MoE routing and each block's
    recompute (its forward run again in the backward) in record_function
    scopes."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch.fusion import chunked, moe

    ce = chunked._ChunkedLMHeadCE
    ce_forward, update, route = ce.forward, step.optimizer.update, \
        moe.gshard_top2
    model = step.model
    block = type((model.llama.layers if hasattr(model, "llama")
                  else model.gpt.h)[0])
    body = block._body
    in_backward = getattr(torch._C, "_current_graph_task_id", None)

    def scoped(label, fn):
        def run(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return run

    def scoped_body(self, *args, **kw):
        # a recompute: the block's forward inside the backward
        if in_backward is not None and in_backward() != -1:
            with record_function(TRAIN_SCOPES[3]):
                return body(self, *args, **kw)
        return body(self, *args, **kw)

    torch.cuda.synchronize()
    ce.forward = staticmethod(scoped(TRAIN_SCOPES[1], ce_forward))
    step.optimizer.update = scoped(TRAIN_SCOPES[0], update)
    moe.gshard_top2 = scoped(TRAIN_SCOPES[2], route)
    block._body = scoped_body
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step(*batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        ce.forward = staticmethod(ce_forward)
        del step.optimizer.update
        moe.gshard_top2 = route
        block._body = body
    print_profile(prof, wall_us, "train %s (%d steps)" % (what, steps), card)
    print_elementwise_split(prof, steps, card, what)
    if any(blk.recompute for blk in (model.llama.layers
                                     if hasattr(model, "llama")
                                     else model.gpt.h)):
        print_scope_split(prof, TRAIN_SCOPES[3], steps, card, what)


# ----------------------------------------------------------- phase 9a
# fused_moe at bench.py's configuration through K8 against the same op
# through K8's plain version (relative L2 per token: the same routing and
# roundings but for the two products' f32 summation order, whose bf16
# roundings of h flip by an ulp), and on 256 of its tokens against a
# dense per-token f32 reference that shares no code with sort_dispatch (the
# op rounds h, the expert outputs and the combine to bf16: a few bf16
# ulps). Read on an H100: 0.0032 against the plain path, 0.0058 against
# the dense reference (the plain path 0.0058 too); limits ~3x above. A
# token sent to a wrong expert reads ~1.
MOE_PLAIN_RTOL = 1e-2
MOE_DENSE_RTOL = 1.5e-2


def dense_moe_ref(x, gate, w1, w2, k, rows):
    """Each token of ``rows`` on its own, in f32, without sort_dispatch:
    the sum over experts of its routing weight (its top-k probabilities,
    ties to the lower expert, renormalised; 0 for other experts) times
    the expert's SwiGLU FFN. The router logits come from the same
    expression over all tokens as the op's, so both route alike."""
    probs = torch.softmax((x @ gate).float(), -1)
    order_p, order_e = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    top_p, top_e = order_p[rows, :k], order_e[rows, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    xs = x[rows].float()
    out = torch.zeros_like(xs)
    for e in range(w1.shape[0]):
        weight = (top_p * (top_e == e)).sum(-1, keepdim=True)
        out += weight * (swiglu(xs @ w1[e].float()) @ w2[e].float())
    return out


def moe_phase(card):
    """The MoE path at bench.py's configuration (``_bench_moe``): bf16,
    random weights from seed 0. ``fused_moe`` on x [1, 8192, 2048] with a
    [2048, 8] router weight, its K8 count set to 0 just before and read
    just after (2 launches); held against the same op through the plain
    version and, on 256 tokens, against a dense f32 reference; then
    bench.py's timing: ``moe_ffn_sorted`` chained 8 and 24 times,
    step = (t24 - t8) / 16, TFLOP/s by bench.py's flops count against the
    989 dense bf16 TFLOP/s, and peak memory."""
    from paddle_tpu_torch.incubate.nn import functional as fn
    from paddle_tpu_torch.incubate.nn.cuda import moe_dispatch as kmd
    from paddle_tpu_torch.incubate.nn.functional import moe_dispatch as fmd

    cfg = MOE_BENCH
    s, m, dff, k = cfg["tokens"], cfg["hidden"], cfg["dff"], cfg["topk"]
    x, gate, w1, w2 = moe_problem(**cfg)
    kmd.grouped_matmul.launches = 0
    out = fn.fused_moe(x[None], gate, w1, w2, moe_topk=k)
    torch.cuda.synchronize()
    launches = kmd.grouped_matmul.launches
    check(launches == 2, "fused_moe launched K8 %d times, not twice"
          % launches)
    check(tuple(out.shape) == (1, s, m) and out.dtype == torch.bfloat16,
          "fused_moe: shape %s %s" % (tuple(out.shape), out.dtype))
    check(bool(torch.isfinite(out).all()), "fused_moe: non-finite")

    kernel = fmd.grouped_matmul
    fmd.grouped_matmul = kmd.grouped_matmul_ref
    try:
        plain = fn.fused_moe(x[None], gate, w1, w2, moe_topk=k)
    finally:
        fmd.grouped_matmul = kernel
    torch.cuda.synchronize()
    check(kmd.grouped_matmul.launches == launches,
          "the plain path launched K8")
    vs_plain = rel_l2(out[0], plain[0], dim=-1)
    rows = torch.arange(0, s, s // 256, device="cuda")
    dense = dense_moe_ref(x, gate, w1, w2, k, rows)
    vs_dense = rel_l2(out[0, rows], dense, dim=-1)
    plain_vs_dense = rel_l2(plain[0, rows], dense, dim=-1)
    print("moe: fused_moe [1, %d, %d] bf16, %d experts, top-%d: K8 "
          "launches %d; relative L2 per token vs the plain path %.4g "
          "(limit %g), vs the dense f32 reference on %d tokens %.4g (limit "
          "%g; the plain path %.4g) [%s]"
          % (s, m, cfg["experts"], k, launches, vs_plain, MOE_PLAIN_RTOL,
             len(rows), vs_dense, MOE_DENSE_RTOL, plain_vs_dense, card),
          flush=True)
    check(vs_plain <= MOE_PLAIN_RTOL, "fused_moe vs the plain path: %.4g"
          % vs_plain)
    check(vs_dense <= MOE_DENSE_RTOL, "fused_moe vs the dense reference: "
          "%.4g" % vs_dense)
    del out, plain, dense

    probs, d = moe_routing(x, gate, k)
    dispatch_ms = cuda_ms(lambda: kmd.sort_dispatch(x, probs, k), iters=20)
    # moe_ffn_sorted passes both products the dispatch's row counts
    counts = kmd.block_rows(d["block_gid"], d["group_sizes"],
                            d["padded_sizes"])
    padding_blocks, n_blocks = int((counts == 0).sum()), counts.numel()
    del d, counts

    def window(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = x
        for _ in range(n):
            c = fmd.moe_ffn_sorted(c, probs, w1, w2, k=k).to(c.dtype)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    before = kmd.grouped_matmul.launches
    times = {}
    for n in (8, 24):
        window(n)                              # as bench.py: warm, then time
        times[n] = window(n)
    check(kmd.grouped_matmul.launches - before == 2 * 2 * (8 + 24),
          "the timed MoE steps launched K8 %d times"
          % (kmd.grouped_matmul.launches - before))
    peak = torch.cuda.max_memory_allocated()
    step = max(times[24] - times[8], 1e-9) / 16
    flops = 2 * s * k * m * 2 * dff + 2 * s * k * dff * m
    tflops = flops / step / 1e12
    res = dict(tokens=s, hidden=m, dff=dff, experts=cfg["experts"], topk=k,
               dtype="bfloat16", launches=launches, step_ms=step * 1e3,
               dispatch_ms=dispatch_ms, padding_blocks=padding_blocks,
               t8_s=times[8], t24_s=times[24], tflops=tflops,
               share_of_peak=tflops * 1e12 / BF16_FLOPS_PER_S,
               peak_gb=peak / 1e9, vs_plain_rel_l2=vs_plain,
               vs_dense_rel_l2=vs_dense, plain_vs_dense_rel_l2=plain_vs_dense,
               card=card)
    print("moe: moe_ffn_sorted step %.4f ms (chained 8: %.4f s, 24: %.4f s), "
          "%.2f TFLOP/s (%.3f of 989), peak %.2f GB; sort_dispatch alone "
          "%.4f ms; K8 with the dispatch's row counts (%d of %d row blocks "
          "padding only) [%s]"
          % (res["step_ms"], times[8], times[24], tflops,
             res["share_of_peak"], res["peak_gb"], dispatch_ms,
             padding_blocks, n_blocks, card), flush=True)
    return res


# ------------------------------------------------------------ phase 9d
# bench.py's decode sub-bench (_bench_decode) on the port: GPT-3 1.3B in
# bf16, 8 prompts of 128 tokens from np.random.default_rng(2), each tier
# timed over bench.py's two-point window (64 and 192 new tokens after one
# warm-up call of 64: (t192 - t64) / 128 a step)
DECODE_BATCH, DECODE_PROMPT = 8, 128
DECODE_WINDOW = (64, 192)
DECODE_TIERS = {"bf16": {},
                "int8_kv8": dict(weight_quant="int8", kv_cache_quant="int8"),
                "int4_kv8": dict(weight_quant="int4", kv_cache_quant="int8")}
# bench.py's speculative datapoint: int8 weights and KV, gamma 4, the
# first 6 blocks as the draft, 128 new tokens
SPEC_KW = dict(weight_quant="int8", kv_cache_quant="int8", gamma=4,
               draft_layers=6)
SPEC_NEW = 128
# the greedy streams through the kernels and through the plain versions
# (bf16) are compared over the window's first length, the agreement
# printed (random weights leave near ties among 50304 logits; a flip
# changes the rest of the row's stream)
# Llama-2 7B: generate at b 8 over a 64-step window (t80 - t16), beam
# search of 4 beams on b 2 with 32 new tokens
LLAMA_DECODE_WINDOW = (16, 80)
LLAMA_BEAM = dict(batch=2, num_beams=4, new=32)
# the exact checks at full width in f32 (two layers): new tokens
EXACT_NEW = 32
# the cached forward loop's logits there against the same loop through
# the plain versions, fed the same tokens: the CPU tests' limit for the
# cached forward against the JAX package's; read on an H100 at 9.78e-6
# (GPT-3 1.3B) and 2.22e-5 (Llama-2 7B) max abs
CACHED_LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
# the decode steps a profile covers (after a prefill outside it)
DECODE_PROFILE_STEPS = 16


def decode_kernels():
    """The decode paths' kernels by name: (wrapper, counter)."""
    from paddle_tpu_torch.incubate.nn.cuda import flash_attn as fa
    from paddle_tpu_torch.incubate.nn.cuda import norms

    return {"K1": (fa.flash_fwd, "launches"),
            "K7 rms_norm": (norms.rms_norm, "launches"),
            "K7 rms_norm fused": (norms.rms_norm, "launches_fused"),
            "K7 layer_norm": (norms.layer_norm, "launches"),
            "K7 layer_norm fused": (norms.layer_norm, "launches_fused")}


def counted(fn):
    """``fn()`` with every decode kernel's count set to 0 just before it
    and read just after: (its result, the counts)."""
    kernels = decode_kernels()
    for f, attr in kernels.values():
        setattr(f, attr, 0)
    out = fn()
    return out, {k: getattr(f, attr) for k, (f, attr) in kernels.items()}


def generate_launches(model, new, beams=1):
    """The launches of one ``generate`` (or beam search) of ``new``
    tokens: the prefill runs K1 once a layer and K7 2L + 1 times (each
    residual update fused with the norm after it but the last, which is
    two adds, then the head's norm on the last row), each of the new - 1
    decode steps K7 2L + 1 times (2L fused: the final norm rides the last
    update) and no K1 (its attention over the dense cache is plain)."""
    L = model.config.num_layers
    norm = "rms_norm" if hasattr(model, "llama") else "layer_norm"
    want = {k: 0 for k in decode_kernels()}
    want["K1"] = L
    want["K7 " + norm] = (2 * L + 1) * new
    want["K7 %s fused" % norm] = 2 * L - 1 + 2 * L * (new - 1)
    return want


def cached_launches(model, calls):
    """The launches of ``calls`` calls of ``forward(caches=...)``: K1
    once a layer a call (a prompt with past 0 causal, a token with a
    cache full); GPT's LayerNorm is PyTorch's, Llama's RMSNorm K7 (2L +
    1 a call, L of them the fused residual update)."""
    L = model.config.num_layers
    want = {k: 0 for k in decode_kernels()}
    want["K1"] = L * calls
    if hasattr(model, "llama"):
        want["K7 rms_norm"] = (2 * L + 1) * calls
        want["K7 rms_norm fused"] = L * calls
    return want


def plain_generation(fn):
    """``fn()`` with the decode engine's attention (K1 in the prefill)
    and norms (K7) replaced in ``models/generation.py`` by their plain
    versions."""
    from paddle_tpu_torch.models import generation

    return patched(fn, generation, dict(
        plain_norms(), scaled_dot_product_attention=plain_attention))


def decode_model(factory, seed=0, dtype=torch.bfloat16, **overrides):
    """A decode path's model on the card in eval mode, weights drawn from
    a generator there seeded ``seed``."""
    from paddle_tpu_torch import models

    cfg = dataclasses.replace(getattr(models, factory)(), **overrides)
    cls = models.LlamaForCausalLM if factory.startswith("llama") else \
        models.GPTForCausalLM
    model = cls(cfg, dtype=dtype,
                generator=torch.Generator(device="cuda").manual_seed(seed))
    return model.eval()


def decode_ids(vocab, batch=DECODE_BATCH, prompt=DECODE_PROMPT, seed=2):
    """bench.py's prompts: ``np.random.default_rng(2).integers(0, vocab,
    (8, 128))``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (batch, prompt))
                            .astype(np.int32)).cuda()


def window_times(fn, window):
    """bench.py's two-point window over ``fn(n)``: one warm-up call of
    the shorter length (eager PyTorch compiles nothing per length, it
    only warms the allocator and the libraries), then each length timed
    once. For each: (seconds, result, the kernel counts of that call,
    every count 0 just before it)."""
    fn(window[0])
    out = []
    for n in window:
        torch.cuda.synchronize()
        t = time.perf_counter()
        got, launches = counted(lambda: fn(n))
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t, got, launches))
    return out


def timed_generate(fn):
    """Seconds of ``fn()`` after a warm-up call of its own (bench.py's
    ``timed_gen``), and its result."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t, out


def tree_bytes(tree):
    """Bytes of every tensor in a weight tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if \
        isinstance(tree, torch.Tensor) else 0


def step_bytes(model, tier, total):
    """The bytes a decode step must read: the served weights (every
    layer's, the final norm's and the head's: ``lm_head``, or ``wte``
    tied; the embedding rows of 8 tokens are left out) and the whole
    ``total``-slot KV cache of every layer (bf16, or int8 codes and f32
    scales)."""
    from paddle_tpu_torch.models import generation

    ad = model.decode_adapter()
    w = generation._resolve_weight_quant(model, ad.weights,
                                         tier.get("weight_quant"))
    head = w["wte"] if w["lm_head"] is None else w["lm_head"]
    weights = tree_bytes([w["layers"], head] + [
        v for k, v in w.items() if k not in ("layers", "lm_head", "wte",
                                             "wpe")])
    cfg = model.config
    slots = 2 * cfg.num_layers * DECODE_BATCH * ad.num_kv_heads * total
    cache = slots * (ad.head_dim + 4 if tier.get("kv_cache_quant")
                     else 2 * ad.head_dim)
    return weights, cache


def decode_logits_check(model, ids, tier, what, tol, rtol):
    """The prefill's last-row logits and the first decode step's, through
    the kernels (K1, K7) and through their plain versions, the same
    prompt and weights: held element by element within ``tol`` and in
    relative L2 within ``rtol`` (GPT-3 1.3B: LOGITS_TOL and
    SERVE_HIDDEN_RTOL; Llama-2 7B: LLAMA_LOGITS_TOL and
    LLAMA_DECODE_LOGITS_RTOL, its 32 layers' bf16 drift)."""
    from paddle_tpu_torch.models import generation

    ad = model.decode_adapter()
    w = generation._activate_q4(generation._resolve_weight_quant(
        model, ad.weights, tier.get("weight_quant")))
    b, plen = ids.shape
    total = plen + 4
    slots = torch.arange(total, device=ids.device)
    pos = torch.full((), plen, dtype=torch.int64, device=ids.device)

    def run(tok=None):
        # the plain run steps on the kernels' token: a near tie of the
        # prefill's logits would otherwise feed the two runs other tokens
        x, ck, cv = ad.prefill(w, ids, total,
                               kv_quant=bool(tier.get("kv_cache_quant")))
        lg0 = ad.logits(w, x[:, -1])
        own = lg0.argmax(-1).to(torch.int32)
        lg1, _, _ = ad.step(w, own if tok is None else tok, pos, ck, cv,
                            slots <= pos)
        return lg0.float(), lg1.float(), own

    got = run()
    want = plain_generation(lambda: run(got[2]))
    torch.cuda.synchronize()
    res = {}
    for name, g, p in (("prefill", got[0], want[0]),
                       ("step", got[1], want[1])):
        check(bool(torch.isfinite(g).all()), "%s %s: non-finite logits"
              % (what, name))
        err, rel = (g - p).abs().max().item(), rel_l2(g, p)
        check(torch.allclose(g, p, **tol), "%s %s logits: max abs "
              "err %.4g against the plain versions" % (what, name, err))
        check(rel <= rtol, "%s %s logits: relative L2 %.4g against the "
              "plain versions > %g" % (what, name, rel, rtol))
        res[name + "_logits_max_abs_err"] = err
        res[name + "_logits_rel_l2"] = rel
    res["first_token_agreement"] = (got[2] == want[2]).float().mean().item()
    return res


def profile_decode(model, ids, tier, what, card):
    """torch.profiler over DECODE_PROFILE_STEPS greedy decode steps (the
    loop of ``generate``, after a prefill outside the profile): the
    device's busy share and the kernels by group (the int8 tiers' weight
    dequantization shows as "copies and casts")."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models import generation

    ad = model.decode_adapter()
    w = generation._activate_q4(generation._resolve_weight_quant(
        model, ad.weights, tier.get("weight_quant")))
    b, plen = ids.shape
    total = plen + DECODE_PROFILE_STEPS + 1
    x, ck, cv = ad.prefill(w, ids, total,
                           kv_quant=bool(tier.get("kv_cache_quant")))
    tok = ad.logits(w, x[:, -1]).argmax(-1).to(torch.int32)
    slots = torch.arange(total, device=ids.device)
    pos = torch.full((), plen, dtype=torch.int64, device=ids.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(DECODE_PROFILE_STEPS):
            lg, ck, cv = ad.step(w, tok, pos, ck, cv, slots <= pos)
            tok = lg.argmax(-1).to(torch.int32)
            pos = pos + 1
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    print_profile(prof, wall_us, "decode %s %s (%d steps)"
                  % (what, "+".join(tier.values()) or "bf16",
                     DECODE_PROFILE_STEPS), card)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels)
    copies = sum(e.self_device_time_total for e in kernels
                 if group_of(e.key) == "copies and casts")
    return dict(wall_ms=wall_us / 1e3, busy_share=busy / wall_us
                if busy else None, copies_ms_per_step=copies / 1e3
                / DECODE_PROFILE_STEPS if busy else None)


def gpt_decode_phase(card):
    """(a) bench.py's decode sub-bench on the port, (b) its speculative
    datapoint, (c) the eager cached-forward loop; see DECODE_*."""
    model = decode_model("gpt3_1p3B")
    cfg = model.config
    ids = decode_ids(cfg.vocab_size)
    res = {"batch": DECODE_BATCH, "prompt": DECODE_PROMPT,
           "window": list(DECODE_WINDOW), "tiers": {}}
    total = DECODE_PROMPT + DECODE_WINDOW[1]
    first = {}      # each tier's first window call: tokens, launches
    for tag, kw in DECODE_TIERS.items():
        torch.cuda.reset_peak_memory_stats()
        (t1, short, launches), (t2, out, _) = window_times(
            lambda n: model.generate(ids, max_new_tokens=n, **kw),
            DECODE_WINDOW)
        first[tag] = short, launches
        peak = torch.cuda.max_memory_allocated()
        check(out.shape == (DECODE_BATCH, DECODE_WINDOW[1])
              and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              "decode %s: tokens out of range" % tag)
        step_s = (t2 - t1) / (DECODE_WINDOW[1] - DECODE_WINDOW[0])
        wbytes, cbytes = step_bytes(model, kw, total)
        bound_ms = (wbytes + cbytes) / HBM_BYTES_PER_S * 1e3
        qtree = getattr(model, {"int8": "_gen_quant_w", "int4":
                                "_gen_quant_w4"}.get(
                                    kw.get("weight_quant"), ""), None)
        r = dict(tokens_s=DECODE_BATCH / step_s, ms_per_step=step_s * 1e3,
                 t_short_s=t1, t_long_s=t2, bound_ms=bound_ms,
                 bound_by="bytes", weight_bytes=wbytes, cache_bytes=cbytes,
                 of_bound=bound_ms / (step_s * 1e3), peak_gb=peak / 1e9,
                 quant_tree_gb=None if qtree is None
                 else tree_bytes(qtree) / 1e9, card=card)
        r.update(decode_logits_check(model, ids, kw, "decode " + tag,
                                     LOGITS_TOL, SERVE_HIDDEN_RTOL))
        r["profile"] = profile_decode(model, ids, kw, "gpt3_1p3B", card)
        res["tiers"][tag] = r
        print("decode gpt3_1p3B %s: %.1f tokens/s, %.4f ms a step (%d -> "
              "%d new: %.3f s -> %.3f s), bound %.4f ms (%.3f GB of "
              "weights + %.3f GB of cache at %d slots, over 3.35 TB/s; %.3f "
              "of it), peak %.2f GB, quantized tree %s GB; vs plain: "
              "prefill %.4g, step %.4g max abs [%s]"
              % (tag, r["tokens_s"], r["ms_per_step"], *DECODE_WINDOW, t1,
                 t2, bound_ms,
                 wbytes / 1e9, cbytes / 1e9, total, r["of_bound"],
                 r["peak_gb"], "%.3f" % r["quant_tree_gb"]
                 if qtree is not None else "-",
                 r["prefill_logits_max_abs_err"],
                 r["step_logits_max_abs_err"], card), flush=True)

    # the launches of the bf16 tier's timed generate of the window's
    # first length
    n = DECODE_WINDOW[0]
    got, launches = first["bf16"]
    want = generate_launches(model, n)
    check(launches == want, "decode: launches %s, want %s"
          % (launches, want))
    plain = plain_generation(lambda: model.generate(ids, max_new_tokens=n))
    res["launches"] = launches
    res["greedy_agreement_vs_plain"] = (got == plain).float().mean().item()
    print("decode gpt3_1p3B bf16: %d new tokens, launches %s; greedy "
          "tokens equal to the plain versions' run: %.4f [%s]"
          % (n, launches, res["greedy_agreement_vs_plain"], card),
          flush=True)

    # (b) speculative decoding, bench.py's datapoint (its warm-up call
    # shorter: eager PyTorch compiles nothing, it only warms the caches)
    speculative(model, ids, 16, **SPEC_KW)
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks, stats = speculative(model, ids, SPEC_NEW, **SPEC_KW)
    torch.cuda.synchronize()
    t = time.perf_counter() - t
    greedy = model.generate(ids, max_new_tokens=SPEC_NEW,
                            weight_quant="int8", kv_cache_quant="int8")
    res["speculative_int8"] = dict(
        tokens_s_raw=DECODE_BATCH * SPEC_NEW / t, seconds=t,
        mean_accepted=stats["mean_accepted"], iterations=stats["iterations"],
        tokens_per_target_pass=stats["tokens_per_target_pass"],
        agreement_with_generate=(toks == greedy).float().mean().item(),
        card=card)
    print("decode gpt3_1p3B speculative (%s, %d new): %.1f tokens/s raw "
          "(%.3f s), mean_accepted %.3f over %d row-iterations; tokens "
          "equal to generate's: %.4f (bf16: the verify pass's [b, gamma + "
          "1] products round apart from the step's [b, 1]) [%s]"
          % (SPEC_KW, SPEC_NEW, res["speculative_int8"]["tokens_s_raw"], t,
             stats["mean_accepted"], stats["iterations"],
             res["speculative_int8"]["agreement_with_generate"], card),
          flush=True)
    del model
    torch.cuda.empty_cache()

    # the exact contracts on a 2-layer copy at full width in f32
    small = decode_model("gpt3_1p3B", dtype=torch.float32, num_layers=2)
    res["exact_f32"] = exact_checks(small, ids, "gpt3_1p3B f32 x 2", card)
    del small
    torch.cuda.empty_cache()
    return res


def speculative(model, ids, new, **kw):
    from paddle_tpu_torch.models import speculative_generate

    return speculative_generate(model, ids, max_new_tokens=new,
                                return_stats=True, **kw)


def exact_checks(model, ids, what, card):
    """f32 at full width: speculative tokens equal ``generate``'s, bit
    for bit, with draft_layers 1 and with the int8 tiers (the
    exact-greedy contract); (c) the eager ``forward(caches=...)`` loop's
    greedy tokens equal ``generate``'s, its K1 launches L a call; and
    ``generate`` / ``beam_search`` through the kernels equal the same
    through the plain versions."""
    res = {}
    n = EXACT_NEW
    for tag, kw in (("fp", {}), ("int8_kv8", DECODE_TIERS["int8_kv8"])):
        want = model.generate(ids, max_new_tokens=n, **kw)
        got, stats = speculative(model, ids, n, gamma=4, draft_layers=1,
                                 **kw)
        check(torch.equal(got, want), "%s: speculative %s tokens differ "
              "from generate's (%.4f equal)" % (what, tag, (got == want)
                                                .float().mean().item()))
        res["speculative_" + tag] = dict(equal=True, **stats)
    (gen, logits), launches = counted(
        lambda: eager_cached_decode(model, ids, n))
    want = cached_launches(model, n)
    check(launches == want, "%s cached: launches %s, want %s"
          % (what, launches, want))
    check(torch.equal(gen, model.generate(ids, max_new_tokens=n)),
          "%s: the eager cached loop's tokens differ from generate's" % what)
    # the same loop through the plain versions, fed the same tokens
    _, plain = with_hooks(lambda: eager_cached_decode(model, ids, n, gen),
                          model, **plain_hooks(model))
    err = (logits - plain).abs().max().item()
    check(torch.allclose(logits, plain, **CACHED_LOGITS_TOL), "%s cached: "
          "logits max abs err %.4g against the plain versions' loop"
          % (what, err))
    res["cached_loop"] = dict(equal=True, calls=n, launches=launches,
                              logits_max_abs_err_vs_plain=err)
    for name, fn in (
            ("generate", lambda: model.generate(ids, max_new_tokens=n)),
            ("beam_search", lambda: model.beam_search(
                ids[:2], max_new_tokens=n // 2, num_beams=4))):
        a = fn()
        b = plain_generation(fn)
        check(torch.equal(a, b), "%s: %s through the kernels differs from "
              "the plain versions' (%.4f equal)"
              % (what, name, (a == b).float().mean().item()))
        res[name + "_vs_plain"] = "equal"
    print("decode %s: speculative == generate (fp: mean_accepted %.3f; "
          "int8_kv8: %.3f), the cached forward loop == generate (%d calls, "
          "launches %s), generate and beam search == the plain versions', "
          "all bit for bit; the cached loop's logits within %.3g of the "
          "plain versions' loop [%s]"
          % (what, res["speculative_fp"]["mean_accepted"],
             res["speculative_int8_kv8"]["mean_accepted"], n, launches, err,
             card), flush=True)
    return res


def eager_cached_decode(model, ids, n, feed=None):
    """Greedy decode through ``forward(caches=...)``: the prompt, then a
    token a call (the reference's test_generate_matches_eager_cached_
    decode). Returns the tokens and each call's last-row logits; with
    ``feed`` (tokens), those are fed instead of the argmax."""
    out, rows = [], []
    with torch.no_grad():
        caches = model.init_caches(ids.shape[0])
        logits, caches = model(ids.long(), caches=caches)
        for i in range(n):
            rows.append(logits[:, -1])
            tok = logits[:, -1].argmax(-1) if feed is None else feed[:, i]
            out.append(tok)
            if i + 1 < n:
                logits, caches = model(tok[:, None].long(), caches=caches)
    return torch.stack(out, 1).to(torch.int32), torch.stack(rows, 1)


def llama_decode_phase(card):
    """(d) Llama-2 7B: generate at b 8 (bf16 and int8_kv8) over a
    LLAMA_DECODE_WINDOW step window, beam search, the launches; then the
    exact checks on a 2-layer f32 copy at full width."""
    model = decode_model("llama2_7B")
    cfg = model.config
    ids = decode_ids(cfg.vocab_size)
    res = {"tiers": {}}
    lo, hi = LLAMA_DECODE_WINDOW
    for tag in ("bf16", "int8_kv8"):
        kw = DECODE_TIERS[tag]
        torch.cuda.reset_peak_memory_stats()
        (t1, _, launches), (t2, _, _) = window_times(
            lambda n: model.generate(ids, max_new_tokens=n, **kw),
            LLAMA_DECODE_WINDOW)
        if tag == "bf16":
            bf16_launches = launches
        step_s = (t2 - t1) / (hi - lo)
        wbytes, cbytes = step_bytes(model, kw, DECODE_PROMPT + hi)
        bound_ms = (wbytes + cbytes) / HBM_BYTES_PER_S * 1e3
        r = dict(tokens_s=DECODE_BATCH / step_s, ms_per_step=step_s * 1e3,
                 bound_ms=bound_ms, bound_by="bytes",
                 of_bound=bound_ms / (step_s * 1e3),
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)
        r.update(decode_logits_check(model, ids, kw, "llama decode " + tag,
                                     LLAMA_LOGITS_TOL,
                                     LLAMA_DECODE_LOGITS_RTOL))
        res["tiers"][tag] = r
        print("decode llama2_7B %s: %.1f tokens/s, %.4f ms a step (%d -> %d "
              "new), bound %.4f ms (%.3f of it), peak %.2f GB; vs plain: "
              "prefill %.4g, step %.4g max abs [%s]"
              % (tag, r["tokens_s"], r["ms_per_step"], lo, hi, bound_ms,
                 r["of_bound"], r["peak_gb"],
                 r["prefill_logits_max_abs_err"],
                 r["step_logits_max_abs_err"], card), flush=True)
    # the launches of the bf16 tier's timed generate of the window's
    # first length
    n, launches = lo, bf16_launches
    want = generate_launches(model, n)
    check(launches == want, "llama decode: launches %s, want %s"
          % (launches, want))
    res["launches"] = launches
    bb = LLAMA_BEAM
    t, beams = timed_generate(lambda: model.beam_search(
        ids[:bb["batch"]], max_new_tokens=bb["new"],
        num_beams=bb["num_beams"]))
    check(beams.shape == (bb["batch"], bb["new"]), "llama beam: shape")
    res["beam_search"] = dict(seconds=t, **bb)
    print("decode llama2_7B: launches of a %d-token generate %s; beam "
          "search (%d beams, b %d, %d new) %.3f s [%s]"
          % (n, launches, bb["num_beams"], bb["batch"], bb["new"], t, card),
          flush=True)
    del model
    torch.cuda.empty_cache()
    small = decode_model("llama2_7B", dtype=torch.float32, num_layers=2)
    res["exact_f32"] = exact_checks(small, ids, "llama2_7B f32 x 2", card)
    del small
    torch.cuda.empty_cache()
    return res


def decode_flash_times(card):
    """K1 at the decode paths' shapes (GPT-3 1.3B's 16 heads, d 128,
    bf16): a prefill (b 8, s 128, causal) and one query a row over a
    320-key cache (b 8, sq 1, not causal: ``forward(caches=...)``'s
    token), each held row by row against the plain version and timed
    beside it, aten's SDPA and the bound."""
    from paddle_tpu_torch.incubate.nn.cuda import flash_attn as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = {}
    for name, (b, sq, sk, h, d, causal) in (
            ("prefill", (8, 128, 128, 16, 128, True)),
            ("sq1", (8, 1, 320, 16, 128, False))):
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda")
                   .bfloat16() for s in (sq, sk, sk))
        hm = [x.transpose(1, 2) for x in (q, k, v)]
        scale = d ** -0.5
        out, _ = fa.flash_fwd(q, k, v, causal, scale)
        ref, _ = fa.flash_fwd_ref(*hm, causal, scale)
        err, rel = row_err(out, ref.transpose(1, 2))
        check(rel <= FLASH_ROW_TOL, "K1 %s: %.4g of its row's RMS" % (name,
                                                                      rel))
        nbytes, flops = flash_work(b, sq, sk, h, d, causal, backward=False)
        bound_ms, bound_by = bound_of(nbytes, flops)
        r = dict(max_abs_err=err, row_err=rel, shape=[b, sq, sk, h, d],
                 causal=causal,
                 ms=graph_ms(lambda: fa.flash_fwd(q, k, v, causal, scale)),
                 plain_ms=cuda_ms(lambda: fa.flash_fwd_ref(*hm, causal,
                                                           scale), 5),
                 library_ms=graph_ms(lambda: sdpa(*hm, is_causal=causal)),
                 bound_ms=bound_ms, bound_by=bound_by)
        res[name] = r
        print("K1 decode %s (b %d, sq %d, sk %d, %d heads, d %d, causal %d): "
              "kernel=%.4f ms plain=%.4f ms library=%.4f ms bound=%.4f ms "
              "(%s) a call in a CUDA graph; max_abs_err %.3g [%s]"
              % (name, b, sq, sk, h, d, causal, r["ms"], r["plain_ms"],
                 r["library_ms"], bound_ms, bound_by, err, card), flush=True)
    res["sq1_f32"] = decode_flash_f32(gen, card)
    return res


def decode_flash_f32(gen, card):
    """K1 in f32 where the 2-layer f32 copies' cached forward loops call
    it: one query a row over 129-160 keys (ragged against the key tiles),
    16 heads (GPT-3 1.3B) and 32 (Llama-2 7B), d 128, b 8, not causal;
    row by row and lse against the plain version, beside the plain
    version with the last key left out (what a lost tail key reads)."""
    from paddle_tpu_torch.incubate.nn.cuda import flash_attn as fa

    res, scale = {}, 128 ** -0.5
    for h in (16, 32):
        for sk in (129, 157, 160):
            q, k, v = (torch.randn(8, s, h, 128, generator=gen,
                                   device="cuda") for s in (1, sk, sk))
            hm = [x.transpose(1, 2) for x in (q, k, v)]
            out, lse = fa.flash_fwd(q, k, v, False, scale)
            ref, ref_lse = fa.flash_fwd_ref(*hm, False, scale)
            cut, _ = fa.flash_fwd_ref(hm[0], hm[1][:, :, :-1],
                                      hm[2][:, :, :-1], False, scale)
            err, rel = row_err(out, ref.transpose(1, 2))
            lse_err = (lse - ref_lse[..., 0]).abs().max().item()
            lost = row_err(cut, ref)[1]
            name = "h%d_sk%d" % (h, sk)
            check(rel <= FLASH_F32_ROW_TOL and lse_err <= FLASH_LSE_ATOL,
                  "K1 f32 sq 1 %s: %.4g of its row's RMS, lse %.3g" %
                  (name, rel, lse_err))
            check(lost > FLASH_F32_ROW_TOL, "K1 f32 sq 1 %s: a lost tail "
                  "key reads %.4g, within the limit" % (name, lost))
            res[name] = dict(max_abs_err=err, row_err=rel, lse_err=lse_err,
                             lost_tail_key_row_err=lost)
    print("K1 decode f32 sq 1 (b 8, 16 / 32 heads, d 128, sk 129 / 157 / "
          "160): row errors %s of a row's RMS (limit %g; the last key left "
          "out: %s) [%s]"
          % (["%.3g" % r["row_err"] for r in res.values()], FLASH_F32_ROW_TOL,
             ["%.3g" % r["lost_tail_key_row_err"] for r in res.values()],
             card), flush=True)
    return res


def decode_phase(card):
    """Phase 9d: K1 at the decode shapes, then the GPT and Llama decode
    paths."""
    res = {"k1": decode_flash_times(card)}
    res["gpt3_1p3B"] = gpt_decode_phase(card)
    res["llama2_7B"] = llama_decode_phase(card)
    return res


# ------------------------------------------------ phases 4d, 9b and 9c
RING_SRC = "paddle_tpu_torch/incubate/nn/csrc/ring.cu"
NVLINK_BYTES_PER_S = 450e9      # one H100's NVLink, each way (data sheet)
# Bytes of other buffers that K10's timing runs through before it uses a
# buffer again: four times the H100's 50 MB L2.
ROTATE_BYTES = 4 * 50 * 2 ** 20
# K9's product against its plain version (f32 sums, rounded once): f32 FFMA
# against an f32 matmul summed in another order, rtol = atol = 2e-4 as K8;
# bf16 row by row (see row_err), one bf16 ulp of a row's largest value at
# most, as K8: 4e-2 of the row's RMS. K9's copy and K10 are held bit-exact.
RING_F32_TOL = dict(rtol=2e-4, atol=2e-4)
RING_ROW_TOL = 4e-2
# bench.py _tp_overlap_result: T 16384, K 4096, N 1024, f32, x ~ N(0, 1),
# w ~ 0.05 N(0, 1); the ring against the serial gather-then-GEMM
TP_BENCH = dict(T=16384, K=4096, N=1024)
# the TP path against the serial composition on the same ring, f32: every
# output, dx and dw element within rtol 1e-4 plus atol 1e-4 (elements near
# zero are sums of terms ~1e3 times larger; f32 sums in two orders differ
# there by ~1e-6 absolute)
TP_TOL = dict(rtol=1e-4, atol=1e-4)
# bench.py _multichip_result's device leg: GPT-3 1.3B widths, 8
# micro-batches of 1 x 1024, SGD at lr 0.01, f32, 12 blocks a stage at S 2
PP_BENCH = dict(hidden=2048, heads=16, vocab=50304, seq=1024, micro=1,
                num_micro=8, lr=0.01, blocks=12)
# the pipeline's first step against the same blocks run one after another
# on one card: the loss within rtol 1e-4, each gradient leaf of a stage
# within rtol 1e-4 plus 1e-4 of the leaf's largest value (per-micro-batch
# accumulation there, one mean here: f32 sums in other orders)
PP_TOL = 1e-4


def ring_devices(size):
    """Rank r on card r % n (n cards); distinct cards only when every pair
    of ring neighbours has peer access both ways, else every rank on card
    0. The ring layer never picks a placement: this script does."""
    n = torch.cuda.device_count()
    devs = ["cuda:%d" % (r % n) for r in range(size)]
    for r in range(size):
        a, b = r % n, (r + 1) % size % n
        if a != b and not (torch.cuda.can_device_access_peer(a, b) and
                           torch.cuda.can_device_access_peer(b, a)):
            return ["cuda:0"] * size
    return devs


def ring_cards(ring):
    return sorted({d.index for d in ring.devices})


def ring_where(ring):
    cards = ring_cards(ring)
    return "%d ranks on %s" % (ring.size, "card %s (shared: no overlap "
                               "between ranks)" % cards[0] if len(cards) == 1
                               else "cards " + ",".join(map(str, cards)))


def ring_ms(fn, ring, iters, warmup=2):
    """Milliseconds per call of ``fn`` over the ring: CUDA events on the
    card when the ranks share one card, else the host clock around
    ``iters`` calls that end in a synchronisation of every card."""
    cards = ring_cards(ring)
    if len(cards) == 1:
        with torch.cuda.device(cards[0]):
            return cuda_ms(fn, iters, warmup)
    for _ in range(warmup):
        fn()
    for c in cards:
        torch.cuda.synchronize(c)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    for c in cards:
        torch.cuda.synchronize(c)
    return (time.perf_counter() - t0) / iters * 1e3


def ring_bound(ring, ops, read_bytes, out_bytes, copy_bytes, flops_per_s):
    """The least time the cards could take for one ring step of every rank:
    rank r does ``ops`` on its card, reads ``read_bytes`` and writes
    ``out_bytes`` there, and writes ``copy_bytes`` into rank r+1's
    memory (its card's HBM, and the link when that is another card). The
    largest over cards of operations over the peak and HBM bytes over its
    rate, and over sending cards of link bytes over NVLink."""
    flops, hbm, link = {}, {}, {}
    for r in range(ring.size):
        c, d = ring.device(r).index, ring.device(r + 1).index
        flops[c] = flops.get(c, 0) + ops
        hbm[c] = hbm.get(c, 0) + read_bytes + out_bytes
        hbm[d] = hbm.get(d, 0) + copy_bytes
        if c != d:
            link[c] = link.get(c, 0) + copy_bytes
    t_ops = max(flops.values()) / flops_per_s * 1e3
    t_bytes = max(max(hbm.values()) / HBM_BYTES_PER_S,
                  max(link.values(), default=0) / NVLINK_BYTES_PER_S) * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def mm_step_case(ring, t, k, n, dtype, seed, lead=()):
    """Per-rank K9 inputs on their cards: buf [t, *lead, k] ~ N(0, 1), w
    [k, n] ~ 0.05 N(0, 1), each rank its own."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    bufs, ws = [], []
    for d in ring.devices:
        bufs.append(torch.randn(t, *lead, k, generator=g, device="cuda")
                    .to(d, dtype))
        ws.append((0.05 * torch.randn(k, n, generator=g, device="cuda"))
                  .to(d, dtype))
    return bufs, ws


def mm_step_library(bufs, ws, ring):
    """One PyTorch call a rank computing the same step, timed only and
    never called by the port: ``torch.matmul`` on the rank's block, with
    the copy as ``copy_`` to the neighbour on a side stream (the copy
    engine)."""
    nxt = [torch.empty_like(b, device=ring.device(r + 1))
           for r, b in enumerate(bufs)]
    sides = [torch.cuda.Stream(device=d) for d in ring.devices]

    def run():
        outs = []
        for r in range(ring.size):
            cur = torch.cuda.current_stream(ring.device(r))
            sides[r].wait_stream(cur)
            with torch.cuda.stream(sides[r]):
                nxt[r].copy_(bufs[r], non_blocking=True)
            outs.append(torch.matmul(bufs[r], ws[r]))
            cur.wait_stream(sides[r])
        return outs
    return run


def mm_step_check(name, ring, bufs, ws, card, timed):
    """One K9 step of every rank against its plain version: next buffers
    bit-exact, partials within RING_F32_TOL (f32) or RING_ROW_TOL of a
    row's RMS (bf16), and bitwise equal to a second step's; with
    ``timed``, K9's time per step of all ranks beside the plain
    version's, the library's and the bound, with the kernel's tile, items
    and waves."""
    from paddle_tpu_torch.incubate.nn.cuda import ring as kring

    before = kring.mm_step.launches
    parts, nexts = kring.mm_step(bufs, ws, ring)
    again = kring.mm_step(bufs, ws, ring)[0]
    want_p, want_n = kring.mm_step_ref(bufs, ws, ring)
    for c in ring_cards(ring):
        torch.cuda.synchronize(c)
    grew = kring.mm_step.launches - before
    check(grew == 2 * ring.size, "K9 %s: launches grew by %d"
          % (name, grew))
    check(all(torch.equal(a, b) for a, b in zip(parts, again)),
          "K9 %s: two launches differ" % name)
    del again
    for r in range(ring.size):
        check(nexts[r].device == ring.device(r) and
              torch.equal(nexts[r], want_n[r]),
              "K9 %s: rank %d's received buffer is not bit-exact"
              % (name, r))
        check(nexts[r].data_ptr() != bufs[r].data_ptr(),
              "K9 %s: the receive buffer aliases the buffer read" % name)
    err = rel = 0.0
    for r in range(ring.size):
        check(bool(torch.isfinite(parts[r]).all()),
              "K9 %s: non-finite" % name)
        e, q = row_err(parts[r], want_p[r])
        err, rel = max(err, e), max(rel, q)
        if parts[r].dtype == torch.float32:
            torch.testing.assert_close(parts[r], want_p[r], **RING_F32_TOL)
    if bufs[0].dtype == torch.bfloat16:
        check(rel <= RING_ROW_TOL, "K9 %s: max abs err %.4g, %.4g of its "
              "row's RMS > %g" % (name, err, rel, RING_ROW_TOL))
    k, n = ws[0].shape
    t = bufs[0].numel() // k
    plan = kring.mm_step_plan(t, k, n, bufs[0].dtype, ring.device(0))
    res = dict(max_abs_err=err, row_err=rel, size=ring.size, rows=t, K=k, N=n,
               dtype=str(bufs[0].dtype)[6:], where=ring_where(ring), **plan)
    del parts, nexts, want_p, want_n
    line = "K9 %-31s %s rows=%d K=%d N=%d %s: next bit-exact, max_abs_err=" \
           "%.3g (%.3e of its row's RMS), bitwise equal across launches; " \
           "tile %dx%d, %d items, %d at once (%.2f waves)" % (
               name, ring_where(ring), t, k, n, res["dtype"], err, rel,
               plan["tile"][0], plan["tile"][1], plan["items"],
               plan["at_once"], plan["waves"])
    if timed:
        el = bufs[0].element_size()
        step = lambda: kring.mm_step(bufs, ws, ring)     # noqa: E731
        library = mm_step_library(bufs, ws, ring)
        if len(ring_cards(ring)) == 1:
            # a step of every rank in a CUDA graph: at mp 4 the wrapper's
            # host time (four launches and allocations) exceeds the
            # device's
            with torch.cuda.device(ring_cards(ring)[0]):
                ms, library_ms = graph_ms(step), graph_ms(library)
            res["timed_by"] = "per step of all ranks in a CUDA graph"
        else:
            ms = ring_ms(step, ring, iters=10)
            library_ms = ring_ms(library, ring, iters=10)
            res["timed_by"] = "host clock per step, launches included"
        res["call_ms"] = ring_ms(step, ring, iters=10)
        plain_ms = ring_ms(lambda: kring.mm_step_ref(bufs, ws, ring), ring,
                           iters=3, warmup=1)
        bound_ms, bound_by = ring_bound(
            ring, 2 * t * k * n, (t * k + k * n) * el, t * n * el,
            t * k * el, BF16_FLOPS_PER_S if el == 2 else F32_FLOPS_PER_S)
        res.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   tflops=2 * t * k * n * ring.size / ms / 1e9)
        line += " kernel=%.4f ms (%.1f TFLOP/s over the ring; %s; back " \
                "to back %.4f ms) plain=%.4f ms library=%.4f ms bound=%.4f " \
                "ms (%s)" % (ms, res["tflops"], res["timed_by"],
                             res["call_ms"], plain_ms, library_ms, bound_ms,
                             bound_by)
    print(line + " [%s]" % card, flush=True)
    return res


def shift_check(name, ring, shape, dtype, card, timed, seed=0):
    """K10 by step 1 and by size - 1 against the plain shift, bit-exact;
    with ``timed``, its time per shift of all ranks (in a CUDA graph when
    the ranks share a card, else the host clock), over buffers that are
    cold in L2, beside the plain version's, ``copy_``'s
    (``cudaMemcpyPeerAsync``) and the bound."""
    from paddle_tpu_torch.incubate.nn.cuda import ring as kring

    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = [torch.randn(*shape, generator=g, device="cuda").to(d, dtype)
          for d in ring.devices]
    before = kring.shift.launches
    for step in (1, ring.size - 1):
        got = kring.shift(xs, ring, step)
        want = ring.shift_ref(xs, step)
        for c in ring_cards(ring):
            torch.cuda.synchronize(c)
        for r in range(ring.size):
            check(got[r].device == ring.device(r) and
                  torch.equal(got[r], want[r]),
                  "K10 %s step %d: rank %d not bit-exact" % (name, step, r))
    grew = kring.shift.launches - before
    check(grew == 2 * ring.size, "K10 %s: launches grew by %d"
          % (name, grew))
    nbytes = xs[0].numel() * xs[0].element_size()
    res = dict(max_abs_err=0.0, size=ring.size, shape=list(shape),
               dtype=str(dtype)[6:], bytes=nbytes, where=ring_where(ring))
    line = "K10 %-21s %s %s %s: bit-exact at steps 1 and %d" % (
        name, ring_where(ring), list(shape), res["dtype"], ring.size - 1)
    if timed:
        # A pipeline hop finds its boundary tensor cold in L2, and one
        # shift of [1, 1024, 2048] f32 (8.4 MB a rank) would stay in the
        # card's 50 MB L2 if it were repeated. So every timed call takes
        # the next of ``sets`` source / destination sets, and a set comes
        # round again only after ROTATE_BYTES of others went through.
        sets = max(2, -(-ROTATE_BYTES // (2 * ring.size * nbytes)))
        srcs = [xs] + [[x.clone() for x in xs] for _ in range(sets - 1)]
        dsts = [[torch.empty_like(x, device=ring.device(r + 1))
                 for r, x in enumerate(xs)] for _ in range(sets)]
        held = [None] * sets
        calls = itertools.count()

        def kernel():
            i = next(calls) % sets
            held[i] = kring.shift(srcs[i], ring, 1)

        def library():
            i = next(calls) % sets
            for r in range(ring.size):
                dsts[i][r].copy_(srcs[i][r], non_blocking=True)

        def plain():
            i = next(calls) % sets
            held[i] = ring.shift_ref(srcs[i], 1)

        if len(ring_cards(ring)) == 1:
            with torch.cuda.device(ring_cards(ring)[0]):
                ms = graph_ms(kernel)
                library_ms = graph_ms(library)
            how = "per call in a CUDA graph"
            res["device_ms"] = res["device_library_ms"] = None
            device = "; the kernel alone across cards: not measured (one " \
                     "card)"
        else:
            ms = ring_ms(kernel, ring, iters=50)
            library_ms = ring_ms(library, ring, iters=50)
            how = "host clock per call, launch overhead included"
            res["device_ms"], res["device_library_ms"] = shift_device_ms(
                ring, [x[0] for x in srcs], [y[0] for y in dsts], nbytes)
            device = "; the kernel alone, rank 0's card %d -> %d: %.4f ms, " \
                     "copy_ %.4f ms (CUDA events on the sending card, " \
                     "back to back)" % (ring.device(0).index,
                                        ring.device(1).index,
                                        res["device_ms"],
                                        res["device_library_ms"])
        plain_ms = ring_ms(plain, ring, iters=20)
        how += ", %d buffer sets in rotation" % sets
        del srcs, dsts, held
        bound_ms, bound_by = ring_bound(ring, 0, nbytes, 0, nbytes,
                                        F32_FLOPS_PER_S)
        res.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, timed_by=how)
        line += " kernel=%.4f ms plain=%.4f ms library=%.4f ms bound=%.4f " \
                "ms (%s; %s)%s" % (ms, plain_ms, library_ms, bound_ms,
                                   bound_by, how, device)
    print(line + " [%s]" % card, flush=True)
    return res


def shift_device_ms(ring, srcs, dsts, nbytes, iters=50):
    """Device milliseconds of one shift from rank 0's card into rank 1's:
    K10 launched alone (``ring_shift_launch``, no receive allocation, no
    cross-card events) and ``copy_`` (``cudaMemcpyPeerAsync``), each
    back to back on the sending card's current stream between CUDA
    events, the sources and destinations (allocated beforehand) taken in
    rotation so that each call finds its source cold in L2. The wrapper's
    count does not move: these are yardstick launches."""
    from paddle_tpu_torch.incubate.nn.cuda import ring as kring

    lib = kring._bind()
    src_dev, dst_dev = ring.device(0), ring.device(1)
    calls = itertools.count()

    def kernel(stream):
        i = next(calls) % len(srcs)
        check(lib.ring_shift_launch(srcs[i].data_ptr(), dsts[i].data_ptr(),
                                    nbytes, stream.cuda_stream) == 0,
              "K10: a launch failed")

    def library(stream):
        i = next(calls) % len(srcs)
        dsts[i].copy_(srcs[i], non_blocking=True)

    out = []
    with torch.cuda.device(src_dev):
        stream = torch.cuda.current_stream(src_dev)
        for fn in (kernel, library):
            for _ in range(3):
                fn(stream)
            torch.cuda.synchronize(src_dev)
            torch.cuda.synchronize(dst_dev)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(stream)
            for _ in range(iters):
                fn(stream)
            b.record(stream)
            b.synchronize()
            torch.cuda.synchronize(dst_dev)
            out.append(a.elapsed_time(b) / iters)
    return tuple(out)


def ring_kernel_phase(card):
    """K9 and K10 against their plain versions on the card(s). K9 at
    bench.py's TP shape (T 16384, K 4096, N 1024: buf [T / mp, 4096], w
    [4096, 1024 / mp] a rank) at mp 2 and 4, f32 and bf16, timed beside
    the plain version, the library and the bound; edges: N 200, K 200
    (not a multiple of the K tile), a 3-D buffer, t 100 (not a multiple of
    the 128-row tile), and two ranks on one card. K10 at the pipeline
    leg's boundary tensor [1, 1024, 2048] f32 and bf16 on the rings of 2
    and 4 stages, and at an odd element count, by step 1 and size - 1."""
    from paddle_tpu_torch.distributed import Ring

    cards = torch.cuda.device_count()
    peers = {"%d->%d" % (a, b): torch.cuda.can_device_access_peer(a, b)
             for a in range(cards) for b in range(cards) if a != b}
    print("ring: %d card(s); peer access %s" % (cards, peers or "n/a"),
          flush=True)
    out = {"K9": {}, "K10": {}, "peer_access": peers}
    T, K, N = TP_BENCH["T"], TP_BENCH["K"], TP_BENCH["N"]
    for mp in (2, 4):
        rings = {"": Ring(ring_devices(mp))}
        if len(ring_cards(rings[""])) > 1:      # the ranks on one card too
            rings[" one card"] = Ring(["cuda:0"] * mp)
        for where, ring in rings.items():
            print("ring: mp %d placement %s" % (
                mp, [str(d) for d in ring.devices]), flush=True)
            for dtype in (torch.float32, torch.bfloat16):
                bufs, ws = mm_step_case(ring, T // mp, K, N // mp, dtype, mp)
                tag = "bench mp%d %s%s" % (mp, str(dtype)[6:], where)
                out["K9"][tag] = mm_step_check(tag, ring, bufs, ws, card,
                                               True)
                del bufs, ws
                torch.cuda.empty_cache()
    shared = Ring(["cuda:0"] * 2)
    ring2 = Ring(ring_devices(2))
    edges = {
        # name: (ring, t, K, N, leading dims)
        "n200": (ring2, 512, 256, 200, ()),
        "k200": (ring2, 512, 200, 256, ()),
        "3d": (ring2, 64, 256, 128, (6,)),
        "t100": (ring2, 100, 64, 72, ()),
        "shared_card": (shared, 1024, 512, 256, ()),
    }
    for dtype in (torch.float32, torch.bfloat16):
        for name, (ring, t, k, n, lead) in edges.items():
            tag = "%s %s" % (name, str(dtype)[6:])
            bufs, ws = mm_step_case(ring, t, k, n, dtype, 7, lead)
            out["K9"][tag] = mm_step_check(tag, ring, bufs, ws, card, False)
    torch.cuda.empty_cache()
    for size in (2, 4):
        ring = Ring(ring_devices(size))
        for dtype in (torch.float32, torch.bfloat16):
            tag = "pp%d %s" % (size, str(dtype)[6:])
            out["K10"][tag] = shift_check(tag, ring, (1, 1024, 2048), dtype,
                                          card, True)
    out["K10"]["odd f32"] = shift_check("odd f32", ring2, (1001,),
                                        torch.float32, card, False)
    out["K10"]["odd bf16"] = shift_check("odd bf16", shared, (3, 333),
                                         torch.bfloat16, card, False)
    return out


def tp_phase(card):
    """The TP path at bench.py's _tp_overlap_result configuration (f32,
    T 16384, K 4096, N 1024), mp 2 then mp 4. With K9's count set to 0
    just before and read just after: ``sharded_all_gather_matmul`` and
    autograd of ``sum(out)`` launch K9 size x (size - 1) times in the
    forward and none in the backward, and out, dx and dw are held against
    the serial composition (gather, then ``torch.matmul``) on the same
    ring; ``sharded_matmul_reduce_scatter`` likewise (no K9). Then
    bench.py's timing, per-rank primitive under no_grad: off (serial)
    against the ring, step ms and speedup (bench.py also sweeps the JAX
    ring's row chunks, which the port does not have)."""
    from paddle_tpu_torch.distributed import Ring
    from paddle_tpu_torch.fusion import overlap_mm as tom
    from paddle_tpu_torch.incubate.nn.cuda import ring as kring

    T, K, N = TP_BENCH["T"], TP_BENCH["K"], TP_BENCH["N"]
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(T, K, generator=g, device="cuda")
    w = 0.05 * torch.randn(K, N, generator=g, device="cuda")
    res = {}
    for mp in (2, 4):
        ring = Ring(ring_devices(mp))
        where = ring_where(ring)

        def loss_grads(fn, off):
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            with tom.override(tp_overlap="off" if off else "on"):
                out = fn(xg, wg, ring=ring)
                fwd = kring.mm_step.launches
                dx, dw = torch.autograd.grad(out.sum(), [xg, wg])
            return out.detach(), dx, dw, fwd

        kring.mm_step.launches = 0
        out, dx, dw, fwd = loss_grads(tom.sharded_all_gather_matmul, False)
        for c in ring_cards(ring):
            torch.cuda.synchronize(c)
        launches = kring.mm_step.launches
        check(fwd == mp * (mp - 1) and launches == fwd,
              "TP mp %d: K9 launched %d times in the forward and %d in the "
              "backward, not %d and 0" % (mp, fwd, launches - fwd,
                                          mp * (mp - 1)))
        ref = loss_grads(tom.sharded_all_gather_matmul, True)
        check(kring.mm_step.launches == launches,
              "the serial composition launched K9")
        errs = {}
        for name, a, b in zip(("out", "dx", "dw"), (out, dx, dw), ref):
            torch.testing.assert_close(a, b, msg="TP mp %d %s" % (mp, name),
                                       **TP_TOL)
            errs[name] = (a - b).abs().max().item()
        check(tuple(out.shape) == (T, N), "TP out shape %s"
              % (tuple(out.shape),))
        del out, dx, dw, ref
        rs = loss_grads(tom.sharded_matmul_reduce_scatter, False)
        rs_ref = loss_grads(tom.sharded_matmul_reduce_scatter, True)
        check(kring.mm_step.launches == launches,
              "matmul_reduce_scatter launched K9")
        for name, a, b in zip(("rs out", "rs dx", "rs dw"), rs[:3],
                              rs_ref[:3]):
            torch.testing.assert_close(a, b, msg="TP mp %d %s" % (mp, name),
                                       **TP_TOL)
            errs[name] = (a - b).abs().max().item()
        del rs, rs_ref
        print("tp: mp %d, %s: sharded_all_gather_matmul launched K9 %d "
              "times forward, 0 backward; max |ring - serial| %s (limits "
              "rtol %g, atol %g) [%s]"
              % (mp, where, launches, {k: float("%.3g" % v) for k, v in
                                       errs.items()}, TP_TOL["rtol"],
                 TP_TOL["atol"], card), flush=True)

        xs = [c.to(d).contiguous() for c, d in zip(x.chunk(mp), ring.devices)]
        ws = [c.to(d).contiguous() for c, d in zip(w.chunk(mp, -1),
                                                   ring.devices)]
        with torch.no_grad():
            with tom.override(tp_overlap="off"):
                off_ms = ring_ms(lambda: tom.all_gather_matmul(xs, ws, ring),
                                 ring, iters=16)
            on_ms = ring_ms(lambda: tom.all_gather_matmul(xs, ws, ring),
                            ring, iters=16)
        res["mp%d" % mp] = dict(
            where=where, placement=[str(d) for d in ring.devices],
            forward_launches=launches, max_abs_vs_serial=errs,
            off_step_ms=off_ms, on_step_ms=on_ms, speedup=off_ms / on_ms,
            card=card)
        print("tp: mp %d, %s: serial (gather, then matmul) %.4f ms, ring "
              "%.4f ms: speedup %.3f%s [%s]"
              % (mp, where, off_ms, on_ms, off_ms / on_ms,
                 "" if len(ring_cards(ring)) > 1 else
                 " (ranks share one card: no overlap between ranks)",
                 card), flush=True)
        del xs, ws
        torch.cuda.empty_cache()
    return res


def pp_sequential(stacked, extra, ids, labels, num_micro, fns, dev):
    """The same blocks run one after another on card ``dev``, no ring:
    the mean over micro-batches of their loss, and the gradients of every
    stacked leaf ([S, B, ...]), one micro-batch's graph at a time."""
    stage_fn, pre_fn, loss_fn = fns
    S, M = stacked[0].shape[0], num_micro
    p = [torch.from_numpy(a).to(dev).requires_grad_() for a in stacked]
    ex = {k: torch.from_numpy(v).to(dev) for k, v in extra.items()}
    mb = ids.shape[0] // M
    total = 0.0
    grads = [torch.zeros_like(a) for a in p]
    for m in range(M):
        h = pre_fn(ex, ids[m * mb:(m + 1) * mb].to(dev))
        for s in range(S):
            h = stage_fn([a[s] for a in p], h)
        loss = loss_fn(ex, h, labels[m * mb:(m + 1) * mb].to(dev)) / M
        for acc, gr in zip(grads, torch.autograd.grad(loss, p)):
            acc += gr
        total += loss.item()
    return total, grads


def pipeline_run(card, stages, blocks_all, extra, batch, blocks_per_stage):
    """CompiledPipeline over ``stages`` stages (placement by
    ring_devices), held against the sequential run on stage 0's card on
    its first step (loss_and_grads), then a warm-up and 4 timed SGD steps (the count
    of K10 set to 0 just before them and read just after)."""
    from paddle_tpu_torch.distributed import Ring
    from paddle_tpu_torch.distributed.pipeline import CompiledPipeline
    from paddle_tpu_torch.incubate.nn.cuda import ring as kring
    from paddle_tpu_torch.models import pipeline_gpt
    from paddle_tpu_torch.optimizer import SGD

    cfg = PP_BENCH
    M, seq, hidden = cfg["num_micro"], cfg["seq"], cfg["hidden"]
    ring = Ring(ring_devices(stages))
    cards = ring_cards(ring)
    where = ring_where(ring)
    stacked = pipeline_gpt.stack(blocks_all[:stages * blocks_per_stage],
                                 stages)
    fns = pipeline_gpt.functions(cfg["heads"])
    stage_fn, pre_fn, loss_fn = fns
    ids, labels = batch
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    pipe = CompiledPipeline(stage_fn, stacked, loss_fn, num_stages=stages,
                            num_micro=M, optimizer=SGD(cfg["lr"]),
                            extra_params=extra, pre_fn=pre_fn, devices=ring)
    per_step = stages * (M + stages - 1) + stages * (M + stages - 2)
    before = kring.shift.launches
    loss0, stage_g, _ = pipe.loss_and_grads(ids, labels)
    loss0 = loss0.item()
    grew = kring.shift.launches - before
    check(grew == per_step, "pipeline S %d: loss_and_grads launched K10 %d "
          "times, not %d" % (stages, grew, per_step))
    got_g = [g.to(ring.device(0)) for g in stage_g[0]]
    del stage_g
    ref_loss, ref_g = pp_sequential(stacked, extra, ids, labels, M, fns,
                                    ring.device(0))
    check(abs(loss0 - ref_loss) <= PP_TOL * abs(ref_loss),
          "pipeline S %d: first loss %.6f, sequential %.6f"
          % (stages, loss0, ref_loss))
    g_err = 0.0
    for i, (a, b) in enumerate(zip(got_g, ref_g)):
        want = b[0]
        scale = want.abs().max().item()
        torch.testing.assert_close(a, want, rtol=PP_TOL, atol=PP_TOL * scale,
                                   msg="pipeline stage 0 grad leaf %d" % i)
        g_err = max(g_err, (a - want).abs().max().item() / max(scale, 1e-30))
    del got_g, ref_g
    torch.cuda.empty_cache()

    def sync():
        for c in cards:
            torch.cuda.synchronize(c)

    losses = [pipe.step(ids, labels).item()]         # warm-up
    iters = 4
    kring.shift.launches = 0
    sync()
    t0 = time.perf_counter()
    last = []
    for _ in range(iters):
        last.append(pipe.step(ids, labels))
    sync()
    el = time.perf_counter() - t0
    launches = kring.shift.launches
    losses += [x.item() for x in last]
    check(launches == iters * per_step,
          "pipeline S %d: %d timed steps launched K10 %d times, not %d"
          % (stages, iters, launches, iters * per_step))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "pipeline S %d: the loss did not fall: %s" % (stages, losses))
    peaks = {c: torch.cuda.max_memory_allocated(c) / 1e9 for c in cards}
    L = stages * blocks_per_stage
    n_params = sum(int(a.size) for a in stacked) + \
        sum(int(v.size) for v in extra.values())
    fpt = 6 * n_params + 6 * L * hidden * seq
    gb = ids.shape[0]
    tps = gb * seq * iters / el
    mfu = tps * fpt / (F32_FLOPS_PER_S * stages)
    res = dict(stages=stages, blocks_per_stage=blocks_per_stage,
               placement=[str(d) for d in ring.devices], where=where,
               micro=cfg["micro"], num_micro=M, seq=seq,
               first_loss=loss0, sequential_loss=ref_loss,
               grad_err_of_max=g_err, losses=losses,
               launches=launches, launches_per_step=per_step,
               step_s=el / iters, tokens_per_s=tps, mfu=mfu,
               mfu_per_card=tps * fpt / (F32_FLOPS_PER_S * len(cards)),
               peak_gb_per_card=peaks, card=card)
    print("pp: S %d x %d blocks (%s): first loss %.6f vs sequential %.6f, "
          "stage-0 grads within %.3g of each leaf's max; losses %s; K10 %d "
          "launches in %d timed steps (%d a step = S (M+S-1) forward + S "
          "(M+S-2) backward); step %.4f s, %.1f tokens/s, MFU %.4f by "
          "bench.py's formula (67 TF f32 x S), %.4f per card used; peak GB "
          "per card %s [%s]"
          % (stages, blocks_per_stage, where, loss0, ref_loss, g_err,
             ["%.5f" % v for v in losses], launches, iters, per_step,
             el / iters, tps, mfu, res["mfu_per_card"],
             {c: round(v, 2) for c, v in peaks.items()}, card), flush=True)
    del pipe
    torch.cuda.empty_cache()
    return res


def pipeline_phase(card):
    """The compiled pipeline at bench.py's _multichip_result device leg:
    GPT-3 1.3B widths (hidden 2048, 16 heads, vocab 50304, seq 1024), 8
    micro-batches of 1 x 1024, SGD 0.01, f32, weights and batch from
    ``np.random.default_rng(0)`` as bench.py draws them. S 2 at 12 blocks
    a stage when the stages have cards of their own, 4 blocks a stage
    when they share one (memory); on four cards S 4 as well, at 6 blocks
    a stage (the same 24 layers)."""
    from paddle_tpu_torch.models import pipeline_gpt

    cfg = PP_BENCH
    distinct = len(set(ring_devices(2))) == 2
    bps = cfg["blocks"] if distinct else 4
    layers = 2 * bps
    blocks, extra, rng = pipeline_gpt.weights(layers, cfg["hidden"],
                                              cfg["vocab"], cfg["seq"])
    gb = cfg["num_micro"] * cfg["micro"]
    ids = torch.from_numpy(rng.integers(0, cfg["vocab"], (gb, cfg["seq"])))
    labels = torch.from_numpy(rng.integers(0, cfg["vocab"],
                                           (gb, cfg["seq"])))
    res = {"S2": pipeline_run(card, 2, blocks, extra, (ids, labels), bps)}
    if torch.cuda.device_count() >= 4 and len(set(ring_devices(4))) == 4:
        res["S4"] = pipeline_run(card, 4, blocks, extra, (ids, labels),
                                 layers // 4)
    return res


# ------------------------------------------------------------ phase 9e
# Sharded training over a mesh: one process a card (spawn, NCCL), each
# running TrainStep(mesh=..., fsdp_axis="dp") on its shards. The full
# widths need four cards: Llama-2 7B (BASELINE #5: dp 2 x mp 2, FSDP over
# dp, recompute, bf16, AdamW with bf16 m and factored v, clip 1.0, 4 x
# 4096 tokens) held against one card (rank 0 alone, before the mesh run)
# on the same weights and batch, and GPT-3 13B (the north star's model:
# mp 2 x dp 2, FSDP over dp, recompute, bf16, 8 x 2048), whose losses
# must be finite and fall. The exact checks: 2-layer f32 copies of both at
# full width (f32 m), 3 steps on the mesh against one card, each on a new
# batch of 4 x 512 tokens (on one batch repeated the 2-layer models learn
# it in two steps, to a loss of ~2e-4, whose relative difference then
# reads rounding): every step's loss and every gathered parameter, m, vr and vc
# within MESH_EXACT_RTOL in relative L2 a tensor, but for GPT's biases:
# they start at zero, so after 3 steps they are Adam's updates alone,
# normalised gradients whose relative error is their gradient's, a sum
# over every token that cancels (a bias and its m and v within
# MESH_BIAS_RTOL; one rank read 2.2e-4 on gpt.h.1.ln_1.bias against one
# card, the row-parallel bias added after its GEMM instead of in its
# epilogue), and the key third of the qkv bias, whose gradient is zero in
# exact arithmetic so that Adam normalises rounding noise there, within
# 3 lr.
MESH_PATHS = {
    "llama2_7B": ("LlamaForCausalLM", "llama2_7B",
                  dict(recompute=True, lm_ce_chunks=8),
                  ((2, 2), ("dp", "mp")), (4, 4096)),
    "gpt3_13B": ("GPTForCausalLM", "gpt3_13B",
                 dict(recompute=True, lm_ce_chunks=8),
                 ((2, 2), ("mp", "dp")), (8, 2048)),
}
MESH_STEPS = 4
MESH_EXACT_STEPS = 3
MESH_EXACT_BATCH = (4, 512)
MESH_LR = 1e-4
MESH_EXACT_RTOL = 1e-4
MESH_BIAS_RTOL = 1e-2
MESH_TIMEOUT_S = 300
# Llama-2 7B bf16, dp 2 x mp 2 against one card, 4 steps at lr 1e-4 on
# one batch: the first step's loss (the same weights: bf16 rounding
# only) within MESH_LOSS_RTOL of the card's, every later one within
# MESH_LATER_LOSS_RTOL of the card's loss at that step, every parameter
# together within MESH_PARAM_RTOL (relative L2), and the parameters'
# difference within MESH_UPDATE_RTOL of the card's update (relative L2
# of the difference against the card's change over the 4 steps: a run
# that never updates reads 1, one that updates a quarter off reads about
# 0.25 more than the rounding). The mesh rounds its partial sums (the
# row-parallel all-reduce, the FSDP reduce-scatter) in bf16 where one
# card sums inside one GEMM, and an update of lr is about one bf16 step
# of a weight of 0.02, so the runs' weights part by a bf16 step here and
# there. The bounds are set from two four-card runs: the losses read
# 3.57e-5, 1.74e-3, 3.13e-3 and 1.50e-2 of the card's (the other run
# 0.0181 at most), the parameters 2.67e-3 together and 0.207 of the
# update.
MESH_LOSS_RTOL = 1e-3
MESH_LATER_LOSS_RTOL = 5e-2
MESH_PARAM_RTOL = 1e-2
MESH_UPDATE_RTOL = 0.4


# Phase 9f, sequence parallelism: name -> (model class, config factory
# and its options, mesh, batch b x s). Llama-2 7B (bf16, recompute, 8 CE
# chunks) at 16384 tokens, in ring mode on sp 4 (the whole model on every
# rank: ~40 GB of parameters, grads and m) and in ulysses mode on sp 2 x
# mp 2 (half of it), both against one card (one run, the same weights
# and batch; ring and ulysses without an sp group are the gspmd model).
SP_LLAMA = dict(recompute=True, lm_ce_chunks=8,
                max_position_embeddings=SP_SEQ)
SP_PATHS = {
    "llama2_7B_ring": ("LlamaForCausalLM", "llama2_7B",
                       dict(SP_LLAMA, sequence_parallel_mode="ring"),
                       ((4,), ("sp",)), (1, SP_SEQ)),
    "llama2_7B_ulysses": ("LlamaForCausalLM", "llama2_7B",
                          dict(SP_LLAMA, sequence_parallel_mode="ulysses"),
                          ((2, 2), ("sp", "mp")), (1, SP_SEQ)),
}
# its exact checks: 2-layer f32 copies at full width on MESH_EXACT_BATCH
SP_EXACT = {
    "gpt3_1p3B_gspmd": ("GPTForCausalLM", "gpt3_1p3B",
                        dict(recompute=True, lm_ce_chunks=8,
                             sequence_parallel_mode="gspmd"),
                        ((2, 2), ("dp", "sp"))),
    "llama2_7B_ring": ("LlamaForCausalLM", "llama2_7B",
                       dict(recompute=True, lm_ce_chunks=8,
                            sequence_parallel_mode="ring"),
                       ((4,), ("sp",))),
    "llama2_7B_ulysses": ("LlamaForCausalLM", "llama2_7B",
                          dict(recompute=True, lm_ce_chunks=8,
                               sequence_parallel_mode="ulysses"),
                          ((2, 2), ("sp", "mp"))),
}


def mesh_ranks(cards):
    """The ranks of the mesh phase's spawn on ``cards`` cards."""
    return 4 if cards >= 4 else 2 if cards >= 2 else 1


def sp_jobs(cards):
    """Phase 9f's runs for ``cards`` cards. Four or more: the exact
    checks on their meshes, then the two Llama-2 7B runs, which share
    one one-card reference (kept on rank 0 between them); two or three:
    the exact checks on sp 2; one: on a one-rank mesh with an sp axis,
    then Llama-2 7B at 1 x 16384 on it (3 steps: the one-card run of the
    four-card jobs, K1 / K3 over the whole sequence; its loss must
    fall)."""
    if cards >= 4:
        meshes = {k: v[3] for k, v in SP_EXACT.items()}
    else:
        meshes = {k: ((mesh_ranks(cards),), ("sp",)) for k in SP_EXACT}
    jobs = [dict(name=path + "_f32_2layer", model=(cls, factory, kw),
                 layers=2, exact=True, mesh=meshes[path],
                 batch=MESH_EXACT_BATCH, steps=MESH_EXACT_STEPS,
                 reference=True)
            for path, (cls, factory, kw, _) in SP_EXACT.items()]
    if cards >= 4:
        for i, (path, (cls, factory, kw, mesh, batch)) in enumerate(
                SP_PATHS.items()):
            jobs.append(dict(name=path, model=(cls, factory, kw),
                             layers=None, exact=False, mesh=mesh,
                             batch=batch, steps=MESH_STEPS, reference=True,
                             ref_key="llama2_7B 1 x %d" % SP_SEQ,
                             keep_ref=i + 1 < len(SP_PATHS)))
    elif cards == 1:
        cls, factory, kw, _, batch = SP_PATHS["llama2_7B_ring"]
        jobs.append(dict(name="llama2_7B_one_card", model=(cls, factory, kw),
                         layers=None, exact=False, mesh=((1,), ("sp",)),
                         batch=batch, steps=MESH_EXACT_STEPS,
                         reference=False))
    return jobs


def mesh_jobs(cards):
    """The mesh runs of phase 9e for ``cards`` cards. Four or more: the
    exact checks on each full run's mesh, then the full runs; two or
    three: the exact checks on mp 2; one: on a one-rank mesh (the
    sharded code with groups of size 1)."""
    if cards >= 4:
        meshes = {k: v[3] for k, v in MESH_PATHS.items()}
    elif cards >= 2:
        meshes = {k: ((2,), ("mp",)) for k in MESH_PATHS}
    else:
        meshes = {k: ((1, 1), ("dp", "mp")) for k in MESH_PATHS}
    jobs = []
    for path, (cls, factory, kw, _, _) in MESH_PATHS.items():
        jobs.append(dict(name=path + "_f32_2layer", model=(cls, factory, kw),
                         layers=2, exact=True, mesh=meshes[path],
                         batch=MESH_EXACT_BATCH, steps=MESH_EXACT_STEPS,
                         reference=True))
    if cards >= 4:
        for path, (cls, factory, kw, mesh, batch) in MESH_PATHS.items():
            jobs.append(dict(name=path, model=(cls, factory, kw),
                             layers=None, exact=False, mesh=mesh,
                             batch=batch, steps=MESH_STEPS,
                             reference=path == "llama2_7B"))
    return jobs


def mesh_model(job):
    """The job's model on this rank's card, whole, weights from a
    generator seeded 0 (the same on every card)."""
    from paddle_tpu_torch import models

    return getattr(models, job["model"][0])(
        mesh_config(job),
        dtype=torch.float32 if job["exact"] else torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(0))


def mesh_optimizer(job):
    from paddle_tpu_torch.optimizer import AdamW

    return AdamW(learning_rate=MESH_LR, weight_decay=0.01,
                 moment_dtype="float32" if job["exact"] else "bfloat16",
                 factored_v=True)


def mesh_batches(job):
    """The job's batches, the same on every rank: a new one a step for
    the exact checks, one repeated for the full runs."""
    b, s = job["batch"]
    rng = np.random.default_rng(0)
    vocab = mesh_config(job).vocab_size
    n = job["steps"] if job["exact"] else 1
    out = [(rng.integers(0, vocab, (b, s)), rng.integers(0, vocab, (b, s)))
           for _ in range(n)]
    return [out[min(i, n - 1)] for i in range(job["steps"])]


def mesh_reference(job, batches):
    """Rank 0 alone: the job's steps on one card. Returns the losses,
    the final parameters (and for the exact checks m / vr / vc; on the
    host for the full runs) and each parameter's squared update."""
    from paddle_tpu_torch.jit import TrainStep

    model = mesh_model(job)
    keep = "cuda" if job["exact"] else "cpu"
    init = {n: p.detach().to(keep, copy=True)
            for n, p in model.named_parameters()}
    step = TrainStep(model, mesh_optimizer(job), grad_clip_norm=1.0)
    losses = [step(*batch).item() for batch in batches]
    ref = {"losses": losses, "params": {}, "update_sq": {}}
    with torch.no_grad():
        for n, p in model.named_parameters():
            ref["update_sq"][n] = float(
                (p.float() - init.pop(n).cuda().float()).square().sum())
            ref["params"][n] = p.detach().to(keep, copy=True)
    if job["exact"]:
        ref["state"] = {k: [e.clone() for e in step.opt_state[k]]
                        for k in ("m", "vr", "vc")}
    del model, step
    torch.cuda.empty_cache()
    return ref


def _rel(got, want):
    return float((got.float() - want.float()).norm() /
                 want.float().norm().clamp_min(1e-30))


def mesh_compare(step, ref, exact):
    """Every parameter (and for the exact checks m / vr / vc) gathered
    whole, a collective of every rank; on rank 0 against ``ref``: the
    largest relative L2 a tensor, the parameters' relative L2 together
    and against their updates, the qkv bias's key third."""
    import torch.distributed as dist

    from paddle_tpu_torch.convert import state_layout

    out = dict(worst=0.0, worst_name=None, worst_bias=0.0,
               worst_bias_name=None, key_bias=0.0)
    sq = dict(diff=0.0, ref=0.0, update=0.0)
    rank0 = dist.get_rank() == 0
    for i, (name, p) in enumerate(step.model.named_parameters()):
        pairs = [(name, p.dist_layout.gather(p.detach()),
                  ref["params"][name] if rank0 else None)]
        if exact:
            for key in ("m", "vr", "vc"):
                e = step.opt_state[key][i]
                lay = state_layout(key, p, e)
                if e.numel():
                    pairs.append(("%s of %s" % (key, name),
                                  e if lay is None else lay.gather(e),
                                  ref["state"][key][i] if rank0 else None))
        if not rank0:
            continue
        for what, got, want in pairs:
            want = want.to(got.device)
            if what.endswith("attn.qkv_proj.bias"):
                h = got.shape[0] // 3
                out["key_bias"] = max(out["key_bias"], float(
                    (got[h:2 * h] - want[h:2 * h]).abs().max()))
                got = torch.cat([got[:h], got[2 * h:]])
                want = torch.cat([want[:h], want[2 * h:]])
            rel = _rel(got, want)
            kind = "worst_bias" if name.endswith(".bias") else "worst"
            if rel > out[kind]:
                out[kind], out[kind + "_name"] = rel, what
            if what == name:
                sq["diff"] += float((got.float() - want.float()).square()
                                    .sum())
                sq["ref"] += float(want.float().square().sum())
                sq["update"] += ref["update_sq"][name]
    if rank0:
        out["params_rel_l2"] = math.sqrt(sq["diff"] / sq["ref"])
        out["update_rel_l2"] = math.sqrt(sq["diff"] / max(sq["update"],
                                                          1e-30))
    return out


def nccl_share(step, batch):
    """One more step a rank, each rank profiled in its own step while the
    others run unprofiled, as rank 0 alone was profiled before (every
    rank profiled in one step read Llama-2 7B dp 2 x mp 2's NCCL share
    69.65% where rank 0 alone read 22.25%): this rank's device time, its
    NCCL kernels' share of it and the rest (the rank's own work; None
    when the profiler saw no device time)."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    for turn in range(dist.get_world_size()):
        if turn != dist.get_rank():
            step(*batch)
            torch.cuda.synchronize()
            continue
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(*batch)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels)
    nccl = sum(e.self_device_time_total for e in kernels
               if "nccl" in e.key.lower())
    return dict(busy_ms=busy / 1e3, nccl_ms=nccl / 1e3,
                compute_ms=(busy - nccl) / 1e3,
                share=nccl / busy) if busy else None


def mesh_step_launches(model, mesh, s):
    """The launches one step of ``model`` must make on this rank of
    ``mesh``, ``s`` its tokens a row (its sp part): ``step_launches``'
    counts, attention taken by ``sequence_parallel_mode`` on an sp axis
    of n > 1 ranks. Ring: rank r's forward runs K1 on r + 1 parts (its
    own and the earlier ones), the backward K2 (or K3, by the route at s
    x s) on each; ulysses: one K1 and one backward a layer over the whole
    n s sequence (K3 past K2's cap); gspmd (and any mode on an sp axis of
    one rank): one of each over the (r + 1) s keys up to the rank's own
    (K3 at sq < sk, by the JAX package's route rule)."""
    from paddle_tpu_torch.incubate.nn.cuda import flash_attn as fa

    want = step_launches(model)
    cfg = model.config
    blocks = model.llama.layers if hasattr(model, "llama") else model.gpt.h
    L = len(blocks)
    rc = sum(bool(blk.recompute) for blk in blocks)
    n, r = mesh.axis_size("sp"), mesh.coord("sp")
    mode = cfg.sequence_parallel_mode if n > 1 else "gspmd"
    if mode == "ring":
        parts, sq, sk = r + 1, s, s
    elif mode == "ulysses":
        parts, sq, sk = 1, n * s, n * s
    else:
        parts, sq, sk = 1, s, (r + 1) * s
    fused = fa.uses_fused_bwd(sq, sk, cfg.head_dim)
    want.update({"K1": (L + rc) * parts, "K2": L * parts if fused else 0,
                 "K3": 0 if fused else L * parts})
    return want


def mesh_job(job, shared):
    """One mesh run on every rank: the one-card reference (rank 0), the
    sharded model, its steps between zeroed and read kernel counts, the
    comparison and a profiled step. Returns every rank's readings (on
    rank 0). ``shared`` keeps rank 0's references that two jobs share,
    by their ``ref_key``."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.jit import TrainStep

    rank = dist.get_rank()
    shape, names = job["mesh"]
    mesh = ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape), names)
    b, s = job["batch"]
    batches = mesh_batches(job)
    ref = None
    if job["reference"] and rank == 0:
        # a reference two jobs share is run once, kept on the host
        key = job.get("ref_key")
        ref = shared.pop(key, None) or mesh_reference(job, batches)
        if job.get("keep_ref"):
            shared[key] = ref
    dist.barrier()
    t0 = time.perf_counter()
    model = mesh_model(job)
    step = TrainStep(model, mesh_optimizer(job), mesh=mesh, fsdp_axis="dp",
                     grad_clip_norm=1.0)
    n_params = sum(math.prod(p.dist_layout.shape)
                   for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    read = zero_counts()
    feed = iter(batches)
    losses, secs = timed_calls(lambda: step(*next(feed)), job["steps"])
    launches = read()
    peak = torch.cuda.max_memory_allocated()
    want = {k: job["steps"] * n for k, n in mesh_step_launches(
        model, mesh, s // mesh.axis_size("sp")).items()}
    cmp = mesh_compare(step, ref, job["exact"]) if job["reference"] else {}
    profile = nccl_share(step, batches[-1])
    tail = secs[1:] or secs
    mine = dict(rank=rank, launches=launches, want=want, peak_gb=peak / 1e9,
                device=torch.cuda.current_device(), profile=profile,
                median_step_ms=1e3 * statistics.median(tail))
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    del model, step
    torch.cuda.empty_cache()
    if rank != 0:
        return None
    cfg = mesh_config(job)
    cards = dist.get_world_size()
    tokens_s = b * s * len(tail) / sum(tail)
    work = [rk["profile"]["compute_ms"] for rk in ranks if rk["profile"]]
    flops = 6 * n_params + 6 * cfg.num_layers * cfg.hidden_size * s
    return dict(mesh=dict(zip(names, shape)), cards=cards, batch=[b, s],
                layers=cfg.num_layers, dtype="float32" if job["exact"]
                else "bfloat16", losses=losses, step_ms=[1e3 * x for x in
                                                         secs],
                median_step_ms=1e3 * statistics.median(tail),
                tokens_s=tokens_s, params=n_params, flops_per_token=flops,
                mfu=tokens_s * flops / (BF16_FLOPS_PER_S * cards),
                setup_s=setup_s, ranks=ranks,
                reference_losses=None if ref is None else ref["losses"],
                compare=cmp, nccl=ranks[0]["profile"],
                skew=(max(work) - min(work)) / max(work)
                if len(work) == len(ranks) and max(work) > 0 else None,
                exact=job["exact"])


def mesh_config(job):
    from paddle_tpu_torch import models

    _, factory, kw = job["model"]
    cfg = getattr(models, factory)(**kw)
    return cfg if not job["layers"] else dataclasses.replace(
        cfg, num_layers=job["layers"])


def mesh_worker(out, jobs):
    """A rank of the mesh phase (spawned, one a card): every job in
    order; rank 0 writes the readings to ``out``."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import init_parallel_env

    torch.backends.cuda.matmul.allow_tf32 = False   # f32: exact checks
    torch.backends.cudnn.allow_tf32 = False
    # a collective that waits this long means a rank is lost: fail
    # (rank 0's one-card Llama-2 7B run, ~1 min, is the longest wait)
    init_parallel_env(timeout=MESH_TIMEOUT_S)
    res, shared = {}, {}
    for job in jobs:
        res[job["name"]] = mesh_job(job, shared)
    if dist.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(res, f)


def mesh_phase(card, parts=("mesh", "sp")):
    """Phases 9e ("mesh": :func:`mesh_jobs`) and 9f ("sp":
    :func:`sp_jobs`) in one spawn of one rank a card (four at most), then
    each run's readings checked and printed."""
    import tempfile

    from paddle_tpu_torch.distributed import spawn

    cards = torch.cuda.device_count()
    ranks = mesh_ranks(cards)
    jobs = (mesh_jobs(cards) if "mesh" in parts else []) + \
        (sp_jobs(cards) if "sp" in parts else [])
    if cards < 4:
        print("mesh: the full-width runs (9e: Llama-2 7B on dp 2 x mp 2, "
              "GPT-3 13B on mp 2 x dp 2, FSDP over dp; 9f: Llama-2 7B at "
              "1 x %d tokens, ring on sp 4 and ulysses on sp 2 x mp 2) "
              "need four cards; %d here: the 2-layer f32 checks only, on "
              "%s [%s]" % (SP_SEQ, cards, sorted({str(j["mesh"])
                                                  for j in jobs}), card),
              flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    fd, out = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        spawn(mesh_worker, (out, jobs), nprocs=ranks)
        with open(out) as f:
            res = json.load(f)
    finally:
        os.unlink(out)
    print("mesh: %d ranks, one a card, %.1f s in all [%s]"
          % (ranks, time.perf_counter() - t0, card), flush=True)
    for job in jobs:
        mesh_check(job, res[job["name"]], card)
    return res


def mesh_check(job, r, card):
    """One mesh run's printed readings, then its checks."""
    name = job["name"]
    losses, ref, c = r["losses"], r["reference_losses"], r["compare"]
    loss_rel = None if ref is None else [abs(a - b) / abs(b)
                                         for a, b in zip(losses, ref)]
    r["loss_rel"] = loss_rel
    nccl = r["nccl"]
    print("mesh %s: %s, %d layers %s, %d x %d tokens, %d steps; losses %s"
          "%s; %.1f tokens/s, median step %.2f ms, MFU %.4f (tokens/s x "
          "(6N + 6 L h s) / (989 TFLOP/s x %d cards), N = %d), setup %.1f "
          "s; peak memory %s GB; each rank's launches %s, median step %s "
          "ms and device time outside NCCL %s ms (skew %s); NCCL share of "
          "rank 0's device time %s [%s]" % (
              name, r["mesh"], r["layers"], r["dtype"], r["batch"][0],
              r["batch"][1], len(losses), ["%.5f" % x for x in losses],
              "" if ref is None else ", one card %s (relative differences "
              "%s)" % (["%.5f" % x for x in ref],
                       ["%.3g" % x for x in loss_rel]),
              r["tokens_s"], r["median_step_ms"], r["mfu"], r["cards"],
              r["params"], r["setup_s"],
              ["%.2f" % rk["peak_gb"] for rk in r["ranks"]],
              [{k: n for k, n in rk["launches"].items() if n}
               for rk in r["ranks"]],
              ["%.2f" % rk["median_step_ms"] for rk in r["ranks"]],
              ["not measured" if rk["profile"] is None else "%.2f"
               % rk["profile"]["compute_ms"] for rk in r["ranks"]],
              "not measured" if r["skew"] is None else "%.4f" % r["skew"],
              "not measured" if nccl is None else "%.4f (%.2f of %.2f ms)"
              % (nccl["share"], nccl["nccl_ms"], nccl["busy_ms"]), card),
          flush=True)
    if c:
        print("mesh %s: against one card: largest relative L2 a tensor "
              "%.3g (%s), a bias %.3g (%s), parameters %.3g together, %.3g "
              "of their updates; qkv key-bias third %.3g [%s]" % (
                  name, c["worst"], c["worst_name"], c["worst_bias"],
                  c["worst_bias_name"],
                  c.get("params_rel_l2", float("nan")),
                  c.get("update_rel_l2", float("nan")), c["key_bias"],
                  card), flush=True)
    check(all(np.isfinite(losses)), "mesh %s: losses %s" % (name, losses))
    for rk in r["ranks"]:
        got = rk["launches"]
        check(got == rk["want"] and got["K1"] > 0
              and got["K2"] + got["K3"] > 0,
              "mesh %s: rank %d launched %s, want %s"
              % (name, rk["rank"], got, rk["want"]))
        if "llama" in name:
            check(got["K7 rms_norm"] > 0, "mesh %s: no K7" % name)
    if job["exact"]:
        check(max(loss_rel) <= MESH_EXACT_RTOL
              and c["worst"] <= MESH_EXACT_RTOL
              and c["worst_bias"] <= MESH_BIAS_RTOL
              and c["key_bias"] <= 3 * MESH_LR,
              "mesh %s: against one card beyond the bounds %g (losses, "
              "tensors), %g (biases), %g (key third)"
              % (name, MESH_EXACT_RTOL, MESH_BIAS_RTOL, 3 * MESH_LR))
    elif ref is not None:
        later = max(loss_rel[1:] or [0.0])
        check(loss_rel[0] <= MESH_LOSS_RTOL and
              later <= MESH_LATER_LOSS_RTOL and
              c["params_rel_l2"] <= MESH_PARAM_RTOL and
              c["update_rel_l2"] <= MESH_UPDATE_RTOL,
              "mesh %s: against one card, first loss %.3g (bound %g), later"
              " losses %.3g (bound %g), params relative L2 %.3g (bound %g),"
              " %.3g of the update (bound %g)" % (
                  name, loss_rel[0], MESH_LOSS_RTOL, later,
                  MESH_LATER_LOSS_RTOL, c["params_rel_l2"],
                  MESH_PARAM_RTOL, c["update_rel_l2"], MESH_UPDATE_RTOL))
    else:
        check(losses[-1] < losses[0], "mesh %s: loss did not fall: %s"
              % (name, losses))


def main_path_phases(card, stamp):
    """Phases 3 to 9a, with 4d, and 9d: every kernel phase, training,
    serving in both layouts, the profiles, the MoE path and the decode
    paths. Returns the kernels line's rows of K1-K8, its JSON lines of
    the training, MoE, serving and decode numbers, and phase 4d's K9 /
    K10 readings."""
    k4 = kernel_phase(card)
    k5 = q8_kernel_phase(card)
    k7 = norm_phase(card)
    k6 = decode_kernel_phase(card)
    k8 = moe_kernel_phase(card)
    torch.cuda.empty_cache()
    ring = ring_kernel_phase(card)
    torch.cuda.empty_cache()
    flash = flash_kernel_phase(card)
    torch.cuda.empty_cache()
    sp_kernels = sp_kernel_phase(card)
    torch.cuda.empty_cache()
    stamp("the build and the kernel phases")
    training = {}
    for path in TRAIN_PATHS:
        # one path's models at a time: Llama-2 7B's step holds ~40 GB of
        # parameters, grads and moments
        model = train_model(path)
        if path == "gpt3_1p3B_stream":
            training[path], step, batch = stream_phase(card, path, model)
        elif path == "gpt3_1p3B_options":
            training[path], step, batch = options_phase(card, path, model)
        else:
            train_check(card, path, model)
            training[path], step, batch = train_phase(card, path, model)
        train_profile(step, batch, card, path)
        del model, step, batch
        torch.cuda.empty_cache()
        stamp("training " + path)
    train_launches = training["gpt3_1p3B"]["launches"]
    gpt, gpt_model, gpt_outs = engine_phase(card)
    torch.cuda.empty_cache()
    llama, llama_model, llama_outs = llama_engine_phase(card)
    torch.cuda.empty_cache()
    stamp("ragged serving")
    Lg, Ll = gpt_model.config.num_layers, llama_model.config.num_layers
    off_gpt = off_engine_phase(
        card, gpt_model, "gpt3_1p3B off", gpt_outs,
        {"K4": 0, "K5": 0, "K6": Lg, "K6-q8": 0, "K7 rms_norm": 0,
         "K7 layer_norm": 2 * Lg + 1, "K7 rms_norm fused": 0,
         "K7 layer_norm fused": 2 * Lg}, LOGITS_TOL, SERVE_HIDDEN_RTOL)
    torch.cuda.empty_cache()
    off_llama = off_engine_phase(
        card, llama_model, "llama2_7B int8 off", llama_outs,
        {"K4": 0, "K5": 0, "K6": 0, "K6-q8": Ll,
         "K7 rms_norm": 2 * Ll + 1, "K7 layer_norm": 0,
         "K7 rms_norm fused": 2 * Ll, "K7 layer_norm fused": 0},
        LLAMA_LOGITS_TOL,
        LLAMA_HIDDEN_RTOL, kv_quant="int8")
    torch.cuda.empty_cache()
    stamp("off-layout serving")
    for ragged in ("on", "off"):
        profile_phase(card, llama_model, "llama2_7B int8 ragged=" + ragged,
                      kv_quant="int8", ragged=ragged, **SERVE_ENGINE)
    del llama_model
    torch.cuda.empty_cache()
    for ragged in ("on", "off"):
        profile_phase(card, gpt_model, "gpt3_1p3B ragged=" + ragged,
                      ragged=ragged, **SERVE_ENGINE)
    del gpt_model
    torch.cuda.empty_cache()
    stamp("the profiles")
    moe = moe_phase(card)
    torch.cuda.empty_cache()
    stamp("the MoE path")
    decode = decode_phase(card)
    torch.cuda.empty_cache()
    stamp("the decode paths")
    dg, dl = decode["gpt3_1p3B"], decode["llama2_7B"]

    rpa_src = "paddle_tpu_torch/incubate/nn/csrc/ragged_paged_attention.cu"
    kernels = []
    for name, line, runs, at, launches, shape in (
            ("ragged_paged_attention", 263, k4, "mixed",
             gpt["launches"]["K4"], "136-token axis, bf16, 16 heads, d 128, "
             "page 16 (GPT-3 1.3B serving)"),
            ("ragged_paged_attention_q8", 303, k5, "mixed",
             llama["launches"]["K5"], "136-token axis, bf16 q, int8 pools, "
             "32 heads, d 128, page 16 (Llama-2 7B serving)")):
        r = runs[at]
        kernels.append({
            "name": name, "route": "cuda", "source": rpa_src,
            "replaces": "paddle_tpu/incubate/nn/pallas/paged_attention.py:%d"
                        % line, "status": "ported", "launches": launches,
            "max_abs_err": max(x["max_abs_err"] for x in runs.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "at": "mixed: one 128-token prefill chunk + 7 decode rows, "
                  + shape + "; ms and library_ms a call in a CUDA graph",
            "mixes": runs})
    for name, line, case, kinds, launches, shape in (
            ("rms_norm", 32, "rms+res bfloat16 d 4096 n 136",
             ("rms", "rms_bias", "rms+res"), llama["launches"]["K7 rms_norm"],
             "Llama-2 7B serving: the residual update and the norm after "
             "it, the form of all but one of a pass's 2L + 1 launches"),
            ("layer_norm", 49, "ln+bias+res bfloat16 d 2048 n 136",
             ("ln", "ln+bias+res"), gpt["launches"]["K7 layer_norm"],
             "GPT-3 1.3B serving: the linear's bias, the residual update "
             "and the norm after it, the form of all but one of a pass's "
             "2L + 1 launches")):
        r = k7[case]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/incubate/nn/csrc/norms.cu",
            "replaces": "paddle_tpu/incubate/nn/pallas/norms.py:%d" % line,
            "status": "ported", "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "at": "%s: 136 rows (%s)" % (case, shape),
            "cases": {k: v for k, v in k7.items() if k.split()[0] in kinds},
            "launches_by_path": {
                "llama2_7B_int8 serving": launches,
                "llama2_7B training": training["llama2_7B"]["launches"][
                    "K7 rms_norm"],
                "llama2_7B_decode": dl["launches"]["K7 rms_norm"],
                "llama2_7B_cached": dl["exact_f32"]["cached_loop"][
                    "launches"]["K7 rms_norm"]} if name == "rms_norm" else {
                "gpt3_1p3B serving": launches,
                "gpt3_1p3B_decode": dg["launches"]["K7 layer_norm"]}})
    for kname, name, line in (("K1", "flash_fwd", 53),
                              ("K2", "flash_bwd_fused", 279),
                              ("K3", "flash_bwd_split", 168)):
        r = flash[kname]
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SRC,
            "replaces": "%s:%d" % (FLASH_PALLAS, line), "status": "ported",
            "launches": train_launches[kname],
            "launches_by_path": dict(
                {p: t["launches"][kname] for p, t in training.items()},
                **({"gpt3_1p3B_decode": dg["launches"]["K1"],
                    "gpt3_1p3B_cached": dg["exact_f32"]["cached_loop"][
                        "launches"]["K1"],
                    "llama2_7B_decode": dl["launches"]["K1"],
                    "llama2_7B_cached": dl["exact_f32"]["cached_loop"][
                        "launches"]["K1"]} if kname == "K1" else {})),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "at": "training shapes: b 8, s 1024, 16 heads, d 128, bf16, "
                  "causal (GPT-3 1.3B; Llama-2 7B's, b 2, s 4096, 32 "
                  "heads, under llama_train; bench.py's seq-2048 "
                  "sub-bench's, b 4, s 2048, 16 heads, under seq2048)",
            **({"split_route": r["split_route"]} if kname == "K3" else {}),
            **({"ulysses_shape": sp_kernels["ulysses"][kname],
                "whole_sequence_shape": sp_kernels["whole"][kname]}
               if kname in sp_kernels["ulysses"] else {}),
            **({"sp_parts": dict(sp_kernels["ring"],
                                 times_ms=sp_kernels["times_ms"])}
               if kname == "K1" else {}),
            **({"decode_shapes": decode["k1"]} if kname == "K1" else {})})
    for name, route, mix, prefill, line, status, off, shape in (
            ("paged_attention", "K6", "gpt_decode", "gpt_prefill", 53,
             "ported", off_gpt, "bf16 pools, 16 heads, d 128 (GPT-3 1.3B "
             "serving, ragged=off)"),
            ("paged_attention_q8", "K6-q8", "decode", "prefill", 97,
             "port route, no TPU kernel (the int8 branch of "
             "_xla_paged_attention)", off_llama,
             "bf16 q, int8 pools, 32 heads, d 128 (Llama-2 7B serving, "
             "ragged=off)")):
        launches = off["launches"][route]
        r = k6[mix][route]
        kernels.append({
            "name": name, "route": "cuda", "source": DECODE_SRC,
            "replaces": "paddle_tpu/incubate/nn/pallas/paged_attention.py:%d"
                        % line, "status": status, "launches": launches,
            "max_abs_err": max(x[route]["max_abs_err"] for x in k6.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "at": "%s: a decode batch of 8 rows (contexts 64-1056, two "
                  "empty), page 16, %s" % (mix, shape),
            "prefill_chunk": {key: k6[prefill][route][key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "launches_by_program": off["launches_by_program"][route],
            "mixes": {k: v[route] for k, v in k6.items()}})
    r = k8["bench ffn1"]
    kernels.append({
        "name": "grouped_matmul", "route": "cuda", "source": MOE_SRC,
        "replaces": "paddle_tpu/incubate/nn/pallas/moe_dispatch.py:97",
        "status": "ported", "launches": moe["launches"],
        "max_abs_err": max(x["max_abs_err"] for x in k8.values()),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "at": "bench ffn1: fused_moe's first product at bench.py's MoE "
              "step, P 17408 (16384 real rows) x K 2048 -> N 5632, 8 "
              "experts, bf16, with the dispatch's row counts as "
              "moe_ffn_sorted passes them (its second, K 2816 -> N 2048, "
              "and Mixtral-8x7B's under cases)", "cases": k8})
    lines = [json.dumps({"training": training}),
             json.dumps({"moe": moe}),
             json.dumps({"serving": {"gpt3_1p3B": gpt,
                                     "llama2_7B_int8": llama,
                                     "gpt3_1p3B_off": off_gpt,
                                     "llama2_7B_int8_off": off_llama}}),
             json.dumps({"decode": decode})]
    return kernels, lines, ring


def ring_rows(ring, tp, pp):
    """The kernels line's K9 and K10 rows: times from phase 4d at the main
    paths' shapes (mp 2 f32 for K9, the S 2 boundary tensor in f32 for
    K10), launches from the TP path's (mp 2) and the pipeline's (S 2)
    runs."""
    k9 = ring["K9"]["bench mp2 float32"]
    k9_bf16 = ring["K9"]["bench mp2 bfloat16"]
    k10 = ring["K10"]["pp2 float32"]
    rows = []
    for name, src, r, launches, at, cases in (
            ("ring_mm_step", "paddle_tpu/fusion/overlap_mm.py:208", k9,
             tp["mp2"]["forward_launches"],
             "bench.py's TP shape at mp 2, f32: buf [8192, 4096], w [4096, "
             "512] a rank, " + k9["where"], ring["K9"]),
            ("ring_shift",
             "paddle_tpu/distributed/pipeline/transport.py:74", k10,
             pp["S2"]["launches"],
             "the pipeline leg's boundary tensor [1, 1024, 2048] f32, one "
             "shift of every rank, " + k10["where"], ring["K10"])):
        rows.append({
            "name": name, "route": "cuda", "source": RING_SRC,
            "replaces": src, "status": "ported", "launches": launches,
            "max_abs_err": max(x["max_abs_err"] for x in cases.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "at": at,
            "peer_access": ring["peer_access"], "cases": cases})
    # K9 in bf16 at the same shape, beside the f32 figures of the main
    # path (bench.py's TP leg runs f32)
    rows[0]["bf16"] = {key: k9_bf16[key] for key in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err",
        "tile", "items", "waves")}
    # K10 alone across cards (None with one card): see shift_device_ms
    rows[-1].update(device_ms=k10["device_ms"],
                    device_library_ms=k10["device_library_ms"])
    return rows


def mesh_rows(kernels, mesh):
    """The mesh paths' launches beside the other paths' in K1's, K2's,
    K3's and K7 RMSNorm's rows: a rank's where every rank's are equal,
    else each rank's (the ring's rank r runs r + 1 parts). A row whose
    training path launched nothing (K3: s·d under K2's cap there) takes
    its launches from the mesh path that ran it most, named in
    ``launches_from``."""
    for row in kernels:
        key = {"flash_fwd": "K1", "flash_bwd_fused": "K2",
               "flash_bwd_split": "K3",
               "rms_norm": "K7 rms_norm"}.get(row["name"])
        if key is None:
            continue
        paths = row.setdefault("launches_by_path", {})
        for name, r in mesh.items():
            counts = [rk["launches"][key] for rk in r["ranks"]]
            if key != "K7 rms_norm" or "llama" in name:
                if len(set(counts)) == 1:
                    paths["mesh %s %s, a rank" % (name, r["mesh"])] = \
                        counts[0]
                else:
                    paths["mesh %s %s, each rank" % (name, r["mesh"])] = \
                        counts
                if not row["launches"] or row.get("launches_from") and \
                        row["launches"] < max(counts):
                    row["launches"] = max(counts)
                    row["launches_from"] = "mesh %s %s, a rank" % (
                        name, r["mesh"])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--phases", choices=("all", "ring", "mesh", "sp"), default="all",
        help="all: every phase (the default); ring: only the card, the "
             "ring kernels' build and phases 4d, 9b and 9c; mesh: only the "
             "card, K1-K3's and K7's build and phases 9e and 9f; sp: only "
             "the card, K1-K3's and K7's build, phase 5b and phase 9f")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    from paddle_tpu_torch.incubate.nn.cuda import _build

    t_main = time.perf_counter()

    def stamp(what):
        # where the run's time limit goes, phase by phase
        print("chip_smoke: %.1f s in, after %s"
              % (time.perf_counter() - t_main, what), flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain versions
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    sources = {"all": _build.SOURCES, "ring": ("ring",),
               "mesh": ("flash_attn", "norms"),
               "sp": ("flash_attn", "norms")}[args.phases]
    secs = _build.build_all(sources)
    print("build: %s in %.2f s" % (", ".join(sources), secs))
    for name in sources:
        for line in _build.ptxas_report(name).splitlines():
            # (C7517) / (C7518): a wgmma kernel waits where it should not
            if "registers" in line or "spill" in line or \
                    "Function properties" in line or "(C75" in line:
                print("ptxas %s: %s" % (name, line.strip()))
    sys.stdout.flush()

    if args.phases in ("mesh", "sp"):
        out = {}
        if args.phases == "sp":
            out["sp_kernels"] = sp_kernel_phase(card)
            torch.cuda.empty_cache()
            stamp("the sp kernel phase")
        out["mesh"] = mesh_phase(card, ("mesh", "sp") if args.phases ==
                                 "mesh" else ("sp",))
        stamp("the mesh paths")
        print(json.dumps(out))
    else:
        if args.phases == "all":
            kernels, lines, ring = main_path_phases(card, stamp)
        else:
            kernels, lines = [], []
            ring = ring_kernel_phase(card)
            torch.cuda.empty_cache()
            stamp("the build and the ring kernel phase")
        tp = tp_phase(card)
        stamp("the TP path")
        pp = pipeline_phase(card)
        stamp("the pipeline")
        kernels += ring_rows(ring, tp, pp)
        if args.phases == "all":
            mesh = mesh_phase(card)
            stamp("the mesh path")
            mesh_rows(kernels, mesh)
            lines.append(json.dumps({"mesh": mesh}))
        for line in lines:
            print(line)
        print(json.dumps({"tp": tp, "pipeline": pp}))
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
