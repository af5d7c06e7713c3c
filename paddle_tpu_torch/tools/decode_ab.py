#!/usr/bin/env python3
"""A/B builds of the paged-decode kernel (K6, K6-q8) on one card.

Builds variants of ``paddle_tpu_torch/incubate/nn/csrc/paged_attention.cu``,
each a textual change of the source, into ``_archive/decode_ab/``
(git-ignored), one ``nvcc`` each, all started together; then, in one
process on one card, holds each variant against the plain version (row
error in units of the row's RMS) and times it per call in a CUDA graph,
in turns (the variants in order, then reversed), on the mixes of
``chip_smoke.py``'s phase 4b that the serving layout ``ragged="off"``
runs: GPT-3 1.3B's decode batch and prefill chunk over bf16 pools (K6),
Llama-2 7B's over int8 pools (K6-q8), a prefill chunk with garbage past
each row's pages and decode rows of 2048-4096 keys, beside SDPA over K/V
gathered per row (timed only). Run from the repository root on a machine
with a Hopper card and the CUDA toolkit::

    python3 paddle_tpu_torch/tools/decode_ab.py [variant ...] [--parent FILE]

``--parent FILE`` adds an earlier source of the kernel, written out by
``git show <commit>:paddle_tpu_torch/incubate/nn/csrc/paged_attention.cu``:
one with this source's C entry points, or the first port's
(``pa_launch(q, k, v, block_tables, context_lens, out, n_rows, n_heads,
n_kv, d, total_pages, page, pages_per_seq, scale, is_bf16, stream)`` and
``pa_q8_launch``, no workspace).

Variants (all by default):
  base        the source as it is
  no_share    rows never share a read: every row runs alone
  stages2     a 2-chunk ring a warp instead of 3
  loads_only  the chunks are copied into the rings and not used (out is
              wrong: the feed, the page ids and the merges alone)
  target4     key splits sized for four times the SMs' worth of units in
              every call (the source: four for decode batches, once for
              prefill chunks)
  target1     and for once in every call
"""
import ctypes
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.incubate.nn.cuda import _build  # noqa: E402
from paddle_tpu_torch.incubate.nn.cuda import \
    paged_attention as pa  # noqa: E402
from paddle_tpu_torch.tools import _ab  # noqa: E402

SRC = ROOT / "paddle_tpu_torch/incubate/nn/csrc/paged_attention.cu"
OUT = ROOT / "_archive/decode_ab"
VARIANTS = {
    "base": [],
    "no_share": [("      shared = live >= 2 && !any_diff;",
                  "      shared = false;")],
    "stages2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "loads_only": [("    consume(j % kStages, first(j));\n", "")],
    "target4": [("(rows ? 4LL : 1LL) * n_sm", "4LL * n_sm")],
    "target1": [("(rows ? 4LL : 1LL) * n_sm", "1LL * n_sm")],
}


def caller(name, lib):
    """``fn(q, k, v, bt, cl) -> out`` on the variant's library: the
    wrapper bound to it, or, for a parent source of the first port's (no
    workspace: no ``pa_workspace_floats``), its own entry points."""
    if name != "parent" or hasattr(lib, "pa_workspace_floats"):
        load, pa._decode_lib = _build.load, None
        _build.load = lambda _name: lib               # bind this library
        try:
            pa._bind_decode()
        finally:
            _build.load = load
        bound = pa._decode_lib

        def run(*case):
            pa._decode_lib = bound
            return pa.paged_attention(*case)
        return run
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pa_launch.argtypes = [p] * 6 + [i] * 7 + [f, i, p]
    lib.pa_q8_launch.argtypes = [p] * 8 + [i] * 7 + [f, i, p]

    def run(q, kp, vp, bt, cl):
        out = torch.zeros_like(q)
        n_rows, n_heads, d = q.shape
        n_kv, total, page, _ = pa.pool_shape(kp)
        if isinstance(kp, dict):
            fn, pools = lib.pa_q8_launch, (kp["q8"], kp["s"], vp["q8"],
                                           vp["s"])
        else:
            fn, pools = lib.pa_launch, (kp, vp)
        rc = fn(q.data_ptr(), *(t.data_ptr() for t in pools), bt.data_ptr(),
                cl.data_ptr(), out.data_ptr(), n_rows, n_heads, n_kv, d,
                total, page, bt.shape[1], d ** -0.5,
                int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, "the parent's launch failed (%d)" % rc)
        return out
    return run


def cases():
    """name -> K6 case: phase 4b's serving mixes on its seed."""
    rng = np.random.RandomState(4)
    gen = torch.Generator(device="cuda").manual_seed(4)
    decode = rng.randint(64, 1057, 8)
    decode[[2, 5]] = 0
    decode = decode.tolist()
    prefill = list(range(897, 1005)) + [0] * 20
    long_lens = rng.randint(2048, 4097, 8).tolist()
    out = {}
    for name, lens, nh, shared, q8 in (
            ("gpt_decode", decode, 16, False, False),
            ("gpt_prefill", prefill, 16, True, False),
            ("llama_decode q8", decode, 32, False, True),
            ("llama_prefill q8", prefill, 32, True, True),
            ("prefill_tails q8", prefill, 32, "tails", True),
            ("long q8", long_lens, 32, False, True)):
        case = cs.decode_case(rng, gen, lens, nh, nh, 128, 16, shared)
        out[name] = cs.q8_case(case) if q8 else case
    return out


def main(argv):
    parent = None
    if "--parent" in argv:
        parent = Path(argv[argv.index("--parent") + 1])
    names = [n for n in VARIANTS if n in argv] or list(VARIANTS)
    card = _ab.card()
    sources = _ab.patch(SRC.read_text(), VARIANTS, names)
    if parent is not None:
        sources["parent"] = parent.read_text()
        names.append("parent")
    t0 = time.perf_counter()
    libs = _ab.build(sources, OUT)
    print("%s; built %s in %.1f s" % (card, ", ".join(names),
                                       time.perf_counter() - t0), flush=True)
    fns = {name: caller(name, libs[name]) for name in names}
    work = cases()
    for case_name, case in work.items():
        want = pa.paged_attention_ref(*case)
        live = case[4] > 0
        for name in names:
            got = fns[name](*case)
            torch.cuda.synchronize()
            print("%-10s %-16s row error %.3g of the row's RMS" % (
                name, case_name, cs.row_err(got[live], want[live])[1]),
                flush=True)
    times = {name: {c: [] for c in work} for name in names}
    for order in (names, names[::-1]):
        for name in order:
            for case_name, case in work.items():
                times[name][case_name].append(cs.graph_ms(
                    lambda: fns[name](*case)))
    for name in names:
        print("%-10s %s [%s]" % (name, ", ".join(
            "%s %s ms" % (c, " / ".join("%.4f" % x for x in v))
            for c, v in times[name].items()), card), flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = {}
    for case_name, case in work.items():
        if isinstance(case[1], dict):
            case = (case[0],) + tuple(pa._dequant(p["q8"], p["s"]).bfloat16()
                                      for p in case[1:3]) + case[3:]
        qs, kg, vg, mask = cs.decode_sdpa_inputs(case)
        lib_ms[case_name] = cs.graph_ms(lambda: sdpa(qs, kg, vg,
                                                     attn_mask=mask))
        del qs, kg, vg, mask
    print("library    %s [%s]" % (", ".join(
        "%s %.4f ms" % kv for kv in lib_ms.items()), card), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
