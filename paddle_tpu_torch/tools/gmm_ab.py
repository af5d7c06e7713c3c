#!/usr/bin/env python3
"""A/B builds of the MoE grouped GEMM (K8) on one card.

Builds variants of ``paddle_tpu_torch/incubate/nn/csrc/moe_dispatch.cu``,
each a textual change of the source, into ``_archive/gmm_ab/``
(git-ignored), one ``nvcc`` each, all started together; then, in one
process on one card, holds each variant against the plain version at
bench.py's first MoE product (row error in units of the row's RMS) and
times it with CUDA events on the bf16 products of ``chip_smoke.py``'s
phase 4c, with the dispatch's row counts as ``moe_ffn_sorted`` passes
them: bench.py's MoE step (8192 tokens x 2048, 8 experts, dff 2816,
top-2) and Mixtral-8x7B's widths at a 2048-token prefill and an 8-token
decode batch, in turns (the variants in order, then reversed), beside
``torch._grouped_mm`` (timed only). Run from the repository root on a
machine with a Hopper card and the CUDA toolkit::

    python3 paddle_tpu_torch/tools/gmm_ab.py [variant ...] [--parent FILE]

``--parent FILE`` adds an earlier source of the kernel with the C entry
point ``gmm_launch(xp, w, block_gid, out, p, k, n, e, is_bf16, stream)``
(no row counts), e.g. the first port's, written out by
``git show <commit>:paddle_tpu_torch/incubate/nn/csrc/moe_dispatch.cu``.

Variants (all by default):
  base       the source as it is
  n_inner    items walk the column tiles of one row block first (groups
             of one row block)
  no_order   the blocks of padding not moved to the end of the walk
  stages2    a 2-stage ring instead of 3
  no_store   the epilogue's TMA stores left out (out is wrong: what the
             stores cost)
  loads_only the products left out (out is wrong: the copies, barriers
             and epilogue alone)
"""
import ctypes
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.incubate.nn.cuda import _build  # noqa: E402
from paddle_tpu_torch.incubate.nn.cuda import \
    moe_dispatch as kmd  # noqa: E402
from paddle_tpu_torch.tools import _ab  # noqa: E402

SRC = ROOT / "paddle_tpu_torch/incubate/nn/csrc/moe_dispatch.cu"
OUT = ROOT / "_archive/gmm_ab"
PRODUCTS = ("          for (int kk = 0; kk < kTK / 16; ++kk)   "
            "// 16 K a step\n"
            "            wgmma_n256(acc, sw128_desc(as + kk * 32, 16, "
            "1024),\n"
            "                       sw128_desc(bs + kk * 16 * 128, "
            "kBoxBytes, 1024));\n")
VARIANTS = {
    "base": [],
    "n_inner": [("constexpr int kGroup = 16;", "constexpr int kGroup = 1;")],
    "no_order": [("  if (rows != nullptr && n_blocks <= kMaxOrder) {",
                  "  if (false) {")],
    "stages2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "no_store": [("        tma_store_2d(&tc, ep + c * kOutBox, n0 + 64 * c,\n"
                  "                     blk * kBM + 64 * wg);\n", "")],
    "loads_only": [(PRODUCTS, "")],
}


def caller(name, lib):
    """``fn(xp, w, gid, rows) -> out`` on the variant's library: the
    wrapper bound to it, or, for the parent source, its own entry point
    (it takes no row counts)."""
    if name != "parent":
        load, kmd._lib = _build.load, None
        _build.load = lambda _name: lib               # bind this library
        try:
            kmd._bind()
        finally:
            _build.load = load
        bound = kmd._lib

        def run(xp, w, gid, rows):
            kmd._lib = bound
            return kmd.grouped_matmul(xp, w, gid, rows=rows)
        return run
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gmm_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.gmm_launch.restype = i

    def run(xp, w, gid, rows):
        out = torch.empty(xp.shape[0], w.shape[-1], dtype=xp.dtype,
                          device=xp.device)
        rc = lib.gmm_launch(xp.data_ptr(), w.data_ptr(), gid.data_ptr(),
                            out.data_ptr(), xp.shape[0], xp.shape[1],
                            w.shape[-1], w.shape[0], 1,
                            torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, "the parent's launch failed (%d)" % rc)
        return out
    return run


def cases():
    """name -> (xp, w, block_gid, rows): the bf16 products of phase 4c on
    seed-0 routing, the second fed the first through SwiGLU (computed on
    the plain version)."""
    out = {}
    bench = cs.moe_problem(**cs.MOE_BENCH)
    mixtral = cs.moe_problem(**dict(cs.MIXTRAL, tokens=2048))
    for tag, (x, gate, w1, w2) in (
            ("bench", bench), ("mixtral prefill", mixtral),
            ("mixtral decode", (mixtral[0][:8].contiguous(),
                                *mixtral[1:]))):
        _, d = cs.moe_routing(x, gate, 2)
        gid = d["block_gid"]
        rows = kmd.block_rows(gid, d["group_sizes"], d["padded_sizes"])
        h = cs.swiglu(kmd.grouped_matmul_ref(d["xp"], w1, gid, rows=rows))
        out[tag + " ffn1"] = (d["xp"], w1, gid, rows)
        out[tag + " ffn2"] = (h.contiguous(), w2, gid, rows)
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
    libs = _ab.build(sources, OUT, "gmm_wgmma")
    print("%s; built %s in %.1f s" % (card, ", ".join(names),
                                       time.perf_counter() - t0), flush=True)
    fns = {name: caller(name, libs[name]) for name in names}
    work = cases()
    xp, w, gid, rows = work["bench ffn1"]
    want = kmd.grouped_matmul_ref(xp, w, gid, rows=rows)
    for name in names:
        got = fns[name](xp, w, gid, rows)
        torch.cuda.synchronize()
        print("%-10s bench ffn1 row error %.3g of the row's RMS"
              % (name, cs.row_err(got, want)[1]), flush=True)
    del want, got
    for order in (names, names[::-1]):
        for name in order:
            fn = fns[name]
            print("%-10s %s [%s]" % (name, ", ".join(
                "%s %.4f ms" % (case, cs.cuda_ms(
                    lambda c=c: fn(*c), 10))
                for case, c in work.items()), card), flush=True)
    print("library    %s [%s]" % (", ".join(
        "%s %.4f ms" % (case, cs.cuda_ms(cs.gmm_library(*c[:3]), 10))
        for case, c in work.items()), card), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
