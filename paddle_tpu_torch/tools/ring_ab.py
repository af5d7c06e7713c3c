#!/usr/bin/env python3
"""A/B builds of the TP ring step (K9) on the card(s).

Builds variants of ``paddle_tpu_torch/incubate/nn/csrc/ring.cu``, each a
textual change of the source, into ``_archive/ring_ab/`` (git-ignored),
one ``nvcc`` each, all started together; then, in one process, holds
each variant against the plain version at bench.py's TP shape (partials
by row error in units of the row's RMS, ``next`` bit-exact) and times one
step of every rank (``ring_mm_step_launch`` on preallocated buffers, the
wrapper's allocation left out) in turns (the variants in order, then
reversed; a step in a CUDA graph when the ranks share a card, by host
clock across cards), beside the library yardstick of ``chip_smoke.py``'s
phase 4d (``torch.matmul`` with the copy as ``copy_`` on a side stream,
timed only): bench.py's TP shape (T 16384, K 4096, N 1024) at mp 2 and 4, f32
and bf16, with the ranks on card 0 and, where as many cards with peer
access exist, one rank a card. Run from the repository root on a machine
with a Hopper card and the CUDA toolkit::

    python3 paddle_tpu_torch/tools/ring_ab.py [variant ...] [--parent FILE]

``--parent FILE`` adds an earlier source of the kernel with the same C
entry point ``ring_mm_step_launch(buf, w, partial, next, t, k, n,
is_bf16, stream)``, e.g. the first port's, written out by ``git show
<commit>:paddle_tpu_torch/incubate/nn/csrc/ring.cu``.

Variants (all by default):
  base         the source as it is: the copy rides on the product's loads
  copy_blocks  separate copy blocks beside the product's blocks, as many as
               the copy's HBM bytes take of the SMs against the product's
               operations at the card's peak rates
  stages2      a 2-stage TMA ring instead of 3 (bf16)
  bn256        bf16 tiles of 256 columns whatever the item count
  f32_128x128  f32 tiles of 128 x 128 whatever the item count (mp 4: 64
               tiles, not 128 of 64 x 128)
  no_copy      the copy left out (next is wrong: what the copy costs)
  loads_only   the bf16 products left out (partials are wrong: the loads,
               the copy and the epilogue alone)
"""
import ctypes
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.distributed import Ring  # noqa: E402
from paddle_tpu_torch.incubate.nn.cuda import ring as kring  # noqa: E402
from paddle_tpu_torch.tools import _ab  # noqa: E402

SRC = ROOT / "paddle_tpu_torch/incubate/nn/csrc/ring.cu"
OUT = ROOT / "_archive/ring_ab"
# the copy on the product's loads left out
NO_FUSED_COPY = [
    ("        if (kt % n_tiles == tn) {", "        if (false) {"),
    ("    const bool copy = kt % tiles_n == tn && kc + ka < k;",
     "    const bool copy = false;")]
# blocks below `copy_blocks` copy buf on their own (copy16, as K10 does)
# and the product's blocks copy nothing: as many as the copy's HBM time
# (buf read, next written) takes of the SMs against the product's time at
# the card's peak rates
COPY_BLOCKS = NO_FUSED_COPY + [
    ("                          bf16* __restrict__ next, int t, int k,\n"
     "                          int n) {\n  using S = Smem<BN>;\n",
     "                          bf16* __restrict__ next, int t, int k,\n"
     "                          int n, int copy_blocks) {\n"
     "  using S = Smem<BN>;\n"
     "  if ((int)blockIdx.x < copy_blocks) {\n"
     "    copy16(reinterpret_cast<uint4*>(next),\n"
     "           reinterpret_cast<const uint4*>(buf), (size_t)t * k / 8,\n"
     "           blockIdx.x, copy_blocks);\n"
     "    return;\n  }\n"),
    ("  const int first = (int)blockIdx.x;\n"
     "  const int stride = (int)gridDim.x;\n",
     "  const int first = (int)blockIdx.x - copy_blocks;\n"
     "  const int stride = (int)gridDim.x - copy_blocks;\n"),
    ("                        int tiles_n) {",
     "                        int tiles_n, int copy_blocks) {"),
    ("  const int b = (int)blockIdx.x;\n",
     "  if ((int)blockIdx.x < copy_blocks) {\n"
     "    copy16(reinterpret_cast<uint4*>(next),\n"
     "           reinterpret_cast<const uint4*>(a), (size_t)t * k / 4,\n"
     "           blockIdx.x, copy_blocks);\n"
     "    return;\n  }\n"
     "  const int b = (int)blockIdx.x - copy_blocks;\n"),
    ("struct Plan {\n  int bm, bn, items, grid;\n};",
     "int separate_copy_blocks(int t, int k, int n, bool is_bf16, int sms) {\n"
     "  const double bytes = 2.0 * t * k * (is_bf16 ? 2 : 4);\n"
     "  const double t_copy = bytes / 3.35e12;\n"
     "  const double t_prod = 2.0 * t * k * n / (is_bf16 ? 989e12 : 67e12);\n"
     "  const int c = (int)(sms * t_copy / (t_copy + t_prod) + 0.5);\n"
     "  return c < 1 ? 1 : (c > sms - 1 ? sms - 1 : c);\n}\n\n"
     "struct Plan {\n  int bm, bn, items, grid, copy_blocks;\n};"),
    ("  Plan p;\n  if (is_bf16) {",
     "  Plan p;\n"
     "  p.copy_blocks = separate_copy_blocks(t, k, n, is_bf16, sms);\n"
     "  if (is_bf16) {"),
    ("    p.grid = p.items < sms ? p.items : sms;",
     "    const int room = sms - p.copy_blocks > 1 ? sms - p.copy_blocks : 1;\n"
     "    p.grid = p.copy_blocks + (p.items < room ? p.items : room);"),
    ("    p.grid = p.items;\n", "    p.grid = p.copy_blocks + p.items;\n"),
    ("      static_cast<bf16*>(next), t, k, n);",
     "      static_cast<bf16*>(next), t, k, n, p.copy_blocks);"),
    ("        a, b, c, d, t, k, n, tiles_n);",
     "        a, b, c, d, t, k, n, tiles_n, p.copy_blocks);")]
VARIANTS = {
    "base": [],
    "copy_blocks": COPY_BLOCKS,
    "stages2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "bn256": [("    p.bn = 4LL * cdiv(t, kBM) * cdiv(n, 256) >= 3LL * sms "
               "? 256 : 64;", "    p.bn = 256;")],
    "f32_128x128": [("    p.bm = (long long)cdiv(t, 128) * cdiv(n, kBN32) >= "
                     "sms ? 128 : 64;", "    p.bm = 128;")],
    "no_copy": NO_FUSED_COPY,
    "loads_only": [("#pragma unroll\n      for (int kk = 0; kk < kTK / 16; "
                    "++kk)     // 16 K a step\n        wgmma<BN>(acc, "
                    "sw128_desc(as + kk * 32, 16, 1024),\n                  "
                    "sw128_desc(bs + kk * 16 * 128, kBoxBytes, 1024));\n",
                    "")],
}


def bind(libs):
    """Declares ``ring_mm_step_launch`` on each variant's library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.ring_mm_step_launch.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.ring_mm_step_launch.restype = i
    return libs


def stepper(lib, ring, bufs, ws):
    """``fn()``: one K9 launch a rank on ``lib``, into buffers allocated
    here once (each rank's ``next`` on the next rank's card), ordered
    across cards as the wrapper orders them; returns (partials, nexts)."""
    k, n = ws[0].shape
    t = bufs[0].numel() // k
    parts = [torch.empty(t, n, dtype=b.dtype, device=b.device) for b in bufs]
    nexts = [torch.empty_like(b, device=ring.device(r + 1))
             for r, b in enumerate(bufs)]
    is_bf16 = int(bufs[0].dtype == torch.bfloat16)

    def fn():
        ring.before_writes(1)
        for r in range(ring.size):
            with torch.cuda.device(ring.device(r)):
                rc = lib.ring_mm_step_launch(
                    bufs[r].data_ptr(), ws[r].data_ptr(),
                    parts[r].data_ptr(), nexts[r].data_ptr(), t, k, n,
                    is_bf16, ring.stream(r).cuda_stream)
            cs.check(rc == 0, "a K9 launch failed (%d)" % rc)
        ring.after_writes(1)
        return parts, [nexts[(r - 1) % ring.size] for r in range(ring.size)]
    return fn


def main(argv):
    parent = None
    if "--parent" in argv:
        parent = Path(argv[argv.index("--parent") + 1])
    names = [n for n in VARIANTS if n in argv] or list(VARIANTS)
    card = _ab.card()
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = _ab.patch(SRC.read_text(), VARIANTS, names)
    if parent is not None:
        sources["parent"] = parent.read_text()
        names.append("parent")
    t0 = time.perf_counter()
    libs = bind(_ab.build(sources, OUT, "ring_mm_step"))
    print("%s; built %s in %.1f s" % (card, ", ".join(names),
                                       time.perf_counter() - t0), flush=True)
    T, K, N = cs.TP_BENCH["T"], cs.TP_BENCH["K"], cs.TP_BENCH["N"]
    for mp in (2, 4):
        rings = {"one card": Ring(["cuda:0"] * mp)}
        devs = cs.ring_devices(mp)
        if len(set(devs)) > 1:
            rings["cards %s" % ",".join(d[5:] for d in devs)] = Ring(devs)
        for where, ring in rings.items():
            for dtype in (torch.float32, torch.bfloat16):
                bufs, ws = cs.mm_step_case(ring, T // mp, K, N // mp, dtype,
                                           mp)
                tag = "mp%d %s %s" % (mp, str(dtype)[6:], where)
                want_p, want_n = kring.mm_step_ref(bufs, ws, ring)
                fns = {name: stepper(libs[name], ring, bufs, ws)
                       for name in names}
                for name in names:
                    parts, nexts = fns[name]()
                    for c in cs.ring_cards(ring):
                        torch.cuda.synchronize(c)
                    rel = max(cs.row_err(p, w)[1]
                              for p, w in zip(parts, want_p))
                    exact = all(torch.equal(a, b)
                                for a, b in zip(nexts, want_n))
                    print("%-11s %s: row error %.3g of the row's RMS, next "
                          "%s" % (name, tag, rel, "bit-exact" if exact
                                  else "NOT bit-exact"), flush=True)
                del want_p, want_n, parts, nexts
                # one card: a step of every rank in a CUDA graph (at mp 4
                # the host's launches take longer than the device); cards:
                # the host clock
                if len(cs.ring_cards(ring)) == 1:
                    timer = cs.graph_ms
                else:
                    def timer(fn):
                        return cs.ring_ms(fn, ring, 10)
                times = {name: [] for name in names}
                for order in (names, names[::-1]):
                    for name in order:
                        times[name].append(timer(fns[name]))
                lib_ms = timer(cs.mm_step_library(bufs, ws, ring))
                bound_ms, bound_by = cs.ring_bound(
                    ring, 2 * (T // mp) * K * (N // mp),
                    (T // mp * K + K * N // mp) * bufs[0].element_size(),
                    T // mp * N // mp * bufs[0].element_size(),
                    T // mp * K * bufs[0].element_size(),
                    cs.BF16_FLOPS_PER_S if dtype == torch.bfloat16
                    else cs.F32_FLOPS_PER_S)
                print("%s: %s; library %.4f ms, bound %.4f ms (%s) [%s]" % (
                    tag, ", ".join("%s %s ms" % (n, " / ".join(
                        "%.4f" % x for x in v)) for n, v in times.items()),
                    lib_ms, bound_ms, bound_by, card), flush=True)
                del bufs, ws, fns
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
