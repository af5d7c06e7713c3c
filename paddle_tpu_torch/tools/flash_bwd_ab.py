#!/usr/bin/env python3
"""A/B builds of the flash-attention backward (K2, K3) on one card.

Builds variants of ``paddle_tpu_torch/incubate/nn/csrc/flash_attn.cu``,
each a textual change of the source, into ``_archive/flash_bwd_ab/``
(git-ignored), one ``nvcc`` each, all started together; then, in one
process on one card, holds each variant's K2 and K3 against the plain
version (row error in units of the row's RMS) and times them with CUDA
events at the training shape (b 8, s 1024, 16 heads, d 128, bf16,
causal), in turns (the variants in order, then reversed); last, the
device time of each kernel of one K2 and one K3 call of the source as it
is (torch.profiler). Run from the repository root on a machine with a
Hopper card and the CUDA toolkit::

    python3 paddle_tpu_torch/tools/flash_bwd_ab.py [variant ...]

Variants (all by default):
  base        the source as it is
  store       K2's dQ tiles written by TMA stores instead of reduce-adds
              (dq is wrong: what the adds cost)
  no_dq_add   K2's dQ tiles neither added nor stored (dq is wrong)
  k2_stages3  K2 with a 3-stage ring of Q / dO tiles (K3 has 3)
  k3_stages2  K3 with a 2-stage ring (K2 has 2)
"""
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.incubate.nn.cuda import _build  # noqa: E402
from paddle_tpu_torch.incubate.nn.cuda import flash_attn as fa  # noqa: E402

SRC = ROOT / "paddle_tpu_torch/incubate/nn/csrc/flash_attn.cu"
OUT = ROOT / "_archive/flash_bwd_ab"
REDUCE = ("cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.tile."
          "bulk_group")
DQ_ADDS = ("          tma_reduce_add(&tacc, stg, e0, q0, h_, b_);\n"
              "          tma_reduce_add(&tacc, stg + kDqStage / 2, e0 + 32,"
              " q0, h_, b_);\n")
VARIANTS = {
    "base": [],
    "store": [(REDUCE, "cp.async.bulk.tensor.4d.global.shared::cta."
                       "bulk_group")],
    "no_dq_add": [(DQ_ADDS, "")],
    "k2_stages3": [("constexpr int kFusedStages = 2;",
                    "constexpr int kFusedStages = 3;")],
    "k3_stages2": [("constexpr int kBwdStages = 3;",
                    "constexpr int kBwdStages = 2;")],
}


def build(names):
    """One library per variant; returns {name: bound ctypes library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    src, procs = SRC.read_text(), {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError("%s: %r is not in the source" % (name, old))
            text = text.replace(old, new)
        cu = OUT / (name + ".cu")
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(OUT / ("lib%s.so" % name)), str(cu)],
            stdout=open(OUT / (name + ".log"), "w"), stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError("nvcc failed on %s:\n%s" % (
                name, (OUT / (name + ".log")).read_text()[-3000:]))
        lib = ctypes.CDLL(str(OUT / ("lib%s.so" % name)))
        load, fa._lib = _build.load, None
        _build.load = lambda _name, lib=lib: lib     # bind this library
        try:
            libs[name] = fa._bind()
        finally:
            _build.load = load
    return libs


def main(argv):
    names = [n for n in VARIANTS if n in argv] or list(VARIANTS)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = build(names)
    print("%s; built %s in %.1f s" % (card, ", ".join(names),
                                       time.perf_counter() - t0))
    b, sq, _, h, d, _ = cs.FLASH_CASES["train"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(b, sq, h, d, generator=gen,
                               device="cuda").bfloat16() for _ in range(4))
    hm = [x.transpose(1, 2) for x in (q, k, v, do)]
    scale = d ** -0.5
    ref_out, ref_lse = fa.flash_fwd_ref(*hm[:3], True, scale)
    want = [g.transpose(1, 2) for g in fa.flash_bwd_ref(
        *hm[:3], ref_out, ref_lse, hm[3], True, scale)]
    out, lse = ref_out.transpose(1, 2), ref_lse[..., 0]
    fns = {"K2": fa.flash_bwd_fused, "K3": fa.flash_bwd_split}
    for name in names:
        fa._lib = libs[name]
        for kname, fn in fns.items():
            got = fn(q, k, v, out, lse, do, True, scale)
            torch.cuda.synchronize()
            print("%-10s %s row errors dq / dk / dv: %s" % (
                name, kname, " / ".join("%.3g" % cs.row_err(g, w)[1]
                                        for g, w in zip(got, want))))
    for order in (names, names[::-1]):
        for name in order:
            fa._lib = libs[name]
            print("%-10s %s [%s]" % (name, ", ".join(
                "%s %.4f ms" % (kname, cs.cuda_ms(
                    lambda fn=fn: fn(q, k, v, out, lse, do, True, scale),
                    20)) for kname, fn in fns.items()), card), flush=True)
    print("aten flash bwd %.4f ms [%s]"
          % (cs.cuda_ms(cs.aten_flash_bwd(hm, True, scale), 20), card))
    from torch.profiler import ProfilerActivity, profile

    fa._lib = libs[names[0]]
    for kname, fn in fns.items():
        fn(q, k, v, out, lse, do, True, scale)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn(q, k, v, out, lse, do, True, scale)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                print("%s (%s) kernel %.4f ms a call: %s [%s]" % (
                    kname, names[0], e.self_device_time_total / 5e3,
                    re.sub(r"\(anonymous namespace\)::|void ", "",
                           e.key)[:70], card))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
