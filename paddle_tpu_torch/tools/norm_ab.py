#!/usr/bin/env python3
"""A/B builds of the row-norm kernel (K7) on one card.

Builds variants of ``paddle_tpu_torch/incubate/nn/csrc/norms.cu``, each a
textual change of the source, into ``_archive/norm_ab/`` (git-ignored),
one ``nvcc`` each, all started together, and prints ptxas's registers and
spills of each variant's kernels; then, in one process on one card, holds
each variant against the plain versions (element by element, as
``chip_smoke.py``'s phase 4; a fused case's sum bitwise PyTorch's adds)
and times it per call in a CUDA graph, in turns (the variants in order,
then reversed): the serving steps' rows (1, 12 and 136 rows of Llama-2
7B's RMSNorm at d 4096 and GPT-3 1.3B's LayerNorm at d 2048, and their
fused residual updates), 1001 and 8192 rows in bf16 and f32 beside
``F.rms_norm`` / ``F.layer_norm``, RMSNorm at 264-4096 rows (the
crossover of the two forms), and a fused update after the GEMM that
produces its input (the case that programmatic dependent launch could
shorten). Then splits a wrapper call's host time by part. Run from the
repository root on a machine with a Hopper card and the CUDA toolkit::

    python3 paddle_tpu_torch/tools/norm_ab.py [variant ...] [--parent FILE]

``--parent FILE`` adds an earlier source of the kernel, written out by
``git show <commit>:paddle_tpu_torch/incubate/nn/csrc/norms.cu``: the
first port's (``norm_launch(x, w, b, out, n, d, eps, kind, is_bf16,
stream)``, no fused form; its fused cases take PyTorch's two adds and
then its kernel, as the serving steps did).

Variants (all by default):
  base          the source as it is
  one_exchange  LayerNorm's statistics in one exchange: each thread's
                (count, mean, centred sum of squares), merged across
                lanes and warps by Chan's formula (the source: two
                exchanges, the mean, then the centred squares)
  rows_vecs2    the block-a-row form at two vectors of 8 values a thread
                (256 threads at d 4096; the source: one, 512 threads)
  vecs1         the persistent form at one vector a thread (the source:
                two)
  rows_only     a block a row at every n (no persistent form)
  no_prefetch   the persistent form does not load the next row early
  no_hold       the parameters are read again for every row
  hold_all      bf16 holds w and b across rows in every kind (the
                source: RMSNorm without a bias only)
  f32_lean      f32 as wide rows are: no prefetch, w and b read after
                the exchange (fewer registers, more blocks an SM)
  f32_rows      f32_lean, and f32 always a block a row at two vectors a
                thread (the first port's shape)
  cap64         at most 64 registers a thread at <= 512 threads (two
                blocks of 512 an SM; the source lets ptxas take 128)
  f32_cap64     the same for f32 only
  f32_rows_cap64  f32_rows at 64 registers
  pdl           programmatic dependent launch: the launch may start while
                the previous kernel runs; the kernel waits
                (griddepcontrol.wait) before it reads y
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
from paddle_tpu_torch.incubate.nn.cuda import norms as kn  # noqa: E402
from paddle_tpu_torch.tools import _ab  # noqa: E402

SRC = ROOT / "paddle_tpu_torch/incubate/nn/csrc/norms.cu"
OUT = ROOT / "_archive/norm_ab"
# one_exchange: Chan's merge, lane pairs and then warps
CHAN = """\
// Chan's merge of (c, m, M) with (cb, mb, Mb): counts, means and centred
// sums of squares of two sets of values, into those of their union.
__device__ __forceinline__ void chan(float& c, float& m, float& M, float cb,
                                     float mb, float Mb) {
  const float t = c + cb;
  if (t > 0.f) {
    const float delta = mb - m;
    const float f = cb / t;
    m += delta * f;
    M += Mb + delta * delta * c * f;
    c = t;
  }
}

// Both lanes of a pair merge (lower lane's, upper lane's), so that every
// lane ends with bitwise the same triple (the merge is not symmetric).
__device__ __forceinline__ void warp_chan(float& c, float& m, float& M) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float cb = __shfl_xor_sync(0xffffffffu, c, o);
    float mb = __shfl_xor_sync(0xffffffffu, m, o);
    float Mb = __shfl_xor_sync(0xffffffffu, M, o);
    if (threadIdx.x & o) {
      float t = c; c = cb; cb = t;
      t = m; m = mb; mb = t;
      t = M; M = Mb; Mb = t;
    }
    chan(c, m, M, cb, mb, Mb);
  }
}

// (mean, centred sum of squares) of the block's values, in every thread,
// from each thread's (count, mean, M); one __syncthreads. `slot` holds
// 3 x 32 floats, alternated as block_sum's.
__device__ __forceinline__ void block_chan(float& c, float& m, float& M,
                                           float* slot) {
  warp_chan(c, m, M);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    slot[warp] = c;
    slot[32 + warp] = m;
    slot[64 + warp] = M;
  }
  __syncthreads();
  const bool live = lane < (int)(blockDim.x >> 5);
  c = live ? slot[lane] : 0.f;
  m = live ? slot[32 + lane] : 0.f;
  M = live ? slot[64 + lane] : 0.f;
  warp_chan(c, m, M);
}

"""
CHAN_BRANCH = """\
      // this thread's values centred about their own mean, merged
      float m = cnt > 0.f ? s1 / cnt : 0.f, M = 0.f;
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        if (threadIdx.x + it * blockDim.x < n_vec) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float c = v[it][e] - m;
            M += c * c;
          }
        }
      }
      block_chan(cnt, m, M, red[phase]);
      phase ^= 1;
      mu = m;
      var = M * inv_d;
"""
S1 = "          s1 += (kCentre ? v[it][e] : v[it][e] * v[it][e]);\n"
TWO = ("    } else {\n"
       "      // two exchanges: the mean, then the centred squares\n")
PREFETCH = "constexpr bool kPrefetch = kIters <= 2;"
PREFETCH_BF16 = "constexpr bool kPrefetch = kIters <= 2 && sizeof(T) == 2;"
EARLY = "constexpr bool kEarly = kIters <= 2;"
EARLY_BF16 = "constexpr bool kEarly = kIters <= 2 && sizeof(T) == 2;"
BOUNDS = "__launch_bounds__(kIters == 4 ? 1024 : kNarrowThreads"
F32_CAP = ", kIters <= 2 && sizeof(T) == 4 ? 2 : 1"
HOLD = "constexpr bool kHold = kEarly && sizeof(T) == 2 && !kNormBias;"
LAUNCH = ("  row_norm_kernel<T, kIters, kKind, kRes><<<p.grid, p.threads, 0, "
          "s>>>(a);\n")
VARIANTS = {
    "base": [],
    "one_exchange": [("struct Args {", CHAN + "struct Args {"),
                     ("    float s1 = 0.f;",
                      "    float s1 = 0.f, cnt = 0.f;"),
                     (S1, S1 + "        cnt += (float)kVec;\n"),
                     ("__shared__ float red[2][32];",
                      "__shared__ float red[2][3 * 32];"),
                     (TWO, "    } else if constexpr (true) {\n" + CHAN_BRANCH
                      + TWO)],
    "rows_vecs2": [("constexpr int kVecsRows = 1;",
                    "constexpr int kVecsRows = 2;")],
    "vecs1": [("constexpr int kVecsPersistent = 2;",
               "constexpr int kVecsPersistent = 1;")],
    "rows_only": [("constexpr int kCrossWaves = 1;",
                   "constexpr int kCrossWaves = 1 << 20;")],
    "no_prefetch": [(PREFETCH, "constexpr bool kPrefetch = false;")],
    "no_hold": [(HOLD, "constexpr bool kHold = false;")],
    "hold_all": [(HOLD, "constexpr bool kHold = kEarly && sizeof(T) == 2;")],
    "f32_rows": [(PREFETCH, PREFETCH_BF16), (EARLY, EARLY_BF16),
                 ("  if ((long long)n > wave * kCrossWaves) {",
                  "  if (is_bf16 && (long long)n > wave * kCrossWaves) {"),
                 ("    const int it = iters_for(d, kVecsRows);",
                  "    const int it = iters_for(d, is_bf16 ? kVecsRows "
                  ": 2);")],
    "cap64": [(BOUNDS, BOUNDS + ", kIters == 4 ? 1 : 2")],
    "f32_cap64": [(BOUNDS, BOUNDS + F32_CAP)],
    "f32_rows_cap64": [
        (BOUNDS, BOUNDS + F32_CAP),
        (PREFETCH, PREFETCH_BF16), (EARLY, EARLY_BF16),
        ("  if ((long long)n > wave * kCrossWaves) {",
         "  if (is_bf16 && (long long)n > wave * kCrossWaves) {"),
        ("    const int it = iters_for(d, kVecsRows);",
         "    const int it = iters_for(d, is_bf16 ? kVecsRows : 2);")],
    "f32_lean": [(PREFETCH, PREFETCH_BF16), (EARLY, EARLY_BF16)],
    "pdl": [("  int row = blockIdx.x;\n  load_row(row, px, pr);",
             "  int row = blockIdx.x;\n"
             "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n"
             "  load_row(row, px, pr);"),
            (LAUNCH + "  return cudaGetLastError();",
             "  cudaLaunchConfig_t cfg = {};\n"
             "  cfg.gridDim = dim3(p.grid);\n"
             "  cfg.blockDim = dim3(p.threads);\n"
             "  cfg.stream = s;\n"
             "  cudaLaunchAttribute attr[1];\n"
             "  attr[0].id = "
             "cudaLaunchAttributeProgrammaticStreamSerialization;\n"
             "  attr[0].val.programmaticStreamSerializationAllowed = 1;\n"
             "  cfg.attrs = attr;\n"
             "  cfg.numAttrs = 1;\n"
             "  return cudaLaunchKernelEx(&cfg, row_norm_kernel<T, kIters, "
             "kKind, kRes>, a);")],
}
BF16, F32 = torch.bfloat16, torch.float32
# name -> (kind, adds, n, d, dtype); adds: None, "res" or "bias+res"
CASES = {
    "rms 136x4096": ("rms", None, 136, 4096, BF16),
    "ln 136x2048": ("ln", None, 136, 2048, BF16),
    "rms 12x4096": ("rms", None, 12, 4096, BF16),
    "ln 12x2048": ("ln", None, 12, 2048, BF16),
    "rms 1x4096": ("rms", None, 1, 4096, BF16),
    "rms+res 136x4096": ("rms", "res", 136, 4096, BF16),
    "ln+bias+res 136x2048": ("ln", "bias+res", 136, 2048, BF16),
    "rms+res 12x4096": ("rms", "res", 12, 4096, BF16),
    "ln+bias+res 12x2048": ("ln", "bias+res", 12, 2048, BF16),
    "ln 1001x2048": ("ln", None, 1001, 2048, BF16),
    "rms 264x4096": ("rms", None, 264, 4096, BF16),
    "rms 528x4096": ("rms", None, 528, 4096, BF16),
    "rms 1056x4096": ("rms", None, 1056, 4096, BF16),
    "rms 2112x4096": ("rms", None, 2112, 4096, BF16),
    "rms 4096x4096": ("rms", None, 4096, 4096, BF16),
    "rms 8192x4096": ("rms", None, 8192, 4096, BF16),
    "ln 8192x4096": ("ln", None, 8192, 4096, BF16),
    "rms f32 8192x4096": ("rms", None, 8192, 4096, F32),
    "ln f32 8192x4096": ("ln", None, 8192, 4096, F32),
    "rms f32 8192x2048": ("rms", None, 8192, 2048, F32),
    "rms f32 136x4096": ("rms", None, 136, 4096, F32),
    "gemm+rms+res 136x4096": ("rms", "res", 136, 4096, BF16),
}


def bind(lib):
    """The wrapper module bound to ``lib`` (this source's C interface)."""
    load, kn._lib = _build.load, None
    _build.load = lambda _name: lib
    try:
        return kn._bind()
    finally:
        _build.load = load


def inputs(kind, adds, n, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape, scale=1.0, shift=0.0):
        return (scale * torch.randn(*shape, generator=g, device="cuda")
                + shift).to(dtype)
    return dict(x=draw(n, d, scale=1.5, shift=0.3), w=draw(d, scale=0.1,
                                                          shift=1.0),
                b=draw(d, scale=0.1) if kind == "ln" else None,
                bias=draw(d, scale=0.1) if adds == "bias+res" else None,
                res=draw(n, d, scale=1.5) if adds else None,
                a=draw(n, d, scale=d ** -0.5), gemm=draw(d, d, scale=1.0))


def caller(name, lib, kind, adds, t, eps):
    """``fn() -> out`` or ``(out, sum)`` of one variant on the inputs
    ``t``: the wrapper bound to its library, or for ``parent`` the first
    port's entry point after PyTorch's adds."""
    if name != "parent":
        bound = bind(lib)
        fn = kn.layer_norm if kind == "ln" else kn.rms_norm
        kw = {} if adds is None else dict(bias=t["bias"], residual=t["res"])

        def run(x):
            kn._lib = bound
            return fn(x, t["w"], t["b"], eps, **kw)
        return run
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.norm_launch.argtypes = [p] * 4 + [i, i, ctypes.c_float, i, i, p]

    def run(x):
        s = None
        if adds is not None:
            s = x + t["bias"] if t["bias"] is not None else x
            s = s + t["res"]
            x = s
        out = torch.empty_like(x)
        n, d = x.shape
        rc = lib.norm_launch(x.data_ptr(), t["w"].data_ptr(),
                             None if t["b"] is None else t["b"].data_ptr(),
                             out.data_ptr(), n, d, eps,
                             2 if kind == "ln" else 0,
                             int(x.dtype == BF16),
                             torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, "the parent's launch failed (%d)" % rc)
        return out if s is None else (out, s)
    return run


def host_split(card, iters=2000):
    """A call's host time by part, back to back (host clock, then one
    synchronize): the wrapper, the functional entry, each part of the
    wrapper alone, and the library call, at 136 x 4096 bf16."""
    from paddle_tpu_torch.incubate.nn.functional import fused_ops

    t = inputs("rms", "res", 136, 4096, BF16, 7)
    x, w, res = t["x"], t["w"], t["res"]
    lib = kn._bind()
    out, s = torch.empty_like(x), torch.empty_like(x)
    dev = x.get_device()
    args = (x.data_ptr(), res.data_ptr(), None, w.data_ptr(), None,
            out.data_ptr(), s.data_ptr(), 136, 4096, 1e-5, 0, 1)
    F = torch.nn.functional
    parts = {
        "functional fused_rms_norm(residual=)": lambda: fused_ops.
        fused_rms_norm(x, w, None, 1e-5, residual=res),
        "wrapper rms_norm(residual=)": lambda: kn.rms_norm(
            x, w, None, 1e-5, residual=res),
        "wrapper rms_norm": lambda: kn.rms_norm(x, w, None, 1e-5),
        "checks": lambda: kn.check_kernel_inputs(x, w, None, None, res),
        "two torch.empty_like": lambda: (torch.empty_like(x),
                                         torch.empty_like(x)),
        "device and stream": lambda: (
            torch._C._cuda_getDevice() == dev,
            torch._C._cuda_getCurrentRawStream(dev)),
        "ctypes call (launches)": lambda: lib.norm_launch(
            *args, torch._C._cuda_getCurrentRawStream(dev)),
        "library F.rms_norm": lambda: F.rms_norm(x, (4096,), w, 1e-5),
        "library x + res": lambda: x + res,
    }
    for name, fn in parts.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = (time.perf_counter() - t0) / iters * 1e3
        torch.cuda.synchronize()
        print("host %-40s %.4f ms a call [%s]" % (name, host, card),
              flush=True)


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
    libs = _ab.build(sources, OUT, kernel="row_norm_kernel")
    print("%s; built %s in %.1f s" % (card, ", ".join(names),
                                       time.perf_counter() - t0), flush=True)
    F = torch.nn.functional
    times = {name: {c: [] for c in CASES} for name in names}
    lib_ms = {}
    for case, (kind, adds, n, d, dtype) in CASES.items():
        t = inputs(kind, adds, n, d, dtype, seed=n + d)
        eps = 1e-5
        gemm = case.startswith("gemm")
        ref = kn.layer_norm_ref if kind == "ln" else kn.rms_norm_ref
        kw = {} if adds is None else dict(bias=t["bias"], residual=t["res"])
        x = t["a"] @ t["gemm"] if gemm else t["x"]
        want = ref(x, t["w"], t["b"], eps, **kw)
        fns = {name: caller(name, libs[name], kind, adds, t, eps)
               for name in names}
        for name in names:
            got = fns[name](x)
            torch.cuda.synchronize()
            if adds is not None:
                cs.check(torch.equal(got[1], want[1]), "%s %s: the sum is "
                         "not PyTorch's adds" % (name, case))
                got = got[0]
            ratio = cs.norm_ratio(got, want[0] if adds else want,
                                  cs.NORM_REL[dtype])
            cs.check(ratio <= 1.0, "%s %s: error %.3g of its allowance"
                     % (name, case, ratio))
        for order in (names, names[::-1]):
            for name in order:
                fn = fns[name]
                if gemm:
                    run = (lambda fn=fn: fn(t["a"] @ t["gemm"]))
                else:
                    run = (lambda fn=fn: fn(t["x"]))
                times[name][case].append(cs.graph_ms(run))
        if adds is None and not (kind == "rms" and t["b"] is not None):
            lib_ms[case] = cs.graph_ms(
                (lambda: F.layer_norm(x, (d,), t["w"], t["b"], eps))
                if kind == "ln" else
                (lambda: F.rms_norm(x, (d,), t["w"], eps)))
        elif gemm:
            lib_ms[case] = cs.graph_ms(lambda: t["a"] @ t["gemm"])
        kn._lib = None               # the plan of this source as it is
        form = kn.plan(n, d, kind, dtype, residual=adds is not None)
        print("%-22s %s, %d blocks of %d threads x %d vectors; %s [%s]" % (
            case, form[0], form[1], form[2], form[3], ", ".join(
                "%s %s" % (name, " / ".join("%.4f" % v for v in
                                            times[name][case]))
                for name in names), card), flush=True)
        del t, x, want, fns
    print("library (F.rms_norm / F.layer_norm; the GEMM alone for gemm+): "
          "%s [%s]" % (", ".join("%s %.4f" % kv for kv in lib_ms.items()),
                       card), flush=True)
    kn._lib = None
    host_split(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
