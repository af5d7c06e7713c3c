#!/usr/bin/env python3
"""Serving end to end for several trees of the repository, on one card,
in turns.

Runs phases 7 and 7b of each tree's own ``chip_smoke.py`` (GPT-3 1.3B
over bf16 pools and Llama-2 7B over int8 pools, seed 0, the ragged and
the ``ragged="off"`` layouts: the trace, weights, launch counts and
first-step checks of a full run, without the kernel phases), each run in
a process of its own from the tree's root, in the order given and then
reversed; prints each run's engine lines and then tokens/s, the median
engine step and the median TTFT by tree and engine. Run from the
repository root on a machine with a CUDA card::

    python3 paddle_tpu_torch/tools/serve_ab.py ROOT [ROOT ...]

each ROOT a checkout of the repository, for instance the parent commit
unpacked by ``git archive <commit> | tar -x -C _archive/parent``.
"""
import re
import subprocess
import sys
import time
from pathlib import Path

# phases 7 and 7b through the tree's own chip_smoke; the launch counts a
# pass are filtered to the counters that tree has
RUN = r'''
import subprocess, torch
import chip_smoke as cs
from paddle_tpu_torch.incubate.nn.cuda import _build
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True, check=True).stdout.strip().splitlines()[0]
torch.backends.cuda.matmul.allow_tf32 = False
_build.build_all(("ragged_paged_attention", "norms", "paged_attention"))
gpt, gm, go = cs.engine_phase(card)
torch.cuda.empty_cache()
llama, lm, lo = cs.llama_engine_phase(card, seeds=(0,))
torch.cuda.empty_cache()
keys = cs.serving_counts()
Lg, Ll = gm.config.num_layers, lm.config.num_layers
for model, what, outs, per, tol, rtol, kw in (
        (gm, "gpt3_1p3B off", go,
         {"K6": Lg, "K7 layer_norm": 2 * Lg + 1,
          "K7 layer_norm fused": 2 * Lg},
         cs.LOGITS_TOL, cs.SERVE_HIDDEN_RTOL, {}),
        (lm, "llama2_7B int8 off", lo,
         {"K6-q8": Ll, "K7 rms_norm": 2 * Ll + 1,
          "K7 rms_norm fused": 2 * Ll},
         cs.LLAMA_LOGITS_TOL, cs.LLAMA_HIDDEN_RTOL, {"kv_quant": "int8"})):
    want = {k: per.get(k, 0) for k in keys}
    cs.off_engine_phase(card, model, what, outs, want, tol, rtol, **kw)
    torch.cuda.empty_cache()
'''
LINE = re.compile(r"^engine (.+?): \d+ requests .* = ([\d.]+) tok/s, median "
                  r"engine step ([\d.]+) ms, TTFT median ([\d.]+) ms")


def main(argv):
    roots = [Path(a).resolve() for a in argv]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    table = {}
    for root in roots + roots[::-1]:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=root,
                              capture_output=True, text=True)
        print("=== %s (%.1f s, exit %d)" % (root, time.perf_counter() - t0,
                                           proc.returncode), flush=True)
        for line in proc.stdout.splitlines():
            if line.startswith(("engine", "NVIDIA")):
                print(line)
            m = LINE.match(line)
            if m:
                table.setdefault((m.group(1), root), []).append(
                    tuple(float(x) for x in m.group(2, 3, 4)))
        if proc.returncode:
            print(proc.stderr[-4000:])
            return proc.returncode
    for (what, root), runs in sorted(table.items()):
        print("%-22s %-40s tok/s %s, median step ms %s, TTFT median ms %s"
              % (what, root.name, *(" / ".join("%.1f" % r[i] for r in runs)
                                    for i in range(3))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
