"""What the A/B tools share: the card's name and power limit, variants
of a kernel's source as textual changes of it, and one ``nvcc`` for each
variant, all started together, into a git-ignored ``_archive/`` folder.
"""
import ctypes
import subprocess
from pathlib import Path

from paddle_tpu_torch.incubate.nn.cuda import _build


def card():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def patch(src, variants, names):
    """{name: source text} for each of ``names``: ``src`` with every
    ``(old, new)`` of ``variants[name]`` replaced, in order. Raises when
    an ``old`` is not in the text, so that a variant never silently
    builds the source as it is."""
    sources = {}
    for name in names:
        text = src
        for old, new in variants[name]:
            if old not in text:
                raise RuntimeError("%s: %r is not in the source" % (name, old))
            text = text.replace(old, new)
        sources[name] = text
    return sources


def build(sources, out, kernel=None):
    """One library per variant ({name: source text}) into ``out``;
    returns {name: loaded library}. With ``kernel``, prints ptxas's
    registers, spills and shared memory of each function whose name holds
    that text."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = out / (name + ".cu")
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(out / ("lib%s.so" % name)), str(cu)],
            stdout=open(out / (name + ".log"), "w"), stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError("nvcc failed on %s:\n%s"
                               % (name, (out / (name + ".log")).read_text()
                                  [-3000:]))
        libs[name] = ctypes.CDLL(str(out / ("lib%s.so" % name)))
        log = (out / (name + ".log")).read_text().splitlines()
        for i, line in enumerate(log if kernel else ()):
            if "Function properties" in line and kernel in line:
                print("%-11s ptxas %s: %s" % (
                    name, line.split(kernel)[1][:24], " ".join(
                        x.strip() for x in log[i + 1:i + 3])))
    return libs
