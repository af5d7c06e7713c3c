"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use by ``nvcc`` for Hopper (``sm_90a``) into a shared library that
:mod:`ctypes` loads; nothing includes PyTorch's headers, so a build takes
seconds. Libraries go to ``paddle_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that carries a hash of the source, so an
edited source is always rebuilt and a stale library is never loaded.
``nvcc``'s resource report (``-Xptxas -v``: registers, shared memory,
spills per kernel) is kept beside each library as ``<lib>.log``.

A kernel source outside ``csrc/`` (a custom op's kernel kept beside its
op, e.g. ``tests/_torch_custom_op/twoxplus1.cu``) is named by its path
(a ``Path``, or a string ending in ``.cu``) wherever a name is taken: it
is built the same way, its library named after the file's stem.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "build", "build_all", "load", "nvcc_path",
           "ptxas_report"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "_build"
SOURCES = ("ragged_paged_attention", "flash_attn", "norms",
           "paged_attention", "moe_dispatch", "ring")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else the toolkit's default install
    prefix, else ``nvcc`` on ``PATH``. Raises when there is none."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that builds the port's kernels")
    return found


def _source(name) -> Path:
    """``csrc/<name>.cu``, or the named ``.cu`` file itself."""
    if isinstance(name, Path) or str(name).endswith(".cu"):
        return Path(name).resolve()
    return CSRC / (name + ".cu")


def _lib_path(name) -> Path:
    src = _source(name)
    name = src.stem
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / ("lib%s-%s.so" % (name, digest))


def _start(name: str):
    """Start one ``nvcc`` for ``name`` unless its library is built;
    returns ``(process, tmp_path, lib_path)`` or None."""
    lib = _lib_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(lib.name + ".%d.tmp" % os.getpid())
    log = open(str(lib) + ".log", "w")
    try:
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))],
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    return proc, tmp, lib


def _finish(name: str, started) -> None:
    proc, tmp, lib = started
    rc = proc.wait()
    if rc != 0:
        raise RuntimeError("nvcc failed (%d) on %s:\n%s"
                           % (rc, _source(name).name, ptxas_report(name)))
    os.replace(tmp, lib)            # atomic: a reader sees all or nothing


def build(name) -> Path:
    """Compile ``csrc/<name>.cu`` (or the named ``.cu`` file) if its library is missing; returns the
    library's path."""
    started = _start(name)
    if started is not None:
        _finish(name, started)
    return _lib_path(name)


def build_all(names: Iterable = SOURCES) -> float:
    """Build every kernel source, one ``nvcc`` per source, all started
    together; returns the wall seconds it took."""
    t0 = time.perf_counter()
    names = list(names)
    started = {n: _start(n) for n in names}
    for n in names:
        if started[n] is not None:
            _finish(n, started[n])
    return time.perf_counter() - t0


def ptxas_report(name) -> str:
    """What ``nvcc`` printed while building ``name`` (empty when the
    library came from an earlier build without its log)."""
    log = Path(str(_lib_path(name)) + ".log")
    return log.read_text() if log.exists() else ""


def load(name) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or of the named ``.cu``
    file), built on first use."""
    key = str(_source(name))
    with _lock:
        lib: Optional[ctypes.CDLL] = _libs.get(key)
        if lib is None:
            lib = _libs[key] = ctypes.CDLL(str(build(name)))
        return lib
