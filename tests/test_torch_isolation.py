"""The port stands alone: no file of ``paddle_tpu_torch/`` and no line of
``chip_smoke.py`` imports JAX or the JAX package, and no kernel wrapper
has an ``except`` that could fall back to the plain version when a
launch fails."""
import ast
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "paddle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")
SMOKE_ALLOWED = {"paddle_tpu_torch", "torch", "numpy"}


def _imported_roots(path: Path):
    """(lineno, top-level module) for every import in ``path``, including
    ``importlib.import_module("...")`` / ``__import__("...")`` with a
    literal name."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module.split(".")[0]
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", "")
            if name in ("import_module", "__import__"):
                yield node.lineno, node.args[0].value.split(".")[0]


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_paddle_tpu_imports(path):
    bad = [(ln, m) for ln, m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, "%s imports %s" % (path.relative_to(ROOT), bad)


def test_chip_smoke_imports_only_the_port_torch_numpy():
    mods = {m for _, m in _imported_roots(ROOT / "chip_smoke.py")}
    third_party = {m for m in mods if m not in sys.stdlib_module_names}
    assert third_party <= SMOKE_ALLOWED, third_party - SMOKE_ALLOWED


# module of incubate/nn/cuda -> the functions that build, bind or launch
WRAPPERS = {
    "paged_attention.py": ("ragged_paged_attention", "_launch", "_bind",
                           "check_kernel_inputs", "paged_attention",
                           "_launch_decode", "_bind_decode",
                           "check_decode_inputs", "_check_common"),
    "norms.py": ("rms_norm", "layer_norm", "_launch", "_bind",
                 "check_kernel_inputs"),
    "flash_attn.py": ("flash_fwd", "flash_bwd_fused", "flash_bwd_split",
                      "flash_bwd", "_launch_bwd", "_bind", "_raise_on",
                      "_FlashAttention"),
    "moe_dispatch.py": ("grouped_matmul", "_bind", "check_kernel_inputs"),
    "ring.py": ("mm_step", "shift", "enable_peer", "_bind", "_raise_on",
                "check_kernel_inputs", "_check_tensor"),
}


def test_kernel_wrapper_has_no_except():
    for fname, names in WRAPPERS.items():
        tree = ast.parse((PORT / "incubate" / "nn" / "cuda" / fname)
                         .read_text())
        defs = {n.name: n for n in tree.body if isinstance(
            n, (ast.FunctionDef, ast.ClassDef))}
        for name in names:
            assert not [n for n in ast.walk(defs[name])
                        if isinstance(n, ast.Try)], (fname, name)
    # the custom-op fixture's wrapper of its CUDA kernel (T1)
    t1 = ROOT / "tests" / "_torch_custom_op" / "twoxplus1.py"
    assert not [n for n in ast.walk(ast.parse(t1.read_text()))
                if isinstance(n, ast.Try)], t1
    build = PORT / "incubate" / "nn" / "cuda" / "_build.py"
    handlers = [n for n in ast.walk(ast.parse(build.read_text()))
                if isinstance(n, ast.ExceptHandler)]
    assert not handlers, "the build must fail loudly, not fall back"
