"""``paddle.utils`` of the port: the custom-op registry, the
``cpp_extension`` guidance and ``run_check`` (port of
``paddle_tpu/utils/__init__.py``)."""
from __future__ import annotations

from . import cpp_extension
from .custom_op import deregister_op, register_op, registered_ops

__all__ = ["register_op", "deregister_op", "registered_ops", "cpp_extension",
           "run_check"]


def run_check() -> None:
    """Sanity-check the install on the default place: a small product
    must sum to 8."""
    import numpy as np

    from ..core.tensor import to_tensor

    x = to_tensor(np.ones((2, 2), np.float32))
    y = (x @ x).sum()
    if float(y) != 8.0:
        raise RuntimeError("run_check: (ones(2, 2) @ ones(2, 2)).sum() is "
                           "%r, not 8" % float(y))
    print(f"paddle_tpu_torch is installed successfully! device: {x.device}")
