"""``paddle_tpu_torch.ops``: the op namespace of the eager surface.

The ops the eager models call (:mod:`.manipulation`) and the mount point
of the custom ops that :func:`paddle_tpu_torch.utils.register_op` adds
(it sets the attribute here, on the package's top level and, when
asked, on ``torch.Tensor``, and appends the name to ``__all__``)."""
from .manipulation import concat, flatten, reshape

__all__ = ["flatten", "reshape", "concat"]
