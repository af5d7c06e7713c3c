"""``Sequential`` (port of ``paddle_tpu/nn/layer/container.py``):
sublayers named ``"0"``, ``"1"``, ... in order, or by the names of
``(name, layer)`` pairs, called one after another."""
from __future__ import annotations

from .layers import Layer

__all__ = ["Sequential"]


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) > 0 and isinstance(layers[0], (list, tuple)):
            for name, layer in layers:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        items = list(self._modules.values())
        if isinstance(idx, slice):
            return Sequential(*items[idx])
        return items[idx]

    def __len__(self) -> int:
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x
