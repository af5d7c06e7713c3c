"""``Sequential`` and ``LayerList`` (port of
``paddle_tpu/nn/layer/container.py``): sublayers named ``"0"``, ``"1"``,
... in order (``Sequential`` also by the names of ``(name, layer)``
pairs); a ``Sequential`` calls them one after another, a ``LayerList``
only holds them."""
from __future__ import annotations

from .layers import Layer

__all__ = ["Sequential", "LayerList"]


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


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for layer in sublayers or ():
            self.append(layer)

    def __getitem__(self, idx):
        items = list(self._modules.values())
        if isinstance(idx, slice):
            return LayerList(items[idx])
        return items[idx]

    def __setitem__(self, idx, layer):
        if idx < 0:
            idx += len(self)
        self.add_sublayer(str(idx), layer)

    def __len__(self) -> int:
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self
