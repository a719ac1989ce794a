"""Sequential and LayerList (``paddle_tpu/nn/layer/container.py``)."""
from __future__ import annotations

from .layers import Layer

__all__ = ["Sequential", "LayerList"]


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)):
            layers = layers[0]
        if layers and isinstance(layers[0], tuple):
            for name, layer in layers:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._sub_layers.values())[idx])
        return list(self._sub_layers.values())[idx]

    def __len__(self):
        return len(self._sub_layers)

    def forward(self, x):
        for layer in self._sub_layers.values():
            x = layer(x)
        return x

    def append(self, layer):
        self.add_sublayer(str(len(self._sub_layers)), layer)
        return self


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or ()):
            self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._sub_layers.values())[idx])
        if idx < 0:
            idx += len(self)
        return self._sub_layers[str(idx)]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self
