"""Sequential, LayerList, ParameterList and LayerDict
(``paddle_tpu/nn/layer/container.py``)."""
from __future__ import annotations

from .layers import Layer

__all__ = ["Sequential", "LayerList", "ParameterList", "LayerDict"]


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


class ParameterList(Layer):
    """Parameters held under "0", "1", ... (in ``parameters()`` and the
    state dict)."""

    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or ()):
            self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        return self._parameters[str(idx)]

    def __setitem__(self, idx, p):
        self._parameters[str(idx)] = p

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, p):
        self.add_parameter(str(len(self)), p)
        return self


class LayerDict(Layer):
    """Sublayers under string keys, in insertion order."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._sub_layers[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._sub_layers[key]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers)

    def __contains__(self, key):
        return key in self._sub_layers

    def clear(self):
        self._sub_layers.clear()

    def pop(self, key):
        return self._sub_layers.pop(key)

    def keys(self):
        return self._sub_layers.keys()

    def items(self):
        return self._sub_layers.items()

    def values(self):
        return self._sub_layers.values()

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) \
            else sublayers
        for k, v in items:
            self.add_sublayer(k, v)
        return self
