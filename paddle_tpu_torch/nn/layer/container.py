"""Layer containers: the port of paddle_tpu/nn/layer/container.py.

``Sequential``, ``LayerList`` and ``LayerDict`` register their layers
under the reference's names ("0", "1", ... or the given keys), and
``ParameterList`` its parameters under "0", "1", ..., so state-dict keys
equal the reference's."""
from __future__ import annotations

from collections import OrderedDict

import torch

from .layers import Layer

__all__ = ["LayerDict", "LayerList", "ParameterList", "Sequential"]


class Sequential(Layer):
    """Layers called in order: given as arguments ("0", "1", ...), as
    (name, layer) pairs, or as one ``OrderedDict``."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            layers = tuple(layers[0].items())
        for i, layer in enumerate(layers):
            name, layer = layer if isinstance(layer, tuple) else (str(i),
                                                                  layer)
            self.add_module(name, layer)

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            return Sequential(*layers[idx])
        return layers[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, input):
        for layer in self._modules.values():
            input = layer(input)
        return input


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for layer in sublayers or ():
            self.append(layer)

    def _abs(self, idx):
        n = len(self._modules)
        if not -n <= idx < n:
            raise IndexError(f"index {idx} out of range for {n} layers")
        return idx % n

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            return LayerList(layers[idx])
        return layers[self._abs(idx)]

    def __setitem__(self, idx, layer):
        self._modules[str(self._abs(idx))] = layer

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_module(str(len(self._modules)), layer)
        return self

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        self.extend(layers)


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for p in parameters or ():
            self.append(p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        if not isinstance(parameter, torch.nn.Parameter):
            parameter = torch.nn.Parameter(parameter)
        self.register_parameter(str(len(self._parameters)), parameter)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_module(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        items = (sublayers.items() if isinstance(sublayers, (dict,
                                                             LayerDict))
                 else sublayers)
        for key, layer in items:
            self.add_module(key, layer)
        return self

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        return self._modules.pop(key)
