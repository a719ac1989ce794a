"""nn.Layer — module base class.

Counterpart of ``paddle_tpu/nn/layer/layers.py``: the same registration
semantics (``__setattr__`` routes Parameters, sub-Layers and
buffers), the same state_dict names ("sub.sub.param", persistable
buffers after the parameters) and parameter names ("<scope>_<k>.w_<i>"),
the same hooks. Parameters are created on the current device
(``paddle_tpu_torch.device``), the card by default.
:meth:`Layer.set_state_dict` takes Tensors or numpy arrays by those
names, buffers included, which is how weights carry across from the JAX
package.
"""
from __future__ import annotations

import collections

import torch

from ...device import current_device
from ...framework import dtype as dtypes
from ...framework.core import Parameter, Tensor, _as_torch
from ...framework.param_attr import ParamAttr
from .. import initializer as I

__all__ = ["Layer"]


class HookRemoveHelper:
    def __init__(self, hooks, idx):
        self._hooks = hooks
        self._idx = idx

    def remove(self):
        self._hooks.pop(self._idx, None)


# unique names, as paddle_tpu gives them: every Layer instance gets
# "<scope>_<k>" and its parameters "<scope>_<k>.w_<i>" / ".b_<i>"
_NAME_COUNTS: dict = {}


def _unique_full_name(scope: str) -> str:
    i = _NAME_COUNTS.get(scope, 0)
    _NAME_COUNTS[scope] = i + 1
    return f"{scope}_{i}"


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self.training = True
        self._dtype = dtypes.convert_dtype(dtype)
        self._parameters = collections.OrderedDict()
        self._sub_layers = collections.OrderedDict()
        self._buffers = collections.OrderedDict()
        self._non_persistable_buffer_names = set()
        self._forward_pre_hooks = collections.OrderedDict()
        self._forward_post_hooks = collections.OrderedDict()
        self._hook_id = 0
        self._name_scope = name_scope or self.__class__.__name__.lower()
        self._full_name = _unique_full_name(self._name_scope)
        self._param_name_counts = {"w": 0, "b": 0}

    # -- parameter creation ------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None) -> Parameter:
        dtype = (dtypes.convert_dtype(dtype) or self._dtype
                 or dtypes.default_float_dtype())
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if attr.initializer is not None:
            init = attr.initializer
        elif default_initializer is not None:
            init = default_initializer
        else:
            init = I.Constant(0.0) if is_bias else I.XavierUniform()
        shape = tuple(int(s) for s in shape)
        name = attr.name
        if name is None:
            kind = "b" if is_bias else "w"
            idx = self._param_name_counts.get(kind, 0)
            self._param_name_counts[kind] = idx + 1
            name = f"{self._full_name}.{kind}_{idx}"
        p = Parameter(init(shape, dtype, current_device()), name=name,
                      trainable=attr.trainable)
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name, parameter):
        """Register ``parameter`` (a Parameter, or None) under ``name``."""
        self._parameters[str(name)] = parameter
        return parameter

    def register_buffer(self, name, tensor, persistable=True):
        """A Tensor the layer owns that is not trained (batch norm's
        running statistics); in ``state_dict`` unless not
        ``persistable``."""
        if tensor is not None and not isinstance(tensor, Tensor):
            tensor = Tensor(tensor)
        self._buffers[name] = tensor
        if persistable:
            self._non_persistable_buffer_names.discard(name)
        else:
            self._non_persistable_buffer_names.add(name)
        return tensor

    # -- attribute routing --------------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, (Parameter, Layer)):
            if params is None:
                raise RuntimeError("call Layer.__init__() before assigning "
                                   "parameters or sublayers")
            own, other = ((params, layers) if isinstance(value, Parameter)
                          else (layers, params))
            own[name] = value
            other.pop(name, None)
            buffers.pop(name, None)
            self.__dict__.pop(name, None)
            return
        if buffers is not None and name in buffers:
            buffers[name] = value
            return
        if params is not None and name in params and value is None:
            params.pop(name)
        if layers is not None and name in layers:
            layers.pop(name)
        object.__setattr__(self, name, value)

    def __getattr__(self, name):
        # only called when normal lookup fails
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(f"'{type(self).__name__}' object has no "
                             f"attribute '{name}'")

    def __delattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    # -- traversal ----------------------------------------------------------
    def add_sublayer(self, name, sublayer):
        self._sub_layers[str(name)] = sublayer
        return sublayer

    def named_children(self):
        seen = set()
        for name, layer in self._sub_layers.items():
            if layer is not None and id(layer) not in seen:
                seen.add(id(layer))
                yield name, layer

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        if layers_set is None:
            layers_set = set()
        if include_self and id(self) not in layers_set:
            layers_set.add(id(self))
            yield prefix, self
        for name, layer in self.named_children():
            if id(layer) in layers_set:
                continue
            sub_prefix = prefix + ("." if prefix else "") + name
            yield from layer.named_sublayers(prefix=sub_prefix,
                                             include_self=True,
                                             layers_set=layers_set)

    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True):
        seen = set()
        layers = (self.named_sublayers(prefix=prefix, include_self=True)
                  if include_sublayers else [(prefix, self)])
        for lp, layer in layers:
            for name, p in layer._parameters.items():
                if p is None or id(p) in seen:
                    continue
                seen.add(id(p))
                yield lp + ("." if lp else "") + name, p

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        for name, b, _ in self._named_buffers(prefix, include_sublayers):
            yield name, b

    def _named_buffers(self, prefix="", include_sublayers=True):
        """(structured name, buffer, persistable) of every buffer."""
        seen = set()
        layers = (self.named_sublayers(prefix=prefix, include_self=True)
                  if include_sublayers else [(prefix, self)])
        for lp, layer in layers:
            for name, b in layer._buffers.items():
                if b is None or id(b) in seen:
                    continue
                seen.add(id(b))
                yield (lp + ("." if lp else "") + name, b,
                       name not in layer._non_persistable_buffer_names)

    # -- modes --------------------------------------------------------------
    def train(self):
        self.training = True
        for layer in self.sublayers():
            layer.training = True
        return self

    def eval(self):
        self.training = False
        for layer in self.sublayers():
            layer.training = False
        return self

    def to(self, device=None, dtype=None, blocking=None):
        """Move every parameter and buffer to ``device`` and/or cast the
        floating ones to ``dtype`` (parameters stay leaves)."""
        d = dtypes.convert_dtype(dtype)
        dev = None if device is None else torch.device(
            "cuda" if str(device).startswith("gpu") else device)

        def moved(data):
            return data.detach().to(device=dev, dtype=d if d is not None
                                    and data.is_floating_point() else None)

        for p in self.parameters():
            p._data = moved(p._data).requires_grad_(p.trainable)
        for b in self.buffers():
            b._data = moved(b._data)
        if d is not None:
            self._dtype = d
        return self

    # -- state dict ----------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   use_hook=True):
        dest = (collections.OrderedDict() if destination is None
                else destination)
        for name, p in self.named_parameters(
                include_sublayers=include_sublayers):
            dest[name] = p
        for name, b, persistable in self._named_buffers(
                include_sublayers=include_sublayers):
            if persistable:
                dest[name] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy values (Tensors, torch tensors or numpy arrays, by
        structured name) into this layer's parameters and persistable
        buffers, cast to their dtypes; returns (missing, unexpected)
        names."""
        own = self.state_dict()
        missing = []
        for name, t in own.items():
            if name not in state_dict:
                missing.append(name)
                continue
            v = state_dict[name]
            v = v._data if isinstance(v, Tensor) else v
            if not isinstance(v, torch.Tensor):
                v = _as_torch(v, device=t._data.device)
            if tuple(v.shape) != tuple(t._data.shape):
                raise ValueError(f"state_dict shape mismatch for {name}: "
                                 f"{tuple(v.shape)} vs "
                                 f"{tuple(t._data.shape)}")
            with torch.no_grad():
                t._data.copy_(v)
        unexpected = [name for name in state_dict if name not in own]
        return missing, unexpected

    # -- hooks ---------------------------------------------------------------
    def register_forward_pre_hook(self, hook) -> HookRemoveHelper:
        self._hook_id += 1
        self._forward_pre_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_pre_hooks, self._hook_id)

    def register_forward_post_hook(self, hook) -> HookRemoveHelper:
        self._hook_id += 1
        self._forward_post_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_post_hooks, self._hook_id)

    # -- call ----------------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in list(self._forward_pre_hooks.values()):
            res = hook(self, inputs)
            if res is not None:
                inputs = res if isinstance(res, tuple) else (res,)
        out = self.forward(*inputs, **kwargs)
        for hook in list(self._forward_post_hooks.values()):
            res = hook(self, inputs, out)
            if res is not None:
                out = res
        return out

    def extra_repr(self):
        return ""

    def __repr__(self):
        lines = []
        for name, layer in self.named_children():
            mod_str = "\n  ".join(repr(layer).split("\n"))
            lines.append(f"({name}): {mod_str}")
        main = self.__class__.__name__ + "(" + self.extra_repr()
        if lines:
            main += "\n  " + "\n  ".join(lines) + "\n"
        return main + ")"

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()
