"""fluid.dygraph (``paddle_tpu/fluid/dygraph.py``; reference
python/paddle/fluid/dygraph/): the 1.x eager names over the port's 2.x
surface."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..framework.core import Parameter, Tensor, apply_op, grad, no_grad  # noqa: F401
from ..nn import (  # noqa: F401
    BatchNorm, Dropout, GroupNorm, InstanceNorm2D, Layer,
    LayerList, LayerNorm, ParameterList, Sequential, SpectralNorm,
)
from ..nn import Embedding as _Embedding2
from ..nn import Linear as _Linear2
from ..nn import Conv2D, Conv2DTranspose, Conv3D  # noqa: F401
from ..static import ParallelEnv  # noqa: F401
from ..jit import ProgramTranslator, TracedLayer, to_static  # noqa: F401
from ..optimizer.lr import LRScheduler as LearningRateDecay  # noqa: F401


@contextlib.contextmanager
def guard(place=None):
    """fluid.dygraph.guard: eager IS the default mode; the guard only
    keeps static mode off within the block."""
    from .. import disable_static, enable_static
    from ..static import _static_mode

    was_static = _static_mode[0]
    disable_static()
    try:
        yield
    finally:
        if was_static:
            enable_static()


def to_variable(value, name=None, zero_copy=None, dtype=None):
    from ..framework.core import to_tensor

    return to_tensor(np.asarray(value), dtype=dtype, stop_gradient=True)


def enabled():
    from .. import in_dynamic_mode

    return in_dynamic_mode()


def save_dygraph(state_dict, model_path):
    """The reference's suffix rule (dygraph/checkpoint.py): a dict holding
    Parameters is the model (.pdparams); anything else (optimizer slots,
    an empty SGD state) is .pdopt, so saving both under one prefix never
    clobbers the weights."""
    from ..framework.io import save

    is_params = any(isinstance(v, Parameter) for v in state_dict.values())
    save(state_dict, model_path + (".pdparams" if is_params else ".pdopt"))


def load_dygraph(model_path):
    import os

    from ..framework.io import load

    params = load(model_path + ".pdparams") \
        if os.path.exists(model_path + ".pdparams") else None
    opt = load(model_path + ".pdopt") \
        if os.path.exists(model_path + ".pdopt") else None
    return params, opt


class Linear(_Linear2):
    """fluid.dygraph.Linear(input_dim, output_dim, param_attr, bias_attr,
    act, dtype): the 1.x signature carries an activation."""

    def __init__(self, input_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__(input_dim, output_dim, weight_attr=param_attr,
                         bias_attr=bias_attr)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            from ..nn import functional as F

            out = getattr(F, self._act)(out)
        return out


class Embedding(_Embedding2):
    """fluid.dygraph.Embedding(size=[vocab, dim], ...): 1.x passes the
    table shape as one list."""

    def __init__(self, size, is_sparse=False, is_distributed=False,
                 padding_idx=None, param_attr=None, dtype="float32"):
        super().__init__(int(size[0]), int(size[1]),
                         padding_idx=padding_idx, sparse=is_sparse,
                         weight_attr=param_attr)


# -- the remaining 1.x dygraph names ------------------------------------------

from ..jit import TranslatedLayer, not_to_static  # noqa: F401,E402
from ..jit import set_code_level, set_verbosity  # noqa: F401,E402
from ..jit import to_static as declarative  # noqa: F401,E402
from ..jit import to_static as dygraph_to_static_func  # noqa: F401,E402
from ..nn import Conv3DTranspose, GRUCell, LSTMCell  # noqa: F401,E402
from ..framework.core import no_grad as no_grad_  # noqa: F401,E402
from ..framework.io import save, load  # noqa: F401,E402
from ..optimizer.lr import (  # noqa: F401,E402
    CosineAnnealingDecay as CosineDecay, ExponentialDecay,
    InverseTimeDecay, LambdaDecay, LinearWarmup as LinearLrWarmup,
    MultiStepDecay, NaturalExpDecay, NoamDecay, PiecewiseDecay,
    PolynomialDecay, ReduceOnPlateau as ReduceLROnPlateau, StepDecay,
)


def enable_dygraph(place=None):
    from .. import disable_static

    disable_static()


def disable_dygraph():
    from .. import enable_static

    enable_static()


def _world_size():
    return ParallelEnv().world_size


def prepare_context(strategy=None):
    """1.x DataParallel bootstrap: one process needs no context; several
    need the port's data parallelism (ROADMAP.md Queue 1 item 7)."""
    if _world_size() > 1:
        raise NotImplementedError(
            "fluid.dygraph.prepare_context over several processes needs the "
            "port's data parallelism (ROADMAP.md Queue 1 item 7)")
    return None


class DataParallel(Layer):
    """1.x DataParallel on one process: the wrapped layer as it is (one
    replica has no gradient to average). Several processes need the
    port's data parallelism (ROADMAP.md Queue 1 item 7): it raises."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False):
        super().__init__()
        if _world_size() > 1:
            raise NotImplementedError(
                "DataParallel over several processes needs the port's data "
                "parallelism (ROADMAP.md Queue 1 item 7)")
        self._layers = layers

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        return None


def _needs_profiler(what):
    raise NotImplementedError(
        f"fluid.dygraph.{what} needs paddle.profiler, which is not ported "
        f"yet (ROADMAP.md Queue 1 item 9's remainder)")


def start_gperf_profiler():
    _needs_profiler("start_gperf_profiler")


def stop_gperf_profiler():
    _needs_profiler("stop_gperf_profiler")


class Pool2D(Layer):
    """The 1.x Pool2D layer over the pooling functionals."""

    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, use_cudnn=True,
                 ceil_mode=False, exclusive=True, data_format="NCHW"):
        super().__init__()
        self._args = (pool_size, pool_type, pool_stride, pool_padding,
                      global_pooling, ceil_mode, exclusive, data_format)

    def forward(self, x):
        from .layers import pool2d

        size, ptype, stride, pad, gp, ceil, excl, df = self._args
        return pool2d(x, size, ptype, stride, pad, gp, ceil, excl,
                      data_format=df)


class Flatten(Layer):
    def __init__(self, axis=1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        from .layers import flatten

        return flatten(x, self.axis)


class InstanceNorm(InstanceNorm2D):
    """The 1.x name of InstanceNorm2D."""


def _prelu(x, w):
    if w.numel() == 1:
        return torch.where(x >= 0, x, w.reshape(()) * x)
    if w.dim() == 1:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return torch.where(x >= 0, x, w.reshape(shape) * x)
    return torch.where(x >= 0, x, w.unsqueeze(0) * x)


class PRelu(Layer):
    def __init__(self, mode="all", channel=None, input_shape=None,
                 param_attr=None, dtype="float32"):
        super().__init__()
        from ..nn import initializer as I

        if mode == "all":
            shape = [1]
        elif mode == "channel":
            shape = [int(channel)]
        else:
            shape = [int(s) for s in input_shape[1:]]
        init = None
        if param_attr is None or getattr(param_attr, "initializer",
                                         None) is None:
            init = I.Constant(0.25)
        self.weight = self.create_parameter(shape=shape, attr=param_attr,
                                            is_bias=False,
                                            default_initializer=init)

    def forward(self, x):
        return apply_op(_prelu, x, self.weight, op_name="prelu")


def _btp(x, y, w, b):
    return torch.einsum("bd,kde,be->bk", x, w, y) + b


class BilinearTensorProduct(Layer):
    def __init__(self, input1_dim, input2_dim, output_dim, name=None,
                 act=None, param_attr=None, bias_attr=None, dtype="float32"):
        super().__init__()
        from ..nn import initializer as I

        self.weight = self.create_parameter(
            shape=[output_dim, input1_dim, input2_dim], attr=param_attr,
            default_initializer=I.XavierNormal())
        self.bias = self.create_parameter(shape=[output_dim],
                                          attr=bias_attr, is_bias=True)
        self._act = act

    def forward(self, x, y):
        out = apply_op(_btp, x, y, self.weight, self.bias,
                       op_name="bilinear_tensor_product")
        if self._act:
            from ..nn import functional as F

            out = getattr(F, self._act)(out)
        return out


class NCE(Layer):
    """The 1.x NCE layer (nce_op): owns the class weights; the uniform
    sampler draws the negatives at each call (from the device's
    generator, or with ``seed`` from a generator seeded by (seed, the
    call's count), an advancing stream)."""

    def __init__(self, num_total_classes, dim, sample_weight=None,
                 param_attr=None, bias_attr=None, num_neg_samples=10,
                 sampler="uniform", custom_dist=None, seed=0,
                 is_sparse=False):
        super().__init__()
        from ..nn import initializer as I

        self.num_total_classes = num_total_classes
        self.num_neg_samples = num_neg_samples
        self.seed = seed
        self._calls = 0
        self.weight = self.create_parameter(
            shape=[num_total_classes, dim], attr=param_attr,
            default_initializer=I.XavierNormal())
        self.bias = self.create_parameter(shape=[num_total_classes],
                                          attr=bias_attr, is_bias=True)

    def forward(self, input, label, sample_weight=None):  # noqa: A002
        from ..framework import random as grandom
        from ..static.nn import _nce

        dev = self.weight._data.device
        if self.seed:
            self._calls += 1
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(self.seed) * 1000003 + self._calls)
        else:
            gen = grandom.generator(dev)
        neg = torch.randint(0, int(self.num_total_classes),
                            (int(self.num_neg_samples),), generator=gen,
                            device=dev)
        return apply_op(_nce, input, label, self.weight, self.bias,
                        Tensor(neg),
                        num_neg_samples=int(self.num_neg_samples),
                        num_total_classes=int(self.num_total_classes),
                        op_name="nce")


def _gru(x, h, w, b, H, origin_mode):
    g = x + b
    ur = torch.sigmoid(g[:, :2 * H] + h @ w[:, :2 * H])
    u, r = ur[:, :H], ur[:, H:]
    rh = r * h
    c = torch.tanh(g[:, 2 * H:] + rh @ w[:, 2 * H:])
    new_h = (u * h + (1 - u) * c) if origin_mode else ((1 - u) * h + u * c)
    return new_h, rh, torch.cat([u, r, c], dim=1)


class GRUUnit(Layer):
    """1.x GRUUnit (gru_unit_op.h): the input is the pre-projected
    [B, 3H] gate vector; owns the hidden-to-gate weight [H, 3H]. Returns
    (hidden, reset_hidden_pre = r * h_prev, gate = [u, r, c~]), the
    reference's three outputs."""

    def __init__(self, size, param_attr=None, bias_attr=None,
                 activation="tanh", gate_activation="sigmoid",
                 origin_mode=False, dtype="float32"):
        super().__init__()
        from ..nn import initializer as I

        self._hidden = size // 3
        self._origin_mode = origin_mode
        self.weight = self.create_parameter(
            shape=[self._hidden, size], attr=param_attr,
            default_initializer=I.XavierNormal())
        self.bias = self.create_parameter(shape=[size], attr=bias_attr,
                                          is_bias=True)

    def forward(self, input, hidden):  # noqa: A002
        return apply_op(_gru, input, hidden, self.weight, self.bias,
                        H=self._hidden, origin_mode=self._origin_mode,
                        op_name="gru_unit")


class TreeConv(Layer):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "TreeConv (tree_conv_op) consumes LoD edge sets; express tree "
            "convolution as gather + conv over a padded adjacency")
