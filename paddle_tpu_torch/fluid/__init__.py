"""paddle.fluid, the 1.x surface (``paddle_tpu/fluid/__init__.py``).

Reference-era scripts import ``paddle.fluid``; every name here re-exports
or thinly adapts the 2.x surface the port implements, so those scripts
run with only the top-level import renamed. ``fluid.profiler`` needs
``paddle.profiler``, which is not ported (ROADMAP.md Queue 1 item 9's
remainder): its functions raise. ``fluid.io``'s inference pair needs the
export format (item 11) and raises.
"""
from __future__ import annotations

import contextlib

from ..framework.core import Parameter, Tensor  # noqa: F401
from ..framework.param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
from ..device import (  # noqa: F401
    CPUPlace, CUDAPlace, CUDAPinnedPlace, XPUPlace, NPUPlace,
    is_compiled_with_cuda,
)
from ..static import (  # noqa: F401
    BuildStrategy, CompiledProgram, ExecutionStrategy, Executor,
    ParallelExecutor, Program, Scope, default_main_program,
    default_startup_program, global_scope, name_scope, program_guard,
    scope_guard,
)
from ..framework.io import save, load  # noqa: F401

from . import layers  # noqa: F401
from . import dygraph  # noqa: F401
from . import optimizer  # noqa: F401
from . import initializer  # noqa: F401
from . import regularizer  # noqa: F401
from . import io  # noqa: F401
from . import backward  # noqa: F401
from . import clip  # noqa: F401
from .framework import Variable  # noqa: F401
from . import framework  # noqa: F401
from .data_feeder import DataFeeder  # noqa: F401
from . import profiler  # noqa: F401


def data(name, shape, dtype="float32", lod_level=0):
    """fluid.data → static.data (reference fluid/data.py)."""
    from ..static import data as _data

    return _data(name, shape, dtype, lod_level)


from ..static.nn import embedding  # noqa: F401,E402


def enable_dygraph(place=None):
    from .. import disable_static

    disable_static()


def disable_dygraph():
    from .. import enable_static

    enable_static()


def enable_imperative(place=None):
    enable_dygraph(place)


def disable_imperative():
    disable_dygraph()


def set_flags(flags):
    from .. import set_flags as _sf

    _sf(flags)


def get_flags(flags):
    from .. import get_flags as _gf

    return _gf(flags)


from .framework import in_dygraph_mode  # noqa: F401,E402


@contextlib.contextmanager
def device_guard(device=None):
    from ..static import device_guard as _dg

    with _dg(device):
        yield
