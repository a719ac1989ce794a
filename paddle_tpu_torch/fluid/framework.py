"""fluid.framework (reference fluid/framework.py)."""
from ..framework.core import Parameter, Tensor  # noqa: F401
from ..static import (  # noqa: F401
    Block, Operator, Program, Variable, default_main_program,
    default_startup_program, device_guard, name_scope, program_guard,
)


def in_dygraph_mode():
    from .. import in_dynamic_mode

    return in_dynamic_mode()


class ParamBase(Parameter):
    """The 1.x alias of Parameter."""
