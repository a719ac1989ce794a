"""fluid.backward (reference fluid/backward.py)."""
from ..static import append_backward, gradients  # noqa: F401


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    return gradients(targets, inputs, target_gradients, no_grad_set)
