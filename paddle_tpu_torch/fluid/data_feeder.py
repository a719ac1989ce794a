"""fluid.data_feeder (reference fluid/data_feeder.py): the type checks
and ``DataFeeder``, which turns a list of samples into a feed dict of
batched arrays (``Executor.run(feed=...)``)."""
from __future__ import annotations

import numpy as np

from ..framework import dtype as dtypes
from ..tensor.creation import check_shape  # noqa: F401


def convert_dtype(dtype):
    return dtypes.dtype_name(dtypes.convert_dtype(dtype))


def check_variable_and_dtype(input, input_name, expected_dtype, op_name,  # noqa: A002
                             extra_message=""):
    check_dtype(input.dtype, input_name, expected_dtype, op_name,
                extra_message)


def check_dtype(input_dtype, input_name, expected_dtype, op_name,
                extra_message=""):
    got = (dtypes.dtype_name(dtypes.convert_dtype(input_dtype))
           if input_dtype is not None else None)
    if got not in tuple(expected_dtype):
        raise TypeError(
            "%s: %s dtype must be one of %s, got %s. %s"
            % (op_name, input_name, expected_dtype, got, extra_message))


def check_type(input, input_name, expected_type, op_name):  # noqa: A002
    if not isinstance(input, expected_type):
        raise TypeError("%s: %s must be %s, got %s"
                        % (op_name, input_name, expected_type, type(input)))


class DataFeeder:
    """List of samples → feed dict of batched arrays (reference
    DataFeeder.feed): field i of every sample stacked under the i-th feed
    name."""

    def __init__(self, feed_list, place=None, program=None):
        self.feed_names = [getattr(v, "name", v) for v in feed_list]

    def feed(self, iterable):
        rows = list(iterable)
        return {name: np.stack([np.asarray(r[i]) for r in rows])
                for i, name in enumerate(self.feed_names)}
