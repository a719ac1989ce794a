"""paddle.linalg (``paddle_tpu/linalg.py``): the ``tensor.linalg`` ops
under their Paddle names, and ``cond``, which Paddle has only here."""
from __future__ import annotations

import torch

from .framework.core import apply_op
from .tensor.linalg import (cholesky, corrcoef, cov, det, eig,  # noqa: F401
                            eigh, eigvals, eigvalsh, inv, lstsq, lu,
                            matrix_power, matrix_rank, multi_dot, norm, pinv,
                            qr, slogdet, solve, svd, triangular_solve)

__all__ = [
    "cholesky", "cond", "det", "eig", "eigh", "eigvals", "inv",
    "matrix_power", "matrix_rank", "multi_dot", "norm", "pinv", "qr",
    "slogdet", "solve", "svd",
]


def _cond(x, p=2):
    if p in (2, -2):
        s = torch.linalg.svdvals(x)
        return (s[..., 0] / s[..., -1] if p == 2
                else s[..., -1] / s[..., 0])
    if p in ("fro", "nuc") or isinstance(p, (int, float)):
        return (torch.linalg.matrix_norm(x, ord=p)
                * torch.linalg.matrix_norm(torch.linalg.inv(x), ord=p))
    raise ValueError("unsupported norm order for cond: %r" % (p,))


def cond(x, p=None, name=None):
    """The condition number of ``x`` in the matrix norm ``p`` (2 by
    default: the ratio of the extreme singular values)."""
    return apply_op(_cond, x, p=2 if p is None else p)
