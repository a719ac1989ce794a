"""Linear algebra ops (``paddle_tpu/tensor/linalg.py``), on the tensor's
device through ``torch.linalg``.

Where the reference differs from torch's defaults, these follow it:
``norm`` is the reference's elementwise p-norm over ``axis`` (2 or
``"fro"``: the root of the sum of squares; ±inf: the max / min of
``|x|``; 0: the count of nonzeros); ``cross``'s default ``axis=9``
takes the first dimension of size 3; ``svd`` returns ``(u, s, vh)``;
``slogdet`` stacks sign and log-determinant; ``lstsq`` is SVD-based
(``np.linalg.lstsq``'s answer, rank-deficient inputs included, with
residuals only for a full-rank tall system), where
``torch.linalg.lstsq`` on the card offers only ``gels``; ``pinv``'s
``rcond`` is relative to the largest singular value. ``lu`` returns
LAPACK's 1-based pivots (Paddle's; the reference returns
``jax.scipy``'s 0-based ones). ``eig`` and ``eigvals`` are complex."""
from __future__ import annotations

import builtins
import math

import torch

from ..framework.core import Tensor, apply_op, records
from .math import dot, matmul  # noqa: F401

__all__ = [
    "norm", "dist", "t", "cross", "cholesky", "qr", "svd", "inv", "det",
    "slogdet", "solve", "triangular_solve", "matrix_power", "pinv",
    "multi_dot", "eig", "eigh", "eigvals", "eigvalsh", "matrix_rank",
    "histogram", "bincount", "mv", "lu", "lstsq", "cov", "corrcoef",
    "inverse",
]


def _norm(x, p=2, axis=None, keepdim=False):
    dims = tuple(range(x.dim())) if axis is None else axis
    if p == "fro" or (p == 2 and axis is None):
        return torch.sqrt(torch.sum(torch.square(x), dim=dims,
                                    keepdim=keepdim))
    if p == math.inf:
        return torch.amax(torch.abs(x), dim=dims, keepdim=keepdim)
    if p == -math.inf:
        return torch.amin(torch.abs(x), dim=dims, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=dims, keepdim=keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=dims,
                               keepdim=keepdim), 1.0 / p)


def norm(x, p=2, axis=None, keepdim=False, name=None):
    if isinstance(axis, (list, tuple)):
        axis = tuple(int(a) for a in axis)
    elif axis is not None:
        axis = int(axis)
    if isinstance(p, str) and p != "fro":
        raise ValueError(f"unsupported norm p={p}")
    if not isinstance(p, str) and not math.isinf(p):
        p = float(p)
    return apply_op(_norm, x, p=p, axis=axis, keepdim=bool(keepdim))


def _dist(x, y, p=2):
    return _norm(x - y, p=p)


def dist(x, y, p=2, name=None):
    return apply_op(_dist, x, y, p=p if math.isinf(p) else float(p))


def _t(x):
    return x if x.dim() < 2 else x.transpose(0, 1)


def t(input, name=None):  # noqa: A002
    return apply_op(_t, input)


def _cross(x, y, axis=9):
    if axis == 9:
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, y, dim=axis)


def cross(x, y, axis=9, name=None):
    return apply_op(_cross, x, y, axis=int(axis))


def cholesky(x, upper=False, name=None):
    return apply_op(torch.linalg.cholesky, x, upper=bool(upper))


def _qr(x, mode="reduced"):
    out = torch.linalg.qr(x, mode=mode)
    return out.R if mode == "r" else tuple(out)


def qr(x, mode="reduced", name=None):
    return apply_op(_qr, x, mode=mode)


def _svd(x, full_matrices=False):
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


def svd(x, full_matrices=False, name=None):
    return apply_op(_svd, x, full_matrices=bool(full_matrices))


def inv(x, name=None):
    return apply_op(torch.linalg.inv, x)


inverse = inv


def det(x, name=None):
    return apply_op(torch.linalg.det, x)


def _slogdet(x):
    sign, logdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logdet])


def slogdet(x, name=None):
    return apply_op(_slogdet, x)


def solve(x, y, name=None):
    return apply_op(torch.linalg.solve, x, y)


def _triangular_solve(x, y, upper=True, transpose=False,
                      unitriangular=False):
    if transpose:
        x, upper = x.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    return apply_op(_triangular_solve, x, y, upper=bool(upper),
                    transpose=bool(transpose),
                    unitriangular=bool(unitriangular))


def matrix_power(x, n, name=None):
    return apply_op(torch.linalg.matrix_power, x, n=int(n))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply_op(torch.linalg.pinv, x, rtol=float(rcond),
                    hermitian=bool(hermitian))


def _multi_dot(*mats):
    out = mats[0]
    for m in mats[1:]:
        out = out @ m
    return out


def multi_dot(x, name=None):
    return apply_op(_multi_dot, *x)


def eig(x, name=None):
    return apply_op(lambda a: tuple(torch.linalg.eig(a)), x)


def eigvals(x, name=None):
    return apply_op(torch.linalg.eigvals, x)


def _eigh(x, UPLO="L"):
    return tuple(torch.linalg.eigh(x, UPLO=UPLO))


def eigh(x, UPLO="L", name=None):
    return apply_op(_eigh, x, UPLO=UPLO)


def eigvalsh(x, UPLO="L", name=None):
    return apply_op(torch.linalg.eigvalsh, x, UPLO=UPLO)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return apply_op(torch.linalg.matrix_rank, x,
                    rtol=None if tol is None else float(tol),
                    hermitian=bool(hermitian))


@records
def histogram(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    """Counts of ``bins`` equal bins over [min, max] (the data's range
    when both are 0), as int64; the last bin holds max."""
    xa = input._data.detach()
    xf = xa if xa.is_floating_point() else xa.double()
    if min == 0 and max == 0:
        lo, hi = xf.min().item(), xf.max().item()
    else:
        lo, hi = float(min), float(max)
    return Tensor(torch.histc(xf, bins=int(bins), min=lo, max=hi).long())


@records
def bincount(x, weights=None, minlength=0, name=None):
    xa = x._data.detach().long()
    wa = None if weights is None else weights._data.detach()
    return Tensor(torch.bincount(xa, weights=wa, minlength=int(minlength)))


def mv(x, vec, name=None):
    return apply_op(torch.matmul, x, vec)


@records
def lu(x, pivot=True, get_infos=False, name=None):
    """The packed LU factors and LAPACK's 1-based pivots (int32)."""
    out, piv, info = torch.linalg.lu_factor_ex(x._data.detach(),
                                               pivot=bool(pivot))
    res = (Tensor(out), Tensor(piv.to(torch.int32)))
    return res + (Tensor(info.to(torch.int32)),) if get_infos else res


def _lstsq(x, y, rcond=None):
    m, n = x.shape[-2], x.shape[-1]
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    if rcond is None or rcond < 0:
        rcond = torch.finfo(x.dtype).eps * builtins.max(m, n)
    cut = rcond * s.amax(dim=-1, keepdim=True)
    keep = s > cut
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0),
                        torch.zeros_like(s))
    col = y.dim() == x.dim() - 1
    yy = y.unsqueeze(-1) if col else y
    sol = vh.transpose(-1, -2) @ (s_inv.unsqueeze(-1)
                                  * (u.transpose(-1, -2) @ yy))
    rank = keep.sum(dim=-1)
    if m > n and bool((rank == n).all()):
        res = torch.sum(torch.square(x @ sol - yy), dim=-2)
        res = res.squeeze(-1) if col else res
    else:
        res = torch.zeros((0,), dtype=x.dtype, device=x.device)
    return (sol.squeeze(-1) if col else sol), res, rank, s


def lstsq(x, y, rcond=None, driver=None, name=None):
    """The least-squares solution of ``x @ sol = y`` through the SVD
    (``np.linalg.lstsq``: rank-deficient inputs take the minimum-norm
    solution): (solution, residuals, rank, singular values)."""
    return apply_op(_lstsq, x, y, rcond=rcond)


def _cov(x, rowvar=True, ddof=True):
    return torch.cov(x if rowvar else x.transpose(0, 1),
                     correction=1 if ddof else 0)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return apply_op(_cov, x, rowvar=bool(rowvar), ddof=bool(ddof))


def _corrcoef(x, rowvar=True):
    return torch.corrcoef(x if rowvar else x.transpose(0, 1))


def corrcoef(x, rowvar=True, name=None):
    return apply_op(_corrcoef, x, rowvar=bool(rowvar))
