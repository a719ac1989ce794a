"""The port's tensor surface against paddle_tpu's, on the CPU: the ops of
``tensor/creation.py``, ``math.py``, ``manipulation.py``, ``logic.py``,
``search.py``, ``linalg.py``, ``paddle.linalg``, ``einsum``, the common
functionals and layers of ``nn/functional/common.py`` and
``nn/layer/common.py``, the containers, and the Tensor methods.

Each case feeds the same seeded numpy inputs through both packages,
parametrized by name. Tolerances (f32): elementwise ops rtol 1e-5, atol
1e-6; reductions, linalg and resizing rtol 1e-4, atol 1e-5 (sums in
another order; a factorization's own rounding); index outputs exactly,
on inputs without ties. Integer results are compared by value (the
port's are int64 where the reference's are int32). For a differentiable
case the gradient of ``sum(y · w)`` (w fixed) is compared at the case's
tolerance, atol taken of the largest gradient (special functions take
the reductions' tolerance: each library's own series). Factorizations whose
factors are defined up to sign (``qr``, ``svd``, ``eig``, ``eigh``) are
compared by their values and by what they reconstruct.

``interpolate`` covers ``nearest``, ``bilinear`` and ``bicubic``, up and
down, with and without ``align_corners`` (the reference resizes with
``jax.image.resize``: half-pixel centres, antialiased downsampling, Keys
a = −0.5); ``median`` runs over an even count (the mean of the two
middle values). The random functionals (``dropout2d``, ``dropout3d``,
``alpha_dropout``, ``class_center_sample``) get shape and statistics
checks, not values.
"""
import math

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import device as tdevice
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

ELEM = (1e-5, 1e-6)
RED = (1e-4, 1e-5)
EXACT = None


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old


_RNG = np.random.default_rng(2016)
A = _RNG.normal(size=(3, 4, 5)).astype("float32")
B = _RNG.normal(size=(3, 4, 5)).astype("float32")
POS = _RNG.uniform(0.5, 2.0, (3, 4, 5)).astype("float32")
UNIT = _RNG.uniform(-0.9, 0.9, (3, 4, 5)).astype("float32")
M = _RNG.normal(size=(4, 4)).astype("float32")
SPD = (M @ M.T + 4 * np.eye(4)).astype("float32")
V = _RNG.normal(size=(4,)).astype("float32")
IA = _RNG.integers(-20, 20, (3, 4, 5)).astype("int32")
IB = _RNG.integers(1, 20, (3, 4, 5)).astype("int32")
PERM = np.stack([_RNG.permutation(20) for _ in range(6)]).astype(
    "float32").reshape(6, 20) - 7.5          # rows without ties
IMG = _RNG.normal(size=(2, 3, 8, 10)).astype("float32")


def _np(v):
    if isinstance(v, (list, tuple)):
        return [_np(x) for x in v]
    if hasattr(v, "numpy"):
        return np.asarray(v.numpy())
    return np.asarray(v)


def _compare(want, got, tol):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for w, g in zip(want, got):
            _compare(w, g, tol)
        return
    assert want.shape == got.shape, (want.shape, got.shape)
    if tol is EXACT or want.dtype.kind in "biu" or got.dtype.kind in "biu":
        assert want.dtype.kind == got.dtype.kind or {
            want.dtype.kind, got.dtype.kind} <= set("iu"), (want.dtype,
                                                            got.dtype)
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_allclose(got.astype(np.complex128 if got.dtype.kind
                                          == "c" else np.float64),
                               want, rtol=tol[0], atol=tol[1])


def _tensors(p, arrays, grad):
    return [p.to_tensor(a, stop_gradient=not (grad and a.dtype.kind == "f"))
            for a in arrays]


def _run(p, fn, arrays, grad):
    ts = _tensors(p, arrays, grad)
    out = fn(p, *ts)
    if not grad:
        return _np(out), None
    y = out[0] if isinstance(out, (list, tuple)) else out
    w = np.random.default_rng(7).normal(size=y.shape).astype("float32")
    y.backward(p.to_tensor(w))
    return _np(out), [None if t.grad is None else t.grad.numpy()
                      for t in ts if not t.stop_gradient]


def _case(fn, arrays, tol=ELEM, grad=False):
    return fn, arrays, tol, grad


UNARY = {
    "exp": A, "expm1": A, "log": POS, "log2": POS, "log10": POS,
    "log1p": POS, "sqrt": POS, "rsqrt": POS, "square": A, "abs": A,
    "sign": A, "floor": A * 3, "ceil": A * 3, "round": A * 3 + 0.1,
    "trunc": A * 3, "sin": A, "cos": A, "tan": UNIT, "asin": UNIT,
    "acos": UNIT, "atan": A, "sinh": A, "cosh": A, "tanh": A,
    "asinh": A, "acosh": POS + 1, "atanh": UNIT, "reciprocal": POS,
    "sigmoid": A, "erf": A, "erfinv": UNIT, "lgamma": POS, "digamma": POS,
    "neg": A, "isnan": A, "isinf": A, "isfinite": A, "deg2rad": A,
    "rad2deg": A, "frac": A * 3, "angle": A, "conj": A, "real": A,
    "imag": A,
}
NO_GRAD = {"sign", "floor", "ceil", "round", "trunc", "isnan", "isinf",
           "isfinite", "angle", "imag", "frac"}
# special functions: each library's own series, a few ulps apart
SPECIAL = {"lgamma", "digamma", "erfinv"}

CASES = {f"unary_{n}": _case((lambda n: lambda p, x: getattr(p, n)(x))(n),
                             [a], RED if n in SPECIAL else ELEM,
                             n not in NO_GRAD)
         for n, a in UNARY.items()}

BINARY = {
    "maximum": (A, B), "minimum": (A, B), "fmax": (A, B), "fmin": (A, B),
    "atan2": (A, B), "floor_mod": (A * 4, POS), "heaviside": (A, B),
}
for _n, _ab in BINARY.items():
    CASES[f"binary_{_n}"] = _case(
        (lambda n: lambda p, x, y: getattr(p, n)(x, y))(_n), list(_ab),
        ELEM, _n in ("maximum", "minimum", "atan2"))

CASES.update({
    "gcd": _case(lambda p, x, y: p.gcd(x, y), [IA, IB], EXACT),
    "lcm": _case(lambda p, x, y: p.lcm(x, y), [IA, IB], EXACT),
    "kron": _case(lambda p, x, y: p.kron(x, y), [M[:2, :3], M[:3, :2]],
                  ELEM, True),
    "dot_1d": _case(lambda p, x, y: p.dot(x, y), [V, V * 2], RED, True),
    "dot_2d": _case(lambda p, x, y: p.dot(x, y), [M, SPD], RED, True),
    "inner": _case(lambda p, x, y: p.inner(x, y), [A, B], RED, True),
    "outer": _case(lambda p, x, y: p.outer(x, y), [V, A[0, 0]], ELEM, True),
    "addmm": _case(lambda p, i, x, y: p.addmm(i, x, y, beta=0.5, alpha=2.0),
                   [M, SPD, M], RED, True),
    "mv": _case(lambda p, x, v: p.mv(x, v), [M, V], RED, True),
    "clip": _case(lambda p, x: p.clip(x, -0.5, 0.7), [A], ELEM, True),
    "stanh": _case(lambda p, x: p.stanh(x, 0.5, 1.5), [A], ELEM, True),
    "lerp": _case(lambda p, x, y: p.lerp(x, y, 0.3), [A, B], ELEM, True),
    "rot90": _case(lambda p, x: p.rot90(x, 1, [1, 2]), [A], EXACT),
    "add_n": _case(lambda p, x, y: p.add_n([x, y, x]), [A, B], ELEM, True),
    "diagonal": _case(lambda p, x: p.diagonal(x, 1, 1, 2), [A], ELEM, True),
    "trace": _case(lambda p, x: p.trace(x, 0, 1, 2), [A], RED, True),
    "diff": _case(lambda p, x: p.diff(x, n=2, axis=-1), [A], ELEM, True),
    "diff_prepend": _case(lambda p, x, y: p.diff(x, axis=1, prepend=y),
                          [A, B[:, :1]], ELEM),
    "nan_to_num": _case(lambda p, x: p.nan_to_num(p.log(x), nan=0.5,
                                                  posinf=9.0, neginf=-9.0),
                        [np.array([-1.0, 0.0, 1.0, np.inf], "float32")]),
    "multiplex": _case(lambda p, x, y, i: p.multiplex([x, y], i),
                       [M, SPD, np.array([[1], [0], [1], [0]], "int32")]),
    "count_nonzero": _case(lambda p, x: p.count_nonzero(x, axis=1),
                           [np.floor(A)], EXACT),
    "count_nonzero_keep": _case(
        lambda p, x: p.count_nonzero(x, axis=[0, 2], keepdim=True),
        [np.floor(A)], EXACT),
    "increment": _case(lambda p, x: p.increment(x * 1.0, 2.5), [A]),
    "logcumsumexp": _case(lambda p, x: p.logcumsumexp(x, axis=1), [A], RED,
                          True),
    "nansum": _case(lambda p, x: p.nansum(p.log(x), axis=1), [A], RED),
    "nanmean": _case(lambda p, x: p.nanmean(p.log(x), axis=2), [A], RED),
})

REDUCTIONS = {
    "sum": {}, "mean": {}, "max": {}, "min": {}, "amax": {}, "amin": {},
    "prod": {}, "logsumexp": {}, "std": {}, "var": {}, "median": {},
}
for _n in REDUCTIONS:
    for _tag, _kw in (("all", {}), ("axis1", {"axis": 1}),
                      ("axes_keep", {"axis": [0, 2], "keepdim": True})):
        if _n == "median" and _tag == "axes_keep":
            _kw = {"axis": 2, "keepdim": True}
        CASES[f"reduce_{_n}_{_tag}"] = _case(
            (lambda n, kw: lambda p, x: getattr(p, n)(x, **kw))(_n, _kw),
            [POS if _n == "prod" else A], RED, _n != "median")
CASES.update({
    # an even count along each axis: the mean of the two middle values
    "median_even": _case(lambda p, x: p.median(x, axis=1), [A], RED),
    "median_even_all": _case(lambda p, x: p.median(x), [A[:, :, :2]], RED),
    "std_biased": _case(lambda p, x: p.std(x, axis=2, unbiased=False), [A],
                        RED, True),
    "var_biased": _case(lambda p, x: p.var(x, unbiased=False), [A], RED),
    "cumsum": _case(lambda p, x: p.cumsum(x, axis=1), [A], RED, True),
    "cumsum_flat": _case(lambda p, x: p.cumsum(x), [A], RED),
    "cumprod": _case(lambda p, x: p.cumprod(x, dim=2), [POS], RED, True),
    "all": _case(lambda p, x: p.all(x > -1.5, axis=1), [A], EXACT),
    "any": _case(lambda p, x: p.any(x > 1.5, axis=[0, 2]), [A], EXACT),
    "any_all": _case(lambda p, x: p.any(x > 2.5), [A], EXACT),
})

# manipulation
IDX = np.array([2, 0, 3], "int64")
CASES.update({
    "stack": _case(lambda p, x, y: p.stack([x, y], axis=1), [A, B], ELEM,
                   True),
    "chunk": _case(lambda p, x: p.chunk(x, 2, axis=1), [A], ELEM),
    "squeeze": _case(lambda p, x: p.squeeze(x[:, :1], axis=[1, 2]), [A]),
    "flip": _case(lambda p, x: p.flip(x, [0, 2]), [A], ELEM, True),
    "reverse": _case(lambda p, x: p.reverse(x, 1), [A]),
    "roll": _case(lambda p, x: p.roll(x, [1, -2], [0, 2]), [A], ELEM, True),
    "roll_flat": _case(lambda p, x: p.roll(x, 3), [A]),
    "tile": _case(lambda p, x: p.tile(x, [2, 1, 1, 2]), [A], ELEM, True),
    "expand": _case(lambda p, x: p.expand(x[:, :1], [2, 3, -1, 5]), [A],
                    ELEM, True),
    "expand_as": _case(lambda p, x, y: p.expand_as(x[:1], y), [A, B]),
    "broadcast_to": _case(lambda p, x: p.broadcast_to(x[0, :1], [2, 4, 5]),
                          [A]),
    "broadcast_tensors": _case(lambda p, x, y: p.broadcast_tensors(
        [x[:, :1], y[:1]]), [A, B]),
    "gather": _case(lambda p, x, i: p.gather(x, i, axis=1), [A, IDX], ELEM,
                    True),
    "gather_nd": _case(lambda p, x, i: p.gather_nd(x, i),
                       [A, np.array([[0, 1], [2, 3], [1, 0]], "int64")],
                       ELEM, True),
    "index_select": _case(lambda p, x, i: p.index_select(x, i, axis=2),
                          [A, IDX], ELEM, True),
    "scatter": _case(lambda p, x, i, u: p.scatter(x, i, u),
                     [M, np.array([2, 0], "int64"), SPD[:2]], ELEM, True),
    "scatter_add": _case(lambda p, x, i, u: p.scatter(x, i, u,
                                                      overwrite=False),
                         [M, np.array([2, 0, 2], "int64"), SPD[:3]], ELEM,
                         True),
    "scatter_nd_add": _case(lambda p, x, i, u: p.scatter_nd_add(x, i, u),
                            [M, np.array([[1], [3], [1]], "int64"), SPD[:3]],
                            ELEM, True),
    "scatter_nd": _case(lambda p, i, u: p.scatter_nd(i, u, [5, 4]),
                        [np.array([[1], [3], [1]], "int64"), SPD[:3]]),
    "index_add": _case(lambda p, x, i, v: p.index_add(x, i, 0, v),
                       [M, np.array([3, 0, 3], "int64"), SPD[:3]], ELEM,
                       True),
    "index_sample": _case(lambda p, x, i: p.index_sample(x, i),
                          [M, np.array([[0, 2], [1, 1], [3, 0], [2, 2]],
                                       "int64")], ELEM, True),
    "masked_select": _case(lambda p, x: p.masked_select(x, x > 0.3), [A],
                           ELEM, True),
    "where": _case(lambda p, x, y: p.where(x > 0, x, y), [A, B], ELEM, True),
    "where_scalar": _case(lambda p, x: p.where(x > 0, x, 0.5), [A]),
    "where_nonzero": _case(lambda p, x: p.where(x > 0.5), [A], EXACT),
    "slice": _case(lambda p, x: p.slice(x, [0, 2], [1, -3], [3, 10]), [A],
                   ELEM, True),
    "strided_slice": _case(lambda p, x: p.strided_slice(
        x, [1, 2], [0, 4], [4, 0], [2, -2]), [A], ELEM, True),
    "unbind": _case(lambda p, x: p.unbind(x, axis=1), [A]),
    "unstack": _case(lambda p, x: p.unstack(x, axis=2), [A]),
    "unique": _case(lambda p, x: p.unique(x, return_index=True,
                                          return_inverse=True,
                                          return_counts=True),
                    [np.array([3, 1, 3, 7, 1, 1, 0], "int64")], EXACT),
    "unique_floats": _case(lambda p, x: p.unique(x), [np.round(A)], EXACT),
    "unique_consecutive": _case(
        lambda p, x: p.unique_consecutive(x, return_inverse=True,
                                          return_counts=True),
        [np.array([1, 1, 2, 2, 2, 1, 3, 3], "int64")], EXACT),
    "repeat_interleave": _case(lambda p, x: p.repeat_interleave(x, 2,
                                                                axis=1),
                               [A], ELEM, True),
    "take_along_axis": _case(lambda p, x, i: p.take_along_axis(x, i, 1),
                             [M, np.array([[0, 3], [1, 1], [2, 0], [3, 2]],
                                          "int64")], ELEM, True),
    "put_along_axis": _case(lambda p, x, i, v: p.put_along_axis(x, i, v, 1),
                            [M, np.array([[0], [1], [2], [3]], "int64"),
                             SPD[:, :1]]),
    "put_along_axis_add": _case(
        lambda p, x, i: p.put_along_axis(x, i, 2.0, 1, reduce="add"),
        [M, np.array([[0], [3], [2], [3]], "int64")]),
    "moveaxis": _case(lambda p, x: p.moveaxis(x, [0, 1], [2, 0]), [A], ELEM,
                      True),
    "tensordot": _case(lambda p, x, y: p.tensordot(x, y, [[1, 2], [1, 2]]),
                       [A, B], RED, True),
    "tensordot_int": _case(lambda p, x, y: p.tensordot(x, y, 1),
                           [M, SPD], RED),
    "as_real_complex": _case(lambda p, x: p.as_real(p.as_complex(x)),
                             [A[..., :2]]),
    "crop": _case(lambda p, x: p.crop(x, [2, -1, 3], [1, 1, 2]), [A], ELEM,
                  True),
    "shape": _case(lambda p, x: p.shape(x), [A], EXACT),
    "rank": _case(lambda p, x: p.rank(x), [A], EXACT),
    "shard_index": _case(lambda p, x: p.shard_index(x, 20, 3, 1),
                         [np.array([[1], [7], [13], [19]], "int64")], EXACT),
    "split_sections": _case(lambda p, x: p.split(x, [1, -1, 2], axis=2),
                            [A]),
})
for _mode in ("constant", "replicate", "reflect", "circular"):
    CASES[f"pad_{_mode}"] = _case(
        (lambda m: lambda p, x: p.nn.functional.pad(x, [1, 2, 2, 1], mode=m,
                                                    value=0.5))(_mode),
        [IMG], ELEM, True)
CASES["pad_all_dims"] = _case(
    lambda p, x: p.nn.functional.pad(x, [0, 1, 1, 0, 2, 2]), [A], ELEM)

# creation
CASES.update({
    "zeros_like": _case(lambda p, x: p.zeros_like(x), [A]),
    "ones_like": _case(lambda p, x: p.ones_like(x, dtype="int32"), [A],
                       EXACT),
    "full_like": _case(lambda p, x: p.full_like(x, 2.5), [A]),
    "empty_like": _case(lambda p, x: p.empty_like(x).shape, [A], EXACT),
    "empty": _case(lambda p: p.empty([2, 3]).shape, [], EXACT),
    "linspace": _case(lambda p: p.linspace(-1.0, 2.0, 7), [], ELEM),
    "logspace": _case(lambda p: p.logspace(0.0, 2.0, 5, base=2.0), [], ELEM),
    "eye": _case(lambda p: p.eye(3, 5), []),
    "tril": _case(lambda p, x: p.tril(x, -1), [M], ELEM, True),
    "triu": _case(lambda p, x: p.triu(x, 1), [M], ELEM, True),
    "diag_vector": _case(lambda p, v: p.diag(v, 1, padding_value=9.0), [V]),
    "diag_matrix": _case(lambda p, x: p.diag(x, -1), [M], ELEM, True),
    "diagflat": _case(lambda p, x: p.diagflat(x, 1), [M[:2]], ELEM, True),
    "meshgrid": _case(lambda p, x, y: p.meshgrid(x, y), [V, V[:3]], ELEM,
                      True),
    "assign": _case(lambda p, x: p.assign(x), [A], ELEM, True),
    "assign_numpy": _case(lambda p: p.assign(np.arange(4.0, dtype="float32")),
                          []),
    "clone": _case(lambda p, x: p.clone(x), [A], ELEM, True),
    "numel": _case(lambda p, x: p.numel(x), [A], EXACT),
    "one_hot": _case(lambda p, x: p.nn.functional.one_hot(x, 5),
                     [np.array([0, 4, 2], "int64")]),
    "complex": _case(lambda p, x, y: p.complex(x, y), [A, B]),
    "is_empty": _case(lambda p, x: p.is_empty(x), [A], EXACT),
    "einsum": _case(lambda p, x, y: p.einsum("ijk,ilk->jl", x, y), [A, B],
                    RED, True),
})

# logic and search
CASES.update({
    "bitwise_and": _case(lambda p, x, y: p.bitwise_and(x, y), [IA, IB],
                         EXACT),
    "bitwise_or": _case(lambda p, x, y: p.bitwise_or(x, y), [IA, IB], EXACT),
    "bitwise_xor": _case(lambda p, x, y: p.bitwise_xor(x, y), [IA, IB],
                         EXACT),
    "bitwise_not": _case(lambda p, x: p.bitwise_not(x), [IA], EXACT),
    "bitwise_and_bool": _case(lambda p, x, y: p.bitwise_and(x > 0, y > 0),
                              [A, B], EXACT),
    "argmax": _case(lambda p, x: p.argmax(x, axis=1), [PERM], EXACT),
    "argmax_all_keep": _case(lambda p, x: p.argmax(x, keepdim=True), [PERM],
                             EXACT),
    "argmin": _case(lambda p, x: p.argmin(x, axis=-1, keepdim=True), [PERM],
                    EXACT),
    "argsort": _case(lambda p, x: p.argsort(x, axis=1), [PERM], EXACT),
    "argsort_desc": _case(lambda p, x: p.argsort(x, descending=True),
                          [PERM], EXACT),
    # stable: equal keys keep their order, ascending and descending
    "argsort_ties_stable": _case(
        lambda p, x: [p.argsort(x), p.argsort(x, descending=True)],
        [np.array([[2, 1, 2, 1, 0, 2, 1]], "float32")], EXACT),
    "sort": _case(lambda p, x: p.sort(x, axis=0), [A], ELEM, True),
    "topk": _case(lambda p, x: p.topk(x, 3, axis=1), [PERM], EXACT),
    "topk_smallest": _case(lambda p, x: p.topk(x, 4, axis=0, largest=False),
                           [PERM.T], EXACT),
    "topk_grad": _case(lambda p, x: p.topk(x, 3)[0], [PERM], ELEM, True),
    "nonzero": _case(lambda p, x: p.nonzero(x > 0.5), [A], EXACT),
    "nonzero_tuple": _case(lambda p, x: p.nonzero(x > 0.5, as_tuple=True),
                           [A], EXACT),
    "searchsorted": _case(lambda p, s, v: p.searchsorted(s, v),
                          [np.sort(PERM, axis=1), PERM[:, ::3] + 0.5],
                          EXACT),
    "searchsorted_right": _case(
        lambda p, s, v: p.searchsorted(s, v, right=True),
        [np.arange(10, dtype="float32"), np.array([0, 3, 9.5], "float32")],
        EXACT),
    "kthvalue": _case(lambda p, x: p.kthvalue(x, 5, axis=1), [PERM], EXACT),
    "mode": _case(lambda p, x: p.mode(x),
                  [np.array([[1, 3, 3, 2, 1, 3], [5, 4, 4, 5, 0, 0]],
                            "float32")], EXACT),
})

# linalg
CASES.update({
    "norm_fro": _case(lambda p, x: p.norm(x), [A], RED, True),
    "norm_axis": _case(lambda p, x: p.norm(x, p=3, axis=1), [A], RED, True),
    "norm_inf": _case(lambda p, x: p.norm(x, p=float("inf"), axis=[1, 2]),
                      [A], RED),
    "norm_one_keep": _case(lambda p, x: p.norm(x, p=1, axis=-1,
                                               keepdim=True), [A], RED),
    "norm_zero": _case(lambda p, x: p.norm(x, p=0, axis=0),
                       [np.floor(A)], RED),
    "dist": _case(lambda p, x, y: p.dist(x, y, 3), [A, B], RED, True),
    "t": _case(lambda p, x: p.t(x), [M], ELEM, True),
    "cross_default_axis": _case(lambda p, x, y: p.cross(x, y),
                                [A[:, :3, 0], B[:, :3, 0]], RED, True),
    "cross_axis": _case(lambda p, x, y: p.cross(x, y, axis=0), [A, B], RED),
    "cholesky": _case(lambda p, x: p.cholesky(x), [SPD], RED, True),
    "cholesky_upper": _case(lambda p, x: p.linalg.cholesky(x, upper=True),
                            [SPD], RED),
    "inv": _case(lambda p, x: p.inverse(x), [SPD], RED, True),
    "det": _case(lambda p, x: p.linalg.det(x), [SPD], RED, True),
    "slogdet": _case(lambda p, x: p.linalg.slogdet(x), [M], RED),
    "solve": _case(lambda p, x, y: p.linalg.solve(x, y), [SPD, M], RED,
                   True),
    "triangular_solve": _case(
        lambda p, x, y: p.tensor.linalg.triangular_solve(x, y, upper=False,
                                                         transpose=True),
        [np.tril(SPD), M], RED),
    "matrix_power": _case(lambda p, x: p.linalg.matrix_power(x, 3),
                          [SPD / 4], RED, True),
    "pinv": _case(lambda p, x: p.linalg.pinv(x), [M[:, :3]], RED),
    "multi_dot": _case(lambda p, x, y: p.linalg.multi_dot([x, y, x]),
                       [M, SPD], RED, True),
    "eigvalsh": _case(lambda p, x: p.tensor.linalg.eigvalsh(x), [SPD], RED),
    "matrix_rank": _case(lambda p, x: p.linalg.matrix_rank(x),
                         [np.concatenate([M[:3], M[:1] * 2])], EXACT),
    "histogram": _case(lambda p, x: p.histogram(x, bins=7), [A], EXACT),
    "histogram_range": _case(lambda p, x: p.histogram(x, 5, -1, 1), [A],
                             EXACT),
    "bincount": _case(lambda p, x: p.tensor.linalg.bincount(x, minlength=9),
                      [np.array([1, 3, 3, 0, 5], "int64")], EXACT),
    "bincount_weights": _case(
        lambda p, x, w: p.tensor.linalg.bincount(x, weights=w),
        [np.array([1, 3, 3, 0], "int64"), V], RED),
    "cov": _case(lambda p, x: p.tensor.linalg.cov(x), [M], RED, True),
    "cov_cols": _case(lambda p, x: p.tensor.linalg.cov(x, rowvar=False,
                                                       ddof=False),
                      [M], RED),
    "corrcoef": _case(lambda p, x: p.tensor.linalg.corrcoef(x), [M], RED),
    "cond": _case(lambda p, x: p.linalg.cond(x), [SPD], RED, True),
    "cond_fro": _case(lambda p, x: p.linalg.cond(x, "fro"), [SPD], RED),
    "cond_inf": _case(lambda p, x: p.linalg.cond(x, float("inf")), [M],
                      RED),
    "lstsq_full_rank": _case(lambda p, x, y: p.linalg.lstsq(x, y),
                             [np.concatenate([M, SPD]), M[:, :2].repeat(
                                 2, axis=0)], RED),
    "lstsq_rank_deficient": _case(
        lambda p, x, y: p.linalg.lstsq(x, y)[0],
        [np.concatenate([M[:, :2], M[:, :2] * 2], axis=1), M[:, :1]], RED),
})

# the common functionals
CASES.update({
    "unfold": _case(lambda p, x: p.nn.functional.unfold(x, [3, 2], [2, 1],
                                                        [1, 0, 2, 1], 1),
                    [IMG], ELEM, True),
    "fold": _case(lambda p, x: p.nn.functional.fold(x, [6, 7], 3, 2, 1),
                  [_RNG.normal(size=(2, 18, 12)).astype("float32")], RED,
                  True),
    "cosine_similarity": _case(
        lambda p, x, y: p.nn.functional.cosine_similarity(x, y, axis=2),
        [A, B], RED, True),
    "pixel_shuffle": _case(lambda p, x: p.nn.functional.pixel_shuffle(x, 2),
                           [_RNG.normal(size=(2, 8, 3, 5)).astype(
                               "float32")], ELEM, True),
    "pixel_unshuffle": _case(
        lambda p, x: p.nn.functional.pixel_unshuffle(x, 2), [IMG[:, :, :8]],
        ELEM, True),
    "normalize": _case(lambda p, x: p.nn.functional.normalize(x, p=3,
                                                              axis=1),
                       [A], RED, True),
    "label_smooth": _case(lambda p, x: p.nn.functional.label_smooth(x, epsilon=0.2),
                          [np.eye(5, dtype="float32")[[0, 3, 1]]], ELEM),
    "label_smooth_prior": _case(
        lambda p, x, q: p.nn.functional.label_smooth(x, q),
        [np.eye(4, dtype="float32")[[0, 3]], np.full((1, 4), 0.25,
                                                     "float32")]),
    "bilinear": _case(lambda p, x, y, w, b: p.nn.functional.bilinear(x, y, w,
                                                                     b),
                      [M[:, :3], SPD, A[:, :3, :4], V[:3]], RED, True),
    "affine_grid": _case(
        lambda p, t: p.nn.functional.affine_grid(t, [2, 3, 4, 5],
                                                 align_corners=False),
        [_RNG.normal(size=(2, 2, 3)).astype("float32")], RED, True),
    "affine_grid_corners": _case(
        lambda p, t: p.nn.functional.affine_grid(t, [2, 3, 5, 4]),
        [_RNG.normal(size=(2, 2, 3)).astype("float32")], RED),
})
for _pm in ("zeros", "border", "reflection"):
    for _ac in (True, False):
        CASES[f"grid_sample_{_pm}_{_ac}"] = _case(
            (lambda pm, ac: lambda p, x, g: p.nn.functional.grid_sample(
                x, g, padding_mode=pm, align_corners=ac))(_pm, _ac),
            [IMG, _RNG.uniform(-1.3, 1.3, (2, 5, 6, 2)).astype("float32")],
            RED, True)
CASES["grid_sample_nearest"] = _case(
    lambda p, x, g: p.nn.functional.grid_sample(x, g, mode="nearest"),
    [IMG, (np.round(_RNG.uniform(-1.2, 1.2, (2, 5, 6, 2)) * 8) / 8 + 1 / 32
           ).astype("float32")], RED)
for _mode in ("nearest", "bilinear", "bicubic"):
    # out − 1 odd on both axes: no align_corners sample falls on a
    # half-pixel, where the reference rounds the last bit of its f32
    # jnp.linspace (which XLA computes in its own way) half to even
    for _size in ((16, 14), (6, 4), (8, 24)):
        for _ac in ((False, True) if _mode != "bicubic" else (False,)):
            CASES[f"interpolate_{_mode}_{_size[0]}x{_size[1]}_{_ac}"] = _case(
                (lambda m, s, ac: lambda p, x: p.nn.functional.interpolate(
                    x, size=list(s), mode=m, align_corners=ac))(
                        _mode, _size, _ac),
                [IMG], RED, True)
CASES.update({
    "interpolate_scale_linear": _case(
        lambda p, x: p.nn.functional.interpolate(x, scale_factor=1.7,
                                                 mode="linear"),
        [A], RED, True),
    "interpolate_trilinear": _case(
        lambda p, x: p.nn.functional.interpolate(x, size=[3, 9, 4],
                                                 mode="trilinear"),
        [IMG[:, :, None, :5, :6].repeat(2, axis=2)], RED, True),
    "upsample_nearest": _case(
        lambda p, x: p.nn.functional.upsample(x, scale_factor=2), [IMG],
        RED),
})

# the differentiable subset whose gradients are compared
GRADS = {
    "unary_exp", "unary_log", "unary_rsqrt", "unary_tanh", "unary_erfinv",
    "unary_lgamma", "binary_maximum", "binary_atan2", "kron", "dot_2d",
    "addmm", "clip", "lerp", "trace", "logcumsumexp", "reduce_max_axis1",
    "reduce_min_all", "reduce_prod_axes_keep", "reduce_std_axis1",
    "reduce_var_all", "reduce_logsumexp_axes_keep", "cumprod", "stack",
    "tile", "expand", "gather", "gather_nd", "scatter", "scatter_add",
    "scatter_nd_add", "index_add", "masked_select", "where",
    "strided_slice", "repeat_interleave", "take_along_axis", "tensordot",
    "crop", "pad_reflect", "pad_circular", "meshgrid", "einsum", "sort",
    "topk_grad", "norm_axis", "dist", "cross_default_axis", "cholesky",
    "inv", "det", "solve", "cond", "unfold", "fold", "cosine_similarity",
    "normalize", "bilinear", "affine_grid", "grid_sample_zeros_True",
    "grid_sample_reflection_False", "interpolate_bilinear_6x4_False",
    "interpolate_bicubic_16x14_False", "interpolate_trilinear",
    "interpolate_nearest_8x24_False",
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    fn, arrays, tol, grad = CASES[name]
    grad = grad and name in GRADS
    (yj, gj), (yt, gt) = (_run(p, fn, arrays, grad)
                          for p in (paddle_tpu, paddle_tpu_torch))
    _compare(yj, yt, tol)
    if grad:
        assert len(gj) == len(gt)
        for a, b in zip(gj, gt):
            if a is None or b is None:
                # an input the output does not reach: None or zeros
                assert not np.any(a if b is None else b)
                continue
            np.testing.assert_allclose(
                b, a, rtol=tol[0], atol=tol[1] * max(1.0, np.abs(a).max()))


FACTORS = {
    "qr": lambda p, x: p.linalg.qr(x),
    "svd": lambda p, x: p.linalg.svd(x),
    "eigh": lambda p, x: p.linalg.eigh(x),
}


@pytest.mark.parametrize("name", sorted(FACTORS))
def test_factorization_matches_jax_up_to_signs(name):
    x = SPD if name == "eigh" else np.concatenate([M, SPD[:2]])
    fj, ft = (_np(FACTORS[name](p, p.to_tensor(x)))
              for p in (paddle_tpu, paddle_tpu_torch))
    for a, b in zip(fj, ft):
        np.testing.assert_allclose(np.abs(b), np.abs(a), rtol=1e-4,
                                   atol=1e-5)
    if name == "qr":
        recon = ft[0] @ ft[1]
    elif name == "svd":
        recon = ft[0] @ np.diag(ft[1]) @ ft[2]
    else:
        recon = ft[1] @ np.diag(ft[0]) @ ft[1].T
    np.testing.assert_allclose(recon, x, rtol=1e-4, atol=1e-4)


def test_eig_and_eigvals_match_jax():
    wj, _ = _np(paddle_tpu.linalg.eig(paddle_tpu.to_tensor(M)))
    wt, vt = _np(paddle_tpu_torch.linalg.eig(paddle_tpu_torch.to_tensor(M)))
    key = (lambda w: np.lexsort((np.round(w.imag, 4), np.round(w.real, 4))))
    np.testing.assert_allclose(wt[key(wt)], wj[key(wj)], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(M.astype(np.complex64) @ vt, vt * wt,
                               rtol=1e-4, atol=1e-4)
    ej = _np(paddle_tpu.linalg.eigvals(paddle_tpu.to_tensor(M)))
    et = _np(paddle_tpu_torch.linalg.eigvals(paddle_tpu_torch.to_tensor(M)))
    np.testing.assert_allclose(et[key(et)], ej[key(ej)], rtol=1e-4,
                               atol=1e-5)


def test_lu_factors_match_jax_and_pivots_are_one_based():
    lj, pj = _np(paddle_tpu.tensor.linalg.lu(paddle_tpu.to_tensor(M)))
    lt, pt, info = _np(paddle_tpu_torch.tensor.linalg.lu(
        paddle_tpu_torch.to_tensor(M), get_infos=True))
    np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(pt, pj + 1)
    assert int(info) == 0


def test_tensor_methods_and_aliases():
    tp = paddle_tpu_torch
    for name in ("exp", "max", "squeeze", "clip", "sigmoid", "argsort",
                 "topk", "norm", "tril", "t", "where", "cumsum", "unique",
                 "bitwise_and", "reshape_", "scatter_", "median", "pad"):
        assert callable(getattr(tp.Tensor, name)), name
    x = tp.to_tensor(A)
    assert x.dim() == 3 and int(x.rank()) == 3
    np.testing.assert_allclose(x.exp().max(axis=1).numpy(),
                               np.exp(A).max(axis=1), rtol=1e-6)
    np.testing.assert_array_equal(x.argmax(axis=2).numpy(),
                                  A.argmax(axis=2))
    assert isinstance(x.dtype, tp.dtype) and tp.complex64 is not None


def test_inplace_manipulation_matches_jax_and_refuses_a_grad_leaf():
    outs = []
    for p in (paddle_tpu, paddle_tpu_torch):
        leaf = p.to_tensor(A, stop_gradient=False)
        y = leaf * 1.0
        assert p.reshape_(y, [3, 20]) is y
        p.unsqueeze_(y, 0)
        p.squeeze_(y, 0)
        p.scatter_(y, p.to_tensor(np.array([1], "int64")),
                   p.to_tensor(B.reshape(3, 20)[:1]))
        p.tanh_(y)
        (y * p.to_tensor(np.arange(60, dtype="float32").reshape(3, 20))
         ).sum().backward()
        outs.append((y.numpy(), leaf.grad.numpy()))
        with pytest.raises(ValueError):
            p.reshape_(leaf, [60])
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


def test_creation_helpers():
    tp = paddle_tpu_torch
    p = tp.create_parameter([3, 4], "float32")
    assert isinstance(p, tp.Parameter) and not p.stop_gradient
    b = tp.create_parameter([4], "float32", is_bias=True)
    np.testing.assert_array_equal(b.numpy(), np.zeros(4, "float32"))
    tp.check_shape([2, -1, 3])
    for bad in ([2, -2], "x"):
        with pytest.raises((TypeError, ValueError)):
            tp.check_shape(bad)
    assert tp.broadcast_shape([3, 1, 5], [4, 1]) == [3, 4, 5]
    # Pad*D(int) pads every side of every spatial dimension, as Paddle's
    # does (the reference raises TypeError on an int)
    img = tp.to_tensor(IMG)
    assert tp.nn.Pad2D(2)(img).shape == [2, 3, 12, 14]
    assert tp.nn.Pad3D(1)(tp.unsqueeze(img, 2)).shape == [2, 3, 3, 10, 12]
    with pytest.raises(TypeError):
        paddle_tpu.nn.Pad2D(2)(paddle_tpu.to_tensor(IMG))
    assert tp.tolist(tp.to_tensor([[1, 2]])) == [[1, 2]]


def test_random_functionals_statistics():
    tp = paddle_tpu_torch
    F = tp.nn.functional
    tp.seed(3)
    x = tp.to_tensor(np.ones((64, 32, 6, 6), "float32"))
    y = F.dropout2d(x, p=0.25).numpy()
    per_channel = y.reshape(64, 32, -1)
    assert np.all(per_channel.min(-1) == per_channel.max(-1))
    assert set(np.unique(y)) <= {0.0, np.float32(1 / 0.75)}
    assert abs((y == 0).mean() - 0.25) < 0.03
    y3 = F.dropout3d(tp.to_tensor(np.ones((32, 16, 2, 3, 3), "float32")),
                     p=0.5).numpy().reshape(32, 16, -1)
    assert np.all(y3.min(-1) == y3.max(-1))
    assert abs((y3 == 0).mean() - 0.5) < 0.05
    np.testing.assert_array_equal(F.dropout2d(x, training=False).numpy(),
                                  x.numpy())
    z = tp.to_tensor(np.random.default_rng(4).normal(
        size=(400, 500)).astype("float32"))
    a = F.alpha_dropout(z, p=0.2).numpy()
    assert abs(a.mean()) < 0.02 and abs(a.std() - 1.0) < 0.02
    vals, counts = np.unique(a, return_counts=True)
    assert abs(counts.max() / a.size - 0.2) < 0.01     # the dropped value
    label = tp.to_tensor(np.array([11, 5, 1, 3, 12, 2, 5, 19], "int64"))
    remapped, centers = F.class_center_sample(label, 20, 10)
    c = centers.numpy()
    assert c.shape == (10,) and len(set(c)) == 10
    np.testing.assert_array_equal(c[:7], [1, 2, 3, 5, 11, 12, 19])
    np.testing.assert_array_equal(c[remapped.numpy()], label.numpy())
    r2, c2 = F.class_center_sample(label, 20, 4)
    np.testing.assert_array_equal(c2.numpy(), [1, 2, 3, 5, 11, 12, 19])


LAYER_CASES = {
    "Identity": (lambda p: p.nn.Identity(), [IMG]),
    "Flatten": (lambda p: p.nn.Flatten(), [IMG]),
    "Upsample": (lambda p: p.nn.Upsample(scale_factor=2, mode="bilinear"),
                 [IMG]),
    "UpsamplingNearest2D": (lambda p: p.nn.UpsamplingNearest2D(size=[5, 7]),
                            [IMG]),
    "UpsamplingBilinear2D": (lambda p: p.nn.UpsamplingBilinear2D(
        scale_factor=1.5), [IMG]),
    "CosineSimilarity": (lambda p: p.nn.CosineSimilarity(axis=2), [A, B]),
    "Pad1D": (lambda p: p.nn.Pad1D([2, 1], mode="reflect"), [A]),
    "Pad2D": (lambda p: p.nn.Pad2D([1, 0, 2, 1], mode="replicate"), [IMG]),
    "Pad3D": (lambda p: p.nn.Pad3D([1, 0, 1, 2, 0, 1], value=2.0),
              [IMG[:, :, None]]),
    "ZeroPad2D": (lambda p: p.nn.ZeroPad2D([1, 2, 0, 1]), [IMG]),
    "PixelShuffle": (lambda p: p.nn.PixelShuffle(2), [IMG[:, :, :4]
                                                      .repeat(4, axis=1)]),
    "PixelUnshuffle": (lambda p: p.nn.PixelUnshuffle(2), [IMG]),
    "Unfold": (lambda p: p.nn.Unfold(3, 1, 1), [IMG]),
    "Fold": (lambda p: p.nn.Fold([4, 5], 2),
             [_RNG.normal(size=(2, 12, 12)).astype("float32")]),
    "PairwiseDistance": (lambda p: p.nn.PairwiseDistance(3.0), [A, B]),
    "Dropout2D_p0": (lambda p: p.nn.Dropout2D(0.0), [IMG]),
    "Dropout3D_p0": (lambda p: p.nn.Dropout3D(0.0), [IMG[:, :, None]]),
    "AlphaDropout_p0": (lambda p: p.nn.AlphaDropout(0.0), [IMG]),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layer_matches_jax(name):
    build, arrays = LAYER_CASES[name]
    outs = [_np(build(p)(*[p.to_tensor(a) for a in arrays]))
            for p in (paddle_tpu, paddle_tpu_torch)]
    _compare(outs[0], outs[1], RED)


def test_bilinear_layer_with_carried_state_matches_jax():
    layers = [p.nn.Bilinear(3, 4, 5) for p in (paddle_tpu, paddle_tpu_torch)]
    state = {k: np.asarray(v.numpy()) for k, v in layers[0].state_dict()
             .items()}
    assert layers[1].set_state_dict(state) == ([], [])
    outs = [_np(layer(p.to_tensor(M[:, :3]), p.to_tensor(SPD)))
            for p, layer in zip((paddle_tpu, paddle_tpu_torch), layers)]
    _compare(outs[0], outs[1], RED)


def test_parameter_list_and_layer_dict():
    tp = paddle_tpu_torch
    ps = tp.nn.ParameterList([tp.create_parameter([2, 3], "float32")
                              for _ in range(3)])
    ps.append(tp.create_parameter([4], "float32"))
    assert len(ps) == 4 and ps[-1].shape == [4]
    assert [k for k, _ in ps.named_parameters()] == ["0", "1", "2", "3"]
    assert len(list(ps)) == 4
    d = tp.nn.LayerDict({"a": tp.nn.Linear(2, 3), "b": tp.nn.ReLU()})
    d["c"] = tp.nn.Tanh()
    assert list(d.keys()) == ["a", "b", "c"] and "b" in d and len(d) == 3
    assert sorted(d.state_dict()) == ["a.bias", "a.weight"]
    d.pop("b")
    assert list(d) == ["a", "c"]
    d.clear()
    assert len(d) == 0
    assert math.isfinite(float(tp.to_tensor(1.0)))
