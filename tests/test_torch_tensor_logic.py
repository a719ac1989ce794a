"""The port's Tensor operators and comparison/logical ops against
paddle_tpu's.

Every entry of the reference's ``_DUNDERS`` table
(``paddle_tpu/tensor/__init__.py``): each binary operator with two
Tensors in both orders and with a Python scalar on either side (a scalar
on the left reaches the reflected dunder or the swapped comparison; the
table has no reflected ``&``, ``|`` or ``^``, so both packages refuse a
scalar on their left), on
float, int and bool inputs where the operator takes them; the unary
``-``, ``abs()`` and ``~``; ``@``, ``[]`` and ``[]=``; then the new
functions of ``tensor/logic.py`` and ``tensor/math.py`` (``equal`` ...
``logical_not``, ``equal_all``, ``allclose``, ``isclose``,
``is_tensor``, ``floor_divide``, ``remainder``/``mod``, ``abs``), and
that ``hash()`` stays identity, so a Tensor is a dict key while ``==``
compares elements. Inputs from numpy with a seed; everything on the CPU.

Results agree in kind (bool, int or float) and value: bool and int
exactly, float to 1e-6 relative (the same f32 operation on two
backends; ``%`` and ``//`` of floats round alike). Integer widths differ
by design (the port's ``to_tensor`` of Python ints is int64, the JAX
package's int32), so an int result is compared by kind and value.
"""
import operator

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import device as tdevice
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

BINARY = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "truediv": operator.truediv, "floordiv": operator.floordiv,
    "mod": operator.mod, "pow": operator.pow,
    "eq": operator.eq, "ne": operator.ne, "lt": operator.lt,
    "le": operator.le, "gt": operator.gt, "ge": operator.ge,
    "and": operator.and_, "or": operator.or_, "xor": operator.xor,
}
ARITH = ("add", "sub", "mul", "truediv", "floordiv", "mod", "pow")
LOGICAL = ("eq", "ne", "and", "or", "xor")
SCALARS = {"float": 1.5, "int": 3, "bool": True}


@pytest.fixture(autouse=True)
def on_cpu():
    """The port's tensors go to the CPU for the test; the device setting
    is restored after."""
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old


def _inputs(kind, op):
    """Two (3, 4) numpy arrays of ``kind``; divisors kept away from zero,
    and pow's operands small and positive."""
    rng = np.random.default_rng(sum(map(ord, kind + op)))
    if kind == "bool":
        return [rng.random((3, 4)) < 0.5 for _ in range(2)]
    if kind == "int":
        lo = 1 if op == "pow" else -6
        hi = 4 if op == "pow" else 7
        a, b = (rng.integers(lo, hi, (3, 4)) for _ in range(2))
        return [np.where(x == 0, 5, x) for x in (a, b)]
    if op == "pow":
        return [rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32)
                for _ in range(2)]
    a, b = (rng.uniform(-4, 4, (3, 4)).astype(np.float32) for _ in range(2))
    return [np.where(np.abs(x) < 0.5, 0.75, x).astype(np.float32)
            for x in (a, b)]


def _kind(dtype_name):
    d = np.dtype(dtype_name)
    return "bool" if d == np.bool_ else d.kind


def _result(t):
    a = np.asarray(t.numpy())
    return _kind(a.dtype), a


def _same(want, got):
    (wk, w), (gk, g) = _result(want), _result(got)
    assert wk == gk, (wk, gk)
    assert w.shape == g.shape
    if wk == "f":
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(g, w)


def _cases():
    for op in BINARY:
        for kind in ("float", "int", "bool"):
            if kind == "bool" and op not in LOGICAL:
                continue
            if kind != "bool" and op in ("and", "or", "xor"):
                continue
            yield op, kind


@pytest.mark.parametrize("op,kind", list(_cases()))
def test_binary_operator_matches_jax(op, kind):
    a, b = _inputs(kind, op)
    s = SCALARS[kind]
    f = BINARY[op]
    ja, jb = paddle_tpu.to_tensor(a), paddle_tpu.to_tensor(b)
    ta, tb = paddle_tpu_torch.to_tensor(a), paddle_tpu_torch.to_tensor(b)
    for j, t in (((ja, jb), (ta, tb)), ((jb, ja), (tb, ta)),
                 ((ja, s), (ta, s)), ((s, ja), (s, ta))):
        if t[0] is s and op in ("and", "or", "xor"):
            # the table has no reflected & | ^: both packages refuse
            for operands in (j, t):
                with pytest.raises(TypeError):
                    f(*operands)
            continue
        got = f(*t)
        assert isinstance(got, paddle_tpu_torch.Tensor)
        _same(f(*j), got)


@pytest.mark.parametrize("kind", ["float", "int", "bool"])
def test_unary_operators_match_jax(kind):
    a, _ = _inputs(kind, "unary")
    ja, ta = paddle_tpu.to_tensor(a), paddle_tpu_torch.to_tensor(a)
    _same(~ja, ~ta)
    if kind != "bool":
        _same(-ja, -ta)
        _same(abs(ja), abs(ta))


def test_matmul_and_indexing_match_jax():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal((4, 5)).astype(np.float32)
    c = rng.standard_normal((5, 3)).astype(np.float32)
    j = [paddle_tpu.to_tensor(x) for x in (a, b, c)]
    t = [paddle_tpu_torch.to_tensor(x) for x in (a, b, c)]
    _same(j[0] @ j[1], t[0] @ t[1])
    _same(j[0].__rmatmul__(j[2]), t[0].__rmatmul__(t[2]))   # c @ a
    _same(j[0][1:, ::2], t[0][1:, ::2])
    j[0][0] = 7.0
    t[0][0] = 7.0
    _same(j[0], t[0])
    mask_j, mask_t = j[0] > 0, t[0] > 0
    _same(j[0][mask_j], t[0][mask_t])


def test_x_eq_3_is_a_bool_tensor():
    x = paddle_tpu_torch.to_tensor([0., 1., 2., 3., 4., 5.])
    want = [False, False, False, True, False, False]
    np.testing.assert_array_equal((x == 3).numpy(), want)
    np.testing.assert_array_equal((x != 3).numpy(), np.logical_not(want))
    np.testing.assert_array_equal(
        (x == 3).numpy(), paddle_tpu.to_tensor([0., 1., 2., 3., 4., 5.])
        .__eq__(3).numpy())


FUNCS = ["equal", "not_equal", "less_than", "less_equal", "greater_than",
         "greater_equal", "logical_and", "logical_or", "logical_xor",
         "floor_divide", "remainder", "mod"]


@pytest.mark.parametrize("name", FUNCS)
@pytest.mark.parametrize("kind", ["float", "int"])
def test_functions_match_jax(name, kind):
    a, b = _inputs(kind, name)
    want = getattr(paddle_tpu, name)(paddle_tpu.to_tensor(a),
                                     paddle_tpu.to_tensor(b))
    got = getattr(paddle_tpu_torch, name)(paddle_tpu_torch.to_tensor(a),
                                          paddle_tpu_torch.to_tensor(b))
    _same(want, got)
    # the method form, as the reference attaches it
    _same(want, getattr(paddle_tpu_torch.to_tensor(a), name)(
        paddle_tpu_torch.to_tensor(b)))


def test_unary_functions_and_predicates_match_jax():
    a, b = _inputs("float", "close")
    for name in ("abs", "logical_not"):
        _same(getattr(paddle_tpu, name)(paddle_tpu.to_tensor(a)),
              getattr(paddle_tpu_torch, name)(paddle_tpu_torch.to_tensor(a)))
    near = a + np.float32(1e-7)
    for other in (a, near, b):
        for name in ("equal_all", "allclose", "isclose"):
            _same(getattr(paddle_tpu, name)(paddle_tpu.to_tensor(a),
                                            paddle_tpu.to_tensor(other)),
                  getattr(paddle_tpu_torch, name)(
                      paddle_tpu_torch.to_tensor(a),
                      paddle_tpu_torch.to_tensor(other)))
    _same(paddle_tpu.isclose(paddle_tpu.to_tensor(a),
                             paddle_tpu.to_tensor(b), rtol=0.5, atol=1.0),
          paddle_tpu_torch.isclose(paddle_tpu_torch.to_tensor(a),
                                   paddle_tpu_torch.to_tensor(b), rtol=0.5,
                                   atol=1.0))
    short = paddle_tpu_torch.to_tensor(a[:2])
    assert not bool(paddle_tpu_torch.equal_all(
        paddle_tpu_torch.to_tensor(a), short))
    assert paddle_tpu_torch.is_tensor(short) and not \
        paddle_tpu_torch.is_tensor(a)


def test_hash_is_identity_and_tensors_are_dict_keys():
    x = paddle_tpu_torch.to_tensor([1., 2.])
    y = paddle_tpu_torch.to_tensor([1., 2.])
    assert hash(x) == id(x) and hash(y) == id(y)
    d = {x: "x", y: "y"}
    assert d[x] == "x" and d[y] == "y" and len({x, y, x}) == 2
    assert (x == y).numpy().all()
    # membership in a list would compare elements: the port goes by id()
    assert id(y) in {id(t) for t in (x, y)}


@pytest.mark.parametrize("dtype", ["int32", "int64", "bool"])
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("keepdim", [False, True])
def test_mean_of_int_and_bool_is_the_f32_mean(dtype, axis, keepdim):
    """``mean`` (and ``Tensor.mean``) of an int or bool input is its f32
    mean, as the reference's ``jnp.mean`` gives: 2.5 for [[1, 2], [3, 4]]
    and [1.5, 3.5] along axis 1."""
    if dtype == "bool":
        a = np.array([[True, False, True], [False, False, True]])
    else:
        a = np.array([[1, 2], [3, 4]], dtype=dtype)
    want = paddle_tpu.mean(paddle_tpu.to_tensor(a), axis=axis,
                           keepdim=keepdim)
    t = paddle_tpu_torch.to_tensor(a)
    for got in (paddle_tpu_torch.mean(t, axis=axis, keepdim=keepdim),
                t.mean(axis=axis, keepdim=keepdim)):
        assert str(got.dtype).endswith("float32")
        _same(want, got)
    if dtype == "int32":
        full = paddle_tpu_torch.mean(t)
        np.testing.assert_allclose(full.numpy(), 2.5)
        np.testing.assert_allclose(
            paddle_tpu_torch.mean(t, axis=1).numpy(), [1.5, 3.5])
