"""``paddle.static.nn`` on the CPU: every function recorded into a port
program, run by ``Executor(CPUPlace())``, against paddle_tpu's.

The JAX package's answer comes from its own program where it can record
the function, else from the function run eagerly (its sequence ops read
their lengths on the host). Parameters are carried from the JAX program
(or eager call) to the port's by ``set_value``, in the order each program
reaches them; where a function draws (nce's negatives) the port's
program is held to a numpy transcription of the formula with its own
draws. Outputs within 1e-5 of the largest value (1e-4 for the
reductions of a conv, a norm or a matmul), integer outputs exactly.
Each test restores dynamic mode and fresh default programs.
"""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu import static as jstatic
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import static as tstatic
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = {"elem": 1e-5, "reduce": 1e-4, "exact": 0.0}
RNG = np.random.default_rng(56)


@pytest.fixture(autouse=True)
def isolated():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    paddle_tpu.disable_static()
    paddle_tpu_torch.disable_static()
    tstatic.reset_default_programs()
    jstatic._default_main[0] = jstatic.Program()
    jstatic._default_startup[0] = jstatic.Program()
    tdevice._current[0] = old


def f32(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype("float32")


def ints(hi, *shape):
    return RNG.integers(0, hi, shape).astype("int64")


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _port_run(build, feed, jax_params):
    """The port's program of ``build`` with ``jax_params`` (numpy, in
    reach order) carried in; returns the fetched outputs."""
    paddle_tpu_torch.enable_static()
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        outs = _flat(build(paddle_tpu_torch, tstatic, feed))
    paddle_tpu_torch.disable_static()
    params = main.all_parameters()
    assert [tuple(p.shape) for p in params] == [
        tuple(a.shape) for a in jax_params]
    for p, a in zip(params, jax_params):
        p.set_value(a)
    exe = tstatic.Executor(paddle_tpu_torch.CPUPlace())
    return exe.run(main, feed=feed, fetch_list=outs)


def _jax_static(build, feed):
    paddle_tpu.enable_static()
    main = jstatic.Program()
    with jstatic.program_guard(main, jstatic.Program()):
        outs = _flat(build(paddle_tpu, jstatic, feed))
    params = [p.numpy() for p in main.all_parameters()]
    vals = jstatic.Executor().run(main, feed=feed, fetch_list=outs)
    paddle_tpu.disable_static()
    return vals, params


def _data(P, S, feed, name):
    a = feed[name]
    return S.data(name, list(a.shape), str(a.dtype))


def _check(got, want, kind):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (g.shape, w.shape)
        err = np.abs(g - w).max(initial=0.0)
        if kind == "exact":
            assert err == 0
        else:
            assert err <= TOL[kind] * max(np.abs(w).max(initial=0.0), 1e-30)


def _case(name, kind, feed, build):
    return pytest.param(kind, feed, build, id=name)


D = lambda P, S, feed, n: _data(P, S, feed, n)  # noqa: E731

STATIC_CASES = [
    _case("fc", "reduce", {"x": f32(16, 32)},
          lambda P, S, f: S.nn.fc(D(P, S, f, "x"), 8, activation="relu")),
    _case("fc_flatten", "reduce", {"x": f32(4, 3, 8)},
          lambda P, S, f: S.nn.fc(D(P, S, f, "x"), 5, num_flatten_dims=1)),
    _case("conv2d", "reduce", {"x": f32(2, 3, 10, 10)},
          lambda P, S, f: S.nn.conv2d(D(P, S, f, "x"), 4, 3, padding=1,
                                      act="relu")),
    _case("conv3d", "reduce", {"x": f32(2, 2, 6, 6, 6)},
          lambda P, S, f: S.nn.conv3d(D(P, S, f, "x"), 3, 3)),
    _case("conv2d_transpose", "reduce", {"x": f32(2, 4, 5, 5)},
          lambda P, S, f: S.nn.conv2d_transpose(D(P, S, f, "x"), 3,
                                                filter_size=3, stride=2)),
    _case("conv2d_transpose_output_size", "reduce", {"x": f32(2, 4, 5, 5)},
          lambda P, S, f: S.nn.conv2d_transpose(D(P, S, f, "x"), 3,
                                                output_size=11, stride=2)),
    _case("conv3d_transpose", "reduce", {"x": f32(1, 2, 3, 4, 4)},
          lambda P, S, f: S.nn.conv3d_transpose(D(P, S, f, "x"), 2,
                                                filter_size=2, stride=2)),
    _case("batch_norm_test", "reduce", {"x": f32(4, 3, 5, 5)},
          lambda P, S, f: S.nn.batch_norm(D(P, S, f, "x"), is_test=True)),
    _case("layer_norm", "reduce", {"x": f32(4, 6, 8)},
          lambda P, S, f: S.nn.layer_norm(D(P, S, f, "x"),
                                          begin_norm_axis=1)),
    _case("group_norm", "reduce", {"x": f32(2, 6, 4, 4)},
          lambda P, S, f: S.nn.group_norm(D(P, S, f, "x"), 3)),
    _case("instance_norm", "reduce", {"x": f32(2, 3, 5, 5)},
          lambda P, S, f: S.nn.instance_norm(D(P, S, f, "x"))),
    _case("data_norm", "elem", {"x": f32(8, 6)},
          lambda P, S, f: S.nn.data_norm(D(P, S, f, "x"))),
    _case("spectral_norm", "reduce", {"w": f32(6, 4)},
          lambda P, S, f: S.nn.spectral_norm(D(P, S, f, "w"),
                                             power_iters=3)),
    _case("embedding", "elem", {"i": ints(20, 4, 5)},
          lambda P, S, f: S.nn.embedding(D(P, S, f, "i"), [20, 8])),
    _case("sparse_embedding", "elem", {"i": ints(20, 4, 5)},
          lambda P, S, f: S.nn.sparse_embedding(D(P, S, f, "i"), [20, 8])),
    _case("prelu_all", "elem", {"x": f32(2, 3, 4, 4)},
          lambda P, S, f: S.nn.prelu(D(P, S, f, "x"), "all")),
    _case("prelu_channel", "elem", {"x": f32(2, 3, 4, 4)},
          lambda P, S, f: S.nn.prelu(D(P, S, f, "x"), "channel")),
    _case("prelu_element", "elem", {"x": f32(2, 3, 4, 4)},
          lambda P, S, f: S.nn.prelu(D(P, S, f, "x"), "element")),
    _case("bilinear_tensor_product", "reduce",
          {"x": f32(5, 4), "y": f32(5, 3)},
          lambda P, S, f: S.nn.bilinear_tensor_product(
              D(P, S, f, "x"), D(P, S, f, "y"), 6)),
    _case("row_conv", "reduce", {"x": f32(2, 7, 4)},
          lambda P, S, f: S.nn.row_conv(D(P, S, f, "x"), 2)),
    _case("deform_conv2d", "reduce",
          {"x": f32(1, 4, 6, 6), "o": f32(1, 18, 6, 6, scale=0.3),
           "m": RNG.random((1, 9, 6, 6)).astype("float32")},
          lambda P, S, f: S.nn.deform_conv2d(
              D(P, S, f, "x"), D(P, S, f, "o"), D(P, S, f, "m"), 5, 3,
              padding=1)),
]


@pytest.mark.parametrize("kind,feed,build", STATIC_CASES)
def test_static_nn_program_matches_jax(kind, feed, build):
    want, params = _jax_static(build, feed)
    got = _port_run(build, feed, params)
    _check(got, want, kind)


def _jax_eager(build, feed):
    outs = _flat(build(paddle_tpu, None, {k: paddle_tpu.to_tensor(v)
                                          for k, v in feed.items()}))
    return [o.numpy() for o in outs]


B, T, H = 3, 6, 4
SEQ = {"x": f32(B, T, H), "n": np.array([6, 3, 4], "int64")}
SEQ2 = {"x": f32(B, T), "n": np.array([6, 3, 4], "int64")}


def _seq(fn, *extra):
    """A sequence op on (x, lengths): in the port's program both are
    placeholders; the JAX reference runs it eagerly."""
    def build(P, S, f):
        if S is None:
            return fn(P, f["x"], f["n"], *extra)
        return fn(P, D(P, S, f, "x"), D(P, S, f, "n"), *extra)
    return build


def _seq_const(fn):
    """A sequence op whose output shape depends on the lengths: they are
    a constant of the port's program."""
    def build(P, S, f):
        n = P.to_tensor(SEQ["n"])
        if S is None:
            return fn(P, f["x"], n)
        return fn(P, D(P, S, f, "x"), n)
    return build


SEQ_CASES = [
    ("sequence_pool_sum", "reduce", SEQ,
     _seq(lambda P, x, n: P.static.nn.sequence_pool(x, n, "sum"))),
    ("sequence_pool_max", "elem", SEQ,
     _seq(lambda P, x, n: P.static.nn.sequence_pool(x, n, "max"))),
    ("sequence_pool_sqrt", "reduce", SEQ,
     _seq(lambda P, x, n: P.static.nn.sequence_pool(x, n, "sqrt"))),
    ("sequence_first_step", "elem", SEQ,
     _seq(lambda P, x, n: P.static.nn.sequence_first_step(x, n))),
    ("sequence_last_step", "elem", SEQ,
     _seq(lambda P, x, n: P.static.nn.sequence_last_step(x, n))),
    ("sequence_softmax", "elem", SEQ2,
     _seq(lambda P, x, n: P.static.nn.sequence_softmax(x, n))),
    ("sequence_reverse", "elem", SEQ,
     _seq(lambda P, x, n: P.static.nn.sequence_reverse(x, n))),
    ("sequence_conv", "reduce", SEQ,
     _seq(lambda P, x, n: P.static.nn.sequence_conv(
         x, n, P.to_tensor(np.linspace(-1, 1, 3 * H * 5).reshape(
             3 * H, 5).astype("float32"))))),
    ("sequence_enumerate", "exact", {"x": ints(9, B, T),
                                     "n": SEQ["n"]},
     lambda P, S, f: P.static.nn.sequence_enumerate(
         f["x"] if S is None else D(P, S, f, "x"), 2)),
    ("sequence_pad", "elem", SEQ,
     _seq_const(lambda P, x, n: P.static.nn.sequence_pad(x, 0.5,
                                                          lengths=n))),
    ("sequence_unpad", "elem", SEQ,
     _seq_const(lambda P, x, n: P.static.nn.sequence_unpad(x, n))),
    ("sequence_expand", "elem", {"x": f32(B, H), "n": SEQ["n"]},
     _seq_const(lambda P, x, n: P.static.nn.sequence_expand(x, n))),
    ("sequence_expand_as", "elem", {"x": f32(B, H), "n": SEQ["n"]},
     _seq_const(lambda P, x, n: P.static.nn.sequence_expand_as(x, n))),
    ("sequence_concat", "elem", SEQ,
     _seq_const(lambda P, x, n: P.static.nn.sequence_concat([x, x],
                                                            [n, n]))),
    ("sequence_reshape", "elem", SEQ,
     _seq_const(lambda P, x, n: P.static.nn.sequence_reshape(
         x, P.to_tensor(np.array([6, 2, 4], "int64")), 2))),
    ("sequence_slice", "elem", SEQ,
     _seq_const(lambda P, x, n: P.static.nn.sequence_slice(
         x, P.to_tensor(np.array([[1], [0], [2]], "int64")),
         P.to_tensor(np.array([[3], [2], [1]], "int64"))))),
    ("sequence_scatter", "elem",
     {"x": f32(5, H), "i": ints(5, B, 2), "u": f32(B, 2, H),
      "n": np.array([2, 1, 2], "int64")},
     lambda P, S, f: P.static.nn.sequence_scatter(
         *([f[k] for k in "xiun"] if S is None
           else [D(P, S, f, k) for k in "xiun"]))),
]


@pytest.mark.parametrize("name,kind,feed,build", SEQ_CASES,
                         ids=[c[0] for c in SEQ_CASES])
def test_sequence_op_in_a_program_matches_jax_eager(name, kind, feed, build):
    want = _jax_eager(build, feed)
    got = _port_run(build, feed, [])
    _check(got, want, kind)


def test_batch_norm_training_matches_jax_eager():
    """Training-mode batch_norm (batch statistics, the running ones
    updated in place at every run): the JAX program cannot record it, so
    its eager call is the reference (scale 1, shift 0 in both)."""
    feed = {"x": f32(4, 3, 5, 5)}

    def build(P, S, f):
        x = f["x"] if S is None else D(P, S, f, "x")
        return P.static.nn.batch_norm(x, act="relu")

    _check(_port_run(build, feed, [np.ones(3, "f4"), np.zeros(3, "f4")]),
           _jax_eager(build, feed), "reduce")


def test_multi_box_head_matches_jax():
    """The heads' convolutions through both programs (weights carried);
    the prior boxes and variances, build-time constants of the JAX
    program, against its returned values."""
    feed = {"a": f32(1, 4, 6, 6), "b": f32(1, 8, 3, 3),
            "img": f32(1, 3, 48, 48)}

    def heads(P, S, f):
        return S.nn.multi_box_head(
            [D(P, S, f, "a"), D(P, S, f, "b")], D(P, S, f, "img"), 48, 3,
            [[2.0], [2.0, 3.0]], min_ratio=20, max_ratio=90)

    paddle_tpu.enable_static()
    main = jstatic.Program()
    with jstatic.program_guard(main, jstatic.Program()):
        locs, confs, boxes, var = heads(paddle_tpu, jstatic, feed)
    params = [p.numpy() for p in main.all_parameters()]
    want = jstatic.Executor().run(main, feed=feed, fetch_list=[locs, confs])
    paddle_tpu.disable_static()
    got = _port_run(heads, feed, params)
    _check(got, want + [boxes.numpy(), var.numpy()], "reduce")


def test_crf_decoding_matches_jax():
    trans = f32(7, 5)
    feed = {"e": f32(3, 6, 5, scale=2.0), "n": np.array([6, 4, 1], "int64")}
    want = jstatic.nn.crf_decoding(paddle_tpu.to_tensor(feed["e"]),
                                   paddle_tpu.to_tensor(trans),
                                   length=paddle_tpu.to_tensor(feed["n"]))
    got = _port_run(lambda P, S, f: S.nn.crf_decoding(
        D(P, S, f, "e"), P.to_tensor(trans), length=D(P, S, f, "n")),
        feed, [])
    # the port keeps the full length (zero past each sequence's end),
    # JAX crops to the longest: equal on the longest's span
    np.testing.assert_array_equal(got[0][:, :want.shape[1]], want.numpy())


def test_nce_matches_its_formula_with_the_drawn_negatives():
    feed = {"x": f32(6, 4), "y": ints(30, 6, 1)}
    paddle_tpu_torch.enable_static()
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        out = tstatic.nn.nce(D(None, tstatic, feed, "x"),
                             D(None, tstatic, feed, "y"), 30,
                             num_neg_samples=5, seed=7)
    paddle_tpu_torch.disable_static()
    (got,) = tstatic.Executor(paddle_tpu_torch.CPUPlace()).run(
        main, feed=feed, fetch_list=[out])
    rec = main.ops[-1]
    w, b, neg = (a.tensor.numpy() for a in rec.args[2:5])
    x, lab = feed["x"], feed["y"][:, 0]
    log_noise = np.log(5 / 30)
    softplus = lambda z: np.log1p(np.exp(-np.abs(z))) + np.maximum(z, 0)  # noqa: E731
    pos = softplus(-((x * w[lab]).sum(-1) + b[lab] - log_noise))
    negl = softplus(x @ w[neg].T + b[neg] - log_noise).sum(-1)
    np.testing.assert_allclose(got[:, 0], pos + negl, rtol=1e-5)
    # a rebuilt program with the same seed draws the same negatives
    paddle_tpu_torch.enable_static()
    main2 = tstatic.Program()
    with tstatic.program_guard(main2, tstatic.Program()):
        tstatic.nn.nce(D(None, tstatic, feed, "x"),
                       D(None, tstatic, feed, "y"), 30, num_neg_samples=5,
                       seed=7)
    paddle_tpu_torch.disable_static()
    np.testing.assert_array_equal(main2.ops[-1].args[4].tensor.numpy(), neg)


def test_py_func_runs_on_the_host_and_marks_the_program():
    feed = {"x": f32(4, 3)}
    paddle_tpu_torch.enable_static()
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        tmpl = paddle_tpu_torch.zeros([4, 3], "float32")
        out = tstatic.nn.py_func(lambda a: np.sin(a) * 2.0,
                                 D(None, tstatic, feed, "x"), tmpl)
    paddle_tpu_torch.disable_static()
    exe = tstatic.Executor(paddle_tpu_torch.CPUPlace())
    (got,) = exe.run(main, feed=feed, fetch_list=[out])
    np.testing.assert_allclose(got, np.sin(feed["x"]) * 2.0, rtol=1e-6)
    assert getattr(main.ops[-1].fn, "host_read", False)
    with pytest.raises(NotImplementedError):
        tstatic.nn.py_func(lambda a: a, out, tmpl, backward_func=abs)


def test_every_static_nn_name_is_covered():
    covered = ({c.id for c in STATIC_CASES} | {c[0] for c in SEQ_CASES}
               | {"crf_decoding", "nce", "py_func", "batch_norm",
                  "multi_box_head"})
    control = {"cond", "while_loop", "case", "switch_case"}  # test_torch_static
    for name in tstatic.nn.__all__:
        assert name in control or any(
            c == name or c.startswith(name + "_") for c in covered), name
