"""The port's recurrent layers (``nn/layer/rnn.py``) and sequence
functions (``nn/functional/sequence.py``) against paddle_tpu's, on the
CPU, from seeded numpy inputs; the JAX layer's state carried across by
``set_state_dict`` (numpy under its ``state_dict()`` names, every name
found).

- ``LSTM``, ``GRU`` and ``SimpleRNN`` at 2 layers, forward and
  bidirectional, both ``time_major`` settings, hidden 16, batch 3, T 7,
  rows at full length: outputs and final states within 1e-5, the
  gradients of a weighted sum of both (input and every parameter) within
  1e-4 of the largest;
- the three cells one step, with gradients; ``RNN`` and ``BiRNN`` over
  the JAX package's cells;
- ``sequence_length``, which the JAX package drops (no JAX oracle): a
  padded row's valid outputs and final state equal that row run alone at
  its own length, its padded outputs are 0, forward and reverse; ``RNN``
  over a cell of the user's freezes its states the same way;
- every ``sequence_*`` function and ``edit_distance``.
"""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import device as tdevice
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5
GRAD_TOL = 1e-4            # of the largest gradient
B, T, I, H = 3, 7, 8, 16


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old


def _close(want, got, tol=TOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert want.shape == got.shape, (want.shape, got.shape)
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(want - got).max() <= tol * max(scale, 1.0), \
        np.abs(want - got).max()


def _grad_close(want, got):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert want.shape == got.shape
    err = np.abs(want - got).max()
    assert err <= GRAD_TOL * max(np.abs(want).max(), 1e-6), err


def _carry(jax_layer, port_layer):
    state = {k: np.asarray(v.numpy()) for k, v in
             jax_layer.state_dict().items()}
    missing, unexpected = port_layer.set_state_dict(state)
    assert not missing and not unexpected, (missing, unexpected)


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _flat(t)]
    return [tree]


def _run(paddle, layer, x, weights, call=None):
    """Outputs, final states and the gradients of sum(out · w_i) over
    every output leaf, w.r.t. the input and each parameter
    (``call(x)`` runs the layer, by default ``layer(x)``)."""
    xt = paddle.to_tensor(x, stop_gradient=False)
    out, final = (call or layer)(xt)
    leaves = [out] + _flat(final)
    total = None
    for leaf, w in zip(leaves, weights):
        term = (leaf * paddle.to_tensor(w)).sum()
        total = term if total is None else total + term
    total.backward()
    grads = {"x": xt.grad.numpy()}
    grads.update({k: p.grad.numpy() for k, p in layer.named_parameters()})
    return [leaf.numpy() for leaf in leaves], grads


def _weights(rng, shapes):
    return [rng.normal(size=s).astype("float32") for s in shapes]


@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("mode", ["LSTM", "GRU", "SimpleRNN"])
def test_rnn_layer_matches_jax(mode, direction, time_major):
    rng = np.random.default_rng([len(mode), direction == "bidirect",
                                 time_major])
    shape = (T, B, I) if time_major else (B, T, I)
    x = rng.normal(size=shape).astype("float32")
    paddle_tpu.seed(0)
    jl = getattr(paddle_tpu.nn, mode)(I, H, 2, direction=direction,
                                      time_major=time_major)
    tl = getattr(paddle_tpu_torch.nn, mode)(I, H, 2, direction=direction,
                                            time_major=time_major)
    _carry(jl, tl)
    D = 2 if direction == "bidirect" else 1
    out_shape = shape[:2] + (D * H,)
    state_shapes = [(2 * D, B, H)] * (2 if mode == "LSTM" else 1)
    ws = _weights(rng, [out_shape] + state_shapes)
    want, wg = _run(paddle_tpu, jl, x, ws)
    got, tg = _run(paddle_tpu_torch, tl, x, ws)
    for a, b in zip(want, got):
        _close(a, b)
    assert set(wg) == set(tg)
    for k in wg:
        _grad_close(wg[k], tg[k])


@pytest.mark.parametrize("cell", ["LSTMCell", "GRUCell", "SimpleRNNCell",
                                  "SimpleRNNCell_relu"])
def test_cell_step_matches_jax(cell):
    rng = np.random.default_rng(5)
    name, kw = cell.split("_")[0], {}
    if cell.endswith("relu"):
        kw["activation"] = "relu"
    jc = getattr(paddle_tpu.nn, name)(I, H, **kw)
    tc = getattr(paddle_tpu_torch.nn, name)(I, H, **kw)
    _carry(jc, tc)
    x = rng.normal(size=(B, I)).astype("float32")
    h = rng.normal(size=(B, H)).astype("float32")
    c = rng.normal(size=(B, H)).astype("float32")
    ws = _weights(rng, [(B, H)] * 3)
    outs = []
    for paddle, layer in ((paddle_tpu, jc), (paddle_tpu_torch, tc)):
        st = paddle.to_tensor(h)
        if name == "LSTMCell":
            st = (st, paddle.to_tensor(c))
        outs.append(_run(paddle, layer, x, ws,
                         call=lambda xt, s=st, lay=layer: lay(xt, s)))
    (want, wg), (got, tg) = outs
    for a, b in zip(want, got):
        _close(a, b)
    for k in wg:
        _grad_close(wg[k], tg[k])


@pytest.mark.parametrize("wrapper", ["RNN", "BiRNN"])
def test_rnn_and_birnn_wrappers_match_jax(wrapper):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, T, I)).astype("float32")
    layers = []
    for paddle in (paddle_tpu, paddle_tpu_torch):
        nn = paddle.nn
        if wrapper == "RNN":
            layers.append(nn.RNN(nn.GRUCell(I, H), is_reverse=True))
        else:
            layers.append(nn.BiRNN(nn.LSTMCell(I, H), nn.LSTMCell(I, H)))
    _carry(*layers)
    shapes = ([(B, T, H), (B, H)] if wrapper == "RNN"
              else [(B, T, 2 * H)] + [(B, H)] * 4)
    ws = _weights(rng, shapes)
    (want, wg), (got, tg) = (_run(p, lay, x, ws) for p, lay in zip(
        (paddle_tpu, paddle_tpu_torch), layers))
    for a, b in zip(want, got):
        _close(a, b)
    for k in wg:
        _grad_close(wg[k], tg[k])


@pytest.mark.parametrize("mode", ["LSTM", "GRU", "SimpleRNN"])
def test_sequence_length_equals_each_row_alone(mode):
    """Paddle's sequence_length: row b's valid outputs and final state
    are those of row b run alone at its own length (both directions);
    its outputs at padded steps are 0."""
    rng = np.random.default_rng(7)
    lens = np.array([7, 4, 1])
    x = rng.normal(size=(B, T, I)).astype("float32")
    paddle_tpu_torch.seed(3)
    layer = getattr(paddle_tpu_torch.nn, mode)(I, H, 2, direction="bidirect")
    out, final = layer(paddle_tpu_torch.to_tensor(x),
                       sequence_length=paddle_tpu_torch.to_tensor(lens))
    out = out.numpy()
    finals = [f.numpy() for f in _flat(final)]
    for b, n in enumerate(lens):
        alone, alone_final = layer(paddle_tpu_torch.to_tensor(x[b:b + 1, :n]))
        np.testing.assert_allclose(out[b, :n], alone.numpy()[0], rtol=1e-6,
                                   atol=1e-6)
        assert not out[b, n:].any()
        for f, af in zip(finals, _flat(alone_final)):
            np.testing.assert_allclose(f[:, b], af.numpy()[:, 0], rtol=1e-6,
                                       atol=1e-6)


def test_sequence_length_with_a_cell_of_the_users():
    """RNN over a cell that is not one of the three built-in ones steps
    it in a loop; with sequence_length its states stop at each row's
    end and its padded outputs are 0."""
    nn = paddle_tpu_torch.nn

    class Doubling(nn.RNNCellBase):
        hidden_size = H

        def forward(self, x, states):
            new = states * 0.5 + paddle_tpu_torch.sum(x, axis=-1,
                                                      keepdim=True)
            return new, new

    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, T, I)).astype("float32")
    lens = np.array([2, 7, 5])
    out, final = nn.RNN(Doubling())(paddle_tpu_torch.to_tensor(x),
                                    sequence_length=paddle_tpu_torch
                                    .to_tensor(lens))
    h = np.zeros((B, H), np.float32)
    want = np.zeros((B, T, H), np.float32)
    for t in range(T):
        step = h * 0.5 + x[:, t].sum(-1, keepdims=True)
        live = (t < lens)[:, None]
        h = np.where(live, step, h)
        want[:, t] = np.where(live, h, 0.0)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(final.numpy(), h, rtol=1e-6, atol=1e-6)


def _seq_inputs():
    rng = np.random.default_rng(9)
    return {
        "x": rng.normal(size=(4, 6, 3)).astype("float32"),
        "x2": rng.normal(size=(4, 6)).astype("float32"),
        "lens": np.array([6, 3, 1, 4], "int64"),
        "ids": rng.integers(0, 9, (4, 6)).astype("int64"),
        "w": rng.normal(size=(9, 5)).astype("float32"),
        "base": rng.normal(size=(10, 3)).astype("float32"),
        "idx": rng.integers(0, 10, (4, 3)).astype("int64"),
        "upd": rng.normal(size=(4, 3, 3)).astype("float32"),
        "ulens": np.array([3, 1, 2, 0], "int64"),
        "off": np.array([0, 1, 0, 2], "int64"),
        "sl": np.array([3, 2, 1, 2], "int64"),
        "hyp": rng.integers(0, 4, (4, 7)).astype("int64"),
        "ref": rng.integers(0, 4, (4, 5)).astype("int64"),
    }


SEQ_CASES = {
    "sequence_mask": lambda p, d: [p.nn.functional.sequence_mask(
        d["lens"], maxlen=6)],
    "sequence_mask_nomaxlen": lambda p, d: [p.nn.functional.sequence_mask(
        d["lens"], dtype="float32")],
    "sequence_reverse": lambda p, d: [p.nn.functional.sequence_reverse(
        d["x"], d["lens"])],
    "sequence_softmax": lambda p, d: [p.nn.functional.sequence_softmax(
        d["x2"], d["lens"])],
    "sequence_expand": lambda p, d: [p.nn.functional.sequence_expand(
        d["x"], d["lens"])],
    "sequence_expand_as": lambda p, d: [p.nn.functional.sequence_expand_as(
        d["x2"], d["lens"])],
    "sequence_pool_sum": lambda p, d: [p.nn.functional.sequence_pool(
        d["x"], d["lens"], "sum")],
    "sequence_pool_average": lambda p, d: [p.nn.functional.sequence_pool(
        d["x"], d["lens"], "average")],
    "sequence_pool_sqrt": lambda p, d: [p.nn.functional.sequence_pool(
        d["x"], d["lens"], "sqrt")],
    "sequence_pool_max": lambda p, d: [p.nn.functional.sequence_pool(
        d["x"], d["lens"], "max")],
    "sequence_first_step": lambda p, d: [p.nn.functional
                                         .sequence_first_step(d["x"],
                                                              d["lens"])],
    "sequence_last_step": lambda p, d: [p.nn.functional.sequence_last_step(
        d["x"], d["lens"])],
    "sequence_concat": lambda p, d: list(p.nn.functional.sequence_concat(
        [d["x"], d["x"][:, :4]], [d["lens"], p.to_tensor(
            np.array([4, 2, 0, 1]))])),
    "sequence_enumerate": lambda p, d: [p.nn.functional.sequence_enumerate(
        d["ids"], 3, pad_value=-1)],
    "sequence_conv": lambda p, d: [p.nn.functional.sequence_conv(
        d["x"], d["lens"], d["w"])],
    "sequence_reshape": lambda p, d: list(p.nn.functional.sequence_reshape(
        d["x"], p.to_tensor(np.array([2, 4, 2, 6], "int64")), 1)),
    "sequence_scatter": lambda p, d: [p.nn.functional.sequence_scatter(
        d["base"], d["idx"], d["upd"], d["ulens"])],
    "sequence_slice": lambda p, d: list(p.nn.functional.sequence_slice(
        d["x"], d["off"], d["sl"])),
    "sequence_pad": lambda p, d: list(p.nn.functional.sequence_pad(
        [d["x"][0, :2], d["x"][1, :5]], 0.5)),
    "sequence_unpad": lambda p, d: p.nn.functional.sequence_unpad(
        d["x"], d["lens"]),
    "edit_distance": lambda p, d: list(p.nn.functional.edit_distance(
        d["hyp"], d["ref"], input_length=p.to_tensor(np.array([7, 3, 0, 5])),
        label_length=p.to_tensor(np.array([5, 5, 2, 1])))),
    "edit_distance_ignored": lambda p, d: list(p.nn.functional
                                              .edit_distance(
        d["hyp"], d["ref"], normalized=False, ignored_tokens=[0])),
}


@pytest.mark.parametrize("name", sorted(SEQ_CASES))
def test_sequence_function_matches_jax(name):
    outs = []
    for paddle in (paddle_tpu, paddle_tpu_torch):
        d = {k: paddle.to_tensor(v) for k, v in _seq_inputs().items()}
        outs.append([np.asarray(o.numpy()) for o in SEQ_CASES[name](paddle,
                                                                     d)])
    want, got = outs
    assert len(want) == len(got)
    for a, b in zip(want, got):
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b)
        else:
            _close(a, b)
