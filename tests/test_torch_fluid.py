"""``paddle_tpu_torch.fluid`` (the 1.x surface) against paddle_tpu's, on
the CPU: the cases of ``tests/test_fluid_compat.py``, each run through
both packages on the same inputs, weights carried from the JAX layers to
the port's by ``set_state_dict`` / ``set_value``. Values within 1e-5 of
the largest (1e-4 for a matmul's sums), integer outputs exactly; a draw
(dropout's training mask, nce's and sampled softmax's negatives) is
checked on its own terms, the packages' generators differing. Static
programs run on ``fluid.Executor(fluid.CPUPlace())``. Every test restores
dynamic mode and fresh default programs."""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu import static as jstatic
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import static as tstatic
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

PACKAGES = (paddle_tpu, paddle_tpu_torch)
TOL = 1e-5


@pytest.fixture(autouse=True)
def isolated():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    for P in PACKAGES:
        P.disable_static()
    tstatic.reset_default_programs()
    jstatic._default_main[0] = jstatic.Program()
    jstatic._default_startup[0] = jstatic.Program()
    tdevice._current[0] = old


def _np(v):
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


def _close(got, want, tol=TOL):
    got, want = np.asarray(_np(got), np.float64), np.asarray(_np(want),
                                                             np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max(initial=0.0) <= tol * max(
        np.abs(want).max(initial=0.0), 1e-30)


def _both(fn, tol=TOL):
    """``fn(P)`` for each package; every output compared."""
    want, got = (fn(P) for P in PACKAGES)
    assert len(want) == len(got)
    for g, w in zip(got, want):
        _close(g, w, tol)
    return got


def _rand(seed, *shape):
    return np.random.default_rng(seed).random(shape).astype("float32")


def test_fc_regression_script_trains_as_jax():
    """The canonical fluid 1.x static training block: 4 runs, the JAX
    program's weights carried in, losses within 1e-5."""
    rng = np.random.default_rng(41)
    feed = {"x": rng.random((8, 13)).astype("float32"),
            "y": rng.random((8, 1)).astype("float32")}
    losses = {}
    params = None
    for P in PACKAGES:
        fluid = P.fluid
        P.enable_static()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.data(name="x", shape=[-1, 13], dtype="float32")
            y = fluid.data(name="y", shape=[-1, 1], dtype="float32")
            hidden = fluid.layers.fc(x, size=32, activation="relu")
            pred = fluid.layers.fc(hidden, size=1)
            loss = fluid.layers.reduce_mean(
                fluid.layers.square_error_cost(pred, y))
            fluid.optimizer.SGDOptimizer(learning_rate=0.01).minimize(loss)
        P.disable_static()
        if params is None:
            params = [p.numpy() for p in main.all_parameters()]
        else:
            for p, a in zip(main.all_parameters(), params):
                p.set_value(a)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        losses[P] = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                     for _ in range(4)]
    assert losses[paddle_tpu][-1] < losses[paddle_tpu][0]
    np.testing.assert_allclose(losses[paddle_tpu_torch], losses[paddle_tpu],
                               rtol=1e-5)


def test_places_and_scope():
    fluid = paddle_tpu_torch.fluid
    assert fluid.CPUPlace() == paddle_tpu_torch.CPUPlace()
    assert fluid.CUDAPlace(0).get_device_id() == 0
    with fluid.scope_guard(fluid.Scope()) as _:
        v = fluid.global_scope().var("a")
        assert fluid.global_scope().find_var("a") is v
    assert fluid.global_scope().find_var("a") is None


def test_guard_linear_backward_minimize():
    x = np.random.default_rng(2).standard_normal((4, 5)).astype("float32")

    def run(P):
        fluid = P.fluid
        with fluid.dygraph.guard():
            P.seed(2)
            lin = fluid.dygraph.Linear(5, 3, act="relu")
            if P is paddle_tpu_torch:
                lin.set_state_dict(_run.state)
            else:
                _run.state = {k: v.numpy()
                              for k, v in lin.state_dict().items()}
            opt = fluid.optimizer.AdamOptimizer(
                learning_rate=0.1, parameters=lin.parameters())
            loss = fluid.layers.reduce_mean(
                lin(fluid.dygraph.to_variable(x)) ** 2)
            loss.backward()
            opt.minimize(loss)
            opt.clear_gradients()
            return [loss, lin.weight, lin.bias]

    _run = run
    _both(run)


def test_embedding_size_list_and_save_load(tmp_path):
    def run(P):
        fluid = P.fluid
        P.seed(3)
        emb = fluid.dygraph.Embedding(size=[10, 4])
        if P is paddle_tpu_torch:
            emb.set_state_dict(run.state)
        else:
            run.state = {k: v.numpy() for k, v in emb.state_dict().items()}
        out = emb(P.to_tensor(np.array([[1, 2], [3, 0]])))
        prefix = str(tmp_path / P.__name__)
        fluid.dygraph.save_dygraph(emb.state_dict(), prefix)
        params, opt = fluid.dygraph.load_dygraph(prefix)
        assert opt is None
        return [out, params["weight"]]

    _both(run)


def test_to_variable_and_enabled():
    fluid = paddle_tpu_torch.fluid
    v = fluid.dygraph.to_variable(np.ones(3, np.float32))
    assert isinstance(v, paddle_tpu_torch.Tensor)
    with fluid.dygraph.guard():
        assert fluid.dygraph.enabled() and fluid.framework.in_dygraph_mode()
    paddle_tpu_torch.enable_static()
    with fluid.dygraph.guard():
        assert fluid.dygraph.enabled()
    assert not fluid.dygraph.enabled()


def test_reduce_family_and_elementwise_axis():
    t, b = _rand(1, 2, 3, 4), _rand(2, 3)

    def run(P):
        L = P.fluid.layers
        x, y = P.to_tensor(t), P.to_tensor(b)
        return ([L.reduce_sum(x, dim=1), L.reduce_mean(x, dim=[1, 2],
                                                      keep_dim=True),
                 L.reduce_max(x), L.reduce_min(x, dim=-1),
                 L.reduce_prod(x, dim=0), L.reduce_all(x > 0.5, dim=1),
                 L.reduce_any(x > 0.9), L.mean(x)]
                + [getattr(L, f"elementwise_{k}")(x, y, axis=1)
                   for k in ("add", "sub", "mul", "div", "max", "min",
                             "pow")]
                + [L.elementwise_mul(x, y, axis=1, act="relu")])

    _both(run)


def test_cross_entropy_takes_probabilities():
    p = np.random.default_rng(4).dirichlet(np.ones(4), 3).astype("float32")

    def run(P):
        L = P.fluid.layers
        probs = P.to_tensor(p)
        lab = P.to_tensor(np.array([[1], [2], [3]]))
        return [L.cross_entropy(probs, lab),
                L.cross_entropy(probs, probs, soft_label=True),
                L.cross_entropy(probs, lab, ignore_index=2)]

    _both(run)


def test_mul_flatten_and_matmul_alpha():
    t, w, w2 = _rand(5, 2, 3, 4), _rand(6, 12, 7), _rand(7, 4, 5)
    a, b = _rand(8, 2, 3), _rand(9, 3, 2)

    def run(P):
        L = P.fluid.layers
        return [L.mul(P.to_tensor(t), P.to_tensor(w)),
                L.mul(P.to_tensor(t), P.to_tensor(w2), x_num_col_dims=2),
                L.matmul(P.to_tensor(a), P.to_tensor(b), alpha=2.0),
                L.matmul(P.to_tensor(a), P.to_tensor(a), transpose_y=True)]

    got = _both(run, 1e-4)
    assert list(got[1].shape) == [2, 3, 5]


def test_expand_flatten_fill_dropout_pool():
    t, img = _rand(10, 2, 3, 4), _rand(11, 1, 2, 8, 8)

    def run(P):
        L = P.fluid.layers
        x = P.to_tensor(t)
        return [L.expand(P.to_tensor(np.array([1.0, 2.0], "f4")), [3]),
                L.flatten(x, axis=2), L.flatten(x, axis=0),
                L.fill_constant([2, 2], "float32", 3.0),
                L.fill_constant_batch_size_like(x, [-1, 5], "float32", 1.0),
                L.dropout(P.ones([2, 8]), 0.5, is_test=True),
                L.pool2d(P.to_tensor(img), 2, "max", 2),
                L.pool2d(P.to_tensor(img), 3, "avg", 2, 1),
                L.pool2d(P.to_tensor(img), global_pooling=True),
                L.reshape(x, [4, -1], act="relu"),
                L.expand_as(P.to_tensor(np.ones((2, 1), "f4")), x[:, :, 0])]

    _both(run)


def test_dropout_training_keeps_the_rate():
    L = paddle_tpu_torch.fluid.layers
    out = L.dropout(paddle_tpu_torch.ones([100000]), 0.3,
                    dropout_implementation="upscale_in_train").numpy()
    keep = (out != 0).mean()
    assert abs(keep - 0.7) <= 5 * np.sqrt(0.21 / 100000)
    np.testing.assert_allclose(out[out != 0], 1 / 0.7, rtol=1e-6)


def test_misc_ops():
    t = _rand(12, 2, 3)

    def run(P):
        L = P.fluid.layers
        x = P.to_tensor(t)
        return [L.where(P.to_tensor(np.array([True, False, True]))),
                L.l2_normalize(x, axis=1), L.has_nan(x), L.has_inf(x),
                L.isfinite(x),
                L.clip_by_norm(P.to_tensor(np.array([3.0, 4.0], "f4")), 1.0),
                L.pad(x, [1, 1, 0, 2], pad_value=9.0),
                L.smooth_l1(x, x * 0.0, sigma=2.0),
                L.smooth_l1(P.zeros([1, 2]), P.ones([1, 2]),
                            outside_weight=P.to_tensor(
                                np.array([[0.0, 2.0]], "f4"))),
                L.sigmoid_cross_entropy_with_logits(
                    P.to_tensor(np.array([[2.0, -1.0]], "f4")),
                    P.to_tensor(np.array([[1.0, -100.0]], "f4")),
                    normalize=True),
                L.hard_sigmoid(x * 4 - 2), L.brelu(x * 30, 1.0, 20.0),
                L.soft_relu(x * 50 - 25, 10.0), L.relu_clipped(x * 9, 6.0),
                L.huber_loss(P.zeros([2, 1]),
                             P.to_tensor(np.array([[0.5], [3.0]], "f4")),
                             1.0),
                L.sums([x, x, x])]

    _both(run)


def test_array_ops():
    def run(P):
        L = P.fluid.layers
        arr = L.create_array("float32")
        i = P.to_tensor(np.array(0, np.int64))
        arr = L.array_write(P.ones([2]), i, arr)
        arr = L.array_write(P.ones([2]) * 2.0, 1, arr)
        out, sizes = L.tensor_array_to_tensor(arr, axis=0)
        return [L.array_read(arr, i), L.array_length(arr), out, sizes]

    _both(run)


def test_submodule_aliases():
    fluid = paddle_tpu_torch.fluid
    assert fluid.initializer.Xavier is fluid.initializer.XavierInitializer
    assert fluid.initializer.XavierInitializer is \
        paddle_tpu_torch.nn.initializer.XavierUniform
    assert fluid.regularizer.L2DecayRegularizer is fluid.regularizer.L2Decay
    assert fluid.clip.GradientClipByGlobalNorm(1.0) is not None
    for n in ["SGDOptimizer", "MomentumOptimizer", "AdamOptimizer",
              "AdamaxOptimizer", "RMSPropOptimizer", "FtrlOptimizer",
              "LambOptimizer", "LarsMomentumOptimizer",
              "AdadeltaOptimizer", "DecayedAdagradOptimizer"]:
        assert hasattr(fluid.optimizer, n), n
    w = fluid.initializer.NumpyArrayInitializer(np.arange(6.0))(
        (2, 3), None, "cpu")
    np.testing.assert_array_equal(w.numpy(), np.arange(6.0).reshape(2, 3))


def test_io_persistables_pair_and_the_inference_pair(tmp_path):
    fluid = paddle_tpu_torch.fluid
    paddle_tpu_torch.enable_static()
    main = fluid.Program()
    with fluid.program_guard(main):
        x = fluid.data(name="x", shape=[-1, 4], dtype="float32")
        y = fluid.layers.fc(x, size=3)
    paddle_tpu_torch.disable_static()
    exe = fluid.Executor(fluid.CPUPlace())
    feed = {"x": np.ones((2, 4), np.float32)}
    want = exe.run(main, feed=feed, fetch_list=[y])[0]
    d = str(tmp_path / "persist_dir")
    fluid.io.save_persistables(exe, d, main_program=main)
    for p in main.all_parameters():
        p.set_value(np.zeros(p.shape, "f4"))
    fluid.io.load_persistables(exe, d, main_program=main)
    np.testing.assert_array_equal(exe.run(main, feed=feed,
                                          fetch_list=[y])[0], want)
    with pytest.raises(NotImplementedError, match="item 11"):
        fluid.io.save_inference_model(str(tmp_path / "m"), ["x"], [y], exe)
    with pytest.raises(NotImplementedError, match="item 11"):
        fluid.io.load_inference_model(str(tmp_path / "m"), exe)
    with pytest.raises(NotImplementedError, match="item 9"):
        fluid.profiler.start_profiler("All")


def test_data_feeder():
    fluid = paddle_tpu_torch.fluid
    paddle_tpu_torch.enable_static()
    with fluid.program_guard(fluid.Program()):
        x = fluid.data(name="x", shape=[-1, 2], dtype="float32")
        y = fluid.data(name="y", shape=[-1, 1], dtype="float32")
    feeder = fluid.DataFeeder(feed_list=[x, y])
    jfeeder = paddle_tpu.fluid.DataFeeder(feed_list=["x", "y"])
    rows = [(np.full(2, i, np.float32), np.zeros(1, np.float32))
            for i in range(3)]
    got, want = feeder.feed(rows), jfeeder.feed(rows)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(TypeError):
        fluid.data_feeder.check_dtype("int32", "x", ["float32"], "op")
    fluid.data_feeder.check_dtype("float32", "x", ["float32"], "op")
    assert fluid.data_feeder.convert_dtype("float32") == "float32"


def test_backward_and_framework():
    fluid = paddle_tpu_torch.fluid
    paddle_tpu_torch.enable_static()
    main = fluid.Program()
    with fluid.program_guard(main):
        x = fluid.data(name="x", shape=[-1, 2], dtype="float32")
        loss = fluid.layers.reduce_mean(fluid.layers.fc(x, size=1))
        grads = fluid.backward.append_backward(loss)
        w = grads[0][0]
        (gw,) = fluid.backward.calc_gradient(loss, [w])
    assert len(grads) == 2 and not fluid.framework.in_dygraph_mode()
    paddle_tpu_torch.disable_static()
    xs = np.ones((4, 2), np.float32)
    a, b = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"x": xs}, fetch_list=[grads[0][1], gw])
    np.testing.assert_allclose(a, np.ones((2, 1)), rtol=1e-6)
    np.testing.assert_array_equal(a, b)


def test_save_dygraph_order_independent(tmp_path):
    lin = paddle_tpu_torch.nn.Linear(3, 2)
    opt = paddle_tpu_torch.optimizer.SGD(0.1, parameters=lin.parameters())
    fluid = paddle_tpu_torch.fluid
    fluid.dygraph.save_dygraph(lin.state_dict(), str(tmp_path / "m"))
    fluid.dygraph.save_dygraph(opt.state_dict(), str(tmp_path / "m"))
    params, _ = fluid.dygraph.load_dygraph(str(tmp_path / "m"))
    assert params and "weight" in params


def test_minimize_is_harvest_only():
    lin = paddle_tpu_torch.nn.Linear(3, 2)
    opt = paddle_tpu_torch.optimizer.SGD(0.5, parameters=lin.parameters())
    before = lin.weight.numpy().copy()
    opt.minimize(paddle_tpu_torch.sum(lin(paddle_tpu_torch.ones([1, 3]))))
    np.testing.assert_allclose(lin.weight.numpy(), before)
    loss = paddle_tpu_torch.sum(lin(paddle_tpu_torch.ones([1, 3])))
    loss.backward()
    opt.minimize(loss)
    assert not np.allclose(lin.weight.numpy(), before)


def test_fc_1x_spelling():
    fluid = paddle_tpu_torch.fluid
    paddle_tpu_torch.enable_static()
    with fluid.program_guard(fluid.Program()):
        x = fluid.data(name="x", shape=[-1, 4], dtype="float32")
        y = fluid.layers.fc(input=x, size=3, act="relu", param_attr=None,
                            bias_attr=None)
    assert y.shape[-1] == 3


def _carry(jl, tl):
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})


def test_functional_rnn_and_lstm():
    x, xs, u = _rand(13, 2, 5, 4), _rand(14, 5, 2, 4), _rand(15, 2, 4)
    cells = {}

    def run(P):
        L = P.fluid.layers
        cell = P.nn.GRUCell(4, 6)
        fw, bw = P.nn.LSTMCell(4, 3), P.nn.LSTMCell(4, 3)
        if P is paddle_tpu:
            cells.update(gru=cell, fw=fw, bw=bw)
        else:
            for k, c in (("gru", cell), ("fw", fw), ("bw", bw)):
                _carry(cells[k], c)
        out, state = L.rnn(cell, P.to_tensor(x))
        bout, _ = L.birnn(fw, bw, P.to_tensor(x))
        return [out, state, bout]

    _both(run)
    # lstm and lstm_unit make their weights per call: shapes and the
    # time-major layout
    L = paddle_tpu_torch.fluid.layers
    h0, c0 = paddle_tpu_torch.zeros([1, 2, 8]), paddle_tpu_torch.zeros(
        [1, 2, 8])
    o, h, c = L.lstm(paddle_tpu_torch.to_tensor(xs), h0, c0, 5, 8, 1)
    assert o.shape == [5, 2, 8] and h.shape == [1, 2, 8]
    hh, cc = L.lstm_unit(paddle_tpu_torch.to_tensor(u),
                         paddle_tpu_torch.zeros([2, 6]),
                         paddle_tpu_torch.zeros([2, 6]))
    assert hh.shape == [2, 6] and cc.shape == [2, 6]


def test_linear_chain_crf_pairs_with_decoding():
    emis = np.zeros((1, 3, 3), np.float32)
    emis[0, 0, 1] = emis[0, 1, 2] = emis[0, 2, 0] = 4.0
    trans = _rand(16, 5, 3)
    e2 = _rand(17, 2, 4, 3) * 3

    def run(P):
        L = P.fluid.layers
        lab = P.to_tensor(np.array([[1, 2, 0]]))
        cost = L.linear_chain_crf(P.to_tensor(emis), lab,
                                  P.to_tensor(trans))
        cost2 = L.linear_chain_crf(
            P.to_tensor(e2), P.to_tensor(np.array([[0, 1, 2, 1],
                                                   [2, 2, 0, 1]])),
            P.to_tensor(trans), length=P.to_tensor(np.array([4, 2])))
        path = L.crf_decoding(P.to_tensor(emis),
                              P.to_tensor(np.zeros((5, 3), "f4")),
                              length=P.to_tensor(np.array([3])))
        return [cost, cost2, path]

    got = _both(run)
    assert got[2].numpy()[0].tolist() == [1, 2, 0]


def test_ctc_greedy_decoder_and_metrics():
    probs = np.zeros((2, 5, 4), np.float32)
    for t, c in enumerate([1, 1, 3, 2, 2]):
        probs[0, t, c] = 5.0
    for t, c in enumerate([0, 3, 0, 0, 1]):
        probs[1, t, c] = 5.0

    def run(P):
        L = P.fluid.layers
        out, lens = L.ctc_greedy_decoder(P.to_tensor(probs), blank=3,
                                         padding_value=-1)
        miou, wrong, correct = L.mean_iou(
            P.to_tensor(np.array([[0, 1], [1, 1]])),
            P.to_tensor(np.array([[0, 1], [0, 1]])), 2)
        a = P.to_tensor(_rand(18, 4, 6))
        return [out, lens, miou, wrong, correct,
                L.cos_sim(a, a * 2.0 + 0.1)]

    got = _both(run)
    assert got[4].numpy().tolist() == [1, 2]


def test_detection_output_composes():
    pb = np.array([[0.1, 0.1, 0.5, 0.5], [0.4, 0.4, 0.9, 0.9]], np.float32)
    pbv = np.full((2, 4), 0.1, np.float32)
    loc = _rand(19, 1, 2, 4) * 0.1
    scores = np.array([[[0.1, 0.9], [0.3, 0.7]]], np.float32)

    def run(P):
        out, nums = P.fluid.layers.detection_output(
            P.to_tensor(loc), P.to_tensor(scores), P.to_tensor(pb),
            P.to_tensor(pbv), score_threshold=0.5)
        return [out, nums]

    got = _both(run)
    assert got[0].shape[1] == 6


def test_sampled_softmax_and_misc():
    x = _rand(20, 1, 4, 6, 6)
    e = _rand(21, 1, 5, 8)

    def run(P):
        L = P.fluid.layers
        t = P.to_tensor(x)
        return [L.shuffle_channel(t, 2),
                L.affine_channel(t, P.to_tensor(np.arange(4, dtype="f4")),
                                 P.to_tensor(np.ones(4, "f4"))),
                L.add_position_encoding(P.to_tensor(e), 0.5, 2.0),
                L.fsp_matrix(t, t * 2.0),
                *L.unique_with_counts(P.to_tensor(np.array([1, 1, 2, 5])))]

    _both(run)
    L = paddle_tpu_torch.fluid.layers
    logits = paddle_tpu_torch.to_tensor(_rand(22, 3, 50))
    lab = paddle_tpu_torch.to_tensor(np.array([[4], [7], [0]]))
    loss = L.sampled_softmax_with_cross_entropy(logits, lab, num_samples=10,
                                                seed=3)
    assert loss.shape == [3, 1] and np.isfinite(loss.numpy()).all()
    again = L.sampled_softmax_with_cross_entropy(logits, lab,
                                                 num_samples=10, seed=3)
    np.testing.assert_array_equal(loss.numpy(), again.numpy())


def test_lr_decay_functions_match_jax():
    def run(P):
        L = P.fluid.layers
        scheds = [L.exponential_decay(0.1, 10, 0.9),
                  L.exponential_decay(0.1, 10, 0.9, staircase=True),
                  L.natural_exp_decay(0.1, 10, 0.5),
                  L.inverse_time_decay(0.1, 10, 0.5),
                  L.piecewise_decay([10, 20], [0.1, 0.05, 0.01]),
                  L.polynomial_decay(0.1, 100),
                  L.cosine_decay(0.1, 10, 5), L.noam_decay(512, 40),
                  L.linear_lr_warmup(0.1, 10, 0.0, 0.1)]
        out = []
        for s in scheds:
            vals = []
            for _ in range(30):
                vals.append(s())
                s.step()
            out.append(np.array(vals))
        return out

    _both(run)


def test_guided_refusals_point_to_replacements():
    L = paddle_tpu_torch.fluid.layers
    with pytest.raises(NotImplementedError, match="padded-dense"):
        L.dynamic_lstm(None, 4)
    with pytest.raises(NotImplementedError, match="BeamSearchDecoder"):
        L.beam_search(None, None, None, None, None, 4)
    with pytest.raises(NotImplementedError, match="roi_align"):
        L.generate_mask_labels(None, None, None, None, None, None, None,
                               None)
    with pytest.raises(NotImplementedError, match="DataLoader"):
        L.py_reader(64, [[2]], ["float32"])
    for cls in (L.While, L.Switch, L.IfElse):
        with pytest.raises(NotImplementedError):
            cls(None)


def test_center_loss_and_chunk_eval():
    x = np.full((4, 3), 2.0, np.float32)
    x[1] += 1.0

    def run(P):
        L = P.fluid.layers
        lab = P.to_tensor(np.array([2, 2, 3, 3]))
        l1 = L.center_loss(P.to_tensor(x), lab, 6, 0.5,
                           param_attr="fluid_test_centers")
        l2 = L.center_loss(P.to_tensor(x), lab, 6, 0.5,
                           param_attr="fluid_test_centers")
        pred = P.to_tensor(np.array([[0, 2, 4, 1]]))
        seq = P.to_tensor(np.array([[4, 5, 6]]))
        ioe = P.to_tensor(np.array([[0, 1, 4]]))
        return ([l1, l2] + list(L.chunk_eval(pred, pred, "IOB", 2))
                + list(L.chunk_eval(seq, seq, "IOB", 3))
                + list(L.chunk_eval(ioe, ioe, "IOE", 2)))

    got = _both(run)
    assert float(got[1].numpy().mean()) < float(got[0].numpy().mean())


def test_teacher_student_and_rank_losses():
    z = _rand(23, 6, 1) * 4 - 2
    lab = np.array([[-2.0], [-1.0], [0.3], [1.4], [0.0], [1.0]], "f4")

    def run(P):
        L = P.fluid.layers
        t = P.to_tensor(z)
        r = P.to_tensor(_rand(24, 6, 1))
        return [L.teacher_student_sigmoid_loss(t, P.to_tensor(lab)),
                L.rank_loss(r, t, -t), L.margin_rank_loss(r * 2 - 1, t, -t),
                L.bpr_loss(P.to_tensor(_rand(25, 6, 10)),
                           P.to_tensor(np.arange(6).reshape(6, 1)))]

    _both(run)


def test_dygraph_layer_shims():
    x = _rand(26, 1, 2, 8, 8)

    def run(P):
        dy = P.fluid.dygraph
        t = P.to_tensor(x)
        layers = [dy.PRelu("channel", channel=2),
                  dy.BilinearTensorProduct(3, 5, 6),
                  dy.GRUUnit(18), dy.InstanceNorm(2)]
        if P is paddle_tpu:
            run.layers = layers
        else:
            for j, tl in zip(run.layers, layers):
                _carry(j, tl)
        pr, btp, gru, inorm = layers
        h, rh, gate = gru(P.to_tensor(_rand(27, 2, 18)), P.zeros([2, 6]))
        return [dy.Pool2D(2, "max", 2)(t), dy.Pool2D(2, "avg", 2)(t),
                dy.Flatten()(t), inorm(t), pr(t),
                btp(P.to_tensor(_rand(28, 2, 3)),
                    P.to_tensor(_rand(29, 2, 5))), h, rh, gate]

    got = _both(run)
    assert list(got[-1].shape) == [2, 18]


def test_dygraph_decay_aliases_modes_and_refusals():
    from paddle_tpu_torch.optimizer.lr import LRScheduler

    dy = paddle_tpu_torch.fluid.dygraph
    assert issubclass(dy.CosineDecay, LRScheduler)
    assert issubclass(dy.NoamDecay, LRScheduler)
    dy.disable_dygraph()
    assert not dy.enabled()
    dy.enable_dygraph()
    assert dy.enabled()
    with pytest.raises(NotImplementedError, match="LoD"):
        dy.TreeConv()
    with pytest.raises(NotImplementedError, match="item 9"):
        dy.start_gperf_profiler()
    lin = paddle_tpu_torch.nn.Linear(2, 2)
    dp = dy.DataParallel(lin)
    x = paddle_tpu_torch.ones([1, 2])
    np.testing.assert_array_equal(dp(x).numpy(), lin(x).numpy())
    assert dy.prepare_context() is None


def test_nce_seeded_negatives_advance():
    n = paddle_tpu_torch.fluid.dygraph.NCE(50, 4, seed=7, num_neg_samples=5)
    x = paddle_tpu_torch.to_tensor(_rand(30, 3, 4))
    lab = paddle_tpu_torch.to_tensor(np.array([[1], [2], [0]]))
    assert not np.allclose(n(x, lab).numpy(), n(x, lab).numpy())
