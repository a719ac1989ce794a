"""``paddle.Model`` prepared under ``paddle.enable_static()`` (the static
graph adapter, ``hapi/model.py``) against paddle_tpu's, on the CPU.

A LeNet from the JAX model's weights, ``Model(net, inputs=[InputSpec],
labels=[InputSpec])``: ``train_batch`` losses for 4 batches within 1e-5
relative of the JAX static Model's and of the port's dynamic Model's;
``eval_batch`` (loss and the Accuracy metric) and ``predict_batch``
within 1e-5; ``fit`` over a dataset drives the same program; a Model
without input specs in static mode raises.
"""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu import static as jstatic
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import static as tstatic
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

REL = 1e-5
BATCH = 16


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


_rng = np.random.default_rng(70)
XS = _rng.normal(size=(4 * BATCH, 1, 28, 28)).astype("float32")
YS = _rng.integers(0, 10, (4 * BATCH, 1)).astype("int64")


def _model(P, state, static):
    net = P.vision.models.LeNet()
    if state is not None:
        net.set_state_dict(state)
    if static:
        P.enable_static()
    try:
        model = P.Model(
            net, inputs=[P.static.InputSpec([None, 1, 28, 28], "float32",
                                            "image")],
            labels=[P.static.InputSpec([None, 1], "int64", "label")])
        model.prepare(P.optimizer.Adam(1e-3, parameters=net.parameters()),
                      P.nn.CrossEntropyLoss(), P.metric.Accuracy())
    finally:
        P.disable_static()
    return model, net


def _train(P, model):
    return [float(model.train_batch([P.to_tensor(XS[i:i + BATCH])],
                                    [P.to_tensor(YS[i:i + BATCH])])[0])
            for i in range(0, len(XS), BATCH)]


def _rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def test_static_model_trains_as_jax_and_as_dynamic():
    paddle_tpu.seed(1)
    jm, jnet = _model(paddle_tpu, None, static=True)
    state = {k: v.numpy() for k, v in jnet.state_dict().items()}
    tm, tnet = _model(paddle_tpu_torch, state, static=True)
    assert tm._static is not None
    dm, _ = _model(paddle_tpu_torch, state, static=False)
    jl, tl, dl = (_train(P, m) for P, m in ((paddle_tpu, jm),
                                            (paddle_tpu_torch, tm),
                                            (paddle_tpu_torch, dm)))
    assert _rel(tl, jl) <= REL, (tl, jl)
    assert _rel(tl, dl) <= REL, (tl, dl)
    # eval and predict through the eval program, after the same updates
    xe, ye = XS[:BATCH], YS[:BATCH]
    out = {}
    for P, m in ((paddle_tpu, jm), (paddle_tpu_torch, tm)):
        loss = m.eval_batch([P.to_tensor(xe)], [P.to_tensor(ye)])
        acc = m._metrics[0].accumulate()
        pred = m.predict_batch([P.to_tensor(xe)])
        out[P] = (loss[0], acc, np.asarray(pred[0]))
    (jl0, ja, jp), (tl0, ta, tp) = out[paddle_tpu], out[paddle_tpu_torch]
    assert abs(tl0 - jl0) <= REL * abs(jl0)
    assert ta == ja
    assert np.abs(tp - jp).max() <= REL * np.abs(jp).max()


def test_static_model_fit_runs_the_program():
    paddle_tpu_torch.seed(2)
    model, net = _model(paddle_tpu_torch, None, static=True)
    before = net.fc[0].weight.numpy().copy()
    data = paddle_tpu_torch.io.TensorDataset(
        [paddle_tpu_torch.to_tensor(XS), paddle_tpu_torch.to_tensor(YS)])
    model.fit(data, batch_size=BATCH, epochs=1, shuffle=False, verbose=0)
    assert not np.allclose(net.fc[0].weight.numpy(), before)
    exe = model._static["exe"]
    assert exe.last_run == {"captured": False, "reason": "cpu"}


def test_static_model_needs_input_specs():
    net = paddle_tpu_torch.vision.models.LeNet()
    paddle_tpu_torch.enable_static()
    with pytest.raises(ValueError, match="InputSpec"):
        paddle_tpu_torch.Model(net).prepare(
            paddle_tpu_torch.optimizer.Adam(1e-3,
                                            parameters=net.parameters()),
            paddle_tpu_torch.nn.CrossEntropyLoss())
