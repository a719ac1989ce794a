"""The port's vision models trained against paddle_tpu's, on the CPU,
with the JAX model's weights carried across by ``set_state_dict``
(numpy f32 arrays under its ``state_dict()`` names, batch-norm buffers
included) and inputs from numpy with a seed.

- LeNet, f32, batch 4: three Adam steps (``bench_lenet``'s optimizer);
  every loss within 1e-5 relative of the JAX run's;
- ``resnet18(num_classes=10)`` at 64×64, batch 2, f32: three Momentum
  steps (0.01, 0.9); losses within 1e-5 relative, and after them every
  batch-norm running statistic and every velocity slot within 1e-3 of
  its largest value (the first step's gradients agree within 3e-5 of
  each one's largest value, summed in another order; each update feeds
  the next step's difference, and after three steps the worst velocity
  is 3.3e-4 apart);
  Not 32×32: there layer4's batch norm normalizes N·H·W = 2 values a
  channel, x̂ = ±d / sqrt(d² + 4ε) for their difference d, which turns
  the two packages' 1e-6 summation differences into 1% where d is near
  0 (the first losses part by 2e-4). Not the rate 0.1: a batch of two
  is then fitted within two steps, the loss reaches 0 and the
  trajectories part;
- the same ResNet after ``amp.decorate(level="O2")`` with the loss under
  ``auto_cast(level="O2")``: one Momentum step's loss within 2e-2
  relative (bf16 activations through 20 conv / BN layers, each rounding
  once where the two sides' f32 sums differ in order);
- one ``BottleneckBlock`` with a downsample: output and every gradient,
  1e-5 of the largest value;
- ``resnet50()``'s ``state_dict``: the same names, shapes and dtypes as
  the JAX model's, buffers included (no compute), and the O2 dtypes.
"""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import device as tdevice
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

LOSS_REL = 1e-5
STATE_TOL = 1e-3
BF16_LOSS_REL = 2e-2


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old


def _close(want, got, tol):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert want.shape == got.shape
    err = np.abs(want - got).max()
    assert err <= tol * max(np.abs(want).max(), 0.1), err


def _carried(build):
    """The JAX model and the port's, holding the JAX model's weights."""
    paddle_tpu.seed(0)
    jm = build(paddle_tpu)
    tm = build(paddle_tpu_torch)
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jm.state_dict().items()}
    missing, unexpected = tm.set_state_dict(state)
    assert missing == [] and unexpected == []
    return jm, tm


def _train(paddle, model, opt, images, labels, steps, amp=False):
    losses = []
    for _ in range(steps):
        with paddle.amp.auto_cast(enable=amp, level="O2"):
            out = model(paddle.to_tensor(images))
        loss = paddle.nn.functional.cross_entropy(out,
                                                  paddle.to_tensor(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.astype("float32").numpy()))
    return losses


def _rel(want, got):
    return [abs(g - w) / abs(w) for w, g in zip(want, got)]


def test_lenet_adam_losses_match_jax():
    from paddle_tpu.vision.models import LeNet as JLeNet
    from paddle_tpu_torch.vision.models import LeNet as TLeNet

    jm, tm = _carried(lambda p: (JLeNet if p is paddle_tpu else TLeNet)())
    rng = np.random.default_rng(0)
    images = rng.normal(size=(4, 1, 28, 28)).astype("float32")
    labels = rng.integers(0, 10, (4,)).astype("int64")
    losses = [_train(p, m, p.optimizer.Adam(learning_rate=1e-3,
                                            parameters=m.parameters()),
                     images, labels, 3)
              for p, m in ((paddle_tpu, jm), (paddle_tpu_torch, tm))]
    assert max(_rel(*losses)) <= LOSS_REL, losses
    assert losses[1][-1] < losses[1][0]


def _resnet18(paddle):
    return paddle.vision.models.resnet18(num_classes=10)


@pytest.fixture(scope="module")
def resnet_batch():
    rng = np.random.default_rng(1)
    return (rng.normal(size=(2, 3, 64, 64)).astype("float32"),
            rng.integers(0, 10, (2,)).astype("int64"))


def test_resnet18_momentum_losses_stats_and_velocity_match_jax(
        resnet_batch):
    images, labels = resnet_batch
    jm, tm = _carried(_resnet18)
    runs = []
    for paddle, model in ((paddle_tpu, jm), (paddle_tpu_torch, tm)):
        opt = paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                        parameters=model.parameters())
        losses = _train(paddle, model, opt, images, labels, 3)
        stats = [(k, b.numpy()) for k, b in model.named_buffers()]
        vel = opt._accumulators["velocity"]
        slots = [(k, np.asarray(vel[id(p)] if paddle is paddle_tpu
                                else vel[id(p)].numpy()))
                 for k, p in model.named_parameters()]
        runs.append((losses, stats, slots))
    (jl, js, jv), (tl, ts, tv) = runs
    assert max(_rel(jl, tl)) <= LOSS_REL, (jl, tl)
    assert [k for k, _ in js] == [k for k, _ in ts] and len(js) == 40
    for (k, a), (_, b) in zip(js + jv, ts + tv):
        _close(a, b, STATE_TOL)
    assert not np.allclose(dict(ts)["bn1._mean"], 0.0)


def test_resnet18_o2_bf16_step_loss(resnet_batch):
    images, labels = resnet_batch
    jm, tm = _carried(_resnet18)
    losses = []
    for paddle, model in ((paddle_tpu, jm), (paddle_tpu_torch, tm)):
        model = paddle.amp.decorate(model, level="O2", dtype="bfloat16")
        opt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                        parameters=model.parameters())
        losses.append(_train(paddle, model, opt, images, labels, 1,
                             amp=True))
        assert str(model.fc.weight.dtype).endswith("bfloat16")
        assert str(model.bn1._mean.dtype).endswith("float32")
    assert max(_rel(*losses)) <= BF16_LOSS_REL, losses


def test_bottleneck_block_forward_backward_match_jax():
    from paddle_tpu.vision.models.resnet import BottleneckBlock as JBlock
    from paddle_tpu_torch.vision.models import BottleneckBlock as TBlock

    def build(paddle):
        nn = paddle.nn
        block = JBlock if paddle is paddle_tpu else TBlock
        down = nn.Sequential(nn.Conv2D(8, 16, 1, stride=2, bias_attr=False),
                             nn.BatchNorm2D(16))
        return block(8, 4, stride=2, downsample=down)

    jm, tm = _carried(build)
    x_np = np.random.default_rng(4).normal(size=(2, 8, 9, 9)).astype(
        "float32")

    def run(paddle, model):
        x = paddle.to_tensor(x_np)
        x.stop_gradient = False
        y = model(x)
        c = np.cos(np.arange(y.size, dtype=np.float32)).reshape(y.shape)
        (y * paddle.to_tensor(c)).sum().backward()
        return ([y.numpy(), x.grad.numpy()]
                + [p.grad.numpy() for p in model.parameters()]
                + [b.numpy() for b in model.buffers()])

    want = run(paddle_tpu, jm)
    got = run(paddle_tpu_torch, tm)
    assert len(want) == len(got) == 2 + 12 + 8
    for a, b in zip(want, got):
        _close(a, b, 1e-5)


def test_resnet50_state_dict_names_shapes_dtypes_match_jax():
    def spec(paddle):
        model = paddle.vision.models.resnet50()
        return [(k, tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in model.state_dict().items()]

    want, got = spec(paddle_tpu), spec(paddle_tpu_torch)
    assert want == got
    # 161 parameters, then the 53 batch norms' two buffers
    assert len(got) == 161 + 2 * 53
    assert got[-1][0] == "layer4.2.bn3._variance"
    with pytest.raises(RuntimeError, match="pretrained"):
        paddle_tpu_torch.vision.models.resnet50(pretrained=True)
