"""The port's eager Paddle surface (``import paddle_tpu_torch as paddle``)
against paddle_tpu's.

Tensor semantics (``to_tensor``, ``stop_gradient``, ``backward`` and
gradient accumulation, ``paddle.grad``, ``no_grad``), the layers
(Linear, LayerNorm, Embedding, MultiHeadAttention, pre- and post-LN
TransformerEncoderLayer) forward and gradients with the JAX layer's
weights carried across by ``set_state_dict``, ``F.cross_entropy``, the
state_dict names, the device rule, and that every name the port exports
exists in paddle_tpu's namespace. Everything runs on the CPU, f32;
inputs from numpy with a seed.

Tolerance 1e-5 of the largest reference value, or 1e-6 absolute where
that value is below 0.1 (the same f32 math on two backends, summed in
another order; a gradient that is zero in exact arithmetic, such as the
key bias's under softmax, is summation noise of ~5e-7 on both).
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import device as tdevice
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5


@pytest.fixture(autouse=True)
def on_cpu():
    """The port's tensors go to the CPU for the test; the device setting
    is restored after."""
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old


def _close(want, got, tol=TOL):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert want.shape == got.shape
    assert np.abs(want - got).max() <= tol * max(np.abs(want).max(), 0.1)


def _both(fn):
    """fn(paddle) on each package."""
    return fn(paddle_tpu), fn(paddle_tpu_torch)


def test_tensor_autograd_semantics():
    x_np = np.random.default_rng(0).standard_normal((3, 4)).astype(
        np.float32)

    def run(paddle):
        x = paddle.to_tensor(x_np)
        assert x.stop_gradient and x.grad is None
        x.stop_gradient = False
        c = paddle.to_tensor(x_np * 2)
        y = (x * x + 3.0 * x - c).sum()
        assert not y.stop_gradient
        y.backward()
        g1 = x.grad.numpy()
        (x * x).sum().backward()            # accumulates
        g2 = x.grad.numpy()
        x.clear_grad()
        assert x.grad is None
        (gx,) = paddle.grad([(x * c).mean()], [x])
        assert x.grad is None               # paddle.grad leaves .grad alone
        with paddle.no_grad():
            z = x * 2.0
        assert z.stop_gradient
        d = (x * 2.0).detach()
        assert d.stop_gradient
        return g1, g2, gx.numpy(), y.numpy(), x.shape, str(x.dtype)

    (j1, j2, jg, jy, jshape, _), (t1, t2, tg, ty, tshape, tdt) = _both(run)
    assert jshape == tshape == [3, 4] and tdt == "torch.float32"
    for want, got in ((j1, t1), (j2, t2), (jg, tg), (jy, ty)):
        _close(want, got)


def _carry(jlayer, tlayer):
    missing, unexpected = tlayer.set_state_dict(
        {k: v.numpy() for k, v in jlayer.state_dict().items()})
    assert not missing and not unexpected


def _fwd_bwd(paddle, layer, inputs, dout, int_input=False):
    """out, input grads, param grads of sum(layer(*inputs) * dout)."""
    xs = [paddle.to_tensor(a, stop_gradient=int_input) for a in inputs]
    out = layer(*xs)
    (out * paddle.to_tensor(dout)).sum().backward()
    grads = {k: p.grad.numpy() for k, p in layer.named_parameters()}
    return (out.numpy(), [None if int_input else x.grad.numpy()
                          for x in xs], grads)


LAYERS = {
    "linear": (lambda nn: nn.Linear(16, 24), [(5, 16)], (5, 24)),
    "layernorm": (lambda nn: nn.LayerNorm(16), [(2, 5, 16)], (2, 5, 16)),
    "mha": (lambda nn: nn.MultiHeadAttention(32, 4), [(2, 7, 32)] * 3,
            (2, 7, 32)),
    "encoder_post_ln": (lambda nn: nn.TransformerEncoderLayer(
        32, 4, 64, dropout=0.0, activation="gelu"), [(2, 7, 32)], (2, 7, 32)),
    "encoder_pre_ln": (lambda nn: nn.TransformerEncoderLayer(
        32, 4, 64, dropout=0.0, activation="relu", normalize_before=True),
        [(2, 7, 32)], (2, 7, 32)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_forward_and_grads_match_jax(name):
    build, in_shapes, out_shape = LAYERS[name]
    rng = np.random.default_rng(1)
    inputs = [rng.standard_normal(s).astype(np.float32) for s in in_shapes]
    dout = rng.standard_normal(out_shape).astype(np.float32)
    paddle_tpu.seed(3)
    jl, tl = build(paddle_tpu.nn), build(paddle_tpu_torch.nn)
    _carry(jl, tl)
    (jo, jx, jg), (to, tx, tg) = (_fwd_bwd(p, layer, inputs, dout)
                                  for p, layer in ((paddle_tpu, jl),
                                                   (paddle_tpu_torch, tl)))
    _close(jo, to)
    for a, b in zip(jx, tx):
        _close(a, b)
    assert list(jg) == list(tg)
    for k in jg:
        _close(jg[k], tg[k])


def test_embedding_matches_jax():
    ids = np.random.default_rng(2).integers(0, 50, (3, 6))
    dout = np.random.default_rng(3).standard_normal((3, 6, 8)).astype(
        np.float32)
    paddle_tpu.seed(4)
    jl = paddle_tpu.nn.Embedding(50, 8, padding_idx=0)
    tl = paddle_tpu_torch.nn.Embedding(50, 8, padding_idx=0)
    _carry(jl, tl)
    (jo, _, jg), (to, _, tg) = (_fwd_bwd(p, layer, [ids], dout,
                                         int_input=True)
                                for p, layer in ((paddle_tpu, jl),
                                                 (paddle_tpu_torch, tl)))
    _close(jo, to)
    _close(jg["weight"], tg["weight"])


@pytest.mark.parametrize("ignore", [False, True])
def test_cross_entropy_matches_jax(ignore):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 9, 30)).astype(np.float32)
    labels = rng.integers(0, 30, (4, 9))
    if ignore:
        labels[:, :3] = -100

    def run(paddle):
        x = paddle.to_tensor(logits, stop_gradient=False)
        loss = paddle.nn.functional.cross_entropy(x, paddle.to_tensor(labels))
        loss.backward()
        return loss.numpy(), x.grad.numpy()

    (jl, jg), (tl, tg) = _both(run)
    _close(jl, tl)
    _close(jg, tg)


def test_state_dict_names_match_jax():
    def names(paddle):
        nn = paddle.nn
        enc = nn.TransformerEncoder(nn.TransformerEncoderLayer(
            32, 4, 64, dropout=0.0), 2)
        return [(k, v.shape) for k, v in enc.state_dict().items()]

    want, got = _both(names)
    assert want == got
    assert "layers.1.self_attn.q_proj.weight" in dict(got)


def test_tensors_go_to_the_card_unless_cpu_was_set():
    tdevice._current[0] = None
    if torch.cuda.is_available():
        assert paddle_tpu_torch.to_tensor([1.0]).place.type == "cuda"
        assert paddle_tpu_torch.get_device().startswith("gpu")
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            paddle_tpu_torch.to_tensor([1.0])
        with pytest.raises(RuntimeError, match="CUDA"):
            paddle_tpu_torch.nn.Linear(2, 2)
        with pytest.raises(RuntimeError, match="CUDA"):
            paddle_tpu_torch.set_device("gpu")
    paddle_tpu_torch.set_device("cpu")
    assert paddle_tpu_torch.to_tensor([1.0]).place.type == "cpu"
    assert paddle_tpu_torch.get_device() == "cpu"


# the port's device rule (not a Paddle name) and its MoE routing functions,
# which paddle_tpu keeps in paddle_tpu.nn.moe
_PORT_ONLY = {"resolve_device", "__version__"}
_MOE = {"moe_capacity", "moe_ffn", "moe_route"}


@pytest.mark.parametrize("module", ["", ".nn", ".nn.functional",
                                    ".optimizer", ".ops"])
def test_every_exported_name_exists_in_paddle_tpu(module):
    port = importlib.import_module("paddle_tpu_torch" + module)
    jax_side = importlib.import_module("paddle_tpu" + module)
    for name in port.__all__:
        if name in _PORT_ONLY:
            continue
        where = (importlib.import_module("paddle_tpu.nn.moe")
                 if name in _MOE else jax_side)
        assert hasattr(where, name), f"paddle_tpu{module} lacks {name}"
