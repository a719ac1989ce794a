"""The port's Transformer decoder, ``Transformer`` and the attention
caches (``nn/layer/transformer.py``) against paddle_tpu's, on the CPU, at
d_model 16, 2 heads, feed-forward 32, 2 layers, batch 2, target 5,
source 7, dropout 0, the JAX layers' state carried by
``set_state_dict``:

- ``TransformerDecoder`` and ``Transformer`` (pre- and post-LN), forward
  within 1e-5 and the gradients of a weighted sum (inputs and every
  parameter) within 1e-4 of the largest;
- a step-by-step decode through ``gen_cache`` (the self-attention's
  growing ``Cache``, the cross-attention's ``StaticCache``) equal to the
  JAX one and to the full causal pass; the encoder's caches likewise;
- ``MultiHeadAttention`` with each kind of cache.
"""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import device as tdevice

D, NH, FF, L, B, TGT, SRC = 16, 2, 32, 2, 2, 5, 7
TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old


def _carry(jl, tl):
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    missing, unexpected = tl.set_state_dict(state)
    assert not missing and not unexpected, (missing, unexpected)


def _close(want, got, tol=TOL):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape
    err = np.abs(want - got).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), err


def _decoder(paddle, normalize_before):
    nn = paddle.nn
    return nn.TransformerDecoder(
        nn.TransformerDecoderLayer(D, NH, FF, dropout=0.0,
                                   normalize_before=normalize_before), L,
        nn.LayerNorm(D) if normalize_before else None)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, TGT, D)).astype("float32"),
            rng.normal(size=(B, SRC, D)).astype("float32"),
            rng.normal(size=(B, TGT, D)).astype("float32"))


def _causal(paddle):
    return paddle.nn.Transformer.generate_square_subsequent_mask(TGT)


def _fwd_bwd(paddle, layer, call, arrays, w):
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    out = call(layer, *ts)
    (out * paddle.to_tensor(w)).sum().backward()
    grads = [t.grad.numpy() for t in ts]
    grads += [p.grad.numpy() for _, p in layer.named_parameters()]
    return out.numpy(), grads


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("which", ["TransformerDecoder", "Transformer"])
def test_forward_and_gradients_match_jax(which, normalize_before):
    tgt, mem, w = _inputs()
    layers = []
    for paddle in (paddle_tpu, paddle_tpu_torch):
        paddle_tpu.seed(1)
        if which == "Transformer":
            layers.append(paddle.nn.Transformer(
                D, NH, L, L, FF, dropout=0.0,
                normalize_before=normalize_before))
        else:
            layers.append(_decoder(paddle, normalize_before))
    _carry(*layers)
    outs = []
    for paddle, layer in zip((paddle_tpu, paddle_tpu_torch), layers):
        mask = _causal(paddle)
        if which == "Transformer":
            call = lambda lay, t, m, mk=mask: lay(m, t, tgt_mask=mk)  # noqa: E731
        else:
            call = lambda lay, t, m, mk=mask: lay(t, m, mk)  # noqa: E731
        outs.append(_fwd_bwd(paddle, layer, call, [tgt, mem], w))
    (want, wg), (got, tg) = outs
    _close(want, got)
    assert len(wg) == len(tg)
    for a, b in zip(wg, tg):
        _close(a, b, GRAD_TOL)


def _incremental(paddle, dec, tgt, mem):
    t_tgt, t_mem = paddle.to_tensor(tgt), paddle.to_tensor(mem)
    with paddle.no_grad():
        full = dec(t_tgt, t_mem, _causal(paddle)).numpy()
        cache = dec.gen_cache(t_mem)
        steps = []
        for t in range(TGT):
            out, cache = dec(t_tgt[:, t:t + 1], t_mem, None, None, cache)
            steps.append(out.numpy())
    return full, np.concatenate(steps, 1)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_incremental_decode_equals_jax_and_the_full_pass(normalize_before):
    tgt, mem, _ = _inputs(3)
    paddle_tpu.seed(2)
    jd = _decoder(paddle_tpu, normalize_before)
    td = _decoder(paddle_tpu_torch, normalize_before)
    _carry(jd, td)
    j_full, j_inc = _incremental(paddle_tpu, jd, tgt, mem)
    t_full, t_inc = _incremental(paddle_tpu_torch, td, tgt, mem)
    _close(j_inc, t_inc)
    _close(t_full, t_inc)
    _close(j_full, t_full)


def test_encoder_caches_match_jax():
    """TransformerEncoder with caches: each step's self-attention sees
    the steps before it through the layer's growing Cache."""
    x = _inputs(4)[0]
    encs = []
    for paddle in (paddle_tpu, paddle_tpu_torch):
        nn = paddle.nn
        encs.append(nn.TransformerEncoder(
            nn.TransformerEncoderLayer(D, NH, FF, dropout=0.0), L))
    _carry(*encs)
    outs = []
    for paddle, enc in zip((paddle_tpu, paddle_tpu_torch), encs):
        t = paddle.to_tensor(x)
        cache = enc.gen_cache(t)
        steps = []
        with paddle.no_grad():
            for i in range(TGT):
                out, cache = enc(t[:, i:i + 1], None, cache)
                steps.append(out.numpy())
        outs.append((np.concatenate(steps, 1), cache[0].k.numpy()))
    for a, b in zip(*outs):
        _close(a, b)
    assert outs[1][1].shape == (B, NH, TGT, D // NH)


@pytest.mark.parametrize("kind", ["Cache", "StaticCache"])
def test_multi_head_attention_caches_match_jax(kind):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(B, 3, D)).astype("float32")
    kv = rng.normal(size=(B, SRC, D)).astype("float32")
    mhas = [p.nn.MultiHeadAttention(D, NH) for p in (paddle_tpu,
                                                     paddle_tpu_torch)]
    _carry(*mhas)
    outs = []
    for paddle, mha in zip((paddle_tpu, paddle_tpu_torch), mhas):
        tq, tkv = paddle.to_tensor(q), paddle.to_tensor(kv)
        if kind == "StaticCache":
            cache = mha.gen_cache(tkv, tkv, type=mha.StaticCache)
        else:
            cache = mha.gen_cache(tkv)
            _, cache = mha(tq, tkv, tkv, None, cache)
        out, new = mha(tq, tkv, tkv, None, cache)
        outs.append((out.numpy(), new.k.numpy(), new.v.numpy()))
    for a, b in zip(*outs):
        _close(a, b)
