"""The losses of ``nn/functional/loss.py:234-519`` and their layers in the
port against paddle_tpu's, on the CPU, from seeded numpy inputs: each
loss within 1e-5 relative (ctc 1e-4) and the gradients of every float
input within 1e-4 of the largest (ctc's too).
"""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import device as tdevice
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

REL, CTC_REL, GRAD_TOL = 1e-5, 1e-4, 1e-4
B, D, C = 12, 8, 6


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old


def _inputs():
    rng = np.random.default_rng(23)
    f = lambda *s: rng.normal(size=s).astype("float32")  # noqa: E731
    prob = rng.uniform(0.05, 0.95, (B, C)).astype("float32")
    T, N, K, L = 12, 4, 5, 4
    logits = f(T, N, K)
    log_probs = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))
                 ).astype("float32")
    table = rng.integers(-1, C - 1, (B, 4)).astype("int64")
    table[:, 0] = rng.integers(0, C - 1, B)
    return {
        "x": f(B, C), "y": f(B, C), "v": f(B), "w": f(B),
        "a": f(B, D), "p": f(B, D), "n": f(B, D),
        "sign": np.where(rng.uniform(size=B) < 0.5, -1.0, 1.0).astype(
            "float32"),
        "lab": rng.integers(0, C, (B, 1)).astype("int64"),
        "lab1": rng.integers(0, C, (B,)).astype("int64"),
        "soft": (prob / prob.sum(-1, keepdims=True)).astype("float32"),
        "prob": prob, "bin": (prob > 0.5).astype("float32"),
        "norm": np.array([3.0], "float32"),
        "cos": np.tanh(f(B, C)), "pairs": rng.integers(0, 4, (B,)).astype(
            "int64"),
        "log_probs": log_probs,
        "labels": rng.integers(1, K, (N, L)).astype("int64"),
        "in_len": np.array([12, 9, 12, 7], "int64"),
        "lab_len": np.array([4, 2, 3, 1], "int64"),
        "hw": f(C - 1, D) * 0.3, "hb": f(C - 1) * 0.3,
        "table": table, "code": rng.integers(0, 2, (B, 4)).astype("int64"),
    }


LOSSES = {
    "softmax_with_cross_entropy": lambda p, d: p.nn.functional
    .softmax_with_cross_entropy(d["x"], d["lab"]),
    "softmax_with_cross_entropy_soft": lambda p, d: p.nn.functional
    .softmax_with_cross_entropy(d["x"], d["soft"], soft_label=True,
                                return_softmax=True),
    "margin_ranking_loss": lambda p, d: p.nn.functional.margin_ranking_loss(
        d["v"], d["w"], d["sign"], margin=0.3),
    "margin_ranking_loss_none": lambda p, d: p.nn.functional
    .margin_ranking_loss(d["v"], d["w"], d["sign"], reduction="none"),
    "hinge_embedding_loss": lambda p, d: p.nn.functional
    .hinge_embedding_loss(d["v"], d["sign"], margin=0.5),
    "cosine_embedding_loss": lambda p, d: p.nn.functional
    .cosine_embedding_loss(d["a"], d["p"], d["sign"], margin=0.1,
                           reduction="sum"),
    "log_loss": lambda p, d: p.nn.functional.log_loss(d["prob"], d["bin"]),
    "sigmoid_focal_loss": lambda p, d: p.nn.functional.sigmoid_focal_loss(
        d["x"], d["bin"]),
    "sigmoid_focal_loss_normalizer": lambda p, d: p.nn.functional
    .sigmoid_focal_loss(d["x"], d["bin"], normalizer=d["norm"], alpha=0.4,
                        gamma=1.5, reduction="mean"),
    "dice_loss": lambda p, d: p.nn.functional.dice_loss(
        p.nn.functional.softmax(d["x"]), d["lab"]),
    "npair_loss": lambda p, d: p.nn.functional.npair_loss(
        d["a"], d["p"], d["pairs"]),
    "triplet_margin_loss": lambda p, d: p.nn.functional.triplet_margin_loss(
        d["a"], d["p"], d["n"]),
    "triplet_margin_loss_swap_p1": lambda p, d: p.nn.functional
    .triplet_margin_loss(d["a"], d["p"], d["n"], p=1.0, swap=True,
                         reduction="none"),
    "hsigmoid_loss": lambda p, d: p.nn.functional.hsigmoid_loss(
        d["a"], d["lab1"], C, d["hw"], d["hb"]),
    "hsigmoid_loss_nobias": lambda p, d: p.nn.functional.hsigmoid_loss(
        d["a"], d["lab"], C, d["hw"]),
    "hsigmoid_loss_custom": lambda p, d: p.nn.functional.hsigmoid_loss(
        d["a"], d["lab1"], C, d["hw"], d["hb"], path_table=d["table"],
        path_code=d["code"]),
    "margin_cross_entropy": lambda p, d: p.nn.functional
    .margin_cross_entropy(d["cos"], d["lab1"], return_softmax=True),
    "margin_cross_entropy_cosface": lambda p, d: p.nn.functional
    .margin_cross_entropy(d["cos"], d["lab1"], margin1=1.0, margin2=0.0,
                          margin3=0.35, scale=30.0, reduction="sum"),
    "ctc_loss": lambda p, d: p.nn.functional.ctc_loss(
        d["log_probs"], d["labels"], d["in_len"], d["lab_len"]),
    "ctc_loss_sum_blank": lambda p, d: p.nn.functional.ctc_loss(
        d["log_probs"], d["labels"] - 1, d["in_len"], d["lab_len"],
        blank=4, reduction="sum"),
    "MarginRankingLoss": lambda p, d: p.nn.MarginRankingLoss(0.2)(
        d["v"], d["w"], d["sign"]),
    "HingeEmbeddingLoss": lambda p, d: p.nn.HingeEmbeddingLoss(
        reduction="sum")(d["v"], d["sign"]),
    "CosineEmbeddingLoss": lambda p, d: p.nn.CosineEmbeddingLoss(0.2)(
        d["a"], d["p"], d["sign"]),
    "CTCLoss": lambda p, d: p.nn.CTCLoss(reduction="none")(
        d["log_probs"], d["labels"], d["in_len"], d["lab_len"]),
    "TripletMarginLoss": lambda p, d: p.nn.TripletMarginLoss(
        margin=0.5, swap=True)(d["a"], d["p"], d["n"]),
}


def _run(paddle, name):
    d = {k: paddle.to_tensor(v, stop_gradient=v.dtype.kind != "f"
                             or k in ("norm", "sign", "bin", "soft", "cos"))
         for k, v in _inputs().items()}
    if name in ("softmax_with_cross_entropy_soft",):
        d["soft"].stop_gradient = True
    out = LOSSES[name](paddle, d)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    w = np.random.default_rng(1).normal(size=outs[0].shape).astype(
        "float32")
    (outs[0] * paddle.to_tensor(w)).sum().backward()
    grads = {k: (None if t.grad is None else t.grad.numpy())
             for k, t in d.items() if not t.stop_gradient}
    return [np.asarray(o.numpy()) for o in outs], grads


def _rel_close(want, got, rel):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape, (want.shape, got.shape)
    err = np.abs(want - got).max()
    assert err <= rel * max(np.abs(want).max(), 1e-6), err


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    (wo, wg), (to, tg) = _run(paddle_tpu, name), _run(paddle_tpu_torch,
                                                      name)
    rel = CTC_REL if "ctc" in name.lower() else REL
    assert len(wo) == len(to)
    for a, b in zip(wo, to):
        _rel_close(a, b, rel)
    assert set(wg) == set(tg)
    for k in wg:
        assert (wg[k] is None) == (tg[k] is None), k
        if wg[k] is not None:
            _rel_close(wg[k], tg[k], GRAD_TOL)


@pytest.mark.parametrize("custom", [False, True])
def test_hsigmoid_layer_with_jax_weights(custom):
    d = _inputs()
    layers = [p.nn.HSigmoidLoss(D, C, is_custom=custom)
              for p in (paddle_tpu, paddle_tpu_torch)]
    state = {"weight": d["hw"], "bias": d["hb"]}
    for lay in layers:
        assert not any(lay.set_state_dict(state))
    outs = []
    for p, lay in zip((paddle_tpu, paddle_tpu_torch), layers):
        extra = ((p.to_tensor(d["table"]), p.to_tensor(d["code"]))
                 if custom else ())
        loss = lay(p.to_tensor(d["a"]), p.to_tensor(d["lab1"]), *extra)
        loss.sum().backward()
        outs.append((loss.numpy(), lay.weight.grad.numpy(),
                     lay.bias.grad.numpy()))
    for a, b in zip(*outs):
        _rel_close(a, b, GRAD_TOL)


def test_refusals():
    F = paddle_tpu_torch.nn.functional
    d = {k: paddle_tpu_torch.to_tensor(v) for k, v in _inputs().items()}
    with pytest.raises(NotImplementedError):
        F.ctc_loss(d["log_probs"], d["labels"], d["in_len"], d["lab_len"],
                   norm_by_times=True)

    class Group:
        nranks = 2

    with pytest.raises(ValueError):
        F.margin_cross_entropy(d["cos"], d["lab1"], group=Group())
    with pytest.raises(ValueError):
        F.hsigmoid_loss(d["a"], d["lab1"], C, d["hw"], path_table=d["table"])
