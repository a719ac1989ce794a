"""Eager training through the port's Paddle surface against paddle_tpu:
a small BERT-style post-LN encoder (chip_smoke.py's ``bert_model`` at 2
layers, hidden 128, 4 heads, FFN 512, seq 64, batch 2, vocab 512),
composed and fused (``bert_fused_model``: ``fused_multi_head_attention``
+ ``fused_feedforward``, with FLAGS_fused_kernels=1), the JAX model's
weights carried across by ``set_state_dict``.

- 10 steps of ``loss.backward(); opt.step(); opt.clear_grad()`` with
  AdamW, FLAGS_fused_optimizer 0 and 1: every loss within 1e-5 relative
  of the JAX run's (the same f32 math, summed in another order), and
  ``optimizer.state_dict()``: the same slot names, and each slot within
  1e-4 of its largest JAX value (ten steps of moments accumulate the
  gradients' ~1e-6 differences, and moment2 holds their squares), or
  1e-9 absolute where that value is below 1e-5 (the key projection's
  bias has a zero gradient in exact arithmetic, softmax being
  shift-invariant: its moments hold ~1e-10 of summation noise in both);
- 3 steps of Lamb with FLAGS_fused_optimizer=1, and of SGD, Momentum
  (Nesterov), Adam (with L2 decay) and Lamb with it unset, losses within
  1e-5.

Runs on the CPU: the port's fused optimizer and fused ops take their
plain versions there. The flags of both packages are restored after
each test.
"""
import numpy as np
import pytest

import chip_smoke
import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core import native as jnative
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core import flags as tflags
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

SMALL = dict(vocab=512, hidden=128, layers=2, heads=4, ffn=512, seq=64)
_rng = np.random.default_rng(7)
IDS = _rng.integers(0, SMALL["vocab"], (2, SMALL["seq"]))
LABELS = _rng.integers(0, SMALL["vocab"], (2, SMALL["seq"]))
LOSS_REL = 1e-5
SLOT_TOL = 1e-4


@pytest.fixture(autouse=True)
def on_cpu_with_flags():
    """The port on the CPU; both packages' flags restored after."""
    old_dev = tdevice._current[0]
    old = [(jnative.fused_kernels[0], jnative.fused_optimizer[0]),
           (tflags.fused_kernels[0], tflags.fused_optimizer[0])]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old_dev
    jnative.fused_kernels[0], jnative.fused_optimizer[0] = old[0]
    tflags.fused_kernels[0], tflags.fused_optimizer[0] = old[1]


def _set_flags(fused_kernels, fused_optimizer):
    for paddle in (paddle_tpu, paddle_tpu_torch):
        paddle.set_flags({"FLAGS_fused_kernels": fused_kernels,
                          "FLAGS_fused_optimizer": fused_optimizer})


def _models(fused):
    """The same small encoder on both packages (the JAX weights carried
    to the port), composed or fused."""
    paddle_tpu.seed(11)
    jm = chip_smoke.bert_model(paddle_tpu, **SMALL)
    tm = chip_smoke.bert_model(paddle_tpu_torch, **SMALL)
    missing, unexpected = tm.set_state_dict(
        {k: v.numpy() for k, v in jm.state_dict().items()})
    assert not missing and not unexpected
    if fused:
        return (chip_smoke.bert_fused_model(paddle_tpu, jm),
                chip_smoke.bert_fused_model(paddle_tpu_torch, tm))
    return jm, tm


def _train(paddle, model, steps, opt_name, **kw):
    opt = getattr(paddle.optimizer, opt_name)(
        learning_rate=1e-3, parameters=model.parameters(), **kw)
    ids, labels = paddle.to_tensor(IDS), paddle.to_tensor(LABELS)
    losses = []
    for _ in range(steps):
        loss = paddle.nn.functional.cross_entropy(model(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, opt


def _slots_by_structured_name(model, opt):
    """optimizer.state_dict() keyed by the parameters' structured names.
    Its keys are "<param name>.<slot>"; a deep-copied encoder layer
    shares its param names, and as in the JAX package the last parameter
    of a name wins, so each key maps to the last structured name of that
    param name."""
    owner = {}
    for sname, p in model.named_parameters():
        owner[p.name] = sname
    out = {}
    for key, value in opt.state_dict().items():
        pname, slot = key.rsplit(".", 1)
        out[f"{owner[pname]}.{slot}"] = value.numpy()
    return out


def _assert_losses_close(want, got):
    rel = [abs(a - b) / abs(a) for a, b in zip(want, got)]
    assert max(rel) <= LOSS_REL, (want, got)


@pytest.mark.parametrize("fused_opt", [0, 1])
@pytest.mark.parametrize("form", ["composed", "fused"])
def test_adamw_trajectory_matches_jax(form, fused_opt):
    _set_flags(int(form == "fused"), fused_opt)
    jm, tm = _models(form == "fused")
    kw = dict(weight_decay=0.01)
    (jl, jopt), (tl, topt) = (_train(p, m, 10, "AdamW", **kw)
                              for p, m in ((paddle_tpu, jm),
                                           (paddle_tpu_torch, tm)))
    assert jl[-1] < jl[0]
    _assert_losses_close(jl, tl)
    js = _slots_by_structured_name(jm, jopt)
    ts = _slots_by_structured_name(tm, topt)
    assert sorted(js) == sorted(ts)
    assert {k.rsplit(".", 1)[1] for k in ts} == {
        "moment1", "moment2", "beta1_pow", "beta2_pow"}
    for k in js:
        want = np.asarray(js[k], np.float32)
        err = np.abs(want - ts[k]).max()
        assert err <= SLOT_TOL * max(np.abs(want).max(), 1e-5), k


def test_fused_lamb_matches_jax():
    _set_flags(0, 1)
    jm, tm = _models(False)
    (jl, _), (tl, topt) = (_train(p, m, 3, "Lamb", lamb_weight_decay=0.01)
                           for p, m in ((paddle_tpu, jm),
                                        (paddle_tpu_torch, tm)))
    assert topt._fused_state is not None and topt._fused_state.kind == "lamb"
    _assert_losses_close(jl, tl)


@pytest.mark.parametrize("opt_name,kw", [
    ("SGD", {}), ("Momentum", {"use_nesterov": True}),
    ("Adam", {"weight_decay": 0.01}), ("Lamb", {"lamb_weight_decay": 0.01})])
def test_per_parameter_optimizers_match_jax(opt_name, kw):
    """The unfused per-parameter updates (Adam's float weight_decay is an
    L2 regularizer on the gradient), 3 steps each."""
    _set_flags(0, 0)
    jm, tm = _models(False)
    (jl, _), (tl, _) = (_train(p, m, 3, opt_name, **kw)
                        for p, m in ((paddle_tpu, jm),
                                     (paddle_tpu_torch, tm)))
    _assert_losses_close(jl, tl)
