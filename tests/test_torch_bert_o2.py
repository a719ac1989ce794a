"""The Paddle BERT under amp O2 (``amp.decorate(level="O2")`` +
``auto_cast(level="O2")``, bf16) in the port against paddle_tpu, on the
CPU: chip_smoke.py's ``bert_model`` at 2 layers, hidden 64, 4 heads, FFN
128, seq 16, batch 2, vocab 128, composed and fused
(``bert_fused_model``; ``FLAGS_fused_kernels`` 0 and 1), the JAX
model's weights carried across by ``set_state_dict``.

- The dtype at each block boundary. The port follows Paddle's
  layer_norm rule (the output takes x's dtype; the f32 scale that O2
  keeps is used in f32), so its encoder stays bf16 after the first
  LayerNorm. The JAX package multiplies a bf16 x by the f32 scale
  without a cast and its encoder runs f32 from there. Both sequences
  are pinned, as is the rule itself on ``F.layer_norm``, ``nn.LayerNorm``
  and the fused ops' LayerNorms.
- Two steps of ``jit.TrainStep`` (uncaptured on the CPU) with
  ``AdamW(multi_precision=True)``, ``FLAGS_fused_optimizer`` 0 and 1:
  bf16 params keep f32 moments (row 7's bucket), and each step's loss
  lies within BF16_LOSS_REL of JAX's O2 eager loop and of the port's own
  f32 run from the same weights (both computed once a form, through a
  module fixture). The O2 loss is a bf16 value (8
  significant bits: one rounding step is 3.9e-3 to 7.8e-3 of it). The
  four cases measured the port's two losses equal to JAX's and 2.7e-3
  and 4.5e-3 from the f32 run's; the bound is 1e-2.
- The first step's gradients, per leaf in f32 norms (``_leaf_errs``:
  ||g - g_ref|| over the larger of ||g_ref|| and 2% of the whole
  gradient's norm, since the key projections' biases have an exact
  gradient of 0), within BF16_GRAD_REL of JAX's O2 gradients and of the
  port's f32 ones. bf16's unit roundoff is 2^-9; the bound is 16 of
  them, 2^-5. The cases measured at most 1.5e-2 against either. After
  one TrainStep step the f32 first moments are (1 - β1) times those
  gradients (within 1e-6), and every parameter lies within one rounding
  of its dtype (torch's eps: 2^-7 for bf16) plus lr of the f32 run's,
  or 2 lr where the two gradients differ in sign (``_step_excess``): the
  first AdamW step moves a parameter by lr g/(|g| + 3.2e-7), between 0
  and lr in the sign of g.
- ``models.bert_base_config`` equals JAX's.
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

SMALL = dict(vocab=128, hidden=64, layers=2, heads=4, ffn=128, seq=16)
_rng = np.random.default_rng(47)
IDS = _rng.integers(0, SMALL["vocab"], (2, SMALL["seq"]))
LABELS = _rng.integers(0, SMALL["vocab"], (2, SMALL["seq"]))
BF16_LOSS_REL = 1e-2
BF16_GRAD_REL, GRAD_FLOOR = 2.0 ** -5, 2e-2
LR = 1e-3
PKGS = (paddle_tpu, paddle_tpu_torch)


@pytest.fixture(autouse=True)
def on_cpu_with_flags():
    old_dev = tdevice._current[0]
    old = [(jnative.fused_kernels[0], jnative.fused_optimizer[0]),
           (tflags.fused_kernels[0], tflags.fused_optimizer[0])]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old_dev
    jnative.fused_kernels[0], jnative.fused_optimizer[0] = old[0]
    tflags.fused_kernels[0], tflags.fused_optimizer[0] = old[1]


def _set_flags(fused_kernels, fused_optimizer=0):
    for paddle in PKGS:
        paddle.set_flags({"FLAGS_fused_kernels": fused_kernels,
                          "FLAGS_fused_optimizer": fused_optimizer})


def _models(form):
    """The same f32 model on both packages, composed or fused."""
    paddle_tpu.seed(47)
    jm = chip_smoke.bert_model(paddle_tpu, **SMALL)
    tm = chip_smoke.bert_model(paddle_tpu_torch, **SMALL)
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    if form == "composed":
        return jm, tm
    return (chip_smoke.bert_fused_model(paddle_tpu, jm),
            chip_smoke.bert_fused_model(paddle_tpu_torch, tm))


def _name(dtype):
    return str(dtype).replace("paddle_tpu.", "").replace("torch.", "")


def _boundaries(paddle, model, form):
    """The dtypes of the embeddings' sum, each block's output, the logits
    and the loss under auto_cast O2."""
    ids = paddle.to_tensor(IDS)
    with paddle.amp.auto_cast(enable=True, level="O2"):
        x = model.word(ids) + model.pos(paddle.arange(SMALL["seq"]))
        seen = [x.dtype]
        blocks = model.encoder.layers if form == "composed" else model.layers
        for block in blocks:
            x = block(x)
            seen.append(x.dtype)
        out = model.head(x)
        seen.append(out.dtype)
    loss = paddle.nn.functional.cross_entropy(out, paddle.to_tensor(LABELS))
    return [_name(d) for d in seen + [loss.dtype]]


# the port: bf16 from the embeddings to the loss (Paddle's rule); JAX:
# f32 from the first LayerNorm on in the composed and fused forms
BF16_FLOW = ["bfloat16"] * 5
JAX_FLOW = ["bfloat16", "float32", "float32", "bfloat16", "bfloat16"]


@pytest.mark.parametrize("form,fused_kernels", [
    ("composed", 0), ("fused", 0), ("fused", 1)])
def test_o2_dtype_at_each_block_boundary(form, fused_kernels):
    _set_flags(fused_kernels)
    models = _models(form)
    flows = []
    for paddle, m in zip(PKGS, models):
        paddle.amp.decorate(m, level="O2", dtype="bfloat16")
        flows.append(_boundaries(paddle, m, form))
        norms = [n for n, p in m.named_parameters() if "norm" in n]
        assert norms and all(_name(dict(m.named_parameters())[n].dtype)
                             == "float32" for n in norms)
    assert flows == [JAX_FLOW, BF16_FLOW]


def test_layer_norm_keeps_the_input_dtype():
    """Paddle's rule, which the port keeps: LN(bf16 x) with an f32 scale
    is bf16, normalized and scaled in f32 and rounded once (within half
    a bf16 ulp, at most 2^-8 relative, of an f64 reference). The JAX functional
    returns f32 (it normalizes in bf16, then scales in f32: within a few
    bf16 roundings of the reference, 2^-6 of the largest value)."""
    import torch

    from paddle_tpu_torch.ops import fused as tfused

    rng = np.random.default_rng(48)
    x = rng.normal(size=(3, 64)).astype("float32")
    w = rng.normal(size=(64,)).astype("float32")
    b = rng.normal(size=(64,)).astype("float32")
    xb = torch.tensor(x).bfloat16().double().numpy()
    mu = xb.mean(-1, keepdims=True)
    ref = (xb - mu) / np.sqrt(((xb - mu) ** 2).mean(-1, keepdims=True)
                              + 1e-5) * w + b
    outs = {}
    for paddle in PKGS:
        outs[paddle.__name__] = paddle.nn.functional.layer_norm(
            paddle.to_tensor(x).astype("bfloat16"), 64,
            paddle.to_tensor(w), paddle.to_tensor(b))
    j, t = outs["paddle_tpu"], outs["paddle_tpu_torch"]
    assert (_name(j.dtype), _name(t.dtype)) == ("float32", "bfloat16")
    got = t.astype("float32").numpy()
    np.testing.assert_allclose(got, ref, rtol=2 ** -8, atol=1e-6)
    assert np.abs(j.numpy() - ref).max() <= 2 ** -6 * np.abs(ref).max()
    layer = paddle_tpu_torch.amp.decorate(paddle_tpu_torch.nn.LayerNorm(64),
                                          level="O2")
    assert _name(layer.weight.dtype) == "float32"
    assert _name(layer(paddle_tpu_torch.to_tensor(x).astype(
        "bfloat16")).dtype) == "bfloat16"
    y = tfused._layer_norm(torch.tensor(x).bfloat16(), torch.tensor(w),
                           torch.tensor(b), 1e-5)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), ref, rtol=2 ** -8,
                               atol=1e-6)


def _o2_steps(paddle, model, steps=2, o2=True, train_step=True):
    """``steps`` AdamW(multi_precision) steps: the port through
    jit.TrainStep, JAX's eager loop; both under O2 when ``o2``."""
    if o2:
        paddle.amp.decorate(model, level="O2", dtype="bfloat16")
    opt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=0.01,
                                 parameters=model.parameters(),
                                 multi_precision=True)
    ids, labels = paddle.to_tensor(IDS), paddle.to_tensor(LABELS)

    def loss_fn(run, x, y):
        with paddle.amp.auto_cast(enable=o2, level="O2"):
            out = run(x)
        return paddle.nn.functional.cross_entropy(out, y)

    if train_step:
        step = paddle.jit.TrainStep(model, loss_fn, opt)
        return [float(step(ids, labels)) for _ in range(steps)], opt
    losses = []
    for _ in range(steps):
        loss = loss_fn(model, ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, opt


@pytest.fixture(scope="module")
def references():
    """Each form's yardsticks, computed once for both optimizer flags:
    JAX's O2 losses (its eager loop, FLAGS_fused_optimizer 0) and the
    port's own f32 run."""
    old_dev = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    try:
        out = {}
        for form in ("composed", "fused"):
            _set_flags(int(form == "fused"), 0)
            jm, _ = _models(form)
            _, tm32 = _models(form)
            out[form] = (_o2_steps(paddle_tpu, jm, train_step=False)[0],
                         _o2_steps(paddle_tpu_torch, tm32, o2=False)[0])
        return out
    finally:
        tdevice._current[0] = old_dev


@pytest.mark.parametrize("fused_opt", [0, 1])
@pytest.mark.parametrize("form", ["composed", "fused"])
def test_o2_adamw_steps_match_jax_and_f32(references, form, fused_opt):
    _set_flags(int(form == "fused"), fused_opt)
    _, tm = _models(form)
    tl, topt = _o2_steps(paddle_tpu_torch, tm)
    for want in references[form]:
        rel = max(abs(a - b) / abs(a) for a, b in zip(want, tl))
        assert rel <= BF16_LOSS_REL, (want, tl)
    # bf16 params with f32 moments; the kept-f32 LayerNorms f32 throughout
    for name, p in tm.named_parameters():
        m1 = topt._get_slots(p)[0]
        assert _name(m1.dtype) == "float32"
        assert _name(p.dtype) == ("float32" if "norm" in name
                                  else "bfloat16"), name


def _grads(paddle, model, o2=True):
    """The first step's gradients (one eager forward and backward under
    auto_cast O2 when ``o2``) as f64 arrays, by name."""
    if o2:
        paddle.amp.decorate(model, level="O2", dtype="bfloat16")
    with paddle.amp.auto_cast(enable=o2, level="O2"):
        out = model(paddle.to_tensor(IDS))
    loss = paddle.nn.functional.cross_entropy(out, paddle.to_tensor(LABELS))
    loss.backward()
    grads = {k: np.asarray(p.grad.astype("float32").numpy(), np.float64)
             for k, p in model.named_parameters()}
    model.clear_gradients()
    return grads


def _leaf_errs(got, want):
    floor = GRAD_FLOOR * np.sqrt(sum(np.square(w).sum()
                                     for w in want.values()))
    return {k: np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), floor)
            for k, w in want.items()}


def _step_excess(p, p_ref, g, g_ref, eps):
    """max |p - p_ref| less one rounding of |p_ref| (``eps`` of it), in
    units of LR, less 1 where the gradients differ in sign: at most 1."""
    flip = np.sign(g) != np.sign(g_ref)
    return float(((np.abs(p - p_ref) - eps * np.abs(p_ref)) / LR
                  - flip).max())


def _f64(model):
    return {k: np.asarray(p.astype("float32").numpy(), np.float64)
            for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def first_step():
    """Each form's yardsticks of the first step, computed once: JAX's O2
    gradients, the port's f32 gradients, and the port's f32 parameters
    after one TrainStep step."""
    old_dev = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    try:
        out = {}
        for form in ("composed", "fused"):
            _set_flags(int(form == "fused"), 0)
            jm, tm32 = _models(form)
            gj = _grads(paddle_tpu, jm)
            g32 = _grads(paddle_tpu_torch, tm32, o2=False)
            _o2_steps(paddle_tpu_torch, tm32, steps=1, o2=False)
            out[form] = (gj, g32, _f64(tm32))
        return out
    finally:
        tdevice._current[0] = old_dev


@pytest.mark.parametrize("form", ["composed", "fused"])
def test_o2_first_step_gradients_match_jax_and_f32(first_step, form):
    _set_flags(int(form == "fused"), 0)
    gj, g32, _ = first_step[form]
    _, tm = _models(form)
    g = _grads(paddle_tpu_torch, tm)
    for want in (gj, g32):
        errs = _leaf_errs(g, want)
        assert max(errs.values()) <= BF16_GRAD_REL, errs


@pytest.mark.parametrize("fused_opt", [0, 1])
@pytest.mark.parametrize("form", ["composed", "fused"])
def test_o2_first_step_moments_and_params(first_step, form, fused_opt):
    """One TrainStep step of the O2 model (row 7's bf16-param bucket with
    f32 moments, its plain version here, under FLAGS_fused_optimizer=1):
    the first moments hold 0.1 of the step's gradients, and the
    parameters agree with the f32 run's step within bf16's rounding."""
    import torch

    _set_flags(int(form == "fused"), fused_opt)
    _, g32, p32 = first_step[form]
    _, tm = _models(form)
    g = _grads(paddle_tpu_torch, tm)
    _, opt = _o2_steps(paddle_tpu_torch, tm, steps=1)
    p = _f64(tm)
    # row 7 takes (1 - β1) in f32; the eager update, as JAX's, first
    # rounds that scalar to a bf16 gradient's dtype (0.10009765625)
    c = {k: 0.1 if fused_opt or t._data.dtype == torch.float32
         else float(torch.tensor(0.1).bfloat16())
         for k, t in tm.named_parameters()}
    m1 = {k: np.asarray(opt._get_slots(t)[0].numpy(), np.float64) / c[k]
          for k, t in tm.named_parameters()}
    errs = _leaf_errs(m1, g)
    assert max(errs.values()) <= 1e-6, errs
    for k, t in tm.named_parameters():
        eps = torch.finfo(t._data.dtype).eps
        assert _step_excess(p[k], p32[k], g[k], g32[k], eps) <= 1.0, k


def test_bert_base_config_equals_jax():
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu_torch.models import bert_base_config

    want, got = jgpt.bert_base_config(), bert_base_config()
    for k in ("vocab_size", "hidden", "n_layers", "n_heads", "seq_len",
              "mlp_ratio"):
        assert getattr(want, k) == getattr(got, k), k
    assert bert_base_config(n_layers=2).n_layers == 2
