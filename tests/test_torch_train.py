"""paddle_tpu_torch training slice against paddle_tpu: ``gpt_loss`` and
its gradients, the pure optimizers, ``global_norm_clip`` and a 30-step
AdamW trajectory.

One JAX ``gpt_init`` tree goes through ``params_from_jax`` into the
port; the same tokens and labels go through ``jax.value_and_grad(
gpt_loss)`` and the port's ``gpt_loss`` + autograd, at gpt_tiny, with
``remat``, ``loss_chunk`` and ``fused_mlp`` each on and off. On the CPU
the JAX fused entry runs the composed math and the port's the kernels'
plain version: the two agree in f32 to the summation order.

Tolerances: f32 loss 1e-5 absolute; f32 gradients 2e-3 of each leaf's
largest value (both heads round the logits' operands and their
cotangents to bf16, as the JAX head does, so a last-bit difference
upstream can flip one bf16 rounding: ~4e-3 of one element); bf16 loss
1e-4 relative and gradients 6e-2 of the largest value (bf16 rounds at
other points in the two packages, and the fused path rounds where the
composed one does not). Optimizer steps: 1e-6 relative (the same f32
arithmetic on the same inputs). Trajectory: each of the 30 losses
within 1e-4.
"""
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as jg
from paddle_tpu.parallel import train_step as jts
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.monitor.stats import stat_get
from paddle_tpu_torch.ops import fused_optimizer as tfo
from paddle_tpu_torch.parallel import DistributedTrainStep
from paddle_tpu_torch.parallel import train_step as tts
from paddle_tpu_torch.resilience import InjectedCrash, configure_faults
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
GRAD_TOL = {"f32": 2e-3, "bf16": 6e-2}
LOSS_TOL = {"f32": 1e-5, "bf16": 1e-4}


def _batch(seed=0, shape=(2, 64)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 512, shape).astype(np.int32),
            rng.integers(0, 512, shape).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _jax_params(dt):
    return jg.gpt_init(jg.gpt_tiny(dtype=DTYPES[dt][0]), seed=1)


def _port_params(pj, requires_grad=True):
    pt = tg.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    if requires_grad:
        for _, t in tts._paths(pt):
            t.requires_grad_(True)
    return pt


def _rel(want, got):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert want.shape == got.shape
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-12))


def _leaves(tree):
    return [(tuple(k.key for k in path), leaf) for path, leaf
            in jax.tree_util.tree_leaves_with_path(tree)]


# (dtype, remat, loss_chunk, fused_mlp): each switch on and off
CASES = [("f32", False, None, False), ("f32", True, 16, True),
         ("f32", False, 16, True), ("bf16", True, None, False)]


@pytest.mark.parametrize("dt,remat,chunk,fused", CASES)
def test_loss_and_grads_match_jax(dt, remat, chunk, fused):
    jdt, tdt = DTYPES[dt]
    cfg_j = jg.gpt_tiny(dtype=jdt, remat=remat, fused_mlp=fused)
    cfg_t = tg.gpt_tiny(dtype=tdt, remat=remat, fused_mlp=fused)
    toks, labs = _batch()
    pj = _jax_params(dt)
    lj, gj = jax.value_and_grad(lambda p: jg.gpt_loss(
        cfg_j, p, (jnp.asarray(toks), jnp.asarray(labs)),
        loss_chunk=chunk))(pj)
    pt = _port_params(pj)
    lt = tg.gpt_loss(cfg_t, pt, (torch.from_numpy(toks),
                                 torch.from_numpy(labs)), loss_chunk=chunk)
    assert lt.dtype == torch.float32 and lt.dim() == 0
    assert abs(float(lt.detach()) - float(lj)) \
        <= LOSS_TOL[dt] * max(1.0, float(lj))
    lt.backward()
    for path, g in _leaves(gj):
        t = tts._get(pt, path)
        assert t.grad is not None and t.grad.dtype == t.dtype, path
        assert _rel(g, t.grad) <= GRAD_TOL[dt], path


def test_gpt_forward_is_differentiable():
    cfg_j = jg.gpt_nano(dtype=jnp.float32)
    cfg_t = tg.gpt_nano(dtype=torch.float32)
    toks, _ = _batch(1, (1, 16))
    w = np.random.default_rng(2).standard_normal((1, 16, 512)).astype(
        np.float32)
    pj = jg.gpt_init(cfg_j, seed=2)
    gj = jax.grad(lambda p: jnp.sum(jg.gpt_forward(
        cfg_j, p, jnp.asarray(toks)) * jnp.asarray(w)))(pj)
    pt = _port_params(pj)
    (tg.gpt_forward(cfg_t, pt, torch.from_numpy(toks))
     * torch.from_numpy(w)).sum().backward()
    for path, g in _leaves(gj):
        assert _rel(g, tts._get(pt, path).grad) <= GRAD_TOL["f32"], path


def test_fused_mlp_none_follows_the_flag():
    cfg = tg.gpt_tiny(dtype=torch.float32)
    pt = _port_params(_jax_params("f32"), requires_grad=False)
    batch = tuple(torch.from_numpy(b) for b in _batch(3, (1, 32)))
    old = flags.fused_kernels[0]
    try:
        flags.fused_kernels[0] = False
        composed = tg.gpt_loss(cfg, pt, batch)
        flags.fused_kernels[0] = True
        fused = tg.gpt_loss(cfg, pt, batch)
    finally:
        flags.fused_kernels[0] = old
    assert abs(float(composed) - float(fused)) <= 1e-5


def test_loss_chunk_must_divide_seq_and_moe_raises():
    cfg = tg.gpt_tiny(dtype=torch.float32)
    pt = _port_params(_jax_params("f32"), requires_grad=False)
    batch = tuple(torch.from_numpy(b) for b in _batch(4, (1, 64)))
    with pytest.raises(ValueError, match="loss_chunk"):
        tg.gpt_loss(cfg, pt, batch, loss_chunk=24)
    # MoE is ported; its expert-parallel axis is not
    for kw in ({"moe_experts": 2, "moe_axis": "model"}, {"n_stages": 2}):
        with pytest.raises(NotImplementedError):
            tg.gpt_loss(tg.gpt_tiny(**kw), pt, batch)


# -- pure optimizers ----------------------------------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"w": n(8, 16), "b": n(16), "blk": {"a": n(3, 4, 5),
                                               "z": np.zeros(7, np.float32)}}


def _to_torch(tree):
    return {k: (_to_torch(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v))) for k, v in tree.items()}


OPT_CASES = [
    ("adamw", {}),
    ("adamw", {"l2_coeff": 0.01, "weight_decay": 0.1,
               "decay_mask": {"w": True, "b": False,
                              "blk": {"a": True, "z": False}}}),
    ("adamw", {"mv_dtype": "bf16"}),
    ("sgd", {"weight_decay": 0.01}),
    ("momentum", {}),
    ("momentum", {"use_nesterov": True, "weight_decay": 0.01}),
    ("lamb", {}),
    ("lars", {}),
]


@pytest.mark.parametrize("name,kw", OPT_CASES)
def test_pure_optimizer_steps_match_jax(name, kw):
    """Two steps from the same params and grads; the port updates in
    place and returns the same tensors."""
    params, g1, g2 = _tree(0), _tree(1), _tree(2)
    kw_j, kw_t = dict(kw), dict(kw)
    init_j, upd_j = jts._OPTS[name]
    init_t, upd_t = tts._OPTS[name]
    if kw.get("mv_dtype") == "bf16":
        kw_j["mv_dtype"], kw_t["mv_dtype"] = jnp.bfloat16, torch.bfloat16
        init_j = functools.partial(init_j, mv_dtype=jnp.bfloat16)
        init_t = functools.partial(init_t, mv_dtype=torch.bfloat16)
    pj = jax.tree.map(jnp.asarray, params)
    sj = init_j(pj)
    pt = _to_torch(params)
    st = init_t(pt)
    for g in (g1, g2):
        pj, sj = upd_j(pj, jax.tree.map(jnp.asarray, g), sj, 1e-2, **kw_j)
        out, st = upd_t(pt, _to_torch(g), st, 1e-2, **kw_t)
        assert out is pt
    assert int(st["count"]) == int(sj["count"]) == 2
    for path, want in _leaves(pj):
        assert _rel(want, tts._get(pt, path)) <= 1e-6, path
    for key in ("m", "v", "velocity"):
        if key in sj:
            for path, want in _leaves(sj[key]):
                got = tts._get(st[key], path)
                tol = 1e-6 if got.dtype == torch.float32 else 0.0
                assert _rel(want, got) <= tol, (key, path)


def test_global_norm_clip_matches_jax():
    g = _tree(5)
    for clip in (0.5, 1e6):
        want, norm_j = jts.global_norm_clip(jax.tree.map(jnp.asarray, g),
                                            clip)
        got, norm_t = tts.global_norm_clip(_to_torch(g), clip)
        assert abs(float(norm_t) - float(norm_j)) <= 1e-5 * float(norm_j)
        for path, w in _leaves(want):
            assert _rel(w, tts._get(got, path)) <= 1e-6, path


# -- the train step --------------------------------------------------------

def test_adamw_trajectory_matches_jax_bench_loop():
    """30 AdamW steps of gpt_tiny (f32, remat, fused MLP, chunked loss)
    on one repeated batch: the JAX package's bench loop
    (value_and_grad + pure_adamw_update, bench.py _device_step_seconds)
    against DistributedTrainStep, loss by loss."""
    kw = dict(dtype=jnp.float32, remat=True, fused_mlp=True)
    cfg_j = jg.gpt_tiny(**kw)
    cfg_t = tg.gpt_tiny(**{**kw, "dtype": torch.float32})
    toks, labs = _batch(6)
    batch_j = (jnp.asarray(toks), jnp.asarray(labs))
    pj = _jax_params("f32")

    @jax.jit
    def step(p, o):
        loss, grads = jax.value_and_grad(
            lambda pp: jg.gpt_loss(cfg_j, pp, batch_j, loss_chunk=16))(p)
        p, o = jts.pure_adamw_update(p, grads, o, 1e-3)
        return p, o, loss

    opt = jts.pure_adamw_init(pj)
    want = []
    p = pj
    for _ in range(30):
        p, opt, loss = step(p, opt)
        want.append(float(loss))

    before = stat_get("train_steps")
    ts = DistributedTrainStep(
        lambda pp, b: tg.gpt_loss(cfg_t, pp, b, loss_chunk=16),
        _port_params(pj, requires_grad=False), optimizer="adamw", lr=1e-3,
        device="cpu")
    got = [float(ts((toks, labs))) for _ in range(30)]
    assert stat_get("train_steps") == before + 30
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert got[-1] < got[0] - 1.0        # it really trains


def test_train_step_lr_schedule_state_dict_and_copy():
    cfg = tg.gpt_nano(dtype=torch.float32)
    params = tg.gpt_init(cfg, seed=0, device="cpu")
    w0 = params["wte"].clone()
    ts = DistributedTrainStep(lambda p, b: tg.gpt_loss(cfg, p, b), params,
                              optimizer="sgd", lr=lambda i: 0.1 / (i + 1),
                              clip_norm=1.0, device="cpu")
    assert ts.current_lr() == pytest.approx(0.1)
    ts.scale_lr(0.5)
    batch = _batch(7, (2, 16))
    ts(batch)
    assert ts.current_lr() == pytest.approx(0.025)
    assert torch.equal(params["wte"], w0)       # the caller's params stay
    snap = ts.state_dict()
    assert snap["step"] == 1 and not snap["params"]["wte"].requires_grad
    l2 = float(ts(batch))
    ts.set_state_dict(snap)
    assert float(ts(batch)) == pytest.approx(l2, abs=1e-6)


@pytest.mark.parametrize("kw", [dict(aux={"s": torch.zeros(1)}),
                                dict(dynamic_scale={"init_scale": 2.0}),
                                dict(mesh=types.SimpleNamespace(
                                    devices=np.zeros(2)))])
def test_unported_train_step_options_raise(kw):
    cfg = tg.gpt_nano(dtype=torch.float32)
    params = tg.gpt_init(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError):
        DistributedTrainStep(lambda p, b: tg.gpt_loss(cfg, p, b), params,
                             device="cpu", **kw)


def test_fused_optimizer_and_fault_flags_raise():
    """FLAGS_fused_optimizer now builds a fused step (adamw and lamb; the
    other optimizers keep their pure update); under FLAGS_fault_inject
    the step runs the train-step hook: a crash raises, and nan_grad
    leaves an all-integer batch as it is (as in the reference)."""
    cfg = tg.gpt_nano(dtype=torch.float32)
    params = tg.gpt_init(cfg, seed=0, device="cpu")
    loss_fn = lambda p, b: tg.gpt_loss(cfg, p, b)
    old = flags.fused_optimizer[0], flags.fault_inject[0]
    try:
        flags.fused_optimizer[0] = True
        for name, want in (("adamw", tfo.fused_adamw_update),
                           ("lamb", tfo.fused_lamb_update),
                           ("sgd", tts.pure_sgd_update)):
            ts = DistributedTrainStep(loss_fn, params, optimizer=name,
                                      device="cpu")
            assert ts._update_fn is want, name
        before = stat_get("fused_optimizer_steps")
        ts = DistributedTrainStep(loss_fn, params, device="cpu")
        assert math.isfinite(float(ts(_batch(8, (1, 16)))))
        assert stat_get("fused_optimizer_steps") == before + 1
        flags.fused_optimizer[0] = False
        ts = DistributedTrainStep(loss_fn, params, device="cpu")
        configure_faults("nan_grad@step=0,crash@step=1")
        assert math.isfinite(float(ts(_batch(8, (1, 16)))))
        with pytest.raises(InjectedCrash):
            ts(_batch(8, (1, 16)))
    finally:
        configure_faults("")
        flags.fused_optimizer[0] = old[0]


def test_train_step_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    cfg = tg.gpt_nano(dtype=torch.float32)
    params = tg.gpt_init(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        DistributedTrainStep(lambda p, b: tg.gpt_loss(cfg, p, b), params)
