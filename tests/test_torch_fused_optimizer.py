"""paddle_tpu_torch fused AdamW/LAMB against paddle_tpu.

The port's flat passes (their plain versions on the CPU, what
chip_smoke.py holds the CUDA kernels against on the card) against the
JAX package's Pallas kernels run in interpret mode (``adamw_flat`` /
``lamb_moments_flat`` with ``interpret=True``), over a bucket whose
length is not a multiple of the kernels' 1024-lane rows, f32 and bf16
params, f32 and bf16 moments, ``l2`` and ``eager_form``; the tree-level
``fused_adamw_update`` / ``fused_lamb_update`` against JAX's on a
gpt_tiny tree with a decay mask; a 30-step fused-AdamW trajectory
through ``DistributedTrainStep`` with ``FLAGS_fused_optimizer=1`` against
the JAX bench loop with JAX's fused update; and the fused updates against
the port's pure ones.

Tolerances: f32 outputs 1e-6 relative to each output's largest value
(the same f32 operations in the same order; XLA may contract a multiply
and an add into one FMA, a last-bit difference); bf16-stored outputs
one bf16 ulp of the largest value (2**-7: an f32 last-bit difference can
cross a bf16 rounding boundary). Tree updates: the same, per leaf, after
5 steps. The trajectory: each of the 30 losses within 1e-4 (as the pure
AdamW trajectory test). Fused against pure in the port: the same losses
to 1e-6 and params to 1e-6 relative per leaf.
"""
import functools
import importlib

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
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

# the module (paddle_tpu.ops may re-export names of it)
jfo = importlib.import_module("paddle_tpu.ops.fused_optimizer")

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}


def _rel(want, got):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert want.shape == got.shape
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-12))


def _flat(n, seed, pdt, mdt):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32) * 0.1
    m = rng.standard_normal(n).astype(np.float32) * 0.01
    v = np.abs(rng.standard_normal(n)).astype(np.float32) * 1e-3
    jax_in = (jnp.asarray(p, DTYPES[pdt][0]), jnp.asarray(g),
              jnp.asarray(m, DTYPES[mdt][0]), jnp.asarray(v, DTYPES[mdt][0]))
    torch_in = tuple(torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
                     .to(t) for a, t in zip(
                         jax_in, (DTYPES[pdt][1], torch.float32,
                                  DTYPES[mdt][1], DTYPES[mdt][1])))
    return jax_in, torch_in


ADAMW_CASES = [("f32", "f32", 0.0, False), ("f32", "bf16", 0.0, False),
               ("bf16", "f32", 0.01, False), ("bf16", "bf16", 0.0, True),
               ("f32", "f32", 0.01, True)]


@pytest.mark.parametrize("pdt,mdt,l2,eager", ADAMW_CASES)
def test_adamw_flat_matches_pallas_kernel(pdt, mdt, l2, eager):
    n = 3000                      # not a multiple of 1024
    jax_in, (p, g, m, v) = _flat(n, 0, pdt, mdt)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.05, l2=l2, eager_form=eager)
    lr, bc1, bc2 = 3e-3, 1.0 - 0.9 ** 3, 1.0 - 0.999 ** 3
    want = jfo.adamw_flat(*jax_in, lr, bc1, bc2, interpret=True, **kw)
    out = tfo.adamw_flat(p, g, m, v, lr, bc1, bc2, **kw)
    assert out[0] is p and out[1] is m and out[2] is v    # in place
    for w, t in zip(want, out):
        assert _rel(w, t) <= TOL[t.dtype]


@pytest.mark.parametrize("pdt,mdt", [("f32", "f32"), ("bf16", "f32"),
                                     ("f32", "bf16")])
def test_lamb_moments_flat_matches_pallas_kernel(pdt, mdt):
    n = 2500
    jax_in, (p, g, m, v) = _flat(n, 1, pdt, mdt)
    kw = dict(b1=0.9, b2=0.999, eps=1e-6, wd=0.01)
    bc1, bc2 = 1.0 - 0.9 ** 2, 1.0 - 0.999 ** 2
    want = jfo.lamb_moments_flat(*jax_in, bc1, bc2, interpret=True, **kw)
    nm, nv, r = tfo.lamb_moments_flat(p, g, m, v, bc1, bc2, **kw)
    assert nm is m and nv is v and r.dtype == torch.float32
    for w, t in zip(want, (nm, nv, r)):
        assert _rel(w, t) <= TOL[t.dtype]


def test_flatten_unflatten_round_trip():
    leaves = [torch.arange(6.0).reshape(2, 3), torch.arange(4.0)]
    flat = tfo.flatten_bucket(leaves)
    assert flat.shape == (10,)
    back = tfo.unflatten_bucket(flat, [(2, 3), (4,)], dtype=torch.bfloat16)
    assert all(torch.equal(a.to(torch.bfloat16), b)
               for a, b in zip(leaves, back))
    assert tfo.flatten_bucket(leaves[:1]).shape == (6,)


def test_bucket_indices_and_lamb_groups():
    f32, bf = torch.float32, torch.bfloat16
    ps = [torch.zeros(3, dtype=d) for d in (f32, bf, f32, f32)]
    ms = [torch.zeros(3, dtype=d) for d in (f32, f32, bf, f32)]
    got = tfo._bucket_indices(ps, ms, [0.1, 0.1, 0.1, 0.0])
    assert got == {(f32, f32, 0.1): [0], (bf, f32, 0.1): [1],
                   (f32, bf, 0.1): [2], (f32, f32, 0.0): [3]}
    old = tfo._R_CAP
    try:
        tfo._R_CAP = 10
        groups, cap = tfo._lamb_groups([torch.zeros(n) for n in
                                        (4, 5, 12, 3, 3, 3)])
        assert cap == 12
        assert groups == [[0, 1], [2], [3, 4, 5]]
    finally:
        tfo._R_CAP = old


# -- tree-level updates --------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tiny_tree():
    return jax.tree.map(np.asarray, jg.gpt_init(jg.gpt_tiny(), seed=2))


def _grads(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.01).astype(np.float32),
        tree)


def _decay_mask(tree):
    return {k: ({kk: not kk.startswith("ln") and not kk.endswith("_b")
                 for kk in v} if isinstance(v, dict)
                else k in ("wte", "wpe")) for k, v in tree.items()}


def _leaves(tree):
    return [(tuple(k.key for k in path), leaf) for path, leaf
            in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("name", ["adamw", "lamb"])
def test_fused_tree_update_matches_jax(name):
    """5 steps of the fused update over gpt_tiny's tree with a decay mask
    (and for AdamW, l2), the port's against JAX's."""
    tree = _tiny_tree()
    mask = _decay_mask(tree)
    kw = dict(weight_decay=0.1, decay_mask=mask)
    if name == "adamw":
        kw["l2_coeff"] = 0.001
        upd_j, upd_t = jfo.fused_adamw_update, tfo.fused_adamw_update
        init_j, init_t = jts.pure_adamw_init, tts.pure_adamw_init
    else:
        upd_j, upd_t = jfo.fused_lamb_update, tfo.fused_lamb_update
        init_j, init_t = jts.pure_lamb_init, tts.pure_lamb_init
    pj = jax.tree.map(jnp.asarray, tree)
    sj = init_j(pj)
    pt = tg.params_from_jax(tree, device="cpu")
    st = init_t(pt)
    before = stat_get("fused_optimizer_steps")
    for step in range(5):
        g = _grads(tree, 10 + step)
        pj, sj = upd_j(pj, jax.tree.map(jnp.asarray, g), sj, 1e-2, **kw)
        out, st = upd_t(pt, tg.params_from_jax(g, device="cpu"), st, 1e-2,
                        **kw)
        assert out is pt
    assert stat_get("fused_optimizer_steps") == before + 5
    assert int(st["count"]) == int(sj["count"]) == 5
    for path, want in _leaves(pj):
        assert _rel(want, tts._get(pt, path)) <= 1e-6, path
    for key in ("m", "v"):
        for path, want in _leaves(sj[key]):
            assert _rel(want, tts._get(st[key], path)) <= 1e-6, (key, path)


def test_fused_adamw_mv_dtype_matches_jax():
    tree = {"w": np.random.default_rng(3).standard_normal((40, 30))
            .astype(np.float32)}
    g = {"w": np.random.default_rng(4).standard_normal((40, 30))
         .astype(np.float32)}
    pj = jax.tree.map(jnp.asarray, tree)
    sj = jts.pure_adamw_init(pj)
    pt = {"w": torch.from_numpy(tree["w"].copy())}
    st = tts.pure_adamw_init(pt)
    for _ in range(2):
        pj, sj = jfo.fused_adamw_update(pj, {"w": jnp.asarray(g["w"])}, sj,
                                        1e-2, mv_dtype=jnp.bfloat16)
        tfo.fused_adamw_update(pt, {"w": torch.from_numpy(g["w"])}, st,
                               1e-2, mv_dtype=torch.bfloat16)
    assert st["m"]["w"].dtype == torch.bfloat16
    assert _rel(pj["w"], pt["w"]) <= 1e-6
    assert _rel(sj["m"]["w"], st["m"]["w"]) <= TOL[torch.bfloat16]


# -- the train step ------------------------------------------------------------

def _batch(seed=6, shape=(2, 64)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 512, shape).astype(np.int32),
            rng.integers(0, 512, shape).astype(np.int32))


class _FusedFlag:
    def __init__(self, value):
        self.value = value

    def __enter__(self):
        self.old = flags.fused_optimizer[0]
        flags.fused_optimizer[0] = self.value

    def __exit__(self, *exc):
        flags.fused_optimizer[0] = self.old


def test_fused_adamw_trajectory_matches_jax():
    """30 steps of gpt_tiny (f32, remat, fused MLP, chunked loss) on one
    repeated batch: the JAX bench loop with JAX's fused AdamW against
    DistributedTrainStep with FLAGS_fused_optimizer=1, loss by loss."""
    kw = dict(dtype=jnp.float32, remat=True, fused_mlp=True)
    cfg_j = jg.gpt_tiny(**kw)
    cfg_t = tg.gpt_tiny(**{**kw, "dtype": torch.float32})
    toks, labs = _batch()
    batch_j = (jnp.asarray(toks), jnp.asarray(labs))
    pj = jg.gpt_init(cfg_j, seed=1)

    @jax.jit
    def step(p, o):
        loss, grads = jax.value_and_grad(
            lambda pp: jg.gpt_loss(cfg_j, pp, batch_j, loss_chunk=16))(p)
        p, o = jfo.fused_adamw_update(p, grads, o, 1e-3)
        return p, o, loss

    opt = jts.pure_adamw_init(pj)
    want = []
    p = pj
    for _ in range(30):
        p, opt, loss = step(p, opt)
        want.append(float(loss))

    with _FusedFlag(True):
        ts = DistributedTrainStep(
            lambda pp, b: tg.gpt_loss(cfg_t, pp, b, loss_chunk=16),
            tg.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu"),
            optimizer="adamw", lr=1e-3, device="cpu")
    assert ts._update_fn is tfo.fused_adamw_update
    got = [float(ts((toks, labs))) for _ in range(30)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert got[-1] < got[0] - 1.0


@pytest.mark.parametrize("name", ["adamw", "lamb"])
def test_fused_step_matches_pure_step(name):
    """The port's fused and pure updates through DistributedTrainStep:
    the same losses and params (the same f32 operations)."""
    cfg = tg.gpt_nano(dtype=torch.float32)
    params = tg.gpt_init(cfg, seed=4, device="cpu")
    batch = _batch(7, (2, 32))
    steps = {}
    for fused in (False, True):
        with _FusedFlag(fused):
            steps[fused] = DistributedTrainStep(
                lambda p, b: tg.gpt_loss(cfg, p, b), params, optimizer=name,
                lr=1e-3, device="cpu",
                opt_kwargs={"weight_decay": 0.05})
    want_fn = tts.pure_adamw_update if name == "adamw" \
        else tts.pure_lamb_update
    assert steps[False]._update_fn is want_fn
    losses = {f: [float(s(batch)) for _ in range(4)]
              for f, s in steps.items()}
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-6,
                               atol=0)
    for path, p in tts._paths(steps[False].params):
        got = tts._get(steps[True].params, path).detach()
        p = p.detach()
        err = (got - p).abs().max() / p.abs().max().clamp_min(1e-12)
        assert float(err) <= 1e-6, path
