"""paddle_tpu_torch paged-attention decode against paddle_tpu.

The port's plain version (what a CPU tensor runs, and what chip_smoke.py
holds the CUDA kernel against on the card) is compared with the JAX
package's Pallas decode kernel in interpret mode, ``ragged`` on and off,
and with its composed reference, on the same numpy inputs. The port's
whole-pool form (``layer=i`` over the engine's (n_blocks, L, nh, bs, hd)
pool) must equal the one-layer form bit for bit.

Tolerances: f32 1e-5; bf16 2e-2 (probabilities are rounded to bf16 at
different points in the two packages).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import paged_attention as tpa
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

# the module (paddle_tpu.ops re-exports a function of the same name)
jpa = importlib.import_module("paddle_tpu.ops.paged_attention")

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _case(B=3, nh=8, hd=64, bs=16, W=4, nb=12, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    kb = rng.standard_normal((nb, nh, bs, hd)).astype(np.float32)
    vb = rng.standard_normal((nb, nh, bs, hd)).astype(np.float32)
    tables = np.zeros((B, W), np.int32)
    for b, row in enumerate(([5, 2, 9], [1, 7, 3, 11], [4])[:B]):
        tables[b, :len(row)] = row
    lengths = np.asarray([37, 64, 1][:B], np.int32)
    return q, kb, vb, tables, lengths


def _t(a, dtype=None):
    t = torch.from_numpy(a)
    return t if dtype is None else t.to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("jdt,tdt,tol", [(jnp.float32, torch.float32, F32_TOL),
                                         (jnp.bfloat16, torch.bfloat16,
                                          BF16_TOL)])
def test_plain_matches_pallas_interpret(ragged, jdt, tdt, tol):
    q, kb, vb, tables, lengths = _case()
    want = jpa._paged_decode(jnp.asarray(q, jdt), jnp.asarray(kb, jdt),
                             jnp.asarray(vb, jdt), jnp.asarray(tables),
                             jnp.asarray(lengths), 0.125, interpret=True,
                             ragged=ragged)
    got = tpa.paged_attention_arrays(_t(q, tdt), _t(kb, tdt), _t(vb, tdt),
                                     _t(tables), _t(lengths), scale=0.125,
                                     ragged=ragged)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("hd,bs", [(64, 16), (128, 16), (16, 8)])
def test_plain_matches_jax_reference_with_empty_lane(hd, bs):
    """Including a length-0 lane with an all-sink table (an unoccupied
    slot): both plain versions give its uniform average."""
    rng = np.random.default_rng(1)
    nh, W, nb = 4, 3, 8
    q = rng.standard_normal((3, nh, hd)).astype(np.float32)
    kb = rng.standard_normal((nb, nh, bs, hd)).astype(np.float32)
    vb = rng.standard_normal((nb, nh, bs, hd)).astype(np.float32)
    tables = np.asarray([[3, 5, 0], [0, 0, 0], [7, 1, 2]], np.int32)
    lengths = np.asarray([bs + 3, 0, 3 * bs], np.int32)
    want = jpa._paged_attention_reference(
        jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
        jnp.asarray(tables), jnp.asarray(lengths), 0.25)
    got = tpa.paged_attention_arrays(_t(q), _t(kb), _t(vb), _t(tables),
                                     _t(lengths), scale=0.25)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL,
                               rtol=F32_TOL)


def test_whole_pool_layer_equals_one_layer():
    """The engine's form: the whole (n_blocks, L, nh, bs, hd) pool and a
    layer index read that layer where it lies, with the same result as
    the one-layer slice."""
    q, kb, vb, tables, lengths = _case()
    rng = np.random.default_rng(2)
    L = 3
    kpool = rng.standard_normal((kb.shape[0], L) + kb.shape[1:]).astype(
        np.float32)
    vpool = rng.standard_normal(kpool.shape).astype(np.float32)
    for layer in range(L):
        whole = tpa.paged_attention_arrays(
            _t(q), _t(kpool), _t(vpool), _t(tables), _t(lengths),
            scale=0.125, layer=layer)
        one = tpa.paged_attention_arrays(
            _t(q), _t(np.ascontiguousarray(kpool[:, layer])),
            _t(np.ascontiguousarray(vpool[:, layer])), _t(tables),
            _t(lengths), scale=0.125)
        assert torch.equal(whole, one)


def test_ragged_flag_is_bit_identical_and_counts_nothing_on_cpu():
    q, kb, vb, tables, lengths = (_t(a) for a in _case())
    before = tpa.LAUNCHES
    a = tpa.paged_attention_arrays(q, kb, vb, tables, lengths, ragged=False)
    b = tpa.paged_attention_arrays(q, kb, vb, tables, lengths, ragged=True)
    assert torch.equal(a, b)
    assert tpa.LAUNCHES == before


def _edge_case(hd, bs, W=11, cl=8, seed=3):
    """The card tests' edge shapes: slots whose live blocks are 1, the
    kernel's cluster (8 here), one past it and the whole table (W no
    multiple of 8), a length-0 slot and a stale all-sink lane."""
    rng = np.random.default_rng(seed)
    B, nh, nb = 6, 2, 1 + 4 * W
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    kb = rng.standard_normal((nb, nh, bs, hd)).astype(np.float32)
    vb = rng.standard_normal((nb, nh, bs, hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    tables = np.zeros((B, W), np.int32)
    used = 0
    for b, n in enumerate((1, cl, cl + 1, W)):
        tables[b, :n] = perm[used:used + n]
        used += n
    lengths = np.asarray([bs - 3, cl * bs, cl * bs + 1, W * bs - 5, 0,
                          2 * bs + 1], np.int32)
    return q, kb, vb, tables, lengths


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_plain_edge_lengths_match_jax_reference(hd, bs):
    """Every (hd, bs) pair the kernel takes, at the edge lengths; the
    length-0 slot gets both plain versions' uniform average."""
    q, kb, vb, tables, lengths = _edge_case(hd, bs)
    want = jpa._paged_attention_reference(
        jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
        jnp.asarray(tables), jnp.asarray(lengths), 0.2)
    got = tpa.paged_attention_arrays(_t(q), _t(kb), _t(vb), _t(tables),
                                     _t(lengths), scale=0.2)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("jdt,tdt,tol", [(jnp.float32, torch.float32, F32_TOL),
                                         (jnp.bfloat16, torch.bfloat16,
                                          BF16_TOL)])
def test_plain_edge_lengths_match_pallas_interpret(jdt, tdt, tol):
    """The edge lengths against the Pallas kernel, ragged; its length-0
    slot is zeros (the card kernel's contract), so it is held apart."""
    q, kb, vb, tables, lengths = _edge_case(64, 16)
    want = jpa._paged_decode(jnp.asarray(q, jdt), jnp.asarray(kb, jdt),
                             jnp.asarray(vb, jdt), jnp.asarray(tables),
                             jnp.asarray(lengths), 0.125, interpret=True,
                             ragged=True)
    got = tpa.paged_attention_arrays(_t(q, tdt), _t(kb, tdt), _t(vb, tdt),
                                     _t(tables), _t(lengths), scale=0.125)
    live = [0, 1, 2, 3, 5]
    np.testing.assert_allclose(_np(got)[live], _np(want)[live], atol=tol,
                               rtol=tol)
    assert not _np(want)[4].any()
