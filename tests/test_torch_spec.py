"""paddle_tpu_torch speculative decoding against paddle_tpu.

The draft (``gpt_truncate``), the C-token verify steps over both caches,
the unaligned-start paged prefill and the acceptance rule are held
against the JAX package on the same inputs (f32; logits and caches
within 1e-5: the same f32 arithmetic in another summation order), and
the verify steps against the port's own one-token decode run C times.
Greedy speculative streams of the port's engine must equal the JAX
speculative engine's and the port's non-speculative engine's, token for
token, in both cache modes.

The sampled rule cannot reproduce JAX's bits (another generator), so its
core is pinned with fixed uniforms and Gumbel noise against a numpy
transcription of JAX's formula, and its draws are held to the target
distribution by a chi-square test: 4000 independent streams at V = 8,
whose statistic (7 degrees of freedom) must stay below 24.32, the
chi-square(7) quantile at 0.999.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as jg
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import sampling as jsampling
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.monitor.stats import stat_get
from paddle_tpu_torch.serving import InferenceEngine, sampling
from torch_jax_util import scaled_params
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

CFG_J = jg.gpt_tiny(dtype=jnp.float32, seq_len=64)
CFG = tg.gpt_tiny(dtype=torch.float32, seq_len=64)
PROMPT_LENS = (5, 17, 30, 41)
NEW_TOKENS = 10
ENGINE_KW = dict(n_slots=2, max_len=64, block_size=8, prefill_chunk=16)
SPEC_K = 3
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _params():
    return scaled_params(CFG_J)


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
            for n in PROMPT_LENS]


def _np(t):
    return t.detach().cpu().numpy()


def test_gpt_truncate_matches_jax():
    tree, params = _params()
    dcfg, draft = tg.gpt_truncate(CFG, params, 2)
    jcfg, jdraft = jg.gpt_truncate(CFG_J, tree, 2)
    want = tg.params_from_jax(jax.tree.map(np.asarray, jdraft), "cpu")
    assert dcfg.n_layers == jcfg.n_layers == 2
    for k, v in want["blocks"].items():
        assert torch.equal(draft["blocks"][k], v), k
    for k in ("wte", "wpe", "lnf_s", "lnf_b"):
        assert draft[k] is params[k]           # shared with the target
    with pytest.raises(ValueError, match="outside"):
        tg.gpt_truncate(CFG, params, 5)
    with pytest.raises(ValueError, match="MoE"):
        tg.gpt_truncate(tg.gpt_tiny(moe_experts=4), params, 2)


def _random_cache(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("paged", [False, True])
def test_verify_step_matches_jax_and_one_token_steps(paged):
    """C = 4 tokens for two rows at positions 13 and 30 against a cache
    of random contents: logits and the written cache equal JAX's verify
    step, and equal the port's one-token decode step fed the same tokens
    one at a time."""
    tree, params = _params()
    L, nh, hd = CFG.n_layers, CFG.n_heads, CFG.head_dim
    B, C, bs = 2, 4, 8
    positions = np.asarray([13, 30], np.int32)
    tokens = np.random.default_rng(1).integers(
        0, CFG.vocab_size, (B, C)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, tree)
    if paged:
        n_blocks, W = 12, 5
        k0, v0 = (_random_cache((n_blocks, L, nh, bs, hd), s) for s in (2, 3))
        tables = np.asarray([[3, 7, 1, 9, 0], [2, 5, 11, 4, 8]], np.int32)
        want, (jk, jv) = jg.gpt_verify_step_paged(
            CFG_J, jparams, (jnp.asarray(k0), jnp.asarray(v0)),
            jnp.asarray(tables), jnp.asarray(positions), jnp.asarray(tokens))
        kb, vb = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
        tab = torch.from_numpy(tables)
        got, _ = tg.gpt_verify_step_paged(
            CFG, params, (kb, vb), tab, torch.from_numpy(positions),
            torch.from_numpy(tokens))
        kb1, vb1 = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
        steps = [tg.gpt_decode_step_paged(
            CFG, params, (kb1, vb1), tab, torch.from_numpy(positions + j),
            torch.from_numpy(tokens[:, j]))[0] for j in range(C)]
    else:
        k0, v0 = (_random_cache((B, L, nh, 64, hd), s) for s in (2, 3))
        want, (jk, jv) = jg.gpt_verify_step(
            CFG_J, jparams, (jnp.asarray(k0), jnp.asarray(v0)),
            jnp.asarray(positions), jnp.asarray(tokens))
        kb, vb = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
        got, _ = tg.gpt_verify_step(CFG, params, (kb, vb),
                                    torch.from_numpy(positions),
                                    torch.from_numpy(tokens))
        kb1, vb1 = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
        steps = [tg.gpt_decode_step(
            CFG, params, (kb1, vb1), torch.from_numpy(positions + j),
            torch.from_numpy(tokens[:, j]))[0] for j in range(C)]
    assert got.shape == (B, C, CFG.vocab_size)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(kb), np.asarray(jk), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(vb), np.asarray(jv), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(got), _np(torch.stack(steps, 1)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(kb), _np(kb1), rtol=TOL, atol=TOL)


def test_prefill_prefix_unaligned_start_matches_jax():
    tree, params = _params()
    L, nh, hd, bs = CFG.n_layers, CFG.n_heads, CFG.head_dim, 8
    k0, v0 = (_random_cache((10, L, nh, bs, hd), s) for s in (4, 5))
    row = np.asarray([6, 2, 9, 3, 1, 0, 0, 0], np.int32)
    toks = np.random.default_rng(2).integers(
        0, CFG.vocab_size, (1, 16)).astype(np.int32)
    start = 21                                  # mid-block
    want, (jk, jv) = jg.gpt_prefill_prefix(
        CFG_J, jax.tree.map(jnp.asarray, tree),
        (jnp.asarray(k0), jnp.asarray(v0)), jnp.asarray(row),
        jnp.asarray(toks), jnp.int32(start))
    kb, vb = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    got, _ = tg.gpt_prefill_prefix(CFG, params, (kb, vb),
                                   torch.from_numpy(row),
                                   torch.from_numpy(toks), start)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(kb), np.asarray(jk), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(vb), np.asarray(jv), rtol=TOL, atol=TOL)


def _accept_inputs(B, K, V, seed):
    rng = np.random.default_rng(seed)
    tl = rng.standard_normal((B, K + 1, V)).astype(np.float32) * 2
    dl = rng.standard_normal((B, K, V)).astype(np.float32) * 2
    d = tl[:, :K].argmax(-1).astype(np.int32)
    d[0, 2] = (d[0, 2] + 1) % V          # row 0 misses at j = 2
    d[2, 0] = (d[2, 0] + 1) % V          # row 2 misses at once
    d[3] = rng.integers(0, V, K)         # row 3: random proposals
    return tl, dl, d


def test_spec_accept_greedy_matches_jax():
    B, K, V = 4, 4, 50
    tl, dl, d = _accept_inputs(B, K, V, 0)
    keys = jsampling.stream_keys(jax.random.key(0),
                                 jnp.arange(B, dtype=jnp.int32),
                                 jnp.zeros(B, jnp.int32))
    want, want_n = jsampling.spec_accept(
        jnp.asarray(tl), jnp.asarray(dl), jnp.asarray(d), keys,
        jnp.zeros(B, jnp.float32), jnp.zeros(B, jnp.int32),
        jnp.ones(B, jnp.float32))
    got, n = sampling.spec_accept(
        torch.from_numpy(tl), torch.from_numpy(dl), torch.from_numpy(d),
        [0.0] * B, [0] * B, [1.0] * B, 0, list(range(B)), [0] * B)
    assert n.tolist() == np.asarray(want_n).tolist()
    assert n.tolist()[:3] == [3, K + 1, 1]
    for b in range(B):
        k = int(n[b])
        assert got[b, :k].tolist() == np.asarray(want)[b, :k].tolist()


def _np_filter(logits, temp, top_k, top_p):
    return np.asarray(jsampling._filter_logits(
        jnp.asarray(logits), jnp.asarray(temp, jnp.float32),
        jnp.asarray(top_k, jnp.int32), jnp.asarray(top_p, jnp.float32)))


def _np_softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _np_spec_accept(tl, dl, d, temp, top_k, top_p, u, g):
    """numpy transcription of paddle_tpu/serving/sampling.py
    spec_accept's sampled path, its draws given."""
    B, K1, V = tl.shape
    K = K1 - 1
    greedy = temp <= 0
    tgt = tl.argmax(-1)

    def filt(lg):
        N = lg.shape[1]
        return _np_filter(lg.reshape(B * N, V), np.repeat(temp, N),
                          np.repeat(top_k, N),
                          np.repeat(top_p, N)).reshape(B, N, V)

    p, q = _np_softmax(filt(tl)), _np_softmax(filt(dl))
    rows = np.arange(B)[:, None]
    p_d = p[rows, np.arange(K)[None], d]
    q_d = q[rows, np.arange(K)[None], d]
    acc = np.where(greedy[:, None], d == tgt[:, :K],
                   u * np.maximum(q_d, 1e-20) < p_d)
    m = np.cumprod(acc.astype(np.int64), -1).sum(-1)
    q_pad = np.concatenate([q, np.zeros_like(p[:, :1])], 1)
    p_m, q_m = p[np.arange(B), m], q_pad[np.arange(B), m]
    res = np.maximum(p_m - q_m, 0.0)
    res = np.where(res.sum(-1, keepdims=True) > 1e-9, res, p_m)
    resampled = (np.log(np.maximum(res, 1e-30)) + g).argmax(-1)
    corr = np.where(greedy, tgt[np.arange(B), m], resampled)
    return m, corr


def test_spec_accept_core_matches_numpy_transcription():
    B, K, V = 4, 4, 50
    tl, dl, d = _accept_inputs(B, K, V, 1)
    temp = np.asarray([0.0, 0.7, 1.0, 1.3], np.float32)
    top_k = np.asarray([0, 10, 0, 5], np.int32)
    top_p = np.asarray([1.0, 0.9, 1.0, 0.95], np.float32)
    rng = np.random.default_rng(3)
    u = rng.random((B, K)).astype(np.float32)
    g = rng.gumbel(size=(B, V)).astype(np.float32)
    m, corr = _np_spec_accept(tl, dl, d, temp, top_k, top_p, u, g)
    got, n = sampling.spec_accept_core(
        torch.from_numpy(tl), torch.from_numpy(dl), torch.from_numpy(d),
        temp.tolist(), top_k.tolist(), top_p.tolist(), torch.from_numpy(u),
        torch.from_numpy(g))
    assert n.tolist() == (m + 1).tolist()
    for b in range(B):
        assert got[b, :m[b]].tolist() == d[b, :m[b]].tolist()
        assert int(got[b, m[b]]) == int(corr[b])
    assert 0 < m.sum() < B * K         # both accepts and misses occur


def test_emitted_tokens_follow_the_target_distribution():
    """The first emitted token of 4000 independent streams (draft
    proposals drawn from q, the rule's uniforms and noise from each
    stream) follows the target softmax p: chi-square(7) below 24.32."""
    B, K, V = 4000, 2, 8
    rng = np.random.default_rng(1)
    tl = np.broadcast_to(rng.standard_normal((1, K + 1, V)),
                         (B, K + 1, V)).astype(np.float32)
    ql = np.broadcast_to(rng.standard_normal((1, K, V)),
                         (B, K, V)).astype(np.float32)
    gen = torch.Generator().manual_seed(9)
    q = torch.softmax(torch.from_numpy(ql[0]), -1)
    d = torch.stack([torch.multinomial(q[j], B, replacement=True,
                                       generator=gen) for j in range(K)], 1)
    toks, n = sampling.spec_accept(
        torch.from_numpy(tl), torch.from_numpy(ql), d, [1.0] * B, [0] * B,
        [1.0] * B, 5, list(range(B)), [0] * B)
    assert int(n.min()) >= 1
    obs = np.bincount(toks[:, 0].numpy(), minlength=V)
    want = _np_softmax(tl[0, 0].astype(np.float64)) * B
    chi2 = float(((obs - want) ** 2 / want).sum())
    assert chi2 < 24.32, (chi2, obs, want)


def _run(engine, prompts, **kw):
    reqs = [engine.submit(p, max_new_tokens=NEW_TOKENS, **kw)
            for p in prompts]
    try:
        return [r.result(timeout=120) for r in reqs]
    finally:
        engine.shutdown()


@functools.lru_cache(maxsize=None)
def _jax_spec_streams(paged):
    tree, _ = _params()
    jparams = jax.tree.map(jnp.asarray, tree)
    eng = JaxEngine(CFG_J, jparams, paged=paged,
                    draft=jg.gpt_truncate(CFG_J, jparams, 2), spec_k=SPEC_K,
                    **ENGINE_KW)
    return _run(eng, _prompts())


def _port_engine(spec, paged, **kw):
    _, params = _params()
    draft = tg.gpt_truncate(CFG, params, 2) if spec else None
    return InferenceEngine(CFG, params, paged=paged, device="cpu",
                           draft=draft, **{**ENGINE_KW, "spec_k": SPEC_K,
                                           **kw})


@functools.lru_cache(maxsize=None)
def _port_streams(spec, paged):
    return _run(_port_engine(spec, paged), _prompts())


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_spec_streams_match_jax_and_non_spec(paged):
    p0, a0 = stat_get("spec_proposed"), stat_get("spec_accepted")
    got = _port_streams(True, paged)
    assert got == _jax_spec_streams(paged)
    assert got == _port_streams(False, paged)
    assert all(len(t) == NEW_TOKENS for t in got)
    proposed = stat_get("spec_proposed") - p0
    accepted = stat_get("spec_accepted") - a0
    assert proposed > 0 and 0 < accepted <= proposed
    assert 0 < stat_get("spec_acceptance_rate") <= 100


@pytest.mark.parametrize("paged", [False, True])
def test_draft_equal_to_target_accepts_every_proposal(paged):
    """A draft of the target's own layers proposes the target's greedy
    tokens, so every proposal is accepted and every tick emits k+1. That
    holds only if the draft's cache gains the K/V of its last proposal,
    which it never consumes, before the next tick drafts past it."""
    _, params = _params()
    p0, a0 = stat_get("spec_proposed"), stat_get("spec_accepted")
    eng = InferenceEngine(
        CFG, params, paged=paged, device="cpu",
        draft=tg.gpt_truncate(CFG, params, CFG.n_layers),
        **{**ENGINE_KW, "spec_k": SPEC_K})
    assert _run(eng, _prompts()) == _port_streams(False, paged)
    proposed = stat_get("spec_proposed") - p0
    assert proposed > 0
    assert stat_get("spec_accepted") - a0 == proposed


def test_spec_paged_preemption_resume_is_token_identical():
    """A pool too small for three streams preempts the youngest; it
    resumes through the draft's chunk append and its stream is
    unchanged."""
    before = stat_get("serving_preemptions")
    eng = _port_engine(True, True, n_slots=3, n_blocks=10)
    got = _run(eng, _prompts()[1:])
    assert stat_get("serving_preemptions") > before
    assert got == _port_streams(False, False)[1:]


def _sampled(neighbours, paged):
    eng = _port_engine(True, paged, seed=11)
    prompts = _prompts()
    reqs = [eng.submit(prompts[0], max_new_tokens=NEW_TOKENS,
                       temperature=0.9, top_k=50, top_p=0.95)]
    for i in range(neighbours):
        reqs.append(eng.submit(prompts[1 + i % 3], max_new_tokens=NEW_TOKENS,
                               temperature=0.7 if i % 2 else 0.0))
    try:
        return [r.result(timeout=120) for r in reqs]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("paged", [False, True])
def test_sampled_spec_stream_independent_of_batch_neighbours(paged):
    alone = _sampled(0, paged)[0]
    crowded = _sampled(3, paged)
    assert crowded[0] == alone
    assert all(0 <= t < CFG.vocab_size for r in crowded for t in r)
    assert alone != _port_streams(False, False)[0]   # really sampled


def test_eos_truncates_a_burst():
    """An eos inside an accepted burst ends the stream there."""
    want = _port_streams(False, False)[3]
    eos = want[4]
    eng = _port_engine(True, False)
    try:
        got = eng.generate(_prompts()[3], max_new_tokens=NEW_TOKENS,
                           eos_id=eos)
    finally:
        eng.shutdown()
    assert got == want[:want.index(eos) + 1]


def test_refusals_match_jax():
    _, params = _params()
    draft = tg.gpt_truncate(CFG, params, 2)
    with pytest.raises(ValueError, match="spec_k"):
        _port_engine(True, False, spec_k=0)
    with pytest.raises(ValueError, match="vocab"):
        InferenceEngine(CFG, params, device="cpu", draft=(
            dataclasses.replace(draft[0], vocab_size=256), draft[1]))
    with pytest.raises(ValueError, match="seq_len"):
        InferenceEngine(CFG, params, device="cpu", draft=(
            dataclasses.replace(draft[0], seq_len=32), draft[1]))
    with pytest.raises(ValueError, match="MoE"):
        InferenceEngine(tg.gpt_tiny(moe_experts=4), params, device="cpu",
                        draft=draft)
    with pytest.raises(ValueError, match="draft"):
        InferenceEngine(CFG, params, device="cpu", paged=True,
                        prefix_cache=True, draft=draft)
    with pytest.raises(ValueError, match="MoE"):
        tg.gpt_verify_step(tg.gpt_tiny(moe_experts=4), params, (None, None),
                           torch.zeros(1, dtype=torch.int32),
                           torch.zeros((1, 2), dtype=torch.int32))
