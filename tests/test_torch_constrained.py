"""paddle_tpu_torch tokenizer and constrained decoding against paddle_tpu.

The byte tokenizer's ids and text, the regex / JSON-schema DFAs and each
state's token mask must equal the JAX package's exactly (the same pure
Python). Greedy constrained streams and ``submit(text=...)`` streams of
the port's engine must equal the JAX engine's, token for token, in f32,
in both cache modes. A bounded regex must end every stream, greedy and
sampled, with finish_reason "stop" inside ``max_new_tokens``, its bytes a
full match of the DFA.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as jg
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import constrained as jcon
from paddle_tpu.serving import tokenizer as jtok
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.monitor.stats import stat_get
from paddle_tpu_torch.serving import InferenceEngine
from paddle_tpu_torch.serving import constrained as tcon
from paddle_tpu_torch.serving import tokenizer as ttok
from torch_jax_util import scaled_params
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

MERGES = ["the ", "ing", "yes", ", ", "é"]
TEXTS = ["hello", "the thing, the ring", "naïve café — 東京 🚀", "",
         "yes, 42."]
REGEXES = [r"-?(0|[1-9][0-9]*)", r"(yes|no), [0-9]{1,3}\.", r"[a-c]+x?",
           r"\{\"k\":(true|false)\}", r"[^a-z]{2,3}"]
SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string", "pattern": "[a-z]{1,6}"},
    "n": {"type": "integer"}, "ok": {"type": "boolean"},
    "tag": {"enum": ["a", "b"]},
    "xs": {"type": "array", "items": {"type": "integer"},
           "minItems": 1, "maxItems": 2}}}
BOUNDED = r"(yes|no), [0-9]{1,3}\."
NEW = 12


@pytest.mark.parametrize("merges", [None, MERGES])
def test_tokenizer_matches_jax_and_round_trips(merges):
    tok, jt = ttok.ByteTokenizer(merges), jtok.ByteTokenizer(merges)
    assert tok.vocab_size == jt.vocab_size and tok.eos_id == jt.eos_id
    for text in TEXTS:
        ids = tok.encode(text)
        assert ids.tolist() == jt.encode(text).tolist()
        assert tok.decode(ids) == jt.decode(ids) == text
        # utf-8 split across tokens: the stream holds partial sequences
        det = tok.stream_detokenizer()
        out = [det.push(int(t)) for t in ids] + [det.flush()]
        jdet = jt.stream_detokenizer()
        want = [jdet.push(int(t)) for t in ids] + [jdet.flush()]
        assert out == want and "".join(out) == text
        assert "�" not in "".join(out)
    assert tok.decode([tok.eos_id], skip_special=False) == "<|eos|>"


@pytest.mark.parametrize("pattern", REGEXES + ["schema"])
def test_dfa_and_masks_match_jax(pattern):
    regex = tcon.schema_to_regex(SCHEMA) if pattern == "schema" else pattern
    assert pattern != "schema" or regex == jcon.schema_to_regex(SCHEMA)
    dfa, jdfa = tcon.compile_regex(regex), jcon.compile_regex(regex)
    assert dfa.trans == jdfa.trans and dfa.accepting == jdfa.accepting
    samples = [b"-42", b"0", b"01", b"yes, 7.", b"no, 1234.", b"abcx",
               b'{"k":true}', b"12", b"@@@@", b"",
               b'{"name":"ab","n":-3,"ok":true,"tag":"b","xs":[1,2]}']
    for s in samples:
        assert dfa.matches(s) == jdfa.matches(s), s
    tok, jt = ttok.ByteTokenizer(MERGES), jtok.ByteTokenizer(MERGES)
    con = tcon.compile_constraint(tokenizer=tok, regex=regex, vocab_size=300)
    jc = jcon.compile_constraint(tokenizer=jt, regex=regex, vocab_size=300)
    for state in range(len(dfa.trans)):
        assert np.array_equal(con.mask(state), jc.mask(state)), state


@functools.lru_cache(maxsize=None)
def _model():
    """gpt_tiny over the tokenizer's vocabulary, block matrices scaled x4
    so that greedy streams vary from token to token."""
    tok = ttok.ByteTokenizer(MERGES)
    cfg_j = jg.gpt_tiny(dtype=jnp.float32, seq_len=64,
                        vocab_size=tok.vocab_size)
    cfg = tg.gpt_tiny(dtype=torch.float32, seq_len=64,
                      vocab_size=tok.vocab_size)
    tree, params = scaled_params(cfg_j)
    return cfg_j, tree, cfg, params


def _requests(eng, con):
    """Text without a constraint, then two constrained greedy requests."""
    reqs = [eng.submit(text="the thing is", max_new_tokens=NEW),
            eng.submit(text="answer: ", max_new_tokens=NEW, constraint=con),
            eng.submit(text="ok? ", max_new_tokens=NEW, constraint=con)]
    try:
        return [(r.result(timeout=120), r.finish_reason) for r in reqs]
    finally:
        eng.shutdown()


@functools.lru_cache(maxsize=None)
def _jax_streams(paged):
    cfg_j, tree, _, _ = _model()
    jt = jtok.ByteTokenizer(MERGES)
    con = jcon.compile_constraint(tokenizer=jt, regex=BOUNDED,
                                  vocab_size=cfg_j.vocab_size)
    eng = JaxEngine(cfg_j, jax.tree.map(jnp.asarray, tree), n_slots=2,
                    max_len=64, paged=paged, block_size=8, prefill_chunk=16,
                    tokenizer=jt)
    return _requests(eng, con)


def _port_engine(paged, **kw):
    _, _, cfg, params = _model()
    tok = ttok.ByteTokenizer(MERGES)
    eng = InferenceEngine(cfg, params, device="cpu", n_slots=2, max_len=64,
                          paged=paged, block_size=8, prefill_chunk=16,
                          tokenizer=tok, **kw)
    con = tcon.compile_constraint(tokenizer=tok, regex=BOUNDED,
                                  vocab_size=cfg.vocab_size)
    return eng, tok, con


@pytest.mark.parametrize("paged", [False, True])
def test_text_and_constrained_streams_match_jax_engine(paged):
    eng, _, con = _port_engine(paged)
    c0 = stat_get("constrained_requests")
    got = _requests(eng, con)
    assert got == _jax_streams(paged)
    assert stat_get("constrained_requests") == c0 + 2
    assert [r for _, r in got[1:]] == ["stop", "stop"]
    assert got[0][1] in ("eos", "length")


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_bounded_regex_ends_with_stop_and_matches(temperature):
    eng, tok, con = _port_engine(True, seed=4)
    dfa = tcon.compile_regex(BOUNDED)
    try:
        reqs = [eng.submit(text=f"q{i}: ", max_new_tokens=NEW,
                           temperature=temperature, constraint=con)
                for i in range(4)]
        outs = [(r.result(timeout=120), r.finish_reason, r.text())
                for r in reqs]
    finally:
        eng.shutdown()
    for ids, reason, text in outs:
        assert reason == "stop" and len(ids) <= NEW
        data = b"".join(tok.token_bytes(t) for t in ids
                        if tok.token_bytes(t) is not None)
        assert dfa.matches(data), data
        assert text == data.decode("utf-8")


def test_constrained_rows_take_the_one_token_tick():
    """A speculative engine drops a tick with a constrained row to the
    one-token decode (the draft is not mask-aware): the stream equals the
    non-speculative engine's and the fallback is counted."""
    _, _, cfg, params = _model()
    plain, _, con = _port_engine(False)
    want = plain.generate(text="answer: ", max_new_tokens=NEW,
                          constraint=con)
    plain.shutdown()
    spec, _, con = _port_engine(False, draft=tg.gpt_truncate(cfg, params, 2),
                                spec_k=2)
    f0 = stat_get("constrained_fallback_ticks")
    try:
        got = spec.generate(text="answer: ", max_new_tokens=NEW,
                            constraint=con)
    finally:
        spec.shutdown()
    assert got == want
    assert stat_get("constrained_fallback_ticks") > f0


def test_text_front_end_refusals():
    eng, _, _ = _port_engine(False)
    try:
        with pytest.raises(ValueError, match="OR text"):
            eng.submit([1, 2], text="x")
        with pytest.raises(ValueError, match="prompt"):
            eng.submit()
        big = tcon.compile_constraint(tokenizer=ttok.ByteTokenizer(MERGES),
                                      regex="a", vocab_size=4096)
        with pytest.raises(ValueError, match="vocab"):
            eng.submit(text="x", constraint=big)
    finally:
        eng.shutdown()
    _, _, cfg, params = _model()
    bare = InferenceEngine(cfg, params, device="cpu", n_slots=1, max_len=64)
    try:
        with pytest.raises(ValueError, match="tokenizer"):
            bare.submit(text="x")
        req = bare.submit([1, 2], max_new_tokens=1)
        req.result(timeout=60)
        with pytest.raises(RuntimeError, match="tokenizer"):
            req.text()
    finally:
        bare.shutdown()
