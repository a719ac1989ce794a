"""Token sampling for the serving engine — vectorized, per-row params.

Counterpart of ``paddle_tpu/serving/sampling.py``. One filter chain
covers greedy, temperature, top-k and top-p, with every row carrying its
own (temperature, top_k, top_p): ``temperature <= 0`` is greedy (argmax
of the raw logits), ``top_k <= 0`` and ``top_p >= 1`` disable those
filters. An optional (B, V) bool mask suppresses disallowed tokens ahead
of the chain.

Per-request streams: a sampled row draws its Gumbel noise from a
``torch.Generator`` seeded from (engine seed, request id, draw index)
alone, so a stream never depends on which neighbours share the batch,
which slot the request landed in or how many ticks the engine has run —
the property ``stream_keys`` gives the JAX engine. The generators are
PyTorch's, not JAX's: sampled streams do not reproduce the JAX package's
tokens bit for bit (greedy rows do, up to the logits' numerics).

Speculative decoding: :func:`spec_accept` applies the rejection-sampling
rule (Leviathan et al., 2023) to a draft's k proposals against the
target's k+1 verify logits; :func:`spec_accept_core` is the same rule
given the acceptance uniforms and the residual's Gumbel noise as
tensors. The draft's proposals, the uniforms and the noise come from
the request's own stream under three salts of their own, so a
speculative stream too depends on (seed, request id, draw) alone.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["sample_tokens_streams", "stream_seed", "spec_accept",
           "spec_accept_core", "MASKED_LOGIT", "DRAFT_SALT", "ACCEPT_SALT",
           "RESIDUAL_SALT"]

# suppression value for masked-out vocabulary entries
MASKED_LOGIT = -1e30

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a bijective 64-bit hash."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


# salts separating the independent draws a speculative tick makes from
# one request's stream (draft proposal / accept uniforms / residual)
DRAFT_SALT = 1
ACCEPT_SALT = 2
RESIDUAL_SALT = 3


def stream_seed(seed: int, rid: int, draw: int, salt: int = 0) -> int:
    """Generator seed of one draw of one request's stream: a pure
    function of (engine seed, request id, draw index, salt); salt 0 is
    the plain token draw."""
    h = _mix64(_mix64(_mix64(int(seed) & _M64) ^ (int(rid) & _M64))
               ^ (int(draw) & _M64))
    if salt:
        h = _mix64(h ^ (int(salt) & _M64))
    return h & ((1 << 63) - 1)


def _apply_mask(logits, mask):
    """Suppress disallowed tokens; ``mask`` (B, V) bool or None."""
    if mask is None:
        return logits
    return torch.where(mask, logits, MASKED_LOGIT)


def _filter_logits(logits, temperature, top_k, top_p):
    """Temperature scale → top-k → top-p (nucleus, on the k-filtered
    distribution); logits (B, V) f32, per-row params as tensors. Returns
    the filtered logits with suppressed entries at -inf."""
    V = logits.shape[-1]
    scaled = logits / temperature.clamp_min(1e-6)[:, None]

    # top-k with per-row k: keep values >= the k-th largest
    k_eff = torch.where(top_k > 0, top_k, V).clamp(1, V).long()
    sorted_desc = scaled.sort(dim=-1, descending=True).values
    kth = sorted_desc.gather(-1, (k_eff - 1)[:, None])
    scaled = torch.where(scaled >= kth, scaled, -torch.inf)

    # top-p: keep the smallest prefix of the sorted distribution whose
    # mass reaches top_p (the top token always survives)
    sorted_desc = scaled.sort(dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    exclusive_cum = probs.cumsum(-1) - probs
    keep = exclusive_cum < top_p[:, None]
    cutoff = torch.where(keep, sorted_desc, torch.inf).amin(-1, keepdim=True)
    return torch.where(scaled >= cutoff, scaled, -torch.inf)


def _filter(logits, temps, top_k: Sequence[int], top_p: Sequence[float]):
    """The filter chain when some row enables top-k or top-p, else the
    temperature scale alone (JAX's ``_filter_logits_cond``); temps (R,)
    and the host top_k/top_p are per row of ``logits`` (R, V)."""
    if any(int(k) > 0 for k in top_k) or any(float(p) < 1.0 for p in top_p):
        dev = logits.device
        return _filter_logits(
            logits, temps,
            torch.tensor([int(k) for k in top_k], device=dev),
            torch.tensor([float(p) for p in top_p], device=dev))
    return logits / temps.clamp_min(1e-6)[:, None]


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _gumbel(n: int, seed: int, device) -> torch.Tensor:
    u = torch.rand(n, generator=_generator(seed, device), device=device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _sampled_rows(temperature: Sequence[float]):
    return [b for b in range(len(temperature))
            if float(temperature[b]) > 0.0]


def sample_tokens_streams(logits, temperature: Sequence[float],
                          top_k: Sequence[int], top_p: Sequence[float],
                          seed: int, rids: Sequence[int],
                          draws: Sequence[int],
                          mask: Optional[torch.Tensor] = None,
                          salt: int = 0):
    """logits (B, V) → token ids (B,) int64 on logits' device.

    temperature/top_k/top_p/rids/draws are host sequences of length B;
    row b draws from the stream (seed, rids[b], draws[b], salt). All-
    greedy batches take the argmax and draw nothing."""
    logits = _apply_mask(logits.float(), mask)
    B, V = logits.shape
    greedy = logits.argmax(-1)
    sampled_rows = _sampled_rows(temperature)
    if not sampled_rows:
        return greedy
    dev = logits.device
    temps = torch.tensor([float(t) for t in temperature], device=dev)
    scaled = _filter(logits, temps, top_k, top_p)
    gumbel = torch.zeros_like(scaled)
    for b in sampled_rows:
        gumbel[b] = _gumbel(V, stream_seed(seed, rids[b], draws[b], salt),
                            dev)
    sampled = (scaled + gumbel).argmax(-1)
    return torch.where(temps <= 0.0, greedy, sampled)


def _spec_emit(draft_tokens, m, correction):
    """Row b emits its first ``m[b]`` proposals, then ``correction[b]``:
    returns (tokens (B, K+1) int64, n_emit (B,) int64)."""
    B, K = draft_tokens.shape
    idx = torch.arange(K + 1, device=m.device)[None, :]
    d_pad = torch.cat([draft_tokens.long(),
                       draft_tokens.new_zeros((B, 1)).long()], dim=1)
    tokens = torch.where(idx < m[:, None], d_pad,
                         torch.where(idx == m[:, None],
                                     correction.long()[:, None], 0))
    return tokens, m + 1


def _spec_greedy(target_logits, draft_tokens):
    """Greedy acceptance: while the proposal is the target's argmax, then
    the argmax at the first miss (or the bonus row)."""
    K = draft_tokens.shape[1]
    tgt = target_logits.argmax(-1)                              # (B, K+1)
    m = (draft_tokens.long() == tgt[:, :K]).long().cumprod(-1).sum(-1)
    return _spec_emit(draft_tokens, m, tgt.gather(1, m[:, None])[:, 0])


def spec_accept_core(target_logits, draft_logits, draft_tokens,
                     temperature: Sequence[float], top_k: Sequence[int],
                     top_p: Sequence[float], uniforms, gumbel):
    """The acceptance rule given its random draws.

    target_logits (B, K+1, V) — the verify pass over [last token,
    d_1..d_K]: row j is the target's distribution after consuming j
    proposals; draft_logits (B, K, V) — the distributions d_{j+1} was
    drawn from; draft_tokens (B, K); temperature/top_k/top_p host
    sequences of length B; uniforms (B, K) in [0, 1) and gumbel (B, V)
    tensors (read on sampled rows only). Greedy rows (temperature <= 0)
    accept while the proposal is the target's argmax and end on the
    argmax at the first miss (or the bonus row). Sampled rows accept d
    with probability ``min(1, p(d) / q(d))`` and resample at the first
    miss from ``normalize(max(0, p - q))`` — at the bonus row from p —
    where p and q are the FILTERED distributions, so the emitted stream
    keeps the target distribution. Returns (tokens (B, K+1) int64,
    n_emit (B,) int64): row b emits ``tokens[b, :n_emit[b]]``."""
    B, K1, V = target_logits.shape
    K = K1 - 1
    dev = target_logits.device
    target_logits = target_logits.float()
    temps = torch.tensor([float(t) for t in temperature], device=dev)
    greedy = temps <= 0.0
    tgt_argmax = target_logits.argmax(-1)                       # (B, K+1)

    def filt(lg):   # (B, N, V), each request's params over its N rows
        N = lg.shape[1]
        return _filter(lg.reshape(B * N, V), temps.repeat_interleave(N),
                       [k for k in top_k for _ in range(N)],
                       [q for q in top_p for _ in range(N)]).reshape(B, N, V)

    p = torch.softmax(filt(target_logits), dim=-1)              # (B, K+1, V)
    q = torch.softmax(filt(draft_logits.float()), dim=-1)       # (B, K, V)
    d = draft_tokens.long()[..., None]
    p_d = p[:, :K].gather(-1, d)[..., 0]
    q_d = q.gather(-1, d)[..., 0]
    acc_sampled = uniforms * q_d.clamp_min(1e-20) < p_d
    acc = torch.where(greedy[:, None], d[..., 0] == tgt_argmax[:, :K],
                      acc_sampled)
    m = acc.long().cumprod(-1).sum(-1)                          # (B,) 0..K

    # resample only at the selected position m: the residual max(0, p_m -
    # q_m) after a rejection, p_K at the bonus (q padded with 0 there)
    q_pad = torch.cat([q, torch.zeros_like(p[:, :1])], dim=1)
    at = m[:, None, None].expand(B, 1, V)
    p_m = p.gather(1, at)[:, 0]
    q_m = q_pad.gather(1, at)[:, 0]
    res = (p_m - q_m).clamp_min(0.0)
    res = torch.where(res.sum(-1, keepdim=True) > 1e-9, res, p_m)
    resampled = (torch.log(res.clamp_min(1e-30)) + gumbel).argmax(-1)
    correction = torch.where(greedy, tgt_argmax.gather(1, m[:, None])[:, 0],
                             resampled)
    return _spec_emit(draft_tokens, m, correction)


def spec_accept(target_logits, draft_logits, draft_tokens,
                temperature: Sequence[float], top_k: Sequence[int],
                top_p: Sequence[float], seed: int, rids: Sequence[int],
                draws: Sequence[int]):
    """:func:`spec_accept_core` with its draws taken from each request's
    stream: row b's uniforms from (seed, rids[b], draws[b], ACCEPT_SALT),
    its Gumbel noise from (..., RESIDUAL_SALT). An all-greedy batch takes
    the greedy rule alone and draws nothing. Host sequences of length B
    as in :func:`sample_tokens_streams`."""
    sampled_rows = _sampled_rows(temperature)
    if not sampled_rows:
        return _spec_greedy(target_logits.float(), draft_tokens)
    B, K1, V = target_logits.shape
    dev = target_logits.device
    uniforms = torch.zeros((B, K1 - 1), device=dev)
    gumbel = torch.zeros((B, V), device=dev)
    for b in sampled_rows:
        uniforms[b] = torch.rand(
            K1 - 1, device=dev, generator=_generator(
                stream_seed(seed, rids[b], draws[b], ACCEPT_SALT), dev))
        gumbel[b] = _gumbel(
            V, stream_seed(seed, rids[b], draws[b], RESIDUAL_SALT), dev)
    return spec_accept_core(target_logits, draft_logits, draft_tokens,
                            temperature, top_k, top_p, uniforms, gumbel)
