"""Beam-search decoding: ``beam_search``, ``BeamSearchDecoder`` and
``dynamic_decode`` (``paddle_tpu/nn/decode.py``).

The search follows the JAX package's ``_beam_search``: the beams ride a
[batch, beam] axis; at the start beam 0 is alive and the others sit at
−1e9, so the first top-k does not pick K copies of one hypothesis; a
finished beam continues only with the end token, at no cost; each step
takes the top K of the beam·vocab totals of a row, reorders the token
history and the cell states by the winners' parents and writes the new
tokens; the lengths count the end token. Where the JAX package runs one
``lax.scan``, the port runs a Python loop of ``max_len`` steps with no
host read in it (the tensors stay on their device until the caller reads
the result).

The state tree may hold tuples, lists and dicts of Tensors; each leaf
is [batch, ...] and is repeated K times per row (``repeat_interleave``,
the JAX package's ``jnp.repeat`` order: row b's beams at b·K ... b·K +
K − 1).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..framework.core import Tensor

__all__ = ["beam_search", "BeamSearchDecoder", "dynamic_decode"]

NEG_INF = -1e9


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree, out):
    if isinstance(tree, (tuple, list)):
        for t in tree:
            _tree_leaves(t, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tree_leaves(v, out)
    else:
        out.append(tree)
    return out


def _beam_search(init_states, step_fn, bos_id, eos_id, beam_size, max_len,
                 batch, device):
    K = beam_size
    states = _tree_map(lambda s: s.repeat_interleave(K, dim=0), init_states)
    # built without a host-to-device write: the loop reads nothing on
    # the host and writes nothing from it
    log_probs = torch.where(torch.arange(K, device=device) == 0, 0.0,
                            NEG_INF).expand(batch, K)
    tokens = torch.full((batch * K,), bos_id, dtype=torch.int64,
                        device=device)
    finished = torch.zeros((batch, K), dtype=torch.bool, device=device)
    seqs = torch.full((batch, K, max_len), eos_id, dtype=torch.int64,
                      device=device)
    row_base = (torch.arange(batch, device=device) * K)[:, None]
    eos_row = None
    for t in range(max_len):
        logp, new_states = step_fn(tokens, states)              # [B*K, V]
        V = logp.shape[-1]
        logp = logp.reshape(batch, K, V)
        if eos_row is None:
            eos_row = torch.where(torch.arange(V, device=device) == eos_id,
                                  0.0, NEG_INF).to(logp.dtype)
        # finished beams: only the end token continues, at no cost
        logp = torch.where(finished[:, :, None], eos_row, logp)
        total = log_probs[:, :, None] + logp                     # [B, K, V]
        top_val, top_idx = torch.topk(total.reshape(batch, K * V), K,
                                      dim=1)
        parent = torch.div(top_idx, V, rounding_mode="floor")    # [B, K]
        token = top_idx - parent * V
        finished = torch.gather(finished, 1, parent) | (token == eos_id)
        seqs = torch.gather(seqs, 1, parent[:, :, None].expand(seqs.shape))
        seqs[:, :, t] = token
        flat_parent = (parent + row_base).reshape(-1)
        states = _tree_map(lambda s: s.index_select(0, flat_parent),
                           new_states)
        log_probs = top_val
        tokens = token.reshape(-1)
    is_eos = seqs == eos_id
    lengths = torch.where(is_eos.any(-1),
                          is_eos.int().argmax(-1) + 1,
                          torch.full_like(seqs[:, :, 0], max_len))
    return seqs, log_probs, lengths


def beam_search(step_fn: Callable, init_states, bos_id: int, eos_id: int,
                beam_size: int, max_len: int, batch_size: int):
    """Beam search over ``step_fn(tokens [N] int64, states) → (log_probs
    [N, V], states)`` on torch tensors, N = batch_size·beam_size;
    ``init_states`` a tree of [batch_size, ...] tensors (Tensors, torch
    tensors or numpy arrays; the search runs on the first tensor's
    device, numpy goes there, or to the current device if all are
    numpy). Returns Tensors (sequences [B, beam, max_len] best first,
    scores [B, beam], lengths [B, beam] with the end token)."""
    from ..device import current_device

    leaves = [t for t in _tree_leaves(init_states, [])
              if isinstance(t, (Tensor, torch.Tensor))]
    device = (_unwrap_tree(leaves[0]).device if leaves
              else current_device())
    init_states = _tree_map(
        lambda t: t._data if isinstance(t, Tensor) else torch.as_tensor(
            t, device=device), init_states)
    seqs, scores, lengths = _beam_search(
        init_states, step_fn, int(bos_id), int(eos_id), int(beam_size),
        int(max_len), int(batch_size), device)
    return Tensor(seqs), Tensor(scores), Tensor(lengths)


class BeamSearchDecoder:
    """The reference's ``BeamSearchDecoder`` surface: a cell with a token
    embedding and an output projection, decoded by
    :func:`dynamic_decode`. The cell's output after ``output_fn`` is the
    logits; the step takes their log-softmax."""

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def _step(self, tokens, states, **kwargs):
        tok = Tensor(tokens)
        inputs = self.embedding_fn(tok) if self.embedding_fn else tok
        out, new_states = self.cell(inputs, _wrap(states), **kwargs)
        if self.output_fn is not None:
            out = self.output_fn(out)
        logits = out._data if isinstance(out, Tensor) else out
        return torch.log_softmax(logits, dim=-1), _unwrap_tree(new_states)


def _wrap(states):
    return _tree_map(Tensor._wrap, states)


def _unwrap_tree(states):
    return _tree_map(lambda t: t._data if isinstance(t, Tensor) else t,
                     states)


def dynamic_decode(decoder: BeamSearchDecoder, inits=None,
                   max_step_num: Optional[int] = None, batch_size=None,
                   **kwargs):
    """Run the decoder for ``max_step_num`` steps (required, as in the
    JAX package: the loop has a fixed trip count). Keyword arguments go
    to the cell at every step, as the reference passes them (a tensor
    among them is [batch·beam, ...], each row repeated per beam as
    ``repeat_interleave`` repeats it). Returns
    (sequences [B, beam, T], already backtraced, scores [B, beam],
    lengths [B, beam])."""
    if max_step_num is None:
        raise RuntimeError("dynamic_decode needs max_step_num: the decode "
                           "loop runs a fixed number of steps (finished "
                           "beams pad with end_token at no cost)")
    states = _unwrap_tree(inits if inits is not None else {})
    leaves = _tree_leaves(states, [])
    if batch_size is None:
        if not leaves:
            raise RuntimeError("dynamic_decode needs inits (cell states) "
                               "or batch_size")
        batch_size = leaves[0].shape[0]
    step = decoder._step
    if kwargs:
        step = lambda tokens, st: decoder._step(tokens, st, **kwargs)  # noqa: E731
    return beam_search(step, states, decoder.start_token, decoder.end_token,
                       decoder.beam_size, int(max_step_num), int(batch_size))
