"""Mixture-of-Experts routing and the routed expert FFN.

Counterpart of ``paddle_tpu/nn/moe.py`` (GShard / Switch Transformer
top-k routing with capacity-factor dispatch), its pure functions only:

- :func:`moe_capacity` — per-expert capacity C;
- :func:`moe_route` — softmax gating in f32, top-k experts per token by
  iterated argmax (lowest index first on ties, as ``torch.argmax`` and
  ``jnp.argmax`` both break them), gates renormalized over the chosen k,
  the aux load-balancing loss and the router z-loss, and the capacity
  slots in rank-major, token-order priority;
- :func:`moe_ffn` — route, gather the routed rows into the (E·C, H)
  grid (``ops/moe_dispatch.py``, the gather kernel on the card), the
  per-expert gelu MLP, the composed combine.

Only the single-device formulation (``expert_axis=None``) is ported; an
expert axis belongs to the multi-GPU slice and raises
``NotImplementedError``. The eager ``MoELayer`` waits for the Paddle-style
API. Routing never reads a tensor on the host.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.moe_dispatch import moe_combine_scatter, moe_dispatch_gather

__all__ = ["moe_route", "moe_ffn", "moe_capacity"]


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: Optional[float]) -> int:
    """Per-expert capacity C. ``None`` = dropless (C = T: a token sends
    at most one assignment per expert, so T slots can never overflow)."""
    if capacity_factor is None:
        return max(1, int(n_tokens))
    return max(1, min(int(n_tokens),
                      int(math.ceil(float(capacity_factor) * top_k
                                    * n_tokens / n_experts))))


def moe_route(router_w, x, *, top_k: int,
              capacity_factor: Optional[float] = None):
    """Route tokens to experts. x (T, H); router_w (H, E).

    Returns ``(gates (T,k) f32, slots (T,k) int32, src (E·C,) int32,
    aux f32, z f32, counts (E,) int32, dropped int32)``: ``slots[t, r]``
    is the flat capacity slot ``e·C + c`` of token t's rank-r assignment
    or −1 if dropped; ``src`` the inverse permutation (−1 = empty slot);
    ``counts`` the tokens each expert accepted; ``dropped`` the
    assignments past capacity."""
    T = x.shape[0]
    E = router_w.shape[-1]
    k = int(top_k)
    if not 1 <= k <= E:
        raise ValueError(f"top_k={k} outside [1, n_experts={E}]")
    C = moe_capacity(T, E, k, capacity_factor)
    dev = x.device

    logits = x.float() @ router_w.float()                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    z = torch.logsumexp(logits, dim=-1).square().mean()
    # top-k by iterated argmax, as JAX does (its order and tie-breaking
    # are top_k's: descending, lowest index first)
    vals, idxs, masked = [], [], probs
    for _ in range(k):
        i = masked.argmax(dim=-1)                                # (T,)
        vals.append(probs.gather(-1, i[:, None])[:, 0])
        idxs.append(i)
        masked = masked - F.one_hot(i, E).to(masked.dtype) * 2.0
    gate_vals = torch.stack(vals, dim=-1)                        # (T, k)
    gate_idx = torch.stack(idxs, dim=-1)                         # (T, k)
    gates = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # aux load balance: mean router prob x fraction of top-1 traffic,
    # summed over experts and scaled by E (uniform routing -> aux = 1)
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx[:, 0], E).float().mean(dim=0)
    aux = E * (me * ce).sum()

    # capacity slots, rank-major priority: rank r claims positions after
    # every kept rank<r assignment; within a rank, token order (cumsum).
    # Dropped assignments write one sentinel slot past the grid, sliced
    # off below (JAX's out-of-range writes with mode="drop")
    counts = torch.zeros((E,), dtype=torch.long, device=dev)
    src = torch.full((E * C + 1,), -1, dtype=torch.int32, device=dev)
    tok = torch.arange(T, dtype=torch.int32, device=dev)
    slots = []
    for r in range(k):
        idx = gate_idx[:, r]
        mask = F.one_hot(idx, E)                                 # (T, E)
        pos = counts[None, :] + mask.cumsum(dim=0) - mask
        pos_t = (pos * mask).sum(dim=1)                          # (T,)
        kept = pos_t < C
        slot_r = torch.where(kept, idx * C + pos_t, -1)
        src.scatter_(0, torch.where(kept, slot_r, E * C), tok)
        counts = counts + (mask * kept[:, None]).sum(dim=0)
        slots.append(slot_r)
    slots = torch.stack(slots, dim=1).to(torch.int32)            # (T, k)
    gates = torch.where(slots >= 0, gates, 0.0)
    dropped = (T * k - counts.sum()).to(torch.int32)
    return (gates, slots, src[:E * C], aux, z, counts.to(torch.int32),
            dropped)


def _expert_ffn(p, expert_in, cd):
    """Per-expert gelu MLP over the packed grid. expert_in (E, C, H)."""
    h = F.gelu(torch.bmm(expert_in, p["w_in"].to(cd))
               + p["b_in"].to(cd)[:, None, :], approximate="tanh")
    return torch.bmm(h, p["w_out"].to(cd)) + p["b_out"].to(cd)[:, None, :]


def moe_ffn(p, x, *, top_k: int, capacity_factor: Optional[float] = None,
            expert_axis: Optional[str] = None):
    """The routed expert FFN. x (T, H) in the compute dtype; ``p`` holds
    ``router_w (H, E)``, ``w_in (E, H, M)``, ``b_in (E, M)``,
    ``w_out (E, M, H)``, ``b_out (E, H)``.

    Returns ``(y (T, H), aux, z, counts (E,), dropped)``: y is the expert
    mix only (zero for fully dropped tokens); the caller adds the
    residual."""
    if expert_axis is not None:
        raise NotImplementedError(
            "expert parallelism (expert_axis / GPTConfig.moe_axis) is not "
            "ported to paddle_tpu_torch yet (see ROADMAP.md)")
    cd = x.dtype
    E = p["router_w"].shape[-1]
    gates, slots, src, aux, z, counts, dropped = moe_route(
        p["router_w"], x, top_k=top_k, capacity_factor=capacity_factor)
    C = src.shape[0] // E
    expert_in = moe_dispatch_gather(x, src).reshape(E, C, -1)
    out = _expert_ffn(p, expert_in, cd)
    y = moe_combine_scatter(out.reshape(E * C, -1), slots, gates)
    return y, aux, z, counts, dropped
