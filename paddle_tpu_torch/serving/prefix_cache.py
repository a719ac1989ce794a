"""Radix-tree prefix cache over the paged KV block pool.

Counterpart of ``paddle_tpu/serving/prefix_cache.py`` over the port's
single-shard :class:`~paddle_tpu_torch.serving.kv_cache.PagedKVCache`.

K/V for token position p is a pure function of tokens[:p+1], so two
requests whose prompts agree on their first N tokens can point their
block tables at the SAME pool blocks for those positions and only
prefill the tails. This is the host-side index that finds those blocks:
a radix tree keyed by token-id chunks (one tree level per pool block,
edge label = that block's token chunk), in the style of SGLang's
RadixAttention.

Contract with the pool:

- every tree node owns ONE pool reference on its block
  (``ref_block``), so a cached prefix survives the slot that wrote it;
  a slot that matches the prefix takes its own reference per block
  (``splice``) and releases it at eviction — releasing a slot
  decrements, never frees, and a block returns to the free list only
  when the tree AND every reader have let go;
- interior nodes hold FULL ``block_size``-token chunks; a node with a
  shorter chunk is a leaf (the partially-filled last block of some
  prompt). Matching may use any PREFIX of a node's chunk — attention
  masks by position, so a reader attending ``pos < matched`` never
  sees the unmatched tail of a block — but a slot that must WRITE into
  a partially-used shared block first copy-on-write-duplicates it
  (the engine's ``_cow``), because blocks handed out by the tree are
  read-only to everyone but their original writer;
- a match is capped at ``len(prompt) - 1`` tokens: the engine always
  re-prefills at least the last prompt token, whose logits seed the
  first sampled token;
- eviction is LRU-BY-LEAF: only childless nodes whose block has no
  reader beyond the tree itself (pool refcount 1) are reclaimable, in
  least-recently-matched order, so every cached prefix stays
  contiguous from the root. The scheduler reclaims tree leaves BEFORE
  it preempts live work.

All methods run on the engine's scheduler thread.

Gauges: ``prefix_matched_tokens`` / ``prefix_lookup_tokens`` feed the
``prefix_hit_rate`` percentage; ``prefix_cache_blocks`` tracks pool
blocks pinned by the tree; ``prefix_evictions`` counts LRU-reclaimed
leaves.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..monitor.stats import (PREFIX_CACHE_BLOCKS, PREFIX_EVICTIONS,
                             PREFIX_HIT_RATE, PREFIX_LOOKUP_TOKENS,
                             PREFIX_MATCHED_TOKENS)

__all__ = ["RadixPrefixCache"]


class _Node:
    """One cached block: ``chunk`` is the token-id tuple its K/V encode
    (full ``block_size`` for interior nodes, shorter only at leaves)."""

    __slots__ = ("chunk", "block", "children", "last_used", "_level")

    def __init__(self, chunk: Tuple[int, ...], block: int):
        self.chunk = chunk
        self.block = block
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0
        self._level: Optional[Dict] = None   # the children dict holding us


def _lcp(chunk: Tuple[int, ...], toks: List[int], start: int,
         limit: int) -> int:
    """Longest common prefix of ``chunk`` and ``toks[start:limit]``."""
    n = min(len(chunk), limit - start)
    i = 0
    while i < n and chunk[i] == toks[start + i]:
        i += 1
    return i


class RadixPrefixCache:
    """Host-side radix index of shared prompt prefixes in a
    :class:`~paddle_tpu_torch.serving.kv_cache.PagedKVCache` pool."""

    def __init__(self, cache):
        self.cache = cache
        self.block_size = int(cache.block_size)
        self._root: Dict[Tuple[int, ...], _Node] = {}
        self._clock = 0          # monotonic touch counter for LRU
        self._blocks = 0         # pool blocks currently pinned by the tree
        # lifetime counters behind the hit-rate gauge
        self._matched = 0
        self._looked_up = 0

    # -- lookup --------------------------------------------------------------
    def match(self, tokens) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens``.

        Returns ``(matched_len, blocks)``: the first ``matched_len``
        tokens of the prompt are already encoded in ``blocks`` (in table
        order; the last block may be only partially used when
        ``matched_len % block_size != 0`` — the engine copy-on-writes it
        before the slot extends it). Capped at ``len(tokens) - 1`` so
        the tail prefill always has at least one token to run. Touches
        the matched path for LRU."""
        toks = [int(t) for t in tokens]
        limit = len(toks) - 1
        self._clock += 1
        level = self._root
        blocks: List[int] = []
        used = 0
        while used < limit:
            best, best_lcp = None, 0
            for chunk, node in level.items():
                lcp = _lcp(chunk, toks, used, limit)
                if lcp > best_lcp:
                    best, best_lcp = node, lcp
            if best is None:
                break
            blocks.append(best.block)
            used += best_lcp
            best.last_used = self._clock
            if best_lcp < len(best.chunk) or len(best.chunk) < self.block_size:
                break            # partial use, or a leaf chunk — path ends
            level = best.children
        return used, blocks

    def peek(self, tokens) -> int:
        """Read-only twin of :meth:`match`: how many leading tokens of
        ``tokens`` the tree could serve now, without touching the LRU
        clock or the hit-rate gauges. Uncapped: a fully cached prompt
        peeks at its full length (``match`` stops one token short)."""
        toks = [int(t) for t in tokens]
        limit = len(toks)
        level = self._root
        used = 0
        while used < limit:
            best, best_lcp = None, 0
            for chunk, node in level.items():
                lcp = _lcp(chunk, toks, used, limit)
                if lcp > best_lcp:
                    best, best_lcp = node, lcp
            if best is None:
                break
            used += best_lcp
            if best_lcp < len(best.chunk) or len(best.chunk) < self.block_size:
                break
            level = best.children
        return used

    def note_lookup(self, matched: int, total: int) -> None:
        """Feed the hit-rate gauge (the engine calls this once per
        admission, with the prompt length it looked up)."""
        self._matched += int(matched)
        self._looked_up += int(total)
        PREFIX_MATCHED_TOKENS.add(int(matched))
        PREFIX_LOOKUP_TOKENS.add(int(total))
        if self._looked_up > 0:
            PREFIX_HIT_RATE.set(
                int(round(100.0 * self._matched / self._looked_up)))

    # -- insertion -----------------------------------------------------------
    def insert(self, tokens, table: Sequence[int]) -> int:
        """Register a fully-prefilled prompt: walk ``tokens`` in
        block-size chunks, adopting ``table``'s blocks for chunks the
        tree does not hold yet (one tree reference each). Existing
        chunks are touched, not replaced — the first writer wins, later
        identical prompts keep their private blocks (their content is
        identical anyway; LRU reclaims the duplicates). Returns the
        number of blocks newly adopted."""
        toks = [int(t) for t in tokens]
        bs = self.block_size
        self._clock += 1
        level = self._root
        adopted = 0
        for i in range(0, len(toks), bs):
            chunk = tuple(toks[i:i + bs])
            node = level.get(chunk)
            if node is None:
                node = _Node(chunk, int(table[i // bs]))
                self.cache.ref_block(node.block)
                node._level = level      # the dict holding us (for evict)
                level[chunk] = node
                adopted += 1
                self._blocks += 1
            node.last_used = self._clock
            if len(chunk) < bs:
                break                    # partial tail chunk is a leaf
            level = node.children
        if adopted:
            PREFIX_CACHE_BLOCKS.set(self._blocks)
            self.cache.update_gauges()
        return adopted

    # -- eviction ------------------------------------------------------------
    def evictable_count(self) -> int:
        """Blocks leaves-first eviction could return to the free list
        right now: every node nobody reads but the tree whose whole
        subtree is such nodes (an interior node goes once its leaves
        have). Exact, not a lower bound: with no request running the
        whole tree is reclaimable, so the admission gate can always place
        a prompt that fits the pool (counting childless nodes alone, as
        the JAX package's tree does, can leave a long prompt waiting on
        an idle engine for ever)."""
        def count(level):
            n, whole = 0, True
            for node in level.values():
                below, clear = count(node.children)
                n += below
                if clear and self.cache.ref_count(node.block) == 1:
                    n += 1
                else:
                    whole = False
            return n, whole

        return count(self._root)[0]

    def _iter_evictable(self):
        stack = list(self._root.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif self.cache.ref_count(node.block) == 1:
                yield node

    def evict(self, n_blocks: int) -> int:
        """Reclaim up to ``n_blocks`` pool blocks from the tree,
        least-recently-matched leaves first (a freed leaf can expose its
        parent as the next candidate). Returns how many blocks actually
        went back to the free list."""
        freed = 0
        while freed < n_blocks:
            victim = None
            for node in self._iter_evictable():
                if victim is None or node.last_used < victim.last_used:
                    victim = node
            if victim is None:
                break
            del victim._level[victim.chunk]
            self.cache.unref_block(victim.block)
            self._blocks -= 1
            freed += 1
        if freed:
            PREFIX_EVICTIONS.add(freed)
            PREFIX_CACHE_BLOCKS.set(self._blocks)
            self.cache.update_gauges()
        return freed

    # -- introspection -------------------------------------------------------
    def blocks(self) -> List[int]:
        """Every pool block the tree holds a reference on."""
        out, stack = [], list(self._root.values())
        while stack:
            node = stack.pop()
            out.append(node.block)
            stack.extend(node.children.values())
        return out

    @property
    def block_count(self) -> int:
        return self._blocks

    @property
    def hit_rate(self) -> float:
        return self._matched / self._looked_up if self._looked_up else 0.0

    def __repr__(self):
        return (f"RadixPrefixCache(blocks={self._blocks}, "
                f"hit_rate={self.hit_rate:.2f})")
