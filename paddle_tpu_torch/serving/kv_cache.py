"""KV caches of the serving engine: fixed slots and the paged block pool.

Counterpart of ``paddle_tpu/serving/kv_cache.py``. The device buffers
are allocated once; the model's prefill/decode functions write them in
place (the JAX package donates them through each jitted call instead).
Slot and block bookkeeping — free lists, per-slot lengths and block
tables — is host-side: it changes at request granularity, not token
granularity.

The paged pool here is single-shard (``shards=1``): pool block 0 is the
garbage sink, never allocated. Blocks are refcounted, so the radix prefix
cache (``serving/prefix_cache.py``) can share one block among several
slots' tables and its own tree; the multi-shard pool of the serving mesh
is not ported.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..monitor.stats import KV_BLOCKS_FREE, KV_BLOCKS_USED, KV_FRAGMENTATION

__all__ = ["KVCache", "PagedKVCache", "cache_insert"]


def cache_insert(k_cache, v_cache, slot, k_new, v_new):
    """Write one sequence's prefill entries into a slot, in place.

    k_new/v_new: (L, nh, S, hd) with S <= max_len (gpt_prefill output for
    one sequence). Positions >= S keep whatever they held; decode
    overwrites position S, S+1, ... before ever attending to them."""
    S = k_new.shape[2]
    k_cache[int(slot), :, :, :S] = k_new.to(k_cache.dtype)
    v_cache[int(slot), :, :, :S] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


class KVCache:
    """Slotted decode cache: device buffers + host-side slot accounting.

        k, v : (n_slots, n_layers, n_heads, max_len, head_dim)  cfg.dtype
    """

    def __init__(self, cfg, n_slots: int, max_len: Optional[int] = None,
                 dtype=None, device=None):
        if max_len is None:
            max_len = cfg.seq_len
        if max_len > cfg.seq_len:
            raise ValueError(
                f"max_len={max_len} exceeds the model's positional table "
                f"(cfg.seq_len={cfg.seq_len})")
        self.cfg = cfg
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.dtype = cfg.dtype if dtype is None else dtype
        self.device = resolve_device(device)
        shape = (self.n_slots, cfg.n_layers, cfg.n_heads, self.max_len,
                 cfg.head_dim)
        self.k = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self._reset_accounting()

    def _reset_accounting(self) -> None:
        # host-side per-slot token counts (== next write position)
        self.lengths = np.zeros(self.n_slots, np.int32)
        self._free: List[int] = list(range(self.n_slots))

    def reset(self) -> None:
        """Zero the buffers in place and free every slot: the state of a
        fresh cache, without allocating a second one."""
        self.k.zero_()
        self.v.zero_()
        self._reset_accounting()

    def alloc(self) -> Optional[int]:
        """Claim a free slot (None when full). Contents are whatever the
        previous occupant left — prefill overwrites them."""
        if not self._free:
            return None
        slot = self._free.pop(0)
        self.lengths[slot] = 0
        return slot

    def release(self, slot: int) -> None:
        if slot in self._free:
            raise ValueError(f"slot {slot} is already free")
        self.lengths[slot] = 0
        self._free.append(slot)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> int:
        return self.n_slots - len(self._free)


class PagedKVCache:
    """Paged decode cache: a shared block pool plus per-slot block tables.

        kb, vb : (n_blocks, n_layers, n_heads, block_size, head_dim)

    A slot owns however many ``block_size``-token blocks its prompt and
    generation have filled, named in order by its block table, so cache
    memory is proportional to live tokens. Pool block 0 is the garbage
    sink: never allocated, it pads every table and fills the tables of
    unoccupied batch lanes, so the batched decode step's stale-lane
    writes land where no live slot reads. A double free raises
    ``AssertionError`` (a corrupt free list would cross-wire two
    requests' caches).

    Refcounted sharing (the radix prefix cache): every allocated block
    carries a reference count. ``grow``/``alloc_block`` hand out blocks
    at refcount 1; :meth:`ref_block` lets another owner (a second slot's
    table, or the prefix tree) pin the same block, and releasing a table
    *unrefs* instead of freeing — a block returns to the free list only
    when the LAST reference drops. Writers never mutate a shared block:
    a slot that must extend a partially-filled shared block first
    :meth:`replace_block`\\ s it with a copy-on-write duplicate (the
    engine copies the block's rows on the device)."""

    def __init__(self, cfg, n_slots: int, n_blocks: Optional[int] = None,
                 block_size: int = 16, dtype=None, device=None):
        if block_size < 1:
            raise ValueError(f"block_size={block_size} must be >= 1")
        self.cfg = cfg
        self.n_slots = int(n_slots)
        self.block_size = int(block_size)
        # widest table any slot can need: the positional table is the
        # per-slot length ceiling
        self.table_width = -(-cfg.seq_len // self.block_size)
        if n_blocks is None:
            # worst case every slot runs to seq_len, +1 sink
            n_blocks = 1 + self.n_slots * self.table_width
        self.n_blocks = int(n_blocks)
        if self.n_blocks < 2:
            raise ValueError(f"n_blocks={self.n_blocks} must be >= 2 (block "
                             "0 is the reserved garbage sink)")
        self.dtype = cfg.dtype if dtype is None else dtype
        self.device = resolve_device(device)
        shape = (self.n_blocks, cfg.n_layers, cfg.n_heads, self.block_size,
                 cfg.head_dim)
        self.kb = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.vb = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self._reset_accounting()

    def _reset_accounting(self) -> None:
        self.lengths = np.zeros(self.n_slots, np.int32)
        self.block_tables: List[List[int]] = [[] for _ in range(self.n_slots)]
        self._free: List[int] = list(range(1, self.n_blocks))
        self._free_set = set(self._free)
        self._refs: dict = {}      # allocated block -> reference count
        self._slot_free: List[int] = list(range(self.n_slots))
        self.update_gauges()

    def reset(self) -> None:
        """Zero the pool in place and free every block and slot: the
        state of a fresh pool, without allocating a second one."""
        self.kb.zero_()
        self.vb.zero_()
        self._reset_accounting()

    @property
    def max_slot_blocks(self) -> int:
        """Largest block count one slot can ever own (the pool minus the
        sink) — the submit-time can-never-fit bound."""
        return self.n_blocks - 1

    # -- slot accounting (same surface as KVCache) ---------------------------
    def alloc(self) -> Optional[int]:
        if not self._slot_free:
            return None
        slot = self._slot_free.pop(0)
        self.lengths[slot] = 0
        self.block_tables[slot] = []
        return slot

    def release(self, slot: int) -> None:
        if slot in self._slot_free:
            raise ValueError(f"slot {slot} is already free")
        self.free_blocks(self.block_tables[slot])
        self.block_tables[slot] = []
        self.lengths[slot] = 0
        self._slot_free.append(slot)

    @property
    def free_count(self) -> int:
        return len(self._slot_free)

    @property
    def occupancy(self) -> int:
        return self.n_slots - len(self._slot_free)

    # -- block accounting ----------------------------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.block_size)

    def can_admit(self, n_tokens: int) -> bool:
        """Enough free blocks to cache ``n_tokens``? (The admission gate
        that replaces the fixed engine's ``prompt >= max_len`` reject.)"""
        return self.blocks_for(n_tokens) <= len(self._free)

    @property
    def free_blocks_count(self) -> int:
        return len(self._free)

    @property
    def used_blocks_count(self) -> int:
        return self.n_blocks - 1 - len(self._free)

    def grow(self, slot: int, n_tokens: int) -> bool:
        """Extend ``slot``'s table to cover positions < n_tokens.
        All-or-nothing: returns False, allocating nothing, when the free
        list cannot supply every needed block."""
        table = self.block_tables[slot]
        extra = self.blocks_for(n_tokens) - len(table)
        if extra <= 0:
            return True
        if extra > len(self._free):
            return False
        for _ in range(extra):
            table.append(self._take_block())
        self.update_gauges()
        return True

    def _take_block(self) -> int:
        b = self._free.pop(0)
        self._free_set.discard(b)
        self._refs[b] = 1
        return b

    def alloc_block(self) -> Optional[int]:
        """One free block at refcount 1 (the copy-on-write destination),
        or None when the pool is dry."""
        if not self._free:
            return None
        b = self._take_block()
        self.update_gauges()
        return b

    def ref_block(self, block: int) -> None:
        """Pin one more reference on an allocated block (a second slot's
        table, or the prefix tree adopting it)."""
        b = int(block)
        if b not in self._refs:
            raise AssertionError(
                f"KV block {b} ref'd while not allocated (use-after-free)")
        self._refs[b] += 1

    def ref_count(self, block: int) -> int:
        return self._refs.get(int(block), 0)

    def unref_block(self, block: int) -> None:
        """Drop one reference; the LAST drop returns the block to the
        free list (shared prefix blocks survive their first owner)."""
        b = int(block)
        if b in self._free_set:
            raise AssertionError(
                f"KV block {b} double-freed (free-list corruption)")
        if not 0 < b < self.n_blocks:
            raise AssertionError(
                f"KV block {b} outside the pool or the reserved sink")
        refs = self._refs.get(b)
        if refs is None:
            raise AssertionError(
                f"KV block {b} unref'd while not allocated "
                "(refcount corruption)")
        if refs > 1:
            self._refs[b] = refs - 1
            return
        del self._refs[b]
        self._free.append(b)
        self._free_set.add(b)

    def free_blocks(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            self.unref_block(b)
        self.update_gauges()

    def splice(self, slot: int, blocks: Sequence[int]) -> None:
        """Seed an empty slot table with already-allocated (shared)
        blocks, taking one reference per block — the prefix-cache hit
        path."""
        table = self.block_tables[slot]
        if table:
            raise AssertionError(
                f"splice into slot {slot} with a non-empty table")
        for b in blocks:
            self.ref_block(b)
            table.append(int(b))
        self.update_gauges()

    def replace_block(self, slot: int, index: int, new_block: int) -> int:
        """Swap one table entry for ``new_block`` (the copy-on-write
        commit: the caller has already copied the old block's rows into
        ``new_block`` on the device). Drops this table's reference on
        the old block and returns it."""
        table = self.block_tables[slot]
        old = table[index]
        table[index] = int(new_block)
        self.unref_block(old)
        self.update_gauges()
        return old

    def table_row(self, slot: int) -> np.ndarray:
        """This slot's table as a fixed-width int32 row, sink-padded."""
        row = np.zeros(self.table_width, np.int32)
        table = self.block_tables[slot]
        row[:len(table)] = table
        return row

    def tables_array(self, slots=None) -> np.ndarray:
        """(n_slots, table_width) int32 for the batched decode step; rows
        not in ``slots`` (and all padding) point at the garbage sink."""
        out = np.zeros((self.n_slots, self.table_width), np.int32)
        for s in (range(self.n_slots) if slots is None else slots):
            table = self.block_tables[s]
            out[s, :len(table)] = table
        return out

    # -- gauges --------------------------------------------------------------
    def update_gauges(self) -> None:
        used = self.used_blocks_count
        KV_BLOCKS_FREE.set(self.free_blocks_count)
        KV_BLOCKS_USED.set(used)
        cap = used * self.block_size
        live = int(self.lengths.sum())
        KV_FRAGMENTATION.set(
            0 if cap == 0 else int(round(100.0 * (1.0 - min(1.0, live / cap)))))
