"""Prefix cache: a radix tree over full KV blocks for cross-request
KV reuse (the PagedAttention/vLLM automatic-prefix-caching design).
A pure-Python copy of ``paddle_tpu/serve/prefix.py``.

Block-table indirection already lets any table row point at any
physical block; this index makes that sharable. Every FULL block a
stream writes is registered under the chain of block-sized token
chunks that produced it — node identity is the exact token tuple, not
a lossy hash, so a match can never alias two different prefixes to the
same KV. At admission the engine walks the tree with the new prompt's
chunks (:meth:`match`) and mounts the longest matched chain of
physical blocks directly into the request's block table: the stream
decodes from the SAME blocks every earlier stream with that prefix
wrote, and prefill runs only on the unshared suffix.

Lifecycle discipline (enforced with ``BlockPool``'s refcounts):

- a matched block is ``acquire``-d per sharing stream; finish and
  preemption ``release`` it;
- a registered block whose refcount drops to 0 is RETAINED in the
  pool's cached state and parked here on an LRU (:meth:`note_cached`)
  — its KV stays resident so a future request can still match it;
- when the pool runs dry the engine calls :meth:`evict`, which
  reclaims LRU-oldest cached blocks (never a referenced one — the
  pool hard-errors on that) and unregisters their subtrees: a chain
  with a missing parent is unmatchable, so orphaned descendants are
  dropped (and reclaimed too when they are themselves cached).
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

from .pool import BlockPool

__all__ = ["PrefixCache"]


class _Node:
    """One full block of KV: ``key`` is the exact token chunk that
    filled it, reached through ``parent`` — the path from the root
    spells the whole token prefix this block's KV depends on."""

    __slots__ = ("key", "block", "parent", "children")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}


class PrefixCache:
    """Trie of full-block token chunks -> resident physical block ids."""

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._root = _Node((), -1, None)
        self._by_block: Dict[int, _Node] = {}
        # refcount-0 registered blocks, oldest-touched first (eviction
        # order); referenced blocks are NOT here — they are unevictable
        self._lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()

    # -- introspection -----------------------------------------------------
    @property
    def registered_blocks(self) -> int:
        return len(self._by_block)

    @property
    def evictable_blocks(self) -> int:
        return len(self._lru)

    def is_registered(self, block: int) -> bool:
        return int(block) in self._by_block

    # -- matching ----------------------------------------------------------
    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest-prefix match: walk the tree with ``tokens`` in
        block-sized chunks and return the matched chain of physical
        block ids (possibly empty). Only FULL chunks participate — a
        partial tail block is never sharable. Touches every matched
        block's LRU recency."""
        bs = self.block_size
        node = self._root
        out: List[int] = []
        for i in range(len(tokens) // bs):
            child = node.children.get(
                tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]))
            if child is None:
                break
            out.append(child.block)
            if child.block in self._lru:
                self._lru.move_to_end(child.block)
            node = child
        return out

    def node_for(self, tokens: Sequence[int]) -> "_Node":
        """The trie node at the end of ``tokens``'s matched chain (the
        root when nothing matches) — the registration cursor a stream
        carries so each later full block registers in O(block_size)."""
        bs = self.block_size
        node = self._root
        for i in range(len(tokens) // bs):
            child = node.children.get(
                tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]))
            if child is None:
                break
            node = child
        return node

    # -- registration ------------------------------------------------------
    def register(self, parent: "_Node", chunk: Sequence[int],
                 block: int) -> "_Node":
        """Register ``block`` as holding the KV of ``chunk`` (exactly
        ``block_size`` tokens) extending ``parent``'s prefix. If the
        chunk is already registered (two streams raced the same
        prefix), the existing node wins — the caller's block simply
        stays private and unshared. Returns the node to carry forward
        as the stream's registration cursor."""
        key = tuple(int(t) for t in chunk)
        if len(key) != self.block_size:
            raise ValueError(
                f"register(): chunk has {len(key)} tokens, expected a "
                f"full block of {self.block_size} — partial blocks are "
                f"not sharable")
        existing = parent.children.get(key)
        if existing is not None:
            return existing
        node = _Node(key, int(block), parent)
        parent.children[key] = node
        self._by_block[int(block)] = node
        return node

    # -- refcount-edge notifications --------------------------------------
    def note_cached(self, blocks: Sequence[int]) -> None:
        """Registered blocks just dropped to refcount 0 (pool parked
        them in the cached state) — enqueue for LRU eviction."""
        for b in blocks:
            b = int(b)
            if b in self._by_block:
                self._lru[b] = None
                self._lru.move_to_end(b)

    def note_acquired(self, blocks: Sequence[int]) -> None:
        """Blocks just gained a live reference — no longer evictable."""
        for b in blocks:
            self._lru.pop(int(b), None)

    # -- eviction ----------------------------------------------------------
    def evict(self, pool: BlockPool, n: int) -> int:
        """Reclaim up to ``n`` cached blocks back to the pool's free
        list, LRU-oldest first; returns how many were actually
        reclaimed. Referenced blocks are untouchable by construction
        (they are never on the LRU)."""
        reclaimed = 0
        while reclaimed < n and self._lru:
            block, _ = self._lru.popitem(last=False)
            reclaimed += self._drop_subtree(self._by_block[block], pool)
        return reclaimed

    def reset(self, pool: BlockPool) -> int:
        """Drop every evictable entry (compile-warm pollution, test
        isolation). Returns the number of blocks reclaimed. Referenced
        registrations survive — their streams are still live."""
        n = 0
        while self._lru:
            block, _ = self._lru.popitem(last=False)
            n += self._drop_subtree(self._by_block[block], pool)
        return n

    def _drop_subtree(self, node: "_Node", pool: BlockPool) -> int:
        """Unregister ``node`` and every descendant (a chain with a
        missing parent can never be matched again); reclaim the cached
        ones. A cached node never has referenced descendants — a
        stream holding a child block holds the whole prefix chain —
        so everything under it is cached or already unregistered."""
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        reclaimed = 0
        stack = [node]
        while stack:
            cur = stack.pop()
            stack.extend(cur.children.values())
            cur.children = {}
            self._by_block.pop(cur.block, None)
            self._lru.pop(cur.block, None)
            if pool.is_cached(cur.block):
                pool.reclaim([cur.block])
                reclaimed += 1
        return reclaimed
