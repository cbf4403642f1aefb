"""Refcounted block pool allocator for the paged KV cache.

A pure-Python copy of ``paddle_tpu/serve/pool.py``.

The physical pool itself is a pair of device arrays per layer
(``[KVH, num_blocks, block_size, DH]``, the paged-attention kernel
layout); THIS object owns only the block-id bookkeeping. Since the
prefix cache landed, a physical block can be in one of three states:

- **free** — on the LIFO free-list, contents meaningless;
- **referenced** — held by one or more live streams (``refcount >= 1``;
  prefix sharing is what pushes it above 1: two streams whose prompts
  share a full-block prefix decode from the SAME physical block);
- **cached** — ``refcount == 0`` but retained because the prefix cache
  still indexes its KV contents. Cached blocks are *evictable*: they
  are reclaimed back to the free list (``reclaim``) on demand, never
  while referenced.

``alloc``/``free`` are the plain surface and remain valid:
``alloc`` hands out fresh blocks at refcount 1 and ``free`` is
``release`` without retention. Double-free detection generalizes to
refcount underflow — releasing a block more times than it is held is a
hard ``ValueError`` either way.

Exhaustion is LOUD by contract: :meth:`alloc` raises
:class:`PoolExhaustedError` instead of handing out an out-of-range id —
the silent failure mode this prevents is an out-of-bounds gather that
reads another sequence's KV block (the serving engine catches the
error, evicts cached blocks, and only then queues/preempts).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Set

__all__ = ["BlockPool", "PoolExhaustedError"]


class PoolExhaustedError(RuntimeError):
    """No free KV-cache blocks remain in the pool.

    Raised by :meth:`BlockPool.alloc`; the serving engine reacts by
    evicting prefix-cached (refcount-0) blocks, then queueing the
    admission or preempting the youngest stream.
    """


class BlockPool:
    """Refcounted free-list allocator over ``num_blocks`` KV blocks."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be > 0, got {num_blocks}")
        if block_size <= 0:
            raise ValueError(f"block_size must be > 0, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # LIFO: recently-freed blocks are re-issued first (their pages
        # are the likeliest to still be cache warm on re-prefill)
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}       # block id -> refcount (>= 1)
        self._cached: Set[int] = set()       # refcount-0, prefix-retained

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks retained by the prefix cache (evictable)."""
        return len(self._cached)

    @property
    def used_blocks(self) -> int:
        """Blocks referenced by live streams (cached-but-unreferenced
        blocks are reclaimable on demand, so they do not count)."""
        return self.num_blocks - len(self._free) - len(self._cached)

    @property
    def occupancy(self) -> float:
        """Fraction of the pool held by live streams (0.0 .. 1.0)."""
        return self.used_blocks / self.num_blocks

    def refcount(self, block: int) -> int:
        """Live references to ``block`` (0 for free AND cached blocks —
        ``is_cached`` distinguishes them)."""
        return self._ref.get(int(block), 0)

    def is_cached(self, block: int) -> bool:
        return int(block) in self._cached

    def blocks_for_tokens(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache positions."""
        return -(-int(n_tokens) // self.block_size)

    def alloc(self, n: int = 1) -> List[int]:
        """Hand out ``n`` fresh block ids at refcount 1, or raise —
        atomically: either all ``n`` are granted or none are taken.
        Cached blocks are NOT tapped here; the caller decides what to
        evict (``reclaim``) before retrying."""
        if n <= 0:
            return []
        if n > len(self._free):
            raise PoolExhaustedError(
                f"KV block pool exhausted: requested {n} block(s) but "
                f"only {len(self._free)} of {self.num_blocks} are free "
                f"({self.used_blocks} in use, {len(self._cached)} "
                f"prefix-cached, block_size={self.block_size}). Evict "
                f"cached blocks, finish or preempt a stream, or size "
                f"the pool for the working set.")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def acquire(self, blocks: Iterable[int]) -> None:
        """Take an additional reference on each block (prefix sharing:
        a new stream starts decoding from resident KV). Acquiring a
        cached block revives it to refcount 1; acquiring a FREE block
        is a hard error — its contents are meaningless."""
        for b in blocks:
            b = int(b)
            if not 0 <= b < self.num_blocks:
                raise ValueError(
                    f"acquire(): block id {b} is outside the pool "
                    f"[0, {self.num_blocks})")
            if b in self._cached:
                self._cached.discard(b)
                self._ref[b] = 1
            elif b in self._ref:
                self._ref[b] += 1
            else:
                raise ValueError(
                    f"acquire(): block id {b} is free — acquiring an "
                    f"unallocated block would share garbage KV")

    def release(self, blocks: Iterable[int],
                retain: Iterable[int] = ()) -> List[int]:
        """Drop one reference per listed block (a duplicate id in one
        call drops two). Refcount underflow — releasing a block that is
        already free or cached, or more times than it is held — is a
        hard error, the generalization of a double-free check,
        and is detected BEFORE any state changes. Blocks that hit
        refcount 0 return to the free list unless listed in ``retain``
        (the prefix cache's registered blocks), which park in the
        cached state instead; the newly-cached ids are returned so the
        prefix cache can enqueue them for LRU eviction."""
        blocks = [int(b) for b in blocks]
        need: Dict[int, int] = {}
        for b in blocks:
            if not 0 <= b < self.num_blocks:
                raise ValueError(
                    f"release(): block id {b} is outside the pool "
                    f"[0, {self.num_blocks})")
            need[b] = need.get(b, 0) + 1
        for b, k in need.items():
            if k > self._ref.get(b, 0):
                raise ValueError(
                    f"release(): block id {b} is already free (refcount "
                    f"{self._ref.get(b, 0)}, releasing {k}) — refcount "
                    f"underflow / double free corrupts the allocator")
        retain_set = {int(b) for b in retain}
        newly_cached: List[int] = []
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                if b in retain_set:
                    self._cached.add(b)
                    newly_cached.append(b)
                else:
                    self._free.append(b)
        return newly_cached

    def free(self, blocks: List[int]) -> None:
        """``release`` with no retention."""
        self.release(blocks)

    def reclaim(self, blocks: Iterable[int]) -> None:
        """Evict cached (refcount-0) blocks back to the free list.
        Reclaiming a referenced block is a hard error — eviction must
        never pull KV out from under a live stream."""
        for b in blocks:
            b = int(b)
            if b in self._ref:
                raise ValueError(
                    f"reclaim(): block id {b} has refcount "
                    f"{self._ref[b]} — eviction only reclaims "
                    f"refcount-0 blocks")
            if b not in self._cached:
                raise ValueError(
                    f"reclaim(): block id {b} is not cached (already "
                    f"free or outside the pool)")
            self._cached.discard(b)
            self._free.append(b)
