"""Paged KV-cache pool: fixed-size token blocks over one shared store.

The serving analogue of the paper's pooled memory arrays: instead of a
``[max_len]`` window per decode slot, the cache is one pool of
``num_blocks`` blocks per layer and each request owns just the blocks
its tokens touch, mapped through a per-slot *block table*.

* Physical block 0 is the **trash block**: rows whose slot is empty,
  retired or mid-prefill carry an all-zero table, so their writes land
  there.  :class:`BlockAllocator` hands out ids ``1 .. num_blocks`` over
  a pool of ``num_blocks + 1`` physical blocks.
* A request of ``prompt_len`` and ``max_tokens`` owns
  ``blocks_needed(...)`` blocks for its whole lifetime (up-front
  allocation: it never runs out mid-decode).

Prefix caching (shared, refcounted blocks and copy-on-write) is not
ported yet; the allocator keeps the JAX package's refcounts so it can
come without changing this interface.
"""
from __future__ import annotations

from collections import deque
from collections.abc import Sequence

TRASH_BLOCK = 0


class BlockAllocatorError(ValueError):
    """Allocator misuse: the caller's bookkeeping lost track of
    ownership."""


class BlockNotLive(BlockAllocatorError):
    """``release``/``acquire`` of a block with no live reference."""


class BlockOutOfRange(BlockAllocatorError):
    """A block id the pool never owned (the trash block included)."""


def blocks_needed(prompt_len: int, max_tokens: int, block_size: int) -> int:
    """Blocks a request owns for its lifetime: KV is written for every
    prompt token and every fed-back generated token; the last sampled
    token is never fed back, so the deepest position is
    ``prompt_len + max_tokens - 2``."""
    positions = prompt_len + max_tokens - 1
    return -(-positions // block_size)


def table_width(max_len: int, block_size: int) -> int:
    """Block-table columns needed to address ``max_len`` positions."""
    return -(-max_len // block_size)


class BlockAllocator:
    """Host-side refcounted free list over block ids ``first_id ..
    first_id + num_blocks - 1``.  FIFO reuse keeps allocation order
    deterministic; ``alloc`` is all or nothing."""

    def __init__(self, num_blocks: int, first_id: int = TRASH_BLOCK + 1):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = num_blocks
        self.first_id = first_id
        self._free = deque(range(first_id, first_id + num_blocks))
        self._ref: dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        return len(self._ref)

    def refcount(self, block: int) -> int:
        self._check_range(block)
        return self._ref.get(block, 0)

    def _check_range(self, block: int) -> None:
        if not self.first_id <= block < self.first_id + self.num_blocks:
            raise BlockOutOfRange(
                f"block {block} is not a pool block id (valid range "
                f"{self.first_id}..{self.first_id + self.num_blocks - 1}; "
                f"id {TRASH_BLOCK} is the reserved trash block)")

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Claim ``n`` blocks at refcount 1, or None (never partial)."""
        if n < 0:
            raise ValueError(f"cannot alloc {n} blocks")
        if n > len(self._free):
            return None
        ids = [self._free.popleft() for _ in range(n)]
        for i in ids:
            self._ref[i] = 1
        return ids

    def acquire(self, ids: Sequence[int]) -> None:
        """One extra reference on each (already live) block."""
        for i in ids:
            self._check_range(i)
            if i not in self._ref:
                raise BlockNotLive(f"acquiring block {i} that is not live")
        for i in ids:
            self._ref[i] += 1

    def release(self, ids: Sequence[int]) -> None:
        """Drop one reference per block; the last returns it to the
        free list."""
        for i in ids:
            self._check_range(i)
            if i not in self._ref:
                raise BlockNotLive(
                    f"releasing block {i} that is not live (double-free "
                    f"or foreign id)")
            self._ref[i] -= 1
            if self._ref[i] == 0:
                del self._ref[i]
                self._free.append(i)

