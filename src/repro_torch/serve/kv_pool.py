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

Recurrent layers (mLSTM, sLSTM, Mamba) keep per-slot rows beside the
pools (``lm.init_paged_state``; a hybrid stack holds both in one state
list); the helpers at the end of this module view, merge and freeze
those rows, in the port's per-layer form of the reference's state-tree
helpers.  A pure-recurrent stack pages no KV.

Prefix caching (shared, refcounted blocks and copy-on-write) is not
ported yet; the allocator keeps the JAX package's refcounts so it can
come without changing this interface.
"""
from __future__ import annotations

from collections import deque
from collections.abc import Sequence
from typing import Any

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer

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



# ---------------------------------------------------------------------------
# Per-layer state helpers: paged pools are shared (no slot axis);
# recurrent states keep their per-slot rows (axis 0)
# ---------------------------------------------------------------------------

def is_paged_cache(state: Any) -> bool:
    return isinstance(state, dict) and "k_pool" in state


def has_kv_cache(cfg: ModelConfig) -> bool:
    """Whether any layer carries a KV cache (a pure-recurrent stack,
    xLSTM, pages nothing but still streams its prompts in chunks)."""
    return any(transformer.mixer_kind(cfg, j) == "attn"
               for j in range(transformer.period(cfg)))


def has_recurrent_state(cfg: ModelConfig) -> bool:
    """Whether any layer carries per-slot recurrent state, which a
    reused slot must start afresh."""
    return any(transformer.mixer_kind(cfg, j) != "attn"
               for j in range(transformer.period(cfg)))


def _recurrent(state: Any) -> bool:
    return bool(state) and not is_paged_cache(state)


def slot_states_view(states: list[Any], slot: torch.Tensor) -> list[Any]:
    """A batch-1 copy of the recurrent rows of ``slot`` ([1] int64 on
    the device) for a prefill chunk; shared paged pools pass through
    whole."""
    return [{k: t.index_select(0, slot) for k, t in st.items()}
            if _recurrent(st) else st for st in states]


def slot_states_merge(states: list[Any], one: list[Any],
                      slot: torch.Tensor) -> None:
    """Inverse of :func:`slot_states_view`: write the advanced batch-1
    rows back at ``slot``, in place."""
    for st, st1 in zip(states, one):
        if _recurrent(st):
            for k, t in st.items():
                t.index_copy_(0, slot, st1[k].to(t.dtype))


def freeze_inactive_rows(states: list[Any], new_states: list[Any],
                         active: torch.Tensor) -> None:
    """Write the step's new recurrent states (``lm.forward(...,
    commit=False)``) into ``states`` in place for the rows of ``active``
    ([B] bool) only.  The slot-wise decode step runs every row, slots
    whose prompt is still streaming in chunk by chunk included; their
    KV writes go to the trash block, but a recurrent row moved between
    two chunks would corrupt the prompt state the chunks accumulate."""
    for st, new in zip(states, new_states):
        if _recurrent(st):
            transformer.commit_state(st, new, rows=active)
