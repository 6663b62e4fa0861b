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

* Prefix caching (:class:`PrefixCache`) shares the blocks of full
  prompt prefixes between requests: content-addressed by chained hashes
  (:func:`prefix_chain_hashes`), each cached block pinned by one
  allocator reference of the cache's own and attached read-only, one
  more reference, by every request whose prompt starts with it.  The
  steps write through a second table (:func:`mask_shared_cols`) that
  sends the shared columns to the trash block, and a fully cached
  prompt copies its last block (:func:`copy_block`) before it re-runs
  its last token there (copy-on-write).
* Speculative decoding writes the K/V of k + 1 positions a row and
  keeps only the accepted ones: :func:`spec_save_cells` gathers the
  cells before the verify forward stores into them and
  :func:`spec_restore_cells` scatters the rejected ones back, so the
  pool's net change is a one-token-a-step replay's;
  :func:`spec_select_recurrent` adopts each recurrent row's state at its
  accepted depth.

Recurrent layers (mLSTM, sLSTM, Mamba) keep per-slot rows beside the
pools (``lm.init_paged_state``; a hybrid stack holds both in one state
list); the helpers at the end of this module view, merge and freeze
those rows, and snapshot and restore them for the prefix cache, in the
port's per-layer form of the reference's state-tree helpers.  A
pure-recurrent stack pages no KV: its cache entries hold snapshots
only.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict, deque
from collections.abc import Sequence
from typing import Any

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.paged_attention.ref import (paged_write_cells,
                                                     write_cells)
from repro_torch.models import transformer
from repro_torch.serve.errors import (BlockAllocatorError,  # noqa: F401
                                      BlockNotLive, BlockOutOfRange)

TRASH_BLOCK = 0


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
# Block-granular prefix caching
# ---------------------------------------------------------------------------

def prefix_chain_hashes(tokens: Sequence[int], block_size: int,
                        root: str = "") -> list[str]:
    """Chain content hashes of every FULL ``block_size``-token prefix
    chunk of ``tokens``: ``h_i = H(h_{i-1}, tokens[i*bs:(i+1)*bs])``
    rooted at ``H(root)``, so ``h_i`` identifies the whole prefix
    ``tokens[:(i+1) * bs]``.  ``root`` folds in the model's identity, so
    entries never match across engines with different numerics.  The
    digests are the reference's."""
    h = hashlib.sha256(root.encode()).hexdigest()
    out = []
    for i in range(len(tokens) // block_size):
        chunk = tokens[i * block_size:(i + 1) * block_size]
        h = hashlib.sha256(
            (h + ":" + ",".join(str(int(t)) for t in chunk)).encode()
        ).hexdigest()
        out.append(h)
    return out


@dataclasses.dataclass
class _PrefixEntry:
    """One cached full prompt-prefix block: ``block``, the pool block
    holding its K/V (None for a pure-recurrent stack), and ``snapshot``,
    the slot's recurrent rows after the prefix it identifies (None
    without recurrent state, or where no chunk of the registering
    prefill ended on this block's edge)."""
    block: int | None
    snapshot: Any = None


class PrefixCache:
    """Bounded content-addressed index of full prompt-prefix blocks, in
    LRU order (touched on every attach).  The cache owns one allocator
    reference per block-bearing entry, so a cached block stays live
    after its registering request retires; eviction (LRU first, only
    entries whose block no request holds) releases it.  Capacity counts
    entries, so snapshot-only entries are bounded too.

    A snapshot holds a slot's whole recurrent rows (tens of MB a slot
    at full width), so ``max_snapshots`` bounds them apart from the
    entries: past it :meth:`drop_snapshot` takes the LRU entry's
    snapshot and leaves the entry, its block and its place in the chain
    (None: as many as entries, the reference's bound)."""

    def __init__(self, alloc: BlockAllocator, block_size: int,
                 capacity: int, root: str = "",
                 max_snapshots: int | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if max_snapshots is not None and max_snapshots < 1:
            raise ValueError(
                f"max_snapshots must be >= 1, got {max_snapshots}")
        self.alloc = alloc
        self.block_size = block_size
        self.capacity = capacity
        self.root = root
        self.max_snapshots = max_snapshots
        self._entries: OrderedDict[str, _PrefixEntry] = OrderedDict()
        self.hits = 0               # admissions that skipped prefill work
        self.tokens_skipped = 0     # prompt tokens whose prefill was skipped
        self.blocks_shared = 0      # shared block attachments (lifetime)

    def hashes(self, tokens: Sequence[int]) -> list[str]:
        return prefix_chain_hashes(tokens, self.block_size, self.root)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, h: str) -> bool:
        return h in self._entries

    @property
    def cached_blocks(self) -> int:
        """Pool blocks pinned by the cache (one reference each)."""
        return sum(e.block is not None for e in self._entries.values())

    @property
    def snapshots(self) -> int:
        """Entries that carry a recurrent snapshot."""
        return sum(e.snapshot is not None for e in self._entries.values())

    @property
    def snapshot_bytes(self) -> int:
        """Device bytes the snapshots hold."""
        return sum(t.nbytes for e in self._entries.values()
                   if e.snapshot is not None
                   for layer in e.snapshot for t in layer.values())

    def drop_snapshot(self) -> bool:
        """Free the LRU snapshot: its entry stays (block, chain and all),
        so a match that needs a snapshot resumes at a shallower one.
        Returns whether there was one."""
        e = next((e for e in self._entries.values()
                  if e.snapshot is not None), None)
        if e is None:
            return False
        e.snapshot = None
        return True

    @property
    def evictable_blocks(self) -> int:
        """Cached blocks that only the cache references: what admission
        could reclaim on demand."""
        return self.evictable_margin()

    def evictable_margin(self, exclude: Sequence[str] = ()) -> int:
        """Evictable blocks outside ``exclude`` (the hashes admission is
        about to attach, which it must not count twice)."""
        ex = set(exclude)
        return sum(h not in ex and e.block is not None
                   and self.alloc.refcount(e.block) == 1
                   for h, e in self._entries.items())

    def match(self, hashes: Sequence[str], *, need_snapshot: bool = False,
              limit: int | None = None) -> int:
        """Longest cached prefix of ``hashes``, in blocks; moves no
        refcount and touches no LRU order.  ``limit`` caps it (a
        recurrent stack resumes at most ``(prompt_len - 1) //
        block_size`` blocks in: a tail token must run for the first
        token's logits); ``need_snapshot`` ends it at the deepest entry
        that carries a snapshot (the resume point restores one)."""
        n = 0
        for h in hashes:
            if h not in self._entries:
                break
            n += 1
        if limit is not None:
            n = min(n, limit)
        if need_snapshot:
            while n > 0 and self._entries[hashes[n - 1]].snapshot is None:
                n -= 1
        return n

    def attach(self, hashes: Sequence[str]) -> list[int]:
        """A reference on every block of the cached prefix ``hashes``;
        returns the block ids in prefix order and LRU-touches them."""
        blocks = []
        for h in hashes:
            e = self._entries[h]
            self._entries.move_to_end(h)
            if e.block is not None:
                blocks.append(e.block)
        self.alloc.acquire(blocks)
        return blocks

    def snapshot_at(self, h: str) -> Any:
        return self._entries[h].snapshot

    def register(self, hashes: Sequence[str],
                 blocks: Sequence[int | None],
                 snapshots: dict[int, Any] | None = None) -> int:
        """Index the prefix blocks of a completed prefill: ``blocks[i]``
        holds chunk ``i`` (None without KV), ``snapshots[i]`` the
        recurrent rows after ``(i+1) * block_size`` tokens.  A hash
        already cached keeps its entry (the registering request's equal
        private copy retires with it); each new block takes one cache
        reference.  Returns the entries inserted."""
        snapshots = snapshots or {}
        inserted = 0
        for i, h in enumerate(hashes):
            if h in self._entries:
                self._entries.move_to_end(h)
                continue
            if len(self._entries) >= self.capacity \
                    and self._evict_lru(1) == 0:
                break              # full of entries in use
            blk = blocks[i]
            if blk is not None:
                self.alloc.acquire([blk])
            snap = snapshots.get(i)
            if snap is not None and self.max_snapshots is not None \
                    and self.snapshots >= self.max_snapshots \
                    and not self.drop_snapshot():
                snap = None
            self._entries[h] = _PrefixEntry(blk, snap)
            inserted += 1
        return inserted

    def _evict_lru(self, n_entries: int) -> int:
        """Drop up to ``n_entries`` LRU entries whose block no request
        holds; returns the entries dropped."""
        victims = []
        for h, e in self._entries.items():
            if e.block is None or self.alloc.refcount(e.block) == 1:
                victims.append(h)
                if len(victims) == n_entries:
                    break
        for h in victims:
            e = self._entries.pop(h)
            if e.block is not None:
                self.alloc.release([e.block])
        return len(victims)

    def evict_blocks(self, n_blocks: int,
                     exclude: Sequence[str] = ()) -> int:
        """Return at least ``n_blocks`` cached blocks to the free list if
        it can (LRU first, blocks in use skipped, ``exclude`` kept);
        returns the blocks freed."""
        ex = set(exclude)
        freed = 0
        while freed < n_blocks:
            before = self.alloc.free_blocks
            victim = next((h for h, e in self._entries.items()
                           if h not in ex and e.block is not None
                           and self.alloc.refcount(e.block) == 1), None)
            if victim is None:
                break
            self.alloc.release([self._entries.pop(victim).block])
            freed += self.alloc.free_blocks - before
        return freed

    def flush(self) -> int:
        """Evict every entry no live request pins, snapshot-only entries
        too; returns the blocks released.  After a drain and a flush no
        block is live."""
        freed = self.evict_blocks(self.cached_blocks)
        for h, e in list(self._entries.items()):
            if e.block is None:
                del self._entries[h]
        return freed


def mask_shared_cols(block_table: torch.Tensor, shared_cols: torch.Tensor
                     ) -> torch.Tensor:
    """The write table: ``block_table`` [B,W] with each row's leading
    ``shared_cols`` [B] columns sent to the trash block.  Shared prefix
    blocks are read-only: the steps gather through the real table and
    store through this one, so no store lands in a block that another
    request or the cache also references, whatever the cache index."""
    cols = torch.arange(block_table.shape[1], dtype=shared_cols.dtype,
                        device=block_table.device)
    return torch.where(cols[None, :] < shared_cols[:, None], TRASH_BLOCK,
                       block_table)


def copy_block(states: list[Any], src: int, dst: int) -> None:
    """Copy pool block ``src`` into ``dst`` in every attention layer's
    K and V pools, in place (the copy-on-write of a fully cached prompt:
    every cell of a full prompt block is valid K/V)."""
    for st in states:
        if is_paged_cache(st):
            for name in ("k_pool", "v_pool"):
                st[name][dst].copy_(st[name][src])


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


def slot_recurrent_bytes(states: list[Any]) -> int:
    """Bytes of one slot's recurrent rows: what a snapshot holds."""
    return sum(t[0].nbytes for st in states if _recurrent(st)
               for t in st.values())


def snapshot_slot_recurrent(states: list[Any], slot: int) -> list[Any]:
    """A copy of slot ``slot``'s recurrent rows (``[1, ...]`` a leaf; an
    empty dict for a paged pool): O(d) a layer, never a view, since the
    steps advance the rows in place.  Restored into a fresh slot it
    gives bit for bit the state a prefill of the same prefix reaches:
    the recurrent prefill branches run token by token, so chunk
    boundaries move no numerics, and rows never couple."""
    return [{k: t[slot:slot + 1].clone() for k, t in st.items()}
            if _recurrent(st) else {} for st in states]


def restore_slot_recurrent(states: list[Any], snap: list[Any],
                           slot: int) -> None:
    """Inverse of :func:`snapshot_slot_recurrent`: write the cached rows
    into ``slot`` in place (the captured graphs hold the states'
    addresses), where a prefill from scratch would reset them."""
    for st, sn in zip(states, snap):
        if _recurrent(st) and sn:
            for k, t in st.items():
                row = torch.full((1,), slot, dtype=torch.int64,
                                 device=t.device)
                t.index_copy_(0, row, sn[k].to(t.dtype))


# ---------------------------------------------------------------------------
# Speculative decoding: cell-wise KV rollback, per-position recurrent rows
# ---------------------------------------------------------------------------

def spec_save_cells(states: list[Any], write_table: torch.Tensor,
                    cache_index: torch.Tensor, s: int) -> list[Any]:
    """Gather the pool cells a speculative verify step is about to
    overwrite: each row's next ``s`` positions through ``write_table``
    (past the table width, the trash block).  One entry a layer: None
    for a recurrent layer, a ``{"k_pool", "v_pool"}`` dict of [B, S, KV,
    hd] copies for a paged one.  The pools are written in place (by the
    kernel or :func:`write_cells`), so the gather must run before the
    verify forward; with :func:`spec_restore_cells` the draft writes are
    transactional."""
    cells = None
    saved = []
    for st in states:
        if not is_paged_cache(st):
            saved.append(None)
            continue
        if cells is None:
            cells = paged_write_cells(write_table, cache_index, s,
                                      st["k_pool"].shape[1])
        phys, off = cells
        saved.append({name: st[name][phys, off]
                      for name in ("k_pool", "v_pool")})
    return saved


def spec_restore_cells(states: list[Any], saved: list[Any],
                       write_table: torch.Tensor, cache_index: torch.Tensor,
                       s: int, advance: torch.Tensor) -> None:
    """Roll back the rejected suffix of a verify step's pool writes, in
    place: of each row's ``s`` probed cells the first ``advance[b]`` are
    committed (kept), the rest get their :func:`spec_save_cells` values
    back.  A committed cell's (redundant) restore goes to the trash
    block, as an inactive row's writes do; where several land in one
    trash cell the last (row, position) wins (:func:`write_cells`), as
    the reference's scatter leaves it on the CPU."""
    rel = torch.arange(s, dtype=advance.dtype, device=advance.device)
    committed = rel[None, :] < advance[:, None]
    cells = None
    for st, sv in zip(states, saved):
        if sv is None:
            continue
        if cells is None:
            phys, off = paged_write_cells(write_table, cache_index, s,
                                          st["k_pool"].shape[1])
            cells = torch.where(committed, TRASH_BLOCK, phys), off
        for name in ("k_pool", "v_pool"):
            write_cells(st[name], *cells, sv[name])


def spec_select_recurrent(states: list[Any], new_states: list[Any],
                          advance: torch.Tensor,
                          active: torch.Tensor) -> None:
    """Collapse a verify step's per-position recurrent states to each
    row's accepted depth, in place.  ``new_states``' recurrent leaves
    come from a ``collect_states`` forward, [B, S, ...], index j the
    state after position j; a row that advances by ``advance[b]`` tokens
    has consumed positions 0 .. advance - 1 and adopts index ``advance -
    1``.  Rows not in ``active`` keep their values, as
    :func:`freeze_inactive_rows` keeps them.  Paged pools are
    :func:`spec_restore_cells`' to roll back."""
    idx = torch.clamp(advance.to(torch.int64) - 1, min=0)
    rows = torch.arange(idx.shape[0], device=idx.device)
    for st, new in zip(states, new_states):
        if _recurrent(st):
            transformer.commit_state(
                st, {name: n[rows, idx] for name, n in new.items()},
                rows=active)
