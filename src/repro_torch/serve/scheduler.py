"""Continuous-batching serve scheduler: paged KV pool or contiguous
windows.

A fixed pool of ``num_slots`` decode slots shares one prepacked
parameter set and the decode state of every layer (KV storage for
attention, per-slot rows for the recurrent mLSTM, sLSTM and Mamba
mixers; a hybrid stack such as Jamba's holds both), in one of the
reference's two layouts:

* **paged** (``kv_block_size > 0``): one pool of KV blocks per layer
  (``serve.kv_pool``).  Admission claims a free slot and the request's
  blocks up front (FIFO; a request the pool cannot fund yet waits),
  retirement releases them.  Each iteration
  (:meth:`ContinuousBatchingScheduler.tick`) feeds every mid-prefill slot
  one chunk of its prompt (``kv_block_size`` tokens with
  ``chunked_prefill``, else the whole prompt) through a batch-1 step
  that writes K/V straight into the pool through the slot's block-table
  row; the slot whose last chunk lands draws its first token (inside
  the chunk step, from ``prng_key(seed)``) and joins decode.  A
  recurrent layer's chunk runs on a batch-1 copy of the slot's rows,
  which the step writes back; admission resets the slot's rows to a
  fresh state first (Mamba's: a zero state and conv window).  A
  pure-recurrent stack (xLSTM) pages no KV: its requests take 0 blocks;
  a hybrid one pages the KV of its attention layers only.  With
  ``prefix_cache`` an admission first looks its prompt up in the prefix
  cache (``kv_pool.PrefixCache``): the blocks of the longest cached
  full-block prefix are attached read-only (the steps write those
  columns to the trash block), a recurrent stack's rows are restored
  from the snapshot taken at that prefix's edge instead of reset, and
  only the tail is fed; a fully cached dense prompt copies its last
  block into a private one and re-runs its last token there
  (copy-on-write).  A completed prefill registers its full blocks, and
  chunks that end on a block edge snapshot the recurrent rows.
* **contiguous** (``kv_block_size = 0``, the reference's default): a
  ``[num_slots, max_len]`` window per layer.  Admission prefills the
  whole prompt at once, batch 1, into a window of the scheduler's own,
  draws token 0 and splices that window into the slot's row: the
  prompt's K/V, then zeros up to ``max_len``, and the recurrent rows the
  prompt left (the window starts each prompt from a fresh state).  A
  request that finishes at its first token (EOS, or ``max_tokens ==
  1``) completes at admission and leaves the slot free.

Then ONE slot-wise decode step runs over all slots: a per-slot
``cache_index`` vector and an active mask (paged: and a block table
masked so that rows not decoding write to the trash block, and the
recurrent rows of slots not decoding kept as they were; contiguous:
every row writes at its own index and advances its recurrent rows, the
free rows into windows the next admission overwrites).  Every row folds
its key with ``gen - 1`` and draws at its own temperature; rows at
temperature 0 take the argmax.
Greedy and sampled rows share the one step: there is no second decode
program.

The steps are compiled (``serve.compiled``): on the card the decode
step is the replay of one CUDA graph, and each chunk (paged) or each
admission's prefill (contiguous) the replay of one graph per distinct
chunk or prompt length, the slot an input of the step; each is built
once for the scheduler's lifetime, as the reference jits
``make_slot_step`` once and its prefill once per length.  The decode
step and the paged chunk advance recurrent rows in place, which they
name to ``CompiledStep`` so that its warm-up does not advance them a
second time.
:meth:`ContinuousBatchingScheduler.step_programs` counts the builds.

Oracle equivalence: each request's tokens equal those of the request
run alone through ``ServeEngine.generate_loop``: activation scales are
per input row, and every row attends over the engine's whole window
(the paged view is cropped to it), so a row's numerics never depend on
its co-tenants.  The contiguous steps attend through the solo loop's
own composition, so there it holds bit for bit on every backend, the
card's ``cuda`` backend too.  The recurrences sum a head's lanes (or
Mamba's state lanes) in a fixed tree whatever the batch
(``layers.lane_sum``), and a stack with no attention runs no
paged-attention kernel, so an xLSTM request's tokens equal its solo
tokens in both layouts on every backend.  The recurrent prefill
branches run token by token, so a chunk boundary moves no numerics:
the paged chunks give the solo loop's whole-prompt prefill.  The
paged steps hold it wherever both run the same arithmetic: on the CPU,
and on the card's ``torch`` backend.  On the ``cuda`` backend they
attend through the paged-attention kernel, which sums in another order
than the solo loop's plain attention, so the two can part at
near-ties; a request served alone through the scheduler still gives
its tokens in any batch.

MoE configs schedule fine but are excluded from the guarantee: expert
capacity is shared across the batch, so dropping is inherently coupled.
This holds for Jamba's hybrid stack too, whose every other FFN is
routed.
Every slot flows through the decode step, live or not, so an idle row's
hidden state takes expert capacity too, and at a capacity of one slot
an expert (OLMoE-1B-7B's at 4 slots) it decides which live assignments
are dropped.  A row not decoding reads and writes the trash block 0 of
the paged pool; where several write one trash cell in a step, the last
row wins on every backend (``kernels/paged_attention``), as the
reference's scatter on the CPU, so the trash block, and through the
capacity the live rows' tokens, are the same from run to run.  They
depend on what the previous run left in the idle rows, which
:meth:`ContinuousBatchingScheduler.run` does not reset (nor does the
reference's).  At a capacity factor of ``E / k`` or more no assignment
is dropped, and a row depends on its co-tenants only through the
rounding of the float expert products, whose row count is the
capacity (a float GEMM's rows may differ by an ulp between row counts).

Prefix caching keeps the guarantee: sharing on == sharing off == the
solo oracle, bit for bit, wherever the steps run the same arithmetic.
A cached block holds the K/V the same chunk of the same prompt would
write, a snapshot the rows the same chunks would leave, and the tail's
chunks start on the same block edges as without the cache; a
copy-on-write tail runs one token where the chunk would run it among
others, and every row's numerics are its own.  MoE is outside it: only
the tail's tokens take expert capacity.

Speculative decoding (``speculate_k > 0``, paged only) replaces the
decode step with the draft-and-verify step (:func:`make_spec_step`): a
drafter (``serve.spec``) proposes k tokens for every decoding slot on
the host, one verify forward scores the k + 1 positions of every slot,
and each slot emits the longest draft prefix that matches what it
samples plus one bonus token, 1 to k + 1 tokens a step.  Each emitted
token is drawn from the logits of its own position with the key the
one-token step would hold there, and a position is accepted only while
the drafts before it matched, so the tokens are the one-token path's
whatever the drafter proposes; the pool cells of the rejected
positions are restored (``kv_pool.spec_restore_cells``) and the
recurrent rows take the state at the accepted depth
(``kv_pool.spec_select_recurrent``), so the pool and the rows are a
one-token run's too.  The guarantee carries over wherever the verify
step runs a row's arithmetic as the decode step does: the integer
projections (``pum``, ``int8``) are exact, and the norms and float
products (the f32 lm head, ``bf16`` mode's projections) run position by
position (``pum_linear.positionwise``); MoE stays outside it (the k + 1
positions of every row share the expert capacity).

This slice serves the dense family, the xLSTM family (mLSTM and sLSTM
mixers), the MoE family and the hybrid family (Mamba and attention
mixers, dense and routed FFNs) at any temperature, each request with
its own seed, and its draws are the reference's (``serve.prng``
reproduces its threefry keys), with or without the prefix cache and
speculative decoding.  Tensor parallelism is not ported yet: ``mesh``
raises ``NotImplementedError``.

Fault tolerance: ``tick(step, fault_hook)`` calls ``fault_hook("chunk",
rid)`` before each prefill chunk's dispatch (before a pending
copy-on-write too) and ``fault_hook("decode", None)`` once before the
decode or spec step; the hook may raise (``serve.chaos`` raises
``FaultInjected``).  Nothing of the dispatch it guards has moved then:
no step input is staged, and ``_cur_tok``, ``_keys``, the events, the
block table and the prefix registration are as they were, so the caller
can cancel the victim (``cancel`` frees its slot and blocks, the
reserved copy-on-write block included) and tick again.  The chunks of
earlier slots in that tick have landed; their events, and the
completions of requests that finished at their first token, come out
with the next tick.  ``serve.frontend.ServeFrontend`` drives the
scheduler this way, with ``start_request``, ``cancel`` and ``drain``.
The errors are the reference's hierarchy (``serve.errors``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import lm
from repro_torch.serve import kv_pool, prng, spec
from repro_torch.serve.compiled import CompiledStep
from repro_torch.serve.engine import (ServeEngine, make_decode_step,
                                      make_verify_step, sample_token)
from repro_torch.serve.errors import (InvalidRequest, PoolExhausted,
                                      RequestTooLarge, SchedulerStalled)


@dataclasses.dataclass
class Request:
    """One generation request.  ``arrival`` is in scheduler steps;
    ``eos_id < 0`` disables EOS; ``max_tokens`` counts every generated
    token, the EOS included; ``seed`` keys the draws at temperature > 0
    (``prng_key(seed)``, as the reference's ``PRNGKey(seed)``).

    The last three fields are the front end's, and the scheduler ignores
    them: ``arrival_time`` is the arrival in seconds (a Poisson trace for
    ``ServeFrontend.serve_trace``), ``priority`` orders the admission
    queue under the ``priority`` policy (higher first), and
    ``deadline_ms`` is the request's latency budget (queued past it:
    expired; decoding past it: cancelled with a partial completion)."""
    prompt: Sequence[int]
    max_tokens: int
    temperature: float = 0.0
    eos_id: int = -1
    seed: int = 0
    arrival: int = 0
    rid: int | None = None
    arrival_time: float | None = None
    priority: int = 0
    deadline_ms: float | None = None


@dataclasses.dataclass
class Completion:
    rid: int
    prompt: list[int]
    tokens: list[int]                  # generated tokens, EOS included
    finish_reason: str                 # "eos" | "length" | "cancelled"
    #                                    | "truncated"
    admitted_step: int
    finished_step: int
    truncated: bool = False            # retired before its natural end
    #                                    (cancel, drain)


@dataclasses.dataclass
class TickResult:
    """What one iteration produced: streaming events ``(rid, index,
    token)``, retired completions, dispatches run, whether decode ran."""
    events: list[tuple[int, int, int]]
    completions: dict[int, Completion]
    dispatches: int
    decoded: bool


@dataclasses.dataclass
class _PrefillJob:
    """A slot mid-prefill.  With the prefix cache, ``pos`` starts past
    the cached prefix; ``hashes`` are the prompt's full-block chain
    hashes (reused at registration), ``snaps`` the recurrent rows
    snapshotted at block edges, and ``cow_col``/``cow_dst`` a pending
    copy-on-write of a fully cached prompt's last block (-1: none)."""
    req: Request
    prompt: list[int]
    pos: int = 0                       # prompt tokens already fed
    hashes: list[str] = dataclasses.field(default_factory=list)
    snaps: dict[int, list] = dataclasses.field(default_factory=dict)
    cow_col: int = -1
    cow_dst: int = -1


def snapshot_budget(device: torch.device) -> int | None:
    """The bytes the prefix cache's recurrent snapshots may hold: half
    the device memory free when the scheduler is built (its weights,
    pools and slot rows in place), so that the snapshots a long prompt
    takes at its block edges cannot run the card out of memory.  None
    on the CPU, where only the cache's entry count bounds them, as in
    the reference."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[0] // 2


def _mask_block_table(block_table: torch.Tensor, active: torch.Tensor
                      ) -> torch.Tensor:
    """Route every non-decoding row's KV writes to the trash block."""
    return block_table * active.to(block_table.dtype)[:, None]


def make_slot_step(cfg: ModelConfig, kv_len: int | None = None):
    """The one-dispatch-per-token core.

    (params, states, cur_tok [B,1], cache_index [B], keys [B,2],
     active [B] bool, temp [B] f32, eos [B], gen [B], max_toks [B]
     [, block_table [B,W], shared_cols [B]])
      -> (states, tok [B], cache_index', step_keys [B,2], active', gen',
          done [B], logits [B,1,V])

    Every slot runs; ``active`` masks rows out of the counters.  With
    ``kv_len`` (the engine window) the states are the paged pool and the
    step takes a block table, which it masks so that rows not decoding
    write to the trash block; without, they are the contiguous windows,
    where every row writes at its own index.  ``shared_cols`` counts each
    row's leading prefix-cache columns: the step reads through the
    table and writes through a copy with those columns sent to the
    trash block (``kv_pool.mask_shared_cols``; all zero without the
    cache, so the step is the same program either way).  Paged, the
    recurrent rows of rows not decoding keep their values (the
    reference's ``freeze_inactive_rows``).  Each row's key is folded
    with its local step number (``gen - 1``, which wraps to 0xFFFFFFFF
    for an empty slot), as ``generate_loop`` folds with ``i``, and the
    folded keys come back for the host to keep.  The logits ride along
    for the compiled step, which keeps them on the device."""
    decode = make_decode_step(cfg, kv_len=kv_len)
    paged = kv_len is not None

    def slot_step(params, states, cur_tok, cache_index, keys, active, temp,
                  eos, gen, max_toks, block_table=None, shared_cols=None):
        step_keys = prng.fold_in(keys, gen - 1)
        write_table = None
        if paged:
            block_table = _mask_block_table(block_table, active)
            write_table = kv_pool.mask_shared_cols(block_table, shared_cols)
        logits, new_states = decode(params, states, cur_tok, cache_index,
                                    block_table=block_table,
                                    write_table=write_table,
                                    commit=not paged)
        if paged:
            # a mid-prefill row's recurrent state must not move between
            # its chunks (its KV writes already go to the trash block)
            kv_pool.freeze_inactive_rows(states, new_states, active)
        tok = sample_token(logits, step_keys, temp)[:, 0]
        gen = gen + active.to(gen.dtype)
        done = active & ((tok == eos) | (gen >= max_toks))
        cache_index = cache_index + active.to(cache_index.dtype)
        active = active & ~done
        return states, tok, cache_index, step_keys, active, gen, done, \
            logits

    return slot_step


def make_spec_step(cfg: ModelConfig, k: int, kv_len: int):
    """The draft-and-verify step (paged only).

    (params, states, cur_tok [B,1], draft [B,k], cache_index [B],
     keys [B,2], active [B] bool, temp [B] f32, eos [B], gen [B],
     max_toks [B], block_table [B,W], shared_cols [B])
      -> (states, emitted [B,k+1], advance [B], cache_index', keys',
          active', gen', done [B])

    One verify forward scores the k + 1 positions of every row (its
    current token and its k drafts); each row then emits the longest
    draft prefix that matches what it samples, plus one bonus token, so
    an active row advances by ``advance`` in [1, k + 1] tokens a step,
    and its tokens are the one-token step's whatever the drafts:

    * token j is sampled from the logits at position j with the j-th
      key of the one-token chain (``fold_in`` with ``gen - 1 + j``,
      ``generate_loop``'s schedule), so greedy and sampled rows emit
      the oracle's token at every accepted position;
    * a position is accepted only while the drafts before it matched the
      emitted tokens, so it attended to the right K/V only;
    * the K/V of the rejected positions are rolled back cell by cell
      (``kv_pool.spec_save_cells`` before the forward,
      ``spec_restore_cells`` after), so the pool's net change is a
      one-token run's;
    * the recurrent rows take the state at position ``advance - 1`` of
      the forward's per-position states (``collect_states``), which is
      bit for bit the one-token steps' state; rows not decoding keep
      theirs.

    The advance stops at the first EOS (inclusive) and at the request's
    ``max_tokens``, as the one-token step stops a row.  Positions past
    the table width write to the trash block, on the kernel as on its
    plain version, so the verify forward runs the paged-attention
    kernel on the card; the reference pins its verify step to the XLA
    composition for want of that routing in its Pallas kernel.  The
    recurrent rows are advanced in place: a compiled spec step names
    them (``CompiledStep(advances=)``); the rollback makes its pool
    writes idempotent."""
    verify = make_verify_step(cfg, kv_len=kv_len)
    s = k + 1

    def spec_step(params, states, cur_tok, draft, cache_index, keys,
                  active, temp, eos, gen, max_toks, block_table,
                  shared_cols):
        # the solo chain's keys for the next k + 1 tokens: token gen + j
        # is drawn after fold_in(..., gen - 1 + j) of the request's key
        # folded through every earlier step
        chain, kk = [], keys
        for j in range(s):
            kk = prng.fold_in(kk, gen - 1 + j)
            chain.append(kk)
        chain = torch.stack(chain, dim=1)                   # [B, k+1, 2]
        block_table = _mask_block_table(block_table, active)
        write_table = kv_pool.mask_shared_cols(block_table, shared_cols)
        tokens = torch.cat([cur_tok, draft], dim=1)         # [B, k+1]
        saved = kv_pool.spec_save_cells(states, write_table, cache_index,
                                        s)
        logits, new_states = verify(params, states, tokens, cache_index,
                                    block_table=block_table,
                                    write_table=write_table)
        emitted = torch.stack(
            [sample_token(logits[:, j:j + 1], chain[:, j], temp)[:, 0]
             for j in range(s)], dim=1)                     # [B, k+1]
        # the longest matching draft prefix, then the caps
        match = (emitted[:, :k] == draft).to(torch.int32)
        m_raw = torch.cumprod(match, dim=1).sum(dim=1, dtype=torch.int32) \
            + 1
        valid = torch.arange(s, device=gen.device)[None, :] < m_raw[:, None]
        is_eos = (emitted == eos[:, None]) & valid
        any_eos = is_eos.any(dim=1)
        first_eos = torch.argmax(is_eos.to(torch.int32), dim=1).to(
            torch.int32)
        eos_cap = torch.where(any_eos, first_eos + 1, s)
        len_cap = torch.clamp(max_toks - gen, min=1)        # >= 1 token
        adv = torch.where(active, torch.minimum(torch.minimum(
            m_raw, eos_cap), len_cap), 0).to(cache_index.dtype)
        kv_pool.spec_restore_cells(states, saved, write_table, cache_index,
                                   s, adv)
        kv_pool.spec_select_recurrent(states, new_states, adv, active)
        gen = gen + adv
        done = active & ((any_eos & (adv == first_eos + 1))
                         | (gen >= max_toks))
        # the key the solo loop holds after the last emitted token (a row
        # not decoding churns to the chain's first, as the decode step's)
        rows = torch.arange(keys.shape[0], device=keys.device)
        keys = chain[rows, torch.clamp(adv - 1, min=0).to(torch.int64)]
        cache_index = cache_index + adv
        active = active & ~done
        return states, emitted, adv, cache_index, keys, active, gen, done

    return spec_step


class ContinuousBatchingScheduler:
    """Continuous batching over a fixed pool of decode slots, serving
    requests at any temperature: each slot carries its request's key and
    temperature, and greedy and sampled rows run in the one decode step.

    ``kv_block_size`` tokens per KV block (0: contiguous windows of
    ``max_len``); ``num_kv_blocks`` sizes the pool (default:
    ``num_slots * ceil(max_len / kv_block_size)``); ``chunked_prefill``
    streams prompts in block-size chunks between decode steps (paged
    only).  ``kernel_backend`` (``"cuda"``/``"torch"``/None) is
    ambient for every step; None selects by device.  It is read when a
    step is built, as the reference reads it when a step is traced.

    ``cuda_graphs`` (on the card only) runs each step as the replay of
    its CUDA graph; False dispatches every op of every step from Python,
    the counterpart of running the reference under ``jax.disable_jit()``.
    On the CPU the steps always run eagerly.

    ``prefix_cache`` (paged only) shares the pool blocks of full prompt
    prefixes between requests (``kv_pool.PrefixCache``, at most
    ``num_kv_blocks`` entries): an admission attaches the longest cached
    prefix read-only (a recurrent stack restores the slot's rows from
    the snapshot taken at its edge) and prefills only the tail; a fully
    cached dense prompt copies its last block into a private one and
    re-runs its last token there.  The snapshots, those of prefills in
    flight included, hold at most :func:`snapshot_budget` bytes.

    ``speculate_k > 0`` (paged only, up to 16) runs every decode
    dispatch as the draft-and-verify step (:func:`make_spec_step`):
    ``drafter`` (``"ngram"``, prompt-lookahead self-speculation, or any
    object with ``propose(context, k)``, such as
    :class:`~repro_torch.serve.spec.ModelDrafter`) proposes k tokens for
    every decoding slot, and each slot advances by 1 to k + 1 tokens a
    step, its tokens the one-token path's whatever the drafter;
    :meth:`spec_stats` counts the acceptance.
    """

    def __init__(self, cfg: ModelConfig, params, num_slots: int = 4,
                 max_len: int = 128, prepack: bool | None = None,
                 kv_block_size: int = 16, num_kv_blocks: int = 0,
                 chunked_prefill: bool = False, kernel_backend=None,
                 device: str | torch.device = "cuda",
                 prefix_cache: bool = False,
                 speculate_k: int = 0, drafter="ngram", mesh=None,
                 cuda_graphs: bool = True):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if chunked_prefill and kv_block_size <= 0:
            raise ValueError(
                "chunked_prefill streams prompts through the paged pool; "
                "set kv_block_size > 0 to enable it")
        if prefix_cache and kv_block_size <= 0:
            raise ValueError(
                "prefix_cache shares paged pool blocks between requests; "
                "set kv_block_size > 0 to enable it")
        if not 0 <= speculate_k <= 16:
            raise ValueError(
                f"speculate_k={speculate_k} out of range: the draft "
                f"depth must be 0 (off) .. 16")
        if speculate_k > 0 and kv_block_size <= 0:
            raise ValueError(
                "speculative decoding rolls rejected draft KV writes "
                "back through the paged pool; set kv_block_size > 0 to "
                "enable it")
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving is not ported yet")
        self.engine = ServeEngine(cfg, params, max_len=max_len,
                                  prepack=prepack,
                                  kernel_backend=kernel_backend,
                                  device=device, cuda_graphs=cuda_graphs)
        self.cfg = cfg
        self.params = self.engine.params
        self.device = self.engine.device
        self.num_slots = num_slots
        self.max_len = max_len
        self.paged = kv_block_size > 0
        self.chunked_prefill = chunked_prefill
        self.prefix_caching = prefix_cache
        # pure-recurrent stacks page no KV, but still stream their
        # prompts in chunks through their slot's rows
        self._has_kv = kv_pool.has_kv_cache(cfg)
        self._has_recurrent = kv_pool.has_recurrent_state(cfg)
        if self.paged:
            self.block_size = kv_block_size
            self.table_width = kv_pool.table_width(max_len, kv_block_size)
            self.num_kv_blocks = (num_kv_blocks
                                  or num_slots * self.table_width)
            self.states = lm.init_paged_state(
                cfg, num_slots, max_len, num_blocks=self.num_kv_blocks,
                block_size=kv_block_size, device=self.device)
            self._one: list[dict] = []
            # a snapshot is one slot's recurrent rows; the budget bounds
            # how many the cache and the prefills in flight hold
            self._max_snapshots = None
            budget = snapshot_budget(self.device) \
                if prefix_cache and self._has_recurrent else None
            if budget is not None:
                self._max_snapshots = max(
                    1, budget // kv_pool.slot_recurrent_bytes(self.states))
        else:
            self.block_size = self.table_width = self.num_kv_blocks = 0
            self.states = lm.init_state(cfg, num_slots, max_len,
                                        device=self.device)
            # the admission prefill's own batch-1 window, spliced into
            # the slot's row
            self._one = lm.init_state(cfg, 1, max_len, device=self.device)
        self._step = make_slot_step(cfg,
                                    kv_len=max_len if self.paged else None)
        self.speculate_k = speculate_k
        if self.speculate_k > 0:
            self._drafter = spec.resolve_drafter(drafter)
            self._spec_step = make_spec_step(cfg, self.speculate_k,
                                             kv_len=max_len)
        # lifetime speculative-decoding counters (all zero at k = 0):
        # spec dispatches, active rows in them, drafts proposed and
        # accepted, tokens emitted
        self._spec_steps = self._spec_rows = 0
        self._spec_proposed = self._spec_accepted = self._spec_emitted = 0
        self.cuda_graphs = self.engine.cuda_graphs
        # "decode", "spec", or a chunk or prompt length -> its step, built
        # once
        # (lifetime: a reset keeps them)
        self._programs: dict[str | int, CompiledStep] = {}
        self._reset()

    def _reset(self) -> None:
        b = self.num_slots
        # the captured graphs hold the states' addresses, so they are set
        # back to their init values in place, never reallocated: every
        # graph stays valid across a reset and none replays against
        # freed memory
        lm.reset_states(self.cfg, self.states)
        lm.reset_states(self.cfg, self._one)
        self._prefix: kv_pool.PrefixCache | None = None
        if self.paged:
            self._alloc = kv_pool.BlockAllocator(self.num_kv_blocks)
            self._block_table = np.zeros((b, self.table_width), np.int32)
            # each row's leading columns the steps must not write
            self._shared_cols = np.zeros((b,), np.int32)
            self._slot_blocks: list[list[int]] = [[] for _ in range(b)]
            if self.prefix_caching:
                # the root folds in the config and the block size, so no
                # entry matches across engines whose numerics differ
                self._prefix = kv_pool.PrefixCache(
                    self._alloc, self.block_size,
                    capacity=self.num_kv_blocks,
                    root=f"{self.cfg!r}/bs={self.block_size}",
                    max_snapshots=self._max_snapshots)
        self._prefills: dict[int, _PrefillJob] = {}
        # completions of requests that finished at their first token,
        # held until the tick returns (past a fault raised in a later
        # slot's chunk, to the next tick)
        self._finished: dict[int, Completion] = {}
        self._cur_tok = np.zeros((b, 1), np.int32)
        self._cache_index = np.zeros((b,), np.int32)
        # each slot's key (uint32 bits as int32) and temperature
        self._keys = np.zeros((b, 2), np.int32)
        self._temp = np.zeros((b,), np.float32)
        self._active = np.zeros((b,), bool)
        self._eos = np.full((b,), -1, np.int32)
        self._gen = np.zeros((b,), np.int32)
        self._max_toks = np.ones((b,), np.int32)
        self._slot_req: list[Request | None] = [None] * b
        self._slot_toks: list[list[int]] = [[] for _ in range(b)]
        self._slot_admitted = np.zeros((b,), np.int64)
        self._events: list[tuple[int, int, int]] = []
        # lifetime dispatch counters (a contiguous admission's prefill
        # counts as one chunk) and the host time spent in decode and in
        # prefill dispatches, builds excluded (each ends in a
        # device-to-host copy, which waits for the step to finish)
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.decode_seconds = 0.0
        self.prefill_seconds = 0.0

    # -- admission ---------------------------------------------------------

    def _blocks_for(self, req: Request) -> int:
        if not self._has_kv:
            return 0
        return kv_pool.blocks_needed(len(req.prompt), req.max_tokens,
                                     self.block_size)

    def validate_request(self, req: Request) -> None:
        if len(req.prompt) < 1:
            raise InvalidRequest(f"request {req.rid}: empty prompt")
        if req.max_tokens < 1:
            raise InvalidRequest(f"request {req.rid}: max_tokens must be "
                                 f">= 1, got {req.max_tokens}")
        self.engine.check_window(len(req.prompt), req.max_tokens)
        if not self.paged:
            return
        need = self._blocks_for(req)
        if need > self.num_kv_blocks:
            raise RequestTooLarge(
                f"request {req.rid}: needs {need} KV blocks, the pool has "
                f"{self.num_kv_blocks}")

    def _free_slot(self) -> int | None:
        for slot in range(self.num_slots):
            if not self._active[slot] and self._slot_req[slot] is None:
                return slot
        return None

    def _prefix_peek(self, req: Request) -> tuple[int, list[str], bool]:
        """The cache lookup for ``req``, moving nothing: (matched blocks,
        chain hashes, whether the match needs a copy-on-write).  A
        recurrent stack resumes only at a snapshot strictly before the
        last prompt token; a dense one can take a fully cached prompt by
        copying its last block and re-running the last token."""
        plen = len(req.prompt)
        hashes = self._prefix.hashes(req.prompt)
        if self._has_recurrent:
            n = self._prefix.match(hashes, need_snapshot=True,
                                   limit=(plen - 1) // self.block_size)
            return n, hashes, False
        n = self._prefix.match(hashes)
        return n, hashes, n > 0 and n * self.block_size == plen

    def blocks_needed(self, req: Request) -> int:
        """KV blocks admission would newly allocate for ``req`` (0 on
        contiguous windows or without KV): with the prefix cache, the
        total less the shared attachments, plus the copy-on-write
        block of a fully cached prompt."""
        if not self.paged:
            return 0
        total = self._blocks_for(req)
        if self._prefix is None or total == 0:
            return total
        n, _, cow = self._prefix_peek(req)
        return total - n + cow

    @property
    def num_free_slots(self) -> int:
        """Slots neither decoding nor mid-prefill."""
        return sum(not self._active[s] and self._slot_req[s] is None
                   for s in range(self.num_slots))

    @property
    def total_blocks(self) -> int:
        """The pool's KV blocks (0 on contiguous windows)."""
        return self.num_kv_blocks if self.paged else 0

    @property
    def free_blocks(self) -> int:
        """KV blocks admission can spend now: the free list, plus cached
        blocks no request references (evictable on demand); 0 on
        contiguous windows."""
        if not self.paged:
            return 0
        free = self._alloc.free_blocks
        if self._prefix is not None:
            free += self._prefix.evictable_blocks
        return free

    def can_fund(self, req: Request) -> bool:
        """A free slot and, paged, enough free and evictable blocks net
        of the request's cache hit, right now (advisory: nothing
        moves)."""
        if self._free_slot() is None:
            return False
        if not self.paged:
            return True
        if self._prefix is None:
            return self._alloc.can_alloc(self._blocks_for(req))
        total = self._blocks_for(req)
        if total == 0:
            return True
        n, hashes, cow = self._prefix_peek(req)
        return total - n + cow <= self._alloc.free_blocks \
            + self._prefix.evictable_margin(exclude=hashes[:n])

    def in_flight(self) -> list[int]:
        """rids holding a slot (decoding or mid-prefill)."""
        return [req.rid for req in self._slot_req if req is not None]

    def start_request(self, req: Request, step: int = 0
                      ) -> Completion | None:
        """Admit one request into a free slot.  Paged: claim its KV
        blocks (with the prefix cache, attach its cached prefix); its
        prompt's tail is fed by the following ticks.  Contiguous: prefill
        it now; returns its :class:`Completion` if it finished at its
        first token, else None."""
        self.validate_request(req)
        slot = self._free_slot()
        if slot is None:
            raise PoolExhausted(f"request {req.rid}: all {self.num_slots} "
                                f"decode slots are occupied")
        if not self.paged:
            return self._admit(slot, req, step)
        if not self._admit_paged(slot, req, step):
            raise PoolExhausted(
                f"request {req.rid}: needs {self.blocks_needed(req)} KV "
                f"blocks, the pool has {self.free_blocks} free")
        return None

    def _admit_paged(self, slot: int, req: Request, step: int) -> bool:
        """Claim ``slot`` and the request's blocks, or return False and
        move nothing.  With the prefix cache: evict idle entries if the
        free list alone cannot fund the private part, attach the matched
        blocks read-only (one reference each), allocate the rest (all or
        nothing: the attached blocks are released if that fails), and
        for a fully cached dense prompt reserve the copy-on-write block
        (the copy itself runs before the tail's chunk).  A recurrent
        stack restores the slot's rows from the match's snapshot, or
        resets them."""
        total = self._blocks_for(req)
        plen = len(req.prompt)
        n_match, hashes, cow = 0, [], False
        if self._prefix is not None:
            n_match, hashes, cow = self._prefix_peek(req)
        private = total - n_match + cow if n_match and self._has_kv \
            else total
        if self._prefix is not None and self._alloc.free_blocks < private:
            self._prefix.evict_blocks(private - self._alloc.free_blocks,
                                      exclude=hashes[:n_match])
        shared: list[int] = []
        if n_match and self._has_kv:
            shared = self._prefix.attach(hashes[:n_match])
        ids = self._alloc.alloc(private)
        if ids is None:
            if shared:                     # admission is atomic
                self._alloc.release(shared)
            return False
        cow_dst, table_private = (ids[0], ids[1:]) if cow else (-1, ids)
        row = shared + table_private
        self._slot_blocks[slot] = shared + ids
        self._block_table[slot, :] = 0
        self._block_table[slot, :len(row)] = row
        self._shared_cols[slot] = len(shared)
        # a fully cached dense prompt re-runs its last token (into the
        # private copy); otherwise the tail starts at the first uncached
        # block edge
        tail_start = min(n_match * self.block_size, plen - 1) if cow \
            else n_match * self.block_size
        if self._has_recurrent:
            snap = self._prefix.snapshot_at(hashes[n_match - 1]) \
                if n_match else None
            if snap is not None:
                kv_pool.restore_slot_recurrent(self.states, snap, slot)
            else:
                # the chunks accumulate the prompt's state in the slot's
                # rows: scrub the retired occupant's state first
                lm.reset_states(self.cfg, self.states, row=slot)
        if self._prefix is not None and tail_start > 0:
            self._prefix.hits += 1
            self._prefix.tokens_skipped += tail_start
            self._prefix.blocks_shared += len(shared)
        prompt = [int(t) for t in req.prompt]
        self._prefills[slot] = _PrefillJob(
            req=req, prompt=prompt, pos=tail_start, hashes=hashes,
            cow_col=n_match - 1 if cow else -1, cow_dst=cow_dst)
        self._slot_req[slot] = req
        self._slot_toks[slot] = []
        self._slot_admitted[slot] = step
        return True

    def _admit(self, slot: int, req: Request, step: int
               ) -> Completion | None:
        """Contiguous admission: one program prefills the prompt, draws
        token 0 with ``prng_key(seed)`` at the request's temperature and
        splices the window into ``slot``'s row.  A request that finished
        at token 0 completes here and leaves the slot free (its row is
        written all the same; the next admission overwrites it)."""
        prompt = [int(t) for t in req.prompt]
        key = prng.prng_key(req.seed).numpy()
        temp = np.float32(req.temperature)
        tok0 = int(self._dispatch(len(prompt), [prompt], slot, key,
                                  temp.view(np.int32))[0, 0])
        self.prefill_chunks += 1
        if tok0 == req.eos_id or req.max_tokens == 1:
            reason = "eos" if tok0 == req.eos_id else "length"
            return Completion(req.rid, prompt, [tok0], reason, step, step)
        self._slot_req[slot] = req
        self._slot_admitted[slot] = step
        self._start_decode(slot, req, tok0, key, temp, len(prompt))
        return None

    def _start_decode(self, slot: int, req: Request, tok0: int,
                      key: np.ndarray, temp: np.float32, depth: int) -> None:
        """``slot`` joins decode after its prompt of ``depth`` tokens and
        its first token ``tok0``."""
        self._cur_tok[slot, 0] = tok0
        self._cache_index[slot] = depth
        self._keys[slot] = key
        self._temp[slot] = temp
        self._active[slot] = True
        self._eos[slot] = req.eos_id if req.eos_id >= 0 else -1
        self._gen[slot] = 1
        self._max_toks[slot] = req.max_tokens
        self._slot_toks[slot] = [tok0]
        self._events.append((req.rid, 0, tok0))

    def _retire(self, slot: int) -> None:
        if self.paged:
            # one reference a block: private blocks go back to the free
            # list, shared ones stay live under the cache's reference
            self._alloc.release(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
            self._block_table[slot, :] = 0
            self._shared_cols[slot] = 0
        self._slot_req[slot] = None
        self._slot_toks[slot] = []

    def _snapshot_room(self, pf: _PrefillJob) -> bool:
        """Whether ``pf`` may take one more snapshot within the budget,
        counting the cache's and those of every prefill in flight; at
        the budget it frees the cache's LRU snapshot, else ``pf``'s
        shallowest (a deeper resume point skips more)."""
        cap = self._prefix.max_snapshots
        held = self._prefix.snapshots + sum(
            len(p.snaps) for p in self._prefills.values())
        if cap is None or held < cap or self._prefix.drop_snapshot():
            return True
        if pf.snaps:
            del pf.snaps[min(pf.snaps)]
            return True
        return False

    def _register_prefix(self, slot: int, pf: _PrefillJob) -> None:
        """Index every full prompt block of a completed prefill (the
        attached prefix dedupes against its own entries), then widen the
        slot's write protection over them: decode writes start past the
        prompt, so this reroutes nothing and makes every cached block
        read-only for its registering request too."""
        n_full = len(pf.hashes)
        if self._prefix is None or n_full == 0:
            return
        blocks = [int(b) for b in self._block_table[slot, :n_full]] \
            if self._has_kv else [None] * n_full
        self._prefix.register(pf.hashes, blocks,
                              pf.snaps if self._has_recurrent else None)
        if self._has_kv:
            self._shared_cols[slot] = max(int(self._shared_cols[slot]),
                                          n_full)

    # -- the steps ---------------------------------------------------------

    def program(self, key: str | int, *values) -> CompiledStep:
        """The compiled step of ``key`` ("decode", "spec", or a chunk or
        prompt length), built at its first use and warmed up on
        ``values``, its first call's inputs.  A contiguous step writes
        the rows its inputs name, so it is built on real inputs: zeros
        would write position 0 of every row.  The spec step is warmed up
        on zeros instead, a step in which no row decodes: every cell it
        probes is the trash block's and is restored, and no recurrent
        row moves, so the warm-up leaves everything as it was.  On real
        inputs it would not: run twice, the restore of the cells a row
        keeps (sent to the trash block) writes what the first run left
        there, so the trash block would differ from one call's."""
        prog = self._programs.get(key)
        if prog is None:
            advances = lm.recurrent_tensors(self.cfg, self.states)
            if key == "decode":
                fn, shapes = self._decode_fn()
            elif key == "spec":
                fn, shapes = self._spec_fn()
                values = ()
            elif self.paged:
                fn, shapes = self._chunk_fn(key)
            else:
                # the admission prefill starts its window afresh
                fn, shapes = self._prefill_fn(key)
                advances = []
            prog = self.engine.compile_step(fn, shapes, *values,
                                            advances=advances)
            self._programs[key] = prog
        return prog

    def _dispatch(self, key: int, *values) -> np.ndarray:
        """One call of the prefill step of ``key`` (a chunk or prompt
        length) on ``values``, its host time (not its build) counted."""
        prog = self.program(key, *values)
        t0 = time.perf_counter()
        ints = prog(*values)
        self.prefill_seconds += time.perf_counter() - t0
        return ints

    def _decode_fn(self):
        """The slot step over all slots: (cur_tok [B,1], cache_index,
        keys [B,2], active, temp (f32 bits), eos, gen, max_toks [B]
        [, block_table [B,W], shared_cols [B]]) -> (tok, cache_index',
        active', gen', done, and the two words of step_keys, packed as
        [7, B]; logits)."""
        params, states, step = self.params, self.states, self._step
        b = self.num_slots

        def decode(cur_tok, cache_index, keys, active, temp, eos, gen,
                   max_toks, *tables):
            with self.engine.backend_ctx():
                _, tok, cache_index, keys, active, gen, done, logits = step(
                    params, states, cur_tok, cache_index, keys, active != 0,
                    temp.view(torch.float32), eos, gen, max_toks, *tables)
            ints = torch.cat([torch.stack([tok, cache_index,
                                           active.to(torch.int32), gen,
                                           done.to(torch.int32)]), keys.T])
            return ints, logits

        tables = [(b, self.table_width), (b,)] if self.paged else []
        return decode, [(b, 1), (b,), (b, 2), (b,), (b,), (b,), (b,),
                        (b,)] + tables

    def _spec_fn(self):
        """The spec step over all slots: (cur_tok [B,1], draft [B,k],
        cache_index, keys [B,2], active, temp (f32 bits), eos, gen,
        max_toks [B], block_table [B,W], shared_cols [B]) -> (emitted
        [k+1 rows], advance, cache_index', active', gen', done, and the
        two words of the carried keys, packed as [k+8, B],)."""
        params, states, step = self.params, self.states, self._spec_step
        b, k = self.num_slots, self.speculate_k

        def spec_step(cur_tok, draft, cache_index, keys, active, temp, eos,
                      gen, max_toks, block_table, shared_cols):
            with self.engine.backend_ctx():
                _, emitted, adv, cache_index, keys, active, gen, done = step(
                    params, states, cur_tok, draft, cache_index, keys,
                    active != 0, temp.view(torch.float32), eos, gen,
                    max_toks, block_table, shared_cols)
            return (torch.cat([emitted.T, torch.stack(
                [adv, cache_index, active.to(torch.int32), gen,
                 done.to(torch.int32)]), keys.T]),)

        return spec_step, [(b, 1), (b, k), (b,), (b, 2), (b,), (b,), (b,),
                           (b,), (b,), (b, self.table_width), (b,)]

    def _prefill_fn(self, length: int):
        """A contiguous admission of a prompt of ``length`` tokens:
        (tokens [1,length], slot [1], key [1,2], temp [1] (f32 bits)) ->
        (token 0, drawn with ``key`` at ``temp`` [1, 1]; logits [1,1,V]).

        The batch-1 window is set back to its init values (K/V zeroed
        past the prompt, recurrent rows fresh), the prompt prefilled into
        it from position 0 (the reference's fresh ``init_state``), and
        the whole window copied into row ``slot`` of every layer's shared
        state (its ``_insert``)."""
        params, states, one, cfg = (self.params, self.states, self._one,
                                    self.cfg)

        def prefill(tokens, slot, key, temp):
            lm.reset_states(cfg, one, kv_from=length)
            start = torch.zeros((), dtype=torch.int32, device=tokens.device)
            with self.engine.backend_ctx():
                logits, _ = lm.forward(params, tokens, cfg, states=one,
                                       cache_index=start, last_only=True)
            row = slot.to(torch.int64)
            for full, mine in zip(states, one):
                for name, t in full.items():
                    t.index_copy_(0, row, mine[name])
            return sample_token(logits, key, temp.view(torch.float32)), \
                logits

        return prefill, [(1, length), (1,), (1, 2), (1,)]

    def _chunk_fn(self, length: int):
        """One chunk of ``length`` prompt tokens of one slot against the
        shared pools: (tokens [1,length], start [1], table_row [1,W],
        slot [1], key [1,2], temp [1] (f32 bits), shared_cols [1]) ->
        (the next token drawn with ``key`` at ``temp`` [1, 1]; logits
        [1,1,V]).  Only the last chunk's token is kept.  The chunk reads
        through the table row and writes through it with the shared
        columns sent to the trash block, as the decode step does: a
        prefix-cache hit's tail attends to the shared K/V and never
        stores there.  Recurrent layers run on a batch-1 copy of the
        slot's rows, written back after the chunk (the reference's slot
        view and merge)."""
        params, states, cfg, max_len = (self.params, self.states, self.cfg,
                                        self.max_len)

        def chunk(tokens, start, table_row, slot, key, temp, shared_cols):
            row = slot.to(torch.int64)
            one = kv_pool.slot_states_view(states, row)
            write_row = kv_pool.mask_shared_cols(table_row, shared_cols)
            with self.engine.backend_ctx():
                logits, _ = lm.forward(
                    params, tokens, cfg, states=one, cache_index=start,
                    block_table=table_row, last_only=True, kv_len=max_len,
                    write_table=write_row)
            kv_pool.slot_states_merge(states, one, row)
            return sample_token(logits, key, temp.view(torch.float32)), \
                logits

        return chunk, [(1, length), (1,), (1, self.table_width), (1,),
                       (1, 2), (1,), (1,)]

    @property
    def prefix_cached_blocks(self) -> int:
        """Pool blocks pinned by the prefix cache (0 when it is off)."""
        return self._prefix.cached_blocks if self._prefix else 0

    def flush_prefix_cache(self) -> int:
        """Drop every cache entry no live request pins; returns the
        blocks released.  After :meth:`drain` and this, no block is
        live."""
        return self._prefix.flush() if self._prefix else 0

    def prefix_stats(self) -> dict[str, int]:
        """Lifetime prefix-cache counters (all zero when it is off):
        admissions that skipped prefill work, prompt tokens skipped,
        shared-block attachments, and the entries and blocks held now."""
        if self._prefix is None:
            return {"hits": 0, "tokens_skipped": 0, "blocks_shared": 0,
                    "entries": 0, "cached_blocks": 0}
        return {"hits": self._prefix.hits,
                "tokens_skipped": self._prefix.tokens_skipped,
                "blocks_shared": self._prefix.blocks_shared,
                "entries": len(self._prefix),
                "cached_blocks": self._prefix.cached_blocks}

    def step_programs(self) -> dict:
        """How many times each step was built: the counterpart of the
        reference's jit cache sizes, ``{"decode": 1, "chunk": {16: 1,
        4: 1}}`` after a paged run whose chunks were 16 and 4 tokens
        long, ``{"decode": 1, "prefill": {5: 1, 9: 1}}`` after a
        contiguous run of prompts of 5 and 9 tokens.  With speculative
        decoding the spec step takes the decode step's place:
        ``{"decode": 0, "spec": 1, "chunk": {...}}``."""
        progs = {"decode": int("decode" in self._programs)}
        if self.speculate_k > 0:
            progs["spec"] = int("spec" in self._programs)
        progs["chunk" if self.paged else "prefill"] = {
            k: 1 for k in sorted(k for k in self._programs
                                 if not isinstance(k, str))}
        return progs

    def spec_stats(self) -> dict[str, float]:
        """Lifetime speculative-decoding counters (all zero at k = 0):
        spec dispatches run, active rows in them, draft tokens proposed
        and accepted, tokens emitted, the ``acceptance_rate`` (accepted
        over proposed) and the ``advance_per_step`` (tokens emitted a
        row a dispatch; above 1 speculation wins), the reference's."""
        return {"steps": self._spec_steps,
                "rows": self._spec_rows,
                "proposed": self._spec_proposed,
                "accepted": self._spec_accepted,
                "emitted": self._spec_emitted,
                "acceptance_rate": (self._spec_accepted
                                    / max(1, self._spec_proposed)),
                "advance_per_step": (self._spec_emitted
                                     / max(1, self._spec_rows))}

    def graphs_captured(self) -> tuple[int, float]:
        """(CUDA graphs captured, seconds spent building them: warm-up
        and capture)."""
        progs = [p for p in self._programs.values() if p.graph is not None]
        return len(progs), sum(p.build_seconds for p in progs)

    def last_logits(self) -> dict[str | int, torch.Tensor]:
        """Each step's logits from its last call, on the device ("decode"
        [B,1,V], a chunk or prompt length [1,1,V]); the next call
        overwrites them."""
        return {k: p.aux[0] for k, p in self._programs.items() if p.aux}

    def _feed_prefills(self, step: int, out: dict[int, Completion],
                       fault_hook=None) -> int:
        """Feed every mid-prefill slot one chunk (after a pending
        copy-on-write); a slot whose prompt is complete registers its
        prefix blocks and draws its first token.  Returns the
        dispatches.

        ``fault_hook("chunk", rid)`` runs before each slot's chunk and
        its copy-on-write; a raise leaves that slot's job, its table row
        (still on the shared block, which ``shared_cols`` protects) and
        its reserved block as they were, for ``cancel`` to clean up."""
        dispatches = 0
        for slot in sorted(self._prefills):
            pf = self._prefills[slot]
            if fault_hook is not None:
                fault_hook("chunk", pf.req.rid)
            if pf.cow_col >= 0:
                # a fully cached prompt: copy the shared last block into
                # the reserved private one, repoint the column, and drop
                # the shared reference
                src = int(self._block_table[slot, pf.cow_col])
                kv_pool.copy_block(self.states, src, pf.cow_dst)
                self._block_table[slot, pf.cow_col] = pf.cow_dst
                self._shared_cols[slot] = pf.cow_col
                self._slot_blocks[slot].remove(src)
                self._alloc.release([src])
                pf.cow_col = pf.cow_dst = -1
                dispatches += 1
            chunk = self.block_size if self.chunked_prefill \
                else len(pf.prompt)
            c = min(chunk, len(pf.prompt) - pf.pos)
            req = pf.req
            key = prng.prng_key(req.seed).numpy()
            temp = np.float32(req.temperature)
            tok0 = int(self._dispatch(c, pf.prompt[pf.pos:pf.pos + c],
                                      pf.pos, self._block_table[slot], slot,
                                      key, temp.view(np.int32),
                                      self._shared_cols[slot])[0, 0])
            pf.pos += c
            dispatches += 1
            self.prefill_chunks += 1
            if self._prefix is not None and self._has_recurrent \
                    and pf.pos % self.block_size == 0:
                # the chunk ended on a block edge: snapshot the slot's
                # rows so that this prefix's entry can be resumed
                i = pf.pos // self.block_size - 1
                if i < len(pf.hashes) and pf.hashes[i] not in self._prefix \
                        and self._snapshot_room(pf):
                    pf.snaps[i] = kv_pool.snapshot_slot_recurrent(
                        self.states, slot)
            if pf.pos < len(pf.prompt):
                continue
            del self._prefills[slot]
            self._register_prefix(slot, pf)
            if tok0 == req.eos_id or req.max_tokens == 1:
                reason = "eos" if tok0 == req.eos_id else "length"
                out[req.rid] = Completion(
                    req.rid, pf.prompt, [tok0], reason,
                    int(self._slot_admitted[slot]), step)
                self._retire(slot)
                continue
            self._start_decode(slot, req, tok0, key, temp, len(pf.prompt))
        return dispatches

    def _run_decode(self, key: str, *args) -> np.ndarray:
        """One call of the decode or spec step, its host time counted."""
        prog = self.program(key, *args)
        t0 = time.perf_counter()
        ints = prog(*args)
        self.decode_seconds += time.perf_counter() - t0
        self.decode_steps += 1
        return ints

    def _emit(self, slot: int, toks: Sequence[int], done: bool, step: int,
              out: dict[int, Completion]) -> None:
        """Stream ``slot``'s new tokens in order; retire it if done (its
        last token is the decider: an EOS-capped advance ends on the
        EOS)."""
        req = self._slot_req[slot]
        for tok in toks:
            self._slot_toks[slot].append(tok)
            self._events.append((req.rid, len(self._slot_toks[slot]) - 1,
                                 tok))
        if done:
            reason = "eos" if toks[-1] == req.eos_id else "length"
            out[req.rid] = Completion(
                req.rid, [int(t) for t in req.prompt],
                self._slot_toks[slot], reason,
                int(self._slot_admitted[slot]), step)
            self._retire(slot)

    def _decode_one(self, step: int, out: dict[int, Completion],
                    was_active: np.ndarray) -> None:
        """One slot-wise decode step: a token for every decoding slot."""
        ints = self._run_decode(
            "decode", self._cur_tok, self._cache_index, self._keys,
            self._active, self._temp.view(np.int32), self._eos, self._gen,
            self._max_toks,
            *((self._block_table, self._shared_cols) if self.paged else ()))
        tok, self._cache_index, active, self._gen, done = ints[:5]
        self._keys = ints[5:].T.copy()
        self._cur_tok = tok[:, None].copy()
        self._active = active.astype(bool)
        for slot in np.nonzero(was_active)[0]:
            self._emit(slot, [int(tok[slot])], bool(done[slot]), step, out)

    def _decode_spec(self, step: int, out: dict[int, Completion],
                     was_active: np.ndarray) -> None:
        """One draft-and-verify step: draft k tokens for every decoding
        slot on the host, run the spec step, then stream a variable
        number of tokens a slot (``advance`` in [1, k + 1]), each one an
        ordinary event, equal to the one-token path's."""
        k = self.speculate_k
        contexts: list[list[int] | None] = [None] * self.num_slots
        for slot in np.nonzero(was_active)[0]:
            contexts[slot] = ([int(t) for t in self._slot_req[slot].prompt]
                              + self._slot_toks[slot])
        drafts = spec.build_drafts(self._drafter, contexts, k,
                                   self.cfg.vocab_size)
        ints = self._run_decode(
            "spec", self._cur_tok, drafts, self._cache_index, self._keys,
            self._active, self._temp.view(np.int32), self._eos, self._gen,
            self._max_toks, self._block_table, self._shared_cols)
        emitted = ints[:k + 1].T
        adv, self._cache_index, active, self._gen, done = ints[k + 1:k + 6]
        self._keys = ints[k + 6:].T.copy()
        self._active = active.astype(bool)
        n_rows = int(was_active.sum())
        self._spec_steps += 1
        self._spec_rows += n_rows
        self._spec_proposed += k * n_rows
        for slot in np.nonzero(was_active)[0]:
            m = int(adv[slot])
            self._spec_accepted += m - 1
            self._spec_emitted += m
            self._cur_tok[slot, 0] = emitted[slot, m - 1]
            self._emit(slot, [int(t) for t in emitted[slot, :m]],
                       bool(done[slot]), step, out)

    @torch.inference_mode()
    def tick(self, step: int = 0, fault_hook=None) -> TickResult:
        """One iteration: a chunk for every mid-prefill slot, then the
        slot-wise decode step (or, with ``speculate_k``, the spec step)
        if any slot is live.

        ``fault_hook(point, rid)`` runs before each dispatch (``"chunk"``
        with the slot's rid, ``"decode"`` with None) and may raise:
        nothing of that dispatch has moved then, so the caller can cancel
        a victim and tick again."""
        out = self._finished
        dispatches = self._feed_prefills(step, out, fault_hook)
        decoded = False
        if self._active.any():
            if fault_hook is not None:
                fault_hook("decode", None)
            was_active = self._active.copy()
            if self.speculate_k > 0:
                self._decode_spec(step, out, was_active)
            else:
                self._decode_one(step, out, was_active)
            decoded = True
            dispatches += 1
        events, self._events = self._events, []
        self._finished = {}
        return TickResult(events, out, dispatches, decoded)

    def _slot_of(self, rid: int) -> int | None:
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.rid == rid:
                return slot
        return None

    def cancel(self, rid: int, step: int = 0,
               reason: str = "cancelled") -> Completion | None:
        """Retire request ``rid`` mid-flight: free its slot and blocks
        (one reference each, so shared blocks stay with their other
        holders) and return its partial completion (``truncated``; the
        tokens so far, none mid-prefill), or None if it is not in
        flight.  Its co-tenants are untouched: a row's lane was isolated
        every step, and the slot's next occupant starts afresh as after
        a natural retirement."""
        slot = self._slot_of(rid)
        if slot is None:
            return None
        req = self._slot_req[slot]
        tokens = list(self._slot_toks[slot])
        self._active[slot] = False
        self._prefills.pop(slot, None)
        self._retire(slot)
        return Completion(req.rid, [int(t) for t in req.prompt], tokens,
                          reason, int(self._slot_admitted[slot]), step,
                          truncated=True)

    def drain(self, step: int = 0) -> dict[int, Completion]:
        """Retire every request in flight, returning their partial
        completions (finish reason ``"truncated"``).  Afterwards every
        slot is free and no block is live but the prefix cache's."""
        return {rid: self.cancel(rid, step, reason="truncated")
                for rid in self.in_flight()}

    def run(self, requests: Sequence[Request], max_steps: int = 100_000
            ) -> dict[int, Completion]:
        """Serve a trace to completion, admitting FIFO in arrival order
        as slots and blocks free up.  Returns ``{rid: Completion}``."""
        taken = {r.rid for r in requests if r.rid is not None}
        if len(taken) != sum(r.rid is not None for r in requests):
            raise InvalidRequest("duplicate request rids")
        reqs, next_rid = [], 0
        for r in requests:
            if r.rid is None:
                while next_rid in taken:
                    next_rid += 1
                r = dataclasses.replace(r, rid=next_rid)
                taken.add(next_rid)
            reqs.append(r)
        for r in reqs:
            self.validate_request(r)
        pending = deque(sorted(reqs, key=lambda r: r.arrival))
        ready: deque = deque()
        out: dict[int, Completion] = {}
        step = 0
        work = 0
        while pending or ready or self._prefills or self._active.any():
            if work > max_steps:
                raise SchedulerStalled(
                    f"scheduler exceeded max_steps={max_steps}")
            while pending and pending[0].arrival <= step:
                ready.append(pending.popleft())
            while ready and self.can_fund(ready[0]):
                comp = self.start_request(ready.popleft(), step)
                if comp is not None:        # finished at its first token
                    out[comp.rid] = comp
            res = self.tick(step)
            work += res.dispatches
            out.update(res.completions)
            if not res.decoded:
                if self._prefills:
                    step += 1
                    continue
                if pending:
                    step = max(step + 1, pending[0].arrival)
                    continue
                if not ready:
                    break
                # admitted requests that all finished at prefill freed
                # their slots for ``ready``: admit on the next tick.  Here
                # nothing is live (no prefill, no slot decoding), so a
                # head that cannot be funded now never will be
                if not self.can_fund(ready[0]):
                    raise SchedulerStalled(
                        f"request {ready[0].rid} can never be funded: "
                        f"{self.free_blocks} KV blocks free, "
                        f"{self.blocks_needed(ready[0])} needed")
            step += 1
        return out


def synthetic_workload(n_requests: int, vocab_size: int, *,
                       min_prompt: int = 1, max_prompt: int = 8,
                       max_new: int = 16, mean_interarrival: float = 0.0,
                       temperature_choices: Sequence[float] = (0.0,),
                       shared_prefix_len: int = 0,
                       seed: int = 0, poisson_rate: float = 0.0,
                       priority_choices: Sequence[int] = (0,),
                       deadline_ms: float | None = None) -> list[Request]:
    """A seeded trace: prompt lengths uniform in ``[min_prompt,
    max_prompt]``, ``max_new`` tokens each, no EOS, exponential
    inter-arrival gaps in scheduler steps (0 = a burst), and a
    temperature drawn from ``temperature_choices`` and a seed for each
    request.  The temperatures and seeds are drawn after everything
    else, so the prompts and arrivals do not depend on them.

    ``poisson_rate`` (requests a second; it overrides
    ``mean_interarrival``) draws a Poisson arrival process for the front
    end: ``arrival_time`` carries each arrival in seconds, and
    ``arrival`` its integer shadow, so the same trace still runs through
    ``ContinuousBatchingScheduler.run``.  ``priority_choices`` stamps a
    priority drawn uniformly on each request, after every other draw,
    and ``deadline_ms`` the same deadline on all of them.  At their
    defaults a trace is the one this function gave before they existed.

    ``shared_prefix_len > 0`` models the system-prompt and multi-turn
    traffic the prefix cache serves, with the reference's semantics: one
    prefix of that length is drawn, and a prompt of ``plen`` tokens is
    ``prefix[:plen]`` (a fully cached prompt where the prefix is whole
    blocks), or the prefix followed by the last ``plen -
    shared_prefix_len`` tokens drawn for it.  The prefix is drawn after
    everything else, so the trace at 0 is unchanged.

    The draws are not the reference's: this trace has no EOS (the
    reference gives a share of its requests a random EOS id), a fixed
    ``max_new`` tokens a request (the reference draws 1..``max_new``),
    and its own order of draws.  The parity tests build their traces
    with the reference's function and carry them across field for
    field."""
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs = []
    for i in range(n_requests):
        if poisson_rate > 0:
            t += rng.exponential(1.0 / poisson_rate)
        elif mean_interarrival > 0:
            t += rng.exponential(mean_interarrival)
        plen = int(rng.integers(min_prompt, max_prompt + 1))
        reqs.append(Request(
            prompt=rng.integers(0, vocab_size, size=plen).tolist(),
            max_tokens=max_new, arrival=int(t), rid=i,
            arrival_time=float(t) if poisson_rate > 0 else None,
            deadline_ms=deadline_ms))
    temps = rng.choice(list(temperature_choices), size=n_requests)
    seeds = rng.integers(0, 2**31 - 1, size=n_requests)
    if shared_prefix_len > 0:
        prefix = rng.integers(0, vocab_size,
                              size=shared_prefix_len).tolist()
        reqs = [dataclasses.replace(r, prompt=prefix[:len(r.prompt)]
                                    + list(r.prompt[shared_prefix_len:]))
                for r in reqs]
    prios = rng.choice(list(priority_choices), size=n_requests)
    return [dataclasses.replace(r, temperature=float(temp), seed=int(s),
                                priority=int(pr))
            for r, temp, s, pr in zip(reqs, temps, seeds, prios)]


def oracle_completion(engine: ServeEngine, req: Request) -> list[int]:
    """``req`` run alone through the per-token loop, truncated at its
    EOS (inclusive): what the scheduler must reproduce exactly."""
    prompt = torch.tensor([list(req.prompt)], dtype=torch.int32,
                          device=engine.device)
    full = engine.generate_loop(prompt, req.max_tokens,
                                temperature=req.temperature, seed=req.seed)
    gen = [int(t) for t in full[0, prompt.shape[1]:].tolist()]
    if req.eos_id >= 0 and req.eos_id in gen:
        gen = gen[:gen.index(req.eos_id) + 1]
    return gen
