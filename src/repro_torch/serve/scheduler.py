"""Continuous-batching serve scheduler: paged KV pool or contiguous
windows.

A fixed pool of ``num_slots`` decode slots shares one prepacked
parameter set and the decode state of every layer (KV storage for
attention, per-slot rows for the recurrent mLSTM and sLSTM), in one of
the reference's two layouts:

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
  fresh state first.  A pure-recurrent stack (xLSTM) pages no KV: its
  requests take 0 blocks.
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
card's ``cuda`` backend too.  The recurrences sum a head's lanes in a
fixed tree whatever the batch (``models/xlstm.py``), and a stack with
no attention runs no paged-attention kernel, so an xLSTM request's
tokens equal its solo tokens in both layouts on every backend.  The
paged steps hold it wherever both run the same arithmetic: on the CPU,
and on the card's ``torch`` backend.  On the ``cuda`` backend they
attend through the paged-attention kernel, which sums in another order
than the solo loop's plain attention, so the two can part at
near-ties; a request served alone through the scheduler still gives
its tokens in any batch.

MoE configs schedule fine but are excluded from the guarantee: expert
capacity is shared across the batch, so dropping is inherently coupled.
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

This slice serves the dense family, the xLSTM family (mLSTM and sLSTM
mixers) and the MoE family at any temperature, each request with its
own seed, and its draws are the reference's (``serve.prng`` reproduces its threefry
keys).  Prefix caching, speculative decoding, tensor parallelism and
fault-injection hooks of the JAX package are not ported yet; their
arguments raise ``NotImplementedError`` (or, with the contiguous
layout, the reference's ``ValueError``).
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
from repro_torch.serve import kv_pool, prng
from repro_torch.serve.compiled import CompiledStep
from repro_torch.serve.engine import (RequestTooLarge, ServeEngine,
                                      make_decode_step, sample_token)


class InvalidRequest(ValueError):
    """A malformed request (empty prompt, max_tokens < 1 or a duplicate
    rid)."""


class PoolExhausted(RuntimeError):
    """No slot or no KV blocks can fund the request right now."""


class SchedulerStalled(RuntimeError):
    """The serve loop exceeded its dispatch budget without draining."""


@dataclasses.dataclass
class Request:
    """One generation request.  ``arrival`` is in scheduler steps;
    ``eos_id < 0`` disables EOS; ``max_tokens`` counts every generated
    token, the EOS included; ``seed`` keys the draws at temperature > 0
    (``prng_key(seed)``, as the reference's ``PRNGKey(seed)``)."""
    prompt: Sequence[int]
    max_tokens: int
    temperature: float = 0.0
    eos_id: int = -1
    seed: int = 0
    arrival: int = 0
    rid: int | None = None


@dataclasses.dataclass
class Completion:
    rid: int
    prompt: list[int]
    tokens: list[int]                  # generated tokens, EOS included
    finish_reason: str                 # "eos" | "length"
    admitted_step: int
    finished_step: int


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
    req: Request
    prompt: list[int]
    pos: int = 0                       # prompt tokens already fed


def _mask_block_table(block_table: torch.Tensor, active: torch.Tensor
                      ) -> torch.Tensor:
    """Route every non-decoding row's KV writes to the trash block."""
    return block_table * active.to(block_table.dtype)[:, None]


def make_slot_step(cfg: ModelConfig, kv_len: int | None = None):
    """The one-dispatch-per-token core.

    (params, states, cur_tok [B,1], cache_index [B], keys [B,2],
     active [B] bool, temp [B] f32, eos [B], gen [B], max_toks [B]
     [, block_table [B,W]])
      -> (states, tok [B], cache_index', step_keys [B,2], active', gen',
          done [B], logits [B,1,V])

    Every slot runs; ``active`` masks rows out of the counters.  With
    ``kv_len`` (the engine window) the states are the paged pool and the
    step takes a block table, which it masks so that rows not decoding
    write to the trash block; without, they are the contiguous windows,
    where every row writes at its own index.  Paged, the recurrent rows
    of rows not decoding keep their values (the reference's
    ``freeze_inactive_rows``).  Each row's key is folded
    with its local step number (``gen - 1``, which wraps to 0xFFFFFFFF
    for an empty slot), as ``generate_loop`` folds with ``i``, and the
    folded keys come back for the host to keep.  The logits ride along
    for the compiled step, which keeps them on the device."""
    decode = make_decode_step(cfg, kv_len=kv_len)
    paged = kv_len is not None

    def slot_step(params, states, cur_tok, cache_index, keys, active, temp,
                  eos, gen, max_toks, block_table=None):
        step_keys = prng.fold_in(keys, gen - 1)
        if paged:
            block_table = _mask_block_table(block_table, active)
        logits, new_states = decode(params, states, cur_tok, cache_index,
                                    block_table=block_table,
                                    write_table=block_table,
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
    """

    def __init__(self, cfg: ModelConfig, params, num_slots: int = 4,
                 max_len: int = 128, prepack: bool | None = None,
                 kv_block_size: int = 16, num_kv_blocks: int = 0,
                 chunked_prefill: bool = False, kernel_backend=None,
                 device: str | torch.device = "cuda",
                 prefix_cache: bool = False, speculate_k: int = 0,
                 mesh=None, cuda_graphs: bool = True):
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
        if speculate_k > 0 and kv_block_size <= 0:
            raise ValueError(
                "speculative decoding rolls rejected draft KV writes "
                "back through the paged pool; set kv_block_size > 0 to "
                "enable it")
        if prefix_cache or speculate_k or mesh is not None:
            raise NotImplementedError(
                "prefix caching, speculative decoding and tensor-parallel "
                "serving are not ported yet")
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
        else:
            self.block_size = self.table_width = self.num_kv_blocks = 0
            self.states = lm.init_state(cfg, num_slots, max_len,
                                        device=self.device)
            # the admission prefill's own batch-1 window, spliced into
            # the slot's row
            self._one = lm.init_state(cfg, 1, max_len, device=self.device)
        self._step = make_slot_step(cfg,
                                    kv_len=max_len if self.paged else None)
        self.cuda_graphs = self.engine.cuda_graphs
        # "decode", or a chunk or prompt length -> its step, built once
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
        if self.paged:
            self._alloc = kv_pool.BlockAllocator(self.num_kv_blocks)
            self._block_table = np.zeros((b, self.table_width), np.int32)
            self._slot_blocks: list[list[int]] = [[] for _ in range(b)]
        self._prefills: dict[int, _PrefillJob] = {}
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
        # counts as one chunk) and the host time spent in decode
        # dispatches (each ends in a device-to-host copy, which waits
        # for the step to finish)
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.decode_seconds = 0.0

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

    def can_fund(self, req: Request) -> bool:
        """A free slot and, paged, enough free blocks right now."""
        if self._free_slot() is None:
            return False
        return not self.paged or self._alloc.can_alloc(self._blocks_for(req))

    def start_request(self, req: Request, step: int = 0
                      ) -> Completion | None:
        """Admit one request into a free slot.  Paged: claim its KV
        blocks; its prompt is fed by the following ticks.  Contiguous:
        prefill it now; returns its :class:`Completion` if it finished at
        its first token, else None."""
        self.validate_request(req)
        slot = self._free_slot()
        if slot is None:
            raise PoolExhausted(f"request {req.rid}: all {self.num_slots} "
                                f"decode slots are occupied")
        if not self.paged:
            return self._admit(slot, req, step)
        ids = self._alloc.alloc(self._blocks_for(req))
        if ids is None:
            raise PoolExhausted(
                f"request {req.rid}: needs {self._blocks_for(req)} KV "
                f"blocks, the pool has {self._alloc.free_blocks} free")
        self._slot_blocks[slot] = ids
        self._block_table[slot, :] = 0
        self._block_table[slot, :len(ids)] = ids
        if self._has_recurrent:
            # the chunks accumulate the prompt's state in the slot's
            # rows: scrub the retired occupant's state first
            lm.reset_states(self.cfg, self.states, row=slot)
        prompt = [int(t) for t in req.prompt]
        self._prefills[slot] = _PrefillJob(req=req, prompt=prompt)
        self._slot_req[slot] = req
        self._slot_toks[slot] = []
        self._slot_admitted[slot] = step
        return None

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
            self._alloc.release(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
            self._block_table[slot, :] = 0
        self._slot_req[slot] = None
        self._slot_toks[slot] = []

    # -- the steps ---------------------------------------------------------

    def program(self, key: str | int, *values) -> CompiledStep:
        """The compiled step of ``key`` ("decode", or a chunk or prompt
        length), built at its first use and warmed up on ``values``, its
        first call's inputs.  A contiguous step writes the rows its
        inputs name, so it is built on real inputs: zeros would write
        position 0 of every row."""
        prog = self._programs.get(key)
        if prog is None:
            advances = lm.recurrent_tensors(self.cfg, self.states)
            if key == "decode":
                fn, shapes = self._decode_fn()
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

    def _dispatch(self, key: str | int, *values) -> np.ndarray:
        """One call of the step of ``key`` on ``values``."""
        return self.program(key, *values)(*values)

    def _decode_fn(self):
        """The slot step over all slots: (cur_tok [B,1], cache_index,
        keys [B,2], active, temp (f32 bits), eos, gen, max_toks [B]
        [, block_table [B,W]]) -> (tok, cache_index', active', gen',
        done, and the two words of step_keys, packed as [7, B];
        logits)."""
        params, states, step = self.params, self.states, self._step
        b = self.num_slots

        def decode(cur_tok, cache_index, keys, active, temp, eos, gen,
                   max_toks, *block_table):
            with self.engine.backend_ctx():
                _, tok, cache_index, keys, active, gen, done, logits = step(
                    params, states, cur_tok, cache_index, keys, active != 0,
                    temp.view(torch.float32), eos, gen, max_toks,
                    *block_table)
            ints = torch.cat([torch.stack([tok, cache_index,
                                           active.to(torch.int32), gen,
                                           done.to(torch.int32)]), keys.T])
            return ints, logits

        table = [(b, self.table_width)] if self.paged else []
        return decode, [(b, 1), (b,), (b, 2), (b,), (b,), (b,), (b,),
                        (b,)] + table

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
        slot [1], key [1,2], temp [1] (f32 bits)) -> (the next token
        drawn with ``key`` at ``temp`` [1, 1]; logits [1,1,V]).  Only the
        last chunk's token is kept.  Recurrent layers run on a batch-1
        copy of the slot's rows, written back after the chunk (the
        reference's slot view and merge)."""
        params, states, cfg, max_len = (self.params, self.states, self.cfg,
                                        self.max_len)

        def chunk(tokens, start, table_row, slot, key, temp):
            row = slot.to(torch.int64)
            one = kv_pool.slot_states_view(states, row)
            with self.engine.backend_ctx():
                logits, _ = lm.forward(
                    params, tokens, cfg, states=one, cache_index=start,
                    block_table=table_row, last_only=True, kv_len=max_len,
                    write_table=table_row)
            kv_pool.slot_states_merge(states, one, row)
            return sample_token(logits, key, temp.view(torch.float32)), \
                logits

        return chunk, [(1, length), (1,), (1, self.table_width), (1,),
                       (1, 2), (1,)]

    def step_programs(self) -> dict:
        """How many times each step was built: the counterpart of the
        reference's jit cache sizes, ``{"decode": 1, "chunk": {16: 1,
        4: 1}}`` after a paged run whose chunks were 16 and 4 tokens
        long, ``{"decode": 1, "prefill": {5: 1, 9: 1}}`` after a
        contiguous run of prompts of 5 and 9 tokens."""
        return {"decode": int("decode" in self._programs),
                "chunk" if self.paged else "prefill": {
                    k: 1 for k in sorted(k for k in self._programs
                                         if k != "decode")}}

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

    def _feed_prefills(self, step: int, out: dict[int, Completion]) -> int:
        dispatches = 0
        for slot in sorted(self._prefills):
            pf = self._prefills[slot]
            chunk = self.block_size if self.chunked_prefill \
                else len(pf.prompt)
            c = min(chunk, len(pf.prompt) - pf.pos)
            req = pf.req
            key = prng.prng_key(req.seed).numpy()
            temp = np.float32(req.temperature)
            tok0 = int(self._dispatch(c, pf.prompt[pf.pos:pf.pos + c],
                                      pf.pos, self._block_table[slot], slot,
                                      key, temp.view(np.int32))[0, 0])
            pf.pos += c
            dispatches += 1
            self.prefill_chunks += 1
            if pf.pos < len(pf.prompt):
                continue
            del self._prefills[slot]
            if tok0 == req.eos_id or req.max_tokens == 1:
                reason = "eos" if tok0 == req.eos_id else "length"
                out[req.rid] = Completion(
                    req.rid, pf.prompt, [tok0], reason,
                    int(self._slot_admitted[slot]), step)
                self._retire(slot)
                continue
            self._start_decode(slot, req, tok0, key, temp, len(pf.prompt))
        return dispatches

    @torch.inference_mode()
    def tick(self, step: int = 0) -> TickResult:
        """One iteration: a chunk for every mid-prefill slot, then the
        slot-wise decode step if any slot is live."""
        out: dict[int, Completion] = {}
        dispatches = self._feed_prefills(step, out)
        decoded = False
        if self._active.any():
            was_active = self._active.copy()
            args = (self._cur_tok, self._cache_index, self._keys,
                    self._active, self._temp.view(np.int32), self._eos,
                    self._gen, self._max_toks) \
                + ((self._block_table,) if self.paged else ())
            prog = self.program("decode", *args)
            t0 = time.perf_counter()
            ints = prog(*args)
            self.decode_seconds += time.perf_counter() - t0
            self.decode_steps += 1
            tok, self._cache_index, active, self._gen, done = ints[:5]
            self._keys = ints[5:].T.copy()
            self._cur_tok = tok[:, None].copy()
            self._active = active.astype(bool)
            done = done.astype(bool)
            for slot in np.nonzero(was_active)[0]:
                req = self._slot_req[slot]
                self._slot_toks[slot].append(int(tok[slot]))
                self._events.append((req.rid,
                                     len(self._slot_toks[slot]) - 1,
                                     int(tok[slot])))
                if done[slot]:
                    reason = ("eos" if int(tok[slot]) == req.eos_id
                              else "length")
                    out[req.rid] = Completion(
                        req.rid, [int(t) for t in req.prompt],
                        self._slot_toks[slot], reason,
                        int(self._slot_admitted[slot]), step)
                    self._retire(slot)
            decoded = True
            dispatches += 1
        events, self._events = self._events, []
        return TickResult(events, out, dispatches, decoded)

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
                        f"{self._alloc.free_blocks} KV blocks free, "
                        f"{self._blocks_for(ready[0])} needed")
            step += 1
        return out


def synthetic_workload(n_requests: int, vocab_size: int, *,
                       min_prompt: int = 1, max_prompt: int = 8,
                       max_new: int = 16, mean_interarrival: float = 0.0,
                       temperature_choices: Sequence[float] = (0.0,),
                       seed: int = 0) -> list[Request]:
    """A seeded trace: prompt lengths uniform in ``[min_prompt,
    max_prompt]``, ``max_new`` tokens each, no EOS, exponential
    inter-arrival gaps in scheduler steps (0 = a burst), and a
    temperature drawn from ``temperature_choices`` and a seed for each
    request.  The temperatures and seeds are drawn after everything
    else, so the prompts and arrivals do not depend on them."""
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs = []
    for i in range(n_requests):
        if mean_interarrival > 0:
            t += rng.exponential(mean_interarrival)
        plen = int(rng.integers(min_prompt, max_prompt + 1))
        reqs.append(Request(
            prompt=rng.integers(0, vocab_size, size=plen).tolist(),
            max_tokens=max_new, arrival=int(t), rid=i))
    temps = rng.choice(list(temperature_choices), size=n_requests)
    seeds = rng.integers(0, 2**31 - 1, size=n_requests)
    return [dataclasses.replace(r, temperature=float(temp), seed=int(s))
            for r, temp, s in zip(reqs, temps, seeds)]


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
