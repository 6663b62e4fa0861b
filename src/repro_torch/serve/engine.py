"""Serving engine: prefill + decode over contiguous decode states (a KV
cache per attention layer, per-row recurrent state per mLSTM, sLSTM or
Mamba layer).

``ServeEngine.generate`` runs a static batch as two compiled programs
(``serve.compiled``), on the card two CUDA graphs, built once per batch,
prompt length and temperature: prefill with the first draw, and one
decode step that is replayed ``steps - 1`` times, its token, key and
cache index handed from one replay to the next on the device.  This is
the port's counterpart of the reference's one jitted ``lax.scan`` over
the decode steps, whose loop body compiles once whatever the count.
``ServeEngine.generate_loop`` (one decode step per token, dispatched
from Python) is the oracle of both: ``generate`` must give its tokens,
and the continuous-batching scheduler each request's tokens exactly as
if it ran alone through it.  The engine prepacks ``int8``/``pum``
weights at construction, so serving pays quantisation and slicing
once, at load.

An encoder-decoder (whisper-tiny) takes ``encoder_frames`` [B, T, D]
in ``generate``, ``generate_loop`` and ``prefill``: the encoder runs
once, at prefill, and every decode step attends over its output,
projecting its K and V anew as the reference's step does.  In the
compiled programs the frames and the encoder's output live in two
device buffers of the engine's: the caller's frames are copied into the
first before the prefill program runs, which writes the second, which
the decode program reads.

Sampling follows the reference: greedy at temperature <= 0, else a
Gumbel-max draw from a threefry key (``serve.prng``), keyed by the
request's seed and folded with the step number, so a seeded request
draws the reference's tokens.
"""
from __future__ import annotations

import contextlib
from collections.abc import Callable, Sequence
from typing import Any

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core import pum_linear
from repro_torch.device import resolve_device
from repro_torch.kernels import registry
from repro_torch.models import lm
from repro_torch.serve import prng
from repro_torch.serve.compiled import CompiledStep
from repro_torch.serve.errors import RequestTooLarge


def make_decode_step(cfg: ModelConfig, kv_len: int | None = None):
    """(params, states, token [B,1], cache_index, encoder_out=None,
    block_table=None, write_table=None, commit=True) -> (logits [B,1,V],
    states).

    ``cache_index`` is a scalar for lockstep decode or [B] for slot-wise
    decode; with a paged state pass ``block_table`` and build the step
    with ``kv_len`` = the engine window.  ``commit=False`` leaves the
    recurrent states as they were and returns their successors
    (``lm.forward``).  ``encoder_out`` is an encoder-decoder's encoder
    output, which every step attends over."""

    def decode_step(params, states, token, cache_index, *,
                    encoder_out=None, block_table=None, write_table=None,
                    commit=True):
        return lm.forward(params, token, cfg, states=states,
                          cache_index=cache_index, encoder_out=encoder_out,
                          last_only=True, block_table=block_table,
                          kv_len=kv_len, write_table=write_table,
                          commit=commit)

    return decode_step


def make_verify_step(cfg: ModelConfig, kv_len: int | None = None):
    """(params, states, tokens [B,S], cache_index [B], block_table=None,
    write_table=None) -> (logits [B,S,V], states').

    The speculative verify forward: it scores all S = k + 1 positions
    (the current token and k drafts) in one pass.  Unlike
    :func:`make_decode_step` it keeps every position's logits, and it
    runs with ``collect_states=True``, so the recurrent leaves come back
    per position ([B, S, ...]) and none is written: the caller adopts
    each row's state at its accepted depth
    (``kv_pool.spec_select_recurrent``) and rolls back the pool cells of
    the rejected suffix (``kv_pool.spec_restore_cells``).  Its norms
    and float products (the f32 lm head, ``bf16`` mode's projections)
    run position by position (``pum_linear.positionwise``), each on the
    decode step's rows, so that a position's logits are the one-token
    step's bit for bit; the integer projections (``pum``, ``int8``), the
    recurrences (``layers.lane_sum``) and the paged attention already
    give a row the same bits whatever the rows beside it."""

    def verify_step(params, states, tokens, cache_index, *,
                    block_table=None, write_table=None):
        with pum_linear.positionwise():
            return lm.forward(params, tokens, cfg, states=states,
                              cache_index=cache_index, last_only=False,
                              block_table=block_table, kv_len=kv_len,
                              write_table=write_table, collect_states=True)

    return verify_step


def sample_token(logits: torch.Tensor, key: torch.Tensor | None = None,
                 temperature: float | torch.Tensor = 0.0) -> torch.Tensor:
    """logits: [B, S, V] -> [B, 1] int32 from the last position.

    Two forms, as the reference's:

    * a scalar ``temperature`` and one key [2] for the whole batch:
      greedy at ``temperature <= 0`` (no key needed), else
      ``categorical(key, last / temperature)`` over all of ``[B, V]``;
    * a vector ``temperature`` [B] (f32) and keys [B, 2]: each row
      draws from its own key at its own temperature, rows at
      ``temperature <= 0`` take the argmax.  No value goes to the host,
      so this form runs inside a captured step.

    Greedy rows take the first index on ties, as ``jnp.argmax``.  The
    division is by a device tensor: CUDA divides by a host scalar as a
    multiply by its reciprocal, which can round otherwise.
    """
    last = logits[:, -1]
    if not (isinstance(temperature, torch.Tensor) and temperature.ndim):
        t = float(temperature)
        if t <= 0.0:
            return torch.argmax(last, dim=-1)[:, None].to(torch.int32)
        if key is None:
            raise ValueError("sampling at temperature > 0 needs a key")
        scale = torch.full((1, 1), t, dtype=last.dtype, device=last.device)
        return prng.categorical(key, last / scale)[:, None].to(torch.int32)
    greedy = torch.argmax(last, dim=-1)
    hot = temperature > 0
    safe_t = torch.where(hot, temperature, torch.ones_like(temperature))
    sampled = prng.categorical(key, last / safe_t[:, None])
    return torch.where(hot, sampled, greedy)[:, None].to(torch.int32)


class ServeEngine:
    """Prefill + decode for a batch of equal-length prompts.

    ``prepack`` (default: on for int8/pum) packs float weights at
    construction; already packed params pass through.
    ``kernel_backend`` (``"cuda"``/``"torch"``/None) is made ambient for
    every step; None selects by device.  ``use_scan`` is ``generate``'s
    default: the compiled token loop, or ``generate_loop``.
    ``cuda_graphs`` (on the card only) runs every compiled program, the
    engine's and its scheduler's, as the replay of its CUDA graph; False
    dispatches their ops from Python, as on the CPU.  The graphs replay
    one after another, never at once: one memory pool and one capture
    stream serve them all.
    """

    def __init__(self, cfg: ModelConfig, params: dict[str, Any],
                 max_len: int = 128, prepack: bool | None = None,
                 kernel_backend: registry.KernelBackend | str | None = None,
                 device: str | torch.device = "cuda",
                 use_scan: bool = True, cuda_graphs: bool = True):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        self.kernel_backend = registry.coerce_backend(kernel_backend)
        if prepack is None:
            prepack = cfg.pum.mode in ("int8", "pum")
        if prepack:
            params = lm.prepack_for_serving(params, cfg)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.use_scan = use_scan
        self._decode = make_decode_step(cfg)
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda"
        if self.cuda_graphs:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(self.device)
        else:
            self._graph_pool = self._capture_stream = None
        # (batch, prompt length, temperature[, the encoder frames' (T, D,
        # dtype)]) -> generate's prefill and decode programs and the
        # window they write; with frames, the buffer they are copied into
        self._scans: dict[tuple, tuple[CompiledStep, CompiledStep,
                                       list[dict]]] = {}
        self._frames: dict[tuple, torch.Tensor] = {}

    def compile_step(self, fn: Callable, shapes: Sequence[tuple[int, ...]],
                     *values, advances: Sequence[torch.Tensor] = ()
                     ) -> CompiledStep:
        """``fn`` built as a :class:`CompiledStep` on the engine's device,
        graph pool and capture stream, warmed up on ``values`` (zeros if
        none are given); ``advances`` are the tensors it advances in
        place (``CompiledStep``)."""
        prog = CompiledStep(fn, shapes, self.device, graphs=self.cuda_graphs,
                            pool=self._graph_pool,
                            stream=self._capture_stream, advances=advances)
        if values:
            prog.stage(*values)
        prog.build()
        return prog

    @contextlib.contextmanager
    def backend_ctx(self):
        """The engine's kernel-backend selection, ambient for a step."""
        if self.kernel_backend is None:
            yield
        else:
            with registry.use_backend(self.kernel_backend):
                yield

    def check_window(self, prompt_len: int, steps: int) -> None:
        if prompt_len + steps > self.max_len:
            raise RequestTooLarge(
                f"decode window overflow: prompt_len={prompt_len} + "
                f"steps={steps} exceeds the engine's max_len="
                f"{self.max_len}")

    @torch.inference_mode()
    def encode(self, encoder_frames: torch.Tensor | None
               ) -> torch.Tensor | None:
        """An encoder-decoder's encoder output over ``encoder_frames``
        [B, T, D], taken as given (the reference's engine does not cast
        them); None for any other model or without frames."""
        if not self.cfg.is_encoder_decoder or encoder_frames is None:
            return None
        with self.backend_ctx():
            return lm._run_encoder(self.params, self.cfg,
                                   encoder_frames.to(self.device))

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor,
                encoder_frames: torch.Tensor | None = None, *,
                encoder_out: torch.Tensor | None = None
                ) -> tuple[list[dict], torch.Tensor]:
        """tokens: [B, S] -> (contiguous states, last logits [B,1,V]);
        an encoder-decoder attends over ``encoder_out``, or over the
        encoder's output on ``encoder_frames`` (:meth:`encode`)."""
        b = tokens.shape[0]
        if encoder_out is None:
            encoder_out = self.encode(encoder_frames)
        states = lm.init_state(self.cfg, b, self.max_len, self.device)
        with self.backend_ctx():
            logits, states = lm.forward(self.params, tokens, self.cfg,
                                        states=states, cache_index=0,
                                        encoder_out=encoder_out,
                                        last_only=True)
        return states, logits

    @torch.inference_mode()
    def decode(self, states, token: torch.Tensor, index, *,
               encoder_out: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, list[dict]]:
        with self.backend_ctx():
            return self._decode(self.params, states, token, index,
                                encoder_out=encoder_out)

    def _scan_programs(self, b: int, s: int, temperature: float,
                       frames: tuple | None = None
                       ) -> tuple[CompiledStep, CompiledStep, list[dict]]:
        """``generate``'s programs at one shape, both unbuilt, and the
        contiguous window of their own that they write:

        * prefill: (prompt [B,S], key [2]) -> token 0 drawn with ``key``,
          the key and the cache index ``s``;
        * decode: (token [B,1], key [2], cache index []) -> the next
          token, drawn with the key folded with ``index - s``, that key
          and ``index + 1``.

        Both return their outputs packed as the decode step's inputs, so
        a replay's outputs are the next replay's inputs: the schedule of
        ``generate_loop``, op for op.  Prefill sets the window back to
        its init values first (KV zero, recurrent rows fresh), so it
        writes only what its inputs fix; decode advances the window's
        recurrent rows, which it names (``CompiledStep``).  With
        ``frames``, the encoder frames' (T, D, dtype), prefill also runs
        the encoder on a frames buffer (``self._frames``, which
        ``generate`` fills) into a second buffer, which every decode
        step reads: the programs' float input and state."""
        cfg, params, dev = self.cfg, self.params, self.device
        states = lm.init_state(cfg, b, self.max_len, dev)
        frames_buf = enc_buf = None
        if frames is not None:
            t, d, dtype = frames
            frames_buf = torch.zeros((b, t, d), dtype=dtype, device=dev)
            self._frames[b, s, temperature, frames] = frames_buf
            pos = params["encoder"]["pos_embed"]
            enc_buf = torch.zeros((b, t, d), device=dev, dtype=
                                  torch.promote_types(dtype, pos.dtype))

        def pack(tok, key, index):
            return (torch.cat([tok.reshape(-1), key,
                               index.reshape(1).to(torch.int32)]),)

        def prefill(prompt, key):
            with self.backend_ctx():
                lm.reset_states(cfg, states)
                if enc_buf is not None:
                    enc_buf.copy_(lm._run_encoder(params, cfg, frames_buf))
                zero = torch.zeros((), dtype=torch.int32, device=dev)
                logits, _ = lm.forward(params, prompt, cfg, states=states,
                                       cache_index=zero, last_only=True,
                                       encoder_out=enc_buf)
                tok = sample_token(logits, key, temperature)
            return pack(tok, key, zero + s)

        def decode(tok, key, index):
            with self.backend_ctx():
                key = prng.fold_in(key, index - s)
                logits, _ = self._decode(params, states, tok, index,
                                         encoder_out=enc_buf)
                tok = sample_token(logits, key, temperature)
            return pack(tok, key, index + 1)

        graphs = dict(device=dev, graphs=self.cuda_graphs,
                      pool=self._graph_pool, stream=self._capture_stream)
        return (CompiledStep(prefill, [(b, s), (2,)], **graphs),
                CompiledStep(decode, [(b, 1), (2,), ()],
                             advances=lm.recurrent_tensors(cfg, states),
                             **graphs), states)

    @torch.inference_mode()
    def generate(self, prompt: torch.Tensor, steps: int,
                 temperature: float = 0.0, seed: int = 0,
                 use_scan: bool | None = None, *,
                 encoder_frames: torch.Tensor | None = None
                 ) -> torch.Tensor:
        """prompt: [B, S] -> [B, S + steps], the tokens of
        ``generate_loop`` from the compiled prefill and decode step
        (``use_scan``, the engine's default), or ``generate_loop``
        itself.  The decode step replays with no value going to the
        host; the tokens come back in one copy at the end.  An
        encoder-decoder's ``encoder_frames`` [B, T, D] are copied into
        the programs' frames buffer before prefill runs."""
        if use_scan is None:
            use_scan = self.use_scan
        if not use_scan:
            return self.generate_loop(prompt, steps, temperature, seed,
                                      encoder_frames=encoder_frames)
        if steps <= 0:
            return prompt
        b, s = prompt.shape
        self.check_window(s, steps)
        if not self.cfg.is_encoder_decoder:
            encoder_frames = None
        shape = (b, s, float(temperature))
        if encoder_frames is not None:
            shape += ((*encoder_frames.shape[1:], encoder_frames.dtype),)
        if shape not in self._scans:
            self._scans[shape] = self._scan_programs(*shape)
        prefill, decode, _ = self._scans[shape]
        if encoder_frames is not None:
            self._frames[shape].copy_(encoder_frames)
        prefill.stage(prompt.cpu().numpy().astype(np.int32),
                      prng.prng_key(seed).numpy())
        prefill.build()
        prefill.launch()
        decode.stage_from(prefill.ints)
        decode.build()
        toks = [prefill.ints[:b].clone()]
        for _ in range(steps - 1):
            decode.launch()
            decode.stage_from(decode.ints)
            toks.append(decode.ints[:b].clone())
        return torch.cat([prompt.to(self.device, torch.int32),
                          torch.stack(toks, dim=1)], dim=1)

    def scan_programs(self) -> dict[tuple, int]:
        """How many times ``generate``'s programs were built, by (batch,
        prompt length, temperature, frames): once each, whatever the
        step count, as the reference's scan body compiles once."""
        return {shape: 1 for shape in self._scans}

    def graphs_captured(self) -> tuple[int, float]:
        """(CUDA graphs of ``generate`` captured, seconds spent building
        them)."""
        progs = [p for *pair, _ in self._scans.values() for p in pair
                 if p.graph is not None]
        return len(progs), sum(p.build_seconds for p in progs)

    @torch.inference_mode()
    def generate_loop(self, prompt: torch.Tensor, steps: int,
                      temperature: float = 0.0, seed: int = 0, *,
                      encoder_frames: torch.Tensor | None = None
                      ) -> torch.Tensor:
        """prompt: [B, S] -> [B, S + steps], one decode step per token.
        The first token is drawn with ``prng_key(seed)``, and the key is
        folded with ``i`` before the draw of token ``i + 1``, as the
        reference's loop does.  An encoder-decoder runs its encoder on
        ``encoder_frames`` once, before prefill."""
        b, s = prompt.shape
        self.check_window(s, steps)
        prompt = prompt.to(self.device)
        encoder_out = self.encode(encoder_frames)
        states, logits = self.prefill(prompt, encoder_out=encoder_out)
        key = prng.prng_key(seed, self.device)
        out = [prompt.to(torch.int32)]
        tok = sample_token(logits, key, temperature)
        for i in range(steps):
            out.append(tok)
            if i == steps - 1:
                break
            key = prng.fold_in(key, i)
            logits, states = self.decode(states, tok, s + i,
                                         encoder_out=encoder_out)
            tok = sample_token(logits, key, temperature)
        return torch.cat(out, dim=1)
