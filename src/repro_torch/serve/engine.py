"""Serving engine: prefill + per-token decode over a contiguous KV cache.

``ServeEngine.generate_loop`` (one decode step per token) is the port's
solo oracle: the continuous-batching scheduler must reproduce each
request's tokens exactly as if it ran alone through it.  The engine
prepacks ``int8``/``pum`` weights at construction, so serving pays
quantisation and slicing once, at load.

Sampling follows the reference: greedy at temperature <= 0, else a
Gumbel-max draw from a threefry key (``serve.prng``), keyed by the
request's seed and folded with the step number, so a seeded request
draws the reference's tokens.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import registry
from repro_torch.models import lm
from repro_torch.serve import prng


class RequestTooLarge(ValueError):
    """The request's window exceeds the engine's ``max_len`` or its KV
    blocks exceed the whole pool: it can never be served here."""


def make_decode_step(cfg: ModelConfig, kv_len: int | None = None):
    """(params, states, token [B,1], cache_index, block_table=None,
    write_table=None) -> (logits [B,1,V], states).

    ``cache_index`` is a scalar for lockstep decode or [B] for slot-wise
    decode; with a paged state pass ``block_table`` and build the step
    with ``kv_len`` = the engine window."""

    def decode_step(params, states, token, cache_index, *,
                    block_table=None, write_table=None):
        return lm.forward(params, token, cfg, states=states,
                          cache_index=cache_index, last_only=True,
                          block_table=block_table, kv_len=kv_len,
                          write_table=write_table)

    return decode_step


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
    """Prefill + per-token decode for a batch of equal-length prompts.

    ``prepack`` (default: on for int8/pum) packs float weights at
    construction; already packed params pass through.
    ``kernel_backend`` (``"cuda"``/``"torch"``/None) is made ambient for
    every step; None selects by device.
    """

    def __init__(self, cfg: ModelConfig, params: dict[str, Any],
                 max_len: int = 128, prepack: bool | None = None,
                 kernel_backend: registry.KernelBackend | str | None = None,
                 device: str | torch.device = "cuda"):
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
        self._decode = make_decode_step(cfg)

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
    def prefill(self, tokens: torch.Tensor
                ) -> tuple[list[dict], torch.Tensor]:
        """tokens: [B, S] -> (contiguous states, last logits [B,1,V])."""
        b = tokens.shape[0]
        states = lm.init_state(self.cfg, b, self.max_len, self.device)
        with self.backend_ctx():
            logits, states = lm.forward(self.params, tokens, self.cfg,
                                        states=states, cache_index=0,
                                        last_only=True)
        return states, logits

    @torch.inference_mode()
    def decode(self, states, token: torch.Tensor, index
               ) -> tuple[torch.Tensor, list[dict]]:
        with self.backend_ctx():
            return self._decode(self.params, states, token, index)

    @torch.inference_mode()
    def generate_loop(self, prompt: torch.Tensor, steps: int,
                      temperature: float = 0.0, seed: int = 0
                      ) -> torch.Tensor:
        """prompt: [B, S] -> [B, S + steps], one decode step per token.
        The first token is drawn with ``prng_key(seed)``, and the key is
        folded with ``i`` before the draw of token ``i + 1``, as the
        reference's loop does."""
        b, s = prompt.shape
        self.check_window(s, steps)
        prompt = prompt.to(self.device)
        states, logits = self.prefill(prompt)
        key = prng.prng_key(seed, self.device)
        out = [prompt.to(torch.int32)]
        tok = sample_token(logits, key, temperature)
        for i in range(steps):
            out.append(tok)
            if i == steps - 1:
                break
            key = prng.fold_in(key, i)
            logits, states = self.decode(states, tok, s + i)
            tok = sample_token(logits, key, temperature)
        return torch.cat(out, dim=1)
