"""Drafters for speculative decoding: propose k tokens a slot.

The scheduler's draft-and-verify path (``speculate_k > 0``) asks a
drafter for k candidate continuation tokens for every active slot,
scores all k+1 positions (the current token and the drafts) in one
compiled verify step, and commits the longest prefix that matches what
the solo oracle would have emitted, plus one bonus token from the
verify logits.  The accept rule makes correctness independent of the
drafter: a slot's tokens equal solo decode's bit for bit whatever the
drafter proposes; a bad drafter costs acceptance, never output.

Two built-ins, the JAX package's:

* :class:`NgramDrafter`: prompt-lookahead self-speculation (prompt
  lookup decoding): find the longest n-gram suffix of the slot's
  context earlier in that same context, and propose the tokens that
  followed it.  No second model, no device memory.
* :class:`ModelDrafter`: a greedy k-token continuation from a second,
  smaller :class:`~repro_torch.serve.engine.ServeEngine`.  Its numerics
  do not reach the output, so it crops or pads the context to one fixed
  window: one compiled prefill, whatever the context's length.

A custom drafter needs only ``propose(context, k) -> list[int]``.
Everything here but ``ModelDrafter.propose`` is plain Python on the
host.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch


class NgramDrafter:
    """Prompt-lookahead self-speculation.

    ``max_ngram`` bounds the suffix matched against the earlier context
    (the longest match wins, the most recent occurrence on ties).  A
    proposal shorter than k (no match, or a match near the context's
    end) is padded with its own last token, or the context's; the
    accept rule makes padding harmless.
    """

    def __init__(self, max_ngram: int = 3):
        if max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {max_ngram}")
        self.max_ngram = max_ngram

    def propose(self, context: Sequence[int], k: int) -> list[int]:
        ctx = list(context)
        out: list[int] = []
        for n in range(min(self.max_ngram, len(ctx) - 1), 0, -1):
            suffix = ctx[-n:]
            # the most recent earlier occurrence of the n-gram suffix
            for start in range(len(ctx) - n - 1, -1, -1):
                if ctx[start:start + n] == suffix:
                    out = ctx[start + n: start + n + k]
                    break
            if out:
                break
        pad = out[-1] if out else ctx[-1]
        return (out + [pad] * k)[:k]


class ModelDrafter:
    """Greedy draft continuation from a second (small) engine.

    ``window`` is the fixed context shape the draft engine sees: the
    last ``window`` context tokens, left-padded with token 0 when the
    context is shorter.  One shape is one compiled prefill; the padding
    and cropping shift the draft model's predictions, which moves the
    acceptance rate and never the output.
    """

    def __init__(self, engine, window: int = 32):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.engine = engine
        self.window = min(window, engine.max_len - 1)

    def propose(self, context: Sequence[int], k: int) -> list[int]:
        k = min(k, self.engine.max_len - self.window)
        if k <= 0:
            return []
        ctx = list(context)[-self.window:]
        ctx = [0] * (self.window - len(ctx)) + ctx
        prompt = torch.tensor([ctx], dtype=torch.int32,
                              device=self.engine.device)
        out = self.engine.generate(prompt, k, temperature=0.0)
        return [int(t) for t in out[0, self.window:].tolist()]


def resolve_drafter(drafter):
    """The scheduler's coercion of its ``drafter`` argument: ``"ngram"``
    (the default self-speculation drafter), None (the same), or any
    object with a ``propose`` method."""
    if drafter is None or drafter == "ngram":
        drafter = NgramDrafter()
    if not callable(getattr(drafter, "propose", None)):
        raise TypeError(
            f"drafter must be 'ngram' or expose propose(context, k); "
            f"got {drafter!r}")
    return drafter


def build_drafts(drafter, contexts: Sequence[Sequence[int] | None], k: int,
                 vocab_size: int) -> np.ndarray:
    """The [B, k] int32 draft matrix of one spec step.

    ``contexts``: each slot's whole token context (prompt and emitted
    tokens), or None for a slot that is not decoding this step (its row
    is zeros: a masked row writes only to the trash block).  Proposals
    are clamped into the vocabulary and padded or cropped to exactly
    k."""
    out = np.zeros((len(contexts), k), np.int32)
    for slot, ctx in enumerate(contexts):
        if not ctx:
            continue
        prop = list(drafter.propose(ctx, k))
        prop = (prop + [ctx[-1]] * k)[:k]
        out[slot] = np.clip(np.asarray(prop, np.int64), 0,
                            vocab_size - 1).astype(np.int32)
    return out
