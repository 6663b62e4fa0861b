"""Deterministic synthetic token pipeline, the JAX package's
``data/synthetic.py`` (numpy only, so its batches are the reference's
bit for bit).

It draws a learnable distribution (order-2 Markov chains with
arch-specific transition tables) rather than uniform noise, so training
loss visibly decreases.  Each host materialises only its slice of the
global batch (``host_batch`` rows); on one host the full batch.  The pipeline
is stateless in (seed, step), so a restart resumes mid-stream without
losing or repeating data: a checkpoint needs only the step counter.
The reference's ``make_batch_specs`` belongs to its dry run and is not
ported.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Iterator

import numpy as np

from repro_torch.config import ModelConfig


@dataclasses.dataclass
class SyntheticTokens:
    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed + 17)
        v = min(self.cfg.vocab_size, 4096)
        # sparse-ish markov table over a reduced alphabet
        self._alpha = v
        self._table = rng.dirichlet(np.ones(8), size=(v,)).astype(np.float32)
        self._succ = rng.integers(0, v, size=(v, 8))

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.hosts

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Deterministic batch for (seed, step, host)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id)
        b = self.host_batch
        toks = np.zeros((b, self.seq_len), np.int32)
        cur = rng.integers(0, self._alpha, size=(b,))
        toks[:, 0] = cur
        for t in range(1, self.seq_len):
            choice = (rng.random(b)[:, None] <
                      np.cumsum(self._table[cur], -1)).argmax(-1)
            cur = self._succ[cur, choice]
            toks[:, t] = cur
        return {"tokens": toks}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
