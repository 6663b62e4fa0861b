"""Keyed random draws for temperature sampling: the port's copy of the
threefry functions the reference takes from ``jax.random``.

The reference draws every sampled token with
``jax.random.categorical`` from a threefry key: the first from
``PRNGKey(seed)``, each later one from that key folded with the step
number (``src/repro/serve/engine.py``, ``src/repro/serve/scheduler.py``).
This module reproduces those draws bit for bit, in JAX's partitionable
threefry layout (``jax_threefry_partitionable``, the default from JAX
0.5 on):

* ``threefry2x32(k0, k1, x0, x1)``: the Threefry-2x32 block cipher, 20
  rounds (``jax._src.prng.threefry_2x32``).
* ``prng_key(seed)``: ``[0, seed mod 2^32]``, as ``PRNGKey`` builds it
  without 64-bit mode.
* ``fold_in(keys, data)``: ``threefry2x32(key, [0, uint32(data)])``;
  ``data`` is an int32 that wraps, so the reference's ``gen - 1 = -1``
  of an empty slot folds as 0xFFFFFFFF.
* ``random_bits(key, shape)``: the counters are the 64-bit iota over
  ``shape``, split into hi and lo words; the bits are the two output
  words xor-ed.  A key ``[..., 2]`` draws over ``shape`` once per key,
  which is ``vmap`` over the key's leading axes.
* ``uniform``, ``gumbel`` (f32, "low" mode: ``-log(-log(u))`` with ``u``
  in ``[tiny, 1)``) and ``categorical`` (the Gumbel-max trick) on top.

Keys are int32 tensors holding uint32 bit patterns.  Every function is
plain PyTorch on the keys' device: nothing reads a value back to the
host, so all of it runs inside a captured CUDA graph, and nothing draws
from a ``torch.Generator`` or any other stateful generator: the same
key gives the same bits on any device.

The uint32 arithmetic runs on int32: add and xor give the same bits,
and ``<<`` drops the high bits.  torch has no logical right shift and no
rotate on int32, so the rotation masks the arithmetic right shift's
copies of the sign bit: ``rotl(x, r) = (x << r) | ((x >> (32 - r)) &
(2^r - 1))``.
"""
from __future__ import annotations

import math
from collections.abc import Sequence

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_MASK32 = 0xFFFFFFFF
# the smallest normal f32, the low end of ``uniform``'s range for gumbel
TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counts ``(x0, x1)`` under the key ``(k0, k1)``:
    int32 tensors of uint32 bits that broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + (i + 1)
    return x0, x1


def _u32(value: int) -> int:
    """``value`` mod 2^32 as the int32 that holds the same bits."""
    value &= _MASK32
    return value - (1 << 32) if value >= 1 << 31 else value


def prng_key(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: an int32 [2] key."""
    return torch.tensor([0, _u32(int(seed))], dtype=torch.int32,
                        device=device)


def fold_in(keys: torch.Tensor, data: torch.Tensor | int) -> torch.Tensor:
    """``jax.random.fold_in`` of each key ``[..., 2]`` with its ``data``
    (an int32 that broadcasts to ``keys.shape[:-1]``, or a Python int)."""
    if not isinstance(data, torch.Tensor):
        data = torch.full((), _u32(data), dtype=torch.int32,
                          device=keys.device)
    data = data.to(torch.int32)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def _counts(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """The lo words of the 64-bit iota over ``shape``; the hi words are 0
    below 2^32 elements, which ``random_bits`` requires."""
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError(f"random bits over {n} >= 2^32 elements")
    # an arange of int64 cast to int32: arange of int32 cannot go past 2^31
    return torch.arange(n, device=keys.device).to(torch.int32).view(
        (1,) * (keys.ndim - 1) + tuple(shape))


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits (int32) of shape ``key.shape[:-1] + shape``: each
    key ``[..., 2]`` draws over ``shape`` as ``jax.random.bits`` does."""
    counts = _counts(key, shape)
    lead = key.shape[:-1] + (1,) * len(shape)
    k0, k1 = key[..., 0].view(lead), key[..., 1].view(lead)
    bits1, bits2 = threefry2x32(k0, k1, torch.zeros_like(counts), counts)
    return bits1 ^ bits2


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval=TINY)``, as its
    Gumbel draws it: the top 23 bits as the mantissa of a float in
    [1, 2), minus 1, scaled to ``[TINY, 1)`` (the scale ``1 - TINY``
    rounds to 1 in f32) and clipped below at ``TINY``."""
    bits = random_bits(key, shape)
    mantissa = ((bits >> 9) & 0x7FFFFF) | 0x3F800000
    floats = mantissa.view(torch.float32) - 1.0
    span = float(np.float32(1.0) - np.float32(TINY))
    return torch.clamp_min(floats * span + TINY, TINY)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in its "low" mode."""
    return -torch.log(-torch.log(uniform(key, shape)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of f32 ``logits``:
    ``argmax(gumbel + logits)``, the first index on ties.

    A key [2] draws the Gumbel noise over all of ``logits`` at once (the
    reference's scalar form); keys [B, 2] draw it row by row over ``(V,)``
    (its ``vmap`` form).  For B > 1 the two give different draws."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical takes f32 logits, got {logits.dtype}")
    noise = gumbel(key, logits.shape[key.ndim - 1:])
    return torch.argmax(noise + logits, dim=-1)
