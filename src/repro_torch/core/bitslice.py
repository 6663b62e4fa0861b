"""Bit-slicing: the arithmetic core of analog PUM (paper §2.2.1, Fig. 2).

An N-bit weight is split into slices of ``M`` bits (the bits one analog
cell stores reliably); each slice is a separate array whose partial
products are recombined by shifting each by its slice's bit position and
adding.  Everything here is exact integer arithmetic and serves as the
oracle for the ``bitslice_mvm`` kernel; it matches the JAX package's
``core/bitslice.py`` bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Quantisation
# ---------------------------------------------------------------------------

def quantize_symmetric(x: torch.Tensor, bits: int, axis=None,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric linear quantisation to ``bits`` (one bit for sign).

    Returns (q, scale) with ``q`` int32 in [-(2^(b-1)-1), 2^(b-1)-1] and
    ``x ~= q * scale``.  ``axis``: an int or tuple of reduction axes for
    per-channel scales (kept as size-1 dims); None = per-tensor (a
    0-d scale).  Rounding is half to even, as in ``jnp.round``.
    """
    scale = symmetric_scale(x, bits, axis)
    return quantize_to(x, scale, bits), scale


def symmetric_scale(x: torch.Tensor, bits: int, axis=None) -> torch.Tensor:
    """:func:`quantize_symmetric`'s scale: absmax / (2^(b-1) - 1)."""
    qmax = (1 << (bits - 1)) - 1
    if axis is None:
        absmax = x.abs().amax()
    else:
        absmax = x.abs().amax(dim=axis, keepdim=True)
    return torch.clamp_min(absmax, 1e-12) / qmax


def quantize_to(x: torch.Tensor, scale: torch.Tensor, bits: int
                ) -> torch.Tensor:
    """``x`` at a given ``scale`` (broadcast): int32 in
    [-(2^(b-1)-1), 2^(b-1)-1], rounded half to even, element by element,
    so a slice of ``x`` at the matching slice of ``scale`` gives that
    slice of the whole."""
    qmax = (1 << (bits - 1)) - 1
    return torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int32)


# ---------------------------------------------------------------------------
# Weight slicing (differential encoding: magnitudes are sliced, the sign
# lives in which array of the cell pair holds the value)
# ---------------------------------------------------------------------------

def split_differential(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Signed int -> (positive array, negative array), both >= 0."""
    return torch.clamp_min(q, 0), torch.clamp_min(-q, 0)


def slice_planes_unsigned(w: torch.Tensor, total_bits: int,
                          bits_per_slice: int) -> torch.Tensor:
    """Unsigned ints -> ``[n_slices, *w.shape]`` int32 planes, slice
    ``s`` holding bits ``[s*M, (s+1)*M)`` (slice 0 least significant)."""
    n_slices = -(-total_bits // bits_per_slice)
    mask = (1 << bits_per_slice) - 1
    planes = [(w >> (s * bits_per_slice)) & mask for s in range(n_slices)]
    return torch.stack(planes).to(torch.int32)


def slice_planes_signed(q: torch.Tensor, weight_bits: int,
                        bits_per_slice: int) -> torch.Tensor:
    """Signed int -> net differential planes ``pos_plane - neg_plane``,
    values in [-(2^M - 1), 2^M - 1] (int8 for M <= 7): the layout the
    kernel consumes."""
    pos, neg = split_differential(q.to(torch.int32))
    mag_bits = weight_bits - 1             # sign carried by the pair
    p = slice_planes_unsigned(pos, mag_bits, bits_per_slice)
    n = slice_planes_unsigned(neg, mag_bits, bits_per_slice)
    return (p - n).to(torch.int32)


def combine_planes(partials: torch.Tensor, bits_per_slice: int
                   ) -> torch.Tensor:
    """Shift-and-add recombination over the leading (slice) axis:
    ``sum_s partials[s] << (s * M)`` in int32."""
    n_slices = partials.shape[0]
    shifts = torch.arange(n_slices, dtype=torch.int32,
                          device=partials.device) * bits_per_slice
    weights = (torch.ones_like(shifts) << shifts).reshape(
        (n_slices,) + (1,) * (partials.ndim - 1))
    return torch.sum(partials.to(torch.int32) * weights, dim=0,
                     dtype=torch.int32)


# ---------------------------------------------------------------------------
# Input bit-slicing (one input bit applied per cycle through the DACs)
# ---------------------------------------------------------------------------

def slice_bits_input(x: torch.Tensor, bits: int, signed: bool = True,
                     ) -> tuple[torch.Tensor, np.ndarray]:
    """Int input -> binary planes + per-plane signed weights.

    Returns (planes [bits, *x.shape] in {0,1} int32, weights [bits]
    int64) such that ``x == sum_i weights[i] * planes[i]``.  For signed
    inputs the planes are the two's-complement bits, top weight
    negative."""
    if signed:
        u = torch.where(x < 0, x + (1 << bits), x).to(torch.int32)
    else:
        u = x.to(torch.int32)
    planes = torch.stack([(u >> i) & 1 for i in range(bits)]).to(torch.int32)
    weights = np.array([1 << i for i in range(bits)], dtype=np.int64)
    if signed:
        weights[bits - 1] = -weights[bits - 1]
    return planes, weights


# ---------------------------------------------------------------------------
# Exact integer matmul
# ---------------------------------------------------------------------------

def int_matmul(x_q: torch.Tensor, w_q: torch.Tensor, *, x_bound: int = 127,
               w_bound: int = 127) -> torch.Tensor:
    """Exact ``x_q @ w_q`` -> int32.

    x_q: [..., K]; w_q: [K, N]; values bounded by ``x_bound``/``w_bound``
    in magnitude (both must fit int8).  On the CPU an int64 matmul; on
    the card a float64 one, which is exact because every partial sum is
    an integer below ``K * 127 * 127 < 2^53``.  Never f32 or TF32: the
    sums reach 127 * 127 * 11008 ~ 1.8e8 > 2^24 at Qwen2.5-3B's d_ff.
    """
    if x_bound > 127 or w_bound > 127:
        raise ValueError(f"int_matmul operands must fit int8, got bounds "
                         f"{x_bound}, {w_bound}")
    if x_q.device.type == "cpu":
        acc = torch.matmul(x_q.to(torch.int64), w_q.to(torch.int64))
    else:
        acc = torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64))
    return acc.to(torch.int32)


def bitsliced_matmul_planes(x_q: torch.Tensor, planes: torch.Tensor,
                            bits_per_slice: int) -> torch.Tensor:
    """Per-plane exact matmuls + shift-and-add over planes [S, K, N]."""
    partials = torch.stack([int_matmul(x_q, p) for p in planes])
    return combine_planes(partials, bits_per_slice)


def bitsliced_matmul_exact(x_q: torch.Tensor, w_q: torch.Tensor,
                           weight_bits: int, bits_per_slice: int
                           ) -> torch.Tensor:
    """``x_q @ w_q`` through the bit-plane decomposition (lossless)."""
    planes = slice_planes_signed(w_q, weight_bits, bits_per_slice)
    return bitsliced_matmul_planes(x_q, planes, bits_per_slice)
