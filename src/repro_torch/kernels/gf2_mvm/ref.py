"""Plain PyTorch versions of the gf2_mvm kernels (the oracles).

The JAX package's ``kernels/gf2_mvm/ref.py`` is an int32 matmul and a
``& 1``.  CUDA has no integer ``torch.matmul``, so this version takes
the low bit of each operand first and multiplies in float32: the
products are 0 or 1 and every partial sum is an integer at most K, so
the float32 sums are exact for K < 2^24, and their low bit is the low
bit of the integer product's sum for any integer inputs (the parity of
a sum of products is the XOR of the products of the operands' low
bits).  The same code runs on the CPU and on the card.

The state-byte entry's plain version is the composition the AES rounds
of the JAX package compute (``apps/aes_app.py``: unpack, parity MVM,
pack), with its bit layout: byte-major, LSB-first.
"""
from __future__ import annotations

import torch


def gf2_mvm_ref(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``(x @ a) mod 2``: x [..., K], a [K, N] integer -> [..., N] int8
    in {0, 1}."""
    acc = torch.matmul((x & 1).to(torch.float32), (a & 1).to(torch.float32))
    return (acc.to(torch.int32) & 1).to(torch.int8)


def unpack_bits(b: torch.Tensor) -> torch.Tensor:
    """[..., B] uint8 -> [..., 8B] int8 bits (byte-major, LSB-first)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=b.device)
    bits = (b[..., None] >> shifts) & 1
    return bits.reshape(tuple(b.shape[:-1]) + (8 * b.shape[-1],)).to(
        torch.int8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 8B] {0,1} -> [..., B] uint8, the inverse of ``unpack_bits``."""
    bits = bits.reshape(tuple(bits.shape[:-1]) + (-1, 8)).to(torch.uint8)
    weights = torch.ones(8, dtype=torch.uint8, device=bits.device) \
        << torch.arange(8, dtype=torch.uint8, device=bits.device)
    # torch.sum promotes uint8 to int64; the sum is at most 255
    return torch.sum(bits * weights, dim=-1).to(torch.uint8)


def gf2_mvm_packed_ref(s: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``pack(unpack(s) @ a mod 2)``: s [..., B] uint8, a [8B, N]
    integer with N a multiple of 8 -> [..., N / 8] uint8."""
    return pack_bits(gf2_mvm_ref(unpack_bits(s), a))
