"""Plain PyTorch version of the gf2_mvm kernel (the oracle).

The JAX package's ``kernels/gf2_mvm/ref.py`` is an int32 matmul and a
``& 1``.  CUDA has no integer ``torch.matmul``, so this version takes
the low bit of each operand first and multiplies in float32: the
products are 0 or 1 and every partial sum is an integer at most K, so
the float32 sums are exact for K < 2^24, and their low bit is the low
bit of the integer product's sum for any integer inputs (the parity of
a sum of products is the XOR of the products of the operands' low
bits).  The same code runs on the CPU and on the card.
"""
from __future__ import annotations

import torch


def gf2_mvm_ref(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``(x @ a) mod 2``: x [..., K], a [K, N] integer -> [..., N] int8
    in {0, 1}."""
    acc = torch.matmul((x & 1).to(torch.float32), (a & 1).to(torch.float32))
    return (acc.to(torch.int32) & 1).to(torch.int8)
