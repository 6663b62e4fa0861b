"""Plain PyTorch version of the bitslice_mvm kernel (the oracle).

Op for op the JAX package's ``kernels/bitslice_mvm/ref.py``: one exact
integer matmul per plane, then the shift-and-add recombination."""
from __future__ import annotations

import torch

from repro_torch.core import bitslice


def bitslice_mvm_ref(x: torch.Tensor, w_planes: torch.Tensor, *,
                     bits_per_slice: int) -> torch.Tensor:
    """x: [M, K] int; w_planes: [S, K, N] int -> [M, N] int32."""
    return bitslice.bitsliced_matmul_planes(x, w_planes, bits_per_slice)


def bitslice_mvm_scaled_ref(x: torch.Tensor, w_planes: torch.Tensor,
                            row_scale: torch.Tensor, *,
                            bits_per_slice: int) -> torch.Tensor:
    """The fused tile's function: ``acc.to(f32) * row_scale`` with
    row_scale [M, 1] f32 -> [M, N] f32."""
    acc = bitslice_mvm_ref(x, w_planes, bits_per_slice=bits_per_slice)
    return acc.to(torch.float32) * row_scale.to(torch.float32)
