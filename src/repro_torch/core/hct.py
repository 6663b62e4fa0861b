"""Hybrid Compute Tile (HCT) / vACore allocation (paper §4, §4.4).

The paper's resource model and library surface, as in the JAX package's
``core/hct.py``:
  * an HCT = 1 ACE (64 analog 64x64 arrays) + 1 DCE (64 pipelines x 64
    arrays of 64x64) + shift/transpose/arbiter/IIU hardware;
  * a **vACore** logically fuses ``n_slices x 2`` analog arrays (slices x
    differential rails) so one logical matrix tile supports arbitrary
    operand widths: only the shift constants programmed into the shift
    units / IIU change (§4.2 "Expanding to Large-Width Operands");
  * the application-agnostic library calls of Table 1 (allocVACore,
    setMatrix, execMVM, updateRow/Col, disable{Analog,Digital}Mode),
    bound to the port's functional simulator (``analog.crossbar_mvm``)
    and the cost model.

A device's matrices live on ``device`` (the card unless the caller asks
for the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.config import ADCConfig, NoiseConfig
from repro_torch.core import analog, bitslice, isa
from repro_torch.device import resolve_device

ARRAY_DIM = 64
ACE_ARRAYS_PER_HCT = 64
DCE_PIPELINES_PER_HCT = 64
DCE_ARRAYS_PER_PIPELINE = 64


@dataclass
class VACore:
    """A virtual analog core: the arrays backing one logical matrix tile."""
    hct: int
    arrays: int                 # physical arrays fused (slices x 2 rails)
    weight_bits: int
    bits_per_slice: int

    @property
    def n_slices(self) -> int:
        return max(1, -(-(self.weight_bits - 1) // self.bits_per_slice))


@dataclass
class MatrixHandle:
    """Result of setMatrix(): where a logical matrix lives."""
    shape: tuple[int, int]
    tiles_k: int
    tiles_n: int
    vacores: list[VACore]
    hcts: list[int]
    w_q: torch.Tensor           # quantised int weights (functional sim)
    scale: torch.Tensor
    analog_mode: bool = True


def _f32(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


@dataclass
class DarthPUMDevice:
    """A DARTH-PUM chip: a pool of HCTs + the library calls of Table 1."""
    n_hcts: int = 1860                       # iso-area, SAR (paper §6)
    adc: ADCConfig = field(default_factory=ADCConfig)
    noise: NoiseConfig = field(default_factory=NoiseConfig)
    device: str | torch.device = "cuda"
    _free_arrays: dict[int, int] = field(default_factory=dict)
    _matrices: list[MatrixHandle] = field(default_factory=list)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if not self._free_arrays:
            self._free_arrays = {h: ACE_ARRAYS_PER_HCT
                                 for h in range(self.n_hcts)}

    # -- Table 1: application-agnostic calls --------------------------------

    def allocVACore(self, element_size: int, bits_per_cell: int,
                    ) -> VACore:
        """Allocate one vACore (element_size-bit operands at bits_per_cell
        per device) on the first HCT with room; configures shift units +
        IIU (represented by the vACore's derived shift constants)."""
        n_slices = max(1, -(-(element_size - 1) // bits_per_cell))
        need = n_slices * 2                       # differential rails
        for h, free in self._free_arrays.items():
            if free >= need:
                self._free_arrays[h] -= need
                return VACore(h, need, element_size, bits_per_cell)
        raise RuntimeError("out of analog arrays")

    def setMatrix(self, w, element_size: int = 8,
                  precision: int = 1) -> MatrixHandle:
        """Store a matrix, allocating HCTs tile-by-tile.

        ``precision`` maps to bits per cell per the paper's 0-2 scale:
        0 -> 1 b/cell, 1 -> half the max, 2 -> max (4 b max per MILO-style
        devices here).
        """
        bits_per_cell = {0: 1, 1: 2, 2: 4}[precision]
        K, N = w.shape
        tiles_k = -(-K // ARRAY_DIM)
        tiles_n = -(-N // ARRAY_DIM)
        w_q, scale = bitslice.quantize_symmetric(_f32(w, self.device),
                                                 element_size)
        cores = [self.allocVACore(element_size, bits_per_cell)
                 for _ in range(tiles_k * tiles_n)]
        handle = MatrixHandle((K, N), tiles_k, tiles_n, cores,
                              sorted({c.hct for c in cores}), w_q, scale)
        self._matrices.append(handle)
        return handle

    def execMVM(self, handle: MatrixHandle, x, *, input_bits: int = 8,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Execute MVM against a stored matrix through the ACE simulation
        (or the DCE integer path if analog mode is disabled)."""
        bpc = handle.vacores[0].bits_per_slice
        wb = handle.vacores[0].weight_bits
        x_q, xs = bitslice.quantize_symmetric(_f32(x, self.device),
                                              input_bits)
        if handle.analog_mode:
            acc = analog.crossbar_mvm(
                x_q, handle.w_q, weight_bits=wb, bits_per_slice=bpc,
                input_bits=input_bits, adc=self.adc, noise=self.noise,
                generator=generator)
        else:
            # exact integer product: int64 on the CPU, float64 on the
            # card (no integer matmul there; exact below 2^53)
            dt = torch.int64 if x_q.device.type == "cpu" else torch.float64
            acc = torch.matmul(x_q.to(dt), handle.w_q.to(dt)).to(torch.int32)
        return acc.to(torch.float32) * (xs * handle.scale)

    def updateRow(self, handle: MatrixHandle, row: int, values):
        """Reprogram one row (in place on the handle's weights)."""
        q, _ = bitslice.quantize_symmetric(
            _f32(values, self.device) / handle.scale * handle.scale,
            handle.vacores[0].weight_bits)
        handle.w_q[row, :] = q

    def updateCol(self, handle: MatrixHandle, col: int, values):
        """Reprogram one column (in place on the handle's weights)."""
        q, _ = bitslice.quantize_symmetric(_f32(values, self.device),
                                           handle.vacores[0].weight_bits)
        handle.w_q[:, col] = q

    def disableAnalogMode(self, handle: MatrixHandle):
        """Copy matrix from analog to digital arrays; MVMs become exact
        integer DCE computations (paper §7.5 high-accuracy migration)."""
        handle.analog_mode = False

    def disableDigitalMode(self, handle: MatrixHandle):
        handle.analog_mode = True

    # -- capacity / cost helpers --------------------------------------------

    def mvm_cycles(self, handle: MatrixHandle, input_bits: int = 8,
                   optimized: bool = True) -> int:
        """Cycles for one MVM against this matrix: tiles along K are
        sequential per output group (their partial sums reduce in the DCE),
        tiles along N run on parallel vACores/HCTs."""
        core = handle.vacores[0]
        t = isa.schedule_mvm(input_bits, core.n_slices,
                             adc_kind=self.adc.kind, optimized=optimized,
                             early_levels=self.adc.early_levels)
        return t.total * handle.tiles_k

    def free_hcts(self) -> int:
        return sum(1 for v in self._free_arrays.values()
                   if v == ACE_ARRAYS_PER_HCT)


def hcts_for_matrix(K: int, N: int, weight_bits: int,
                    bits_per_cell: int) -> int:
    """Static planning: HCTs needed to hold a KxN matrix (ceil arrays/64)."""
    n_slices = max(1, -(-(weight_bits - 1) // bits_per_cell))
    arrays = -(-K // ARRAY_DIM) * -(-N // ARRAY_DIM) * n_slices * 2
    return -(-arrays // ACE_ARRAYS_PER_HCT)
