"""Analog Compute Element (ACE) functional simulation.

Models the analog crossbar MVM path of DARTH-PUM (paper §2.2.1, §4):
  * differential cell pairs (signed weights as G+ / G- arrays),
  * per-array MVM over 64-row segments (arrays are 64x64, so a K-dim
    reduction spans ceil(K/64) arrays whose outputs are summed
    digitally),
  * CrossSim-style non-idealities: programming noise (relative
    conductance error), read noise, and an IR-drop proxy (measured
    current droops quadratically with total bitline current),
  * ADC quantisation (SAR / ramp; ramp supports early termination),
  * the paper's parasitic compensation scheme (§4.3): {0,1} -> {-1/2,+1/2}
    remap via differential pairs + a post-MVM compensation factor
    applied in the DCE.

The JAX package's ``core/analog.py`` op for op.  Noise is drawn from an
explicit ``torch.Generator`` (on the inputs' device); JAX draws from
threefry keys, which torch does not reproduce, so the two agree bit for
bit only where the result is deterministic: noise disabled, or IR drop
alone.  Exact when noise is disabled.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ADCConfig, NoiseConfig
from repro_torch.core import bitslice

ARRAY_ROWS = 64     # paper Table 2: ReRAM array size 64x64


# ---------------------------------------------------------------------------
# ADC models
# ---------------------------------------------------------------------------

def adc_quantize(v: torch.Tensor, adc: ADCConfig, full_scale: float,
                 ) -> torch.Tensor:
    """Quantise bitline value ``v`` to the ADC grid.

    The grid has 2^bits levels over [0, full_scale]; with binary inputs
    and integer conductances the ideal bitline value is an integer
    count, so an LSB of 1 (full_scale = 2^bits - 1 >= max count)
    digitises exactly.  Ramp ADCs with ``early_levels`` only resolve the
    bottom levels (the value is read modulo that range, sufficient
    ahead of an XOR: paper §5.3, AES MixColumns).  Rounding is half to
    even, as in ``jnp.round``.
    """
    levels = (1 << adc.bits) - 1
    lsb = max(1.0, float(np.ceil(full_scale / levels)))
    code = torch.clamp(torch.round(v / lsb), 0, levels)
    if adc.kind == "ramp" and adc.early_levels > 0:
        code = torch.remainder(code, adc.early_levels)
    return code * lsb


# ---------------------------------------------------------------------------
# Noise injection
# ---------------------------------------------------------------------------

def _normal(shape, generator: torch.Generator | None,
            device: torch.device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, device=device)


def _program_noise(planes: torch.Tensor, sigma: float,
                   generator: torch.Generator | None) -> torch.Tensor:
    """Relative conductance error at programming time (per device)."""
    if sigma <= 0.0:
        return planes.to(torch.float32)
    noise = 1.0 + sigma * _normal(planes.shape, generator, planes.device)
    return planes.to(torch.float32) * noise


def _ir_drop(i_line: torch.Tensor, alpha: float) -> torch.Tensor:
    """IR-drop proxy: droop grows with total line current (paper §4.3 /
    Xiao+ parasitics): I_meas = I - alpha * I^2."""
    if alpha <= 0.0:
        return i_line
    return i_line - alpha * i_line * i_line


# ---------------------------------------------------------------------------
# Crossbar MVM with the full analog pipeline
# ---------------------------------------------------------------------------

def crossbar_mvm(x_q: torch.Tensor, w_q: torch.Tensor, *, weight_bits: int,
                 bits_per_slice: int, input_bits: int,
                 adc: ADCConfig, noise: NoiseConfig,
                 generator: torch.Generator | None = None,
                 signed_inputs: bool = True) -> torch.Tensor:
    """Full ACE simulation of ``y = x_q @ w_q`` (integer operands).

    x_q: [..., K] int; w_q: [K, N] int (signed).  Returns int32;
    exactly ``x_q @ w_q`` when noise is disabled and the ADC is wide
    enough.

    Pipeline (paper Fig. 9): input bit-planes applied one per cycle to
    the wordlines; each 64-row array segment produces a partial-product
    vector per (input bit, weight slice, segment); the ADC digitises
    each; the shift units + DCE recombine (shift-and-add over input bits
    and slices, plain adds over segments).  One small product per
    (input bit, slice, segment, rail), as in the JAX package.
    """
    K, N = w_q.shape
    pos, neg = bitslice.split_differential(w_q)
    mag_bits = weight_bits - 1
    pos_planes = bitslice.slice_planes_unsigned(pos, mag_bits, bits_per_slice)
    neg_planes = bitslice.slice_planes_unsigned(neg, mag_bits, bits_per_slice)
    n_slices = pos_planes.shape[0]

    prog_sigma = noise.prog_sigma if noise.enable else 0.0
    pos_g = _program_noise(pos_planes, prog_sigma, generator)
    neg_g = _program_noise(neg_planes, prog_sigma, generator)

    x_planes, x_weights = bitslice.slice_bits_input(x_q, input_bits,
                                                    signed=signed_inputs)
    n_bits = x_planes.shape[0]

    # segment the K dimension into 64-row arrays
    n_seg = -(-K // ARRAY_ROWS)
    pad = n_seg * ARRAY_ROWS - K
    if pad:
        pos_g = torch.nn.functional.pad(pos_g, (0, 0, 0, pad))
        neg_g = torch.nn.functional.pad(neg_g, (0, 0, 0, pad))
        x_planes = torch.nn.functional.pad(x_planes, (0, pad))
    pos_g = pos_g.reshape(n_slices, n_seg, ARRAY_ROWS, N)
    neg_g = neg_g.reshape(n_slices, n_seg, ARRAY_ROWS, N)
    xp = x_planes.reshape(tuple(x_planes.shape[:-1]) + (n_seg, ARRAY_ROWS))
    xp = torch.movedim(xp, -2, 1)                # [n_bits, n_seg, ..., 64]
    xpf = xp.to(torch.float32)

    # per-bitline full scale: binary inputs x (2^M - 1) conductance x 64 rows
    cell_max = (1 << bits_per_slice) - 1
    full_scale = float(ARRAY_ROWS * cell_max)
    read_sigma = noise.read_sigma if noise.enable else 0.0
    ir_alpha = noise.ir_alpha if noise.enable else 0.0

    def line(xb, g):
        """One (input-bit, segment) MVM against one differential rail."""
        i_line = torch.matmul(xb, g)
        i_line = _ir_drop(i_line, ir_alpha)
        if read_sigma > 0.0:
            i_line = i_line + read_sigma * _normal(i_line.shape, generator,
                                                   i_line.device)
        return adc_quantize(i_line, adc, full_scale)

    # accumulate over input bits, slices, segments with the shift weights
    out = torch.zeros(tuple(x_q.shape[:-1]) + (N,), dtype=torch.float32,
                      device=x_q.device)
    for b in range(n_bits):
        for s in range(n_slices):
            for seg in range(n_seg):
                p = line(xpf[b, seg], pos_g[s, seg])
                n_ = line(xpf[b, seg], neg_g[s, seg])
                w = float(x_weights[b]) * float(1 << (s * bits_per_slice))
                out = out + w * (p - n_)
    return torch.round(out).to(torch.int32)


# ---------------------------------------------------------------------------
# Parasitic compensation scheme (paper §4.3)
# ---------------------------------------------------------------------------

def compensated_binary_mvm(x_bits: torch.Tensor, w_bits: torch.Tensor, *,
                           noise: NoiseConfig, adc: ADCConfig,
                           generator: torch.Generator | None = None,
                           ) -> torch.Tensor:
    """MVM of a strictly-positive binary matrix with the remapping scheme.

    The naive mapping stores w in {0,1} on the positive rail only: a
    large positive-rail current, hence IR droop.  The paper remaps cell
    values {0,1} -> {-1/2,+1/2} using the differential pair:
        w' = w - 1/2   =>   x @ w' = x @ w - (1/2) * sum(x)
    so the true result is recovered by adding the *compensation factor*
    (1/2) * popcount(x) in the DCE after the ADC.  Halving the per-rail
    current keeps the IR-drop error under one ADC LSB.

    Returns int32 ``x_bits @ w_bits`` (exact under the modelled droop at
    the paper's operating point).  The float32 products of {0,1}
    operands are exact integers whatever the summation order.
    """
    K = w_bits.shape[0]
    wf = w_bits.to(torch.float32)
    xf = x_bits.to(torch.float32)
    ir_alpha = noise.ir_alpha if noise.enable else 0.0
    read_sigma = noise.read_sigma if noise.enable else 0.0

    # remapped rails: G+ holds w'>0 cells at 1/2 G_unit, G- holds w'<0
    # cells at 1/2 G_unit.  Physical line current = 0.5 * active-cell
    # count; the ADC LSB aligns with the half-unit cell conductance, so
    # 2*I_meas is digitised on an integer grid and the code halved.
    i_pos = _ir_drop(0.5 * (xf @ wf), ir_alpha)
    i_neg = _ir_drop(0.5 * (xf @ (1.0 - wf)), ir_alpha)
    if read_sigma > 0.0:
        i_pos = i_pos + read_sigma * _normal(i_pos.shape, generator,
                                             i_pos.device)
        i_neg = i_neg + read_sigma * _normal(i_neg.shape, generator,
                                             i_neg.device)
    full_scale = float(K)
    v = 0.5 * (adc_quantize(2.0 * i_pos, adc, full_scale)
               - adc_quantize(2.0 * i_neg, adc, full_scale))
    comp = 0.5 * torch.sum(xf, dim=-1, keepdim=True)     # DCE-applied factor
    return torch.round(v + comp).to(torch.int32)


def naive_binary_mvm(x_bits: torch.Tensor, w_bits: torch.Tensor, *,
                     noise: NoiseConfig, adc: ADCConfig,
                     generator: torch.Generator | None = None,
                     ) -> torch.Tensor:
    """The uncompensated mapping (w on the positive rail in {0,1}): the
    baseline that shows the compensation scheme's benefit."""
    K = w_bits.shape[0]
    xf = x_bits.to(torch.float32)
    ir_alpha = noise.ir_alpha if noise.enable else 0.0
    read_sigma = noise.read_sigma if noise.enable else 0.0
    i_pos = _ir_drop(xf @ w_bits.to(torch.float32), ir_alpha)
    if read_sigma > 0.0:
        i_pos = i_pos + read_sigma * _normal(i_pos.shape, generator,
                                             i_pos.device)
    return torch.round(adc_quantize(i_pos, adc, float(K))).to(torch.int32)
