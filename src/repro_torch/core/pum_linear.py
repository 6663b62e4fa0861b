"""PUMLinear — the paper's technique as the port's linear layer.

Every linear layer routes through :func:`pum_linear`, which executes in
one of three modes (``PUMConfig.mode``):

  bf16 — plain dense matmul (``torch.matmul``).
  int8 — symmetric int8 x int8 -> int32 matmul against a prepacked
         weight: the single-plane special case of bit-slicing.
  pum  — bit-sliced execution against prepacked differential planes,
         per-plane integer products recombined by shift-and-add, with
         the per-row dequant scale fused into the kernel's epilogue.

Serving only: ``int8``/``pum`` take a prepacked
:class:`~repro_torch.core.prepack.PackedLinear`.  The raw-weight QAT
paths, the analog noise simulation (``core/analog.py`` in the JAX
package) and tensor parallelism are not ported yet and raise
``NotImplementedError``.

Kernel dispatch (:mod:`repro_torch.kernels.registry`): on CUDA tensors
the ``cuda`` backend runs the ``bitslice_mvm`` kernels; the ``torch``
backend (every CPU tensor, or an explicit selection) runs the exact
integer matmul against the recombined weight, as the JAX package's XLA
path does.  Both give the same int32 accumulator bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.config import PUMConfig
from repro_torch.core import bitslice
from repro_torch.core.prepack import PackedLinear
from repro_torch.kernels import registry
from repro_torch.kernels.bitslice_mvm import ops as mvm_ops
from repro_torch.kernels.registry import KernelBackend


def _mvm_backend(x: torch.Tensor) -> KernelBackend:
    return registry.resolve_backend(x, kernel=mvm_ops.KERNEL)


def _quantize_act(x: torch.Tensor, bits: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Activation quantisation with a *per-input-row* scale: each input
    vector goes through the DACs with its own full-scale range, so a
    row's numerics never depend on what it is batched with."""
    return bitslice.quantize_symmetric(x.to(torch.float32), bits,
                                       axis=x.ndim - 1)


def _matmul_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w.to(x.dtype))


def _matmul_int8_packed(x: torch.Tensor, w: PackedLinear) -> torch.Tensor:
    xq, xs = _quantize_act(x, 8)
    if _mvm_backend(x) == KernelBackend.CUDA:
        # one plane with bits_per_slice=8; the per-out-channel scale
        # ([1, N]) cannot ride the per-row epilogue, so it stays outside
        acc = mvm_ops.bitslice_mvm_planes(xq, w.wq[None], bits_per_slice=8,
                                          backend=KernelBackend.CUDA)
    else:
        acc = bitslice.int_matmul(xq, w.wq)
    y = acc.to(torch.float32) * (xs * w.scale)
    return y.to(x.dtype)


def _matmul_pum_packed(x: torch.Tensor, w: PackedLinear,
                       cfg: PUMConfig) -> torch.Tensor:
    xq, xs = _quantize_act(x, cfg.input_bits)
    if _mvm_backend(x) == KernelBackend.CUDA:
        # the fused tile: plane recombination + per-row dequant scale in
        # one kernel.  pum's scale is per tensor ([1, 1]), so
        # ``xs * w.scale`` is a pure per-row scale and the fusion is
        # bit-identical to scaling outside (same int32 -> f32 convert,
        # same f32 product)
        y = mvm_ops.bitslice_mvm_planes_scaled(
            xq, w.planes, xs * w.scale, bits_per_slice=w.bits_per_slice,
            backend=KernelBackend.CUDA)
        return y.to(x.dtype)
    x_bound = (1 << (cfg.input_bits - 1)) - 1
    w_bound = (1 << (w.weight_bits - 1)) - 1
    acc = bitslice.int_matmul(xq, w.wq, x_bound=x_bound, w_bound=w_bound)
    y = acc.to(torch.float32) * (xs * w.scale)
    return y.to(x.dtype)


def pum_linear(x: torch.Tensor, w: torch.Tensor | PackedLinear,
               cfg: PUMConfig, bias: torch.Tensor | None = None,
               ) -> torch.Tensor:
    """y = x @ w (+ bias) under the configured execution mode.

    x: [..., K]; w: [K, N] float weight (bf16 mode) or a per-layer
    :class:`PackedLinear` (int8/pum modes)."""
    packed = isinstance(w, PackedLinear)
    if cfg.noise.enable:
        raise NotImplementedError(
            "the analog noise simulation is not ported yet")
    if cfg.mode == "bf16":
        if packed:
            raise ValueError("bf16 mode has no packed representation")
        y = _matmul_bf16(x, w)
    elif cfg.mode in ("int8", "pum"):
        if not packed:
            raise NotImplementedError(
                f"{cfg.mode} with a raw float weight is the QAT path, not "
                f"ported yet; prepack the weights for serving")
        if w.ndim != 2:
            raise ValueError(f"pum_linear expects a per-layer PackedLinear "
                             f"[K, N], got shape {w.shape}")
        if w.mode != cfg.mode:
            raise ValueError(f"weight packed for {w.mode!r}, config says "
                             f"{cfg.mode!r}")
        y = _matmul_int8_packed(x, w) if cfg.mode == "int8" \
            else _matmul_pum_packed(x, w, cfg)
    else:
        raise ValueError(cfg.mode)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
