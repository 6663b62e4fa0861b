"""PUMLinear — the paper's technique as the port's linear layer.

Every linear layer routes through :func:`pum_linear`, which executes in
one of three modes (``PUMConfig.mode``):

  bf16 — plain dense matmul (``torch.matmul``; inside
         :func:`positionwise`, one position at a time).
  int8 — symmetric int8 x int8 -> int32 matmul: the single-plane
         special case of bit-slicing.
  pum  — bit-sliced execution over differential planes, per-plane
         integer products recombined by shift-and-add; with a prepacked
         weight the per-row dequant scale is fused into the kernel's
         epilogue.  With ``noise.enable`` the ACE simulation
         (``core/analog.py``: ADC and non-idealities) runs instead,
         drawing its noise from the ``generator`` argument (the JAX
         package's ``key``).

``int8``/``pum`` take a prepacked
:class:`~repro_torch.core.prepack.PackedLinear` (serving) or a raw
float weight, quantised on every call as the JAX package's forward
does.  The raw-weight forward returns the value the JAX package's
straight-through forward returns (``yq``) and computes no shadow float
matmul.  Where autograd needs a gradient (QAT: ``x`` or ``w`` requires
one, and ``cfg.inference`` is off), :class:`_ShadowSTE` gives the
straight-through estimator of the reference's ``_ste(_matmul_bf16(x,
w), yq)``: the forward value ``yq``, the backward that of the shadow
product ``x @ w.to(x.dtype)``, computed only in the backward
(``torch.matmul``, as the reference's shadow product runs outside any
kernel).  A packed weight has no gradient.  Tensor parallelism is not
ported.

Kernel dispatch (:mod:`repro_torch.kernels.registry`): on CUDA tensors
the ``cuda`` backend runs the ``bitslice_mvm`` kernels; the ``torch``
backend (every CPU tensor, or an explicit selection) runs the exact
integer matmul against the recombined weight, as the JAX package's XLA
path does.  Both give the same int32 accumulator bit for bit.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.config import PUMConfig
from repro_torch.core import analog, bitslice
from repro_torch.core.prepack import PackedLinear
from repro_torch.kernels import registry
from repro_torch.kernels.bitslice_mvm import ops as mvm_ops
from repro_torch.kernels.registry import KernelBackend


# ---------------------------------------------------------------------------
# Straight-through estimators
# ---------------------------------------------------------------------------

class _STE(torch.autograd.Function):
    """``xq`` forward, the identity to ``x`` backward (the reference's
    ``_ste``)."""

    @staticmethod
    def forward(ctx, x, xq):
        return xq.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant(x: torch.Tensor, bits: int, axis=None) -> torch.Tensor:
    """``x`` quantised to ``bits`` and back, with the straight-through
    gradient."""
    q, s = bitslice.quantize_symmetric(x, bits, axis=axis)
    return _STE.apply(x, (q.to(torch.float32) * s).to(x.dtype))


class _ShadowSTE(torch.autograd.Function):
    """``forward_fn(x, w)`` (the quantised product ``yq``) forward; the
    gradient of the shadow product ``x @ w.to(x.dtype)`` backward: ``dx``
    in x's dtype, ``dw`` cast back to w's (the transpose of the
    reference's ``astype``).  The shadow product itself is never
    formed."""

    @staticmethod
    def forward(ctx, x, w, forward_fn):
        ctx.save_for_backward(x, w)
        return forward_fn(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        wx = w.to(x.dtype)
        g = g.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g, wx.T)
        if ctx.needs_input_grad[1]:
            k, n = wx.shape
            dw = torch.matmul(x.reshape(-1, k).T, g.reshape(-1, n)
                              ).to(w.dtype)
        return dx, dw, None


def _mvm_backend(x: torch.Tensor) -> KernelBackend:
    return registry.resolve_backend(x, kernel=mvm_ops.KERNEL)


def _quantize_act(x: torch.Tensor, bits: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Activation quantisation with a *per-input-row* scale: each input
    vector goes through the DACs with its own full-scale range, so a
    row's numerics never depend on what it is batched with."""
    return bitslice.quantize_symmetric(x.to(torch.float32), bits,
                                       axis=x.ndim - 1)


_POSITIONWISE = contextvars.ContextVar("positionwise", default=False)


@contextlib.contextmanager
def positionwise():
    """Within it, :func:`by_position` runs a [B, S, ...] input one
    position at a time, each the [B, 1, ...] call a one-token step makes.
    A float GEMM's or reduction's summation order may depend on its row
    count (cuBLAS and PyTorch's reduction kernels on the card, MKL on
    the CPU), so a row could round otherwise at B (k + 1) rows than at
    B; the speculative verify step runs in it
    (``serve.engine.make_verify_step``), so that each position's logits
    are the one-token step's bit for bit.  Its float products
    (:func:`float_matmul`) and the norms' statistics
    (``models.layers.rmsnorm``, ``layernorm``) go through
    :func:`by_position`; the integer products (``int8``,
    ``pum``) are exact at any row count and ignore it."""
    token = _POSITIONWISE.set(True)
    try:
        yield
    finally:
        _POSITIONWISE.reset(token)


def by_position(fn, x: torch.Tensor) -> torch.Tensor:
    """fn(x); inside :func:`positionwise`, a [B, S, ...] x position by
    position."""
    if _POSITIONWISE.get() and x.ndim >= 3 and x.shape[1] > 1:
        # each position's rows copied out, laid out as a one-token
        # step's: a kernel may also pick its path by the row stride
        return torch.cat([fn(x[:, j:j + 1].contiguous())
                          for j in range(x.shape[1])], dim=1)
    return fn(x)


def float_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w; inside :func:`positionwise`, position by position."""
    return by_position(lambda t: torch.matmul(t, w), x)


def _matmul_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return float_matmul(x, w.to(x.dtype))


def _matmul_int8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dynamic activation quant + per-column weight quant, int32 sums."""
    xq, xs = _quantize_act(x, 8)
    wq, ws = bitslice.quantize_symmetric(w.to(torch.float32), 8, axis=0)
    if _mvm_backend(x) == KernelBackend.CUDA:
        # the whole quantised weight is one plane (bits_per_slice=8)
        acc = mvm_ops.bitslice_mvm(xq, wq, weight_bits=8, bits_per_slice=8,
                                   backend=KernelBackend.CUDA)
    else:
        acc = bitslice.int_matmul(xq, wq)
    y = acc.to(torch.float32) * (xs * ws)
    return y.to(x.dtype)


def _crossbar(xq: torch.Tensor, wq: torch.Tensor, cfg: PUMConfig,
              weight_bits: int, bits_per_slice: int,
              generator: torch.Generator | None) -> torch.Tensor:
    """The ACE simulation of ``xq @ wq`` over rows of ``xq``."""
    acc = analog.crossbar_mvm(
        xq.reshape(-1, xq.shape[-1]), wq, weight_bits=weight_bits,
        bits_per_slice=bits_per_slice, input_bits=cfg.input_bits,
        adc=cfg.adc, noise=cfg.noise, generator=generator)
    return acc.reshape(xq.shape[:-1] + (wq.shape[-1],))


def _matmul_pum(x: torch.Tensor, w: torch.Tensor, cfg: PUMConfig,
                generator: torch.Generator | None) -> torch.Tensor:
    """Bit-sliced path with a per-tensor weight scale, quantised per
    call: exact (K2 or its plain version) unless noise is enabled, in
    which case the ACE simulation runs."""
    xq, xs = _quantize_act(x, cfg.input_bits)
    wq, ws = bitslice.quantize_symmetric(w.to(torch.float32),
                                         cfg.weight_bits)
    if cfg.noise.enable:
        acc = _crossbar(xq, wq, cfg, cfg.weight_bits, cfg.bits_per_slice,
                        generator)
    elif _mvm_backend(x) == KernelBackend.CUDA:
        acc = mvm_ops.bitslice_mvm(xq, wq, weight_bits=cfg.weight_bits,
                                   bits_per_slice=cfg.bits_per_slice,
                                   backend=KernelBackend.CUDA)
    else:
        acc = bitslice.bitsliced_matmul_exact(xq, wq, cfg.weight_bits,
                                              cfg.bits_per_slice)
    y = acc.to(torch.float32) * (xs * ws)
    return y.to(x.dtype)


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


def _matmul_pum_packed(x: torch.Tensor, w: PackedLinear, cfg: PUMConfig,
                       generator: torch.Generator | None) -> torch.Tensor:
    xq, xs = _quantize_act(x, cfg.input_bits)
    if cfg.noise.enable:
        acc = _crossbar(xq, w.wq.to(torch.int32), cfg, w.weight_bits,
                        w.bits_per_slice, generator)
    elif _mvm_backend(x) == KernelBackend.CUDA:
        # the fused tile: plane recombination + per-row dequant scale in
        # one kernel.  pum's scale is per tensor ([1, 1]), so
        # ``xs * w.scale`` is a pure per-row scale and the fusion is
        # bit-identical to scaling outside (same int32 -> f32 convert,
        # same f32 product)
        y = mvm_ops.bitslice_mvm_planes_scaled(
            xq, w.planes, xs * w.scale, bits_per_slice=w.bits_per_slice,
            backend=KernelBackend.CUDA)
        return y.to(x.dtype)
    else:
        x_bound = (1 << (cfg.input_bits - 1)) - 1
        w_bound = (1 << (w.weight_bits - 1)) - 1
        acc = bitslice.int_matmul(xq, w.wq, x_bound=x_bound,
                                  w_bound=w_bound)
    y = acc.to(torch.float32) * (xs * w.scale)
    return y.to(x.dtype)


def pum_linear(x: torch.Tensor, w: torch.Tensor | PackedLinear,
               cfg: PUMConfig, bias: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """y = x @ w (+ bias) under the configured execution mode.

    x: [..., K]; w: [K, N] float weight, or a per-layer
    :class:`PackedLinear` (int8/pum modes).  ``generator`` draws the
    analog noise of ``pum`` with ``noise.enable`` (on x's device)."""
    packed = isinstance(w, PackedLinear)
    if cfg.mode == "bf16":
        if packed:
            raise ValueError("bf16 mode has no packed representation")
        y = _matmul_bf16(x, w)
    elif cfg.mode in ("int8", "pum"):
        if packed:
            if w.ndim != 2:
                raise ValueError(f"pum_linear expects a per-layer "
                                 f"PackedLinear [K, N], got shape {w.shape}")
            if w.mode != cfg.mode:
                raise ValueError(f"weight packed for {w.mode!r}, config "
                                 f"says {cfg.mode!r}")
            y = _matmul_int8_packed(x, w) if cfg.mode == "int8" \
                else _matmul_pum_packed(x, w, cfg, generator)
        else:
            def quantised(x, w):
                return _matmul_int8(x, w) if cfg.mode == "int8" \
                    else _matmul_pum(x, w, cfg, generator)

            if (not cfg.inference and torch.is_grad_enabled()
                    and (x.requires_grad or w.requires_grad)):
                y = _ShadowSTE.apply(x, w, quantised)
            else:
                y = quantised(x, w)
    else:
        raise ValueError(cfg.mode)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
