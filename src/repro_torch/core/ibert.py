"""I-BERT integer-only kernels (Kim et al., ICML'21) — the DCE's auxiliary
functions for the LLM-encoder workload (paper §5.2: "DARTH-PUM relies on
its DCE to realize the non-MVM operations using I-BERT algorithms").

All functions operate on *quantised tensors* ``(q, s)``: integer codes ``q``
(int32) and a float scale ``s`` with real value ``q * s``.  Only integer
ops appear on the q-path (adds, muls, shifts, comparisons, floor
division), with int32 wraparound; the scale arithmetic is f32.  Bit for
bit the JAX package's ``core/ibert.py``, which needs three things spelt
out here:

  * a float becomes int32 through :func:`to_int32`, which saturates as
    XLA's conversion does (NaN -> 0, past the range -> its end);
    ``.to(torch.int32)`` does not (it gives INT_MIN for all of them on
    the CPU), and the scales make out-of-range values of real inputs:
    an all-zero tensor has ``s = 1e-12 / 127``;
  * sums of int32 codes stay int32 (``torch.sum`` would give int64),
    wrapping mod 2^32 as the reference's do;
  * constants enter as f32 tensors and divisions are tensor / tensor
    (``python_float / tensor`` is ``reciprocal() * float`` in PyTorch,
    rounded otherwise);
  * XLA on the CPU flushes f32 subnormals to zero: the scales are
    flushed the same way (:func:`_flush`), where a scale near the
    quantiser's floor (an input's absmax below ~7e-11) makes i_gelu's
    output scale subnormal.

Every op is a plain PyTorch op on the input's device, with no host
synchronisation, so a CUDA graph captures them.

Implemented: i_poly, i_erf, i_gelu, i_exp, i_softmax, i_sqrt, i_layernorm.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

INT32_MAX = (1 << 31) - 1


class QTensor(NamedTuple):
    q: torch.Tensor       # int32 codes
    s: torch.Tensor       # scalar (or broadcastable) float32 scale

    @property
    def real(self) -> torch.Tensor:
        return self.q.to(torch.float32) * self.s


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d f32 tensor on ``like``'s device (a fill, not a
    host-to-device copy)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _flush(x: torch.Tensor) -> torch.Tensor:
    """``x`` with f32 subnormals flushed to zero of their sign."""
    return torch.where(torch.abs(x) < torch.finfo(torch.float32).tiny,
                       x * 0, x)


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """Float -> int32, truncating toward zero and saturating as XLA's
    conversion does: NaN -> 0, x >= 2^31 -> INT32_MAX, x < -2^31 ->
    INT32_MIN."""
    big = x >= 2.0 ** 31
    inside = torch.clamp(x, min=-2.0 ** 31)       # -inf -> -2^31, exact
    inside = torch.where(torch.isnan(x) | big, torch.zeros_like(x), inside)
    q = inside.to(torch.int32)
    return torch.where(big, torch.full_like(q, INT32_MAX), q)


def _isum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The int32 sum over ``dim`` (kept), wrapping mod 2^32."""
    return torch.sum(x, dim=dim, keepdim=True, dtype=torch.int32)


def quantize(x: torch.Tensor, bits: int = 8, axis=None) -> QTensor:
    qmax = (1 << (bits - 1)) - 1
    if axis is None:
        absmax = torch.amax(torch.abs(x))
    else:
        absmax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    s = torch.clamp_min(absmax, 1e-12) / torch.full(
        (), qmax, dtype=absmax.dtype, device=x.device)
    q = to_int32(torch.clamp(torch.round(x / s), -qmax, qmax))
    return QTensor(q, s.to(torch.float32))


# ---------------------------------------------------------------------------
# i-Poly: integer 2nd-order polynomial  a(q*s + b)^2 + c
# ---------------------------------------------------------------------------

def i_poly(q: torch.Tensor, s: torch.Tensor, a: float, b: float, c: float,
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Evaluate a(x+b)^2 + c on integer codes: all arithmetic on int32."""
    sout = _f32(a, s) * s * s
    qb = to_int32(torch.floor(_f32(b, s) / s))
    qc = to_int32(torch.floor(_f32(c, s) / sout))
    qout = (q + qb) * (q + qb) + qc
    return qout, sout


# ---------------------------------------------------------------------------
# i-erf / i-GELU  (I-BERT §3.4)
# ---------------------------------------------------------------------------

_ERF_A, _ERF_B, _ERF_C = -0.2888, -1.769, 1.0


def i_erf(q: torch.Tensor, s: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    sgn = torch.sign(q)
    qa = torch.minimum(torch.abs(q),
                       to_int32(torch.floor(_f32(-_ERF_B, s) / s)))
    ql, sl = i_poly(qa, s, _ERF_A, _ERF_B, _ERF_C)
    return sgn * ql, sl


def i_gelu(q: torch.Tensor, s: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """GELU(x) = x * 0.5 * (1 + erf(x / sqrt(2))) with integer erf."""
    qe, se = i_erf(q, s / torch.sqrt(_f32(2.0, s)))
    one = to_int32(torch.floor(_f32(1.0, s) / se))
    qout = q * (qe + one)
    sout = _flush(_flush(s * se) / _f32(2.0, s))
    return qout, sout


def gelu_quantized(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Float in, float out convenience wrapper (quantise -> i_gelu)."""
    t = quantize(x, bits)
    qo, so = i_gelu(t.q, t.s)
    return (qo.to(torch.float32) * so).to(x.dtype)


# ---------------------------------------------------------------------------
# i-exp / i-softmax  (I-BERT §3.3)
# ---------------------------------------------------------------------------

_EXP_A, _EXP_B, _EXP_C = 0.3585, 1.353, 0.344
_LN2 = 0.6931471805599453


def i_exp(q: torch.Tensor, s: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """exp(x) for x <= 0 via range reduction x = -z ln2 + p, p in (-ln2, 0]."""
    q_ln2 = torch.clamp_min(to_int32(torch.floor(_f32(_LN2, s) / s)), 1)
    z = torch.floor_divide(-q, q_ln2)               # x<=0 -> z>=0
    qp = q + z * q_ln2                              # p codes, in (-ln2, 0]
    ql, sl = i_poly(qp, s, _EXP_A, _EXP_B, _EXP_C)
    # exp(x) = 2^-z * poly(p); shift right by z (integer)
    qout = torch.bitwise_right_shift(torch.clamp_min(ql, 0),
                                     torch.clamp(z, 0, 30))
    return qout, sl


def i_softmax(q: torch.Tensor, s: torch.Tensor, axis: int = -1,
              out_bits: int = 15) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer softmax: subtract max, i_exp, integer-divide by the sum."""
    qm = torch.amax(q, dim=axis, keepdim=True)
    qe, _ = i_exp(q - qm, s)
    tot = _isum(qe, axis)
    # out = qe / tot, expressed with an integer reciprocal at out_bits
    factor = torch.floor_divide(torch.full_like(tot, 1 << out_bits),
                                torch.clamp_min(tot, 1))
    return qe * factor, _f32(1.0 / (1 << out_bits), s)


def softmax_quantized(x: torch.Tensor, bits: int = 8, axis: int = -1
                      ) -> torch.Tensor:
    t = quantize(x, bits, axis=None)
    qo, so = i_softmax(t.q, t.s, axis=axis)
    return (qo.to(torch.float32) * so).to(x.dtype)


# ---------------------------------------------------------------------------
# i-sqrt  (integer Newton iteration, I-BERT §3.5) and i-layernorm
# ---------------------------------------------------------------------------

def bit_length(n: torch.Tensor) -> torch.Tensor:
    """The bit length of each int32 ``n >= 1`` (``32 - clz(n)``), by a
    binary search over shifts: exact for every int32."""
    bits = torch.ones_like(n)
    for sh in (16, 8, 4, 2, 1):
        hi = torch.bitwise_right_shift(n, sh)
        up = hi > 0
        bits = torch.where(up, bits + sh, bits)
        n = torch.where(up, hi, n)
    return bits


def i_sqrt(n: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """floor(sqrt(n)) for non-negative int32 via Newton's method; the
    ``iters`` steps are a fixed loop (no data-dependent exit)."""
    n = torch.clamp_min(n, 0)
    # initial guess: 2^ceil(bits/2)
    bits = bit_length(torch.clamp_min(n, 1))
    x = torch.bitwise_left_shift(torch.ones_like(n),
                                 torch.floor_divide(bits + 1, 2))
    for _ in range(iters):
        x_new = torch.floor_divide(
            x + torch.floor_divide(n, torch.clamp_min(x, 1)), 2)
        x = torch.where(x_new < x, x_new, x)
    # final correction
    x = torch.where(x * x > n, x - 1, x)
    return torch.clamp_min(x, 0)


def i_layernorm(q: torch.Tensor, s: torch.Tensor, axis: int = -1,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """LayerNorm on integer codes: (q - mean) / sqrt(var) with i_sqrt.

    Output scale is 1/2^OUT for a fixed OUT-bit fraction.
    """
    OUT = 10
    d = q.shape[axis]
    mean = torch.floor_divide(_isum(q, axis), d)
    dev = q - mean
    var = torch.floor_divide(_isum(dev * dev, axis), d)
    std = i_sqrt(var)
    qout = torch.floor_divide(dev * (1 << OUT), torch.clamp_min(std, 1))
    return qout, _f32(1.0 / (1 << OUT), s)


def layernorm_quantized(x: torch.Tensor, bits: int = 8, axis: int = -1,
                        ) -> torch.Tensor:
    t = quantize(x, bits)
    qo, so = i_layernorm(t.q, t.s, axis=axis)
    return (qo.to(torch.float32) * so).to(x.dtype)
