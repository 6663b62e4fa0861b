"""Digital Compute Element (DCE) functional simulation.

Models RACER-style bit-pipelined Boolean PUM (paper §2.2.2) built on the
OSCAR logic family, whose only primitive is NOR.  A *vector register*
holds M elements of N bits, bit-striped across N arrays; it is a bool
plane stack ``[bits, rows]`` (plane 0 = LSB).

Every operation is built **only from NOR** (plus copy), and a
:class:`GateCounter` tallies primitive issues; these feed and validate
the cost model.  The operations and their gate counts are the JAX
package's ``core/digital.py`` one for one.

Values packed from planes are int64 tensors (torch has few ``uint32``
ops); they hold the same numbers as the JAX package's uint32 values.
"""
from __future__ import annotations

import dataclasses

import torch


# ---------------------------------------------------------------------------
# Gate accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GateCounter:
    """Counts primitive issues (one per NOR/copy across a whole vector:
    digital PUM activates a full column per primitive, so the unit of
    cost is one *vector-wide* primitive, matching RACER's model)."""
    nor: int = 0
    copy: int = 0

    @property
    def total(self) -> int:
        return self.nor + self.copy

    def reset(self):
        self.nor = 0
        self.copy = 0


_NULL = GateCounter()


# ---------------------------------------------------------------------------
# NOR-complete primitives on bool planes
# ---------------------------------------------------------------------------

def nor(a, b, ctr: GateCounter = _NULL):
    ctr.nor += 1
    return torch.logical_not(torch.logical_or(a, b))


def not_(a, ctr: GateCounter = _NULL):
    return nor(a, a, ctr)


def or_(a, b, ctr: GateCounter = _NULL):
    return not_(nor(a, b, ctr), ctr)


def and_(a, b, ctr: GateCounter = _NULL):
    return nor(not_(a, ctr), not_(b, ctr), ctr)


def xnor_(a, b, ctr: GateCounter = _NULL):
    # 4-gate NOR-only XNOR
    n1 = nor(a, b, ctr)
    n2 = nor(a, n1, ctr)            # = !a & b
    n3 = nor(b, n1, ctr)            # =  a & !b
    return nor(n2, n3, ctr)         # = !(a ^ b)


def xor_(a, b, ctr: GateCounter = _NULL):
    # minimal NOR-only XOR is 5 gates (XNOR + final inversion)
    return not_(xnor_(a, b, ctr), ctr)


def full_adder(a, b, cin, ctr: GateCounter = _NULL):
    """1-bit full adder from NOR primitives. Returns (sum, carry)."""
    axb = xor_(a, b, ctr)
    s = xor_(axb, cin, ctr)
    # carry = ab + cin(a^b)
    t1 = and_(a, b, ctr)
    t2 = and_(cin, axb, ctr)
    c = or_(t1, t2, ctr)
    return s, c


# ---------------------------------------------------------------------------
# Vector-register (bit-plane) representation
# ---------------------------------------------------------------------------

def pack(planes: torch.Tensor) -> torch.Tensor:
    """[bits, ...] bool planes -> int64 values (little-endian planes)."""
    bits = planes.shape[0]
    w = (torch.ones(bits, dtype=torch.int64, device=planes.device)
         << torch.arange(bits, device=planes.device)).reshape(
        (bits,) + (1,) * (planes.ndim - 1))
    return torch.sum(planes.to(torch.int64) * w, dim=0)


def unpack(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Integer values (read as uint32) -> [bits, ...] bool planes."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([((v >> i) & 1).to(torch.bool) for i in range(bits)])


# ---------------------------------------------------------------------------
# Multi-bit operations (bit-pipelined in hardware; plane-wise here)
# ---------------------------------------------------------------------------

def add(a: torch.Tensor, b: torch.Tensor, ctr: GateCounter = _NULL,
        ) -> torch.Tensor:
    """Ripple-carry add over plane stacks (modulo 2^bits)."""
    bits = a.shape[0]
    c = torch.zeros_like(a[0])
    out = []
    for i in range(bits):
        s, c = full_adder(a[i], b[i], c, ctr)
        out.append(s)
    return torch.stack(out)


def sub(a: torch.Tensor, b: torch.Tensor, ctr: GateCounter = _NULL,
        ) -> torch.Tensor:
    """a - b via two's complement (invert + carry-in 1)."""
    bits = a.shape[0]
    nb = torch.stack([not_(b[i], ctr) for i in range(bits)])
    c = torch.ones_like(a[0])
    out = []
    for i in range(bits):
        s, c = full_adder(a[i], nb[i], c, ctr)
        out.append(s)
    return torch.stack(out)


def xor_planes(a: torch.Tensor, b: torch.Tensor, ctr: GateCounter = _NULL,
               ) -> torch.Tensor:
    return torch.stack([xor_(a[i], b[i], ctr) for i in range(a.shape[0])])


def shift_left(a: torch.Tensor, n: int, ctr: GateCounter = _NULL,
               ) -> torch.Tensor:
    """Logical shift toward MSB by n bit positions (plane relabel + zero
    fill; in hardware: n pipeline shift steps)."""
    ctr.copy += n
    bits = a.shape[0]
    zeros = torch.zeros((n,) + tuple(a.shape[1:]), dtype=a.dtype,
                        device=a.device)
    return torch.cat([zeros, a[: bits - n]], dim=0)


def shift_right(a: torch.Tensor, n: int, ctr: GateCounter = _NULL,
                ) -> torch.Tensor:
    ctr.copy += n
    zeros = torch.zeros((n,) + tuple(a.shape[1:]), dtype=a.dtype,
                        device=a.device)
    return torch.cat([a[n:], zeros], dim=0)


def reverse_pipeline(a: torch.Tensor, ctr: GateCounter = _NULL,
                     ) -> torch.Tensor:
    """The paper's pipeline-reversal macro (§5.3): drain + reverse
    propagation. Cost modelled as a full drain (bits copies)."""
    ctr.copy += a.shape[0]
    return torch.flip(a, dims=(0,))


def rotate_rows(a: torch.Tensor, shift: int, axis: int = 1,
                ctr: GateCounter = _NULL) -> torch.Tensor:
    """Cyclic rotation of vector-register *rows* (AES ShiftRows uses
    reversal + shifts; this models the macro's net effect)."""
    ctr.copy += a.shape[0]
    return torch.roll(a, -shift, dims=axis)


def elementwise_load(table: torch.Tensor, addr: torch.Tensor,
                     ctr: GateCounter = _NULL) -> torch.Tensor:
    """The paper's element-wise load (§4.2): for each row r, fetch
    ``table[addr[r]]`` from an adjacent pipeline; 1 row read + 1 row
    write per element per cycle in hardware.

    table: planes [bits_out, T]; addr: planes [bits_addr, rows].
    Returns [bits_out, rows]."""
    idx = pack(addr)           # int64: a gather index, never a bool mask
    ctr.copy += 2 * idx.numel()                          # read+write per elem
    return table[:, idx]


def mul(a: torch.Tensor, b: torch.Tensor, out_bits: int,
        ctr: GateCounter = _NULL) -> torch.Tensor:
    """Shift-add multiply (unsigned), truncated to out_bits."""
    bits_a = a.shape[0]
    acc = torch.zeros((out_bits,) + tuple(a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    bx = torch.cat([b, torch.zeros((out_bits - b.shape[0],)
                                   + tuple(b.shape[1:]), dtype=b.dtype,
                                   device=b.device)], dim=0)[:out_bits]
    for i in range(bits_a):
        shifted = shift_left(bx, i, ctr) if i else bx
        gated = torch.stack([and_(shifted[j], a[i], ctr)
                             for j in range(out_bits)])
        acc = add(acc, gated, ctr)
    return acc


def greater_equal(a: torch.Tensor, b: torch.Tensor, ctr: GateCounter = _NULL,
                  ) -> torch.Tensor:
    """Unsigned a >= b, returns a single bool plane (via subtract borrow)."""
    bits = a.shape[0]
    nb = torch.stack([not_(b[i], ctr) for i in range(bits)])
    c = torch.ones_like(a[0])
    for i in range(bits):
        _, c = full_adder(a[i], nb[i], c, ctr)
    return c                                            # carry-out == no borrow


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           ctr: GateCounter = _NULL) -> torch.Tensor:
    """cond ? a : b per row (cond: single plane)."""
    out = []
    for i in range(a.shape[0]):
        t = and_(a[i], cond, ctr)
        f = and_(b[i], not_(cond, ctr), ctr)
        out.append(or_(t, f, ctr))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# Primitive-count formulas (used by the cost model; validated against the
# GateCounter in tests)
# ---------------------------------------------------------------------------

XOR_NORS = 5
AND_NORS = 3
OR_NORS = 2
NOT_NORS = 1
FULL_ADDER_NORS = 2 * XOR_NORS + 2 * AND_NORS + OR_NORS          # = 18


def add_cost(bits: int) -> int:
    return bits * FULL_ADDER_NORS


def xor_cost(bits: int) -> int:
    return bits * XOR_NORS


def mul_cost(bits_a: int, out_bits: int) -> int:
    return bits_a * (out_bits * AND_NORS + add_cost(out_bits)) + sum(
        range(bits_a))  # + shifts (copies)
