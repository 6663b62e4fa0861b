"""Hybrid ISA + µop scheduling semantics (paper §4.2, Figs. 9/10).

This module captures the *timing* behaviour of the coordination hardware
the paper contributes — the analog–digital arbiter, the instruction
injection unit (IIU), and the shift-during-transfer units — as an
event-driven µop timeline.  It is pure Python: it feeds the cost model
and regenerates Fig. 10's optimised-vs-unoptimised MVM schedules, and
its instruction stream doubles as the "expert programmer" ISA surface.
Copied from the JAX package's ``core/isa.py`` (the port shares no module
with it).

Primitive µops (latencies in cycles @ 1 GHz, paper Table 2 + §4):
  A_APPLY   apply one input bit-plane to an analog array        (1)
  A_ADC     digitise 64 bitlines                 SAR: 32 = 64 lines / 2
            units @1cyc; ramp: 256 (or early-terminated L) for all lines
  IO_XFER   move one 64-elem partial-product vector ACE->DCE over the
            8 B/cycle network (64 B at 8-bit codes -> 8 cycles)
  D_WRITE   write one row into a DCE pipeline                   (1/row)
  D_SHIFT   shift a vector register by one bit position         (1)
  D_ADD     ripple add, bit-pipelined: 5b+13 for b-bit operands
            (5-cycle carry-to-carry NOR chain; see core.digital)
  D_NOR     one vector-wide Boolean primitive                   (1)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

SAR_LINES_PER_CYCLE = 2          # 2 SAR ADCs per HCT, 1 conversion/cycle
RAMP_CYCLES = 256
IO_BYTES_PER_CYCLE = 8
ARRAY_DIM = 64


def adc_cycles(kind: str, lines: int = 64, early_levels: int = 0) -> int:
    if kind == "sar":
        return -(-lines // SAR_LINES_PER_CYCLE)
    cyc = RAMP_CYCLES if early_levels <= 0 else early_levels
    return cyc                                   # ramp: all lines in parallel


def xfer_cycles(elems: int = 64, bits: int = 8) -> int:
    return -(-(elems * bits) // (8 * IO_BYTES_PER_CYCLE))


def add_cycles(bits: int) -> int:
    return 5 * bits + 13


def write_cycles(rows: int) -> int:
    return rows


@dataclass
class MVMTiming:
    """Cycle breakdown for one K<=64, N<=64 analog MVM with B input bits
    and S weight slices (differential pair folded into the plane count —
    both rails convert concurrently on separate bitlines)."""
    total: int
    ace_cycles: int
    adc_cycles: int
    xfer_cycles: int
    dce_cycles: int


def schedule_mvm(input_bits: int, n_slices: int, *, adc_kind: str = "sar",
                 acc_bits: int = 24, optimized: bool = True,
                 early_levels: int = 0, rows: int = 64) -> MVMTiming:
    """Timeline of the full bit-sliced MVM (paper Fig. 10).

    Unoptimised (Fig. 10a): per partial product, serialise
      write(rows) -> shift(i positions) -> add;
    the DCE cannot overlap these with the next transfer.

    Optimised (Fig. 10b): shift units place data in the right bit position
    *during* IO_XFER (zero extra cycles), transfers rate-match the ADC, and
    the IIU issues the pipelined ADDs so only the final reduction tail is
    exposed.  The steady-state interval per partial product becomes
    max(adc, xfer) and the adds hide under it.
    """
    parts = input_bits * n_slices
    adc_c = adc_cycles(adc_kind, lines=ARRAY_DIM, early_levels=early_levels)
    x_c = xfer_cycles(ARRAY_DIM, 8)
    a_c = 1                                     # apply one input bit-plane

    if not optimized:
        ace = parts * (a_c + adc_c)
        dce = 0
        for i in range(input_bits):
            for s in range(n_slices):
                shift = i + s  # bit position of this partial product
                dce += write_cycles(rows) + shift + add_cycles(acc_bits)
        total = ace + parts * x_c + dce
        return MVMTiming(total, ace, parts * adc_c, parts * x_c, dce)

    # optimised: software pipeline, interval = bottleneck stage
    interval = max(a_c + adc_c, x_c, write_cycles(rows) if rows < ARRAY_DIM
                   else write_cycles(ARRAY_DIM))
    # adds are injected by the IIU and bit-pipelined; one add latency is
    # exposed at the tail (the rest overlap with later transfers)
    tail = add_cycles(acc_bits)
    total = parts * interval + x_c + tail
    return MVMTiming(total, parts * (a_c + adc_c), parts * adc_c,
                     parts * x_c, tail)


# ---------------------------------------------------------------------------
# Instruction stream + arbiter (functional semantics)
# ---------------------------------------------------------------------------

Op = Literal["AMVM", "DADD", "DXOR", "DSHL", "DSHR", "DLOADE", "DNOR",
             "PRESERVE", "SETM", "TRANSPOSE"]


@dataclass(frozen=True)
class Instr:
    op: Op
    dst: int = 0
    src0: int = 0
    src1: int = 0
    imm: int = 0

    def is_analog(self) -> bool:
        return self.op in ("AMVM", "SETM")


_DIGITAL_LAT = {"DADD": add_cycles(16), "DXOR": 5, "DSHL": 1, "DSHR": 1,
                "DNOR": 1, "DLOADE": 2 * ARRAY_DIM, "PRESERVE": 1,
                "TRANSPOSE": ARRAY_DIM}


def arbitrate(stream: list[Instr], *, input_bits: int = 8, n_slices: int = 4,
              adc_kind: str = "sar", iiu: bool = True) -> tuple[int, int]:
    """Execute the arbiter's serialisation rule over an instruction stream.

    Analog instructions appear atomic (paper §4.2): a younger digital
    instruction touching the DCE stalls until an older in-flight AMVM
    completes.  With the IIU, the shift-and-add expansion does not occupy
    front-end issue slots (1 front-end slot per AMVM); without it, every
    injected ADD consumes an issue slot (front-end pressure `stalls`).

    Returns (total_cycles, frontend_slots_used).
    """
    t = 0
    slots = 0
    for ins in stream:
        if ins.op == "AMVM":
            mt = schedule_mvm(input_bits, n_slices, adc_kind=adc_kind,
                              optimized=True)
            t += mt.total
            slots += 1 if iiu else 1 + input_bits * n_slices
        elif ins.op == "SETM":
            t += 10_000          # analog programming is expensive (§4.1)
            slots += 1
        else:
            t += _DIGITAL_LAT[ins.op]
            slots += 1
    return t, slots
