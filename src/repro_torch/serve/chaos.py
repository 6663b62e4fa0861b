"""Seeded fault injection for the serving front end.

Robustness claims are worthless untested: the chaos layer deterministically
injects the failure modes a real deployment sees — a compiled step's
dispatch blowing up mid-step, admission stalling, a step taking far too long —
so the test suite can *prove* the scheduler's state machine (slot free
list, KV block tables, recurrent rows) survives every path without
corrupting co-batched survivors.  Everything draws from one
``np.random.default_rng(seed)``, so a chaos run replays bit-identically:
the same seed always kills the same victims at the same ticks.

Injection sites (all pre-dispatch, so a raised fault never leaves
half-mutated host state):

  * ``decode`` — before the slot-wise decode step.  ``decode_fault_rate``
    raises a victimless transient :class:`FaultInjected` (the dispatch
    simply didn't happen; the caller retries the tick).  With
    ``victim_fault_rate`` the fault instead names a random live request
    as its victim — modelling a poisoned lane — which the front-end
    cancels and (budget permitting) retries from scratch.
  * ``chunk`` — before a chunk-prefill dispatch; the victim is the
    mid-prefill request itself.
  * ``stall`` — admission freezes for ``stall_ticks`` scheduler
    iterations (queue keeps filling; backpressure must engage).
  * ``latency`` — ``step_latency_s`` is added to the front-end's view
    of elapsed time per afflicted tick (virtual-clock runs), tripping
    deadline and shed paths without actually sleeping on CI.

``ChaosPolicy.parse`` reads the CLI spec string, e.g.
``--chaos "seed=0,fault=0.05,victim=0.02,stall=0.01,latency_ms=40"``.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np

from repro_torch.serve.errors import FaultInjected


@dataclasses.dataclass(frozen=True)
class ChaosPolicy:
    """What to inject, how often.  All rates are per-opportunity
    probabilities in [0, 1]; zero everything = chaos off."""
    seed: int = 0
    decode_fault_rate: float = 0.0     # victimless transient step faults
    victim_fault_rate: float = 0.0     # step faults naming a live victim
    chunk_fault_rate: float = 0.0      # prefill-chunk faults (victim=rid)
    stall_rate: float = 0.0            # admission freeze, per tick
    stall_ticks: int = 3               # freeze duration once triggered
    step_latency_s: float = 0.0        # artificial latency, per tick
    latency_rate: float = 0.0          # fraction of ticks afflicted

    @property
    def enabled(self) -> bool:
        return any(r > 0 for r in (
            self.decode_fault_rate, self.victim_fault_rate,
            self.chunk_fault_rate, self.stall_rate, self.latency_rate))

    @staticmethod
    def parse(spec: str) -> "ChaosPolicy":
        """Parse a ``k=v,...`` CLI spec.  Keys: ``seed``, ``fault``
        (decode), ``victim``, ``chunk``, ``stall``, ``stall_ticks``,
        ``latency_ms`` (implies ``latency=1.0`` unless given),
        ``latency`` (rate).  ``--chaos ""``/``"off"`` disables."""
        spec = spec.strip()
        if not spec or spec == "off":
            return ChaosPolicy()
        kw: dict = {}
        for part in spec.split(","):
            k, _, v = part.partition("=")
            k = k.strip()
            if not _:
                raise ValueError(f"chaos spec needs k=v pairs, got {part!r}")
            if k == "seed":
                kw["seed"] = int(v)
            elif k == "fault":
                kw["decode_fault_rate"] = float(v)
            elif k == "victim":
                kw["victim_fault_rate"] = float(v)
            elif k == "chunk":
                kw["chunk_fault_rate"] = float(v)
            elif k == "stall":
                kw["stall_rate"] = float(v)
            elif k == "stall_ticks":
                kw["stall_ticks"] = int(v)
            elif k == "latency_ms":
                kw["step_latency_s"] = float(v) / 1e3
            elif k == "latency":
                kw["latency_rate"] = float(v)
            else:
                raise ValueError(f"unknown chaos key {k!r} in {spec!r}")
        if kw.get("step_latency_s", 0) > 0 and "latency_rate" not in kw:
            kw["latency_rate"] = 1.0
        return ChaosPolicy(**kw)


class ChaosInjector:
    """The stateful side of a :class:`ChaosPolicy`: owns the seeded RNG
    and the stall countdown.  One injector per front-end run."""

    def __init__(self, policy: ChaosPolicy):
        self.policy = policy
        self._rng = np.random.default_rng(policy.seed)
        self._stall_until_tick = -1
        self.injected = 0               # faults raised (tests assert >0)

    # -- fault hook (passed into scheduler.tick) ---------------------------

    def fault_hook(self, point: str, rid: int | None) -> None:
        """Raises :class:`FaultInjected` per the policy; called by the
        scheduler immediately before each step's dispatch."""
        p = self.policy
        if point == "decode":
            if p.decode_fault_rate > 0 and \
                    self._rng.random() < p.decode_fault_rate:
                self.injected += 1
                raise FaultInjected("injected decode-step fault",
                                    rid=None, point="decode")
        elif point == "chunk":
            if p.chunk_fault_rate > 0 and \
                    self._rng.random() < p.chunk_fault_rate:
                self.injected += 1
                raise FaultInjected(
                    f"injected chunk-prefill fault (rid={rid})",
                    rid=rid, point="chunk")

    def pick_victim(self, rids: Sequence[int]) -> int | None:
        """After a clean tick, maybe poison one live request (the
        ``victim_fault_rate`` path).  Returns the victim rid or None."""
        p = self.policy
        if not rids or p.victim_fault_rate <= 0:
            return None
        if self._rng.random() < p.victim_fault_rate:
            self.injected += 1
            return int(self._rng.choice(np.asarray(rids)))
        return None

    # -- stall / latency ---------------------------------------------------

    def stalled(self, tick: int) -> bool:
        """Whether admission is frozen at ``tick`` (rolls the stall dice
        once per non-stalled tick)."""
        p = self.policy
        if tick < self._stall_until_tick:
            return True
        if p.stall_rate > 0 and self._rng.random() < p.stall_rate:
            self._stall_until_tick = tick + max(1, p.stall_ticks)
            return True
        return False

    def latency(self) -> float:
        """Artificial seconds to add to this tick's elapsed time."""
        p = self.policy
        if p.latency_rate > 0 and self._rng.random() < p.latency_rate:
            return p.step_latency_s
        return 0.0
