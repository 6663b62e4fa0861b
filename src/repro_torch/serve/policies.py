"""Admission-queue policies, retry backoff, and the test clock for the
async serving front-end.

The front-end's bounded queue orders waiting requests by one of three
policies:

  * ``fifo``     — arrival order (submission sequence number);
  * ``priority`` — higher ``Request.priority`` first, FIFO within a
                   priority level (no starvation *within* a level; a
                   steady stream of high-priority work can starve low —
                   that is the contract callers opt into);
  * ``edf``      — earliest absolute deadline first (requests without a
                   deadline sort last, FIFO among themselves).  Classic
                   earliest-deadline-first: optimal for meeting
                   deadlines when the pool is feasible, degrades to
                   FIFO-of-the-desperate when it is not — which is
                   exactly when the front-end's expiry sweep reclaims
                   the queue.

Entries are kept in a heap keyed ``(policy_key..., seq)``; ``seq`` is a
global submission counter so equal keys stay FIFO and heap comparisons
never reach the (uncomparable) request object.

``RetryPolicy`` is the bounded jittered-backoff schedule for retryable
failures (injected faults, transient pool exhaustion): attempt ``k``
waits ``backoff_s * multiplier**k`` scaled by a seeded uniform jitter in
``[1-jitter, 1+jitter]`` — seeded so chaos tests replay bit-identically.

``VirtualClock`` is a monotone fake of ``time.monotonic`` the
deterministic tests and trace runner advance by hand; production uses
the real clock.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections.abc import Callable

import numpy as np

from repro_torch.serve.scheduler import Request

POLICIES = ("fifo", "priority", "edf")


@dataclasses.dataclass
class QueueEntry:
    """One queued request plus its front-end bookkeeping."""
    req: Request
    priority: int = 0
    deadline: float | None = None       # absolute, clock seconds
    enq_time: float = 0.0
    seq: int = 0
    attempt: int = 0                    # retry attempts consumed so far
    not_before: float = 0.0             # retry backoff eligibility time


class RequestQueue:
    """Bounded admission queue with a pluggable ordering policy.

    ``push`` refuses past ``maxlen`` (the caller maps that to a typed
    ``QueueFull``); ``pop_ready(now)`` returns the best eligible entry —
    an entry still inside its retry-backoff window (``not_before``) is
    skipped *without* losing its queue position; ``expire(now)`` removes
    and returns every entry whose deadline has passed, regardless of
    policy order.

    Deadline beats backoff: an entry whose ``deadline_ms`` elapses
    *while it is held* in its backoff window must never dispatch when
    the hold expires — ``pop_ready`` checks expiry before backoff
    eligibility and parks such entries for the next ``expire`` sweep
    (they surface as ``expired``, exactly as if they had aged out in
    the queue proper).
    """

    def __init__(self, maxlen: int, policy: str = "fifo"):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown queue policy {policy!r}; expected one of "
                f"{POLICIES}")
        if maxlen < 1:
            raise ValueError(f"maxlen must be >= 1, got {maxlen}")
        self.maxlen = maxlen
        self.policy = policy
        self._heap: list[tuple] = []
        self._expired_held: list[QueueEntry] = []
        self._seq = 0

    def _key(self, e: QueueEntry) -> tuple:
        if self.policy == "priority":
            return (-e.priority, e.seq)
        if self.policy == "edf":
            return (e.deadline if e.deadline is not None else float("inf"),
                    e.seq)
        return (e.seq,)

    def __len__(self) -> int:
        # held-expired entries still count: they occupy queue space
        # until the next expire() sweep surfaces them
        return len(self._heap) + len(self._expired_held)

    @property
    def depth(self) -> int:
        return len(self)

    def full(self) -> bool:
        return len(self) >= self.maxlen

    def push(self, entry: QueueEntry) -> bool:
        """Enqueue; returns False (entry NOT queued) when full."""
        if self.full():
            return False
        entry.seq = entry.seq or self._next_seq()
        heapq.heappush(self._heap, (*self._key(entry), entry))
        return True

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def pop_ready(self, now: float) -> QueueEntry | None:
        """Best non-expired entry whose retry backoff has elapsed, or
        None.

        Backoff-ineligible entries keep their position: they are set
        aside during the scan and pushed back untouched.  Expiry is
        checked BEFORE backoff eligibility — an entry whose deadline
        passed while it sat in its ``not_before`` hold is parked for
        ``expire`` instead of ever dispatching.
        """
        deferred = []
        found = None
        while self._heap:
            item = heapq.heappop(self._heap)
            entry = item[-1]
            if entry.deadline is not None and now >= entry.deadline:
                self._expired_held.append(entry)
                continue
            if entry.not_before <= now:
                found = entry
                break
            deferred.append(item)
        for item in deferred:
            heapq.heappush(self._heap, item)
        return found

    def peek(self) -> QueueEntry | None:
        return self._heap[0][-1] if self._heap else None

    def remove(self, rid: int) -> QueueEntry | None:
        """Remove the queued entry for ``rid`` (None if not queued)."""
        for i, item in enumerate(self._heap):
            if item[-1].req.rid == rid:
                entry = item[-1]
                self._heap[i] = self._heap[-1]
                self._heap.pop()
                heapq.heapify(self._heap)
                return entry
        for i, entry in enumerate(self._expired_held):
            if entry.req.rid == rid:
                return self._expired_held.pop(i)
        return None

    def expire(self, now: float) -> list[QueueEntry]:
        """Remove and return every queued entry past its deadline —
        including entries ``pop_ready`` parked when their deadline
        passed inside a retry-backoff hold."""
        expired, kept = list(self._expired_held), []
        self._expired_held = []
        for item in self._heap:
            entry = item[-1]
            if entry.deadline is not None and now >= entry.deadline:
                expired.append(entry)
            else:
                kept.append(item)
        if len(kept) != len(self._heap):
            self._heap = kept
            heapq.heapify(self._heap)
        return expired

    def drain(self) -> list[QueueEntry]:
        """Remove and return everything, best-first (held-expired
        entries last — they are no longer dispatchable)."""
        out = []
        while self._heap:
            out.append(heapq.heappop(self._heap)[-1])
        out.extend(self._expired_held)
        self._expired_held = []
        return out


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded jittered exponential backoff for retryable failures.

    ``max_retries=0`` disables retry (first failure is final).  The
    jitter RNG is seeded, so a chaos run's full retry schedule replays
    bit-identically under the same seeds.
    """
    max_retries: int = 2
    backoff_s: float = 0.05
    multiplier: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "_rng",
                           np.random.default_rng(self.seed))

    def next_delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        base = self.backoff_s * self.multiplier ** (attempt - 1)
        if self.jitter <= 0:
            return base
        lo, hi = 1.0 - self.jitter, 1.0 + self.jitter
        return base * float(self._rng.uniform(lo, hi))

    def should_retry(self, attempt: int) -> bool:
        return attempt <= self.max_retries


class VirtualClock:
    """A hand-advanced monotone clock (drop-in for ``time.monotonic``).

    The deterministic trace runner and the chaos tests use one of these
    so deadlines, backoff windows, and latency metrics are exact
    functions of the trace — no wall-clock flake on slow CI runners.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot go backwards (advance({dt}))")
        self._now += dt
        return self._now


Clock = Callable[[], float]
