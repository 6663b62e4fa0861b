"""Straggler detection, heartbeat liveness, and serving/trainer metrics.

Across many hosts the common failure modes are (a) a host silently
slowing down (thermal, ECC retries, network) and (b) a host dying.  Both
are detected from per-step timing reports:

  * ``StragglerDetector`` keeps a rolling window of per-host step times
    and flags hosts whose median exceeds ``threshold`` x the fleet median
    — the orchestration layer then drains/replaces them (here: reported in
    trainer metrics; tests inject synthetic timings).
  * ``HeartbeatMonitor`` is file-based (shared FS): each host touches its
    heartbeat every step; hosts silent for ``timeout_s`` are declared dead
    so the job can restart on the surviving set (elastic restart via the
    mesh-independent checkpoints).
  * ``MetricsRegistry`` is the in-process counter/gauge sink both of the
    above report into: monotone ``Counter``s (tokens served, restarts,
    stragglers drained), last-value ``Gauge``s (active slots, fleet
    slowdown), rolling-window ``Summary``s (TTFT / inter-token latency
    percentiles for the serving front-end), and a flat ``snapshot()``
    the launcher can dump as JSON or scrape into whatever telemetry
    exists outside this repo.
"""
from __future__ import annotations

import collections
import math
import os
import threading
import time
from collections.abc import Sequence


class Counter:
    """Monotone event count.  ``inc`` rejects negative deltas — a counter
    that can go down is a gauge, and downstream rate() math silently
    corrupts on resets it didn't cause."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def inc(self, amount: int | float = 1) -> None:
        if amount < 0:
            raise ValueError(
                f"counter {self.name!r} cannot decrease (inc({amount}))")
        self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-observed value; settable both ways."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def set(self, value: int | float) -> None:
        self._value = float(value)

    def add(self, amount: int | float) -> None:
        self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Summary:
    """Rolling-window distribution for latency-style observations.

    Keeps the last ``window`` observations plus a lifetime count; the
    registry snapshot expands it to ``<name>_p50`` / ``<name>_p99`` /
    ``<name>_count`` rows (nearest-rank percentiles over the window —
    the serving front-end's shed-on-p99 check and the latency-under-load
    bench both read these).  An empty summary reports 0.0.
    """

    def __init__(self, name: str, help: str = "", window: int = 512):
        self.name = name
        self.help = help
        self._window: collections.deque = collections.deque(maxlen=window)
        self._count = 0

    def observe(self, value: int | float) -> None:
        self._window.append(float(value))
        self._count += 1

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile of the current window, ``q`` in
        [0, 1]: the smallest value with at least ``ceil(q * n)`` of the
        ``n`` observations at or below it (rank ``max(ceil(q*n), 1)``,
        1-based).  Exact at the edges: q=0 is the window minimum, q=1
        the maximum, and a window of one observation reports that
        observation at every ``q`` (p50 of four observations is the
        2nd, where an ``int(q*n)`` index would take the 3rd)."""
        if not self._window:
            return 0.0
        s = sorted(self._window)
        rank = max(math.ceil(q * len(s)), 1)
        return s[min(rank, len(s)) - 1]

    @property
    def count(self) -> int:
        return self._count

    @property
    def value(self) -> float:
        return self.percentile(0.5)

    def snapshot_items(self) -> list[tuple[str, float]]:
        # alphabetical, so registry snapshots stay globally sorted
        return [(f"{self.name}_count", float(self._count)),
                (f"{self.name}_p50", self.percentile(0.5)),
                (f"{self.name}_p99", self.percentile(0.99))]


class MetricsRegistry:
    """Named metric registry with idempotent registration.

    ``counter``/``gauge`` return the existing instrument when re-invoked
    with the same name (call sites don't coordinate), but refuse to
    re-register a name as a *different* kind — that is always a bug.
    ``snapshot()`` returns a flat ``{name: value}`` dict (a plain-data
    copy: mutating it never touches the live instruments).
    """

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Summary] = {}
        self._lock = threading.Lock()

    def _register(self, kind, name: str, help: str):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}, not {kind.__name__}")
                return existing
            m = kind(name, help)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def summary(self, name: str, help: str = "", window: int = 512) -> Summary:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not Summary:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}, not Summary")
                return existing
            m = Summary(name, help, window=window)
            self._metrics[name] = m
            return m

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            out: dict[str, float] = {}
            for name, m in sorted(self._metrics.items()):
                if isinstance(m, Summary):
                    out.update(m.snapshot_items())
                else:
                    out[name] = m.value
            return out


class StragglerDetector:
    def __init__(self, n_hosts: int, window: int = 16,
                 threshold: float = 1.5,
                 metrics: MetricsRegistry | None = None):
        self.n_hosts = n_hosts
        self.window = window
        self.threshold = threshold
        self._times: list[collections.deque] = [
            collections.deque(maxlen=window) for _ in range(n_hosts)]
        self._reports = metrics.counter(
            "ft.step_reports", "per-host step timings received",
        ) if metrics else None
        self._straggler_gauge = metrics.gauge(
            "ft.stragglers", "hosts currently over the straggler threshold",
        ) if metrics else None

    def report(self, host: int, step_time_s: float):
        self._times[host].append(step_time_s)
        if self._reports is not None:
            self._reports.inc()

    def _median(self, xs: Sequence[float]) -> float:
        s = sorted(xs)
        return s[len(s) // 2]

    def stragglers(self) -> list[int]:
        meds = [self._median(t) if t else 0.0 for t in self._times]
        live = [m for m in meds if m > 0]
        out: list[int] = []
        if live:
            fleet = self._median(live)
            out = [h for h, m in enumerate(meds)
                   if m > self.threshold * fleet]
        if self._straggler_gauge is not None:
            self._straggler_gauge.set(len(out))
        return out

    def slowdown(self, host: int) -> float:
        meds = [self._median(t) if t else 0.0 for t in self._times]
        live = [m for m in meds if m > 0]
        if not live or not self._times[host]:
            return 1.0
        return self._median(self._times[host]) / self._median(live)


class HeartbeatMonitor:
    def __init__(self, directory: str, host_id: int = 0,
                 timeout_s: float = 60.0,
                 metrics: MetricsRegistry | None = None):
        self.directory = directory
        self.host_id = host_id
        self.timeout_s = timeout_s
        self._beats = metrics.counter(
            "ft.heartbeats", "heartbeats written by this host",
        ) if metrics else None
        self._dead_gauge = metrics.gauge(
            "ft.dead_hosts", "hosts past the heartbeat timeout",
        ) if metrics else None
        os.makedirs(directory, exist_ok=True)

    def _path(self, host: int) -> str:
        return os.path.join(self.directory, f"host_{host}.hb")

    def beat(self, now: float | None = None):
        with open(self._path(self.host_id), "w") as f:
            f.write(str(now if now is not None else time.time()))
        if self._beats is not None:
            self._beats.inc()

    def dead_hosts(self, known_hosts: Sequence[int],
                   now: float | None = None) -> list[int]:
        now = now if now is not None else time.time()
        dead = []
        for h in known_hosts:
            try:
                with open(self._path(h)) as f:
                    last = float(f.read().strip())
                if now - last > self.timeout_s:
                    dead.append(h)
            except (FileNotFoundError, ValueError):
                dead.append(h)
        if self._dead_gauge is not None:
            self._dead_gauge.set(len(dead))
        return dead
