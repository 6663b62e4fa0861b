"""Preemption handling: SIGTERM/SIGINT -> stop cleanly.

A cluster's maintenance event delivers SIGTERM with a grace window; the
serving front end polls ``should_stop`` at every pump and closes (queued
and in-flight requests resolve ``cancelled``, partials kept), as a
trainer would poll it each step and save.
"""
from __future__ import annotations

import contextlib
import signal
import threading


class PreemptionHandler:
    def __init__(self, install: bool = True):
        self._stop = threading.Event()
        self._prev = {}
        if install:
            self.install()

    def install(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            with contextlib.suppress(ValueError):   # non-main thread (tests)
                self._prev[sig] = signal.signal(sig, self._on_signal)

    def _on_signal(self, signum, frame):
        self._stop.set()

    def request_stop(self):
        """Programmatic trigger (tests / external orchestrators)."""
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
