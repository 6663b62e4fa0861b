"""Resilient async serving front end over the continuous-batching
scheduler.

The scheduler raises on overload; a deployment needs the opposite:
degrade gracefully, keep its promises about latency, and never let one
bad request (or one injected fault) take down co-batched work.
``ServeFrontend`` wraps :class:`ContinuousBatchingScheduler`'s step-wise
primitives (``start_request`` / ``tick`` / ``cancel`` / ``drain``) with:

  * **admission control** — a bounded :class:`RequestQueue` (FIFO /
    priority / EDF), cost-aware admission (``can_fund``: a request is
    only started when a slot and the KV pool can fund it), and load
    shedding on queue depth or p99 TTFT.  Overload NEVER raises out of
    the front end: rejected work comes back as a handle already
    resolved with a typed :class:`AdmissionRejected` subclass.
  * **deadlines / cancellation / retry** — per-request ``deadline_ms``
    and ``priority``; queued requests expire in place, decoding requests
    are cancelled mid-flight (slot and KV blocks retired, survivors
    untouched — every row's lane is isolated in every step) and return
    their partial tokens flagged ``truncated``.  Retryable failures
    (injected faults, transient pool exhaustion) re-queue with bounded
    jittered backoff; a request's tokens are a function of the request
    alone, so a retried request regenerates its prefix bit for bit and
    the handle's ``emitted`` watermark dedupes the stream.
  * **fault injection** — a seeded :class:`ChaosPolicy` drives the
    scheduler's pre-dispatch fault hook (decode and chunk faults),
    admission stalls, and artificial step latency.
  * **streaming and observability** — per-token async streaming through
    ``RequestHandle.stream()`` and live ``ft.monitor`` metrics (queue
    depth, pool occupancy, tok/s, p50/p99 TTFT and inter-token latency,
    shed/reject/expire/fault counters) through
    ``MetricsRegistry.snapshot()``.

The core is the synchronous :meth:`ServeFrontend._pump` (one scheduler
iteration).  Two loops call it: the asyncio one (:meth:`start` /
:meth:`stop`) for real serving on ``time.monotonic``, and the
deterministic :meth:`serve_trace` (a virtual clock, seeded arrivals);
both run the same code.  On a :class:`VirtualClock` every latency is a
function of the trace and ``tick_dt``, not a time of the device.

``_pump`` absorbs exactly two exceptions: :class:`FaultInjected` from
``tick`` and :class:`PoolExhausted` from ``start_request``.  Anything
else — a CUDA error, a kernel that fails to build or launch — goes out
to the caller; it is never retried as if it were a fault.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from collections.abc import AsyncIterator, Sequence
from dataclasses import dataclass, field

from repro_torch.ft.monitor import MetricsRegistry
from repro_torch.ft.preemption import PreemptionHandler
from repro_torch.serve.chaos import ChaosInjector, ChaosPolicy
from repro_torch.serve.errors import (AdmissionRejected, DeadlineExceeded,
                                      FaultInjected, LoadShed, PoolExhausted,
                                      QueueFull, RequestCancelled,
                                      RequestTooLarge, RetriesExhausted)
from repro_torch.serve.policies import (Clock, QueueEntry, RequestQueue,
                                        RetryPolicy, VirtualClock)
from repro_torch.serve.scheduler import (Completion,
                                         ContinuousBatchingScheduler, Request)

_STREAM_END = None          # stream sentinel


@dataclass
class ServeResult:
    """Terminal outcome of one submitted request.

    ``status``: ``ok`` | ``rejected`` | ``expired`` | ``cancelled`` |
    ``failed``.  ``completion`` is present for ``ok`` and (partial,
    ``truncated=True``) for expired/cancelled mid-decode; ``error``
    carries the typed reason for every non-``ok`` status.
    """
    status: str
    rid: int
    completion: Completion | None = None
    error: Exception | None = None
    attempts: int = 0

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def tokens(self) -> list[int]:
        return list(self.completion.tokens) if self.completion else []


class RequestHandle:
    """The caller's view of one submitted request.

    Stream tokens with ``async for tok in handle.stream()`` (ends when
    the request resolves, however it resolves); await the terminal
    :class:`ServeResult` with ``await handle.result()``; or poll
    ``handle.done`` / ``handle.result_nowait()`` from synchronous
    callers.  ``emitted`` is the dedupe watermark: a retried request
    regenerates its (deterministic) prefix, and only tokens at or past
    the watermark reach the stream — the consumer never sees a repeat.
    """

    def __init__(self, rid: int, req: Request, enq_time: float,
                 deadline: float | None = None, priority: int = 0):
        self.rid = rid
        self.req = req
        self.enq_time = enq_time
        self.deadline = deadline
        self.priority = priority
        self.emitted = 0
        self.attempts = 0
        self.first_token_time: float | None = None
        self.last_token_time: float | None = None
        self._stream: asyncio.Queue = asyncio.Queue()
        self._done = asyncio.Event()
        self._result: ServeResult | None = None

    # -- producer side (front-end only) ------------------------------------

    def _emit(self, index: int, token: int) -> bool:
        """Deliver a token event; returns True if it was fresh (not a
        replayed prefix from a retry)."""
        if self._result is not None or index < self.emitted:
            return False
        self._stream.put_nowait(int(token))
        self.emitted += 1
        return True

    def _resolve(self, result: ServeResult) -> None:
        if self._result is not None:
            return
        # flush tokens the completion carries past the stream watermark
        # (instant completions, the final token of a harvest, partials)
        if result.completion is not None:
            for tok in result.completion.tokens[self.emitted:]:
                self._stream.put_nowait(int(tok))
                self.emitted += 1
        self._result = result
        self._stream.put_nowait(_STREAM_END)
        self._done.set()

    # -- consumer side ------------------------------------------------------

    @property
    def done(self) -> bool:
        return self._result is not None

    def result_nowait(self) -> ServeResult:
        if self._result is None:
            raise RuntimeError(f"request {self.rid} not resolved yet")
        return self._result

    async def result(self) -> ServeResult:
        await self._done.wait()
        return self._result

    async def stream(self) -> AsyncIterator[int]:
        while True:
            tok = await self._stream.get()
            if tok is _STREAM_END:
                return
            yield tok

    def cancel(self) -> None:
        """Ask the front-end to cancel this request (effective at its
        next pump)."""
        self.cancel_requested = True

    cancel_requested: bool = False


@dataclass
class FrontendConfig:
    """Knobs for :class:`ServeFrontend` (all overridable as ctor kwargs
    via ``ServeFrontend(sched, max_queue=..., ...)``)."""
    max_queue: int = 64
    policy: str = "fifo"                 # fifo | priority | edf
    default_deadline_ms: float | None = None
    shed_depth: int | None = None        # shed when queue depth >= this
    shed_p99_ttft_ms: float | None = None
    shed_min_samples: int = 8            # p99 shed needs this many TTFTs
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    tick_dt: float = 0.01                # virtual seconds per trace tick


class ServeFrontend:
    """Admission control, deadlines, backpressure, chaos, and streaming
    over one :class:`ContinuousBatchingScheduler`.  See module docstring."""

    def __init__(self, scheduler: ContinuousBatchingScheduler, *,
                 config: FrontendConfig | None = None,
                 metrics: MetricsRegistry | None = None,
                 chaos: ChaosPolicy | None = None,
                 clock: Clock | None = None,
                 preemption: PreemptionHandler | None = None,
                 **overrides):
        cfg = config or FrontendConfig()
        for k, v in overrides.items():
            if not hasattr(cfg, k):
                raise TypeError(f"unknown ServeFrontend option {k!r}")
            setattr(cfg, k, v)
        self.cfg = cfg
        self.sched = scheduler
        self.clock: Clock = clock if clock is not None else time.monotonic
        self.queue = RequestQueue(cfg.max_queue, cfg.policy)
        self.chaos = ChaosInjector(chaos) if chaos is not None \
            and chaos.enabled else None
        self.preemption = preemption
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._handles: dict[int, RequestHandle] = {}
        self._inflight: dict[int, RequestHandle] = {}
        self._next_rid = 0
        self._step = 0            # scheduler-step counter (bookkeeping)
        self._tick = 0
        self._closed = False
        self._task: asyncio.Task | None = None
        self._t0: float | None = None
        self._total_tokens = 0
        m = self.metrics
        self._g_depth = m.gauge("serve.queue_depth",
                                "requests waiting for admission")
        self._g_active = m.gauge("serve.active_slots",
                                 "requests decoding or mid-prefill")
        self._g_free_blocks = m.gauge("serve.free_blocks",
                                      "unallocated KV pool blocks")
        self._g_occupancy = m.gauge(
            "serve.pool_occupancy", "fraction of KV blocks (paged) or "
            "slots (contiguous) in use")
        self._g_tok_s = m.gauge("serve.tok_per_s",
                                "generated tokens per second")
        self._c = {name: m.counter(f"serve.{name}", help_) for name, help_
                   in [("admitted", "requests admitted to a slot"),
                       ("completed", "requests finished naturally"),
                       ("rejected", "requests refused at submit"),
                       ("shed", "requests refused by load shedding"),
                       ("expired", "requests past their deadline"),
                       ("cancelled", "requests cancelled by the caller"),
                       ("retries", "retry re-queues after faults"),
                       ("faults", "injected faults absorbed"),
                       ("stalls", "ticks with admission stalled"),
                       ("tokens", "tokens streamed to callers")]}
        self._s_ttft = m.summary("serve.ttft_ms",
                                 "ms from submit to first token")
        self._s_itl = m.summary("serve.itl_ms",
                                "ms between consecutive tokens")
        self._g_spec_accept = m.gauge(
            "serve.spec.acceptance_rate",
            "draft tokens accepted / proposed (0 when speculate_k=0)")
        self._g_spec_advance = m.gauge(
            "serve.spec.advance_per_step",
            "mean tokens emitted per active slot per decode dispatch")

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request, *, priority: int | None = None,
               deadline_ms: float | None = None) -> RequestHandle:
        """Queue a request; returns its handle immediately.

        Malformed requests (empty prompt, bad ``max_tokens``) raise
        :class:`InvalidRequest` — a caller bug.  Every *load*-dependent
        refusal (queue full, shedding, closed, too large for the
        engine) comes back as an already-resolved handle with a typed
        error: overload never raises.
        """
        now = self.clock()
        if self._t0 is None:
            self._t0 = now
        if req.rid is None:
            while self._next_rid in self._handles:
                self._next_rid += 1
            req = _with_rid(req, self._next_rid)
        prio = priority if priority is not None else req.priority
        dl_ms = deadline_ms if deadline_ms is not None else (
            req.deadline_ms if req.deadline_ms is not None
            else self.cfg.default_deadline_ms)
        deadline = now + dl_ms / 1e3 if dl_ms is not None else None
        handle = RequestHandle(req.rid, req, now, deadline, prio)

        if self._closed:
            return self._refuse(handle, AdmissionRejected(
                "front-end is closed", reason="closed"))
        try:
            self.sched.validate_request(req)
        except RequestTooLarge as e:
            return self._refuse(handle, AdmissionRejected(
                str(e), reason="too_large"))
        # InvalidRequest (non-size) propagates: caller bug, not load
        if self.cfg.shed_depth is not None \
                and self.queue.depth >= self.cfg.shed_depth:
            self._c["shed"].inc()
            return self._refuse(handle, LoadShed(
                f"queue depth {self.queue.depth} >= shed threshold "
                f"{self.cfg.shed_depth}"), count=False)
        if self.cfg.shed_p99_ttft_ms is not None \
                and self._s_ttft.count >= self.cfg.shed_min_samples \
                and self._s_ttft.percentile(0.99) \
                > self.cfg.shed_p99_ttft_ms:
            self._c["shed"].inc()
            return self._refuse(handle, LoadShed(
                f"p99 TTFT {self._s_ttft.percentile(0.99):.1f}ms > shed "
                f"threshold {self.cfg.shed_p99_ttft_ms}ms"), count=False)
        entry = QueueEntry(req=req, priority=prio, deadline=deadline,
                           enq_time=now)
        if not self.queue.push(entry):
            return self._refuse(handle, QueueFull(
                f"admission queue full ({self.queue.maxlen})"))
        self._handles[req.rid] = handle
        self._g_depth.set(self.queue.depth)
        return handle

    def _refuse(self, handle: RequestHandle,
                err: AdmissionRejected, count: bool = True) -> RequestHandle:
        if count:
            self._c["rejected"].inc()
        handle._resolve(ServeResult("rejected", handle.rid, error=err))
        return handle

    # -- the pump (one scheduler iteration) ---------------------------------

    def _pump(self) -> None:
        """One front-end iteration: expire, cancel, admit, tick, stream,
        account.  Both the asyncio loop and ``serve_trace`` call this —
        it never raises on overload or injected faults."""
        tick = self._tick
        self._tick += 1
        if self.chaos is not None:
            lat = self.chaos.latency()
            if lat > 0 and isinstance(self.clock, VirtualClock):
                self.clock.advance(lat)
        now = self.clock()

        if self.preemption is not None and self.preemption.should_stop:
            self.close()
            return

        # queued requests past their deadline expire in place
        for entry in self.queue.expire(now):
            h = self._handles.get(entry.req.rid)
            if h is not None:
                self._c["expired"].inc()
                h._resolve(ServeResult(
                    "expired", h.rid, attempts=h.attempts,
                    error=DeadlineExceeded(
                        f"request {h.rid} expired in queue")))

        # caller-requested cancellations (queued or in flight)
        for rid, h in list(self._handles.items()):
            if h.cancel_requested and not h.done:
                self._cancel_now(h, now)

        # decoding requests past their deadline are cut loose with a
        # partial completion; survivors are untouched
        for rid, h in list(self._inflight.items()):
            if h.deadline is not None and now >= h.deadline:
                comp = self.sched.cancel(rid, self._step, reason="expired")
                self._inflight.pop(rid, None)
                self._c["expired"].inc()
                h._resolve(ServeResult(
                    "expired", rid, completion=comp, attempts=h.attempts,
                    error=DeadlineExceeded(
                        f"request {rid} exceeded deadline mid-decode")))

        # admission: policy-best fundable request, unless chaos stalls it
        stalled = self.chaos.stalled(tick) if self.chaos is not None \
            else False
        if stalled:
            self._c["stalls"].inc()
        while not stalled and self.sched.num_free_slots > 0:
            entry = self.queue.pop_ready(now)
            if entry is None:
                break
            h = self._handles.get(entry.req.rid)
            if h is None or h.done:
                continue                      # expired/cancelled already
            if not self.sched.can_fund(entry.req):
                # cost-aware: the pool cannot fund the policy-best
                # request yet — it keeps its queue position
                self.queue.push(entry)
                break
            try:
                comp = self.sched.start_request(entry.req, self._step)
            except PoolExhausted:             # raced with our own check
                self.queue.push(entry)
                break
            self._c["admitted"].inc()
            h.attempts = max(h.attempts, entry.attempt)
            if comp is not None:              # finished at prefill
                self._finish(h, comp, now)
            else:
                self._inflight[entry.req.rid] = h

        # one engine tick, chaos hooks armed
        fault_hook = self.chaos.fault_hook if self.chaos is not None \
            else None
        res = None
        try:
            res = self.sched.tick(self._step, fault_hook)
        except FaultInjected as f:
            self._c["faults"].inc()
            if f.rid is not None:
                self._fault_victim(f.rid, f, now)
            # victimless decode fault: the dispatch simply didn't
            # happen; next pump retries the identical step
        if res is not None:
            for rid, idx, tok in res.events:
                h = self._handles.get(rid)
                if h is None or h.done:
                    continue
                if h._emit(idx, tok):
                    self._total_tokens += 1
                    self._c["tokens"].inc()
                    if h.first_token_time is None:
                        h.first_token_time = now
                        self._s_ttft.observe((now - h.enq_time) * 1e3)
                    elif h.last_token_time is not None:
                        self._s_itl.observe(
                            (now - h.last_token_time) * 1e3)
                    h.last_token_time = now
            for rid, comp in res.completions.items():
                h = self._handles.get(rid)
                if h is not None:
                    self._finish(h, comp, now)
            victim = self.chaos.pick_victim(self.sched.in_flight()) \
                if self.chaos is not None else None
            if victim is not None:
                self._c["faults"].inc()
                self._fault_victim(victim, FaultInjected(
                    "injected slot fault", rid=victim, point="decode"),
                    now)
        self._step += 1
        self._update_gauges(now)

    def _finish(self, h: RequestHandle, comp: Completion,
                now: float) -> None:
        self._inflight.pop(h.rid, None)
        self._c["completed"].inc()
        h._resolve(ServeResult("ok", h.rid, completion=comp,
                               attempts=h.attempts))

    def _cancel_now(self, h: RequestHandle, now: float) -> None:
        comp = self.sched.cancel(h.rid, self._step, reason="cancelled")
        self._inflight.pop(h.rid, None)
        self.queue.remove(h.rid)
        self._c["cancelled"].inc()
        h._resolve(ServeResult(
            "cancelled", h.rid, completion=comp, attempts=h.attempts,
            error=RequestCancelled(f"request {h.rid} cancelled")))

    def _fault_victim(self, rid: int, fault: FaultInjected,
                      now: float) -> None:
        """A fault named ``rid``: cancel it (freeing slot + blocks) and
        retry from scratch under the backoff policy.  Decode is
        deterministic, so the retried prefix is bit-identical and the
        handle's watermark keeps the stream duplicate-free."""
        self.sched.cancel(rid, self._step, reason="fault")
        h = self._inflight.pop(rid, None)
        if h is None:
            return
        h.attempts += 1
        if self.cfg.retry.should_retry(h.attempts) and not self._closed:
            delay = self.cfg.retry.next_delay(h.attempts)
            requeued = self.queue.push(QueueEntry(
                req=h.req, priority=h.priority, deadline=h.deadline,
                enq_time=h.enq_time, attempt=h.attempts,
                not_before=now + delay))
            if requeued:
                self._c["retries"].inc()
                return
        h._resolve(ServeResult(
            "failed", rid, attempts=h.attempts,
            error=RetriesExhausted(
                f"request {rid} failed after {h.attempts} attempt(s): "
                f"{fault}")))

    def _update_gauges(self, now: float) -> None:
        self._g_depth.set(self.queue.depth)
        self._g_active.set(len(self.sched.in_flight()))
        if self.sched.paged:
            total = self.sched.total_blocks
            free = self.sched.free_blocks
            self._g_free_blocks.set(free)
            self._g_occupancy.set((total - free) / total if total else 0.0)
        else:
            occ = self.sched.num_slots - self.sched.num_free_slots
            self._g_occupancy.set(occ / self.sched.num_slots)
        if self._t0 is not None and now > self._t0:
            self._g_tok_s.set(self._total_tokens / (now - self._t0))
        if self.sched.speculate_k > 0:
            st = self.sched.spec_stats()
            self._g_spec_accept.set(st["acceptance_rate"])
            self._g_spec_advance.set(st["advance_per_step"])

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        """Stop admission and retire everything: queued requests resolve
        ``cancelled``, in-flight requests resolve ``cancelled`` with
        their partial (``truncated=True``) completions — accepted work
        is never silently lost."""
        if self._closed and not self._inflight and not len(self.queue):
            return
        self._closed = True
        for entry in self.queue.drain():
            h = self._handles.get(entry.req.rid)
            if h is not None and not h.done:
                self._c["cancelled"].inc()
                h._resolve(ServeResult(
                    "cancelled", h.rid, attempts=h.attempts,
                    error=RequestCancelled("front-end closed")))
        for rid, comp in self.sched.drain(self._step).items():
            h = self._inflight.pop(rid, None)
            if h is not None and not h.done:
                self._c["cancelled"].inc()
                h._resolve(ServeResult(
                    "cancelled", rid, completion=comp,
                    attempts=h.attempts,
                    error=RequestCancelled("front-end closed")))

    async def start(self) -> None:
        """Run the pump as a background asyncio task."""
        if self._task is not None:
            return
        self._task = asyncio.create_task(self._run_loop())

    async def _run_loop(self) -> None:
        while not self._closed:
            self._pump()
            await asyncio.sleep(0)

    async def stop(self, drain: bool = True) -> None:
        """Stop serving.  ``drain=True`` finishes in-flight work first
        (no new admissions); ``drain=False`` truncates it via
        :meth:`close`."""
        self._closed = True
        if drain:
            while self._inflight:
                self._pump()
                await asyncio.sleep(0)
        self.close()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    # -- deterministic trace runner ----------------------------------------

    def serve_trace(self, requests: Sequence[Request],
                    max_ticks: int = 200_000,
                    ) -> dict[int, RequestHandle]:
        """Drive a whole arrival trace synchronously to completion.

        Requests are submitted when the front-end clock reaches their
        ``arrival_time`` (immediately if unset); the clock (a
        :class:`VirtualClock` for determinism, or wall time) advances
        ``cfg.tick_dt`` virtual seconds per pump.  Returns every
        request's handle — all resolved, with typed outcomes for
        everything that was shed, expired, or failed.  Never raises on
        overload (the 4x-capacity acceptance trace runs through here).
        """
        virtual = isinstance(self.clock, VirtualClock)
        pending = sorted(requests,
                         key=lambda r: (r.arrival_time or 0.0))
        handles: dict[int, RequestHandle] = {}
        i, ticks = 0, 0
        while (i < len(pending) or self._inflight or len(self.queue)
               or self.sched.in_flight()):
            if ticks >= max_ticks:
                self.close()
                break
            now = self.clock()
            while i < len(pending) \
                    and (pending[i].arrival_time or 0.0) <= now:
                h = self.submit(pending[i])
                handles[h.rid] = h
                i += 1
            self._pump()
            if virtual:
                self.clock.advance(self.cfg.tick_dt)
            ticks += 1
            if self._closed:
                break
        # anything still unresolved (closed mid-trace) is accounted for
        for h in handles.values():
            if not h.done:
                h._resolve(ServeResult(
                    "cancelled", h.rid, attempts=h.attempts,
                    error=RequestCancelled("trace ended")))
        return handles

    def results(self, handles: dict[int, RequestHandle],
                ) -> dict[int, ServeResult]:
        return {rid: h.result_nowait() for rid, h in handles.items()}


def _with_rid(req: Request, rid: int) -> Request:
    return dataclasses.replace(req, rid=rid)
