"""The serving stack's typed errors, the reference's hierarchy.

Everything the scheduler, the engine, the block allocator and the front
end raise on purpose derives from :class:`SchedulerError`; the builtin
types stay as secondary bases, so an ``except ValueError`` or ``except
RuntimeError`` still catches what it caught before.  A caller that wants
to degrade under load (queue, shed, retry) branches on the class:

  * **scheduler errors**, raised by ``ContinuousBatchingScheduler`` and
    ``ServeEngine`` on a request they cannot serve or a loop that does
    not drain.  ``PoolExhausted`` is transient (capacity returns when
    running requests retire); ``RequestTooLarge`` is permanent (the
    request can never fit this engine).
  * **front-end outcomes**, which ``ServeFrontend`` never lets out of its
    serve loop: they ride on each request's result (``ServeResult.error``),
    so an overloaded trace ends in typed rejections and expiries, not in
    an exception.
"""
from __future__ import annotations


class SchedulerError(Exception):
    """Base of every intentional serving-stack failure."""


class InvalidRequest(SchedulerError, ValueError):
    """A malformed request (empty prompt, ``max_tokens < 1``, a duplicate
    rid): a caller's bug, never load-dependent."""


class RequestTooLarge(InvalidRequest):
    """The request can never be served by this engine: its window exceeds
    ``max_len`` or its KV blocks exceed the whole pool."""


class BlockAllocatorError(SchedulerError, ValueError):
    """Block-allocator misuse: the caller's bookkeeping lost track of
    ownership.  Never load-dependent; it fails loudly rather than
    corrupt a refcount."""


class BlockNotLive(BlockAllocatorError):
    """``release``/``acquire`` of a block with no live reference: a
    double free, or an id the allocator never handed out."""


class BlockOutOfRange(BlockAllocatorError):
    """A block id the pool never owned, the reserved trash block 0
    included."""


class PoolExhausted(SchedulerError, RuntimeError):
    """No slot or no KV blocks can fund the request right now.  Transient:
    queue it (``run`` does) or apply backpressure (the front end does)."""


class SchedulerStalled(SchedulerError, RuntimeError):
    """The serve loop exceeded its dispatch budget (``max_steps``)
    without draining."""


# -- front-end outcomes (on ServeResult.error, never raised out of the
# serve loop) ---------------------------------------------------------------

class FrontendError(SchedulerError):
    """Base of the per-request front-end outcomes."""


class AdmissionRejected(FrontendError):
    """The front end refused the request; ``reason`` is the
    machine-readable cause (``queue_full``, ``shed``, ``too_large`` or
    ``closed``)."""

    def __init__(self, message: str, reason: str = "rejected"):
        super().__init__(message)
        self.reason = reason


class QueueFull(AdmissionRejected):
    """The bounded admission queue holds ``max_queue`` requests."""

    def __init__(self, message: str):
        super().__init__(message, reason="queue_full")


class LoadShed(AdmissionRejected):
    """Backpressure: the queue depth or the p99 time to first token
    crossed the shedding threshold."""

    def __init__(self, message: str):
        super().__init__(message, reason="shed")


class DeadlineExceeded(FrontendError):
    """The request's deadline passed: in the queue (never admitted) or
    mid-decode (cancelled with a partial, ``truncated`` completion)."""


class RequestCancelled(FrontendError):
    """The caller, a drain or a preemption cancelled the request."""


class FaultInjected(FrontendError):
    """A chaos-policy fault.  ``rid`` is the victim (None for a
    whole-step transient fault that harmed no request), ``point`` the
    injection site (``decode`` or ``chunk``).  Always retryable."""

    def __init__(self, message: str, rid: int | None = None,
                 point: str = "decode"):
        super().__init__(message)
        self.rid = rid
        self.point = point


class RetriesExhausted(FrontendError):
    """A retryable failure recurred past ``RetryPolicy.max_retries``."""
