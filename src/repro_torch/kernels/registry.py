"""The kernel-backend registry: one switch for every hand-written kernel.

  * :class:`KernelBackend` — ``torch`` (the plain PyTorch versions, the
    oracle role XLA plays in the JAX package) and ``cuda`` (the
    hand-written Hopper kernels under ``kernels/*/csrc``).
  * :func:`use_backend` — a context manager installing an ambient
    default plus per-kernel overrides (``use_backend("cuda",
    paged_attention="torch")``); frames nest, inner frames win, and the
    stack is thread-local.
  * :func:`resolve_backend` — per call: an explicit argument, else the
    ambient selection, else the tensor's device (``cuda`` for CUDA
    tensors, ``torch`` for CPU tensors).  A CPU tensor always takes the
    plain version; asking for ``cuda`` on one raises.  ``torch`` on a
    CUDA tensor is taken only when selected explicitly (the kernel
    comparisons in ``chip_smoke.py``).

The registry also holds the launch counters: each wrapper adds one to
its kernel's count where it launches the kernel, and nowhere else, so a
run can show that the main path went through the kernels (a launch
recorded while a CUDA graph is captured counts at each replay of the
graph, :func:`recording`), and each
card's properties (:func:`device_props`), from which the kernels'
launch plans are sized.
"""
from __future__ import annotations

import collections
import contextlib
import enum
import functools
import threading
import typing

import torch


class KernelBackend(enum.Enum):
    TORCH = "torch"
    CUDA = "cuda"

    def __str__(self) -> str:
        return self.value


class KernelTileError(ValueError):
    """A tensor the kernel cannot take (shape, type, layout, device)."""


def coerce_backend(value: KernelBackend | str | None,
                   ) -> KernelBackend | None:
    """Accept the enum, its string value, or None (= unset)."""
    if value is None or isinstance(value, KernelBackend):
        return value
    try:
        return KernelBackend(str(value).lower())
    except ValueError:
        raise ValueError(
            f"unknown kernel backend {value!r}; expected one of "
            f"{[b.value for b in KernelBackend]}") from None


_STATE = threading.local()


def _stack() -> list[tuple[KernelBackend | None,
                           dict[str, KernelBackend | None]]]:
    st = getattr(_STATE, "stack", None)
    if st is None:
        st = _STATE.stack = []
    return st


def get_backend(kernel: str | None = None) -> KernelBackend | None:
    """The ambient selection for ``kernel`` (innermost frame wins; a
    frame's per-kernel override beats its default), or None."""
    for default, overrides in reversed(_stack()):
        if kernel is not None and kernel in overrides:
            return overrides[kernel]
        if default is not None:
            return default
    return None


@contextlib.contextmanager
def use_backend(backend: KernelBackend | str | None = None,
                **per_kernel: KernelBackend | str | None):
    """Install an ambient backend default and/or per-kernel overrides."""
    frame = (coerce_backend(backend),
             {k: coerce_backend(v) for k, v in per_kernel.items()})
    st = _stack()
    st.append(frame)
    try:
        yield
    finally:
        st.pop()


def snapshot():
    """A context manager that installs this thread's current selection
    (every open :func:`use_backend` frame) in the thread it is entered
    in: the autograd engine runs a CUDA backward, and with it a
    checkpointed block's recomputation, on a thread of its own."""
    frames = list(_stack())

    @contextlib.contextmanager
    def restore():
        st = _stack()
        depth = len(st)
        st.extend(frames)
        try:
            yield
        finally:
            del st[depth:]

    return restore


def resolve_backend(tensor: torch.Tensor,
                    backend: KernelBackend | str | None = None, *,
                    kernel: str | None = None) -> KernelBackend:
    """Explicit ``backend`` > ambient selection > the tensor's device."""
    b = coerce_backend(backend)
    if b is None:
        b = get_backend(kernel)
    if tensor.device.type != "cuda":
        if b == KernelBackend.CUDA:
            raise KernelTileError(
                f"the cuda backend of {kernel or 'this kernel'} takes CUDA "
                f"tensors, got one on {tensor.device}")
        return KernelBackend.TORCH
    return KernelBackend.CUDA if b is None else b


# ---------------------------------------------------------------------------
# Launch counters
# ---------------------------------------------------------------------------

LAUNCHES: collections.Counter[str] = collections.Counter()


def _recorders() -> list[collections.Counter[str]]:
    rec = getattr(_STATE, "recorders", None)
    if rec is None:
        rec = _STATE.recorders = []
    return rec


def count_launch(kernel: str) -> None:
    """One launch of ``kernel``: into the innermost :func:`recording`
    counter when one is open, else into ``LAUNCHES``."""
    rec = _recorders()
    (rec[-1] if rec else LAUNCHES)[kernel] += 1


def reset_launches() -> None:
    LAUNCHES.clear()


@contextlib.contextmanager
def recording():
    """Count the launches issued inside into a counter of their own,
    kept out of ``LAUNCHES``: a CUDA graph's capture (the counter stays
    with the graph, and each replay adds it with :func:`add_launches`)
    and its warm-up (the counter is dropped)."""
    counter: collections.Counter[str] = collections.Counter()
    rec = _recorders()
    rec.append(counter)
    try:
        yield counter
    finally:
        rec.pop()


def add_launches(counts: collections.Counter[str]) -> None:
    """The launches of one replay of a captured graph."""
    LAUNCHES.update(counts)


# ---------------------------------------------------------------------------
# The card's own numbers, for the kernels' launch plans
# ---------------------------------------------------------------------------

class DeviceProps(typing.NamedTuple):
    """What a launch plan needs to know of the card."""
    sms: int             # streaming multiprocessors
    max_smem: int        # shared bytes one CTA may opt in to
    max_threads: int     # resident threads an SM holds


@functools.cache
def device_props(index: int) -> DeviceProps:
    """The properties of CUDA device ``index``, read from the card once
    per process and device."""
    p = torch.cuda.get_device_properties(index)
    return DeviceProps(p.multi_processor_count,
                       p.shared_memory_per_block_optin,
                       p.max_threads_per_multi_processor)
