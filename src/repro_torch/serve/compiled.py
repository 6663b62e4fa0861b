"""The compiled serving step: one step function at one input shape, run
on the card as the replay of one CUDA graph.

The port's counterpart of the reference's ``jax.jit`` of the slot-wise
decode step and of the batch-1 chunk prefill
(``src/repro/serve/scheduler.py``): the scheduler builds one
:class:`CompiledStep` for decode and one per distinct chunk length, once
for its lifetime, and every later call replays it.  A replay is one
host call for the 252 MVM launches, 36 attention calls and the small
ops of a step, which eager dispatch issues one by one from Python.

A step's inputs are a few small int32 tensors; a float input (a
sampling temperature) travels as its f32 bit pattern in an int32 lane
(``np.float32(t).view(np.int32)`` on the host, ``.view(torch.float32)``
in the step), so one buffer still holds them all.  They live in one
static buffer on the device, filled from one pinned host staging tensor
by a single non-blocking copy; the step's integer outputs come back packed
in one int32 tensor, by a single copy.  Anything else the step returns
(its logits) stays on the device, in ``CompiledStep.aux``, overwritten
by the next call of the same step.  A graph copies it, as its last
launches, into buffers of its own allocated outside the graphs' memory
pool: the graphs share that pool, and another step's replay may write
its temporaries where this step's outputs were captured.

On the CPU the same object runs the function eagerly on the same static
buffers: a CPU has no graphs.  On the card, ``graphs=False`` does the
same, which is the counterpart of running the reference under
``jax.disable_jit()``.  A capture or a replay that fails raises; nothing
returns quietly to eager dispatch.
"""
from __future__ import annotations

import collections
import gc
import math
import time
from collections.abc import Callable, Sequence

import numpy as np
import torch

from repro_torch.kernels import registry


class CompiledStep:
    """``fn`` at one input shape.

    ``fn(*inputs) -> (ints, *aux)``: ``inputs`` are int32 views of one
    static device buffer, of ``shapes``; ``ints`` is an int32 tensor that
    :meth:`read` copies to the host; ``aux`` stays on the device.

    With ``graphs`` on a CUDA device, :meth:`build` warms ``fn`` up on
    ``stream`` (outside capture the kernels' libraries load, their launch
    plans are cached and their shared-memory attributes are set), then
    captures it into a CUDA graph whose allocations come from ``pool``.
    Both run on the staged inputs, zeros until the first :meth:`stage`.
    The launches counted during capture are kept with the graph
    (``launches``) and added to ``registry.LAUNCHES`` at each replay; the
    warm-up's count nowhere.

    The warm-up runs the step once on the first call's inputs and the
    replay that follows runs it again, so a call must leave what one run
    leaves.  A step holds to this in one of two ways:

    * it is idempotent on its inputs: it writes only the cells of its
      inputs' rows and positions, with values its inputs fix (zero
      inputs write only the paged pool's trash block), and returns what
      it advances (a token, a key, a cache index) rather than updating
      its own inputs; :meth:`stage_from` hands those outputs to the next
      call.  K/V writes are so;
    * or it names the tensors it advances in place in ``advances``
      (a recurrent state: ``c <- f c + i v k^T`` done twice advances it
      twice), and :meth:`build` copies them before the warm-up and
      back after it, so the first replay advances them once.  This
      costs one copy at build and nothing a replay; the reference needs
      neither, its update being functional and its state donated.

    A step that counts or accumulates in place anything it does not
    name (a refcount, a rollback) would apply twice.
    ``tests/test_torch_cuda.py`` holds each step kind to the rule.
    """

    def __init__(self, fn: Callable, shapes: Sequence[tuple[int, ...]],
                 device: torch.device, *, graphs: bool = True, pool=None,
                 stream: torch.cuda.Stream | None = None,
                 advances: Sequence[torch.Tensor] = ()):
        self.fn = fn
        self.advances = list(advances)
        self.device = device
        self.graphs = graphs and device.type == "cuda"
        self._pool = pool
        self._stream = stream
        sizes = [math.prod(s) for s in shapes]
        ends = np.cumsum(sizes).tolist()
        self._slices = [slice(e - n, e) for n, e in zip(sizes, ends)]
        self._staging = torch.zeros(sum(sizes), dtype=torch.int32,
                                    pin_memory=device.type == "cuda")
        self._host = self._staging.numpy()
        self._buf = torch.zeros(sum(sizes), dtype=torch.int32, device=device)
        self.inputs = [self._buf[sl].view(shape)
                       for sl, shape in zip(self._slices, shapes)]
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: collections.Counter[str] = collections.Counter()
        self.build_seconds = 0.0
        self._ints: torch.Tensor | None = None
        self.aux: tuple[torch.Tensor, ...] = ()

    @torch.inference_mode()
    def build(self) -> None:
        """Warm up and capture (once); a no-op when running eagerly."""
        if not self.graphs or self.graph is not None:
            return
        t0 = time.perf_counter()
        side, cur = self._stream, torch.cuda.current_stream(self.device)
        before = [t.clone() for t in self.advances]
        side.wait_stream(cur)
        with torch.cuda.stream(side), registry.recording():
            _, *warm = self.fn(*self.inputs)
        cur.wait_stream(side)
        for t, b in zip(self.advances, before):
            t.copy_(b)
        keep = [torch.empty_like(a) for a in warm]
        del before, warm
        graph = torch.cuda.CUDAGraph()
        # no finalizer may run inside the capture: a dead object of an
        # earlier scheduler (a graph, a pinned staging buffer) collected
        # there may make CUDA calls that invalidate the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with registry.recording() as counts, \
                    torch.cuda.graph(graph, pool=self._pool, stream=side):
                self._ints, *aux = self.fn(*self.inputs)
                for k, a in zip(keep, aux):
                    k.copy_(a)
        finally:
            if collecting:
                gc.enable()
        self.aux = tuple(keep)
        self.graph = graph
        self.launches = counts
        torch.cuda.synchronize(self.device)
        self.build_seconds = time.perf_counter() - t0

    @torch.inference_mode()
    def stage(self, *values) -> None:
        """Fill the inputs: the host staging tensor, then one copy."""
        for sl, v in zip(self._slices, values):
            self._host[sl] = np.asarray(v).reshape(-1)
        self._buf.copy_(self._staging, non_blocking=True)

    @torch.inference_mode()
    def stage_from(self, values: torch.Tensor) -> None:
        """Fill the inputs from a tensor on the device, packed as they
        are (another step's :attr:`ints`): one device copy, nothing on
        the host."""
        self._buf.copy_(values)

    @property
    def ints(self) -> torch.Tensor:
        """The last call's integer outputs, on the device."""
        return self._ints

    @torch.inference_mode()
    def launch(self) -> None:
        """One step on the staged inputs: a replay, or eager dispatch."""
        if not self.graphs:
            self._ints, *aux = self.fn(*self.inputs)
            self.aux = tuple(aux)
            return
        self.graph.replay()
        registry.add_launches(self.launches)

    def read(self) -> np.ndarray:
        """The step's integer outputs: one copy, which waits for it."""
        return self._ints.cpu().numpy()

    def __call__(self, *values) -> np.ndarray:
        self.stage(*values)
        self.launch()
        return self.read()
