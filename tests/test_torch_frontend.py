"""The port's resilient serving front end and fault tolerance against the
JAX package's, at the reference suite's shapes: ``small_test_config
(dtype="float32")`` in ``pum`` mode, 2 slots, KV blocks of 4, 12 blocks,
chunked prefill (``tests/test_frontend.py``, ``tests/test_chaos.py``).

  * **The error hierarchy**: the port's classes have the reference's
    names and bases, pair for pair; the old modules re-export them.
  * **Host modules, bit for bit**: ``RequestQueue`` under a seeded
    stream of pushes, pops, expiries and removals for each policy,
    ``RetryPolicy.next_delay``, ``ChaosPolicy.parse``, the
    ``ChaosInjector``'s hooks, victims and stalls for a fixed sequence
    of calls, ``MetricsRegistry`` (``Summary`` at its window edges
    included), ``StragglerDetector`` and ``HeartbeatMonitor``.  These
    are host code on the same numpy generators: equal, not close.
  * **The whole front end against JAX's**: one trace of the reference's
    ``synthetic_workload`` (Poisson arrivals, EOS off, greedy, random
    priorities, a deadline) carried field for field into the port's
    ``Request``s and served under the reference's ``STORM`` through
    JAX's ``ServeFrontend`` over its scheduler (``kernel_backend=
    "xla"``) and through the port's.  With EOS off and greedy decoding
    the tick structure does not depend on token values, so the per-rid
    status, attempts and token count, and every entry of the metrics
    snapshot (virtual-clock milliseconds included), must be equal; the
    tokens must agree outside near-ties (``agree_outside_near_ties``:
    up to a first difference at a step whose JAX top-2 logit margin is
    within 10x ``LOGIT_TOL`` = 1e-4, the tolerance
    ``tests/test_torch_scheduler.py`` states for ``pum``).  The
    reference's tick drops the completion of a request that finished at
    its first token when a later dispatch of the same tick faults (the
    request then expires at its deadline, or waits out ``max_ticks``);
    the port carries it to the next tick, and the JAX side here runs
    through ``_JSchedKeepsFinished``, which does the same.
  * **The port's own contracts, bit for bit**, under the reference's
    storm with EOS (30 %) and temperature 0.7 on: survivors equal their
    solo ``oracle_completion`` and the allocator's invariants hold, with
    and without the prefix cache; a seed replays; a retried stream never
    repeats a token; a victimless decode fault is a pure retry; chunk
    faults do no harm on contiguous windows; a trace at 4x capacity
    never raises; priority, EDF and FIFO order admission; queue-full
    and shed come back typed; deadlines expire in the queue and
    mid-decode, and a deadline beats a backoff hold; cancel, drain and
    preemption end in typed outcomes; the async stream equals the
    result; the front end serves a ``speculate_k=3`` scheduler with the
    tokens of k = 0; anything but an injected fault or a transient pool
    exhaustion goes out of ``_pump``.
"""
import asyncio
import dataclasses

import jax
import numpy as np
import pytest

from _torch_port import agree_outside_near_ties, jax_logits_along, to_numpy
from repro import ft as jft
from repro.config import PUMConfig as JPUM, small_test_config as jsmall
from repro.models import lm as jlm
from repro.serve import ChaosPolicy as JChaosPolicy
from repro.serve import ContinuousBatchingScheduler as JSched
from repro.serve import RetryPolicy as JRetryPolicy
from repro.serve import ServeFrontend as JFrontend
from repro.serve import VirtualClock as JClock
from repro.serve import chaos as jchaos
from repro.serve import errors as jerrors
from repro.serve import policies as jpolicies
from repro.serve import synthetic_workload as jworkload
from repro_torch import bridge, ft
from repro_torch.config import PUMConfig as TPUM, small_test_config as tsmall
from repro_torch.serve import (ChaosPolicy, ContinuousBatchingScheduler,
                               FaultInjected, FrontendError, InvalidRequest,
                               PoolExhausted, QueueEntry, Request,
                               RequestQueue, RequestTooLarge, RetryPolicy,
                               ServeFrontend, VirtualClock, chaos, errors,
                               oracle_completion)
from repro_torch.serve import engine as tengine
from repro_torch.serve import kv_pool as tkv_pool
from repro_torch.serve import scheduler as tscheduler

LOGIT_TOL = 1e-4
STORM = dict(decode_fault_rate=0.10, victim_fault_rate=0.08,
             chunk_fault_rate=0.08, stall_rate=0.08, stall_ticks=2)
SCHED = dict(num_slots=2, max_len=32, kv_block_size=4, num_kv_blocks=12,
             chunked_prefill=True)
KINDS = {"paged": SCHED,
         "contig": dict(num_slots=2, max_len=32, kv_block_size=0),
         "prefix": dict(SCHED, prefix_cache=True),
         "one_slot": dict(num_slots=1, max_len=32, kv_block_size=4,
                          num_kv_blocks=8, chunked_prefill=True),
         "spec": dict(SCHED, speculate_k=3)}
VOCAB = 256


class _JSchedKeepsFinished(JSched):
    """The JAX scheduler, a completion at a request's first token kept
    past a fault later in the same tick.  The reference's ``tick``
    collects those completions in a local dict, which a raise from a
    later slot's chunk hook or from the decode hook throws away: the
    front end never resolves the request.  The port holds them for the
    next tick; so does this subclass."""

    def _feed_prefills(self, step, out, fault_hook=None):
        out.update(getattr(self, "_held", {}))
        self._held = out
        return super()._feed_prefills(step, out, fault_hook)

    def tick(self, step=0, fault_hook=None):
        res = super().tick(step, fault_hook)
        self._held = {}
        return res


@pytest.fixture(scope="module")
def world():
    """JAX's scheduler (``xla``) and the port's schedulers on the same
    weights, carried across by the bridge; each port scheduler is built
    once and shared by every case (each leaves it drained)."""
    jcfg = jsmall(dtype="float32", pum=JPUM(mode="pum"))
    raw = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tsmall(dtype="float32", pum=TPUM(mode="pum"))
    params = bridge.params_from_numpy(
        to_numpy(jlm.prepack_for_serving(raw, jcfg)), tcfg, device="cpu")
    scheds: dict = {}

    def sched(kind="paged"):
        if kind not in scheds:
            scheds[kind] = ContinuousBatchingScheduler(
                tcfg, params, device="cpu", **KINDS[kind])
        return scheds[kind]

    return dict(jcfg=jcfg, raw=raw, tcfg=tcfg, sched=sched,
                jsched=_JSchedKeepsFinished(jcfg, raw, kernel_backend="xla",
                                            **SCHED),
                oracles={})


def oracle(world, req):
    """``req``'s solo tokens through the port's per-token loop, cached
    by the fields they depend on."""
    key = (tuple(req.prompt), req.max_tokens, req.temperature, req.seed,
           req.eos_id)
    if key not in world["oracles"]:
        world["oracles"][key] = oracle_completion(world["sched"]().engine,
                                                  req)
    return world["oracles"][key]


def to_port(reqs):
    """The reference's requests carried field for field."""
    return [Request(**{f.name: getattr(r, f.name)
                       for f in dataclasses.fields(Request)}) for r in reqs]


def assert_clean(sched):
    """No request in flight, no live block but the prefix cache's (each
    at refcount 1, the free list and the cache partitioning the pool),
    the tables scrubbed."""
    assert sched.in_flight() == [] and not sched._prefills
    assert not sched._active.any()
    if not sched.paged:
        return
    alloc = sched._alloc
    cached = sorted(e.block for e in sched._prefix._entries.values()
                    if e.block is not None) if sched._prefix else []
    assert alloc.live_blocks == len(cached) == sched.prefix_cached_blocks
    assert all(alloc.refcount(b) == 1 for b in cached)
    free = list(alloc._free)
    assert len(set(free)) == len(free)
    assert sorted(free + cached) == list(range(1, sched.num_kv_blocks + 1))
    assert (sched._block_table == 0).all()
    assert all(not b for b in sched._slot_blocks)


def pump_until(fe, handles, ticks=400):
    for _ in range(ticks):
        fe._pump()
        fe.clock.advance(0.01)
        if all(h.done for h in handles):
            return


def drain_stream(handle):
    toks = []
    while not handle._stream.empty():
        t = handle._stream.get_nowait()
        if t is not None:
            toks.append(t)
    return toks


# ---------------------------------------------------------------------------
# The error hierarchy
# ---------------------------------------------------------------------------

ERRORS = sorted(n for n, v in vars(jerrors).items()
                if isinstance(v, type) and issubclass(v, Exception))


def test_error_hierarchy_matches_reference():
    port = sorted(n for n, v in vars(errors).items()
                  if isinstance(v, type) and issubclass(v, Exception))
    assert port == ERRORS and len(ERRORS) == 16
    for a in ERRORS:
        assert [b.__name__ for b in getattr(errors, a).__mro__] == \
            [b.__name__ for b in getattr(jerrors, a).__mro__], a
        for b in ERRORS:
            assert issubclass(getattr(errors, a), getattr(errors, b)) == \
                issubclass(getattr(jerrors, a), getattr(jerrors, b)), (a, b)
    # the old homes re-export the one hierarchy
    assert tengine.RequestTooLarge is tscheduler.RequestTooLarge \
        is errors.RequestTooLarge
    assert tscheduler.InvalidRequest is errors.InvalidRequest
    assert tscheduler.PoolExhausted is errors.PoolExhausted
    assert tscheduler.SchedulerStalled is errors.SchedulerStalled
    assert tkv_pool.BlockNotLive is errors.BlockNotLive
    assert tkv_pool.BlockOutOfRange is errors.BlockOutOfRange
    assert issubclass(tkv_pool.BlockAllocatorError, errors.SchedulerError)
    with pytest.raises(errors.SchedulerError):
        tkv_pool.BlockAllocator(4).release([2])
    rej = errors.QueueFull("full")
    assert rej.reason == "queue_full" and isinstance(rej, FrontendError)
    assert errors.LoadShed("x").reason == "shed"
    f = errors.FaultInjected("f", rid=3, point="chunk")
    assert (f.rid, f.point) == (3, "chunk")


def test_too_large_is_rejected_typed_and_invalid_raises(world):
    sched = world["sched"]()
    with pytest.raises(InvalidRequest):       # caught where the reference
        sched.validate_request(Request(list(range(30)), max_tokens=30))
    fe = ServeFrontend(sched, clock=VirtualClock())
    h = fe.submit(Request(list(range(30)), max_tokens=30, rid=0))
    r = h.result_nowait()
    assert r.status == "rejected" and r.error.reason == "too_large"
    assert isinstance(r.error, errors.AdmissionRejected)
    with pytest.raises(InvalidRequest):
        fe.submit(Request([], max_tokens=4, rid=1))        # a caller bug
    with pytest.raises(InvalidRequest):
        fe.submit(Request([1], max_tokens=0, rid=2))
    assert fe.metrics.snapshot()["serve.rejected"] == 1
    # the window check of the engine raises the same class
    with pytest.raises(RequestTooLarge):
        sched.engine.check_window(30, 30)
    assert_clean(sched)


# ---------------------------------------------------------------------------
# Host modules, bit for bit
# ---------------------------------------------------------------------------

def _queue_ops(mod, policy, seed):
    """A seeded stream of queue operations through ``mod``'s
    ``RequestQueue``: what each returns, rid by rid."""
    rng = np.random.default_rng(seed)
    q = mod.RequestQueue(maxlen=6, policy=policy)
    log, now, rid = [], 0.0, 0
    for _ in range(200):
        op = rng.integers(0, 5)
        now += float(rng.uniform(0, 0.05))
        if op <= 1:
            dl = None if rng.random() < 0.3 else now + float(
                rng.uniform(0.01, 0.3))
            e = mod.QueueEntry(
                req=mod.Request([1, 2], max_tokens=2, rid=rid),
                priority=int(rng.integers(0, 3)), deadline=dl, enq_time=now,
                not_before=now + float(rng.uniform(0, 0.1))
                if rng.random() < 0.3 else 0.0)
            log.append(("push", rid, q.push(e)))
            rid += 1
        elif op == 2:
            e = q.pop_ready(now)
            log.append(("pop", None if e is None else e.req.rid))
        elif op == 3:
            log.append(("expire", [e.req.rid for e in q.expire(now)]))
        else:
            e = q.remove(int(rng.integers(0, rid + 1)))
            log.append(("remove", None if e is None else e.req.rid))
        log.append(("len", len(q), q.full(),
                    None if q.peek() is None else q.peek().req.rid))
    log.append(("drain", [e.req.rid for e in q.drain()]))
    return log


class _JQueueMod:
    RequestQueue = jpolicies.RequestQueue
    QueueEntry = jpolicies.QueueEntry
    Request = jpolicies.Request


class _TQueueMod:
    RequestQueue = RequestQueue
    QueueEntry = QueueEntry
    Request = Request


@pytest.mark.parametrize("policy", ["fifo", "priority", "edf"])
def test_request_queue_matches_reference(policy):
    for seed in range(3):
        want = _queue_ops(_JQueueMod, policy, seed)
        assert _queue_ops(_TQueueMod, policy, seed) == want
        assert {op[0] for op in want} >= {"push", "pop", "expire"}
    with pytest.raises(ValueError, match="unknown queue policy"):
        RequestQueue(4, "lifo")


def test_retry_policy_and_clock_match_reference():
    for kw in (dict(), dict(seed=7, jitter=0.3, backoff_s=0.02),
               dict(jitter=0.0, multiplier=3.0), dict(max_retries=0)):
        t, j = RetryPolicy(**kw), JRetryPolicy(**kw)
        assert [t.next_delay(a) for a in range(1, 9)] == \
            [j.next_delay(a) for a in range(1, 9)]
        assert [t.should_retry(a) for a in range(4)] == \
            [j.should_retry(a) for a in range(4)]
    c = VirtualClock(1.5)
    assert c() == 1.5 and c.advance(0.25) == 1.75
    with pytest.raises(ValueError, match="backwards"):
        c.advance(-1)


CHAOS_SPECS = ["seed=7,fault=0.05,victim=0.02,chunk=0.1,stall=0.2,"
               "stall_ticks=5,latency_ms=40", "off", "", "seed=3,latency=0.5",
               "latency_ms=10,latency=0.25", "fault=0.1"]


@pytest.mark.parametrize("spec", CHAOS_SPECS)
def test_chaos_policy_parse_matches_reference(spec):
    t, j = ChaosPolicy.parse(spec), jchaos.ChaosPolicy.parse(spec)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.enabled == j.enabled


@pytest.mark.parametrize("spec", ["explode=1.0", "fault"])
def test_chaos_policy_parse_errors_match_reference(spec):
    with pytest.raises(ValueError) as te:
        ChaosPolicy.parse(spec)
    with pytest.raises(ValueError) as je:
        jchaos.ChaosPolicy.parse(spec)
    assert str(te.value) == str(je.value)


def _injector_calls(mod, policy):
    """A fixed sequence of calls on ``mod``'s injector: hooks raised,
    victims, stalls, latencies."""
    inj = mod.ChaosInjector(policy)
    log = []
    for tick in range(300):
        log.append(("stall", inj.stalled(tick)))
        log.append(("lat", inj.latency()))
        for point, rid in (("chunk", tick % 5), ("decode", None)):
            try:
                inj.fault_hook(point, rid)
                log.append((point, None))
            except Exception as e:
                log.append((point, type(e).__name__, e.rid, e.point))
        log.append(("victim", inj.pick_victim([tick % 7, 11, 3])))
        log.append(("victim", inj.pick_victim([])))
    return log, inj.injected


def test_chaos_injector_matches_reference():
    kw = dict(seed=5, decode_fault_rate=0.1, victim_fault_rate=0.2,
              chunk_fault_rate=0.15, stall_rate=0.05, stall_ticks=3,
              step_latency_s=0.04, latency_rate=0.3)
    t = _injector_calls(chaos, ChaosPolicy(**kw))
    j = _injector_calls(jchaos, jchaos.ChaosPolicy(**kw))
    assert t == j
    assert t[1] > 0 and any(e[0] == "victim" and e[1] is not None
                            for e in t[0])
    assert any(e == ("stall", True) for e in t[0])


def _metrics_run(mod):
    reg = mod.MetricsRegistry()
    c, g = reg.counter("a.c", "help"), reg.gauge("b.g")
    assert reg.counter("a.c") is c
    c.inc()
    c.inc(2.5)
    g.set(4)
    g.add(-1.5)
    sums = {w: reg.summary(f"s{w}", window=w) for w in (1, 4, 512)}
    snaps = [reg.snapshot()]
    for v in (5.0, 1.0, 3.0, 2.0, 9.0, 0.5, 7.0):
        for s in sums.values():
            s.observe(v)
        snaps.append(reg.snapshot())
    pct = [s.percentile(q) for s in sums.values()
           for q in (0.0, 0.25, 0.5, 0.99, 1.0)]
    errs = []
    for fn in (lambda: c.inc(-1), lambda: reg.gauge("a.c"),
               lambda: reg.summary("b.g")):
        try:
            fn()
        except ValueError as e:
            errs.append(str(e))
    return snaps, pct, errs, reg.names()


def test_metrics_registry_matches_reference():
    t, j = _metrics_run(ft), _metrics_run(jft)
    assert t == j
    assert len(t[2]) == 3
    empty = ft.monitor.Summary("e")
    assert empty.percentile(0.5) == 0.0 and empty.count == 0


def _straggler_run(mod):
    reg = mod.MetricsRegistry()
    det = mod.StragglerDetector(4, window=3, threshold=1.5, metrics=reg)
    rng = np.random.default_rng(0)
    out = [det.stragglers(), det.slowdown(0)]
    for step in range(12):
        for host in range(3):               # host 3 stays silent
            det.report(host, float(rng.uniform(0.9, 1.1))
                       * (2.0 if host == 1 and step > 4 else 1.0))
        out += [det.stragglers(), [det.slowdown(h) for h in range(4)]]
    return out, reg.snapshot()


def test_straggler_detector_matches_reference():
    t = _straggler_run(ft)
    assert t == _straggler_run(jft)
    assert [1] in t[0] and t[1]["ft.stragglers"] == 1


def _heartbeat_run(mod, root):
    reg = mod.MetricsRegistry()
    a = mod.HeartbeatMonitor(str(root), host_id=0, timeout_s=10.0,
                             metrics=reg)
    b = mod.HeartbeatMonitor(str(root), host_id=1, timeout_s=10.0)
    a.beat(now=100.0)
    b.beat(now=95.0)
    (root / "host_2.hb").write_text("garbled")
    out = [a.dead_hosts([0, 1, 2, 3], now=104.0),
           a.dead_hosts([0, 1, 2, 3], now=106.0)]
    return out, reg.snapshot()


def test_heartbeat_monitor_matches_reference(tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    t = _heartbeat_run(ft, tmp_path / "t")
    assert t == _heartbeat_run(jft, tmp_path / "j")
    assert t[0] == [[2, 3], [1, 2, 3]]


def test_preemption_handler_flag_and_signal_table():
    import signal
    pre = ft.PreemptionHandler(install=False)
    assert not pre.should_stop
    pre.request_stop()
    pre.request_stop()
    assert pre.should_stop
    before = signal.getsignal(signal.SIGTERM)
    pre = ft.PreemptionHandler()
    assert signal.getsignal(signal.SIGTERM) == pre._on_signal
    pre.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before


# ---------------------------------------------------------------------------
# The whole front end against the reference's
# ---------------------------------------------------------------------------

def _frontend_kw(seed, policy, retry_cls, chaos_cls):
    return dict(max_queue=16, policy=policy,
                retry=retry_cls(max_retries=4, backoff_s=0.02, seed=seed),
                chaos=chaos_cls(seed=seed, **STORM))


@pytest.mark.parametrize("seed,policy", [(0, "edf"), (1, "priority")])
def test_frontend_storm_matches_jax(world, seed, policy):
    jtrace = jworkload(10, VOCAB, max_prompt=6, max_new=8, eos_rate=0.0,
                       temperature_choices=(0.0,), poisson_rate=150.0,
                       priority_choices=(0, 1, 2), deadline_ms=300.0,
                       seed=seed + 100)
    jfe = JFrontend(world["jsched"], clock=JClock(),
                    **_frontend_kw(seed, policy, JRetryPolicy,
                                   JChaosPolicy))
    jres = jfe.results(jfe.serve_trace(jtrace))
    sched = world["sched"]()
    fe = ServeFrontend(sched, clock=VirtualClock(),
                       **_frontend_kw(seed, policy, RetryPolicy,
                                      ChaosPolicy))
    res = fe.results(fe.serve_trace(to_port(jtrace)))
    assert sorted(res) == sorted(jres) == [r.rid for r in jtrace]
    assert {r: (v.status, v.attempts, len(v.tokens))
            for r, v in res.items()} == \
        {r: (v.status, v.attempts, len(v.tokens)) for r, v in jres.items()}
    assert fe.metrics.snapshot() == jfe.metrics.snapshot()
    assert fe.chaos.injected == jfe.chaos.injected > 0
    eng = world["jsched"].engine
    for r in jtrace:
        want = jres[r.rid].tokens
        if want:
            scores = jax_logits_along(eng, list(r.prompt), want)
            agree_outside_near_ties(res[r.rid].tokens, want, scores,
                                    LOGIT_TOL, 0.0)
    assert_clean(sched)


def test_first_token_finish_survives_a_later_fault(world):
    """A request that finishes at its first token keeps its completion
    when a later dispatch of the same tick faults: it comes out with the
    next tick (the reference's tick drops it)."""
    sched = world["sched"]()
    one = Request([5, 6, 7], max_tokens=1, seed=1, rid=0)
    other = Request([1, 2, 3, 4, 5], max_tokens=4, seed=2, rid=1)
    sched.start_request(one, 0)
    sched.start_request(other, 0)
    calls = []

    def hook(point, rid):
        calls.append((point, rid))
        if point == "chunk" and rid == 1:
            raise FaultInjected("x", rid=1, point="chunk")

    with pytest.raises(FaultInjected):
        sched.tick(0, hook)
    assert calls == [("chunk", 0), ("chunk", 1)]
    res = sched.tick(1)
    assert res.completions[0].tokens == oracle(world, one)
    sched.drain(2)
    assert_clean(sched)


def test_fault_hook_moves_nothing(world):
    """A raise from the hook leaves every host array, the events, the
    block table and the prefix registration as they were; the dispatch
    runs as if never tried; ``cancel`` frees a copy-on-write's reserved
    block."""
    sched = world["sched"]("prefix")
    a = Request([9, 8, 7, 6, 5, 4, 3, 2], max_tokens=3, seed=4, rid=0)
    assert sched.run([a])[0].tokens == oracle(world, a)
    b = dataclasses.replace(a, rid=1)          # fully cached: a pending COW
    sched.start_request(b, 0)
    assert sched._prefills[0].cow_col >= 0
    chunks = sched.prefill_chunks
    names = ("_cur_tok", "_cache_index", "_keys", "_temp", "_active",
             "_gen", "_block_table", "_shared_cols")
    before = {n: getattr(sched, n).copy() for n in names}
    blocks = [list(x) for x in sched._slot_blocks]
    entries = len(sched._prefix)

    def boom(point, rid):
        raise FaultInjected("x", rid=rid, point=point)

    with pytest.raises(FaultInjected):
        sched.tick(0, boom)
    assert all(np.array_equal(getattr(sched, n), before[n]) for n in names)
    assert [list(x) for x in sched._slot_blocks] == blocks
    assert len(sched._prefix) == entries and sched._events == []
    assert sched._prefills[0].cow_col >= 0
    assert sched.prefill_chunks == chunks
    comp = sched.cancel(1, 0, reason="fault")
    assert comp.truncated and comp.tokens == []
    assert_clean(sched)
    # the decode hook: a live row, nothing moved by the raise
    sched.start_request(dataclasses.replace(a, rid=2), 0)
    sched.tick(0)
    before = {n: getattr(sched, n).copy() for n in names}

    def decode_boom(point, rid):
        if point == "decode":
            raise FaultInjected("x", rid=None, point="decode")

    with pytest.raises(FaultInjected):
        sched.tick(1, decode_boom)
    assert all(np.array_equal(getattr(sched, n), before[n]) for n in names)
    out = {}
    for step in range(2, 8):
        out.update(sched.tick(step).completions)
        if out:
            break
    assert out[2].tokens == oracle(world, a)
    sched.flush_prefix_cache()
    assert_clean(sched)


def test_other_errors_propagate_out_of_pump(world):
    """``_pump`` absorbs an injected fault and a transient pool
    exhaustion only; any other error, a ``RuntimeError`` such as a CUDA
    failure included, goes out to the caller."""
    sched = world["sched"]()
    fe = ServeFrontend(sched, clock=VirtualClock())
    h = fe.submit(Request([1, 2, 3], max_tokens=4, seed=3, rid=0))
    real_tick = sched.tick

    def failing(step, fault_hook=None):
        raise RuntimeError("CUDA error: an illegal memory access")

    sched.tick = failing
    try:
        with pytest.raises(RuntimeError, match="illegal memory"):
            fe._pump()
        sched.tick = lambda step, fault_hook=None: (_ for _ in ()).throw(
            PoolExhausted("not caught around tick"))
        with pytest.raises(PoolExhausted):
            fe._pump()
    finally:
        sched.tick = real_tick
    pump_until(fe, [h])
    assert h.result_nowait().tokens == oracle(world, h.req)
    assert_clean(sched)


# ---------------------------------------------------------------------------
# The port's own contracts under the reference's storm (EOS and
# temperature 0.7 on), bit for bit
# ---------------------------------------------------------------------------

def _run_storm(sched, seed, *, n=10, retry=None, policy=None,
               max_prompt=6, shared_prefix_len=0):
    fe = ServeFrontend(
        sched, clock=VirtualClock(), max_queue=16,
        retry=retry or RetryPolicy(max_retries=4, backoff_s=0.02, seed=seed),
        chaos=policy or ChaosPolicy(seed=seed, **STORM))
    trace = to_port(jworkload(n, VOCAB, max_prompt=max_prompt, max_new=8,
                              eos_rate=0.3, poisson_rate=150.0,
                              shared_prefix_len=shared_prefix_len,
                              seed=seed + 100))
    handles = fe.serve_trace(trace)
    return fe, trace, handles, fe.results(handles)


@pytest.mark.parametrize("kind", ["paged", "prefix"])
@pytest.mark.parametrize("seed", [0, 1])
def test_survivors_equal_oracle_and_no_leaks_under_storm(world, kind, seed):
    sched = world["sched"](kind)
    extra = dict(max_prompt=8, shared_prefix_len=8) if kind == "prefix" \
        else {}
    fe, trace, _, res = _run_storm(sched, seed, **extra)
    assert set(res) == {r.rid for r in trace}
    by_rid = {r.rid: r for r in trace}
    n_ok = 0
    for rid, r in res.items():
        assert r.status in ("ok", "failed", "expired", "rejected",
                            "cancelled")
        if r.status == "ok":
            n_ok += 1
            assert r.tokens == oracle(world, by_rid[rid])
        elif r.status == "failed":
            assert r.attempts > fe.cfg.retry.max_retries
    assert n_ok > 0 and fe.chaos.injected > 0
    snap = fe.metrics.snapshot()
    assert snap["serve.faults"] + snap["serve.stalls"] > 0
    if kind == "prefix":
        assert sched.prefix_stats()["hits"] > 0
    assert_clean(sched)
    if kind == "prefix":
        sched.flush_prefix_cache()
        assert sched._alloc.live_blocks == 0
        assert_clean(sched)


def test_same_seed_replays_bit_for_bit(world):
    sched = world["sched"]()
    _, _, _, res1 = _run_storm(sched, 2)
    _, _, _, res2 = _run_storm(sched, 2)
    assert {r: (v.status, v.tokens, v.attempts) for r, v in res1.items()} \
        == {r: (v.status, v.tokens, v.attempts) for r, v in res2.items()}
    assert_clean(sched)


def test_retried_streams_never_duplicate_tokens(world):
    sched = world["sched"]()
    retried_ok = 0
    for seed in (0, 1):
        _, trace, handles, res = _run_storm(
            sched, seed, policy=ChaosPolicy(seed=seed, victim_fault_rate=0.25),
            retry=RetryPolicy(max_retries=6, backoff_s=0.01, seed=seed))
        by_rid = {r.rid: r for r in trace}
        for rid, r in res.items():
            if r.status != "ok":
                continue
            assert drain_stream(handles[rid]) == oracle(world, by_rid[rid])
            retried_ok += r.attempts > 0
        assert_clean(sched)
    assert retried_ok > 0


def test_victimless_decode_fault_is_a_pure_retry(world):
    sched = world["sched"]()
    fe, trace, _, res = _run_storm(
        sched, 0, policy=ChaosPolicy(seed=0, decode_fault_rate=0.3))
    by_rid = {r.rid: r for r in trace}
    assert all(r.status == "ok" and r.attempts == 0 for r in res.values())
    for rid, r in res.items():
        assert r.tokens == oracle(world, by_rid[rid])
    assert fe.chaos.injected > 0
    assert_clean(sched)


def test_chunk_faults_on_contiguous_windows_are_harmless(world):
    sched = world["sched"]("contig")
    fe, trace, _, res = _run_storm(
        sched, 1, policy=ChaosPolicy(seed=1, chunk_fault_rate=0.9))
    by_rid = {r.rid: r for r in trace}
    assert all(r.status == "ok" for r in res.values())
    for rid, r in res.items():
        assert r.tokens == oracle(world, by_rid[rid])
    assert fe.chaos.injected == 0
    assert_clean(sched)


def test_overload_never_raises_and_metrics_report(world):
    sched = world["sched"]()
    fe = ServeFrontend(sched, clock=VirtualClock(), max_queue=4,
                       shed_depth=4, default_deadline_ms=400)
    trace = to_port(jworkload(16, VOCAB, max_prompt=6, max_new=8,
                              poisson_rate=500.0, eos_rate=0.0, seed=0))
    res = fe.results(fe.serve_trace(trace))
    assert set(res) == {r.rid for r in trace}
    assert {r.status for r in res.values()} <= {"ok", "rejected", "expired"}
    assert any(r.status != "ok" for r in res.values())
    by_rid = {r.rid: r for r in trace}
    for rid, r in res.items():
        if r.status == "ok":
            assert r.tokens == oracle(world, by_rid[rid])
        else:
            assert isinstance(r.error, FrontendError)
    snap = fe.metrics.snapshot()
    assert snap["serve.shed"] + snap["serve.rejected"] \
        + snap["serve.expired"] > 0
    assert snap["serve.ttft_ms_p50"] <= snap["serve.ttft_ms_p99"]
    assert_clean(sched)


def test_admission_stall_applies_backpressure(world):
    sched = world["sched"]()
    fe = ServeFrontend(sched, clock=VirtualClock(), max_queue=4,
                       default_deadline_ms=150.0,
                       chaos=ChaosPolicy(seed=0, stall_rate=1.0,
                                         stall_ticks=10_000))
    trace = [Request([1, 2, 3], max_tokens=4, seed=i, rid=i)
             for i in range(6)]
    res = fe.results(fe.serve_trace(trace))
    assert all(r.status in ("expired", "rejected") for r in res.values())
    snap = fe.metrics.snapshot()
    assert snap["serve.admitted"] == 0 and snap["serve.stalls"] > 0
    assert snap["serve.expired"] > 0
    assert_clean(sched)


@pytest.mark.parametrize("policy", ["priority", "edf", "fifo"])
def test_admission_policy_order(world, policy):
    sched = world["sched"]("one_slot")
    fe = ServeFrontend(sched, clock=VirtualClock(), policy=policy)
    reqs = [Request([1, 2, 3], max_tokens=4, seed=i, rid=i)
            for i in range(3)]
    kw = {"priority": lambda i: dict(priority=[0, 5, 1][i]),
          "edf": lambda i: dict(deadline_ms=[None, 5_000.0, 1_000.0][i]),
          "fifo": lambda i: {}}[policy]
    handles = {r.rid: fe.submit(r, **kw(r.rid)) for r in reqs}
    pump_until(fe, handles.values(), 200)
    res = fe.results(handles)
    assert all(r.status == "ok" for r in res.values())
    adm = {rid: r.completion.admitted_step for rid, r in res.items()}
    order = {"priority": (1, 2, 0), "edf": (2, 1, 0), "fifo": (0, 1, 2)}
    a, b, c = order[policy]
    assert adm[a] < adm[b] < adm[c]
    assert_clean(sched)


def test_queue_full_and_shed_are_typed_not_raised(world):
    sched = world["sched"]()
    fe = ServeFrontend(sched, clock=VirtualClock(), max_queue=3)
    handles = [fe.submit(Request([1, 2], max_tokens=4, seed=i, rid=i))
               for i in range(6)]
    rejected = [h for h in handles if h.done]
    assert len(rejected) == 3
    assert all(h.result_nowait().error.reason == "queue_full"
               for h in rejected)
    sched1 = world["sched"]("one_slot")
    fe2 = ServeFrontend(sched1, clock=VirtualClock(), max_queue=32,
                        shed_depth=1)
    hs = [fe2.submit(Request([1], max_tokens=2, seed=i, rid=i))
          for i in range(4)]
    shed = [h for h in hs if h.done]
    assert shed and all(h.result_nowait().error.reason == "shed"
                        for h in shed)
    assert fe2.metrics.snapshot()["serve.shed"] == len(shed)
    pump_until(fe, handles, 300)
    pump_until(fe2, hs, 300)
    assert_clean(sched)
    assert_clean(sched1)


def test_deadline_expires_in_queue_and_mid_decode(world):
    sched1 = world["sched"]("one_slot")
    fe = ServeFrontend(sched1, clock=VirtualClock())
    blocker = fe.submit(Request([1, 2, 3], max_tokens=12, seed=0, rid=0))
    doomed = fe.submit(Request([4, 5], max_tokens=4, seed=1, rid=1),
                       deadline_ms=20.0)
    pump_until(fe, [blocker, doomed], 300)
    rd = doomed.result_nowait()
    assert rd.status == "expired" and rd.completion is None
    assert isinstance(rd.error, errors.DeadlineExceeded)
    assert blocker.result_nowait().tokens == oracle(world, blocker.req)
    assert fe.metrics.snapshot()["serve.expired"] == 1
    assert_clean(sched1)
    sched = world["sched"]()
    fe = ServeFrontend(sched, clock=VirtualClock())
    long = Request([1, 2, 3], max_tokens=16, seed=3, rid=0)
    peer = Request([4, 5], max_tokens=16, seed=4, rid=1)
    hl = fe.submit(long, deadline_ms=80.0)
    hp = fe.submit(peer)
    pump_until(fe, [hl, hp])
    rl = hl.result_nowait()
    assert rl.status == "expired" and rl.completion.truncated
    want = oracle(world, long)
    assert 0 < len(rl.tokens) < len(want)
    assert rl.tokens == want[:len(rl.tokens)]
    assert hp.result_nowait().tokens == oracle(world, peer)
    assert_clean(sched)


def test_deadline_beats_backoff_hold(world):
    q = RequestQueue(maxlen=4)
    e = QueueEntry(req=Request([1], max_tokens=2, rid=7), deadline=1.0,
                   not_before=5.0)
    assert q.push(e)
    assert q.pop_ready(0.5) is None and len(q) == 1
    assert q.pop_ready(6.0) is None
    assert len(q) == 1 and not q.full()
    assert q.expire(6.0) == [e]
    assert len(q) == 0 and q.drain() == []
    # end to end: a victim re-queued under a backoff longer than its
    # deadline resolves expired, never dispatches
    sched = world["sched"]()
    fe = ServeFrontend(sched, clock=VirtualClock(),
                       retry=RetryPolicy(max_retries=2, backoff_s=10.0,
                                         jitter=0.0))
    h = fe.submit(Request([1, 2, 3], max_tokens=8, seed=11, rid=0),
                  deadline_ms=200.0)
    for _ in range(3):
        fe._pump()
        fe.clock.advance(0.01)
    assert not h.done and 0 in fe._inflight
    fe._fault_victim(0, FaultInjected("injected", rid=0, point="decode"),
                     fe.clock())
    assert not h.done and len(fe.queue) == 1
    assert fe.metrics.snapshot()["serve.retries"] == 1
    pump_until(fe, [h], 40)
    r = h.result_nowait()
    assert r.status == "expired" and "expired" in str(r.error)
    assert len(fe.queue) == 0
    assert_clean(sched)


def test_cancel_drain_and_preemption_end_typed(world):
    sched = world["sched"]()
    fe = ServeFrontend(sched, clock=VirtualClock())
    h = fe.submit(Request([1, 2, 3], max_tokens=16, seed=5, rid=0))
    for _ in range(6):
        fe._pump()
        fe.clock.advance(0.01)
    assert not h.done
    h.cancel()
    fe._pump()
    r = h.result_nowait()
    assert r.status == "cancelled" and r.completion.truncated
    assert r.tokens == oracle(world, h.req)[:len(r.tokens)]
    assert_clean(sched)
    # the scheduler's drain returns truncated prefixes
    r0 = Request([1, 2, 3], max_tokens=16, seed=6, rid=0)
    r1 = Request([4, 5], max_tokens=16, seed=7, rid=1)
    assert sched.start_request(r0, 0) is None
    assert sched.start_request(r1, 0) is None
    for step in range(5):
        sched.tick(step)
    out = sched.drain(5)
    for req in (r0, r1):
        comp = out[req.rid]
        assert comp.truncated and comp.finish_reason == "truncated"
        assert 0 < len(comp.tokens)
        assert comp.tokens == oracle(world, req)[:len(comp.tokens)]
    assert_clean(sched)
    # preemption closes the front end: every outcome typed
    pre = ft.PreemptionHandler(install=False)
    fe = ServeFrontend(sched, clock=VirtualClock(), preemption=pre)
    hs = [fe.submit(Request([1, 2, 3], max_tokens=16, seed=i, rid=i))
          for i in range(3)]
    for _ in range(4):
        fe._pump()
        fe.clock.advance(0.01)
    pre.request_stop()
    fe._pump()
    for h in hs:
        r = h.result_nowait()
        assert r.status == "cancelled"
        assert isinstance(r.error, errors.RequestCancelled)
        assert r.tokens == oracle(world, h.req)[:len(r.tokens)]
    h = fe.submit(Request([1], max_tokens=2, rid=99))
    assert h.result_nowait().error.reason == "closed"
    assert_clean(sched)


def test_async_stream_equals_result_and_oracle(world):
    sched = world["sched"]()

    async def scenario():
        fe = ServeFrontend(sched)                  # the real clock
        await fe.start()
        reqs = [Request([1, 2, 3], max_tokens=6, seed=9, rid=0,
                        temperature=0.7),
                Request([4, 5, 6, 7, 8], max_tokens=5, seed=2, rid=1)]
        hs = [fe.submit(r) for r in reqs]
        streamed = [[t async for t in h.stream()] for h in hs]
        res = [await h.result() for h in hs]
        await fe.stop()
        return reqs, streamed, res, fe.metrics.snapshot()

    reqs, streamed, res, snap = asyncio.run(scenario())
    for req, s, r in zip(reqs, streamed, res):
        assert r.status == "ok"
        assert s == r.tokens == oracle(world, req)
    assert snap["serve.tokens"] == 11 and snap["serve.ttft_ms_count"] == 2
    assert_clean(sched)


def test_contiguous_frontend_end_to_end(world):
    sched = world["sched"]("contig")
    fe = ServeFrontend(sched, clock=VirtualClock())
    trace = to_port(jworkload(5, VOCAB, max_prompt=5, max_new=5,
                              poisson_rate=200.0, seed=2))
    assert all(sched.blocks_needed(r) == 0 for r in trace)
    res = fe.results(fe.serve_trace(trace))
    by_rid = {r.rid: r for r in trace}
    assert all(r.status == "ok" for r in res.values())
    for rid, r in res.items():
        assert r.tokens == oracle(world, by_rid[rid])
    assert fe.metrics.snapshot()["serve.free_blocks"] == 0
    assert_clean(sched)


def test_frontend_over_speculative_scheduler(world):
    """``speculate_k=3``: the storm's survivors carry the tokens of
    k = 0 (each its solo oracle), and the acceptance gauges move."""
    sched = world["sched"]("spec")
    fe, trace, handles, res = _run_storm(sched, 0)
    by_rid = {r.rid: r for r in trace}
    n_ok = 0
    for rid, r in res.items():
        if r.status == "ok":
            n_ok += 1
            assert r.tokens == oracle(world, by_rid[rid])
            assert drain_stream(handles[rid]) == r.tokens
    assert n_ok > 0
    assert sched.step_programs()["spec"] == 1
    assert sched.step_programs()["decode"] == 0
    snap = fe.metrics.snapshot()
    assert snap["serve.spec.advance_per_step"] >= 1.0
    assert_clean(sched)


def test_scheduler_properties(world):
    sched = world["sched"]()
    assert sched.num_free_slots == 2 and sched.total_blocks == 12
    contig = world["sched"]("contig")
    assert contig.total_blocks == 0 and contig.num_free_slots == 2
    sched.start_request(Request([1, 2, 3], max_tokens=2, rid=0), 0)
    assert sched.num_free_slots == 1
    sched.drain(0)
    assert_clean(sched)
