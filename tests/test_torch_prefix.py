"""The port's prefix cache (``serve/kv_pool.py``: ``prefix_chain_hashes``,
``PrefixCache``, ``mask_shared_cols``, the recurrent snapshots; the
scheduler's admission, copy-on-write and registration) against the JAX
package's, and its own contract: sharing on == sharing off == the solo
``generate_loop``, bit for bit, for the dense, xLSTM and hybrid families
in ``pum``, ``int8`` and ``bf16`` (f32 activations, the ``torch``
backend), a warm rerun and the copy-on-write repeat included; after a
drain and a flush no block is live.

The host-side pieces are pure Python on both sides and must agree
exactly: the digests, every ``match``/``attach``/eviction/refcount of
one op sequence, the write table.  Across frameworks the schedulers are
held on one fixed trace a family in ``pum``: the JAX scheduler is built
here, fresh, with its prefix registration made to wait for the chunk
before it (``_JSchedRegistersAfterItsChunk``: the reference races with
its own async dispatch there); it must first equal its own oracle, then
the port's tokens and ``prefix_stats()`` must equal its.  An MoE config keeps only the leak-freedom contract:
its tail alone takes expert capacity, so its tokens may move.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_numpy
from repro.config import PUMConfig as JPUM, small_test_config as jsmall
from repro.models import lm as jlm
from repro.serve import ContinuousBatchingScheduler as JSched
from repro.serve import Request as JRequest
from repro.serve import kv_pool as jpool
from repro.serve import oracle_completion as joracle
from repro_torch import bridge, configs
from repro_torch.config import PUMConfig as TPUM, small_test_config as tsmall
from repro_torch.models import lm as tlm
from repro_torch.serve import (ContinuousBatchingScheduler, Request,
                               kv_pool as tpool, oracle_completion,
                               synthetic_workload)
from repro_torch.serve import scheduler as tsched

FAMILIES = {"dense": dict(qkv_bias=True, tie_embeddings=True),
            "xlstm": dict(xlstm_slstm_every=2),
            "hybrid": dict(attn_period=2)}
MODES = ["pum", "int8", "bf16"]
KW = dict(dtype="float32")
SCHED = dict(num_slots=2, max_len=24, kv_block_size=4, chunked_prefill=True)
# two full blocks of 4 shared; the whole prefix (a copy-on-write for a
# dense stack), a slice, two extensions and the whole prefix again,
# arriving while the first ones decode
PREFIX = [3, 1, 4, 1, 5, 9, 2, 6]
FIXED = [(PREFIX, 5, 0), (PREFIX[:6], 4, 0), (PREFIX + [5, 3, 5], 5, 1),
         (PREFIX + [8, 9, 7, 9, 3], 4, 3), (PREFIX, 5, 4)]


@pytest.fixture(scope="module")
def models():
    """JAX's raw params and the port's copy of the prepacked ones, a
    (family, mode) each, built on first use."""
    cache = {}

    def get(family, mode):
        if (family, mode) not in cache:
            jcfg = jsmall(pum=JPUM(mode=mode), **KW, **FAMILIES[family])
            raw = jlm.init_params(jcfg, jax.random.PRNGKey(0))
            tcfg = tsmall(pum=TPUM(mode=mode), **KW, **FAMILIES[family])
            params = bridge.params_from_numpy(
                to_numpy(jlm.prepack_for_serving(raw, jcfg)), tcfg,
                device="cpu")
            cache[family, mode] = dict(jcfg=jcfg, raw=raw, tcfg=tcfg,
                                       params=params)
        return cache[family, mode]
    return get


def _sched(m, **kw):
    return ContinuousBatchingScheduler(m["tcfg"], m["params"], device="cpu",
                                       **{**SCHED, **kw})


def _tokens(out):
    return {rid: c.tokens for rid, c in sorted(out.items())}


def _leak_free(sched):
    """Drain, then flush: no block is live, no entry left."""
    sched.drain()
    assert sched._alloc.live_blocks == sched.prefix_cached_blocks
    sched.flush_prefix_cache()
    assert sched._alloc.live_blocks == 0
    assert sched._alloc.free_blocks == sched.num_kv_blocks
    assert sched.prefix_stats()["entries"] == 0


# ---------------------------------------------------------------------------
# The host-side pieces, exactly the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bs", [1, 4, 16])
def test_chain_hashes_equal_the_reference(bs):
    rng = np.random.default_rng(bs)
    for root in ("", "ModelConfig(name='tiny')/bs=4"):
        for n in (0, bs - 1, bs, 3 * bs + 2):
            toks = rng.integers(0, 1 << 17, size=n).tolist()
            assert tpool.prefix_chain_hashes(toks, bs, root) == \
                jpool.prefix_chain_hashes(toks, bs, root)


def _both(n_blocks, block_size, capacity):
    ja, ta = jpool.BlockAllocator(n_blocks), tpool.BlockAllocator(n_blocks)
    return (ja, jpool.PrefixCache(ja, block_size, capacity)), \
        (ta, tpool.PrefixCache(ta, block_size, capacity))


def _same_state(j, t):
    (ja, jc), (ta, tc) = j, t
    assert ta.free_blocks == ja.free_blocks
    assert ta.live_blocks == ja.live_blocks
    assert [ta.refcount(i) for i in range(1, ta.num_blocks + 1)] == \
        [ja.refcount(i) for i in range(1, ja.num_blocks + 1)]
    assert len(tc) == len(jc) and tc.cached_blocks == jc.cached_blocks
    assert tc.evictable_blocks == jc.evictable_blocks
    assert list(tc._entries) == list(jc._entries)


def test_prefix_cache_lifecycle_equals_the_reference():
    """The op sequence of the JAX package's lifecycle, LRU, eviction and
    snapshot tests, on both caches side by side."""
    j, t = _both(8, 4, 8)

    def both(fn):
        want, got = fn(*j), fn(*t)
        assert got == want
        _same_state(j, t)
        return got

    toks = list(range(12))
    hs = t[1].hashes(toks)
    assert hs == j[1].hashes(toks)
    assert both(lambda a, c: c.match(hs)) == 0
    ids = both(lambda a, c: a.alloc(3))
    both(lambda a, c: c.register(hs, ids))
    both(lambda a, c: a.release(ids))
    for kw in (dict(), dict(limit=1)):
        both(lambda a, c: c.match(hs, **kw))
    both(lambda a, c: c.match(hs[:2]))
    got = both(lambda a, c: c.attach(hs))
    both(lambda a, c: c.evictable_margin(exclude=hs))
    both(lambda a, c: a.release(got))
    both(lambda a, c: c.match(c.hashes(toks[:4] + [99] * 8)))
    # LRU at capacity 2 over 4 blocks, in-use entries never evicted
    j, t = _both(4, 2, 2)
    h1, h2, h3 = (t[1].hashes(x) for x in ([1, 2], [3, 4], [5, 6]))
    for h in (h1, h2):
        b = both(lambda a, c: a.alloc(1))
        both(lambda a, c: c.register(h, b))
        both(lambda a, c: a.release(b))
    both(lambda a, c: a.release(c.attach(h1)))
    b3 = both(lambda a, c: a.alloc(1))
    both(lambda a, c: c.register(h3, b3))
    both(lambda a, c: a.release(b3))
    both(lambda a, c: [c.match(h) for h in (h1, h2, h3)])
    pinned = both(lambda a, c: c.attach(h1))
    assert both(lambda a, c: c.evict_blocks(10)) == 1
    both(lambda a, c: a.release(pinned))
    assert both(lambda a, c: c.flush()) == 1
    # snapshot-only entries: need_snapshot and limit, nothing pinned
    j, t = _both(4, 2, 8)
    hs = t[1].hashes(list(range(6)))
    both(lambda a, c: c.register(hs, [None] * 3,
                                 snapshots={0: "s0", 1: "s1"}))
    for kw in (dict(), dict(need_snapshot=True),
               dict(need_snapshot=True, limit=1)):
        both(lambda a, c: c.match(hs, **kw))
    both(lambda a, c: c.snapshot_at(hs[1]))
    both(lambda a, c: c.attach(hs))
    both(lambda a, c: c.flush())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prefix_cache_random_ops_equal_the_reference(seed):
    """Random registrations, attachments, releases, evictions and
    flushes over few distinct prefixes (so hashes recur) through both
    caches: every result and the allocator's every refcount equal."""
    rng = np.random.default_rng(seed)
    j, t = _both(10, 2, 6)
    held: list[list[int]] = []
    prompts = [[int(x) for x in rng.integers(0, 3, size=6)]
               for _ in range(5)]
    for _ in range(80):
        op = int(rng.integers(0, 6))
        hs = t[1].hashes(prompts[int(rng.integers(0, len(prompts)))])
        if op == 0:                          # a prefill registers its blocks
            got = [x.alloc(len(hs)) for x in (j[0], t[0])]
            assert got[0] == got[1]
            if got[1] is None:
                continue
            res = [c.register(hs, got[1]) for c in (j[1], t[1])]
            assert res[0] == res[1]
            held.append(got[1])
        elif op == 1:                        # an admission attaches a match
            n = [c.match(hs) for c in (j[1], t[1])]
            assert n[0] == n[1]
            got = [c.attach(hs[:n[1]]) for c in (j[1], t[1])]
            assert got[0] == got[1]
            held.append(got[1])
        elif op == 2 and held:               # a request retires
            ids = held.pop(int(rng.integers(0, len(held))))
            j[0].release(ids), t[0].release(ids)
        elif op == 3:
            n = int(rng.integers(0, 4))
            res = [c.evict_blocks(n, exclude=hs[:1]) for c in (j[1], t[1])]
            assert res[0] == res[1]
        elif op == 4:
            res = [c.evictable_margin(exclude=hs) for c in (j[1], t[1])]
            assert res[0] == res[1]
        else:
            limit = int(rng.integers(0, 4))
            res = [c.match(hs, limit=limit) for c in (j[1], t[1])]
            assert res[0] == res[1]
        _same_state(j, t)
    for ids in held:
        j[0].release(ids), t[0].release(ids)
    assert j[1].flush() == t[1].flush()
    _same_state(j, t)
    assert t[0].live_blocks == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_shared_cols_equals_jax(seed):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 40, size=(5, 7)).astype(np.int32)
    shared = rng.integers(0, 9, size=(5,)).astype(np.int32)
    want = np.asarray(jpool._mask_shared_cols(jnp.asarray(table),
                                              jnp.asarray(shared)))
    got = tpool.mask_shared_cols(torch.from_numpy(table),
                                 torch.from_numpy(shared))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("family", ["xlstm", "hybrid"])
def test_snapshot_restores_bit_for_bit(family):
    """A snapshot is a copy (the rows advancing after it leave it as it
    was) and restores the slot's rows bit for bit, in place, leaving the
    other slots and the pools untouched."""
    cfg = tsmall(**KW, **FAMILIES[family])
    states = tlm.init_paged_state(cfg, 3, 16, num_blocks=4, block_size=4,
                                  device="cpu")
    g = torch.Generator().manual_seed(0)
    for st in states:
        for t in st.values():
            t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    snap = tpool.snapshot_slot_recurrent(states, 1)
    want = [{k: t.clone() for k, t in st.items()} for st in states]
    addrs = [[t.data_ptr() for t in st.values()] for st in states]
    for st in states:                        # advance every row in place
        for t in st.values():
            t.add_(1)
    assert all(torch.equal(sn[k], w[k][1:2]) for sn, w in zip(snap, want)
               for k in sn)
    tpool.restore_slot_recurrent(states, snap, 1)
    assert [[t.data_ptr() for t in st.values()] for st in states] == addrs
    for st, w, sn in zip(states, want, snap):
        for k, t in st.items():
            if sn:
                assert torch.equal(t[1], w[k][1])
                assert torch.equal(t[0], w[k][0] + 1)
            else:                            # a pool: no snapshot, moved on
                assert torch.equal(t, w[k] + 1)


def test_max_snapshots_drops_the_lru_snapshot():
    """Past ``max_snapshots`` a registration frees the LRU entry's
    snapshot and keeps the entry: the chain still matches through it,
    and a match that needs a snapshot resumes at the deepest one left."""
    alloc = tpool.BlockAllocator(4)
    cache = tpool.PrefixCache(alloc, 2, 8, max_snapshots=2)
    snap = [{"c": torch.zeros(1, 3)}, {}]
    hs = cache.hashes(list(range(8)))
    cache.register(hs[:3], [None] * 3, snapshots={0: snap, 1: snap,
                                                  2: snap})
    assert len(cache) == 3 and cache.snapshots == 2
    assert cache.snapshot_bytes == 2 * 12
    assert [cache.snapshot_at(h) is not None for h in hs[:3]] == \
        [False, True, True]
    cache.register(hs, [None] * 4, snapshots={3: snap})
    assert cache.snapshots == 2 and cache.snapshot_at(hs[1]) is None
    assert cache.match(hs) == 4
    assert cache.match(hs, need_snapshot=True, limit=2) == 0
    assert cache.match(hs, need_snapshot=True) == 4
    assert cache.drop_snapshot() and cache.drop_snapshot()
    assert not cache.drop_snapshot() and cache.snapshot_bytes == 0
    with pytest.raises(ValueError):
        tpool.PrefixCache(alloc, 2, 8, max_snapshots=0)


# ---------------------------------------------------------------------------
# The scheduler: sharing on == off == the solo oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sharing_on_equals_off_and_oracle(models, family, mode):
    """A shared-prefix trace served twice with the cache (cold, then
    warm, where every prefix hits) and once without: every completion of
    the three runs equals its request alone through ``generate_loop``;
    leak-free after."""
    m = models(family, mode)
    on, off = _sched(m, prefix_cache=True), _sched(m)
    reqs = synthetic_workload(5, m["tcfg"].vocab_size, min_prompt=1,
                              max_prompt=10, max_new=6,
                              mean_interarrival=1.0, shared_prefix_len=8,
                              seed=29)
    cold, warm, plain = (_tokens(s.run(reqs)) for s in (on, on, off))
    want = {r.rid: oracle_completion(on.engine, r) for r in reqs}
    assert cold == warm == plain == want
    stats = on.prefix_stats()
    assert stats["hits"] > 0 and stats["tokens_skipped"] > 0
    assert all(v == 0 for v in off.prefix_stats().values())
    _leak_free(on)


@pytest.mark.parametrize("bs", [1, 4, 16])
def test_cow_full_prompt_repeat(models, bs):
    """A 16-token prompt (whole blocks at 1, 4 and 16) served, then
    served again twice, one greedy and one sampled: the repeats copy the
    cached last block and re-run the last token there, and leave the
    shared block as the first request wrote it; every completion equals
    its solo run."""
    m = models("dense", "pum")
    sched = _sched(m, kv_block_size=bs, prefix_cache=True)
    prompt = [(i * 7 + 3) % m["tcfg"].vocab_size for i in range(16)]
    first = sched.run([Request(prompt, max_tokens=5, seed=9, rid=0)])
    pool = [t.clone() for st in sched.states for t in st.values()]
    cached = [e.block for e in sched._prefix._entries.values()]
    reqs = [Request(prompt, max_tokens=5, seed=9, rid=0),
            Request(prompt, max_tokens=4, temperature=0.6, seed=10, rid=1,
                    arrival=1)]
    out = sched.run(reqs)
    assert out[0].tokens == first[0].tokens
    for r in reqs:
        assert out[r.rid].tokens == oracle_completion(sched.engine, r)
    stats = sched.prefix_stats()
    assert stats["hits"] == 2 and stats["tokens_skipped"] == 2 * 15
    assert stats["blocks_shared"] == 2 * (16 // bs)
    # the cached blocks hold what the first request wrote, bit for bit
    after = [t for st in sched.states for t in st.values()]
    for before, now in zip(pool, after):
        assert torch.equal(now[cached], before[cached])
    _leak_free(sched)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cancel_mid_decode_leaks_nothing(models, family):
    """Cancelling a request that decodes against shared blocks releases
    its references only: the peer sharing its prefix still gives its
    solo tokens, and a drain and a flush leave no block live."""
    m = models(family, "pum")
    sched = _sched(m, prefix_cache=True)
    r0 = Request(PREFIX + [5], max_tokens=12, seed=41, rid=0)
    r1 = Request(PREFIX + [8, 9], max_tokens=12, seed=42, rid=1)
    assert sched.start_request(r0, 0) is None
    for step in range(4):
        sched.tick(step)
    assert sched.start_request(r1, 4) is None
    assert sched.prefix_stats()["hits"] == 1
    for step in range(4, 8):
        sched.tick(step)
    comp0 = sched.cancel(0, 8)
    assert comp0.truncated and comp0.finish_reason == "cancelled"
    assert 0 < len(comp0.tokens) < 12
    assert comp0.tokens == oracle_completion(sched.engine, r0)[
        :len(comp0.tokens)]
    assert sched.cancel(0, 8) is None
    for step in range(8, 10):
        sched.tick(step)
    assert sched.in_flight() == [1]
    out = sched.drain(10)
    assert out[1].truncated and out[1].finish_reason == "truncated"
    assert out[1].tokens == oracle_completion(sched.engine, r1)[
        :len(out[1].tokens)]
    _leak_free(sched)


@pytest.mark.parametrize("family", ["xlstm", "hybrid"])
def test_snapshot_budget_bounds_the_snapshots(models, family, monkeypatch):
    """A budget of two snapshots (``snapshot_budget``; on the card half
    the memory free at the build): a 12-token prompt keeps the two
    deepest of its three block-edge snapshots and its repeat resumes 8
    tokens in; the sharing trace served past the budget frees LRU ones.
    The cache and the prefills in flight never hold more than two, and
    on == off == the solo oracle, leak-free."""
    m = models(family, "pum")
    row = tpool.slot_recurrent_bytes(_sched(m).states)
    monkeypatch.setattr(tsched, "snapshot_budget",
                        lambda device: 2 * row + row // 2)
    on, off = _sched(m, prefix_cache=True), _sched(m)
    assert on._prefix.max_snapshots == 2
    held = []
    take = tpool.snapshot_slot_recurrent

    def counted(states, slot):
        held.append(on._prefix.snapshots
                    + sum(len(p.snaps) for p in on._prefills.values()))
        return take(states, slot)
    monkeypatch.setattr(tpool, "snapshot_slot_recurrent", counted)
    req = Request([(i * 5 + 2) % m["tcfg"].vocab_size for i in range(12)],
                  max_tokens=4, seed=7, rid=0)
    first = on.run([req])[0].tokens
    hs = on._prefix.hashes(req.prompt)
    assert [on._prefix.snapshot_at(h) is not None for h in hs] == \
        [False, True, True]
    assert on.run([req])[0].tokens == first == \
        oracle_completion(on.engine, req)
    assert (on.prefix_stats()["hits"],
            on.prefix_stats()["tokens_skipped"]) == (1, 8)
    reqs = synthetic_workload(5, m["tcfg"].vocab_size, min_prompt=1,
                              max_prompt=10, max_new=6,
                              mean_interarrival=1.0, shared_prefix_len=8,
                              seed=29)
    got, warm, want = (_tokens(s.run(reqs)) for s in (on, on, off))
    assert got == warm == want == {r.rid: oracle_completion(on.engine, r)
                                   for r in reqs}
    assert on.prefix_stats()["hits"] > 1
    assert len(held) > 3 and max(held) < 2 and on._prefix.snapshots <= 2
    _leak_free(on)


def test_cache_full_of_entries_serves_and_leaks_nothing(models):
    """Ten distinct 8-token prompts on an xLSTM stack (two snapshot-only
    entries each, no block to bound them) through a cache of 12 entries
    (``num_kv_blocks``), then back in reverse: registrations past the
    capacity evict the LRU entries, the cache holds its capacity and no
    more, every completion equals its solo run, the way back hits the
    prompts still cached and misses the evicted ones, and nothing
    leaks."""
    m = models("xlstm", "pum")
    sched = _sched(m, prefix_cache=True)
    cap = sched._prefix.capacity
    assert cap == sched.num_kv_blocks == 12
    v = m["tcfg"].vocab_size
    reqs = [Request([(7 * i + 3 * j + 1) % v for j in range(8)],
                    max_tokens=2, rid=i) for i in range(10)]
    want = {r.rid: oracle_completion(sched.engine, r) for r in reqs}
    sizes = []
    for r in reqs + reqs[::-1]:
        assert sched.run([r])[r.rid].tokens == want[r.rid]
        sizes.append(len(sched._prefix))
    assert max(sizes) == cap == sizes[-1]
    stats = sched.prefix_stats()
    assert 0 < stats["hits"] < len(reqs)
    _leak_free(sched)


class _JSchedRegistersAfterItsChunk(JSched):
    """The JAX scheduler, its prefix registration waiting for the chunk
    dispatched before it.  The reference widens ``_shared_cols`` in place
    right after dispatching a prompt's last chunk, which reads that host
    array through a zero-copy alias on JAX's CPU client; with async
    dispatch the chunk may then see the widened count and send its own
    last block's K/V to the trash block, so its tokens part from its
    oracle now and then (one run in four on this trace)."""

    def _register_prefix(self, slot, pf):
        jax.block_until_ready(self.states)
        super()._register_prefix(slot, pf)


def _jax_run(m, reqs):
    js = _JSchedRegistersAfterItsChunk(m["jcfg"], m["raw"],
                                       kernel_backend="xla",
                                       prefix_cache=True, **SCHED)
    out = js.run([JRequest(p, n, arrival=a, rid=i)
                  for i, (p, n, a) in enumerate(reqs)])
    return js, _tokens(out), js.prefix_stats()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tokens_and_stats_equal_the_jax_scheduler(models, family):
    """The fixed trace in ``pum`` through a fresh JAX scheduler with the
    cache and through the port's: JAX equals its own oracle first, then
    the port gives its tokens and its ``prefix_stats()``."""
    m = models(family, "pum")
    js, want, jstats = _jax_run(m, FIXED)
    for rid, (p, n, _) in enumerate(FIXED):
        assert want[rid] == joracle(js.engine, JRequest(p, n))
    assert jstats["hits"] > 0
    sched = _sched(m, prefix_cache=True)
    got = _tokens(sched.run([Request(p, n, arrival=a, rid=i)
                             for i, (p, n, a) in enumerate(FIXED)]))
    assert got == want
    assert sched.prefix_stats() == jstats
    _leak_free(sched)


def test_moe_serves_with_the_cache_and_leaks_nothing():
    """OLMoE's reduced config (the MoE family) with the cache on: every
    request completes, the cache hits, the pool drains clean.  No token
    gate: the tail alone takes expert capacity."""
    cfg = configs.get_reduced("olmoe-1b-7b").replace(pum=TPUM(mode="pum"),
                                                     **KW)
    params = tlm.prepack_for_serving(
        tlm.init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu"), cfg)
    sched = ContinuousBatchingScheduler(cfg, params, device="cpu",
                                        prefix_cache=True, **SCHED)
    reqs = synthetic_workload(5, cfg.vocab_size, max_prompt=10, max_new=5,
                              mean_interarrival=1.0, shared_prefix_len=8,
                              seed=3)
    for _ in range(2):
        out = sched.run(reqs)
        assert sorted(out) == [r.rid for r in reqs]
        assert all(len(c.tokens) == 5 for c in out.values())
    assert sched.prefix_stats()["hits"] > 0
    _leak_free(sched)


def test_workload_prefix_keeps_the_plain_trace():
    """``shared_prefix_len=0`` draws the trace it drew before; with a
    prefix every prompt is a slice of it or extends it with the tokens
    drawn for it."""
    kw = dict(min_prompt=2, max_prompt=12, max_new=4, seed=5,
              temperature_choices=(0.0, 0.7))
    plain = synthetic_workload(6, 100, **kw)
    shared = synthetic_workload(6, 100, shared_prefix_len=8, **kw)
    prefix = max((r.prompt for r in shared), key=len)[:8]
    for a, b in zip(plain, shared):
        assert dataclasses.replace(a, prompt=b.prompt) == b
        assert len(b.prompt) == len(a.prompt)
        n = min(len(a.prompt), 8)
        assert b.prompt[:n] == prefix[:n]
        assert b.prompt[8:] == a.prompt[8:]
