"""The port's speculative decoding (``serve/spec.py``, the mixers'
``collect_states``, ``kv_pool.spec_*``, ``engine.make_verify_step`` and
the scheduler's spec step) against the JAX package's, and its own
contract: with ``speculate_k > 0`` every request's tokens equal those of
the one-token path (the port's ``speculate_k = 0`` run) and JAX's solo
oracle, whatever the drafter proposes, and the pool (the trash block 0
excepted) and the recurrent rows end as a ``k = 0`` replay leaves them.

Small configs in f32 (``small_test_config(dtype="float32")``), JAX's
weights carried across by ``repro_torch.bridge``, the ``torch`` backend.

Tolerances:

  * the drafters, the draft matrix and the pool rollback are host
    Python or integer gathers and scatters on both sides: equal;
  * ``collect_states`` within the port: index t is t + 1 one-token
    steps bit for bit (the same per-token loop); against JAX within
    ``MIXER_TOL``, the bound ``tests/test_torch_ssm.py`` states for a
    mixer on equal inputs (f32 sums in another order, XLA's and torch's
    exp and log);
  * verify logits within ``LOGIT_TOL`` (``tests/test_torch_ssm.py``'s:
    an f32 difference can move an int8 activation step at a rounding
    edge); in ``pum`` and ``int8`` every integer accumulator of the
    port's verify step equals JAX's integer contraction of the same
    operands, and each position's logits equal the port's own
    one-token step bit for bit, which is what the token contract rests
    on.

MoE keeps only the leak-freedom contract: the k + 1 positions of every
row share the expert capacity, so a spec step drops otherwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_numpy
from repro.config import ModelConfig as JConfig
from repro.config import PUMConfig as JPUM, small_test_config as jsmall
from repro.core import bitslice as jbits
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.models import xlstm as jxl
from repro.serve import ContinuousBatchingScheduler as JSched
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.serve import kv_pool as jpool
from repro.serve import make_verify_step as jverify
from repro.serve import oracle_completion as joracle
from repro.serve import spec as jspec
from repro_torch import bridge
from repro_torch.config import ModelConfig as TConfig
from repro_torch.config import MoEConfig as TMoE
from repro_torch.config import PUMConfig as TPUM, small_test_config as tsmall
from repro_torch.core import pum_linear as tpl
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txl
from repro_torch.serve import (ContinuousBatchingScheduler, Request,
                               ServeEngine, kv_pool as tpool,
                               oracle_completion, synthetic_workload)
from repro_torch.serve import engine as tengine
from repro_torch.serve import spec as tspec

MIXER_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = 1e-3
FAMILIES = {"dense": dict(qkv_bias=True, tie_embeddings=True),
            "xlstm": dict(xlstm_slstm_every=2),
            "hybrid": dict(attn_period=2)}
KW = dict(dtype="float32")
SCHED = dict(num_slots=3, max_len=32, kv_block_size=4, chunked_prefill=True)
# (prompt, max_tokens, temperature, seed, arrival): a burst of three
# then two late arrivals, greedy and sampled; two prompt lengths (one
# chunk of 3, or chunks of 4 and 1), so the JAX oracle compiles two
# prefills a model
TRACE = [([3, 1, 4, 1, 5], 9, 0.0, 0, 0), ([9, 2, 6], 8, 0.7, 11, 0),
         ([5, 3, 5, 8, 9], 7, 0.0, 0, 0), ([2, 7, 1], 10, 1.0, 5, 2),
         ([1, 8, 2, 8, 1], 6, 0.0, 0, 3)]


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_cache():
    # the JAX package's verify-step compilations have segfaulted inside
    # XLA under an accumulated jit cache (tests/test_spec.py does the
    # same): start and end this module with a clean one
    jax.clear_caches()
    yield
    jax.clear_caches()


# the reference's prepack compiled (the same bits as its op-by-op
# dispatch, some ten times sooner); its engines take the packed params
_jax_prepack = jax.jit(jlm.prepack_for_serving, static_argnums=1)


@pytest.fixture(scope="module")
def models():
    """JAX's prepacked params and the port's copy of them, a (family,
    mode) each, built on first use."""
    cache = {}

    def get(family, mode):
        if (family, mode) not in cache:
            jcfg = jsmall(pum=JPUM(mode=mode), **KW, **FAMILIES[family])
            raw = jlm.init_params(jcfg, jax.random.PRNGKey(0))
            jp = _jax_prepack(raw, jcfg)
            tcfg = tsmall(pum=TPUM(mode=mode), **KW, **FAMILIES[family])
            params = bridge.params_from_numpy(to_numpy(jp), tcfg,
                                              device="cpu")
            cache[family, mode] = dict(jcfg=jcfg, jp=jp, tcfg=tcfg,
                                       params=params)
        return cache[family, mode]
    return get


def _reqs(trace=TRACE):
    return [Request(p, n, temperature=t, seed=s, arrival=a, rid=i)
            for i, (p, n, t, s, a) in enumerate(trace)]


def _sched(m, **kw):
    return ContinuousBatchingScheduler(m["tcfg"], m["params"], device="cpu",
                                       **{**SCHED, **kw})


def _tokens(out):
    return {rid: c.tokens for rid, c in sorted(out.items())}


_ORACLE: dict = {}
_K0: dict = {}


def _jax_oracle(m, family, mode):
    if (family, mode) not in _ORACLE:
        eng = JEngine(m["jcfg"], m["jp"], max_len=SCHED["max_len"],
                      prepack=False)
        _ORACLE[family, mode] = {
            i: joracle(eng, JRequest(p, n, temperature=t, seed=s))
            for i, (p, n, t, s, _) in enumerate(TRACE)}
    return _ORACLE[family, mode]


def _k0(m, family, mode):
    """The port's k = 0 tokens of ``TRACE``."""
    if (family, mode) not in _K0:
        _K0[family, mode] = _tokens(_sched(m).run(_reqs()))
    return _K0[family, mode]


class WrongDrafter:
    """Proposes tokens the model is unlikely to emit."""

    def propose(self, context, k):
        return [(int(context[-1]) + 1) % 7] * k


class ReplayDrafter:
    """Replays recorded continuations: the perfect drafter."""

    def __init__(self, sequences):
        self.sequences = [tuple(int(t) for t in s) for s in sequences]

    def propose(self, context, k):
        key = tuple(int(t) for t in context)
        for s in self.sequences:
            if s[:len(key)] == key and len(s) > len(key):
                return list(s[len(key):len(key) + k])
        return []


def _same_end_state(a, b):
    """The pools bit-equal but for the trash block 0, the recurrent rows
    bit-equal."""
    for st0, st1 in zip(a.states, b.states):
        for name, t in st0.items():
            if tpool.is_paged_cache(st0):
                assert torch.equal(t[1:], st1[name][1:]), name
            else:
                assert torch.equal(t, st1[name]), name


# ---------------------------------------------------------------------------
# The drafters: host Python on both sides, equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_ngram", [1, 2, 3, 4])
def test_ngram_drafter_equals_the_reference(max_ngram):
    rng = np.random.default_rng(max_ngram)
    jd, td = jspec.NgramDrafter(max_ngram), tspec.NgramDrafter(max_ngram)
    for _ in range(200):
        ctx = rng.integers(0, 4, size=int(rng.integers(1, 24))).tolist()
        k = int(rng.integers(1, 7))
        assert td.propose(ctx, k) == jd.propose(ctx, k)
    with pytest.raises(ValueError):
        tspec.NgramDrafter(max_ngram=0)


def test_build_drafts_equals_the_reference():
    """Out-of-vocabulary and short proposals clamped and padded, empty
    contexts zero rows, for a wild drafter and the n-gram one."""
    class Wild:
        def propose(self, context, k):
            return [10 ** 9, -5, int(context[0])][:1 + len(context) % 3]

    rng = np.random.default_rng(7)
    for drafter in (Wild(), jspec.NgramDrafter()):
        for _ in range(50):
            ctxs = [None if rng.random() < 0.3 else
                    rng.integers(0, 60, size=int(rng.integers(1, 12))
                                 ).tolist() for _ in range(4)]
            k = int(rng.integers(1, 6))
            got = tspec.build_drafts(drafter, ctxs, k, vocab_size=50)
            want = jspec.build_drafts(drafter, ctxs, k, vocab_size=50)
            assert got.dtype == np.int32 and got.shape == (4, k)
            np.testing.assert_array_equal(got, want)


def test_resolve_drafter_coercion():
    assert isinstance(tspec.resolve_drafter(None), tspec.NgramDrafter)
    assert isinstance(tspec.resolve_drafter("ngram"),
                      tspec.NgramDrafter)
    d = WrongDrafter()
    assert tspec.resolve_drafter(d) is d
    for bad in ("beam", 42):
        with pytest.raises(TypeError, match="propose"):
            tspec.resolve_drafter(bad)


def test_model_drafter_window_and_clamp(models):
    m = models("dense", "pum")
    eng = ServeEngine(m["tcfg"], m["params"], max_len=12, device="cpu")
    d = tspec.ModelDrafter(eng, window=64)       # clamped to max_len - 1
    assert d.window == 11
    out = d.propose([1, 2, 3], 4)                # k clamped to 12 - 11
    assert len(out) == 1 and all(0 <= t < 256 for t in out)
    with pytest.raises(ValueError):
        tspec.ModelDrafter(eng, window=0)


# ---------------------------------------------------------------------------
# collect_states: the per-position recurrent states
# ---------------------------------------------------------------------------

# f32 activations, ``pum`` projections: the integer products do not
# depend on the rows beside them (a float matmul's may: on the CPU one
# of 3 rows can round otherwise than the same row among 15)
MIXER = dict(d_model=16, num_heads=2, num_kv_heads=2, ssm_state_dim=4,
             dtype="float32")


def _mixer_cfgs():
    return (JConfig(**MIXER, pum=JPUM(mode="pum")),
            TConfig(**MIXER, pum=TPUM(mode="pum")))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _mixer(kind, seed=0):
    """(JAX fn, port fn, JAX params, port params, numpy state) of one
    mixer of ``kind``, a state a few tokens old."""
    key = jax.random.PRNGKey(seed)
    cfg = _mixer_cfgs()[0]
    jfn, tfn, init, make = {
        "mlstm": (jxl.mlstm, txl.mlstm, jxl.init_mlstm,
                  jxl.make_mlstm_state),
        "slstm": (jxl.slstm, txl.slstm, jxl.init_slstm,
                  jxl.make_slstm_state),
        "mamba": (jssm.mamba, tssm.mamba, jssm.init_mamba,
                  jssm.make_ssm_state)}[kind]
    p = to_numpy(init(key, cfg))
    rng = np.random.default_rng(seed)
    st = {n: np.asarray(a) for n, a in make(cfg, 3).items()}
    st = {n: (rng.normal(size=a.shape) * 0.5).astype(np.float32)
          for n, a in st.items()}
    if "m" in st:
        st["n"] = np.abs(st["n"]) + 0.5
    tp = {k: ({n: _t(a) for n, a in v.items()} if isinstance(v, dict)
              else _t(v)) for k, v in p.items()}
    return jfn, tfn, jax.tree_util.tree_map(jnp.asarray, p), tp, st


@pytest.mark.parametrize("kind", ["mlstm", "slstm", "mamba"])
def test_collect_states_equal_one_token_steps(kind):
    """Index t of the collected states is the state t + 1 one-token
    steps leave, bit for bit, and the outputs are the steps' outputs."""
    _, tfn, _, tp, st = _mixer(kind)
    cfg = _mixer_cfgs()[1]
    x = _t(np.random.default_rng(1).normal(size=(3, 5, 16)).astype(
        np.float32) * 0.5)
    state = {n: _t(a) for n, a in st.items()}
    y, per = tfn(tp, x, cfg, state=state, collect_states=True)
    assert {n: tuple(t.shape) for n, t in per.items()} == \
        {n: (3, 5) + tuple(t.shape[1:]) for n, t in state.items()}
    # the given state is left as it was
    assert all(torch.equal(state[n], _t(st[n])) for n in st)
    cur = state
    for t in range(5):
        yt, cur = tfn(tp, x[:, t:t + 1], cfg, state=cur)
        assert torch.equal(yt[:, 0], y[:, t])
        for n in cur:
            assert torch.equal(per[n][:, t], cur[n]), (t, n)


@pytest.mark.parametrize("kind", ["mlstm", "slstm", "mamba"])
def test_collect_states_match_jax(kind):
    jfn, tfn, jp, tp, st = _mixer(kind, seed=2)
    x = (np.random.default_rng(3).normal(size=(3, 4, 16)) * 0.5).astype(
        np.float32)
    jcfg, tcfg = _mixer_cfgs()
    jy, jper = jax.jit(jfn, static_argnames=("cfg", "collect_states"))(
        jp, jnp.asarray(x), jcfg,
        state={n: jnp.asarray(a) for n, a in st.items()},
        collect_states=True)
    ty, tper = tfn(tp, _t(x), tcfg,
                   state={n: _t(a) for n, a in st.items()},
                   collect_states=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MIXER_TOL)
    assert set(tper) == set(jper)
    for n, t in tper.items():
        assert t.shape == jper[n].shape
        np.testing.assert_allclose(t.numpy(), np.asarray(jper[n]),
                                   **MIXER_TOL)


# ---------------------------------------------------------------------------
# The rollback: spec_save_cells, spec_restore_cells, spec_select_recurrent
# ---------------------------------------------------------------------------

def _rollback_case(seed):
    """Pools [NB, bs, KV, hd] (bf16 values), a write table whose rows
    are: live, live with positions past the table width, inactive (all
    zeros), live with a shared leading column; their cache indices and
    advances (one row keeps nothing)."""
    rng = np.random.default_rng(seed)
    nb, bs, w, s = 12, 4, 3, 4
    pools = [(rng.normal(size=(nb, bs, 2, 8))).astype(np.float32)
             for _ in range(2)]
    table = np.asarray([[1, 2, 3], [4, 5, 6], [0, 0, 0], [0, 10, 11]],
                       np.int32)
    ci = np.asarray([2, 10, 0, 5], np.int32)
    adv = np.asarray([3, 1, 0, 4], np.int32)
    return pools, table, ci, adv, s


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_save_and_restore_cells_equal_jax(seed):
    """Saved cells, then a verify step's writes and the restore: every
    pool bit-equal to JAX's, the trash block included (its last-writer
    rule for the restores that land there)."""
    pools, table, ci, adv, s = _rollback_case(seed)
    rng = np.random.default_rng(100 + seed)
    new = [rng.normal(size=(4, s, 2, 8)).astype(np.float32)
           for _ in range(2)]
    jst = [{"k_pool": jnp.asarray(pools[0], jnp.bfloat16)[None],
            "v_pool": jnp.asarray(pools[1], jnp.bfloat16)[None]}, {}]
    tst = [{"k_pool": _bf16(pools[0]), "v_pool": _bf16(pools[1])}, {}]
    jt, jci, jadv = (jnp.asarray(a) for a in (table, ci, adv))
    tt, tci, tadv = (torch.from_numpy(a) for a in (table, ci, adv))
    jsaved = jpool.spec_save_cells(jst, jt, jci, s)
    tsaved = tpool.spec_save_cells(tst, tt, tci, s)
    assert jsaved[1] is None and tsaved[1] is None
    for name in ("k_pool", "v_pool"):
        np.testing.assert_array_equal(
            tsaved[0][name].float().numpy(),
            np.asarray(jsaved[0][name][0], np.float32))
    # the verify step's stores, as both stacks' attention makes them
    phys, off = jpool.paged_write_cells(jt, jci, s, 4)
    for name, val in zip(("k_pool", "v_pool"), new):
        jst[0][name] = jst[0][name].at[:, phys, off].set(
            jnp.asarray(val, jnp.bfloat16)[None])
        tphys, toff = tpool.paged_write_cells(tt, tci, s, 4)
        tpool.write_cells(tst[0][name], tphys, toff, _bf16(val))
    jout = jpool.spec_restore_cells(jst, jsaved, jt, jci, s, jadv)
    tpool.spec_restore_cells(tst, tsaved, tt, tci, s, tadv)
    for name in ("k_pool", "v_pool"):
        np.testing.assert_array_equal(
            tst[0][name].float().numpy(),
            np.asarray(jout[0][name][0], np.float32))
    # a row's kept cells hold the step's values, the rest the old ones
    got = tst[0]["k_pool"].float().numpy()
    want_old = _bf16(pools[0]).float().numpy()
    want_new = _bf16(new[0]).float().numpy()
    for b, j in ((0, 0), (0, 2), (3, 3)):
        p = ci[b] + j
        np.testing.assert_array_equal(got[table[b, p // 4], p % 4],
                                      want_new[b, j])
    p = ci[0] + 3
    np.testing.assert_array_equal(got[table[0, p // 4], p % 4],
                                  want_old[table[0, p // 4], p % 4])


def test_select_recurrent_equals_jax():
    """Each active row adopts its state at ``advance - 1``; inactive rows
    keep theirs; pools pass through."""
    rng = np.random.default_rng(5)
    b, s = 4, 3
    old = {"c": rng.normal(size=(b, 2, 5)).astype(np.float32),
           "m": rng.normal(size=(b, 2)).astype(np.float32)}
    new = {n: rng.normal(size=(b, s) + a.shape[1:]).astype(np.float32)
           for n, a in old.items()}
    adv = np.asarray([1, 3, 0, 2], np.int32)
    active = np.asarray([True, True, False, True])
    pool = {"k_pool": np.zeros((2, 4, 1, 2), np.float32)}
    pool["v_pool"] = pool["k_pool"]
    jout = jpool.spec_select_recurrent(
        [jax.tree_util.tree_map(lambda a: jnp.asarray(a)[None], old),
         jax.tree_util.tree_map(jnp.asarray, pool)],
        [jax.tree_util.tree_map(lambda a: jnp.asarray(a)[None], new),
         jax.tree_util.tree_map(jnp.asarray, pool)],
        jnp.asarray(adv), jnp.asarray(active))
    tst = [{n: _t(a) for n, a in old.items()},
           {n: _t(a) for n, a in pool.items()}]
    tpool.spec_select_recurrent(
        tst, [{n: _t(a) for n, a in new.items()}, tst[1]],
        torch.from_numpy(adv), torch.from_numpy(active))
    for n in old:
        np.testing.assert_array_equal(tst[0][n].numpy(),
                                      np.asarray(jout[0][n][0]))
    np.testing.assert_array_equal(tst[0]["c"][2].numpy(), old["c"][2])
    np.testing.assert_array_equal(tst[0]["c"][1].numpy(), new["c"][1, 2])


# ---------------------------------------------------------------------------
# The verify step against JAX's
# ---------------------------------------------------------------------------

# the reference's forward compiled once a shape (op-by-op dispatch of
# its pum path costs seconds a call)
_jax_forward = jax.jit(jlm.forward, static_argnums=2,
                       static_argnames=("kv_len",))


def _layer_state(j_states, cfg, layer):
    """Layer ``layer``'s state in JAX's grouped per-period tree."""
    from repro_torch.models import transformer as ttr
    p = ttr.period(cfg)
    return jax.tree_util.tree_map(lambda a: a[layer // p],
                                  j_states[layer % p])


@pytest.mark.parametrize("family,mode", [
    (f, m) for f in sorted(FAMILIES) for m in ("pum", "int8")]
    + [("dense", "bf16")])
def test_verify_step_matches_jax(models, family, mode, monkeypatch):
    """A 5-token paged chunk, then a verify step of S = 4 at two rows
    (one at the chunk's end, one fresh): logits and per-position states
    within tolerance of JAX's; in ``pum``/``int8`` every integer
    accumulator equal to JAX's contraction of the same operands; each
    position's logits bit-equal to the port's one-token decode steps."""
    m = models(family, mode)
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    bs, max_len, nb = 4, 16, 8
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, 256, (2, 5)).astype(np.int32)
    toks = rng.integers(0, 256, (2, 4)).astype(np.int32)
    ci = np.asarray([5, 0], np.int32)
    jst = jlm.init_paged_state(jcfg, 2, max_len, num_blocks=nb,
                               block_size=bs)
    _, jst, _ = _jax_forward(m["jp"], jnp.asarray(prompt), jcfg,
                             states=jst, cache_index=jnp.zeros(2, jnp.int32),
                             block_table=jnp.asarray(table), kv_len=max_len)
    # row 1 starts afresh: JAX's chunk left its recurrent rows moved
    jst = [jax.tree_util.tree_map(
        lambda a, f: a.at[:, 1].set(f[:, 1]), st, fresh) if st and
        "k_pool" not in st else st
        for st, fresh in zip(jst, jlm.init_paged_state(
            jcfg, 2, max_len, num_blocks=nb, block_size=bs))]
    jlog, jnew = jax.jit(jverify(jcfg, kv_len=max_len))(
        m["jp"], jst, jnp.asarray(toks), jnp.asarray(ci),
        block_table=jnp.asarray(table))
    tst = tlm.init_paged_state(tcfg, 2, max_len, num_blocks=nb,
                               block_size=bs, device="cpu")
    tt = torch.from_numpy(table)
    with torch.no_grad():
        tlm.forward(m["params"], torch.from_numpy(prompt), tcfg, states=tst,
                    cache_index=torch.zeros(2, dtype=torch.int32),
                    block_table=tt, kv_len=max_len)
        tlm.reset_states(tcfg, tst, row=1)
        before = [{n: t.clone() for n, t in st.items()} for st in tst]
        records = []
        int_matmul = tpl.bitslice.int_matmul

        def recording(xq, wq, **kw):
            out = int_matmul(xq, wq, **kw)
            records.append((xq.numpy(), wq.numpy(), out.numpy()))
            return out

        monkeypatch.setattr(tpl.bitslice, "int_matmul", recording)
        tlog, tnew = tengine.make_verify_step(tcfg, kv_len=max_len)(
            m["params"], tst, torch.from_numpy(toks),
            torch.from_numpy(ci), block_table=tt)
        monkeypatch.undo()
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL, rtol=0)
        for layer, (st, new) in enumerate(zip(tst, tnew)):
            if tpool.is_paged_cache(st):
                continue
            want = _layer_state(jnew, tcfg, layer)
            for n, t in new.items():
                assert t.shape[:2] == (2, 4)
                np.testing.assert_allclose(t.numpy(), np.asarray(want[n]),
                                           atol=LOGIT_TOL, rtol=LOGIT_TOL)
            # the collecting forward wrote no recurrent row
            assert all(torch.equal(t, before[layer][n])
                       for n, t in st.items())
        if mode == "bf16":
            assert not records
        else:
            assert records
            for xq, wq, acc in records:
                np.testing.assert_array_equal(
                    acc, np.asarray(jbits.int_matmul(jnp.asarray(xq),
                                                     jnp.asarray(wq))))
        # position j is the one-token step at cache_index + j
        for st, b in zip(tst, before):
            if tpool.is_paged_cache(st):
                for n, t in st.items():
                    t.copy_(b[n])
        for j in range(4):
            lg, _ = tlm.forward(
                m["params"], torch.from_numpy(toks[:, j:j + 1]), tcfg,
                states=tst, cache_index=torch.from_numpy(ci + j),
                block_table=tt, kv_len=max_len, last_only=True)
            assert torch.equal(lg[:, 0], tlog[:, j]), j


# ---------------------------------------------------------------------------
# The scheduler: tokens, pools and rows of the one-token path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,mode,k", [
    (f, m, k) for f in sorted(FAMILIES) for m in ("pum", "int8")
    for k in (1, 3)] + [("dense", "bf16", 2)])
def test_spec_tokens_equal_k0_and_jax_oracle(models, family, mode, k):
    """The trace (greedy and sampled, late arrivals, chunked prefill)
    at k = 1 and 3 (bf16: 2): every completion equals the port's k = 0
    run's and JAX's solo oracle's; one spec program, no decode
    program."""
    m = models(family, mode)
    want = _k0(m, family, mode)
    assert want == _jax_oracle(m, family, mode)
    sched = _sched(m, speculate_k=k)
    assert _tokens(sched.run(_reqs())) == want
    progs = sched.step_programs()
    assert progs["decode"] == 0 and progs["spec"] == 1
    st = sched.spec_stats()
    assert st["steps"] == sched.decode_steps and st["rows"] > 0


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("drafter", ["ngram", "wrong", "replay"])
def test_pool_and_rows_equal_a_k0_replay(models, family, drafter):
    """A burst of exactly ``num_slots`` requests (both runs give each
    slot the same blocks): after the spec run the pool, block 0 excluded,
    and the recurrent rows are bit-equal to the k = 0 run's."""
    m = models(family, "pum")
    reqs = _reqs(TRACE[:3])
    base = _sched(m)
    want = _tokens(base.run(reqs))
    d = {"ngram": "ngram", "wrong": WrongDrafter(),
         "replay": ReplayDrafter([list(r.prompt) + want[r.rid]
                                  for r in reqs])}[drafter]
    sched = _sched(m, speculate_k=4, drafter=d)
    assert _tokens(sched.run(reqs)) == want
    _same_end_state(base, sched)
    if drafter == "replay":
        assert sched.spec_stats()["advance_per_step"] > 1.5


def test_wrong_drafter_full_rejection_still_oracle(models):
    m = models("dense", "pum")
    want = _k0(m, "dense", "pum")
    sched = _sched(m, speculate_k=3, drafter=WrongDrafter())
    assert _tokens(sched.run(_reqs())) == want
    st = sched.spec_stats()
    assert st["accepted"] == 0 and st["advance_per_step"] == 1.0


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_replay_drafter_multi_token_advance(models, family):
    m = models(family, "int8")
    want = _k0(m, family, "int8")
    reqs = _reqs()
    drafter = ReplayDrafter([list(r.prompt) + want[r.rid] for r in reqs])
    sched = _sched(m, speculate_k=3, drafter=drafter)
    assert _tokens(sched.run(reqs)) == want
    st = sched.spec_stats()
    assert st["advance_per_step"] > 1.5 and st["accepted"] > 0


def test_model_drafter_oracle_identical(models):
    m = models("dense", "pum")
    want = _k0(m, "dense", "pum")
    drafter = tspec.ModelDrafter(
        ServeEngine(m["tcfg"], m["params"], max_len=16, device="cpu"),
        window=8)
    sched = _sched(m, speculate_k=2, drafter=drafter)
    assert _tokens(sched.run(_reqs())) == want


def test_allocator_exact_partition_after_rollback_storm(models):
    """A wrong drafter probing past funded windows every step on a small
    pool never leaks or double-assigns a block: after each trace the
    free list alone partitions the pool."""
    m = models("dense", "int8")
    sched = _sched(m, num_slots=2, num_kv_blocks=10, speculate_k=4,
                   drafter=WrongDrafter())
    for seed in (0, 1):
        reqs = synthetic_workload(6, 256, max_prompt=6, max_new=10,
                                  mean_interarrival=1.0, seed=seed)
        out = sched.run(reqs)
        assert all(out[r.rid].tokens == oracle_completion(sched.engine, r)
                   for r in reqs)
        assert sched._alloc.live_blocks == 0
        assert sorted(sched._alloc._free) == list(
            range(1, sched.num_kv_blocks + 1))
        assert (sched._block_table == 0).all()
        assert all(not b for b in sched._slot_blocks)


def test_spec_stats_are_consistent(models):
    m = models("hybrid", "pum")
    sched = _sched(m, speculate_k=2)
    assert all(v == 0 for v in sched.spec_stats().values())
    sched.run(_reqs())
    st = sched.spec_stats()
    assert st["steps"] > 0
    assert st["emitted"] == st["accepted"] + st["rows"]
    assert st["proposed"] == 2 * st["rows"]
    assert 0.0 <= st["acceptance_rate"] <= 1.0
    assert st["advance_per_step"] >= 1.0
    assert st["emitted"] == sum(n for _, n, *_ in TRACE) - len(TRACE)
    assert all(v == 0 for v in _sched(m).spec_stats().values())


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_prefix_cache_on_equals_off_under_speculation(models, family):
    """A shared-prefix trace with the cache (cold, then warm) and
    without, all at k = 3: the same tokens as at k = 0, and the cache
    hits."""
    m = models(family, "pum")
    reqs = synthetic_workload(5, 256, min_prompt=1, max_prompt=10,
                              max_new=6, mean_interarrival=1.0,
                              shared_prefix_len=8, seed=29)
    want = _tokens(_sched(m).run(reqs))
    on = _sched(m, prefix_cache=True, speculate_k=3)
    off = _sched(m, speculate_k=3)
    assert _tokens(on.run(reqs)) == _tokens(on.run(reqs)) == \
        _tokens(off.run(reqs)) == want
    assert on.prefix_stats()["hits"] > 0
    on.drain()
    on.flush_prefix_cache()
    assert on._alloc.live_blocks == 0


def test_eos_and_max_tokens_cap_an_accepted_run(models):
    """With the perfect drafter a whole run is accepted at once: an EOS
    inside it ends the request on the EOS, and ``max_tokens`` inside it
    ends the request there, as the one-token path ends them."""
    m = models("dense", "pum")
    want = _k0(m, "dense", "pum")
    p0, n0, *_ = TRACE[0]
    eos = want[0][2]
    cut = want[0].index(eos) + 1
    reqs = [Request(p0, n0, eos_id=eos, rid=0), Request(p0, 2, rid=1),
            Request(p0, 3, eos_id=want[0][-1], rid=2)]
    base = _sched(m).run(reqs)
    drafter = ReplayDrafter([list(p0) + want[0]])
    out = _sched(m, speculate_k=4, drafter=drafter).run(reqs)
    assert _tokens(out) == _tokens(base)
    assert out[0].tokens == want[0][:cut] and out[0].finish_reason == "eos"
    assert out[1].tokens == want[0][:2] and out[1].finish_reason == "length"
    assert [c.finish_reason for c in out.values()] == \
        [c.finish_reason for c in base.values()]


def test_sampled_rows_equal_k0(models):
    """Every request sampled (temperatures 0.7 and 1, their own seeds):
    the spec step draws each emitted token with its position's key of
    the one-token chain."""
    m = models("xlstm", "pum")
    reqs = [dataclasses.replace(r, temperature=t, seed=100 + r.rid)
            for r, t in zip(_reqs(), [0.7, 1.0, 0.7, 1.0, 0.7])]
    want = _tokens(_sched(m).run(reqs))
    ngram = _tokens(_sched(m, speculate_k=3).run(reqs))
    replay = _sched(m, speculate_k=3, drafter=ReplayDrafter(
        [list(r.prompt) + want[r.rid] for r in reqs]))
    assert ngram == _tokens(replay.run(reqs)) == want
    assert replay.spec_stats()["advance_per_step"] > 1.5


def test_events_stream_in_order(models):
    m = models("dense", "int8")
    want = _k0(m, "dense", "int8")
    sched = _sched(m, speculate_k=3, drafter=ReplayDrafter(
        [list(r.prompt) + want[r.rid] for r in _reqs()]))
    reqs = _reqs()[:3]
    for r in reqs:
        sched.start_request(r)
    seen = {r.rid: [] for r in reqs}
    multi = False
    for step in range(100):
        res = sched.tick(step)
        got = [rid for rid, _, _ in res.events]
        multi |= len(got) > len(set(got))
        for rid, idx, tok in res.events:
            assert idx == len(seen[rid])
            seen[rid].append(tok)
        if not sched.in_flight():
            break
    assert multi
    assert seen == {r.rid: want[r.rid] for r in reqs}


def test_moe_serves_under_speculation_and_leaks_nothing():
    """MoE keeps only the leak-freedom contract (the k + 1 positions of
    every row share the expert capacity): every request completes at its
    length, and a drain leaves no block live."""
    cfg = tsmall(pum=TPUM(mode="pum"), **KW,
                 moe=TMoE(num_experts=4, top_k=2, capacity_factor=1.0))
    params = tlm.prepack_for_serving(tlm.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), cfg)
    sched = ContinuousBatchingScheduler(cfg, params, device="cpu",
                                        speculate_k=3, **SCHED)
    reqs = _reqs()
    out = sched.run(reqs)
    assert all(len(out[r.rid].tokens) == r.max_tokens for r in reqs)
    assert all(0 <= t < cfg.vocab_size for c in out.values()
               for t in c.tokens)
    assert sched._alloc.live_blocks == 0
    assert sorted(sched._alloc._free) == list(
        range(1, sched.num_kv_blocks + 1))


def test_speculate_k_requires_the_paged_pool_and_a_range(models):
    m = models("dense", "pum")
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatchingScheduler(m["tcfg"], m["params"], num_slots=2,
                                    max_len=32, kv_block_size=0,
                                    device="cpu", speculate_k=2)
    for bad in (-1, 17):
        with pytest.raises(ValueError, match="speculate_k"):
            _sched(m, speculate_k=bad)
    with pytest.raises(NotImplementedError):
        _sched(m, mesh=object())
    assert _sched(m, speculate_k=16).speculate_k == 16


# ---------------------------------------------------------------------------
# One trace against the JAX package's spec scheduler
# ---------------------------------------------------------------------------

def test_spec_scheduler_equals_jax_spec_scheduler(models):
    """Dense ``pum`` at k = 2 with the n-gram drafter: the tokens and
    every ``spec_stats()`` counter equal the JAX scheduler's."""
    m = models("dense", "pum")
    js = JSched(m["jcfg"], m["jp"], prepack=False, kernel_backend="xla",
                speculate_k=2, **SCHED)
    jout = js.run([JRequest(p, n, temperature=t, seed=s, arrival=a, rid=i)
                   for i, (p, n, t, s, a) in enumerate(TRACE)])
    sched = _sched(m, speculate_k=2)
    assert _tokens(sched.run(_reqs())) == _tokens(jout)
    assert sched.spec_stats() == js.spec_stats()
