"""The port's xLSTM family (``models/xlstm.py`` and the xLSTM stack of
``lm.forward``) against the JAX package's, on numpy inputs and on JAX's
weights carried across (the bridge for whole models), in f32.

Tolerances: in f32 the two frameworks differ only by the order of f32
sums (matmuls, cumulative log-forget, and the port's fixed lane tree
against XLA's reduction), some 1e-7 relative; the recurrences divide by
``max(|n . q|, exp(-m))``, which can lift that to ~1e-5 on outputs of
order 1, so mixers are held within ``MIXER_TOL`` (outputs and states).
Logits of the small models are held within ``LOGIT_TOL``: the integer
contractions of ``int8``/``pum`` are exact on equal inputs, but an f32
difference in an activation can move its int8 quantisation by a step
where it sits on a rounding edge, which moves logits of magnitude ~0.5
by a few 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_numpy
from repro.config import ModelConfig as JConfig
from repro.config import PUMConfig as JPUM, small_test_config as jsmall
from repro.models import lm as jlm
from repro.models import xlstm as jx
from repro_torch import bridge
from repro_torch.config import ModelConfig as TConfig
from repro_torch.config import PUMConfig as TPUM, small_test_config as tsmall
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttr
from repro_torch.models import xlstm as tx
from repro_torch.serve import kv_pool

MIXER_TOL = dict(atol=1e-4, rtol=1e-4)
LOGIT_TOL = 2e-4
# the parallel form against the recurrence (the reference's own bound:
# tests/test_model_numerics.py), and chunk 16 against chunk 1024
FORM_TOL = dict(atol=5e-3, rtol=5e-3)
CHUNK_TOL = dict(atol=2e-3, rtol=2e-3)

MIXER_CFG = dict(d_model=16, num_heads=2, num_kv_heads=2)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _mixer_params(kind, seed):
    """JAX's mixer params with non-zero biases, and the port's copy."""
    init = jx.init_mlstm if kind == "mlstm" else jx.init_slstm
    p = to_numpy(init(jax.random.PRNGKey(seed), JConfig(**MIXER_CFG)))
    rng = np.random.default_rng(seed)
    for leaf in p.values():
        if "b" in leaf:
            leaf["b"] = (rng.normal(size=leaf["b"].shape) * 0.5).astype(
                np.float32)
    return p, {k: {n: _t(a) for n, a in v.items()} for k, v in p.items()}


def _state(kind, batch, seed):
    """A state a few tokens old: random c, n, m (numpy), or fresh."""
    inner, heads, hd = 2 * MIXER_CFG["d_model"], MIXER_CFG["num_heads"], \
        MIXER_CFG["d_model"]
    rng = np.random.default_rng(seed)
    if kind == "mlstm":
        shapes = {"c": (batch, heads, hd, hd), "n": (batch, heads, hd),
                  "m": (batch, heads)}
    else:
        shapes = {n: (batch, inner) for n in "cnm"}
    st = {n: rng.normal(size=s).astype(np.float32) for n, s in
          shapes.items()}
    st["n"] = np.abs(st["n"]) + 0.5
    return st


def _check_state(got, want):
    assert set(got) == set(want) == {"c", "n", "m"}
    for n in "cnm":
        assert got[n].dtype == torch.float32
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   **MIXER_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("branch,s,fresh", [
    ("no-state", 12, True), ("prefill", 7, True), ("prefill", 5, False),
    ("step", 1, True), ("step", 1, False)])
def test_mixer_matches_jax(kind, branch, s, fresh):
    """Each branch of each mixer (mLSTM's parallel form without a state,
    the recurrence over a prompt, the single step), from a fresh state
    and from one a few tokens old: outputs and new states within
    MIXER_TOL of JAX's."""
    jp, tp = _mixer_params(kind, seed=s)
    x = (np.random.default_rng(10 + s).normal(size=(2, s, 16)) * 0.5
         ).astype(np.float32)
    jfn, tfn = (jx.mlstm, tx.mlstm) if kind == "mlstm" else \
        (jx.slstm, tx.slstm)
    if branch == "no-state":
        jst = tst = None
    else:
        make = jx.make_mlstm_state if kind == "mlstm" else jx.make_slstm_state
        jst = {n: np.asarray(a) for n, a in make(JConfig(**MIXER_CFG),
                                                 2).items()} \
            if fresh else _state(kind, 2, seed=s)
        tst = {n: _t(a) for n, a in jst.items()}
        jst = {n: jnp.asarray(a) for n, a in jst.items()}
    jy, jnew = jfn(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x),
                   JConfig(**MIXER_CFG), state=jst)
    ty, tnew = tfn(tp, _t(x), TConfig(**MIXER_CFG), state=tst)
    assert ty.shape == (2, s, 16) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MIXER_TOL)
    if branch == "no-state":
        assert tnew is None
    else:
        _check_state(tnew, jnew)
        assert all(torch.equal(tst[n], _t(np.asarray(jst[n])))
                   for n in "cnm")       # the mixer returns, never writes


def _parallel_inputs(seed, b=2, s=50, h=2, hd=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    k /= np.sqrt(hd)
    i_pre, f_pre = (rng.normal(size=(b, s, h)).astype(np.float32) * 2
                    for _ in range(2))
    return q, k, v, i_pre, f_pre


def test_mlstm_parallel_chunked_matches_unchunked_and_jax():
    """Chunks of 16 over 50 tokens (ragged last block, padded with
    i_pre = -1e30) against one chunk of 1024: within CHUNK_TOL, as the
    reference's own test; and each against JAX's at the same chunk
    within MIXER_TOL."""
    args = _parallel_inputs(3)
    big = tx._mlstm_parallel(*map(_t, args), chunk=1024)
    small = tx._mlstm_parallel(*map(_t, args), chunk=16)
    np.testing.assert_allclose(small.numpy(), big.numpy(), **CHUNK_TOL)
    for chunk, got in ((1024, big), (16, small)):
        want = jx._mlstm_parallel(*map(jnp.asarray, args), chunk=chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MIXER_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_prefill_then_steps_equal_the_whole_sequence(kind):
    """A prompt fed into a fresh state and then token by token gives the
    outputs and the state of the whole sequence fed at once, bit for
    bit (the same recurrence), and row 0 alone gives its rows of a
    batch of two bit for bit (the lane sums do not depend on the
    batch); the stateless form agrees within FORM_TOL.  ``pum``
    projections, whose integer sums do not depend on the rows beside
    them (a float matmul's may)."""
    _, tp = _mixer_params(kind, seed=4)
    cfg = TConfig(**MIXER_CFG, pum=TPUM(mode="pum"))
    x = _t((np.random.default_rng(5).normal(size=(2, 9, 16)) * 0.5
            ).astype(np.float32))
    make = tx.make_mlstm_state if kind == "mlstm" else tx.make_slstm_state
    fn = tx.mlstm if kind == "mlstm" else tx.slstm
    y_all, st_all = fn(tp, x, cfg, state=make(cfg, 2))
    y0, st = fn(tp, x[:, :5], cfg, state=make(cfg, 2))
    ys = [y0]
    for t in range(5, 9):
        y, st = fn(tp, x[:, t:t + 1], cfg, state=st)
        ys.append(y)
    assert torch.equal(torch.cat(ys, dim=1), y_all)
    assert all(torch.equal(st[n], st_all[n]) for n in "cnm")
    y_one, st_one = fn(tp, x[:1], cfg, state=make(cfg, 1))
    assert torch.equal(y_one, y_all[:1])
    assert all(torch.equal(st_one[n], st_all[n][:1]) for n in "cnm")
    y_par, _ = fn(tp, x, cfg, state=None)
    np.testing.assert_allclose(y_par.numpy(), y_all.numpy(), **FORM_TOL)


def test_lane_sum_is_a_sum():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 4, 512)).astype(np.float32))
    np.testing.assert_allclose(tlayers.lane_sum(x).numpy(),
                               x.double().sum(-1).numpy(), atol=1e-5)
    odd = x[..., :37]
    np.testing.assert_allclose(tlayers.lane_sum(odd).numpy(),
                               odd.double().sum(-1).numpy(), atol=1e-5)


def test_fresh_states_carry_neg_1e30_and_reset_restores_them():
    """Fresh mLSTM and sLSTM states (alone, in ``init_state`` and beside
    no pool in ``init_paged_state``) hold m = -1e30 and zeros, as the
    reference's; ``reset_states`` sets a whole tree, or one slot's
    rows, back to those values in place."""
    cfg = tsmall(xlstm_slstm_every=2)
    jcfg = jsmall(xlstm_slstm_every=2)
    for make, jmake in ((tx.make_mlstm_state, jx.make_mlstm_state),
                        (tx.make_slstm_state, jx.make_slstm_state)):
        got, want = make(cfg, 3), jmake(jcfg, 3)
        for n in "cnm":
            assert got[n].dtype == torch.float32
            np.testing.assert_array_equal(got[n].numpy(),
                                          np.asarray(want[n]))
        assert bool((got["m"] == -1e30).all())
    for states in (tlm.init_state(cfg, 3, 16, device="cpu"),
                   tlm.init_paged_state(cfg, 3, 16, num_blocks=4,
                                        block_size=4, device="cpu")):
        assert not any(kv_pool.is_paged_cache(st) for st in states)
        fresh = [{n: t.clone() for n, t in st.items()} for st in states]
        addrs = [t.data_ptr() for st in states for t in st.values()]
        for st in states:
            for t in st.values():
                t.normal_()
        tlm.reset_states(cfg, states, row=1)
        for st, f in zip(states, fresh):
            for n, t in st.items():
                assert torch.equal(t[1], f[n][1])
                assert not torch.equal(t[0], f[n][0])
        tlm.reset_states(cfg, states)
        assert all(torch.equal(t, f[n]) for st, f in zip(states, fresh)
                   for n, t in st.items())
        assert addrs == [t.data_ptr() for st in states for t in st.values()]
    assert not kv_pool.has_kv_cache(cfg) and kv_pool.has_recurrent_state(cfg)
    dense = tsmall()
    assert kv_pool.has_kv_cache(dense) and not \
        kv_pool.has_recurrent_state(dense)


def _models(mode, **kw):
    jcfg = jsmall(pum=JPUM(mode=mode), dtype="float32", **kw)
    tcfg = tsmall(pum=TPUM(mode=mode), dtype="float32", **kw)
    raw = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    raw = jax.tree_util.tree_map_with_path(
        lambda p, a: a + jnp.asarray(rng.normal(size=a.shape) * 0.3,
                                     a.dtype)
        if jax.tree_util.keystr(p).endswith("['b']") else a, raw)
    jp = jlm.prepack_for_serving(raw, jcfg)
    tp = bridge.params_from_numpy(to_numpy(jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _logits_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("mode", ["pum", "int8", "bf16"])
def test_lm_forward_matches_jax(mode):
    """xLSTM stacks at ``small_test_config(xlstm_slstm_every=2)``, JAX's
    weights through the bridge (period 2: packed [64, 4] gates and bias
    leaves): logits with no state, and a prefill into fresh states then
    two decode steps, within LOGIT_TOL of JAX's; the states too."""
    jcfg, jp, tcfg, tp = _models(mode, xlstm_slstm_every=2)
    assert [next(iter(set(b) - {"norm1", "norm2", "mlp"}))
            for b in tp["blocks"]] == ["slstm", "mlstm"]
    toks = np.random.default_rng(1).integers(0, 256, (2, 9)).astype(
        np.int32)
    jl, _, _ = jlm.forward(jp, jnp.asarray(toks), jcfg)
    tl, _ = tlm.forward(tp, torch.from_numpy(toks), tcfg)
    assert tl.shape == (2, 9, 256)
    _logits_close(tl, jl)
    jst = jlm.init_state(jcfg, 2, 16)
    tst = tlm.init_state(tcfg, 2, 16, device="cpu")
    jl, jst, _ = jlm.forward(jp, jnp.asarray(toks[:, :6]), jcfg,
                             states=jst, cache_index=0, last_only=True)
    tl, tst = tlm.forward(tp, torch.from_numpy(toks[:, :6]), tcfg,
                          states=tst, cache_index=0, last_only=True)
    _logits_close(tl, jl)
    for i in (6, 7):
        idx = np.full((2,), i, np.int32)
        jl, jst, _ = jlm.forward(jp, jnp.asarray(toks[:, i:i + 1]), jcfg,
                                 states=jst, cache_index=jnp.asarray(idx),
                                 last_only=True)
        tl, tst = tlm.forward(tp, torch.from_numpy(toks[:, i:i + 1]), tcfg,
                              states=tst, cache_index=torch.from_numpy(idx),
                              last_only=True)
        _logits_close(tl, jl)
    for layer, st in enumerate(tst):
        for n, t in st.items():
            want = np.asarray(jst[layer % 2][n][layer // 2])
            np.testing.assert_allclose(t.numpy(), want, atol=1e-3,
                                       rtol=1e-3)


def test_ragged_period_takes_the_reference_layout():
    """``num_layers=10, xlstm_slstm_every=4``: the period falls back on
    5, a pattern of positions 0-4 whose sLSTM positions are 0 and 4, so
    layers 0, 4, 5 and 9 are sLSTM (layer 5 is mLSTM by its own index
    mod 4), as in the reference's grouped stack; logits equal JAX's
    within LOGIT_TOL."""
    jcfg, jp, tcfg, tp = _models("pum", num_layers=10, xlstm_slstm_every=4)
    assert ttr.period(tcfg) == 5
    kinds = [ttr.layer_kinds(tcfg, j)[0] for j in range(10)]
    assert kinds == ["slstm", "mlstm", "mlstm", "mlstm", "slstm"] * 2
    assert ["slstm" in b for b in tp["blocks"]] == \
        [k == "slstm" for k in kinds]
    toks = np.random.default_rng(2).integers(0, 256, (1, 7)).astype(
        np.int32)
    jl, _, _ = jlm.forward(jp, jnp.asarray(toks), jcfg)
    tl, _ = tlm.forward(tp, torch.from_numpy(toks), tcfg)
    _logits_close(tl, jl)
    st = tlm.init_state(tcfg, 1, 8, device="cpu")
    assert [set(s) for s in st] == [{"c", "n", "m"}] * 10
    assert st[5]["c"].shape == (1, 128) and st[6]["c"].ndim == 4
    assert ttr.mixer_kind(tcfg, 5) == "mlstm"


def test_unported_mixers_still_raise():
    """An MoE FFN beside an xLSTM mixer is the one layout left unported;
    the vision stub and the encoder-decoder are served."""
    from repro_torch.config import MoEConfig
    with pytest.raises(NotImplementedError, match="MoE FFNs"):
        ttr.check_supported(tsmall(xlstm_slstm_every=2, d_ff=128,
                                   moe=MoEConfig(num_experts=4, top_k=2)))
    for kw in (dict(vision_stub=True), dict(is_encoder_decoder=True)):
        ttr.check_supported(tsmall(**kw))
    ttr.check_supported(tsmall(xlstm_slstm_every=2, d_ff=0))


def _solo_rows(eng, prompt):
    """The recurrent state a solo prefill of ``prompt`` leaves."""
    states, _ = eng.prefill(torch.tensor([prompt], dtype=torch.int32))
    return states


def _row_equals(sched, slot, states):
    return all(torch.equal(t[slot], solo[n][0])
               for st, solo in zip(sched.states, states)
               for n, t in st.items())


@pytest.mark.parametrize("mode", ["pum", "int8"])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_reused_slot_starts_fresh_and_streaming_rows_stay_put(mode, layout):
    """A slot reused after another request holds, once its prompt is in,
    exactly the state a solo prefill of that prompt leaves (it starts
    from a fresh state, not the last occupant's nor zeros); and paged,
    while a prompt streams in chunks between decode steps of another
    slot, its row holds the solo prefill state of the tokens fed so far
    (the decode step freezes it).  Bit for bit: ``pum``/``int8``
    projections are exact per row, and the recurrence is the same
    elementwise ops on either path."""
    from repro_torch.serve import ContinuousBatchingScheduler, Request
    cfg = tsmall(xlstm_slstm_every=2, pum=TPUM(mode=mode), dtype="float32")
    params = tlm.init_params(cfg, torch.Generator().manual_seed(6),
                             device="cpu")
    paged = layout == "paged"
    sched = ContinuousBatchingScheduler(
        cfg, params, num_slots=2, max_len=32, device="cpu",
        kv_block_size=2 if paged else 0, chunked_prefill=paged)
    eng = sched.engine
    sched.run([Request([9, 8, 7], 4, rid=9), Request([3, 3], 2, rid=8)])
    stale = [t.clone() for t in tlm.recurrent_tensors(cfg, sched.states)]
    assert not all(bool((t == tx.STATE_INIT[n]).all()) for t, n in
                   zip(stale, "cnm" * len(sched.states)))
    first = Request([1, 2, 3, 4, 5], 12, rid=0)
    second = Request(list(range(10, 17)), 3, rid=1)
    if not paged:
        sched.start_request(first)
        assert _row_equals(sched, 0, _solo_rows(eng, first.prompt))
        sched.tick()
        sched.start_request(second)
        assert _row_equals(sched, 1, _solo_rows(eng, second.prompt))
        return
    sched.start_request(first)
    while 0 in sched._prefills:
        pos = sched._prefills[0].pos
        assert _row_equals(sched, 0, _solo_rows(eng, first.prompt[:pos])) \
            if pos else all(torch.equal(t[0], torch.full_like(
                t[0], tx.STATE_INIT[n])) for st in sched.states
                for n, t in st.items())
        sched.tick()
    sched.start_request(second)
    streamed = 0
    while 1 in sched._prefills:
        sched.tick()
        if 1 in sched._prefills:
            pos = sched._prefills[1].pos
            assert sched._active[0] and 0 < pos < len(second.prompt)
            assert _row_equals(sched, 1, _solo_rows(eng,
                                                    second.prompt[:pos]))
            streamed += 1
    assert streamed == 3                     # 7 tokens in chunks of 2


def test_full_width_period_comes_across_the_bridge():
    """xLSTM-350M's period (one sLSTM every 4 layers) at a small width:
    8 layers stack as 4 positions of 2 groups in JAX's tree; the bridge
    unstacks them into layers 0 and 4 sLSTM, the rest mLSTM, and the
    logits equal JAX's within LOGIT_TOL."""
    jcfg, jp, tcfg, tp = _models("int8", num_layers=8, xlstm_slstm_every=4,
                                 d_ff=0)
    assert ttr.period(tcfg) == 4 and len(jp["blocks"]) == 4
    assert ["slstm" in b for b in tp["blocks"]] == \
        [j % 4 == 0 for j in range(8)]
    assert all("mlp" not in b and "norm2" not in b for b in tp["blocks"])
    toks = np.random.default_rng(4).integers(0, 256, (2, 5)).astype(
        np.int32)
    jl, _, _ = jlm.forward(jp, jnp.asarray(toks), jcfg)
    tl, _ = tlm.forward(tp, torch.from_numpy(toks), tcfg)
    _logits_close(tl, jl)
