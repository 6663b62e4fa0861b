"""The port's Mamba mixer (``models/ssm.py``) and the hybrid stacks of
``lm.forward`` (both schedulers and the static batch) against the JAX
package's, on numpy inputs and on JAX's weights carried across by the
bridge, in f32: the reduced Jamba-v0.1 (8 layers: 7 Mamba, 1 attention,
4 MoE FFNs) and ``small_test_config(attn_period=2)`` (one Mamba and one
attention layer, dense MLPs), the hybrid of the JAX scheduler's tests.

Tolerances:

  * the mixer (``MIXER_TOL``): on equal inputs the two differ by the
    order of f32 sums (the conv's taps are summed in the reference's
    order; the state lanes by the port's fixed tree against XLA's dot)
    and by XLA's and torch's exp, log1p and sigmoid, some 1e-7 at
    outputs of order 1; the integer contractions of ``int8``/``pum``
    are exact.  Without a state the reference runs an associative scan
    in chunks of 256 and the port a sequential one: the same products
    associated otherwise, within the same bound at S = 300;
  * logits (``LOGIT_TOL``): an f32 difference in an activation can move
    its int8 quantisation by one step where it sits on a rounding edge;
    in ``pum`` at the reduced Jamba one such step moves logits of
    magnitude ~0.7 by up to 4.2e-4 (``tests/test_torch_xlstm.py`` and
    ``tests/test_torch_moe.py`` describe the same);
  * tokens: the port's schedulers and static batch must give JAX's
    tokens exactly, which they do wherever the logits (within
    ``LOGIT_TOL``) hold no near-tie, as on this trace; the solo
    ``generate_loop`` under the margin rule of
    ``tests/test_torch_scheduler.py``.

Within the port the chunk-versus-token and the B = 1 versus B = 4 cases
are bit for bit (``pum``/``int8``: the integer products do not depend on
the rows beside them, a float matmul's may).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import agree_outside_near_ties, jax_logits_along, to_numpy
from repro.config import ModelConfig as JConfig
from repro.config import PUMConfig as JPUM, small_test_config as jsmall
from repro.configs import jamba_v0_1_52b as jjamba
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.serve import ContinuousBatchingScheduler as JSched
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch import bridge, configs
from repro_torch.config import ModelConfig as TConfig
from repro_torch.config import PUMConfig as TPUM, small_test_config as tsmall
from repro_torch.core.prepack import PackedLinear, prepack_params
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.serve import (ContinuousBatchingScheduler, Request,
                               ServeEngine, oracle_completion)

MIXER_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = 1e-3
MODES = ["pum", "int8", "bf16"]
MIXER_CFG = dict(d_model=32, num_heads=2, num_kv_heads=2, ssm_state_dim=8,
                 dtype="float32")
CONFIGS = {"jamba": (jjamba.reduced, lambda: configs.get_reduced(
    "jamba-v0.1-52b")),
    "hybrid": (lambda: jsmall(attn_period=2),
               lambda: tsmall(attn_period=2))}
# prompts of whole blocks: one chunk program paged, two prefill programs
# contiguous (the reference compiles each; ragged chunks are held by
# tests/test_torch_scheduler.py and the chunk-versus-token case here)
TRACE = [([3, 1, 4, 1], 8, 0), ([9, 2, 6, 5, 3, 5, 8, 9], 6, 1),
         ([7, 7, 2, 6], 7, 2)]
SCHED = dict(num_slots=2, max_len=24)
LAYOUTS = {"paged": dict(kv_block_size=4, chunked_prefill=True),
           "contiguous": dict(kv_block_size=0)}
LINEARS = ("in_proj", "x_proj", "dt_proj", "out_proj")
FLOAT_LEAVES = ("conv_w", "conv_b", "a_log", "d_skip")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _mixer_params(mode, seed=0):
    """JAX's mixer params with a non-zero conv and dt bias, the port's
    copy, and both configs."""
    jcfg = JConfig(**MIXER_CFG, pum=JPUM(mode=mode))
    tcfg = TConfig(**MIXER_CFG, pum=TPUM(mode=mode))
    p = to_numpy(jssm.init_mamba(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    p["conv_b"] = (rng.normal(size=p["conv_b"].shape) * 0.3).astype(
        np.float32)
    p["dt_proj"]["b"] = (rng.normal(size=p["dt_proj"]["b"].shape) * 0.5
                         ).astype(np.float32)
    tp = {k: ({n: _t(a) for n, a in v.items()} if isinstance(v, dict)
              else _t(v)) for k, v in p.items()}
    return jcfg, jax.tree_util.tree_map(jnp.asarray, p), tcfg, tp


# the reference mixer compiled once per shape (op-by-op dispatch of its
# pum path costs seconds a call)
_jax_mamba = jax.jit(jssm.mamba, static_argnames=("cfg",))
_jax_forward = jax.jit(jlm.forward, static_argnums=2,
                       static_argnames=("last_only",))


def _state(batch, seed, fresh):
    inner, st = 2 * MIXER_CFG["d_model"], MIXER_CFG["ssm_state_dim"]
    rng = np.random.default_rng(seed)
    scale = 0.0 if fresh else 1.0
    return {"h": (rng.normal(size=(batch, inner, st)) * scale).astype(
        np.float32),
        "conv": (rng.normal(size=(batch, 3, inner)) * scale).astype(
            np.float32)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("branch,s,fresh", [
    ("no-state", 300, True), ("prefill", 7, True), ("prefill", 5, False),
    ("step", 1, False)])
def test_mamba_matches_jax(mode, branch, s, fresh):
    """Each branch of the mixer (the whole-sequence scan without a
    state, across a 256-token chunk of the reference's; a prefill into a
    fresh state and into one a few tokens old; the one-token decode), in
    each mode: outputs and the new h and conv window within MIXER_TOL of
    JAX's; the given state left as it was."""
    jcfg, jp, tcfg, tp = _mixer_params(mode, seed=s)
    x = (np.random.default_rng(10 + s).normal(size=(2, s, 32)) * 0.5
         ).astype(np.float32)
    if branch == "no-state":
        jst = tst = None
    else:
        st = _state(2, s, fresh)
        jst = {n: jnp.asarray(a) for n, a in st.items()}
        tst = {n: _t(a) for n, a in st.items()}
    jy, jnew = _jax_mamba(jp, jnp.asarray(x), cfg=jcfg, state=jst)
    ty, tnew = tssm.mamba(tp, _t(x), tcfg, state=tst)
    assert ty.shape == (2, s, 32) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MIXER_TOL)
    if branch == "no-state":
        assert tnew is None
        return
    assert set(tnew) == {"h", "conv"}
    for n in ("h", "conv"):
        assert tnew[n].dtype == torch.float32
        np.testing.assert_allclose(tnew[n].numpy(), np.asarray(jnew[n]),
                                   **MIXER_TOL)
        assert torch.equal(tst[n], _t(st[n]))     # returned, never written


@pytest.mark.parametrize("mode", ["pum", "int8"])
def test_token_alone_equals_token_in_chunk(mode):
    """A prompt of 9 tokens fed into a fresh state whole, in chunks of
    4, 1 and 4, and token by token gives the same outputs and the same
    state bit for bit (one step function in every branch, the conv taps
    in one order); the stateless form, the same recurrence from zero,
    gives the same outputs too."""
    _, _, tcfg, tp = _mixer_params(mode, seed=4)
    x = _t((np.random.default_rng(5).normal(size=(2, 9, 32)) * 0.5
            ).astype(np.float32))
    y_all, st_all = tssm.mamba(tp, x, tcfg,
                               state=tssm.make_ssm_state(tcfg, 2))
    for cuts in ((0, 4, 5, 9), tuple(range(10))):
        st, ys = tssm.make_ssm_state(tcfg, 2), []
        for lo, hi in zip(cuts, cuts[1:]):
            y, st = tssm.mamba(tp, x[:, lo:hi], tcfg, state=st)
            ys.append(y)
        assert torch.equal(torch.cat(ys, dim=1), y_all)
        assert all(torch.equal(st[n], st_all[n]) for n in ("h", "conv"))
    y_none, _ = tssm.mamba(tp, x, tcfg, state=None)
    assert torch.equal(y_none, y_all)


@pytest.mark.parametrize("mode", ["pum", "int8"])
def test_row_is_batch_invariant(mode):
    """Row 0 of a batch of four, in a prefill from a state a few tokens
    old and in a decode step, equals that row run alone, bit for bit:
    the state lanes are summed in a fixed tree, never a batched GEMM."""
    _, _, tcfg, tp = _mixer_params(mode, seed=6)
    x = _t((np.random.default_rng(7).normal(size=(4, 6, 32)) * 0.5
            ).astype(np.float32))
    st = {n: _t(a) for n, a in _state(4, 8, fresh=False).items()}
    for lo, hi in ((0, 5), (5, 6)):
        y4, st4 = tssm.mamba(tp, x[:, lo:hi], tcfg, state=st)
        y1, st1 = tssm.mamba(tp, x[:1, lo:hi], tcfg,
                             state={n: t[:1] for n, t in st.items()})
        assert torch.equal(y1, y4[:1])
        assert all(torch.equal(st1[n], st4[n][:1]) for n in ("h", "conv"))
        st = st4


@functools.lru_cache(maxsize=None)
def _raw(name):
    """JAX's raw params of the reduced model ``name`` (the same in every
    mode), initialised as one compiled program."""
    jcfg = CONFIGS[name][0]().replace(dtype="float32")
    return jax.jit(jlm.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(3))


@functools.lru_cache(maxsize=None)
def _models(name, mode):
    """JAX's reduced model ``name`` in ``mode`` (raw and prepacked) and
    the port's copy of its prepacked params."""
    jmake, tmake = CONFIGS[name]
    jcfg = jmake().replace(pum=JPUM(mode=mode), dtype="float32")
    tcfg = tmake().replace(pum=TPUM(mode=mode), dtype="float32")
    raw = _raw(name)
    jp = jax.jit(lambda r: jlm.prepack_for_serving(r, jcfg))(raw)
    tp = bridge.params_from_numpy(to_numpy(jp), tcfg, device="cpu")
    return jcfg, raw, jp, tcfg, tp


def test_config_and_layout_come_across():
    """Jamba-v0.1, full and reduced, field for field the reference's;
    its 8-layer period: Mamba everywhere but position 4, MoE FFNs at odd
    positions; ``check_supported`` admits it, and 8 layers of the full
    width keep the whole layout."""
    for make, jmake in ((configs.get, jjamba.config),
                        (configs.get_reduced, jjamba.reduced)):
        got, want = make("jamba-v0.1-52b"), jmake()
        assert vars(got.moe) == vars(want.moe)
        assert {k: v for k, v in vars(got).items() if k not in ("moe",
                                                                "pum")} \
            == {k: v for k, v in vars(want).items() if k not in ("moe",
                                                                  "pum")}
    cut = configs.get("jamba-v0.1-52b").replace(num_layers=8)
    ttr.check_supported(cut)
    assert ttr.period(cut) == 8
    assert [ttr.layer_kinds(cut, j) for j in range(8)] == [
        ("attn" if j == 4 else "mamba", "moe" if j % 2 else "mlp")
        for j in range(8)]
    assert tssm._inner(cut) == 8192


@pytest.mark.parametrize("mode", ["pum", "int8"])
def test_prepack_packs_the_projections_and_bridge_round_trips(mode):
    """The port's prepack and JAX's through the bridge: the four Mamba
    projections packed, the conv, ``a_log``, ``d_skip``, the router and
    the expert stacks f32; the bridged tensors equal JAX's arrays, the
    raw (``bf16``) tree's and the packed one's."""
    tcfg = configs.get_reduced("jamba-v0.1-52b").replace(
        pum=TPUM(mode=mode))
    raw = tlm.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    jcfg, jraw, jp, _, bridged = _models("jamba", mode)
    for params in (prepack_params(raw, tcfg.pum), bridged):
        for j, blk in enumerate(params["blocks"]):
            if "mamba" in blk:
                m = blk["mamba"]
                assert all(isinstance(m[n]["w"], PackedLinear)
                           for n in LINEARS)
                assert all(m[n].dtype == torch.float32 for n in FLOAT_LEAVES)
                assert m["dt_proj"]["b"].dtype == torch.float32
            if "moe" in blk:
                assert isinstance(blk["moe"]["router"]["w"], torch.Tensor)
                assert all(blk["moe"][n].dtype == torch.float32 for n in
                           ("experts_wg", "experts_wu", "experts_wd"))
    # layer 0 is group 0 of position 0; layer 4 the attention position
    for tree, port in ((to_numpy(jp), bridged),
                       (to_numpy(jraw), bridge.params_from_numpy(
                           to_numpy(jraw), tcfg.replace(
                               pum=TPUM(mode="bf16")), device="cpu"))):
        jm, tm = tree["blocks"][0]["mamba"], port["blocks"][0]["mamba"]
        for n in FLOAT_LEAVES:
            np.testing.assert_array_equal(tm[n].numpy(), jm[n][0])
        np.testing.assert_array_equal(tm["dt_proj"]["b"].numpy(),
                                      jm["dt_proj"]["b"][0])
        for n in LINEARS:
            w = tm[n]["w"]
            if isinstance(w, PackedLinear):
                np.testing.assert_array_equal(w.wq.numpy(),
                                              jm[n]["w"]["wq"][0])
                np.testing.assert_array_equal(w.scale.numpy(),
                                              jm[n]["w"]["scale"][0])
            else:
                np.testing.assert_array_equal(w.numpy(), jm[n]["w"][0])
        assert "attn" in port["blocks"][4] and "mamba" not in \
            port["blocks"][4]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("mode", MODES)
def test_lm_forward_matches_jax(name, mode):
    """Logits with no state within LOGIT_TOL of JAX's; in ``pum``, a
    prefill into fresh contiguous states and two decode steps too, and
    the states: Mamba's h and conv window, the attention layers' K/V."""
    jcfg, _, jp, tcfg, tp = _models(name, mode)
    toks = np.random.default_rng(1).integers(0, 256, (2, 9)).astype(
        np.int32)
    jl, _, _ = _jax_forward(jp, jnp.asarray(toks), jcfg)
    tl, _ = tlm.forward(tp, _t(toks), tcfg)
    assert tl.shape == (2, 9, 256)
    _close(tl, jl)
    if mode != "pum":
        return
    jst = jlm.init_state(jcfg, 2, 16)
    tst = tlm.init_state(tcfg, 2, 16, device="cpu")
    jl, jst, _ = _jax_forward(jp, jnp.asarray(toks[:, :6]), jcfg,
                              states=jst, cache_index=0, last_only=True)
    tl, tst = tlm.forward(tp, _t(toks[:, :6]), tcfg, states=tst,
                          cache_index=0, last_only=True)
    _close(tl, jl)
    for i in (6, 7):
        idx = np.full((2,), i, np.int32)
        jl, jst, _ = _jax_forward(jp, jnp.asarray(toks[:, i:i + 1]), jcfg,
                                  states=jst, cache_index=jnp.asarray(idx),
                                  last_only=True)
        tl, tst = tlm.forward(tp, _t(toks[:, i:i + 1]), tcfg, states=tst,
                              cache_index=_t(idx), last_only=True)
        _close(tl, jl)
    period = ttr.period(tcfg)
    for layer, st in enumerate(tst):
        want = jst[layer % period]
        for n, t in st.items():
            np.testing.assert_allclose(
                t.float().numpy(),
                np.asarray(want[n][layer // period], np.float32),
                atol=1e-3, rtol=1e-3)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def ref(request):
    """JAX's scheduler runs of TRACE in both layouts, its static batch
    and one request through its solo greedy loop (``pum``), once per
    config; the port's params from the bridge."""
    jcfg, raw, _, tcfg, tp = _models(request.param, "pum")
    sched = {}
    for layout, kw in LAYOUTS.items():
        js = JSched(jcfg, raw, kernel_backend="xla", **SCHED, **kw)
        out = js.run([JRequest(p, m, arrival=a) for p, m, a in TRACE])
        sched[layout] = {rid: c.tokens for rid, c in out.items()}
    jeng = JEngine(jcfg, raw, max_len=24, kernel_backend="xla")
    prompt = np.random.default_rng(2).integers(0, 256, (2, 8)).astype(
        np.int32)
    static = np.asarray(jeng.generate(jnp.asarray(prompt), 6))
    solo_prompt = list(TRACE[1][0])
    solo = np.asarray(jeng.generate_loop(
        jnp.asarray([solo_prompt], jnp.int32), 8))[0, len(solo_prompt):
                                                      ].tolist()
    return dict(name=request.param, tcfg=tcfg, params=tp, sched=sched,
                static=static, prompt=prompt, solo=solo,
                solo_prompt=solo_prompt,
                solo_logits=jax_logits_along(jeng, solo_prompt, solo))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_scheduler_tokens_match_jax(ref, layout):
    """TRACE through the port's scheduler (paged: blocks of 4, chunked
    prefill; contiguous windows), JAX's tokens exactly.  The hybrid's
    rows are independent (no MoE), so each completion is also its
    request served alone through the port's ``generate_loop``; the
    reduced Jamba's MoE capacity couples its rows (its decode steps
    drop), as the reference's scheduler documents."""
    sched = ContinuousBatchingScheduler(ref["tcfg"], ref["params"],
                                        device="cpu", **SCHED,
                                        **LAYOUTS[layout])
    reqs = [Request(p, m, arrival=a, rid=i)
            for i, (p, m, a) in enumerate(TRACE)]
    got = {rid: c.tokens for rid, c in sched.run(reqs).items()}
    assert got == ref["sched"][layout]
    if ref["name"] == "hybrid":
        eng = ServeEngine(ref["tcfg"], ref["params"], max_len=24,
                          device="cpu")
        assert got == {r.rid: oracle_completion(eng, r) for r in reqs}


def test_static_batch_and_solo_loop_match_jax(ref):
    """The static batch: ``generate`` == ``generate_loop`` bit for bit
    and JAX's ``generate`` exactly; one request alone through
    ``generate_loop``, JAX's greedy tokens under the margin rule."""
    eng = ServeEngine(ref["tcfg"], ref["params"], max_len=24, device="cpu")
    tp = _t(ref["prompt"])
    got = eng.generate(tp, 6)
    assert torch.equal(got, eng.generate_loop(tp, 6))
    np.testing.assert_array_equal(got.numpy(), ref["static"])
    solo = oracle_completion(eng, Request(ref["solo_prompt"], 8))
    assert agree_outside_near_ties(solo, ref["solo"], ref["solo_logits"],
                                   LOGIT_TOL, 0.0) == 8


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_reused_slot_starts_with_fresh_mamba_rows(layout):
    """``lm.reset_states`` sets a slot's Mamba rows (h and the conv
    window) back to zeros, the others untouched, and a whole tree to its
    init values in place; a slot reused after another request holds,
    once its prompt is in, exactly the state a solo prefill of that
    prompt leaves (the hybrid, ``pum``, bit for bit)."""
    _, _, _, tcfg, tp = _models("hybrid", "pum")
    paged = layout == "paged"
    sched = ContinuousBatchingScheduler(
        tcfg, tp, num_slots=2, max_len=32, device="cpu",
        kv_block_size=2 if paged else 0, chunked_prefill=paged)
    sched.run([Request([9, 8, 7], 4, rid=9), Request([3, 3], 2, rid=8)])
    mamba = [st for j, st in enumerate(sched.states)
             if ttr.layer_kinds(tcfg, j)[0] == "mamba"]
    assert mamba and all(not bool((t == 0).all()) for st in mamba
                         for t in st.values())
    addrs = [t.data_ptr() for t in tlm.recurrent_tensors(tcfg, sched.states)]
    before = [t.clone() for st in mamba for t in st.values()]
    tlm.reset_states(tcfg, sched.states, row=1)
    for t, b in zip((t for st in mamba for t in st.values()), before):
        assert bool((t[1] == 0).all()) and torch.equal(t[0], b[0])
    req = Request(list(range(10, 17)), 3, rid=1)

    def holds_solo_prefill(n):
        solo, _ = sched.engine.prefill(torch.tensor([req.prompt[:n]],
                                                    dtype=torch.int32))
        return all(torch.equal(t[0], solo[j][name][0])
                   for j, st in enumerate(sched.states)
                   if ttr.layer_kinds(tcfg, j)[0] == "mamba"
                   for name, t in st.items())

    sched.start_request(req)                 # slot 0
    if not paged:
        assert holds_solo_prefill(len(req.prompt))
    else:
        assert all(bool((t[0] == 0).all()) for st in mamba
                   for t in st.values())
        streamed = 0
        while 0 in sched._prefills:
            sched.tick()
            if 0 in sched._prefills:
                assert holds_solo_prefill(sched._prefills[0].pos)
                streamed += 1
        assert streamed == 3                 # 7 tokens in chunks of 2
    tlm.reset_states(tcfg, sched.states)
    assert all(bool((t == 0).all()) for st in mamba for t in st.values())
    assert addrs == [t.data_ptr()
                     for t in tlm.recurrent_tensors(tcfg, sched.states)]


def test_cli_serves_the_reduced_jamba_contiguous_and_a_given_cut(capsys):
    """``--arch jamba-v0.1-52b --reduced --device cpu --kv-block-size 0``
    serves from contiguous windows (the paged layout:
    ``tests/test_torch_imports.py``); ``main(cfg=...)`` serves the
    config it is given in place of ``--arch``'s, at ``--pum-mode``."""
    from repro_torch.launch import serve
    args = ["--arch", "jamba-v0.1-52b", "--reduced", "--device", "cpu",
            "--batch-slots", "2", "--requests", "3", "--prompt-len", "9",
            "--gen", "4", "--kv-block-size", "0"]
    res = serve.main(args)
    assert "kv=contiguous(max_len=14)" in capsys.readouterr().out
    assert not res["scheduler"].paged and res["scheduler"].prefill_chunks == 3
    assert [len(c.tokens) for c in res["completions"].values()] == [4] * 3
    cut = configs.get_reduced("jamba-v0.1-52b").replace(num_layers=16)
    res = serve.main(args + ["--pum-mode", "int8"], cfg=cut)
    assert "layers=16" in capsys.readouterr().out
    assert res["scheduler"].cfg == cut.replace(pum=TPUM(mode="int8"))
