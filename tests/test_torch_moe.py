"""The port's MoE family (``models/moe.py`` and the MoE stacks of
``lm.forward``, both schedulers and the static batch) against the JAX
package's, on numpy inputs and on JAX's weights carried across by the
bridge, in f32, at the reduced OLMoE-1B-7B and granite-moe-1b-a400m.

Tolerances:

  * ``moe_ffn`` on equal inputs: the routing indices, their order among
    equal probabilities and the drop set are integer results of equal
    f32 router logits, so they are equal; the outputs and both aux
    losses differ only by the f32 summation order of the router and
    expert matmuls, some 1e-7 relative, and are held within ``FFN_TOL``
    (1e-5 relative).  A drop set that differed would miss it by O(1),
    so the capacity factors 0.25 and 1.25, where assignments are
    dropped, hold the dispatch itself.
  * logits of the small models within ``LOGIT_TOL``: integer
    contractions of ``int8``/``pum`` are exact on equal inputs, but an
    f32 difference in an activation can move its int8 quantisation by a
    step where it sits on a rounding edge (tests/test_torch_xlstm.py).
  * tokens: the solo ``generate_loop`` under the margin rule of
    tests/test_torch_scheduler.py (JAX's solo logits along its own
    tokens).  A scheduled or batched row's logits depend on its
    co-tenants through the shared capacity, so there is no solo margin
    to read: the schedulers and the static batch must give JAX's tokens
    exactly, which they do wherever the batch's logits (within
    ``LOGIT_TOL`` of JAX's) hold no near-tie, as on this trace.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import agree_outside_near_ties, jax_logits_along, to_numpy
from repro.config import MoEConfig as JMoE, ModelConfig as JConfig
from repro.config import PUMConfig as JPUM
from repro.configs import granite_moe_1b_a400m as jgranite
from repro.configs import olmoe_1b_7b as jolmoe
from repro.kernels.paged_attention import ref as jpa_ref
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serve import ContinuousBatchingScheduler as JSched
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch import bridge, configs
from repro_torch.config import MoEConfig as TMoE, ModelConfig as TConfig
from repro_torch.config import PUMConfig as TPUM
from repro_torch.core.prepack import PackedLinear, prepack_params
from repro_torch.kernels.paged_attention import ref as tpa_ref
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.serve import (ContinuousBatchingScheduler, Request,
                               ServeEngine, oracle_completion)

FFN_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = 2e-4
ARCHS = {"olmoe-1b-7b": jolmoe, "granite-moe-1b-a400m": jgranite}
MODES = ["pum", "int8", "bf16"]
FFN_DIMS = dict(d_model=32, d_ff=48)
TRACE = [([3, 1, 4, 1, 5], 8, 0), ([9, 2, 6, 5, 3, 5, 8], 6, 1),
         ([7, 7], 7, 2)]
SCHED = dict(num_slots=2, max_len=24)
LAYOUTS = {"paged": dict(kv_block_size=4, chunked_prefill=True),
           "contiguous": dict(kv_block_size=0)}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _ffn_cfgs(experts, k, cf):
    return (JConfig(**FFN_DIMS, moe=JMoE(num_experts=experts, top_k=k,
                                         capacity_factor=cf)),
            TConfig(**FFN_DIMS, moe=TMoE(num_experts=experts, top_k=k,
                                         capacity_factor=cf)))


def _ffn_params(jcfg, seed):
    p = to_numpy(jmoe.init_moe(jax.random.PRNGKey(seed), jcfg))
    return (jax.tree_util.tree_map(jnp.asarray, p),
            {"router": {"w": _t(p["router"]["w"])},
             **{k: _t(v) for k, v in p.items() if k != "router"}})


def _jax_routing(jp, x, k):
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, x.shape[-1]))
                           @ jp["router"]["w"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, k)[1])


def _port_routing(tp, x, tcfg):
    return tmoe.route(tp, _t(x.reshape(-1, x.shape[-1])), tcfg)[3].numpy()


def _ranks(idx):
    """Each flat assignment's rank among its expert's earlier ones."""
    flat = idx.reshape(-1)
    return np.array([(flat[:i] == e).sum() for i, e in enumerate(flat)])


@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
@pytest.mark.parametrize("experts,k,shape", [(8, 2, (2, 24)),
                                             (16, 4, (3, 7))])
def test_moe_ffn_matches_jax(cf, experts, k, shape):
    """Routing indices equal, slots equal to a brute-force rank, drops at
    cf 0.25 and 1.25; outputs and aux losses within FFN_TOL."""
    jcfg, tcfg = _ffn_cfgs(experts, k, cf)
    jp, tp = _ffn_params(jcfg, seed=experts + k)
    x = np.random.default_rng(k).normal(size=shape + (32,)).astype(
        np.float32)
    idx = _port_routing(tp, x, tcfg)
    np.testing.assert_array_equal(idx, _jax_routing(jp, x, k))
    slots = tmoe.dispatch_slots(_t(idx), experts).numpy()
    np.testing.assert_array_equal(slots, _ranks(idx))
    dropped = int((slots >= tmoe.capacity(shape[0] * shape[1], tcfg)).sum())
    assert (dropped > 0) == (cf < 8.0), dropped
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_ffn(tp, _t(x), tcfg)
    assert ty.shape == shape + (32,) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FFN_TOL)
    for name in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=1e-5)
    assert tmoe.moe_ffn(tp, _t(x), tcfg, aux=False)[1] == {}


def test_combine_equals_index_put_of_kept_rows():
    """The dispatch's spare-row scatter against a plain ``index_put_``
    of the kept rows into zeros, and the combine's chain of adds against
    a scatter-add in flat order: equal outputs."""
    jcfg, tcfg = _ffn_cfgs(8, 2, 1.25)
    _, tp = _ffn_params(jcfg, seed=3)
    x = _t(np.random.default_rng(3).normal(size=(40, 32)).astype(
        np.float32))
    _, _, vals, idx = tmoe.route(tp, x, tcfg)
    cap = tmoe.capacity(40, tcfg)
    got = tmoe._dispatch_ffn(tp, x, vals, idx, tcfg, cap)
    flat = idx.reshape(-1)
    slot = tmoe.dispatch_slots(idx, 8)
    keep = slot < cap
    assert not bool(keep.all())
    buf = torch.zeros((8, cap, 32))
    buf[flat[keep], slot[keep]] = x.repeat_interleave(2, 0)[keep]
    act = torch.nn.functional.silu(buf @ tp["experts_wg"]) * (
        buf @ tp["experts_wu"])
    out_e = act @ tp["experts_wd"]
    want = torch.zeros((40, 32)).index_put_(
        (torch.arange(40).repeat_interleave(2)[keep],),
        out_e[flat[keep], slot[keep]] * vals.reshape(-1, 1)[keep],
        accumulate=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_capacity_is_over_every_row_of_the_call():
    """The sort and the capacity span all B * S rows of a call, as the
    reference's default (global) dispatch: at capacity 1.25 a batch of 4
    sequences of 8 tokens has 20 slots an expert, not 5 a sequence, and
    gives the same bits as its rows in one sequence, and JAX's output
    within FFN_TOL."""
    x = np.random.default_rng(6).normal(size=(4, 8, 32)).astype(np.float32)
    jcfg, tcfg = _ffn_cfgs(4, 2, 1.25)
    jp, tp = _ffn_params(jcfg, seed=5)
    assert tmoe.capacity(32, tcfg) == 20 and tmoe.capacity(8, tcfg) == 5
    slots = tmoe.dispatch_slots(_t(_port_routing(tp, x, tcfg)), 4).numpy()
    assert (slots >= 5).any() and not (slots >= 20).any()
    got = tmoe.moe_ffn(tp, _t(x), tcfg)[0]
    assert torch.equal(got.reshape(1, 32, 32),
                       tmoe.moe_ffn(tp, _t(x.reshape(1, 32, 32)), tcfg)[0])
    want, _ = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN_TOL)


def test_tied_probabilities_take_the_lower_experts_first():
    """A zero router weight makes every probability equal: JAX's top_k
    takes experts 0..k-1 in order, and so must the port."""
    jcfg, tcfg = _ffn_cfgs(16, 4, 1.25)
    jp, tp = _ffn_params(jcfg, seed=0)
    jp = dict(jp, router={"w": jnp.zeros_like(jp["router"]["w"])})
    tp = dict(tp, router={"w": torch.zeros_like(tp["router"]["w"])})
    x = np.random.default_rng(0).normal(size=(1, 5, 32)).astype(np.float32)
    want = np.tile(np.arange(4), (5, 1))
    np.testing.assert_array_equal(_jax_routing(jp, x, 4), want)
    np.testing.assert_array_equal(_port_routing(tp, x, tcfg), want)


@functools.lru_cache(maxsize=None)
def _models(arch, mode):
    """JAX's reduced model of ``arch`` in ``mode`` (raw and prepacked)
    and the port's copy of its prepacked params."""
    jcfg = ARCHS[arch].reduced().replace(pum=JPUM(mode=mode),
                                         dtype="float32")
    tcfg = configs.get_reduced(arch).replace(pum=TPUM(mode=mode),
                                             dtype="float32")
    raw = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    jp = jlm.prepack_for_serving(raw, jcfg)
    tp = bridge.params_from_numpy(to_numpy(jp), tcfg, device="cpu")
    return jcfg, raw, jp, tcfg, tp


def test_configs_come_across_value_for_value():
    """Both MoE configs, full and reduced, field for field the
    reference's; every layer attention with an MoE FFN."""
    for arch, mod in ARCHS.items():
        for make, jmake in ((configs.get, mod.config),
                            (configs.get_reduced, mod.reduced)):
            got, want = make(arch), jmake()
            assert vars(got.moe) == vars(want.moe)
            assert {k: v for k, v in vars(got).items()
                    if k not in ("moe", "pum")} == \
                {k: v for k, v in vars(want).items()
                 if k not in ("moe", "pum")}
        cfg = configs.get(arch)
        ttr.check_supported(cfg)
        assert [ttr.layer_kinds(cfg, j) for j in range(cfg.num_layers)] \
            == [("attn", "moe")] * cfg.num_layers


@pytest.mark.parametrize("mode", ["pum", "int8"])
def test_prepack_leaves_router_and_experts_float(mode):
    """The port's own prepack, and JAX's through the bridge: q/k/v/o
    packed, the router and the expert stacks f32."""
    tcfg = configs.get_reduced("olmoe-1b-7b").replace(pum=TPUM(mode=mode))
    raw = tlm.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    bridged = _models("granite-moe-1b-a400m", mode)[4]
    for params in (prepack_params(raw, tcfg.pum), bridged):
        for blk in params["blocks"]:
            assert all(isinstance(blk["attn"][w]["w"], PackedLinear)
                       for w in ("wq", "wk", "wv", "wo"))
            m = blk["moe"]
            assert isinstance(m["router"]["w"], torch.Tensor)
            assert m["router"]["w"].dtype == torch.float32
            e, d = len(m["experts_wg"]), m["router"]["w"].shape[0]
            assert m["router"]["w"].shape == (d, e)
            assert m["experts_wd"].shape[:2] == (e, m["experts_wg"].shape[2])
            assert all(m[n].dtype == torch.float32 for n in
                       ("experts_wg", "experts_wu", "experts_wd"))
    assert torch.equal(prepack_params(raw, tcfg.pum)["blocks"][0]["moe"][
        "router"]["w"], raw["blocks"][0]["moe"]["router"]["w"])


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("mode", MODES)
def test_lm_forward_matches_jax(arch, mode):
    """Both reduced MoE configs, JAX's weights through the bridge: logits
    with no state, and (``pum``) a prefill into fresh states then two
    decode steps (a batch of two: the capacity is shared), within
    LOGIT_TOL."""
    jcfg, _, jp, tcfg, tp = _models(arch, mode)
    toks = np.random.default_rng(1).integers(0, 256, (2, 9)).astype(
        np.int32)
    jl, _, _ = jlm.forward(jp, jnp.asarray(toks), jcfg)
    tl, _ = tlm.forward(tp, _t(toks), tcfg)
    assert tl.shape == (2, 9, 256)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    if mode != "pum":
        return
    jst = jlm.init_state(jcfg, 2, 16)
    tst = tlm.init_state(tcfg, 2, 16, device="cpu")
    jl, jst, _ = jlm.forward(jp, jnp.asarray(toks[:, :6]), jcfg, states=jst,
                             cache_index=0, last_only=True)
    tl, tst = tlm.forward(tp, _t(toks[:, :6]), tcfg, states=tst,
                          cache_index=0, last_only=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    for i in (6, 7):
        idx = np.full((2,), i, np.int32)
        jl, jst, _ = jlm.forward(jp, jnp.asarray(toks[:, i:i + 1]), jcfg,
                                 states=jst, cache_index=jnp.asarray(idx),
                                 last_only=True)
        tl, tst = tlm.forward(tp, _t(toks[:, i:i + 1]), tcfg, states=tst,
                              cache_index=_t(idx), last_only=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def ref(request):
    """JAX's scheduler runs of TRACE in both layouts, its static batch
    and its solo greedy loop, at the config's own capacity factor
    (``pum``), built once per arch; the port's params from the bridge."""
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
        jnp.asarray([solo_prompt], jnp.int32), 8))[0, 7:].tolist()
    return dict(tcfg=tcfg, params=tp, sched=sched, static=static,
                prompt=prompt, solo=solo, solo_prompt=solo_prompt,
                solo_logits=jax_logits_along(jeng, solo_prompt, solo))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_scheduler_tokens_match_jax(ref, layout):
    """TRACE through the port's scheduler, JAX's tokens exactly.  The
    reduced OLMoE drops at decode (2 slots, one slot an expert, so two
    rows routed to one expert contest it, an idle row among them);
    granite's 4 experts take 2 rows each, so it drops only in prefill
    (a chunk of 4 tokens: 3 slots an expert)."""
    sched = ContinuousBatchingScheduler(ref["tcfg"], ref["params"],
                                        device="cpu", **SCHED,
                                        **LAYOUTS[layout])
    out = sched.run([Request(p, m, arrival=a) for p, m, a in TRACE])
    assert {rid: c.tokens for rid, c in out.items()} == ref["sched"][layout]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_no_drop_scheduler_equals_each_request_alone(arch, layout):
    """At capacity factor E / k an expert takes every row of a call, so
    no assignment is dropped and no row depends on the rows beside it,
    idle ones included: each completion is its request served alone
    through ``generate_loop``, token for token (on the CPU a row's
    products do not depend on the batch's size either)."""
    _, _, _, tcfg, tp = _models(arch, "pum")
    m = tcfg.moe
    tcfg = tcfg.replace(moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    reqs = [Request(p, m, arrival=a, rid=i)
            for i, (p, m, a) in enumerate(TRACE)]
    sched = ContinuousBatchingScheduler(tcfg, tp, device="cpu", **SCHED,
                                        **LAYOUTS[layout])
    out = sched.run(reqs)
    eng = ServeEngine(tcfg, tp, max_len=24, device="cpu")
    assert {r.rid: out[r.rid].tokens for r in reqs} == \
        {r.rid: oracle_completion(eng, r) for r in reqs}


def test_static_batch_and_solo_loop_match_jax(ref):
    """The static batch (two rows sharing the capacity): ``generate`` ==
    ``generate_loop`` bit for bit and JAX's ``generate`` exactly; one
    request alone through ``generate_loop`` under the margin rule."""
    eng = ServeEngine(ref["tcfg"], ref["params"], max_len=24, device="cpu")
    tp = _t(ref["prompt"])
    got = eng.generate(tp, 6)
    assert torch.equal(got, eng.generate_loop(tp, 6))
    np.testing.assert_array_equal(got.numpy(), ref["static"])
    prompt = ref["solo_prompt"]
    solo = oracle_completion(eng, Request(prompt, 8))
    assert agree_outside_near_ties(solo, ref["solo"], ref["solo_logits"],
                                   LOGIT_TOL, 0.0) == 8


def _dup_case(seed, s, past_width):
    """Five rows over a pool of 8 blocks of 4: rows 0 and 2 live in
    blocks of their own, rows 1, 3 and 4 idle (all-zero tables) at
    depths that send them to one trash cell; with ``past_width`` row 2
    also writes past its two-column table into the trash block."""
    rng = np.random.default_rng(seed)
    b, kvh, grp, hd, nb, bs, w = 5, 2, 2, 8, 8, 4, 2
    table = np.zeros((b, w), np.int32)
    table[0] = [1, 2]
    table[2] = [3, 4]
    ci = np.array([1, 6, 9 - s if past_width else 2, 2, 10], np.int32)

    def rnd(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return (rnd(b, s, kvh, grp, hd), rnd(b, s, kvh, hd), rnd(b, s, kvh, hd),
            rnd(nb, bs, kvh, hd), rnd(nb, bs, kvh, hd), table, table, ci)


@pytest.mark.parametrize("s,past_width", [(1, False), (3, False),
                                          (3, True)])
def test_duplicate_trash_writes_match_jax(s, past_width):
    """Several rows writing one trash cell in a call: the last (row,
    position) wins in JAX's composition on the CPU, and in the port's
    plain version, on bf16 pools bit for bit (against the kernel's
    reference without a past-width row, whose column it clips; against
    the model's paged write with one); the port's model path leaves the
    same pools."""
    args = _dup_case(s, s, past_width)
    jargs = [jnp.asarray(a) for a in args]
    targs = [_t(a) for a in args]
    for i in (3, 4):
        jargs[i] = jargs[i].astype(jnp.bfloat16)
        targs[i] = targs[i].to(torch.bfloat16)
    tk, tv, tout = tpa_ref.paged_attention_ref(*targs, kv_len=8)
    if past_width:
        cache, _, _, _ = jattn._paged_update_and_gather(
            {"k_pool": jargs[3], "v_pool": jargs[4]}, jargs[1], jargs[2],
            jargs[5], jargs[7], 8, write_table=jargs[6])
        jk, jv = cache["k_pool"], cache["v_pool"]
    else:
        jk, jv, jout = jpa_ref.paged_attention_ref(*jargs, kv_len=8)
        np.testing.assert_allclose(
            tout.float().numpy(), np.asarray(jout.astype(jnp.float32)),
            rtol=2e-2, atol=2e-2)
    for got, want in ((tk, jk), (tv, jv)):
        assert torch.equal(got.float(),
                           _t(np.asarray(want.astype(jnp.float32))))
    # row 4, the last of the rows, wrote every trash cell it shares
    for j in range(s):
        assert torch.equal(tk[0, (10 + j) % 4],
                           targs[1][4, j].to(torch.bfloat16))
    cache = {"k_pool": targs[3].clone(), "v_pool": targs[4].clone()}
    tattn._paged_update_and_gather(cache, targs[1], targs[2], targs[5],
                                   _t(args[7]), 8, write_table=targs[6])
    assert torch.equal(cache["k_pool"], tk)
    assert torch.equal(cache["v_pool"], tv)
