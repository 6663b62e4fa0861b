"""The port's contiguous-cache serving paths against the JAX package's:
the online softmax ``_chunked_attention``, the contiguous-window
scheduler (``kv_block_size=0``, JAX at ``kernel_backend="xla"``) and
``ServeEngine.generate``, the compiled token loop.

  * ``_chunked_attention`` on equal f32 inputs runs the reference's
    blocks in the reference's order: it agrees with JAX's within
    ``CHUNK_TOL`` (f32 summation order only, ~1e-7 here).  With bf16
    K/V it stays within ``2^-6 E`` of the plain composition, E the
    p-weighted mean |V| of each output element (``chip_smoke.py``
    derives that bound and gates it at full width);
  * the contiguous scheduler emits JAX's contiguous scheduler's tokens
    under the margin rule of ``tests/test_torch_scheduler.py``, and
    inside the port its own solo ``generate_loop``'s and the paged
    scheduler's bit for bit;
  * ``generate`` equals ``generate_loop`` bit for bit, and JAX's
    ``generate`` under the margin rule.

The scheduler and engine tests run for the dense and the xLSTM family
(the reference's ``FAMILIES``): an xLSTM slot's row holds recurrent
state, which its admission window starts afresh and splices in whole.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (agree_outside_near_ties, jax_logits_along,
                         scores_at, to_numpy)
from repro.config import PUMConfig as JPUM, small_test_config as jsmall
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.serve import ContinuousBatchingScheduler as JSched
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.config import PUMConfig as TPUM, small_test_config as tsmall
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.models import attention as tattn
from repro_torch.models import lm
from repro_torch.serve import (ContinuousBatchingScheduler, Request,
                               RequestTooLarge, ServeEngine,
                               oracle_completion)

# equal f32 inputs through the same blocks: only the f32 sums' order
# differs between the frameworks
CHUNK_TOL = 1e-5
# f32 logits: the integer contractions are exact on equal inputs, the
# rest differs by f32 summation order; bf16 mode's float projections can
# flip a cached K/V cell's bf16 rounding (tests/test_torch_scheduler.py)
LOGIT_TOL = {"pum": 1e-4, "int8": 1e-4, "bf16": 2e-3}
KW = dict(dtype="float32")
FAMILIES = {"dense": dict(qkv_bias=True, tie_embeddings=True),
            "xlstm": dict(xlstm_slstm_every=2)}
MODES = ["pum", "int8", "bf16"]
SCHED = dict(num_slots=2, max_len=32, kv_block_size=0)
# the reference's test_scheduler_matches_oracle trace: staggered
# arrivals, more requests than slots, greedy and sampled rows; the last
# prompt is the vocabulary's last token
ORACLE_TRACE = [([1, 2, 3], 6, 0.0, 1, 0), ([4] * 6, 4, 0.8, 2, 1),
                ([5, 6], 7, 0.0, 3, 1), ([7, 8, 9, 10, 11], 3, 0.6, 4, 3),
                ([-1], 5, 0.0, 5, 8)]
GREEDY_TRACE = [([3, 1, 4, 1, 5], 8, 0.0, 0, 0),
                ([9, 2, 6, 5, 3, 5, 8], 6, 0.0, 0, 1), ([7, 7], 7, 0.0, 0, 2)]
TRACES = {"oracle": ORACLE_TRACE, "greedy": GREEDY_TRACE}


def _requests(trace, vocab, cls=Request):
    return [cls([t % vocab for t in p], m, temperature=t, seed=seed,
                arrival=a, rid=i)
            for i, (p, m, t, seed, a) in enumerate(trace)]


# ---------------------------------------------------------------------------
# _chunked_attention
# ---------------------------------------------------------------------------

def _chunk_inputs(s, t, g, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, s, 2, g, hd)).astype(np.float32)
    k = rng.standard_normal((1, t, 2, hd)).astype(np.float32)
    v = rng.standard_normal((1, t, 2, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("offset,t", [(0, 150), (60, 160)])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_chunked_attention_matches_jax(monkeypatch, chunk, offset, t,
                                       softcap):
    """Queries at ``offset + [0, 100)`` against ``t`` keys: offset 0 is
    the cache-free prompt (keys past the queries masked), 60 a prefill
    into a cache; both modules' blocks shrunk to ``chunk``."""
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "CHUNK_Q", chunk)
        monkeypatch.setattr(mod, "CHUNK_K", chunk)
    q, k, v = _chunk_inputs(100, t, 2, 16, seed=chunk + offset)
    want = jattn._chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), offset, softcap)
    got = tattn._chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(offset, dtype=torch.int32), softcap)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=CHUNK_TOL, rtol=CHUNK_TOL)


@pytest.mark.parametrize("offset", [0, 40])
def test_chunked_attention_bf16_within_its_bound(monkeypatch, offset):
    """bf16 K/V: the online softmax rounds p and each block's p @ V to
    bf16, the plain composition p and the output, so the two differ by
    at most 2^-6 of E = sum_t p_t |v_t| per element, plus 1e-6."""
    monkeypatch.setattr(tattn, "CHUNK_Q", 32)
    monkeypatch.setattr(tattn, "CHUNK_K", 32)
    s, t = 100, 150
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _chunk_inputs(s, t, 4, 32, seed=offset))
    mask = torch.arange(t)[None, :] <= offset + torch.arange(s)[:, None]
    got = tattn._chunked_attention(q, k, v, offset, 0.0)
    plain = pa_ref.plain_attention(q, k, v, mask, 0.0).float()
    scores = torch.einsum("bskgd,btkd->bksgt", q.float(), k.float()) \
        / np.sqrt(32)
    probs = pa_ref.softmax(torch.where(mask[None, None, :, None, :], scores,
                                       torch.tensor(pa_ref.NEG_INF)), 0.0)
    weighted = torch.einsum("bksgt,btkd->bskgd", probs, v.float().abs())
    err = (got - plain).abs()
    assert 0 < err.max() and bool((err <= 2.0 ** -6 * weighted + 1e-6).all())


def test_long_prompt_raises_on_the_paged_branch_only(monkeypatch):
    """A prompt over 2 * CHUNK_Q at once: the paged branch refuses it
    with the reference's message, the contiguous branch asks a scalar
    cache index of it."""
    monkeypatch.setattr(tattn, "CHUNK_Q", 4)
    cfg = tsmall(**KW, **FAMILIES["dense"])
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.arange(1, 10, dtype=torch.int32)[None]
    paged = lm.init_paged_state(cfg, 1, 16, num_blocks=4, block_size=4,
                                device="cpu")
    with pytest.raises(ValueError, match="enable chunked_prefill"):
        lm.forward(params, toks, cfg, states=paged,
                   cache_index=torch.zeros(1, dtype=torch.int32),
                   block_table=torch.arange(1, 5, dtype=torch.int32)[None],
                   kv_len=16)
    window = lm.init_state(cfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="scalar cache_index"):
        lm.forward(params, toks, cfg, states=window,
                   cache_index=torch.zeros(1, dtype=torch.int32))
    logits, _ = lm.forward(params, toks, cfg, states=window, cache_index=0)
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# The contiguous scheduler
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module",
                params=[(f, m) for f in FAMILIES for m in MODES],
                ids=[f"{f}-{m}" for f in FAMILIES for m in MODES])
def ref(request):
    """JAX's contiguous scheduler on each trace (its sampled rows in the
    partitionable threefry layout) with its scores along its own
    tokens, per family and mode; the port's params carried across by
    the bridge."""
    family, mode = request.param
    jcfg = jsmall(pum=JPUM(mode=mode), **KW, **FAMILIES[family])
    raw = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tsmall(pum=TPUM(mode=mode), **KW, **FAMILIES[family])
    params = bridge.params_from_numpy(
        to_numpy(jlm.prepack_for_serving(raw, jcfg)), tcfg, device="cpu")
    out = {}
    with jax.threefry_partitionable(True):
        js = JSched(jcfg, raw, kernel_backend="xla", **SCHED)
        for name, trace in TRACES.items():
            reqs = _requests(trace, jcfg.vocab_size, JRequest)
            done = js.run(reqs)
            out[name] = {r.rid: (done[r.rid].tokens, scores_at(
                jax_logits_along(js.engine, list(r.prompt),
                                 done[r.rid].tokens),
                r.temperature, r.seed)) for r in reqs}
    return dict(family=family, mode=mode, tcfg=tcfg, params=params,
                jcfg=jcfg, raw=raw, jax=out, jsched=js)


def _sched(ref, **kw):
    return ContinuousBatchingScheduler(ref["tcfg"], ref["params"],
                                       device="cpu", **{**SCHED, **kw})


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_contiguous_scheduler_matches_jax_and_own_oracle(ref, trace):
    sched = _sched(ref)
    reqs = _requests(TRACES[trace], ref["tcfg"].vocab_size)
    out = sched.run(reqs)
    compared = 0
    for req in reqs:
        got = out[req.rid].tokens
        assert len(got) == req.max_tokens
        assert got == oracle_completion(sched.engine, req)
        want, scores = ref["jax"][trace][req.rid]
        compared += agree_outside_near_ties(
            got, want, scores, LOGIT_TOL[ref["mode"]], req.temperature)
    assert compared >= sum(r.max_tokens for r in reqs) // 2
    assert sched.step_programs() == {
        "decode": 1, "prefill": {n: 1 for n in {len(r.prompt)
                                                 for r in reqs}}}


@pytest.mark.parametrize("block,chunked", [(4, False), (4, True), (1, True)])
def test_contiguous_equals_paged(ref, block, chunked):
    """The same trace through contiguous windows and the paged pool:
    every row attends over the whole window in both, so the tokens are
    equal bit for bit, with monolithic or chunked paged prefill."""
    reqs = _requests(ORACLE_TRACE + GREEDY_TRACE, ref["tcfg"].vocab_size)
    contig = _sched(ref).run(reqs)
    paged = _sched(ref, kv_block_size=block,
                   chunked_prefill=chunked).run(reqs)
    assert {r: c.tokens for r, c in contig.items()} == \
        {r: c.tokens for r, c in paged.items()}


def test_admission_splices_jax_insert_row(ref):
    """After admission the slot's row of every layer holds the prompt's
    K/V (JAX's state after ``_insert`` within the logit tolerance) and
    zeros exactly beyond it, or the recurrent state the prompt left
    (within 1e-3: it sums the prompt's f32 steps); the other slot's row
    is untouched: zero K/V, or a fresh state."""
    prompt = [5, 9, 2, 7, 1, 3]
    sched = _sched(ref)
    js = JSched(ref["jcfg"], ref["raw"], kernel_backend="xla", **SCHED)
    for s, req in ((sched, Request(prompt, 4, rid=0)),
                   (js, JRequest(prompt, 4, rid=0))):
        assert s.start_request(req) is None
    tol = LOGIT_TOL[ref["mode"]]
    n = len(prompt)
    period = len(js.states)
    fresh = lm.init_state(ref["tcfg"], 1, SCHED["max_len"], device="cpu")
    for layer, st in enumerate(sched.states):
        jstate = js.states[layer % period]
        for name, t in st.items():
            got = t[0].float().numpy()
            want = np.asarray(jstate[name][layer // period, 0].astype(
                jnp.float32))
            if name in ("k", "v"):
                np.testing.assert_allclose(got[:n], want[:n],
                                           atol=tol * 10, rtol=2.0 ** -7)
                assert not got[n:].any() and not want[n:].any()
            else:
                np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
            assert torch.equal(t[1], fresh[layer][name][0])


def test_instant_completions_leave_the_slot_free(ref):
    """``max_tokens == 1`` and an EOS as token 0 complete at admission,
    occupying no slot, and match JAX's contiguous scheduler and the
    solo oracle."""
    sched = _sched(ref)
    probe = Request([4, 4, 2], 3, rid=0)
    first = oracle_completion(sched.engine, probe)[0]
    reqs = [Request([1, 2, 3], 1, rid=0),
            Request([4, 4, 2], 3, eos_id=first, rid=1),
            Request([6, 5], 3, arrival=1, rid=2)]
    comp = sched.start_request(reqs[0])
    assert comp.tokens and comp.finish_reason == "length"
    assert comp.admitted_step == comp.finished_step == 0
    comp = sched.start_request(reqs[1], step=2)
    assert comp.tokens == [first] and comp.finish_reason == "eos"
    assert not sched._active.any() and sched._free_slot() == 0
    sched._reset()
    out = sched.run(reqs)
    js = JSched(ref["jcfg"], ref["raw"], kernel_backend="xla", **SCHED)
    jout = js.run([JRequest(r.prompt, r.max_tokens, eos_id=r.eos_id,
                            arrival=r.arrival, rid=r.rid) for r in reqs])
    for req in reqs:
        assert out[req.rid].tokens == oracle_completion(sched.engine, req)
        assert out[req.rid].finish_reason == jout[req.rid].finish_reason
    assert [out[r].tokens for r in (0, 1)] == [jout[r].tokens for r in (0, 1)]


def test_eos_frees_slot_for_queued_request(ref):
    sched = _sched(ref, num_slots=1)
    prompt = [3, 1, 4, 1, 5]
    solo = oracle_completion(sched.engine, Request(prompt, 8))
    eos = next((t for t in solo[1:-1] if t != solo[0]), None)
    if eos is None:
        pytest.skip("greedy rollout is constant; no mid-stream stop")
    reqs = [Request(prompt, 8, eos_id=eos, rid=0),
            Request([2, 7], 5, temperature=0.9, seed=42, rid=1)]
    out = sched.run(reqs)
    assert out[0].finish_reason == "eos"
    assert out[0].tokens == solo[:solo.index(eos) + 1]
    assert out[1].tokens == oracle_completion(sched.engine, reqs[1])
    assert out[1].admitted_step >= out[0].finished_step


@pytest.mark.parametrize("kw,match", [
    (dict(chunked_prefill=True), "chunked_prefill streams prompts"),
    (dict(prefix_cache=True), "prefix_cache shares paged pool blocks"),
    (dict(speculate_k=2), "speculative decoding rolls rejected"),
])
def test_paged_only_options_raise_like_jax(ref, kw, match):
    for cls, params in ((ContinuousBatchingScheduler, ref["params"]),
                        (JSched, ref["raw"])):
        with pytest.raises(ValueError, match=match):
            cls(ref["tcfg"] if cls is ContinuousBatchingScheduler
                else ref["jcfg"], params, num_slots=2, max_len=32,
                kv_block_size=0, **kw)


def test_contiguous_validation_counts_no_blocks(ref):
    """A contiguous window is bound by ``max_len`` alone: any request
    that fits it is admitted, one that does not raises."""
    sched = _sched(ref)
    sched.validate_request(Request(list(range(1, 28)), 5))
    with pytest.raises(RequestTooLarge):
        sched.validate_request(Request(list(range(1, 28)), 6))


def test_long_prompt_through_the_online_softmax(ref, monkeypatch):
    """A prompt of 20 tokens with blocks of 8 (over 2 * CHUNK_Q) takes
    the online softmax at admission and in the solo loop: the scheduler
    equals ``generate_loop`` bit for bit, and JAX's solo loop (blocks
    shrunk before its engine traces) under the margin rule.  An xLSTM
    stack has no attention: its prompts of 20 tokens run the recurrence
    under the same rules."""
    calls = []
    chunked = tattn._chunked_attention
    monkeypatch.setattr(tattn, "_chunked_attention",
                        lambda *a: calls.append(1) or chunked(*a))
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "CHUNK_Q", 8)
        monkeypatch.setattr(mod, "CHUNK_K", 8)
    prompt = [(7 * i + 3) % 256 for i in range(20)]
    reqs = [Request(prompt, 6, rid=0),
            Request(prompt[:5], 6, temperature=0.7, seed=9, rid=1),
            Request(prompt[::-1], 5, temperature=1.0, seed=3, rid=2)]
    sched = _sched(ref)
    out = sched.run(reqs)
    n_attn = sum(st.keys() == {"k", "v"} for st in sched.states)
    assert n_attn == (ref["tcfg"].num_layers if ref["family"] == "dense"
                      else 0)
    assert len(calls) == 2 * n_attn            # two prompts of 20 tokens
    jeng = JEngine(ref["jcfg"], ref["raw"], max_len=SCHED["max_len"],
                   kernel_backend="xla")
    for req in reqs:
        got = out[req.rid].tokens
        assert got == oracle_completion(sched.engine, req)
        with jax.threefry_partitionable(True):
            want = jeng.generate_loop(jnp.asarray([req.prompt], jnp.int32),
                                      req.max_tokens,
                                      temperature=req.temperature,
                                      seed=req.seed)
            want = np.asarray(want)[0, len(req.prompt):].tolist()
            scores = scores_at(jax_logits_along(jeng, req.prompt, want),
                               req.temperature, req.seed)
        assert agree_outside_near_ties(got, want, scores,
                                       LOGIT_TOL[ref["mode"]],
                                       req.temperature) >= 2


# ---------------------------------------------------------------------------
# ServeEngine.generate: the compiled token loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(FAMILIES))
def engines(request):
    """The port's engine and JAX's on the same model (pum) of each
    family."""
    family = request.param
    jcfg = jsmall(pum=JPUM(mode="pum"), **KW, **FAMILIES[family])
    raw = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    tcfg = tsmall(pum=TPUM(mode="pum"), **KW, **FAMILIES[family])
    params = bridge.params_from_numpy(
        to_numpy(jlm.prepack_for_serving(raw, jcfg)), tcfg, device="cpu")
    prompt = np.random.default_rng(1).integers(0, 256, (2, 8)).astype(
        np.int32)
    return dict(port=ServeEngine(tcfg, params, max_len=48, device="cpu"),
                jax=JEngine(jcfg, raw, max_len=48, kernel_backend="xla"),
                prompt=prompt)


@pytest.mark.parametrize("steps", [0, 1, 6])
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_generate_equals_loop_and_jax(engines, steps, temperature):
    """Bit for bit the port's loop; JAX's ``generate`` under the margin
    rule, row by row (a row's logits do not depend on its co-tenant)."""
    eng, prompt = engines["port"], engines["prompt"]
    tp = torch.from_numpy(prompt)
    got = eng.generate(tp, steps, temperature=temperature, seed=3)
    assert got.shape == (2, 8 + steps)
    assert torch.equal(got, eng.generate_loop(tp, steps, temperature, 3))
    assert torch.equal(got, eng.generate(tp, steps, temperature, 3,
                                         use_scan=False))
    if steps == 0:
        assert got is tp
        return
    assert eng.scan_programs()[(2, 8, temperature)] == 1
    jeng = engines["jax"]
    with jax.threefry_partitionable(True):
        want = np.asarray(jeng.generate(jnp.asarray(prompt), steps,
                                        temperature=temperature, seed=3))
        for row in range(2):
            theirs = want[row, 8:].tolist()
            scores = scores_at(
                jax_logits_along(jeng, prompt[row].tolist(), theirs),
                temperature, 3, row=row, batch=2)
            agree_outside_near_ties(got[row, 8:].tolist(), theirs, scores,
                                    LOGIT_TOL["pum"], temperature)


def test_generate_seeds_and_builds(engines):
    """The same seed gives the same tokens and builds nothing new;
    another seed other tokens; another step count nothing new (the
    decode step replays), another temperature one new pair of
    programs."""
    eng, tp = engines["port"], torch.from_numpy(engines["prompt"])
    a = eng.generate(tp, 6, temperature=0.9, seed=3)
    before = eng.scan_programs()
    b = eng.generate(tp, 6, temperature=0.9, seed=3)
    c = eng.generate(tp, 6, temperature=0.9, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert eng.scan_programs() == before
    assert torch.equal(eng.generate(tp, 5, temperature=0.9, seed=3),
                       a[:, :13])
    assert eng.scan_programs() == before
    eng.generate(tp, 5, temperature=0.8, seed=3)
    assert eng.scan_programs() == {**before, (2, 8, 0.8): 1}
    assert eng.graphs_captured() == (0, 0.0)      # no graphs on a CPU


def test_generate_without_scan_is_the_loop(engines):
    tcfg = engines["port"].cfg
    eng = ServeEngine(tcfg, engines["port"].params, max_len=48,
                      device="cpu", use_scan=False)
    tp = torch.from_numpy(engines["prompt"])
    assert torch.equal(eng.generate(tp, 4, seed=1),
                       engines["port"].generate(tp, 4, seed=1))
    assert eng.scan_programs() == {}

