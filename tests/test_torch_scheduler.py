"""The port's continuous-batching scheduler against the JAX package's
(``kernel_backend="xla"``): the dense and the xLSTM family (the
reference's ``FAMILIES``) x {pum, int8, bf16}, paged KV blocks of 4,
chunked prefill, three staggered greedy requests.  An xLSTM stack pages
no KV: its requests take 0 blocks, and its prompts stream in chunks
through their slot's recurrent rows.

  * teacher forcing: JAX's greedy tokens fed through the port's prefill
    and decode steps give per-step logits within ``LOGIT_TOL`` of JAX's
    (``BF16_MODE_LOGIT_TOL`` in bf16 mode; for xLSTM in int8/pum, one
    step of a request may be within ``FLIP_TOL``);
  * the port's scheduler emits JAX's tokens wherever JAX's top-2 logit
    margin exceeds 10x that tolerance (past a near-tie the two may
    legitimately diverge);
  * inside the port, the scheduler's tokens equal its own solo oracle
    (``ServeEngine.generate_loop``) bit for bit.

Sampled traces (temperatures 0, 0.7 and 1.0, a seed a request) run with
JAX in its partitionable threefry layout, which the port reproduces
(``tests/test_torch_sampling.py``): there the port emits JAX's token
wherever the top-2 margin of JAX's Gumbel-perturbed scores
(``gumbel + logits / t``) exceeds 10x the logit tolerance over ``t`` --
the greedy rule, scaled by the temperature, since the scores carry the
logits' difference divided by ``t``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (agree_outside_near_ties, jax_logits_along, margin,
                         scores_at, to_numpy)
from repro.config import PUMConfig as JPUM, small_test_config as jsmall
from repro.models import lm as jlm
from repro.serve import ContinuousBatchingScheduler as JSched
from repro.serve import Request as JRequest
from repro_torch import bridge
from repro_torch.config import PUMConfig as TPUM, small_test_config as tsmall
from repro_torch.kernels import registry
from repro_torch.serve import (ContinuousBatchingScheduler, Request,
                               oracle_completion)
from repro_torch.serve.scheduler import SchedulerStalled

# f32 logits: integer contractions are exact on equal inputs, the rest
# differs by f32 summation order (~1e-7 at this size)
LOGIT_TOL = 1e-4
# bf16 mode's projections are float matmuls: their f32 summation-order
# differences can flip the bf16 rounding of a cached K/V cell (2^-8
# relative), which moves these logits by a few 1e-4
BF16_MODE_LOGIT_TOL = 2e-3
# xLSTM in int8/pum: XLA's and torch's exp, log-sigmoid and tanh differ
# by an ulp here and there, and an activation on an int8 rounding edge
# then quantises one step apart; one step of one input of a projection
# moves these logits by up to ~5e-3 at the step it happens (the states
# carry it on at the 1e-7 level).  So at most one step of a request may
# exceed the logit tolerance, and by no more than FLIP_TOL
FLIP_TOL = 1e-2
TRACE = [([3, 1, 4, 1, 5], 8, 0), ([9, 2, 6, 5, 3, 5, 8], 6, 1),
         ([7, 7], 7, 2)]
KW = dict(dtype="float32")
FAMILIES = {"dense": dict(qkv_bias=True, tie_embeddings=True),
            "xlstm": dict(xlstm_slstm_every=2)}
MODES = ["pum", "int8", "bf16"]
SCHED = dict(num_slots=2, max_len=24, kv_block_size=4, chunked_prefill=True)


@pytest.fixture(scope="module",
                params=[(f, m) for f in FAMILIES for m in MODES],
                ids=[f"{f}-{m}" for f in FAMILIES for m in MODES])
def ref(request):
    """JAX's scheduler run and per-step solo logits, built once per
    family and mode; and the port's params carried across by the
    bridge."""
    family, mode = request.param
    jcfg = jsmall(pum=JPUM(mode=mode), **KW, **FAMILIES[family])
    raw = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    js = JSched(jcfg, raw, kernel_backend="xla", **SCHED)
    out = js.run([JRequest(p, m, arrival=a) for p, m, a in TRACE])
    tokens = {rid: out[rid].tokens for rid in out}
    logits = {rid: jax_logits_along(js.engine, prompt, tokens[rid])
              for rid, (prompt, _, _) in enumerate(TRACE)}
    tcfg = tsmall(pum=TPUM(mode=mode), **KW, **FAMILIES[family])
    params = bridge.params_from_numpy(
        to_numpy(jlm.prepack_for_serving(raw, jcfg)), tcfg, device="cpu")
    tol = BF16_MODE_LOGIT_TOL if mode == "bf16" else LOGIT_TOL
    return dict(family=family, mode=mode, tcfg=tcfg, params=params, tokens=tokens,
                logits=logits, tol=tol, jcfg=jcfg, raw=raw,
                jengine=js.engine)


def test_teacher_forced_logits_match(ref):
    sched = ContinuousBatchingScheduler(ref["tcfg"], ref["params"],
                                        device="cpu", **SCHED)
    eng = sched.engine
    for rid, (prompt, _, _) in enumerate(TRACE):
        states, lg = eng.prefill(torch.tensor([prompt], dtype=torch.int32))
        steps = [lg[0, -1]]
        for i, tok in enumerate(ref["tokens"][rid][:-1]):
            lg, states = eng.decode(states,
                                    torch.tensor([[tok]], dtype=torch.int32),
                                    len(prompt) + i)
            steps.append(lg[0, -1])
        got = torch.stack(steps).numpy()
        want = ref["logits"][rid]
        err = np.abs(got - want).max(axis=-1)
        flips = ref["family"] == "xlstm" and ref["mode"] != "bf16"
        assert (err > ref["tol"]).sum() <= (1 if flips else 0), err
        assert err.max() <= (FLIP_TOL if flips else ref["tol"]), err
        for i, row in enumerate(want):
            if margin(row) > 10 * ref["tol"]:
                assert int(got[i].argmax()) == ref["tokens"][rid][i]


def test_scheduler_tokens_match_jax_and_own_oracle(ref):
    sched = ContinuousBatchingScheduler(ref["tcfg"], ref["params"],
                                        device="cpu", **SCHED)
    registry.reset_launches()
    out = sched.run([Request(p, m, arrival=a) for p, m, a in TRACE])
    assert sum(registry.LAUNCHES.values()) == 0     # plain versions on CPU
    assert sched.prefill_chunks == sum(-(-len(p) // 4) for p, _, _ in TRACE)
    for rid, (prompt, max_tokens, _) in enumerate(TRACE):
        got = out[rid].tokens
        assert len(got) == max_tokens and out[rid].finish_reason == "length"
        # port-internal contract: scheduler == solo oracle, bit for bit
        assert got == oracle_completion(sched.engine,
                                        Request(prompt, max_tokens))
        # cross-framework: equal while JAX's choice is not a near-tie
        for i, want in enumerate(ref["tokens"][rid]):
            if margin(ref["logits"][rid][i]) <= 10 * ref["tol"]:
                break
            assert got[i] == want, (rid, i, got, ref["tokens"][rid])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_allocator_matches_jax(seed):
    """The same alloc / acquire / release sequence through both
    allocators: the same ids in the same FIFO order, the same refcounts,
    the same refusals and the same typed errors."""
    from repro.serve import kv_pool as jpool
    from repro_torch.serve import kv_pool as tpool
    rng = np.random.default_rng(seed)
    ja, ta = jpool.BlockAllocator(12), tpool.BlockAllocator(12)
    live: list[int] = []
    for _ in range(60):
        op = rng.integers(0, 4)
        if op == 0:
            n = int(rng.integers(0, 6))
            got, want = ta.alloc(n), ja.alloc(n)
            assert got == want
            live += got or []
        elif op == 1 and live:
            ids = [int(rng.choice(live))]
            ja.acquire(ids), ta.acquire(ids)
            live += ids
        elif op == 2 and live:
            i = int(rng.integers(0, len(live)))
            ids = [live.pop(i)]
            ja.release(ids), ta.release(ids)
        else:
            bad = int(rng.choice([0, 13, 5]))
            if bad in live:
                continue
            with pytest.raises(ValueError) as je:
                ja.release([bad])
            with pytest.raises(ValueError) as te:
                ta.release([bad])
            assert type(te.value).__name__ == type(je.value).__name__
        assert ta.free_blocks == ja.free_blocks
        assert ta.live_blocks == ja.live_blocks
        assert [ta.refcount(i) for i in range(1, 13)] == \
            [ja.refcount(i) for i in range(1, 13)]
    assert tpool.blocks_needed(9, 4, 4) == jpool.blocks_needed(9, 4, 4) == 3
    assert tpool.table_width(24, 4) == jpool.table_width(24, 4) == 6


@pytest.mark.parametrize("block,chunked", [(1, True), (4, False),
                                           (16, True)])
def test_port_scheduler_equals_own_oracle(ref, block, chunked):
    """Inside the port, across block sizes and chunked / monolithic
    prefill: every request's tokens equal its solo ``generate_loop``
    run (contiguous cache) bit for bit, so paged == contiguous too.
    Four requests on two slots: the last reuses a slot, whose recurrent
    rows (xLSTM) must start from a fresh state."""
    sched = ContinuousBatchingScheduler(
        ref["tcfg"], ref["params"], device="cpu", num_slots=2, max_len=24,
        kv_block_size=block, chunked_prefill=chunked)
    trace = TRACE + [([11, 12, 13], 5, 4)]
    out = sched.run([Request(p, m, arrival=a) for p, m, a in trace])
    for rid, (prompt, max_tokens, _) in enumerate(trace):
        assert out[rid].tokens == oracle_completion(
            sched.engine, Request(prompt, max_tokens))
    assert sched._alloc.free_blocks == sched.num_kv_blocks    # no leaks


def test_port_scheduler_eos_frees_slot(ref):
    """A request stopped by its EOS token retires early and hands its
    slot and blocks to the queued request; both match the oracle."""
    sched = ContinuousBatchingScheduler(ref["tcfg"], ref["params"],
                                        device="cpu", num_slots=1,
                                        max_len=24, kv_block_size=4,
                                        chunked_prefill=True)
    prompt, max_tokens, _ = TRACE[0]
    solo = oracle_completion(sched.engine, Request(prompt, max_tokens))
    eos = next((t for t in solo[1:-1] if t != solo[0]), None)
    if eos is None:
        pytest.skip("greedy rollout is constant; no mid-stream stop")
    reqs = [Request(prompt, max_tokens, eos_id=eos), Request([2, 7], 5)]
    out = sched.run(reqs)
    assert out[0].finish_reason == "eos"
    assert out[0].tokens == solo[:solo.index(eos) + 1]
    assert out[1].tokens == oracle_completion(sched.engine, reqs[1])
    assert out[1].admitted_step >= out[0].finished_step


# every slot finishes at prefill (max_tokens=1) on a tick that decodes
# nothing while rid 4 still waits in the ready queue
STRANDED = [([5, 6, 7], 2, 0), ([1, 2], 2, 0), ([3], 1, 1), ([4], 1, 1),
            ([8], 2, 1)]


@pytest.mark.parametrize("chunked", [False, True])
def test_port_scheduler_serves_every_ready_request(ref, chunked):
    """A tick that decodes nothing, with no prefill live and nothing
    pending, must not end the run while requests wait to be admitted:
    every rid comes back, equal to its solo oracle (not to JAX's ``run``,
    which drops the last one)."""
    sched = ContinuousBatchingScheduler(
        ref["tcfg"], ref["params"], device="cpu", num_slots=2, max_len=24,
        kv_block_size=1, chunked_prefill=chunked)
    out = sched.run([Request(p, m, arrival=a) for p, m, a in STRANDED])
    assert sorted(out) == list(range(len(STRANDED)))
    for rid, (prompt, max_tokens, _) in enumerate(STRANDED):
        assert out[rid].tokens == oracle_completion(
            sched.engine, Request(prompt, max_tokens))
    assert sched._alloc.free_blocks == sched.num_kv_blocks    # no leaks


def test_port_scheduler_raises_on_a_request_never_funded(ref):
    """With every KV block held outside the scheduler and nothing live,
    the head of the ready queue can never be admitted: ``run`` raises
    instead of spinning (no tick dispatches, so its step budget would
    never run out).  An xLSTM stack pages no KV, so its requests need no
    block and are served all the same."""
    sched = ContinuousBatchingScheduler(
        ref["tcfg"], ref["params"], device="cpu", num_slots=2, max_len=24,
        kv_block_size=4)
    held = sched._alloc.alloc(sched.num_kv_blocks - 1)
    assert held is not None
    reqs = [Request([1, 2, 3], 3), Request([4, 5], 2)]
    if ref["family"] == "xlstm":
        out = sched.run(reqs)
        assert [len(out[r].tokens) for r in (0, 1)] == [3, 2]
        assert sched._alloc.free_blocks == 1
        return
    with pytest.raises(SchedulerStalled, match="never be funded"):
        sched.run(reqs)


# TRACE's prompts at three temperatures, a seed each
SAMPLED = [(p, m, a, t, seed) for (p, m, a), t, seed in
           zip(TRACE, (0.0, 0.7, 1.0), (11, 2**31 - 1, 5))]


@pytest.fixture(scope="module")
def sampled(ref):
    """JAX's scheduler on the sampled trace, in the partitionable
    threefry layout, and its per-step scores along its own tokens."""
    with jax.threefry_partitionable(True):
        js = JSched(ref["jcfg"], ref["raw"], kernel_backend="xla", **SCHED)
        out = js.run([JRequest(p, m, arrival=a, temperature=t, seed=seed)
                      for p, m, a, t, seed in SAMPLED])
        tokens = {rid: out[rid].tokens for rid in out}
        scores = {rid: scores_at(
                      jax_logits_along(js.engine, p, tokens[rid]), t, seed)
                  for rid, (p, _, _, t, seed) in enumerate(SAMPLED)}
    return dict(tokens=tokens, scores=scores)


def test_sampled_scheduler_matches_jax_and_own_oracle(ref, sampled):
    """Temperatures 0, 0.7 and 1.0 in one batch: every request equals its
    solo ``generate_loop`` bit for bit, JAX's scheduler outside its
    near-ties, and the temperature-0 request the greedy run's tokens."""
    sched = ContinuousBatchingScheduler(ref["tcfg"], ref["params"],
                                        device="cpu", **SCHED)
    reqs = [Request(p, m, arrival=a, temperature=t, seed=seed)
            for p, m, a, t, seed in SAMPLED]
    out = sched.run(reqs)
    compared = 0
    for rid, req in enumerate(reqs):
        got = out[rid].tokens
        assert len(got) == req.max_tokens
        assert got == oracle_completion(sched.engine, req)
        compared += agree_outside_near_ties(
            got, sampled["tokens"][rid], sampled["scores"][rid], ref["tol"],
            req.temperature)
    assert compared >= 6
    greedy = sched.run([Request(p, m, arrival=a) for p, m, a in TRACE])
    assert out[0].tokens == greedy[0].tokens
    # the sampled requests did sample: not every token is the argmax
    assert any(out[rid].tokens != greedy[rid].tokens for rid in (1, 2))


@pytest.mark.parametrize("temperature,seed", [(0.7, 3), (1.0, 2**31 - 1)])
def test_generate_loop_sampled_matches_jax(ref, temperature, seed):
    """The port's solo loop with ``seed`` at ``temperature`` against JAX's,
    under the same margin rule."""
    prompt, steps = [9, 2, 6, 5, 3], 8
    eng = ContinuousBatchingScheduler(ref["tcfg"], ref["params"],
                                      device="cpu", **SCHED).engine
    got = eng.generate_loop(torch.tensor([prompt], dtype=torch.int32), steps,
                            temperature=temperature, seed=seed)
    got = got[0, len(prompt):].tolist()
    jeng = ref["jengine"]
    with jax.threefry_partitionable(True):
        want = jeng.generate_loop(jnp.asarray([prompt], jnp.int32), steps,
                                  temperature=temperature, seed=seed)
        want = np.asarray(want)[0, len(prompt):].tolist()
        scores = scores_at(jax_logits_along(jeng, prompt, want),
                           temperature, seed)
    assert agree_outside_near_ties(got, want, scores, ref["tol"],
                                   temperature) >= 2
