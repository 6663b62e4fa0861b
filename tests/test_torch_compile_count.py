"""The port's compile-count contract, the counterpart of
``tests/test_compile_count.py``: the scheduler builds its decode step
once and its chunk prefill (contiguous windows: its admission prefill)
once per distinct chunk (prompt) length, and a second run builds
nothing new (``ContinuousBatchingScheduler.step_programs``,
the counterpart of the reference's jit cache sizes).

On the CPU a compiled step runs eagerly through its static buffers, so
``cuda_graphs=True`` and ``False`` run the same code here and must give
the same completions, equal to the solo oracle's and to the JAX
scheduler's on the same trace.  A trace that mixes temperatures builds
the greedy trace's programs: the sampler is part of the one decode
step.  Graph capture itself is exercised on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import dataclasses

import jax
import pytest

from _torch_port import to_numpy
from repro.config import PUMConfig as JPUM, small_test_config as jsmall
from repro.models import lm as jlm
from repro.serve import ContinuousBatchingScheduler as JSched
from repro.serve import Request as JRequest
from repro_torch import bridge
from repro_torch.config import PUMConfig as TPUM, small_test_config as tsmall
from repro_torch.serve import (ContinuousBatchingScheduler, Request,
                               oracle_completion)

BLOCK = 4
# f32 activations: the integer contractions are exact on equal inputs
# and the float ones differ across frameworks by summation order only,
# so the greedy tokens of these short traces agree
KW = dict(dtype="float32")
SCHED = dict(num_slots=2, max_len=32, kv_block_size=BLOCK,
             chunked_prefill=True)


@pytest.fixture(scope="module", params=["bf16", "int8", "pum"])
def models(request):
    """JAX's params for one mode and the port's, carried across."""
    mode = request.param
    jcfg = jsmall(pum=JPUM(mode=mode), **KW)
    raw = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tsmall(pum=TPUM(mode=mode), **KW)
    params = bridge.params_from_numpy(
        to_numpy(jlm.prepack_for_serving(raw, jcfg)), tcfg, device="cpu")
    return dict(jcfg=jcfg, raw=raw, tcfg=tcfg, params=params)


def _sched(models, **kw):
    return ContinuousBatchingScheduler(models["tcfg"], models["params"],
                                       device="cpu", **SCHED, **kw)


def _reqs(lengths, cls=Request):
    return [cls(list(range(1, n + 1)), max_tokens=3, rid=i)
            for i, n in enumerate(lengths)]


def test_chunked_serving_builds_each_step_once(models):
    sched = _sched(models)
    assert sched.step_programs() == {"decode": 0, "chunk": {}}
    # prompt lengths 4 and 8: different chunk counts, one chunk shape
    sched.run(_reqs([BLOCK, 2 * BLOCK]))
    assert sched.step_programs() == {"decode": 1, "chunk": {BLOCK: 1}}
    # steady state: a second run with other lengths builds nothing new
    sched.run(_reqs([2 * BLOCK, BLOCK]))
    assert sched.step_programs() == {"decode": 1, "chunk": {BLOCK: 1}}
    # a ragged tail (6 = 4 + 2) adds exactly one chunk program
    sched.run(_reqs([6]))
    assert sched.step_programs() == {"decode": 1,
                                     "chunk": {2: 1, BLOCK: 1}}
    assert sched.graphs_captured() == (0, 0.0)      # no graphs on a CPU


def test_prefix_cache_builds_each_step_once(models):
    """With the prefix cache the decode step is still built once (its
    shared-column input is zeros without a hit), the warm rerun adds
    only the 1-token tail chunk of the fully cached prompt, and a third
    run builds nothing; every completion equals its solo oracle."""
    sched = _sched(models, prefix_cache=True)
    reqs = _reqs([2 * BLOCK, 2 * BLOCK + 2])     # a shared 8-token prefix
    cold = sched.run(reqs)
    assert sched.step_programs() == {"decode": 1, "chunk": {2: 1, BLOCK: 1}}
    assert sched.prefix_stats()["hits"] == 0
    warm = sched.run(reqs)
    want = {"decode": 1, "chunk": {1: 1, 2: 1, BLOCK: 1}}
    assert sched.step_programs() == want
    assert sched.prefix_stats()["hits"] == 2
    again = sched.run(reqs)
    assert sched.step_programs() == want
    for req in reqs:
        assert cold[req.rid].tokens == warm[req.rid].tokens == \
            again[req.rid].tokens == oracle_completion(sched.engine, req)


def test_compiled_and_eager_equal_oracle_and_jax(models):
    lengths = [BLOCK, 2 * BLOCK, 6]
    out = {flag: _sched(models, cuda_graphs=flag).run(_reqs(lengths))
           for flag in (True, False)}
    assert {r: c.tokens for r, c in out[True].items()} == \
        {r: c.tokens for r, c in out[False].items()}
    sched = _sched(models)
    js = JSched(models["jcfg"], models["raw"], kernel_backend="xla", **SCHED)
    jout = js.run(_reqs(lengths, JRequest))
    for req in _reqs(lengths):
        got = out[True][req.rid].tokens
        assert got == oracle_completion(sched.engine, req)
        assert got == jout[req.rid].tokens, (req.rid, got,
                                             jout[req.rid].tokens)


def test_mixed_temperatures_build_the_greedy_programs(models):
    """Greedy and sampled rows share one decode program: a trace at
    temperatures 0, 0.7 and 1.0 builds exactly the programs of the same
    trace served greedy, a second run builds nothing, and every
    completion equals its solo oracle."""
    lengths = [BLOCK, 2 * BLOCK, 6]
    greedy = _sched(models)
    greedy.run(_reqs(lengths))
    mixed = _sched(models)
    reqs = [dataclasses.replace(r, temperature=t, seed=100 + r.rid)
            for r, t in zip(_reqs(lengths), (0.0, 0.7, 1.0))]
    out = mixed.run(reqs)
    assert mixed.step_programs() == greedy.step_programs() == {
        "decode": 1, "chunk": {2: 1, BLOCK: 1}}
    again = mixed.run(reqs)
    assert mixed.step_programs() == greedy.step_programs()
    for req in reqs:
        assert out[req.rid].tokens == again[req.rid].tokens == \
            oracle_completion(mixed.engine, req)


def test_contiguous_decode_compiles_once(models):
    """Contiguous windows (``kv_block_size=0``): one decode program
    across mixed prompt lengths, one prefill program per prompt length,
    and nothing new on a second run; the tokens equal the solo oracle's
    and JAX's contiguous scheduler's."""
    sched = ContinuousBatchingScheduler(models["tcfg"], models["params"],
                                        device="cpu", num_slots=2,
                                        max_len=32, kv_block_size=0)
    assert sched.step_programs() == {"decode": 0, "prefill": {}}
    out = sched.run(_reqs([3, 5]))
    assert sched.step_programs() == {"decode": 1, "prefill": {3: 1, 5: 1}}
    sched.run(_reqs([6, 2]))
    want = {"decode": 1, "prefill": {2: 1, 3: 1, 5: 1, 6: 1}}
    assert sched.step_programs() == want
    again = sched.run(_reqs([3, 5]))
    assert sched.step_programs() == want
    js = JSched(models["jcfg"], models["raw"], kernel_backend="xla",
                num_slots=2, max_len=32, kv_block_size=0)
    jout = js.run(_reqs([3, 5], JRequest))
    for req in _reqs([3, 5]):
        assert out[req.rid].tokens == again[req.rid].tokens == \
            oracle_completion(sched.engine, req) == jout[req.rid].tokens
