"""The paper's LLM encoder (``repro_torch.apps.encoder_app``) and
``pum.ibert`` through the language model, against the JAX package, with
JAX's weights carried across by the bridge.

The encoder at 2 layers, d_model 64, d_ff 128, 4 heads, vocabulary 100,
in ``bf16``, ``int8`` and ``pum``, I-BERT off and on, raw and prepacked:

  * op by op (teacher forcing): JAX's forward runs eagerly with every
    ``pum_linear``, softmax, LayerNorm and GELU call recorded; the
    port's forward takes JAX's recorded input at each such call and
    hands JAX's output on.  On equal inputs the integer projections
    (``int8``/``pum``) and every I-BERT function equal JAX's bit for
    bit; the float ones (``bf16`` projections, the float softmax,
    LayerNorm and exact GELU) are within ``OP_TOL`` (relative to the
    output's largest value).  The inputs the port computed itself, the
    products of the two attention einsums, are within ``EINSUM_TOL`` of
    JAX's (f32 summation order);
  * free-running, I-BERT off: hidden states within ``TOL`` of JAX's in
    ``bf16`` (f32 summation order only) and within ``ENC_FLIP_TOL`` in
    ``int8``/``pum``, where an f32 difference can quantise an
    activation on an int8 rounding edge one step apart (over 12 draws
    at this size that moved the hidden states by up to 1.9e-2).  With I-BERT on
    there is no useful bound: one code of a softmax input moves the
    integer reciprocal ``2^15 // sum`` of its row by up to one part in
    a few, so a one-ulp difference of the score einsum can move a row's
    probabilities by ~20 % and the hidden states by O(1); the op-by-op
    test holds that path;
  * raw == prepacked bit for bit (``int8`` and ``pum``), as
    ``tests/test_prepack.py::test_encoder_app_prepack_matches_raw``
    holds JAX's;
  * gradients (``bf16``) finite and non-zero, as
    ``tests/test_apps.py::test_encoder_gradients``.

``pum.ibert`` through ``lm.forward`` (``small_test_config`` in f32, the
gated SiLU block and the plain GELU block), through the paged scheduler
(reduced Qwen2.5-3B) and through whisper's ``generate(encoder_frames=)``
(a real I-BERT softmax over the encoder and the cross-attention):
logits within ``FLIP_TOL``, tokens equal to JAX's but past a near-tie
(``agree_outside_near_ties``), and inside the port bit for bit.  Causal
self-attention under I-BERT gives zero probabilities on both sides (the
reference's whole-tensor scale and its ``-1e30`` mask: ROADMAP queue
3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import agree_outside_near_ties, jax_logits_along, to_numpy
from repro import configs as jconfigs
from repro.apps import encoder_app as jenc
from repro.config import PUMConfig as JPUM, small_test_config as jsmall
from repro.models import lm as jlm
from repro.serve import ContinuousBatchingScheduler as JSched
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch import bridge, configs
from repro_torch.apps import encoder_app as tenc
from repro_torch.config import PUMConfig as TPUM, small_test_config as tsmall
from repro_torch.core import prepack
from repro_torch.models import attention as tattn
from repro_torch.models import lm
from repro_torch.serve import (ContinuousBatchingScheduler, Request,
                               ServeEngine, oracle_completion)

TOL = 1e-5
FLIP_TOL = 1e-2
ENC_FLIP_TOL = 5e-2
OP_TOL = 1e-5
EINSUM_TOL = 1e-5
MODES = ["bf16", "int8", "pum"]
SIZE = dict(layers=2, d_model=64, d_ff=128, heads=4, vocab=100)
OPS = ("pum_linear", "_softmax", "_layernorm", "_gelu")


@pytest.fixture(scope="module")
def encoder():
    p = jenc.encoder_init(jax.random.PRNGKey(0), **SIZE)
    toks = np.random.default_rng(0).integers(0, 100, (2, 16)).astype(
        np.int32)
    return p, toks


def _params(p, mode: str, packed: bool):
    """JAX's params (prepacked when ``packed``) and the port's copy."""
    jp = jenc.encoder_prepack(p, JPUM(mode=mode)) if packed else p
    return jp, bridge.encoder_params_from_numpy(to_numpy(jp), device="cpu")


def _record(monkeypatch) -> list:
    calls = []
    for name in OPS:
        def wrap(x, *a, _f=getattr(jenc, name), _n=name, **kw):
            y = _f(x, *a, **kw)
            calls.append((_n, np.array(x), np.array(y)))
            return y
        monkeypatch.setattr(jenc, name, wrap)
    return calls


def _forced(monkeypatch, calls: list, pum: TPUM) -> list:
    """The port's ops take JAX's recorded inputs and return JAX's
    outputs; each checks its own output on them.  Returns, per call,
    (op, relative difference of the port's own input from JAX's)."""
    it, seen = iter(calls), []
    exact = {"pum_linear": pum.mode != "bf16", "_softmax": pum.ibert,
             "_layernorm": pum.ibert, "_gelu": pum.ibert}
    for name in OPS:
        def wrap(x, *a, _f=getattr(tenc, name), _n=name, **kw):
            op, xj, yj = next(it)
            assert op == _n
            scale = max(1.0, float(np.abs(xj).max()))
            seen.append((op, float(np.abs(x.numpy() - xj).max()) / scale))
            y = _f(torch.from_numpy(xj), *a, **kw).numpy()
            if exact[op]:
                np.testing.assert_array_equal(y.view(np.uint32),
                                              yj.view(np.uint32), op)
            else:
                np.testing.assert_allclose(
                    y, yj, rtol=0, atol=OP_TOL * max(1.0, np.abs(yj).max()),
                    err_msg=op)
            return torch.from_numpy(yj)
        monkeypatch.setattr(tenc, name, wrap)
    return seen


CASES = [(m, i, packed) for m in MODES for i in (False, True)
         for packed in (False, True) if not (packed and m == "bf16")]


@pytest.mark.parametrize("mode,ibert,packed", CASES,
                         ids=[f"{m}-{'ibert' if i else 'float'}-"
                              f"{'packed' if p else 'raw'}"
                              for m, i, p in CASES])
def test_encoder_op_by_op(monkeypatch, encoder, mode, ibert, packed):
    p, toks = encoder
    jp, tp = _params(p, mode, packed)
    calls = _record(monkeypatch)
    want = np.asarray(jenc.encoder_apply(jp, jnp.asarray(toks),
                                         JPUM(mode=mode, ibert=ibert)))
    assert len(calls) == SIZE["layers"] * 10
    pum = TPUM(mode=mode, ibert=ibert)
    seen = _forced(monkeypatch, calls, pum)
    got = tenc.encoder_apply(tp, torch.from_numpy(toks), pum).numpy()
    assert len(seen) == len(calls)
    # the last op's output is handed on: the forward returns JAX's bits
    np.testing.assert_array_equal(got, want)
    # the inputs the port made itself: the embedding (exact), the
    # einsums' products and the residual sums of JAX's outputs
    worst = max(d for _, d in seen)
    assert worst <= EINSUM_TOL, seen


@pytest.mark.parametrize("mode", MODES)
def test_encoder_free_running_float(encoder, mode):
    p, toks = encoder
    jp, tp = _params(p, mode, mode != "bf16")
    want = np.asarray(jenc.encoder_apply(jp, jnp.asarray(toks),
                                         JPUM(mode=mode)))
    got = tenc.encoder_apply(tp, torch.from_numpy(toks), TPUM(mode=mode))
    assert got.shape == (2, 16, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL if mode == "bf16" else ENC_FLIP_TOL)


@pytest.mark.parametrize("mode", ["int8", "pum"])
@pytest.mark.parametrize("ibert", [False, True])
def test_encoder_raw_equals_packed(encoder, mode, ibert):
    p, toks = encoder
    _, raw = _params(p, mode, False)
    pum = TPUM(mode=mode, ibert=ibert)
    packed = tenc.encoder_prepack(raw, pum)
    assert all(isinstance(w, prepack.PackedLinear)
               for lp in packed["layers"] for w in lp.values())
    tok = torch.from_numpy(toks)
    a = tenc.encoder_apply(raw, tok, pum)
    b = tenc.encoder_apply(packed, tok, pum)
    assert torch.equal(a, b)
    assert torch.equal(tenc.encoder_logits(raw, tok, pum),
                       tenc.encoder_logits(packed, tok, pum))


def test_encoder_prepack_bf16_is_the_params(encoder):
    p, _ = encoder
    _, tp = _params(p, "bf16", False)
    assert tenc.encoder_prepack(tp, TPUM(mode="bf16")) is tp


def test_encoder_init_shapes_and_laws():
    gen = torch.Generator().manual_seed(0)
    p = tenc.encoder_init(gen, layers=2, d_model=64, d_ff=256, vocab=500,
                          device="cpu")
    assert p["embed"].shape == (500, 64) and p["pos"].shape == (2048, 64)
    assert [sorted(lp) for lp in p["layers"]] == [sorted(tenc.LINEARS)] * 2
    assert p["layers"][0]["w1"].shape == (64, 256)
    assert p["layers"][0]["w2"].shape == (256, 64)
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    assert abs(float(p["layers"][1]["w2"].std()) - 256 ** -0.5) < 5e-3


def test_encoder_ibert_tracks_float_and_logits(encoder):
    """The JAX test's bound at 2 layers: I-BERT's hidden states keep a
    cosine above 0.9 with the float path's; the tied head's logits."""
    p, toks = encoder
    _, tp = _params(p, "bf16", False)
    tok = torch.from_numpy(toks)
    h_f = tenc.encoder_apply(tp, tok, TPUM(mode="bf16"))
    h_i = tenc.encoder_apply(tp, tok, TPUM(mode="pum", ibert=True))
    assert bool(torch.isfinite(h_i).all())
    cos = float((h_f * h_i).sum() / (h_f.norm() * h_i.norm()))
    assert cos > 0.9
    logits = tenc.encoder_logits(tp, tok, TPUM(mode="pum", ibert=True))
    assert logits.shape == (2, 16, 100)
    assert torch.equal(logits, h_i @ tp["embed"].T)


def test_encoder_gradients():
    gen = torch.Generator().manual_seed(2)
    p = tenc.encoder_init(gen, layers=1, d_model=32, d_ff=64, heads=2,
                          vocab=50, device="cpu")
    leaves = [p["embed"], p["pos"], *p["layers"][0].values()]
    for t in leaves:
        t.requires_grad_(True)
    toks = torch.randint(0, 50, (1, 8), generator=gen)
    h = tenc.encoder_apply(p, toks, TPUM(mode="bf16"), heads=2)
    (h * h).sum().backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in leaves)
    assert any(float(t.grad.abs().max()) > 0 for t in leaves)


# ---------------------------------------------------------------------------
# pum.ibert through the language model
# ---------------------------------------------------------------------------

_jax_forward = jax.jit(jlm.forward, static_argnums=2,
                       static_argnames=("last_only", "kv_len"))


@pytest.mark.parametrize("mode,activation", [
    ("pum", "silu"), ("pum", "gelu"), ("int8", "gelu"), ("bf16", "gelu")])
def test_lm_forward_ibert_matches_jax(mode, activation):
    kw = dict(dtype="float32", activation=activation)
    jcfg = jsmall(pum=JPUM(mode=mode, ibert=True), **kw)
    tcfg = tsmall(pum=TPUM(mode=mode, ibert=True), **kw)
    raw = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    jp = jlm.prepack_for_serving(raw, jcfg)
    tp = bridge.params_from_numpy(to_numpy(jp), tcfg, device="cpu")
    toks = np.random.default_rng(4).integers(0, 256, (2, 9)).astype(
        np.int32)
    want, _, _ = _jax_forward(jp, jnp.asarray(toks), jcfg)
    got, _ = lm.forward(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FLIP_TOL)


def test_causal_ibert_attention_is_zero(monkeypatch):
    """Under ``pum.ibert`` causal self-attention's probabilities are all
    zero (the reference's fault, kept): the attention output is 0."""
    cfg = tsmall(pum=TPUM(mode="pum", ibert=True), dtype="float32")
    seen = []
    real = tattn._plain_attention

    def spy(q, k, v, mask, softcap, ibert_mode):
        out = real(q, k, v, mask, softcap, ibert_mode)
        seen.append((ibert_mode, bool(mask.all()), float(out.abs().max())))
        return out

    monkeypatch.setattr(tattn, "_plain_attention", spy)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    lm.forward(params, torch.zeros((1, 5), dtype=torch.int32), cfg)
    assert seen == [(True, False, 0.0)] * cfg.num_layers


def test_scheduler_ibert_tokens_match_jax():
    """The paged scheduler (chunked prefill, blocks of 4) under
    ``pum.ibert`` on reduced Qwen2.5-3B: JAX's scheduler's tokens but
    past a near-tie, and its own solo oracle's bit for bit."""
    pum = dict(mode="pum", ibert=True)
    jcfg = jconfigs.get_reduced("qwen2.5-3b").replace(pum=JPUM(**pum),
                                                      dtype="float32")
    tcfg = configs.get_reduced("qwen2.5-3b").replace(pum=TPUM(**pum),
                                                     dtype="float32")
    raw = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    trace = [([3, 1, 4, 1, 5], 6, 0), ([9, 2, 6, 5, 3, 5, 8], 4, 1),
             ([7, 7], 5, 2)]
    kw = dict(num_slots=2, max_len=24, kv_block_size=4,
              chunked_prefill=True)
    js = JSched(jcfg, raw, kernel_backend="xla", **kw)
    jout = js.run([JRequest(p, m, arrival=a) for p, m, a in trace])
    params = bridge.params_from_numpy(
        to_numpy(jlm.prepack_for_serving(raw, jcfg)), tcfg, device="cpu")
    sched = ContinuousBatchingScheduler(tcfg, params, device="cpu", **kw)
    reqs = [Request(p, m, arrival=a) for p, m, a in trace]
    out = sched.run(reqs)
    compared = 0
    for rid, (prompt, _, _) in enumerate(trace):
        got, want = out[rid].tokens, jout[rid].tokens
        assert got == oracle_completion(sched.engine, reqs[rid])
        logits = jax_logits_along(js.engine, prompt, want)
        compared += agree_outside_near_ties(got, want, logits, FLIP_TOL,
                                            0.0)
    assert compared >= 12


def test_whisper_generate_ibert_matches_jax():
    """whisper's reduced config under ``pum.ibert``: the I-BERT softmax
    over the encoder's frames and the cross-attention, the I-BERT GELU
    in both stacks.  The compiled loop equals the per-token loop; JAX's
    engine gives the same tokens but past a near-tie."""
    pum = dict(mode="pum", ibert=True)
    jcfg = jconfigs.get_reduced("whisper-tiny").replace(pum=JPUM(**pum),
                                                        dtype="float32")
    tcfg = configs.get_reduced("whisper-tiny").replace(pum=TPUM(**pum),
                                                       dtype="float32")
    raw = jlm.init_params(jcfg, jax.random.PRNGKey(11))
    tp = bridge.params_from_numpy(
        to_numpy(jlm.prepack_for_serving(raw, jcfg)), tcfg, device="cpu")
    rng = np.random.default_rng(13)
    frames = rng.normal(size=(2, 32, 64)).astype(np.float32)
    prompt = rng.integers(0, 256, (2, 6)).astype(np.int32)
    eng = ServeEngine(tcfg, tp, max_len=24, device="cpu")
    tpr, tf = torch.from_numpy(prompt), torch.from_numpy(frames)
    got = eng.generate(tpr, 8, encoder_frames=tf)
    assert torch.equal(got, eng.generate_loop(tpr, 8, encoder_frames=tf))
    jeng = JEngine(jcfg, raw, max_len=24, kernel_backend="xla")
    want = np.asarray(jeng.generate(jnp.asarray(prompt), 8,
                                    encoder_frames=jnp.asarray(frames)))
    states, lg, enc = jeng.prefill(jnp.asarray(prompt), jnp.asarray(frames))
    steps = [np.asarray(lg)[:, -1]]
    for i in range(7):
        lg, states = jeng._decode(jeng.params, states,
                                  jnp.asarray(want[:, 6 + i:7 + i]),
                                  jnp.int32(6 + i), encoder_out=enc)
        steps.append(np.asarray(lg)[:, -1])
    logits = np.stack(steps, axis=1)
    agreed = [agree_outside_near_ties(got[row, 6:].tolist(),
                                      want[row, 6:].tolist(), logits[row],
                                      FLIP_TOL, 0.0) for row in range(2)]
    assert sum(agreed) >= 8, agreed
