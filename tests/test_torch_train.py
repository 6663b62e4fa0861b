"""The port's training path against the JAX package's, on the CPU: the
straight-through gradient of ``pum_linear``, the loss and its gradients
(dense in three modes; xLSTM, MoE and the hybrid in one each), AdamW,
clipping and the schedules, error-feedback compression, the synthetic
data stream, three train steps, microbatching, checkpoints and the
trainer's resume, and the CLI.  Same numpy inputs on both sides; JAX's
params and optimiser state are carried across by ``repro_torch.bridge``.

Tolerances (each case names its own):

  * ``pum_linear``'s forward in ``int8``/``pum`` is the quantised
    product, equal to JAX's ``yq`` bit for bit; ``bf16`` mode's float
    product within ``F32_TOL`` (f32) or ``BF16_TOL`` (bf16 inputs, a
    bf16 ulp).  The gradients are those of the shadow product
    ``x @ w.to(x.dtype)``: within ``F32_TOL`` relative in f32, and in
    bf16 within two bf16 ulps of the output's scale (both sides sum in
    f32 and round once, in other orders).
  * model gradients in f32 (``dtype="float32"``: in bf16 XLA's CPU
    fusions round where PyTorch's ops do not, some 1e-2 apart): each
    element within ``GRAD_RTOL`` of JAX's plus ``GRAD_ATOL`` times the
    largest gradient of the tree (an sLSTM gate bias's gradient is
    ~1e-10, round-off of an exact zero).  In ``int8``/``pum`` an f32
    difference of ~1e-7 (the hybrid's Mamba scan, sequential in the
    port and associative in JAX, is one source) can quantise an
    activation one int8 step apart, which moves every gradient
    downstream a little: so there the share of elements outside that
    bound must stay within ``FLIP_SHARE``, and every element within
    ``FLIP_TOL`` times the largest gradient.  (The hybrid's reduced
    8-layer period, whose JAX compile alone takes 30 s, so that the
    test runs a 2-layer cut of it with one Mamba and one attention
    layer: 0.14 % of its elements outside, at most 3.2e-4, in ``pum``;
    8.5 %, at most 5.0e-3, in ``int8``.)  The loss within ``LOSS_TOL``
    relative, ``FLIP_LOSS_TOL`` in the integer modes.
  * AdamW, clipping and the schedules within ``F32_TOL`` relative (both
    compute the same f32 operations; ``pow`` and ``cos`` may differ in
    the last ulp); error feedback's int8 codes equal, its outputs
    within an ulp.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_numpy
from repro import configs as jconfigs
from repro.ckpt import checkpoint as jckpt
from repro.config import PUMConfig as JPUM
from repro.config import ShardingConfig as JSharding
from repro.config import TrainConfig as JTrain
from repro.core import pum_linear as jpl
from repro.data import synthetic as jdata
from repro.dist import compress as jcompress
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro.train import step as jstep
from repro_torch import bridge, configs
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.config import PUMConfig as TPUM
from repro_torch.config import ShardingConfig as TSharding
from repro_torch.config import TrainConfig as TTrain
from repro_torch.core import pum_linear as tpl
from repro_torch.data import synthetic as tdata
from repro_torch.dist import compress as tcompress
from repro_torch.ft import PreemptionHandler
from repro_torch.kernels import registry
from repro_torch.kernels.registry import KernelBackend
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedules as tsched
from repro_torch.train import step as tstep
from repro_torch.train.trainer import Trainer
from repro_torch.tree import leaves

F32_TOL = 1e-5
BF16_TOL = 2 * 2.0 ** -8
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-5
FLIP_SHARE = 0.1
FLIP_TOL = 1e-2
LOSS_TOL = 1e-5
FLIP_LOSS_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _clean_jit_cache():
    # compile each JAX loss once and free them after: the suite's
    # workers share memory (tests/test_torch_spec.py does the same)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _np(t):
    return t.detach().to(torch.float32).numpy()


def test_train_configs_match_the_reference():
    """``TrainConfig`` field for field (the checkpoint directory's
    default lies under the process's temporary directory), and the
    one-card knobs of ``ShardingConfig`` with the reference's defaults."""
    import dataclasses
    want = dataclasses.asdict(JTrain())
    got = dataclasses.asdict(TTrain())
    assert got.pop("ckpt_dir").endswith("repro_ckpt")
    want.pop("ckpt_dir")
    assert got == want
    js = dataclasses.asdict(JSharding())
    assert dataclasses.asdict(TSharding()) == {
        k: js[k] for k in ("remat", "grad_compress", "bf16_params")}


# ---------------------------------------------------------------------------
# the straight-through estimator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["pum", "int8", "bf16"])
def test_pum_linear_straight_through_gradient(mode, dtype):
    """The raw-weight forward is JAX's ``yq`` (bit for bit in the integer
    modes), and ``dx``, ``dw`` and the bias's gradient are JAX's
    straight-through ones: those of the shadow product."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 6, 96)).astype(np.float32)
    w = (rng.normal(size=(96, 40)) / np.sqrt(96)).astype(np.float32)
    b = (rng.normal(size=(40,)) * 0.1).astype(np.float32)
    cot = rng.normal(size=(2, 6, 40)).astype(np.float32)
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)

    def jfun(x, w, b):
        y = jpl.pum_linear(x, w, JPUM(mode=mode), bias=b)
        return jnp.sum(y.astype(jnp.float32) * cot), y

    (_, jy), jg = jax.value_and_grad(jfun, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x, jd), jnp.asarray(w), jnp.asarray(b))
    tx = torch.from_numpy(x).to(td).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    ty = tpl.pum_linear(tx, tw, TPUM(mode=mode), bias=tb)
    (ty.to(torch.float32) * torch.from_numpy(cot)).sum().backward()
    assert ty.dtype == td and tx.grad.dtype == td
    assert tw.grad.dtype == torch.float32
    want_y = np.asarray(jy.astype(jnp.float32))
    if mode == "bf16":
        np.testing.assert_allclose(_np(ty), want_y, rtol=0, atol=(
            F32_TOL if dtype == "float32" else BF16_TOL) * np.abs(
                want_y).max())
    else:
        assert np.array_equal(_np(ty), want_y)
    for got, want in ((tx.grad, jg[0]), (tw.grad, jg[1]), (tb.grad, jg[2])):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        tol = F32_TOL if dtype == "float32" else BF16_TOL
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=tol * np.abs(want).max())


def test_straight_through_skips_the_shadow_product_forward(monkeypatch):
    """The forward computes only the quantised product (one exact
    bit-sliced product, K2's plain version on the CPU, and no float
    product); the backward one float matmul an input.  Without a
    gradient, no estimator."""
    calls = {"quantised": 0, "float": 0, "matmul": 0}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(tpl.bitslice, "bitsliced_matmul_exact", counted(
        "quantised", tpl.bitslice.bitsliced_matmul_exact))
    monkeypatch.setattr(tpl, "float_matmul", counted("float",
                                                     tpl.float_matmul))
    x = torch.randn(3, 32, requires_grad=True)
    w = torch.randn(32, 16, requires_grad=True)
    y = tpl.pum_linear(x, w, TPUM(mode="pum"))
    assert calls == {"quantised": 1, "float": 0, "matmul": 0}
    assert y.requires_grad
    monkeypatch.setattr(torch, "matmul", counted("matmul", torch.matmul))
    y.sum().backward()
    assert calls == {"quantised": 1, "float": 0, "matmul": 2}
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    monkeypatch.undo()
    with torch.no_grad():
        assert not tpl.pum_linear(x, w, TPUM(mode="pum")).requires_grad


def test_fake_quant():
    x = np.random.default_rng(2).normal(size=(4, 24)).astype(np.float32)
    jy, jvjp = jax.vjp(lambda v: jpl.fake_quant(v, 4, axis=-1),
                       jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    ty = tpl.fake_quant(tx, 4, axis=-1)
    assert np.array_equal(_np(ty), np.asarray(jy))
    ty.backward(torch.full_like(ty, 3.0))
    assert np.array_equal(_np(tx.grad), np.asarray(
        jvjp(jnp.full(x.shape, 3.0, jnp.float32))[0]))


# ---------------------------------------------------------------------------
# loss and gradients of the models
# ---------------------------------------------------------------------------

LOSS_CASES = [("qwen2.5-3b", "pum"), ("qwen2.5-3b", "int8"),
              ("qwen2.5-3b", "bf16"), ("xlstm-350m", "pum"),
              ("olmoe-1b-7b", "int8"), ("jamba-v0.1-52b", "pum")]


def _cfgs(arch, mode):
    """The reduced configs in f32; the hybrid cut to a Mamba layer with
    a dense FFN and an attention layer with the MoE FFN, xLSTM to an
    sLSTM and an mLSTM layer (each JAX compile costs seconds a layer)."""
    cut = {"jamba-v0.1-52b": dict(num_layers=2, attn_period=2),
           "xlstm-350m": dict(num_layers=2)}.get(arch, {})
    return (jconfigs.get_reduced(arch).replace(pum=JPUM(mode=mode),
                                               dtype="float32", **cut),
            configs.get_reduced(arch).replace(pum=TPUM(mode=mode),
                                              dtype="float32", **cut))


def _tokens(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _jax_params(jcfg, seed=0):
    return jax.jit(jlm.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))


def assert_grads_close(got, want_jax, tcfg, quantised):
    """The port's gradient tree against JAX's (carried across), under
    the module's rule; returns the share of elements outside the tight
    bound."""
    want = bridge.params_from_numpy(to_numpy(want_jax), tcfg, device="cpu")
    g_leaves, w_leaves = leaves(got), leaves(want)
    assert len(g_leaves) == len(w_leaves)
    gmax = max(float(np.abs(_np(w)).max()) for w in w_leaves)
    outside = total = 0
    for g, w in zip(g_leaves, w_leaves):
        assert g.shape == w.shape and g.dtype == w.dtype
        d = np.abs(_np(g) - _np(w))
        tight = d <= GRAD_RTOL * np.abs(_np(w)) + GRAD_ATOL * gmax
        outside += int((~tight).sum())
        total += d.size
        assert d.max() <= (FLIP_TOL if quantised else 1.0) * gmax
    share = outside / total
    assert share <= (FLIP_SHARE if quantised else 0.0), share
    return share


@pytest.mark.parametrize("arch,mode", LOSS_CASES,
                         ids=[f"{a}-{m}" for a, m in LOSS_CASES])
def test_loss_and_gradients_match_jax(arch, mode):
    """``make_loss_fn`` and autograd through the port's blocks (with
    ``remat``, recomputed in the backward) against ``jax.value_and_grad``
    of JAX's loss, on JAX's params; the MoE's ``moe_lb`` and its
    ``moe_z`` weighted into the total."""
    jcfg, tcfg = _cfgs(arch, mode)
    jp = _jax_params(jcfg)
    toks = _tokens(jcfg)
    jfn = jax.jit(jax.value_and_grad(
        jstep.make_loss_fn(jcfg, JSharding(remat="none")), has_aux=True))
    (_, jm), jg = jfn(jp, {"tokens": jnp.asarray(toks)})
    tp = bridge.params_from_numpy(to_numpy(jp), tcfg, device="cpu")
    tm, tg = tstep.value_and_grad(tstep.make_loss_fn(tcfg, TSharding()), tp,
                                  {"tokens": torch.from_numpy(toks)})
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=(
            LOSS_TOL if mode == "bf16" else FLIP_LOSS_TOL))
    if "moe_lb" in jm:
        # the total carries the z loss too
        assert float(tm["total_loss"]) > float(tm["loss"]) + 0.01 * float(
            tm["moe_lb"])
    assert_grads_close(tg, jg, tcfg, quantised=mode != "bf16")
    if arch == "olmoe-1b-7b":
        router = tg["blocks"][0]["moe"]["router"]["w"]
        assert torch.isfinite(router).all() and router.abs().max() > 0


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "xlstm-350m"])
def test_remat_is_bit_equal_to_no_remat(arch):
    """Recomputing each block in the backward gives the same loss and
    gradients bit for bit (the MoE's aux losses through the
    checkpointed blocks too)."""
    _, tcfg = _cfgs(arch, "pum")
    params = lm.init_params(tcfg, torch.Generator().manual_seed(1),
                            device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(tcfg, seed=1))}
    runs = [tstep.value_and_grad(
        tstep.make_loss_fn(tcfg, TSharding(remat=r)), params, batch)
        for r in ("block", "none")]
    for k in runs[0][0]:
        assert torch.equal(runs[0][0][k], runs[1][0][k]), k
    for a, b in zip(leaves(runs[0][1]), leaves(runs[1][1])):
        assert torch.equal(a, b)


def test_backend_selection_reaches_the_recomputation_thread():
    """On the card autograd runs the backward, and with it a checkpointed
    block's recomputation, on a thread of its own, where this thread's
    ``use_backend`` frames are not open: ``registry.snapshot`` carries
    them there (``lm.forward`` hands it to the checkpoint)."""
    import threading
    seen = {}
    with registry.use_backend("torch", paged_attention="cuda"):
        restore = registry.snapshot()

    def other():
        seen["bare"] = registry.get_backend("bitslice_mvm")
        with restore():
            seen["in"] = (registry.get_backend("bitslice_mvm"),
                          registry.get_backend("paged_attention"))
        seen["after"] = registry.get_backend("bitslice_mvm")

    thread = threading.Thread(target=other)
    thread.start()
    thread.join()
    assert seen == {"bare": None, "after": None,
                    "in": (KernelBackend.TORCH, KernelBackend.CUDA)}
    assert registry.get_backend("bitslice_mvm") is None


def test_serving_forward_keeps_two_values():
    _, tcfg = _cfgs("olmoe-1b-7b", "pum")
    params = lm.init_params(tcfg, torch.Generator().manual_seed(2),
                            device="cpu")
    toks = torch.from_numpy(_tokens(tcfg))
    out = lm.forward(params, toks, tcfg)
    assert len(out) == 2 and out[1] is None
    logits, _, aux = lm.forward(params, toks, tcfg, with_aux=True)
    assert torch.equal(logits, out[0]) and set(aux) == {"moe_lb", "moe_z"}
    _, dense = _cfgs("qwen2.5-3b", "pum")
    dparams = lm.init_params(dense, torch.Generator().manual_seed(2),
                             device="cpu")
    assert lm.forward(dparams, toks, dense, with_aux=True)[2] == {}


# ---------------------------------------------------------------------------
# optimiser, schedules, compression, data
# ---------------------------------------------------------------------------

def _trees(seed):
    """A small param-shaped tree (a dict holding a list) drawn in numpy,
    as JAX arrays and as tensors."""
    rng = np.random.default_rng(seed)
    tree = {"b": [rng.normal(size=(5, 3)).astype(np.float32),
                  rng.normal(size=(7,)).astype(np.float32)],
            "a": rng.normal(size=(4, 6)).astype(np.float32)}

    def conv(fn):
        return {"b": [fn(x) for x in tree["b"]], "a": fn(tree["a"])}

    return conv(jnp.asarray), conv(torch.from_numpy)


def _close(got, want, tol=F32_TOL):
    for g, w in zip(leaves(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=tol,
                                   atol=tol * np.abs(w).max())


def test_adamw_update_and_clipping_match_jax():
    tcfg, jcfg = TTrain(weight_decay=0.1), JTrain(weight_decay=0.1)
    (jp, tp), (jg, tg) = _trees(0), _trees(1)
    jst, tst = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for i in range(3):
        lr = 1e-2 * (i + 1)
        jg_c, jn = jadamw.clip_by_global_norm(
            jax.tree_util.tree_map(lambda g: g * (i + 1), jg), 2.5)
        tg_c, tn = tadamw.clip_by_global_norm(
            {"b": [g * (i + 1) for g in tg["b"]], "a": tg["a"] * (i + 1)},
            2.5)
        np.testing.assert_allclose(float(tn), float(jn), rtol=F32_TOL)
        _close(tg_c, jg_c)
        jp, jst = jadamw.adamw_update(jp, jg_c, jst, jnp.float32(lr), jcfg)
        tp, tst = tadamw.adamw_update(tp, tg_c, tst,
                                      torch.tensor(lr, dtype=torch.float32),
                                      tcfg)
        _close(tp, jp)
        _close(tst["m"], jst["m"])
        _close(tst["v"], jst["v"])
        assert int(tst["count"]) == int(jst["count"]) == i + 1
        assert tst["count"].dtype == torch.int32
    # in place: the same values, written into the given tensors
    (_, p2), (_, g2) = _trees(0), _trees(1)
    want_g, want_n = tadamw.clip_by_global_norm(g2, 0.5)
    got_g, got_n = tadamw.clip_by_global_norm(g2, 0.5, inplace=True)
    assert got_g is g2 and torch.equal(got_n, want_n)
    assert all(torch.equal(a, b) for a, b in zip(leaves(got_g),
                                                 leaves(want_g)))
    st2 = tadamw.adamw_init(p2)
    want, wst = tadamw.adamw_update(p2, g2, st2, torch.tensor(0.01), tcfg)
    got, gst = tadamw.adamw_update(p2, g2, st2, torch.tensor(0.01), tcfg,
                                   inplace=True)
    assert got is p2 and gst is st2
    for a, b in zip(leaves([want, wst]), leaves([got, gst])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("schedule", ["cosine", "constant", "wsd"])
def test_schedules_match_jax_at_each_step(schedule):
    kw = dict(steps=40, warmup_steps=6, learning_rate=3e-3,
              schedule=schedule, wsd_decay_frac=0.25)
    jf, tf = jsched.make_schedule(JTrain(**kw)), tsched.make_schedule(
        TTrain(**kw))
    for step in range(45):
        want = float(jf(jnp.int32(step)))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=F32_TOL,
                                   atol=1e-12)


def test_ef_compress_grads_matches_jax():
    (jg, tg), (_, tr0) = _trees(3), _trees(4)
    jr = jax.tree_util.tree_map(lambda r: r * 1e-3, _trees(4)[0])
    tr = {"b": [r * 1e-3 for r in tr0["b"]], "a": tr0["a"] * 1e-3}
    for _ in range(2):
        jd, jr = jcompress.ef_compress_grads(jg, jr)
        td, tr = tcompress.ef_compress_grads(tg, tr)
        _close(td, jd, tol=1e-6)
        _close(tr, jr, tol=1e-6)
    for g, r in zip(leaves(tg), leaves(tr)):
        corrected = g + r
        scale = torch.amax(corrected.abs())
        jq = jcompress._quantise(jnp.asarray(corrected.numpy()),
                                 jnp.asarray(scale.numpy()))
        assert np.array_equal(tcompress._quantise(corrected, scale).numpy(),
                              np.asarray(jq))
    zeros = tcompress.zeros_like_residual(tg)
    assert all(z.dtype == torch.float32 and not z.any()
               for z in leaves(zeros))


def test_synthetic_tokens_bit_for_bit():
    for arch, seed in (("qwen2.5-3b", 3), ("xlstm-350m", 0)):
        jds = jdata.SyntheticTokens(jconfigs.get(arch), 4, 33, seed=seed,
                                    hosts=2, host_id=1)
        tds = tdata.SyntheticTokens(configs.get(arch), 4, 33, seed=seed,
                                    hosts=2, host_id=1)
        for step in (0, 1, 7):
            want, got = jds.batch(step), tds.batch(step)
            assert got.keys() == want.keys()
            assert got["tokens"].dtype == want["tokens"].dtype
            assert np.array_equal(got["tokens"], want["tokens"])


# ---------------------------------------------------------------------------
# the train step, microbatches
# ---------------------------------------------------------------------------

def test_three_train_steps_match_jax():
    """Three steps of ``make_train_step`` (``bf16`` mode: the integer
    modes' flips are held above; the warm-up's first rate is 0): loss,
    gradient norm, rate and params after each step, and m, v and the
    count at the end, against JAX's.  The key projections' bias has a
    zero gradient in exact arithmetic (softmax ignores a shift shared by
    every key), so both sides hold round-off there, which AdamW's
    normalisation lifts to steps of up to ``lr`` (``g / (|g| + eps)``):
    that leaf is held within the summed rates, every other within
    ``PARAM_TOL``."""
    param_tol = 1e-5
    jcfg, tcfg = _cfgs("qwen2.5-3b", "bf16")
    kw = dict(steps=10, learning_rate=1e-2, warmup_steps=2)
    jt, tt = JTrain(**kw), TTrain(**kw)
    jp = _jax_params(jcfg, seed=4)
    jst = jstep.init_opt_state(jp, jt)
    tp = bridge.params_from_numpy(to_numpy(jp), tcfg, device="cpu")
    tst = tstep.init_opt_state(tp, tt)
    jfn = jax.jit(jstep.make_train_step(jcfg, jt, JSharding(remat="none")))
    tfn = tstep.make_train_step(tcfg, tt)
    data = tdata.SyntheticTokens(tcfg, 2, 16, seed=5)
    zero_grad = {id(blk["attn"]["wk"]["b"]) for blk in tp["blocks"]}
    lr_sum = 0.0
    for i in range(3):
        toks = data.batch(i)["tokens"]
        jp, jst, jm = jfn(jp, jst, {"tokens": jnp.asarray(toks)})
        tp2, tst2, tm = tfn(tp, tst, {"tokens": torch.from_numpy(toks)})
        assert tp2 is tp and tst2 is tst
        for k in ("loss", "total_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=LOSS_TOL, err_msg=k)
        lr_sum += float(jm["lr"])
        want = bridge.params_from_numpy(to_numpy(jp), tcfg, device="cpu")
        for a, b in zip(leaves(tp), leaves(want)):
            tol = lr_sum if id(a) in zero_grad else param_tol
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol)
    wst = bridge.opt_state_from_numpy(to_numpy(jst), tcfg, device="cpu")
    assert set(wst) == set(tst) == {"m", "v", "count"}
    assert int(tst["count"]) == int(wst["count"]) == 3
    for key, tol in (("m", 1e-6), ("v", 1e-8)):
        for a, b in zip(leaves(tst[key]), leaves(wst[key])):
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol,
                                       err_msg=key)


def test_microbatches_equal_the_full_batch():
    """Two microbatches of 2 against one batch of 4: the gradients and
    metrics summed in f32 and halved equal the full batch's within f32
    round-off (``MICRO_TOL`` of the largest gradient; bf16 mode, where
    no quantiser can flip); the ``pum`` step runs the same path."""
    micro_tol = 1e-6
    _, tcfg = _cfgs("qwen2.5-3b", "bf16")
    params = lm.init_params(tcfg, torch.Generator().manual_seed(3),
                            device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(tcfg, b=4, seed=3))}
    full = tstep.make_grad_fn(tcfg, TTrain())(params, batch)
    micro = tstep.make_grad_fn(tcfg, TTrain(microbatch=2))(params, batch)
    assert set(full[1]) == set(micro[1]) == {"loss", "total_loss"}
    for k in full[1]:
        np.testing.assert_allclose(float(micro[1][k]), float(full[1][k]),
                                   rtol=micro_tol)
    gmax = max(float(g.abs().max()) for g in leaves(full[0]))
    for a, b in zip(leaves(micro[0]), leaves(full[0])):
        assert a.dtype == torch.float32
        assert float((a - b).abs().max()) <= micro_tol * gmax
    _, pcfg = _cfgs("qwen2.5-3b", "pum")
    tfn = tstep.make_train_step(pcfg, TTrain(microbatch=2))
    st = tstep.init_opt_state(params, TTrain())
    _, _, m = tfn(params, st, batch)
    assert np.isfinite(float(m["loss"])) and int(st["count"]) == 1


# ---------------------------------------------------------------------------
# checkpoints, the trainer, the CLI
# ---------------------------------------------------------------------------

class StopAfter(PreemptionHandler):
    """Asks the trainer to stop at its ``n``-th poll (one a step, after
    it)."""

    def __init__(self, n):
        super().__init__(install=False)
        self.n = n

    @property
    def should_stop(self):
        self.n -= 1
        return self.n <= 0


def test_trainer_resume_equals_an_uninterrupted_run(tmp_path):
    cfg = configs.get_reduced("qwen2.5-3b").replace(pum=TPUM(mode="pum"))
    kw = dict(steps=5, learning_rate=1e-2, warmup_steps=1, ckpt_every=100,
              ckpt_keep=2)
    whole = Trainer(cfg, TTrain(ckpt_dir=str(tmp_path / "a"), **kw),
                    batch=2, seq=16, device="cpu").run()
    assert not whole["stopped_early"] and whole["last_step"] == 5
    tcfg = TTrain(ckpt_dir=str(tmp_path / "b"), **kw)
    first = Trainer(cfg, tcfg, batch=2, seq=16, preemption=StopAfter(3),
                    device="cpu").run()
    assert first["stopped_early"] and first["last_step"] == 3
    assert tckpt.latest_step(tcfg.ckpt_dir) == 3
    second = Trainer(cfg, tcfg, batch=2, seq=16, device="cpu").run()
    assert second["last_step"] == 5 and not second["stopped_early"]
    assert [h["step"] for h in second["history"]] == [3, 4]
    for a, b in zip(leaves([whole["params"], whole["opt_state"]]),
                    leaves([second["params"], second["opt_state"]])):
        assert torch.equal(a, b)
    assert [h["loss"] for h in second["history"]] == \
        [h["loss"] for h in whole["history"][3:]]


def test_checkpoints_keep_the_reference_layout(tmp_path):
    """The port's checkpoint has JAX's directory names, manifest keys and
    files; its block leaves are per layer where JAX stacks each period
    position's layers, and every other leaf path and shape is JAX's."""
    jcfg, tcfg = _cfgs("qwen2.5-3b", "bf16")
    jp = _jax_params(jcfg)
    jtree = {"params": jp, "opt_state": jstep.init_opt_state(jp, JTrain())}
    tp = bridge.params_from_numpy(to_numpy(jp), tcfg, device="cpu")
    ttree = {"params": tp, "opt_state": tstep.init_opt_state(tp, TTrain())}
    for step in (1, 2, 3):
        jckpt.CheckpointManager(str(tmp_path / "j"), keep=2).save(step, jtree)
        tckpt.CheckpointManager(str(tmp_path / "t"), keep=2).save(step, ttree)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j")) == ["step_00000002", "step_00000003"]
    man = {k: json.loads((tmp_path / k / "step_00000003" / "manifest.json")
                         .read_text()) for k in ("j", "t")}
    assert man["t"].keys() == man["j"].keys() and man["t"]["step"] == 3
    jl, tl = man["j"]["leaves"], man["t"]["leaves"]

    def unstacked(path, meta):
        if ".blocks." not in path:
            return {(path, tuple(meta["shape"]), meta["dtype"])}
        head, tail = path.split(".blocks.")
        pos, rest = tail.split(".", 1)
        return {(f"{head}.blocks.{g * len(jp['blocks']) + int(pos)}.{rest}",
                 tuple(meta["shape"][1:]), meta["dtype"])
                for g in range(meta["shape"][0])}

    want = set().union(*(unstacked(p, m) for p, m in jl.items()))
    got = {(p, tuple(m["shape"]), m["dtype"]) for p, m in tl.items()}
    assert got == want
    assert all(m.keys() == {"file", "shape", "dtype"} for m in tl.values())
    assert sorted(os.listdir(tmp_path / "t" / "step_00000003")) == sorted(
        ["manifest.json"] + [m["file"] for m in tl.values()])
    # loaded back, on the caller's device
    back, step = tckpt.load_checkpoint(str(tmp_path / "t"), ttree,
                                       device="cpu")
    assert step == 3
    for a, b in zip(leaves(back), leaves(ttree)):
        assert a.device.type == "cpu" and torch.equal(a, b)


def test_train_cli_on_the_cpu(tmp_path, capsys):
    res = tlaunch.main(["--reduced", "--device", "cpu", "--steps", "3",
                        "--batch", "4", "--seq", "16", "--pum-mode", "pum",
                        "--microbatch", "2", "--grad-compress",
                        "--log-every", "1", "--ckpt-every", "2",
                        "--ckpt-dir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "mode=pum" in lines[0] and "device=cpu" in lines[0]
    assert [ln.split()[1] for ln in lines[1:4]] == ["0", "1", "2"]
    assert all(" loss " in ln and " gnorm " in ln for ln in lines[1:4])
    final = json.loads(lines[-1])
    assert final["steps"] == 3 and np.isfinite(final["final_loss"])
    assert res["last_step"] == 3 and "ef" in res["opt_state"]
    assert tckpt.latest_step(str(tmp_path)) == 2
