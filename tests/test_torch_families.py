"""The rest of the model registry against the JAX package: glm4-9b,
minicpm-2b, command-r-plus-104b, llava-next-mistral-7b (its projected
image prefix) and whisper-tiny (its encoder and cross-attention), at
their reduced sizes in f32, with JAX's weights carried across by the
bridge, in ``pum``, ``int8`` and ``bf16``.

Tolerances:

  * ``bf16`` mode (float weights, no quantiser): logits within ``TOL``
    = 1e-4 of JAX's, as ``tests/test_torch_model.py`` holds f32 logits
    (here ~1e-6); over the paged pools within its
    ``BF16_MODE_POOL_TOL``, a cached cell's bf16 rounding flipped by an
    f32 difference.  This holds the structure: the image prefix, the
    encoder, cross-attention, the decoder without RoPE;
  * ``pum``/``int8``: the integer contractions are exact on equal
    inputs, but an f32 difference of ~1e-7 (a softmax's, a norm's sum)
    can quantise an activation sitting on an int8 rounding edge one step
    apart.  At these sizes that happens in one draw in five to ten (at
    Qwen2.5-3B's structure too, and in whisper's encoder as often), and
    moves logits by up to ~6e-3, the encoder's output by up to ~3e-2.
    So logits are held within ``FLIP_TOL`` = 1e-2 (the bound
    ``tests/test_torch_scheduler.py`` states for the same step), the
    encoder's output within ``ENC_FLIP_TOL``, and the pools' cells of
    the first layer (its input the embedding, equal on both sides) bit
    for bit;
  * greedy tokens equal JAX's wherever JAX's top-2 logit margin exceeds
    10x the mode's tolerance (past a near-tie the two may legitimately
    part), and inside the port bit for bit: the compiled token loop
    against the per-token loop, the scheduler against its solo oracle.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (agree_outside_near_ties, jax_logits_along, margin,
                         to_numpy)
from repro import configs as jconfigs
from repro.config import PUMConfig as JPUM
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.serve import ContinuousBatchingScheduler as JSched
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch import bridge, configs
from repro_torch.config import PUMConfig as TPUM
from repro_torch.core import prepack
from repro_torch.kernels.paged_attention import ops as tpa
from repro_torch.models import lm, transformer
from repro_torch.serve import (ContinuousBatchingScheduler, Request,
                               ServeEngine, oracle_completion)

TOL = 1e-4
BF16_MODE_POOL_TOL = 2e-3
FLIP_TOL = 1e-2
ENC_FLIP_TOL = 5e-2
ARCHS = ["glm4-9b", "minicpm-2b", "command-r-plus-104b",
         "llava-next-mistral-7b", "whisper-tiny"]
MODES = ["pum", "int8", "bf16"]
# the dense configs' structure is Qwen2.5-3B's (tests/test_torch_model.py
# holds it in bf16 mode); the image prefix and the encoder-decoder are
# new, and held in bf16 mode here; the engine paths over them in the
# integer modes
PACKED = ["pum", "int8"]
CASES = [(a, m) for a in ARCHS for m in MODES
         if m != "bf16" or a in ("llava-next-mistral-7b", "whisper-tiny")]
_jax_forward = jax.jit(jlm.forward, static_argnums=2,
                       static_argnames=("last_only", "kv_len"))


@functools.cache
def _jax_raw(jcfg, seed):
    return jax.jit(jlm.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))


def _jax_params(jcfg, seed):
    """JAX's params for ``jcfg``, packed for its mode: init (once an
    arch, whatever the mode: its draws do not depend on it) and prepack
    each compiled whole (both sides of a comparison take this one
    tree, so how JAX rounded while packing it does not matter)."""
    raw = _jax_raw(jcfg.replace(pum=JPUM()), seed)
    return jax.jit(lambda p: jlm.prepack_for_serving(p, jcfg))(raw)


def _close(got, want, mode, pools=False, flip=FLIP_TOL):
    """``got`` within the mode's tolerance of ``want`` (``flip`` in
    ``pum``/``int8``)."""
    tol = (BF16_MODE_POOL_TOL if pools else TOL) if mode == "bf16" else flip
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0)


@pytest.mark.parametrize("arch", sorted(jconfigs.all_arch_ids()))
def test_configs_equal_the_reference(arch):
    assert sorted(configs.all_arch_ids()) == sorted(jconfigs.all_arch_ids())
    for get in ("get", "get_reduced"):
        want = dataclasses.asdict(getattr(jconfigs, get)(arch))
        assert dataclasses.asdict(getattr(configs, get)(arch)) == want
    if arch == "llava-next-mistral-7b":
        from repro.configs import llava_next_mistral_7b as jllava
        from repro_torch.configs import llava_next_mistral_7b as tllava
        assert tllava.NUM_IMAGE_TOKENS == jllava.NUM_IMAGE_TOKENS == 2880


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-{m}" for a, m in CASES])
def model(request):
    """One arch in one mode at its reduced size in f32: JAX's prepacked
    params and the port's, carried across by the bridge; inputs drawn
    from a seed, the image embeddings and encoder frames too."""
    arch, mode = request.param
    jcfg = jconfigs.get_reduced(arch).replace(pum=JPUM(mode=mode),
                                              dtype="float32")
    tcfg = configs.get_reduced(arch).replace(pum=TPUM(mode=mode),
                                             dtype="float32")
    jp = _jax_params(jcfg, 3)
    tp = bridge.params_from_numpy(to_numpy(jp), tcfg, device="cpu")
    rng = np.random.default_rng(1)
    extra = {}
    if jcfg.vision_stub:
        extra["image_embeds"] = rng.normal(
            size=(2, jcfg.num_image_tokens, jcfg.d_model)).astype(np.float32)
    if jcfg.is_encoder_decoder:
        extra["encoder_frames"] = rng.normal(
            size=(2, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, extra=extra,
                toks=rng.integers(0, 256, (2, 9)).astype(np.int32))


def test_prefill_logits_match(model):
    """Whole-prompt logits, with the image prefix (llava) or the encoder
    over its frames (whisper) where the arch has one."""
    jcfg, tcfg, toks = model["jcfg"], model["tcfg"], model["toks"]
    jkw = {k: jnp.asarray(v) for k, v in model["extra"].items()}
    tkw = {k: torch.from_numpy(v) for k, v in model["extra"].items()}
    jl, _, _ = _jax_forward(model["jp"], jnp.asarray(toks), jcfg, **jkw)
    tl, _ = lm.forward(model["tp"], torch.from_numpy(toks), tcfg, **tkw)
    s = 9 + (jcfg.num_image_tokens if jcfg.vision_stub else 0)
    assert tl.shape == (2, s, 256 if jcfg.vocab_size == 256 else 512)
    _close(tl, jl, jcfg.pum.mode)


def test_paged_chunk_then_decode_match(model):
    """One paged prefill chunk and one decode step (whisper's decoder
    over the encoder's output, computed once, as the engine does)."""
    jcfg, tcfg, toks = model["jcfg"], model["tcfg"], model["toks"]
    bs, max_len = 4, 16
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    nxt = np.random.default_rng(2).integers(0, 256, (2, 1)).astype(np.int32)
    ci0, ci1 = np.zeros(2, np.int32), np.full(2, 6, np.int32)
    jenc = tenc = None
    if jcfg.is_encoder_decoder:
        frames = model["extra"]["encoder_frames"]
        jenc = jlm._run_encoder(model["jp"], jcfg, jnp.asarray(frames))
        tenc = lm._run_encoder(model["tp"], tcfg, torch.from_numpy(frames))
        _close(tenc, jenc, jcfg.pum.mode, flip=ENC_FLIP_TOL)
    js = jlm.init_paged_state(jcfg, 2, max_len, num_blocks=8, block_size=bs)
    ts = lm.init_paged_state(tcfg, 2, max_len, num_blocks=8, block_size=bs,
                             device="cpu")
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    got, want = [], []
    for step, ci in ((toks[:, :6], ci0), (nxt, ci1)):
        jl, js, _ = _jax_forward(model["jp"], jnp.asarray(step), jcfg,
                                states=js, cache_index=jnp.asarray(ci),
                                block_table=jt, kv_len=max_len,
                                encoder_out=jenc, last_only=True)
        tl, ts = lm.forward(model["tp"], torch.from_numpy(step), tcfg,
                            states=ts, cache_index=torch.from_numpy(ci),
                            block_table=tt, kv_len=max_len,
                            encoder_out=tenc, last_only=True)
        got.append(tl)
        want.append(jl)
    for t, j in zip(got, want):
        _close(t, j, jcfg.pum.mode, pools=True)
    # the first layer's written cells: the same bf16 K/V bit for bit (in
    # bf16 mode its projections are float products: a cell may round
    # otherwise, as BF16_MODE_POOL_TOL allows)
    for name in ("k_pool", "v_pool") if jcfg.pum.mode != "bf16" else ():
        np.testing.assert_array_equal(
            ts[0][name].float().numpy()[1:9],
            np.asarray(js[0][name][0], np.float32)[1:9])


@pytest.mark.parametrize("mode", PACKED)
def test_llava_image_prefix_then_decode(mode):
    """The image prefix into a contiguous cache at cache index 0, as the
    card's phase does, then two decode steps at the joined length."""
    jcfg = jconfigs.get_reduced("llava-next-mistral-7b").replace(
        pum=JPUM(mode=mode), dtype="float32")
    tcfg = configs.get_reduced("llava-next-mistral-7b").replace(
        pum=TPUM(mode=mode), dtype="float32")
    jp = _jax_params(jcfg, 5)
    tp = bridge.params_from_numpy(to_numpy(jp), tcfg, device="cpu")
    rng = np.random.default_rng(7)
    img = rng.normal(size=(2, 8, 64)).astype(np.float32)
    toks = rng.integers(0, 256, (2, 5)).astype(np.int32)
    js = jlm.init_state(jcfg, 2, 24)
    ts = lm.init_state(tcfg, 2, 24, device="cpu")
    jl, js, _ = _jax_forward(jp, jnp.asarray(toks), jcfg, states=js,
                             cache_index=jnp.int32(0),
                             image_embeds=jnp.asarray(img), last_only=True)
    tl, ts = lm.forward(tp, torch.from_numpy(toks), tcfg, states=ts,
                        cache_index=0, image_embeds=torch.from_numpy(img),
                        last_only=True)
    _close(tl, jl, mode)
    for i in range(2):
        last = np.asarray(jl)[:, -1]
        tok = np.argmax(last, -1)[:, None].astype(np.int32)
        for row in range(2):
            if margin(last[row]) > 10 * FLIP_TOL:
                assert int(tl[row, -1].argmax()) == tok[row, 0]
        jl, js, _ = _jax_forward(jp, jnp.asarray(tok), jcfg, states=js,
                                 cache_index=jnp.int32(13 + i),
                                 last_only=True)
        tl, ts = lm.forward(tp, torch.from_numpy(tok), tcfg, states=ts,
                            cache_index=13 + i, last_only=True)
        _close(tl, jl, mode, pools=True)


# K3's layouts at the new group sizes: command-r-plus-104b's G = 12 and
# glm4-9b's G = 16 (one position's heads span two CTAs on the card), at
# a small head dim
@pytest.mark.parametrize("g", [12, 16])
@pytest.mark.parametrize("s", [1, 16])
def test_paged_composition_at_wide_groups(g, s):
    """The port's paged attention (its plain version on the CPU) against
    the reference's composition (``_paged_update_and_gather`` then
    ``_plain_attention``): the pools' real blocks bit for bit, the
    active rows' outputs within f32 tolerance."""
    b, w, bs, kvh, hd = 3, 6, 4, 2, 16
    rng = np.random.default_rng(g + s)
    nb = 1 + b * w
    q, kn, vn = (rng.standard_normal(sh).astype(np.float32) for sh in
                 ((b, s, kvh, g, hd), (b, s, kvh, hd), (b, s, kvh, hd)))
    kp, vp = (rng.standard_normal((nb, bs, kvh, hd)).astype(np.float32)
              for _ in range(2))
    table = np.arange(1, nb).reshape(b, w).astype(np.int32)
    table[-1] = 0                      # an inactive row on the trash block
    ci = np.asarray([3, w * bs - s, 0], np.int32)
    kv_len = w * bs
    cache, k_all, v_all, qpos = jattn._paged_update_and_gather(
        {"k_pool": jnp.asarray(kp), "v_pool": jnp.asarray(vp)},
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(table),
        jnp.asarray(ci), kv_len)
    mask = jnp.arange(kv_len)[None, None, :] <= qpos[..., None]
    jo = jattn._plain_attention(jnp.asarray(q), k_all, v_all, mask, 0.0)
    tk, tv, to = tpa.paged_attention(
        *(torch.from_numpy(a) for a in (q, kn, vn, kp, vp, table,
                                        table.copy(), ci)), kv_len=kv_len)
    np.testing.assert_array_equal(tk.numpy()[1:],
                                  np.asarray(cache["k_pool"])[1:])
    np.testing.assert_array_equal(tv.numpy()[1:],
                                  np.asarray(cache["v_pool"])[1:])
    np.testing.assert_allclose(to.numpy()[:-1], np.asarray(jo)[:-1],
                               atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", params=PACKED)
def whisper(request):
    mode = request.param
    jcfg = jconfigs.get_reduced("whisper-tiny").replace(pum=JPUM(mode=mode),
                                                        dtype="float32")
    tcfg = configs.get_reduced("whisper-tiny").replace(pum=TPUM(mode=mode),
                                                       dtype="float32")
    raw = jlm.init_params(jcfg, jax.random.PRNGKey(11))
    tp = bridge.params_from_numpy(
        to_numpy(jlm.prepack_for_serving(raw, jcfg)), tcfg, device="cpu")
    rng = np.random.default_rng(13)
    return dict(jcfg=jcfg, tcfg=tcfg, raw=raw, tp=tp,
                frames=rng.normal(size=(2, 32, 64)).astype(np.float32),
                prompt=rng.integers(0, 256, (2, 6)).astype(np.int32))


def _jax_logits_with_frames(jeng, prompt, frames, tokens):
    """JAX's last-position logits [B, len, V] before each column of
    ``tokens`` [B, len], fed through its prefill over ``frames`` and its
    decode steps over the encoder's output."""
    states, lg, enc = jeng.prefill(jnp.asarray(prompt), jnp.asarray(frames))
    steps = [np.asarray(lg)[:, -1]]
    for i in range(tokens.shape[1] - 1):
        lg, states = jeng._decode(jeng.params, states,
                                  jnp.asarray(tokens[:, i:i + 1]),
                                  jnp.int32(prompt.shape[1] + i),
                                  encoder_out=enc)
        steps.append(np.asarray(lg)[:, -1])
    return np.stack(steps, axis=1)


def test_whisper_generate_with_frames(whisper):
    """Greedy ``generate(encoder_frames=)``: the compiled token loop
    equals the per-token loop bit for bit and builds its two programs
    once for the shape, whatever the frames; other frames give other
    tokens; JAX's engine gives the same tokens but past a near-tie."""
    eng = ServeEngine(whisper["tcfg"], whisper["tp"], max_len=24,
                      device="cpu")
    prompt, frames = whisper["prompt"], whisper["frames"]
    tp, tf = torch.from_numpy(prompt), torch.from_numpy(frames)
    got = eng.generate(tp, 8, encoder_frames=tf)
    assert got.shape == (2, 14)
    assert torch.equal(got, eng.generate_loop(tp, 8, encoder_frames=tf))
    assert torch.equal(eng.generate(tp, 5, encoder_frames=tf), got[:, :11])
    assert not torch.equal(eng.generate(tp, 8, encoder_frames=tf * 2), got)
    assert torch.equal(eng.generate(tp, 8, encoder_frames=tf), got)
    assert eng.scan_programs() == {(2, 6, 0.0, (32, 64, torch.float32)): 1}
    jeng = JEngine(whisper["jcfg"], whisper["raw"], max_len=24,
                   kernel_backend="xla")
    want = np.asarray(jeng.generate(jnp.asarray(prompt), 8,
                                    encoder_frames=jnp.asarray(frames)))
    logits = _jax_logits_with_frames(jeng, prompt, frames, want[:, 6:])
    agreed = [agree_outside_near_ties(got[row, 6:].tolist(),
                                      want[row, 6:].tolist(), logits[row],
                                      FLIP_TOL, 0.0) for row in range(2)]
    assert sum(agreed) >= 8, agreed


@pytest.mark.parametrize("arch", ["glm4-9b", "whisper-tiny"])
def test_scheduler_tokens_match_jax(arch):
    """The paged scheduler (chunked prefill, blocks of 4) on three
    staggered greedy requests against the JAX scheduler's tokens, and
    against its own solo oracle bit for bit.  Whisper's decoder runs
    alone (no frames), as the reference's scheduler runs it."""
    jcfg = jconfigs.get_reduced(arch).replace(pum=JPUM(mode="pum"),
                                              dtype="float32")
    tcfg = configs.get_reduced(arch).replace(pum=TPUM(mode="pum"),
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
        compared += agree_outside_near_ties(got, want, logits, TOL, 0.0)
    assert compared >= 12


@pytest.mark.parametrize("arch", ["glm4-9b", "llava-next-mistral-7b",
                                  "whisper-tiny", "jamba-v0.1-52b"])
@pytest.mark.parametrize("mode", ["pum", "int8", "bf16"])
def test_pack_at_load_is_prepack_of_the_whole_tree(arch, mode):
    """``init_params(pack=True)`` packs each layer as drawn: the same
    tree as packing the whole float tree, bit for bit, vision_proj and
    the encoder's blocks included; bf16 leaves the weights float."""
    cfg = configs.get_reduced(arch).replace(pum=TPUM(mode=mode))
    whole = lm.prepack_for_serving(
        lm.init_params(cfg, torch.Generator().manual_seed(4), device="cpu"),
        cfg)
    packed = lm.init_params(cfg, torch.Generator().manual_seed(4),
                            device="cpu", pack=True)

    def leaves(tree, path=""):
        if isinstance(tree, prepack.PackedLinear):
            yield from ((f"{path}.{f.name}", getattr(tree, f.name))
                        for f in dataclasses.fields(tree))
        elif isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{path}.{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}[{i}]")
        else:
            yield path, tree

    a, b = dict(leaves(whole)), dict(leaves(packed))
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k
    n_packed = sum(k.endswith(".wq") for k in a)
    assert n_packed == (0 if mode == "bf16" else n_packed) and (
        mode == "bf16" or n_packed > 0)
    if cfg.vision_stub and mode != "bf16":
        assert isinstance(packed["vision_proj"]["w"], prepack.PackedLinear)
    if cfg.is_encoder_decoder:
        assert len(packed["encoder"]["blocks"]) == cfg.encoder_layers
        assert "cross" in packed["blocks"][0]


def test_every_registered_config_is_supported():
    """``check_supported`` passes all ten configs, the encoder-decoder
    and the vision stub included (``tests/test_torch_model.py`` holds
    the one raise left)."""
    for arch in configs.all_arch_ids():
        transformer.check_supported(configs.get(arch))


@pytest.mark.parametrize("mode", ["pum", "int8"])
def test_pack_weight_by_columns_is_the_whole(mode, monkeypatch):
    """``pack_weight`` quantises and slices a few columns a pass (memory
    at load); any pass width packs the weight as one pass does, stacked
    weights too."""
    cfg = TPUM(mode=mode)
    w = torch.randn((3, 40, 50), generator=torch.Generator().manual_seed(2))
    whole = prepack.pack_weight(w, cfg)
    for elems in (1, 7 * 40 * 3, 40 * 3 * 50 - 1):
        monkeypatch.setattr(prepack, "PACK_ELEMS", elems)
        part = prepack.pack_weight(w, cfg)
        for f in ("planes", "wq", "scale"):
            a, b = getattr(whole, f), getattr(part, f)
            assert (a is None and b is None) or torch.equal(a, b), f
