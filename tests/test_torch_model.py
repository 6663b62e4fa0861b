"""The port's lm.forward against the JAX package's, with JAX's weights
carried across by the bridge: prefill logits and a paged prefill chunk
followed by one paged decode step, at Qwen2.5-3B's structure (QKV
bias, tied embeddings) cut to a small width."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_numpy
from repro.config import PUMConfig as JPUM
from repro.configs import qwen2_5_3b as jqwen
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.config import PUMConfig as TPUM
from repro_torch.configs import qwen2_5_3b as tqwen
from repro_torch.models import lm as tlm

# f32: the integer contractions are exact on equal inputs, so logits
# differ only by f32 summation order (~1e-7 here).  bf16: XLA's CPU
# backend keeps bf16 regions in f32 between fusion boundaries while
# torch rounds after every op, and each bf16 ulp can move an int8
# activation step; logits of magnitude ~0.5 agree within 5e-2.
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# bf16 mode's projections are float matmuls, whose f32 sums differ
# across frameworks by summation order (~1e-7); where their K/V pass
# through the bf16 pools, that can flip a cell's bf16 rounding (2^-8
# relative), which moves f32 logits of magnitude ~0.5 by a few 1e-4
# (int8/pum K/V are exact integer sums times equal scales: no flips)
BF16_MODE_POOL_TOL = 2e-3


def _models(mode, dtype):
    jcfg = jqwen.reduced().replace(pum=JPUM(mode=mode), dtype=dtype)
    tcfg = tqwen.reduced().replace(pum=TPUM(mode=mode), dtype=dtype)
    assert jcfg.qkv_bias and jcfg.tie_embeddings
    raw = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    # non-zero biases, so the bias path is exercised
    rng = np.random.default_rng(0)
    raw = jax.tree_util.tree_map_with_path(
        lambda p, a: a + jnp.asarray(rng.normal(size=a.shape) * 0.05,
                                     a.dtype)
        if jax.tree_util.keystr(p).endswith("['b']") else a, raw)
    jp = jlm.prepack_for_serving(raw, jcfg)
    tp = bridge.params_from_numpy(to_numpy(jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _close(t, j, dtype, atol=None):
    np.testing.assert_allclose(t.numpy(), np.asarray(j),
                               atol=TOL[dtype] if atol is None else atol,
                               rtol=0)


@pytest.mark.parametrize("mode", ["pum", "int8", "bf16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_match(mode, dtype):
    jcfg, jp, tcfg, tp = _models(mode, dtype)
    toks = np.random.default_rng(1).integers(0, 256, (2, 9)).astype(
        np.int32)
    jl, _, _ = jlm.forward(jp, jnp.asarray(toks), jcfg)
    tl, _ = tlm.forward(tp, torch.from_numpy(toks), tcfg)
    assert tl.shape == (2, 9, 256) and tl.dtype == torch.float32
    _close(tl, jl, dtype)
    jl1, _, _ = jlm.forward(jp, jnp.asarray(toks), jcfg, last_only=True)
    tl1, _ = tlm.forward(tp, torch.from_numpy(toks), tcfg, last_only=True)
    _close(tl1, jl1, dtype)


@pytest.mark.parametrize("mode", ["pum", "int8", "bf16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_chunk_then_decode_match(mode, dtype):
    jcfg, jp, tcfg, tp = _models(mode, dtype)
    bs, w, max_len = 4, 4, 16
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 256, (2, 6)).astype(np.int32)
    nxt = rng.integers(0, 256, (2, 1)).astype(np.int32)
    ci0 = np.zeros(2, np.int32)
    ci1 = np.full(2, 6, np.int32)

    js = jlm.init_paged_state(jcfg, 2, max_len, num_blocks=8,
                              block_size=bs)
    jl, js, _ = jlm.forward(jp, jnp.asarray(toks), jcfg, states=js,
                            cache_index=jnp.asarray(ci0),
                            block_table=jnp.asarray(table),
                            kv_len=max_len, last_only=True)
    jd, js, _ = jlm.forward(jp, jnp.asarray(nxt), jcfg, states=js,
                            cache_index=jnp.asarray(ci1),
                            block_table=jnp.asarray(table), kv_len=max_len,
                            last_only=True)
    ts = tlm.init_paged_state(tcfg, 2, max_len, num_blocks=8,
                              block_size=bs, device="cpu")
    tt = torch.from_numpy(table)
    tl, ts = tlm.forward(tp, torch.from_numpy(toks), tcfg, states=ts,
                         cache_index=torch.from_numpy(ci0), block_table=tt,
                         kv_len=max_len, last_only=True)
    td, ts = tlm.forward(tp, torch.from_numpy(nxt), tcfg, states=ts,
                         cache_index=torch.from_numpy(ci1), block_table=tt,
                         kv_len=max_len, last_only=True)
    atol = BF16_MODE_POOL_TOL if (mode, dtype) == ("bf16", "float32") \
        else None
    _close(tl, jl, dtype, atol)
    _close(td, jd, dtype, atol)
    # the pools hold the same K/V (bf16 storage) for the written cells
    jk = np.asarray(js[0]["k_pool"], np.float32)
    for layer, st in enumerate(ts):
        assert st["k_pool"].dtype == torch.bfloat16
        np.testing.assert_allclose(st["k_pool"].float().numpy()[1:9],
                                   jk[layer][1:9], atol=TOL[dtype] * 2,
                                   rtol=2e-2)


def test_unported_families_raise():
    """The one layout the port does not serve: an MoE FFN beside an
    xLSTM mixer (every registered config is served)."""
    from repro_torch.config import MoEConfig
    cfg = tqwen.reduced().replace(xlstm_slstm_every=2, d_ff=128,
                                  moe=MoEConfig(num_experts=4, top_k=2))
    with pytest.raises(NotImplementedError, match="MoE FFNs"):
        tlm.init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match(dtype):
    """Norms, RoPE and the GELU MLP branch (bf16-mode float weights)."""
    import jax.numpy as jnp
    from repro.config import small_test_config as jsmall
    from repro.models import layers as jl, mlp as jm
    from repro_torch.config import small_test_config as tsmall
    from repro_torch.models import layers as tl, mlp as tm
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" \
        else dict(atol=2e-2, rtol=2e-2)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    tp = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}

    def close(t, j):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), **tol)

    close(tl.rmsnorm(tp, tx), jl.rmsnorm(jp, jx))
    close(tl.layernorm(tp, tx), jl.layernorm(jp, jx))
    pos = np.arange(5, dtype=np.int32) + 7
    jc, js = jl.rope_tables(jnp.asarray(pos), 16, 1e6)
    tc, ts = tl.rope_tables(torch.from_numpy(pos), 16, 1e6)
    close(tc, jc)
    close(ts, js)
    xh = x.reshape(2, 5, 4, 16)
    close(tl.apply_rope(torch.from_numpy(xh).to(td), tc, ts),
          jl.apply_rope(jnp.asarray(xh, jd), jc, js))
    assert tl.padded_vocab(151936) == jl.padded_vocab(151936) == 152064
    kw = dict(activation="gelu", dtype=dtype)
    jcfg, tcfg = jsmall(**kw), tsmall(**kw)
    w = {k: rng.normal(size=s).astype(np.float32) * 0.1 for k, s in
         (("wu", (64, 128)), ("bu", (128,)), ("wd", (128, 64)),
          ("bd", (64,)))}
    jmp = {"wu": {"w": jnp.asarray(w["wu"]), "b": jnp.asarray(w["bu"])},
           "wd": {"w": jnp.asarray(w["wd"]), "b": jnp.asarray(w["bd"])}}
    tmp = {"wu": {"w": torch.from_numpy(w["wu"]),
                  "b": torch.from_numpy(w["bu"])},
           "wd": {"w": torch.from_numpy(w["wd"]),
                  "b": torch.from_numpy(w["bd"])}}
    close(tm.mlp(tmp, tx, tcfg), jm.mlp(jmp, jx, jcfg))
