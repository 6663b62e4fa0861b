"""The port's core/prepack.py and the weight bridge against the JAX
package, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_numpy
from repro.config import PUMConfig as JPUM, small_test_config as jsmall
from repro.core import prepack as jpre
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.config import PUMConfig as TPUM, small_test_config as tsmall
from repro_torch.core import prepack as tpre
from repro_torch.core.prepack import PackedLinear


def _assert_same(tp: PackedLinear, jp):
    assert (tp.mode, tp.weight_bits, tp.bits_per_slice) == (
        jp.mode, jp.weight_bits, jp.bits_per_slice)
    if jp.planes is None:
        assert tp.planes is None
    else:
        assert tp.planes.dtype == torch.int8
        np.testing.assert_array_equal(tp.planes.numpy(),
                                      np.asarray(jp.planes))
    assert tp.wq.dtype == torch.int8
    np.testing.assert_array_equal(tp.wq.numpy(), np.asarray(jp.wq))
    np.testing.assert_array_equal(tp.scale.numpy(), np.asarray(jp.scale))


@pytest.mark.parametrize("mode,bps", [("pum", 2), ("pum", 1), ("int8", 1)])
@pytest.mark.parametrize("stacked", [False, True])
def test_pack_weight_bit_exact(mode, bps, stacked):
    shape = (3, 48, 24) if stacked else (48, 24)
    w = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    jp = jpre.pack_weight(jnp.asarray(w), JPUM(mode=mode,
                                                bits_per_slice=bps))
    tp = tpre.pack_weight(torch.from_numpy(w), TPUM(mode=mode,
                                                    bits_per_slice=bps))
    _assert_same(tp, jp)


def test_pack_weight_bf16_bit_exact():
    w = np.random.default_rng(8).normal(size=(32, 16)).astype(np.float32)
    jp = jpre.pack_weight(jnp.asarray(w, jnp.bfloat16), JPUM(mode="pum"))
    tp = tpre.pack_weight(torch.from_numpy(w).to(torch.bfloat16),
                          TPUM(mode="pum"))
    _assert_same(tp, jp)


def test_pack_weight_rejects_wide_and_bf16_mode():
    w = torch.zeros((4, 4))
    with pytest.raises(ValueError):
        tpre.pack_weight(w, TPUM(mode="pum", weight_bits=10,
                                 bits_per_slice=2))
    with pytest.raises(ValueError):
        tpre.pack_weight(w, TPUM(mode="bf16"))
    assert tpre.prepack_params({"w": w}, TPUM(mode="bf16"))["w"] is w


@pytest.mark.parametrize("mode", ["pum", "int8"])
def test_bridge_unstacks_packed_model(mode):
    """JAX's prepacked, group-stacked tree -> per-layer port params: the
    bridge carries every packed leaf across bit for bit, and packing
    the bridged float tree in the port gives the same leaves."""
    kw = dict(qkv_bias=True, tie_embeddings=True, num_layers=3)
    jcfg = jsmall(pum=JPUM(mode=mode), **kw)
    tcfg = tsmall(pum=TPUM(mode=mode), **kw)
    raw = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    packed = jlm.prepack_for_serving(raw, jcfg)
    tp = bridge.params_from_numpy(to_numpy(packed), tcfg, device="cpu")
    tr = tpre.prepack_params(
        bridge.params_from_numpy(to_numpy(raw), tcfg, device="cpu"),
        tcfg.pum)
    assert len(tp["blocks"]) == 3 and "lm_head" not in tp
    np.testing.assert_array_equal(tp["embed"].numpy(),
                                  np.asarray(packed["embed"]))
    jblk = packed["blocks"][0]
    for layer in range(3):
        for path in (("attn", "wq"), ("attn", "wo"), ("mlp", "wd")):
            jl = jblk[path[0]][path[1]]["w"]
            jone = jax.tree_util.tree_map(lambda a, i=layer: a[i], jl)
            _assert_same(tp["blocks"][layer][path[0]][path[1]]["w"], jone)
            _assert_same(tr["blocks"][layer][path[0]][path[1]]["w"], jone)
        np.testing.assert_array_equal(
            tp["blocks"][layer]["attn"]["wq"]["b"].numpy(),
            np.asarray(jblk["attn"]["wq"]["b"][layer]))
