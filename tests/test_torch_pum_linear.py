"""The port's pum_linear serving paths against the JAX package's: the
int32 accumulators bit for bit for the same input, outputs within
tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import PUMConfig as JPUM
from repro.core import bitslice as jb
from repro.core import prepack as jpre
from repro.core import pum_linear as jpl
from repro_torch.config import PUMConfig as TPUM
from repro_torch.core import bitslice as tb
from repro_torch.core import prepack as tpre
from repro_torch.core import pum_linear as tpl
from repro_torch.kernels.bitslice_mvm import ops as tmvm


def _case(seed, dtype, m=6, k=96, n=40):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32) * 0.1
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ((jnp.asarray(x, jd), jnp.asarray(w), jnp.asarray(b)),
            (torch.from_numpy(x).to(td), torch.from_numpy(w),
             torch.from_numpy(b)))


@pytest.mark.parametrize("mode", ["pum", "int8"])
def test_int32_accumulators_bit_exact(mode):
    (jx, jw, _), (tx, tw, _) = _case(1, "float32")
    jp = jpre.pack_weight(jw, JPUM(mode=mode))
    tp = tpre.pack_weight(tw, TPUM(mode=mode))
    jq, js = jpl._quantize_act(jx, 8)
    tq, ts = tpl._quantize_act(tx, 8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    want = np.asarray(jb.int_matmul(jq, jp.wq))
    # the torch backend's contraction and the kernel's plain function
    # over the planes (or the single int8 plane) give the same int32
    np.testing.assert_array_equal(tb.int_matmul(tq, tp.wq).numpy(), want)
    planes = tp.planes if mode == "pum" else tp.wq[None]
    bps = tp.bits_per_slice if mode == "pum" else 8
    np.testing.assert_array_equal(
        tmvm.bitslice_mvm_planes(tq, planes, bits_per_slice=bps).numpy(),
        want)


@pytest.mark.parametrize("mode", ["pum", "int8"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 1e-2)])
def test_packed_outputs_match(mode, dtype, tol):
    """f32: the same bits up to the last f32 ulp of the scale product;
    bf16: outputs round to bf16 (2^-8 relative) in both frameworks."""
    (jx, jw, jb_), (tx, tw, tb_) = _case(2, dtype)
    jy = jpl.pum_linear(jx, jpre.pack_weight(jw, JPUM(mode=mode)),
                        JPUM(mode=mode), bias=jb_)
    ty = tpl.pum_linear(tx, tpre.pack_weight(tw, TPUM(mode=mode)),
                        TPUM(mode=mode), bias=tb_)
    assert ty.dtype == tx.dtype and ty.shape == (2, 6, 40)
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), rtol=tol,
                               atol=tol)


def test_bf16_mode_matches():
    (jx, jw, _), (tx, tw, _) = _case(3, "bfloat16")
    jy = jpl.pum_linear(jx, jw, JPUM(mode="bf16", inference=True))
    ty = tpl.pum_linear(tx, tw, TPUM(mode="bf16"))
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_unported_paths_raise():
    (_, _, _), (tx, tw, _) = _case(4, "float32")
    with pytest.raises(NotImplementedError):
        tpl.pum_linear(tx, tw, TPUM(mode="pum"))          # QAT path
    noisy = TPUM(mode="pum")
    noisy = type(noisy)(mode="pum", noise=type(noisy.noise)(enable=True))
    with pytest.raises(NotImplementedError):
        tpl.pum_linear(tx, tpre.pack_weight(tw, noisy), noisy)
