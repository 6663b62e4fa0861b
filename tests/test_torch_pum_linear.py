"""The port's pum_linear serving paths against the JAX package's: the
int32 accumulators bit for bit for the same input, outputs within
tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ADCConfig as JADC, NoiseConfig as JNoise
from repro.config import PUMConfig as JPUM
from repro.core import bitslice as jb
from repro.core import prepack as jpre
from repro.core import pum_linear as jpl
from repro_torch.config import ADCConfig, NoiseConfig
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_positionwise_runs_a_float_product_position_by_position(
        dtype, monkeypatch):
    """Inside ``positionwise`` a ``bf16``-mode product of [B, S, K] rows
    runs as S products of [B, 1, K] rows, each bit-equal to that
    position alone; outside it, one product over all rows; a norm's
    mean likewise.  The integer modes give the same output inside and
    outside."""
    _, (tx, tw, tb_) = _case(4, dtype)
    cfg = TPUM(mode="bf16")
    shapes = []
    matmul = torch.matmul

    def recording(a, b):
        shapes.append(tuple(a.shape))
        return matmul(a, b)

    monkeypatch.setattr(torch, "matmul", recording)
    with tpl.positionwise():
        got = tpl.pum_linear(tx, tw, cfg, bias=tb_)
    assert shapes == [(2, 1, 96)] * 6
    for j in range(6):
        one = tpl.pum_linear(tx[:, j:j + 1].contiguous(), tw, cfg, bias=tb_)
        assert torch.equal(got[:, j:j + 1], one), j
    shapes.clear()
    tpl.pum_linear(tx, tw, cfg, bias=tb_)
    assert shapes == [(2, 6, 96)]
    monkeypatch.undo()
    for mode in ("pum", "int8"):
        packed = tpre.pack_weight(tw, TPUM(mode=mode))
        with tpl.positionwise():
            inside = tpl.pum_linear(tx, packed, TPUM(mode=mode))
        assert torch.equal(inside, tpl.pum_linear(tx, packed, TPUM(mode=mode)))
    from repro_torch.config import small_test_config
    from repro_torch.models import layers
    cfg = small_test_config(d_model=96)
    norm = {"scale": torch.from_numpy(
        np.random.default_rng(5).normal(size=96).astype(np.float32))}
    seen = []
    mean = torch.mean

    def recording_mean(x, *a, **kw):
        seen.append(tuple(x.shape))
        return mean(x, *a, **kw)

    monkeypatch.setattr(torch, "mean", recording_mean)
    with tpl.positionwise():
        got = layers.norm_apply(norm, tx, cfg)
    assert seen == [(2, 1, 96)] * 6
    monkeypatch.undo()
    for j in range(6):
        assert torch.equal(got[:, j:j + 1], layers.norm_apply(
            norm, tx[:, j:j + 1].contiguous(), cfg)), j


def test_unported_paths_raise():
    """The raw-weight int8/pum forward has its gradient now (the QAT
    straight-through estimator, ``tests/test_torch_train.py`` holds it
    against JAX's): it no longer raises where autograd needs one, gives
    ``yq`` with or without a gradient, and none under ``no_grad``."""
    (_, _, _), (tx, tw, _) = _case(4, "float32")
    for mode in ("pum", "int8"):
        w = tw.clone().requires_grad_()
        x = tx.clone().requires_grad_()
        y = tpl.pum_linear(x, w, TPUM(mode=mode))
        y.sum().backward()
        assert w.grad.shape == tw.shape and x.grad.shape == tx.shape
        with torch.no_grad():
            y0 = tpl.pum_linear(tx, tw.clone().requires_grad_(),
                                TPUM(mode=mode))
        assert y0.shape == (2, 6, 40) and not y0.requires_grad
        assert torch.equal(y.detach(), y0)
        assert torch.equal(tpl.pum_linear(tx, tw, TPUM(mode=mode)), y0)
    # the float mode keeps its gradient
    w = tw.clone().requires_grad_()
    tpl.pum_linear(tx, w, TPUM(mode="bf16")).sum().backward()
    assert w.grad is not None


# ---------------------------------------------------------------------------
# the raw-weight forwards (quantised per call): the ResNet path
# ---------------------------------------------------------------------------

RAW_K = [27, 144, 576]
RAW_N = [10, 16, 64]


def _raw_case(seed, k, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 5, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * np.sqrt(2.0 / k)).astype(np.float32)
    return (jnp.asarray(x), jnp.asarray(w)), (torch.from_numpy(x),
                                              torch.from_numpy(w))


@pytest.mark.parametrize("k", RAW_K)
@pytest.mark.parametrize("n", RAW_N)
def test_raw_pum_bit_exact(k, n):
    """Per-tensor weight quantisation, the bit-plane int32 accumulator
    and the f32 output, all bit for bit (tolerance: none)."""
    (jx, jw), (tx, tw) = _raw_case(k + n, k, n)
    jwq, jws = jb.quantize_symmetric(jw, 8)
    twq, tws = tb.quantize_symmetric(tw, 8)
    np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))
    jq, _ = jpl._quantize_act(jx, 8)
    tq, _ = tpl._quantize_act(tx, 8)
    want = np.asarray(jb.bitsliced_matmul_exact(jq, jwq, 8, 2))
    np.testing.assert_array_equal(
        tb.bitsliced_matmul_exact(tq, twq, 8, 2).numpy(), want)
    np.testing.assert_array_equal(
        tmvm.bitslice_mvm(tq, twq, weight_bits=8, bits_per_slice=2).numpy(),
        want)
    jy = jpl.pum_linear(jx, jw, JPUM(mode="pum"))
    ty = tpl.pum_linear(tx, tw, TPUM(mode="pum"))
    assert ty.dtype == torch.float32 and ty.shape == (2, 5, n)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("k", RAW_K)
@pytest.mark.parametrize("n", RAW_N)
def test_raw_int8_bit_exact(k, n):
    """Per-column weight quantisation, the int32 accumulator and the f32
    output, bit for bit (tolerance: none)."""
    (jx, jw), (tx, tw) = _raw_case(2 * k + n, k, n)
    jwq, jws = jb.quantize_symmetric(jw, 8, axis=0)
    twq, tws = tb.quantize_symmetric(tw, 8, axis=0)
    np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))
    jq, _ = jpl._quantize_act(jx, 8)
    tq, _ = tpl._quantize_act(tx, 8)
    want = np.asarray(jb.int_matmul(jq, jwq))
    np.testing.assert_array_equal(tb.int_matmul(tq, twq).numpy(), want)
    np.testing.assert_array_equal(
        tmvm.bitslice_mvm(tq, twq, weight_bits=8, bits_per_slice=8).numpy(),
        want)
    jy = jpl.pum_linear(jx, jw, JPUM(mode="int8"))
    ty = tpl.pum_linear(tx, tw, TPUM(mode="int8"))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def _noisy(prog_sigma=0.05, read_sigma=0.0):
    return TPUM(mode="pum", adc=ADCConfig("sar", bits=10),
                noise=NoiseConfig(enable=True, prog_sigma=prog_sigma,
                                  read_sigma=read_sigma))


@pytest.mark.parametrize("packed", [False, True], ids=["raw", "packed"])
@pytest.mark.parametrize("noise", [dict(prog_sigma=0.05),
                                   dict(prog_sigma=0.0, read_sigma=0.5)],
                         ids=["prog", "read"])
def test_noise_branch_follows_the_generator(packed, noise):
    """The ACE simulation draws its noise from the generator: the same
    seed gives the same bits, another seed other bits, and noise on
    differs from noise off (the exact MVM)."""
    (_, _), (tx, tw) = _raw_case(7, 144, 16)
    cfg = _noisy(**noise)
    w = tpre.pack_weight(tw, TPUM(mode="pum")) if packed else tw

    def run(seed):
        return tpl.pum_linear(tx, w, cfg,
                              generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    exact = tpl.pum_linear(tx, w, TPUM(mode="pum"))
    assert not torch.equal(a, exact)
    if noise["prog_sigma"]:
        # 5 % conductance error: the result stays near the exact MVM
        assert (a - exact).abs().max() < 0.5 * exact.abs().max()


@pytest.mark.parametrize("packed", [False, True], ids=["raw", "packed"])
def test_noise_branch_without_noise_is_the_exact_mvm(packed):
    """``noise.enable`` with zero sigmas runs the ACE simulation, whose
    10-bit ADC digitises a 64-row array's count exactly: the same f32
    output as the exact path (and as JAX's, bit for bit)."""
    (jx, jw), (tx, tw) = _raw_case(8, 144, 10)
    tcfg = TPUM(mode="pum", adc=ADCConfig("sar", bits=10),
                noise=NoiseConfig(enable=True))
    jcfg = JPUM(mode="pum", adc=JADC("sar", bits=10),
                noise=JNoise(enable=True))
    if packed:
        tw_, jw_ = (tpre.pack_weight(tw, TPUM(mode="pum")),
                    jpre.pack_weight(jw, JPUM(mode="pum")))
    else:
        tw_, jw_ = tw, jw
    got = tpl.pum_linear(tx, tw_, tcfg)
    np.testing.assert_array_equal(got.numpy(),
                                  tpl.pum_linear(tx, tw_,
                                                 TPUM(mode="pum")).numpy())
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpl.pum_linear(jx, jw_, jcfg)))
