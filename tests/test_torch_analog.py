"""The port's ACE simulator against the JAX package's on the CPU.

Where the result is deterministic (noise disabled, or IR drop alone) the
int32 outputs must be equal bit for bit.  JAX draws its programming and
read noise from threefry keys, which torch does not reproduce, so the
noisy paths are held to properties of the port itself.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ADCConfig as JADC, NoiseConfig as JNoise
from repro.core import analog as ja
from repro.core import bitslice as jb
from repro_torch.config import ADCConfig, NoiseConfig
from repro_torch.core import analog as ta
from repro_torch.core import bitslice as tb

# adc_quantize's float output: both round half to even and divide by the
# same LSB; 1e-6 relative covers an FMA XLA may form around it
ADC_RTOL = 1e-6


def _both(kind="sar", bits=8, early=0, **noise):
    return ((JADC(kind, bits=bits, early_levels=early), JNoise(**noise)),
            (ADCConfig(kind, bits=bits, early_levels=early),
             NoiseConfig(**noise)))


@pytest.mark.parametrize("kind,bits,early,fs", [
    ("sar", 8, 0, 255.0), ("sar", 4, 0, 192.0), ("ramp", 8, 4, 255.0),
    ("ramp", 8, 0, 128.0)])
def test_adc_quantize_equals_jax(kind, bits, early, fs):
    v = np.random.default_rng(bits).uniform(-5, 300, size=(64,)).astype(
        np.float32)
    v[:4] = [0.5, 1.5, 2.5, 63.5]                  # ties round to even
    (jadc, _), (tadc, _) = _both(kind, bits, early)
    want = np.asarray(ja.adc_quantize(jnp.asarray(v), jadc, fs))
    got = ta.adc_quantize(torch.from_numpy(v), tadc, fs)
    np.testing.assert_allclose(got.numpy(), want, rtol=ADC_RTOL, atol=0)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("bits", [4, 8])
def test_slice_bits_input_equals_jax(bits, signed):
    lo = -(1 << (bits - 1)) if signed else 0
    x = np.random.default_rng(bits).integers(lo, 1 << (bits - 1),
                                             size=(3, 17)).astype(np.int32)
    jp, jw = jb.slice_bits_input(jnp.asarray(x), bits, signed=signed)
    tp, tw = tb.slice_bits_input(torch.from_numpy(x), bits, signed=signed)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(
        np.tensordot(tw, tp.numpy().astype(np.int64), axes=1), x)


NOISE = [dict(enable=False), dict(enable=True, ir_alpha=5e-5),
         dict(enable=True, ir_alpha=0.04)]


@pytest.mark.parametrize("noise", NOISE)
@pytest.mark.parametrize("k", [16, 64, 100])
@pytest.mark.parametrize("bps", [1, 2])
def test_crossbar_mvm_equals_jax(bps, k, noise):
    rng = np.random.default_rng(k + bps)
    x = rng.integers(-127, 128, size=(2, k)).astype(np.int32)
    w = rng.integers(-7, 8, size=(k, 5)).astype(np.int32)
    (jadc, jn), (tadc, tn) = _both("sar", 8, **noise)
    kw = dict(weight_bits=4, bits_per_slice=bps, input_bits=8)
    want = np.asarray(ja.crossbar_mvm(jnp.asarray(x), jnp.asarray(w), adc=jadc,
                                      noise=jn, **kw))
    got = ta.crossbar_mvm(torch.from_numpy(x), torch.from_numpy(w), adc=tadc,
                          noise=tn, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if not noise["enable"]:
        np.testing.assert_array_equal(got.numpy(), x @ w)


@pytest.mark.parametrize("noise", NOISE)
@pytest.mark.parametrize("fn", ["compensated_binary_mvm",
                                "naive_binary_mvm"])
@pytest.mark.parametrize("kind,early", [("sar", 0), ("ramp", 0),
                                        ("ramp", 4)])
def test_binary_mvms_equal_jax(fn, noise, kind, early):
    rng = np.random.default_rng(7)
    K, N = 64, 32
    w = rng.integers(0, 2, size=(K, N)).astype(np.int32)
    w[:, 0] = 1                       # a full line current
    x = rng.integers(0, 2, size=(8, K)).astype(np.int32)
    (jadc, jn), (tadc, tn) = _both(kind, 8, early, **noise)
    want = np.asarray(getattr(ja, fn)(jnp.asarray(x), jnp.asarray(w),
                                      noise=jn, adc=jadc))
    got = getattr(ta, fn)(torch.from_numpy(x), torch.from_numpy(w),
                          noise=tn, adc=tadc)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_compensation_beats_naive_under_ir_drop():
    """Paper Fig. 11: under the IR-drop proxy the naive mapping mis-reads
    while the remapped scheme + compensation factor is exact."""
    rng = np.random.default_rng(7)
    w = rng.integers(0, 2, size=(64, 32)).astype(np.int32)
    w[:, 0] = 1
    x = np.zeros((8, 64), np.int32)
    for r in range(8):
        x[r, rng.choice(64, size=4, replace=False)] = 1
    noise, adc = NoiseConfig(enable=True, ir_alpha=0.04), ADCConfig("sar", 8)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    comp = ta.compensated_binary_mvm(xt, wt, noise=noise, adc=adc).numpy()
    naive = ta.naive_binary_mvm(xt, wt, noise=noise, adc=adc).numpy()
    assert np.abs(comp - x @ w).max() == 0
    assert np.abs(naive - x @ w).max() > 0


def test_noisy_paths_follow_the_generator():
    """Programming and read noise: drawn from the caller's generator (the
    same seed gives the same result), perturbing but bounded."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.integers(0, 64, size=(4, 64)).astype(np.int32))
    w = torch.from_numpy(rng.integers(-7, 8, size=(64, 8)).astype(np.int32))
    noise = NoiseConfig(enable=True, prog_sigma=0.05, read_sigma=0.2)
    kw = dict(weight_bits=4, bits_per_slice=2, input_bits=7,
              adc=ADCConfig("sar", bits=8), noise=noise, signed_inputs=False)

    def run(seed):
        return ta.crossbar_mvm(x, w, generator=torch.Generator().manual_seed(
            seed), **kw).numpy()

    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    want = (x @ w).numpy()
    rel = np.abs(a - want).max() / (np.abs(want).max() + 1)
    assert 0 < rel < 0.5
    xb = torch.from_numpy(rng.integers(0, 2, size=(8, 64)).astype(np.int32))
    wb = torch.from_numpy(rng.integers(0, 2, size=(64, 16)).astype(np.int32))
    r1 = ta.compensated_binary_mvm(
        xb, wb, noise=NoiseConfig(enable=True, read_sigma=0.05),
        adc=ADCConfig("sar", 8), generator=torch.Generator().manual_seed(3))
    # read noise of 0.05 LSB stays under half an LSB: still exact
    np.testing.assert_array_equal(r1.numpy(), (xb @ wb).numpy())
