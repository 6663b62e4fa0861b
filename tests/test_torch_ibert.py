"""The port's I-BERT integer kernels (``repro_torch.core.ibert``) against
the JAX package's (``repro.core.ibert``), bit for bit: codes, scales and
the float wrappers' outputs, on the same numpy inputs.

JAX's I-BERT is plain ``jnp`` (no Pallas kernel), so both run here as
they are.  Beside the reference's own cases (``tests/test_ibert.py``)
the inputs reach the places where a line-for-line port would part from
the reference:

  * an all-zero tensor and tensors of absmax 1e-3, 1e-6, 1e-9 and
    1e-12: the scales make ``floor(b / s)`` and its kin leave int32
    range, where XLA's conversion saturates and a plain
    ``.to(torch.int32)`` does not (and i_gelu's output scale goes
    subnormal, which XLA on the CPU flushes to zero);
  * scores of magnitude ~1e-2 over 64 keys: ``i_softmax``'s int32 sum
    of the exponentials wraps mod 2^32, as an int64 sum would not;
  * a causal-masked score tensor with ``-1e30`` entries: one scale over
    the whole tensor rounds every real score to code 0, so both sides
    give zero probabilities (a fault of the reference, which the port
    keeps);
  * rows of 512 keys of unit spread, whose exponential codes sum past
    the integer reciprocal's 2^15: zero rows on both sides (the
    reference's, kept);
  * ``i_sqrt`` over every n < 2^16 and drawn up to 2^31 - 1.

The last two tests swap the port's saturating cast and its int32 sum
for the naive ones and show that these cases then fail.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import ibert as jib
from repro_torch.core import ibert as tib


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.reshape(-1).view(np.uint8), a.dtype, a.shape


def assert_bits_equal(got: torch.Tensor, want) -> None:
    """Same dtype, shape and bits (so -0.0 and 0.0 differ)."""
    g, w = _bits(got.numpy()), _bits(want)
    assert g[1] == w[1] and g[2] == w[2], (g[1:], w[1:])
    if not np.array_equal(g[0], w[0]):
        gv, wv = got.numpy().reshape(-1), np.asarray(want).reshape(-1)
        bad = np.flatnonzero(gv.view(np.uint8).reshape(gv.size, -1).any(1)
                             != wv.view(np.uint8).reshape(wv.size, -1)
                             .any(1)) if gv.dtype.itemsize else []
        raise AssertionError(f"bits differ: got {gv[:8]}, want {wv[:8]} "
                             f"({len(bad)} elements differ in zero-ness)")


def _masked(rng, b=2, s=8) -> np.ndarray:
    scores = rng.normal(size=(b, s, s)).astype(np.float32)
    mask = np.tril(np.ones((s, s), bool))
    return np.where(mask, scores, np.float32(-1e30)).astype(np.float32)


def _at_absmax(x: np.ndarray, absmax: float) -> np.ndarray:
    return (x / np.abs(x).max() * absmax).astype(np.float32)


def _inputs() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    base = rng.normal(size=(4, 64)).astype(np.float32)
    return {
        "linspace": np.linspace(-4.0, 4.0, 513, dtype=np.float32),
        "normal": (rng.normal(size=(8, 64)) * 3).astype(np.float32),
        "offset": (rng.normal(size=(4, 256)) * 2 + 0.5).astype(np.float32),
        "zeros": np.zeros((4, 64), np.float32),
        "tiny": _at_absmax(base, 1e-3),
        "micro": _at_absmax(base, 1e-6),
        "nano": _at_absmax(base, 1e-9),
        "pico": _at_absmax(base, 1e-12),
        # scores of std ~1e-2 (absmax 0.03) over 64 keys
        "small_scores": _at_absmax(rng.normal(size=(16, 64)), 0.03),
        "masked": _masked(rng),
    }


INPUTS = _inputs()
WRAPPERS = ["gelu_quantized", "softmax_quantized", "layernorm_quantized"]


def _both(name: str):
    x = INPUTS[name]
    return jnp.asarray(x), torch.from_numpy(x.copy())


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("axis", [None, -1])
def test_quantize_bit_for_bit(name, axis):
    jx, tx = _both(name)
    want, got = jib.quantize(jx, 8, axis=axis), tib.quantize(tx, 8, axis=axis)
    assert_bits_equal(got.q, want.q)
    assert_bits_equal(got.s, want.s)
    assert_bits_equal(got.real, want.real)


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("fn", WRAPPERS)
def test_wrappers_bit_for_bit(fn, name):
    jx, tx = _both(name)
    assert_bits_equal(getattr(tib, fn)(tx), getattr(jib, fn)(jx))


def _codes(name: str):
    jx, tx = _both(name)
    return jib.quantize(jx, 8), tib.quantize(tx, 8)


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("fn", ["i_erf", "i_gelu", "i_exp", "i_softmax",
                                "i_layernorm"])
def test_integer_kernels_bit_for_bit(fn, name):
    """Codes and output scale of each ``i_*`` on the same quantised
    input (``i_exp`` on codes shifted to at most 0, its domain)."""
    jt, tt = _codes(name)
    jq, tq = jt.q, tt.q
    if fn == "i_exp":
        jq, tq = jq - jnp.max(jq), tq - torch.amax(tq)
    want = getattr(jib, fn)(jq, jt.s)
    got = getattr(tib, fn)(tq, tt.s)
    assert_bits_equal(got[0], want[0])
    assert_bits_equal(got[1], want[1])


@pytest.mark.parametrize("name", ["normal", "zeros", "tiny", "nano"])
@pytest.mark.parametrize("abc", [(-0.2888, -1.769, 1.0),
                                 (0.3585, 1.353, 0.344), (2.0, 0.0, -3.0)])
def test_i_poly_bit_for_bit(abc, name):
    jt, tt = _codes(name)
    want, got = jib.i_poly(jt.q, jt.s, *abc), tib.i_poly(tt.q, tt.s, *abc)
    assert_bits_equal(got[0], want[0])
    assert_bits_equal(got[1], want[1])


def test_i_sqrt_every_n_below_2_16():
    n = np.arange(1 << 16, dtype=np.int32)
    got = tib.i_sqrt(torch.from_numpy(n))
    assert_bits_equal(got, jib.i_sqrt(jnp.asarray(n)))
    exact = np.floor(np.sqrt(n.astype(np.float64))).astype(np.int32)
    np.testing.assert_array_equal(got.numpy(), exact)


def test_i_sqrt_reference_cases():
    n = np.asarray([0, 1, 2, 3, 4, 15, 16, 17, 255, 256, 1 << 20,
                    (1 << 20) + 1, 999983, (1 << 31) - 1, -5], np.int32)
    assert_bits_equal(tib.i_sqrt(torch.from_numpy(n)),
                      jib.i_sqrt(jnp.asarray(n)))


@given(seed=st.integers(0, 2 ** 31 - 1))
@settings(max_examples=10, deadline=None)
def test_i_sqrt_drawn_up_to_int32_max(seed):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 2 ** 31 - 1, size=(256,), endpoint=True).astype(
        np.int32)
    assert_bits_equal(tib.i_sqrt(torch.from_numpy(n)),
                      jib.i_sqrt(jnp.asarray(n)))


def test_bit_length_is_exact():
    n = np.concatenate([np.arange(1, 4096), (1 << np.arange(31)),
                        (1 << np.arange(1, 31)) - 1, [2 ** 31 - 1]]
                       ).astype(np.int32)
    want = np.array([int(v).bit_length() for v in n], np.int32)
    np.testing.assert_array_equal(
        tib.bit_length(torch.from_numpy(n)).numpy(), want)


def test_to_int32_saturates_as_xla():
    x = np.array([np.inf, -np.inf, np.nan, 3e10, -3e10, 2.0 ** 31,
                  -2.0 ** 31, 2147483520.0, 1.5, -1.5, -0.0, 7.0],
                 np.float32)
    assert_bits_equal(tib.to_int32(torch.from_numpy(x)),
                      jnp.asarray(x).astype(jnp.int32))


def test_small_scores_wrap_the_int32_sum():
    """The case is real: JAX's i_softmax sum of the exponentials of this
    input leaves int32 range and wraps below the integer reciprocal's
    2^15, where the true sum would floor it to 0."""
    jt = jib.quantize(jnp.asarray(INPUTS["small_scores"]), 8)
    qe, _ = jib.i_exp(jt.q - jnp.max(jt.q, axis=-1, keepdims=True), jt.s)
    wrapped = np.asarray(jnp.sum(qe, axis=-1))
    wide = np.asarray(qe).astype(np.int64).sum(-1)
    assert ((wide >= 2 ** 31) & (wrapped < 1 << 15)).any(), (wide, wrapped)


def test_masked_softmax_is_zero_on_both_sides():
    """Motivation of the reference-side fault: a ``-1e30`` entry sets
    the one scale, every real score rounds to code 0, and the integer
    softmax is zero everywhere; the same scores unmasked give rows
    summing to ~1."""
    jx, tx = _both("masked")
    want = np.asarray(jib.softmax_quantized(jx, 8, axis=-1))
    assert not want.any()
    assert_bits_equal(tib.softmax_quantized(tx, 8, axis=-1), want)
    rng = np.random.default_rng(0)
    plain = rng.normal(size=(2, 8, 8)).astype(np.float32)
    got = tib.softmax_quantized(torch.from_numpy(plain), 8, axis=-1)
    assert_bits_equal(got, jib.softmax_quantized(jnp.asarray(plain), 8))
    # the integer reciprocal floors: rows sum to at most 1
    sums = got.sum(-1).numpy()
    assert (sums > 0.5).all() and (sums <= 1.0).all(), sums


@pytest.mark.parametrize("spread,zero", [(1.0, True), (3.0, False)])
def test_long_rows_zero_past_2_15(spread, zero):
    """The integer reciprocal ``2^15 // sum`` is 0 once a row's
    exponential codes sum past 2^15: at 512 keys of unit spread every
    row is zero, on both sides (the reference's, kept); at spread 3 no
    row is (the reciprocal's floor keeps their sums under 1)."""
    x = (np.random.default_rng(7).normal(size=(4, 512)) * spread).astype(
        np.float32)
    want = np.asarray(jib.softmax_quantized(jnp.asarray(x), 8))
    got = tib.softmax_quantized(torch.from_numpy(x), 8)
    assert_bits_equal(got, want)
    sums = got.sum(-1).numpy()
    assert (sums == 0).all() if zero else (sums > 0.8).all(), sums


def _naive_cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _int64_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.sum(x, dim=dim, keepdim=True)


@pytest.mark.parametrize("name,fn", [("tiny", "softmax_quantized"),
                                     ("micro", "softmax_quantized"),
                                     ("nano", "gelu_quantized")])
def test_a_naive_cast_fails_the_saturation_cases(monkeypatch, name, fn):
    """With ``.to(torch.int32)`` in place of the saturating cast, the
    small inputs part from the reference (an all-zero tensor does not:
    its codes are 0, whatever the constants): the cases above hold the
    saturation."""
    jx, tx = _both(name)
    want = np.asarray(getattr(jib, fn)(jx))
    monkeypatch.setattr(tib, "to_int32", _naive_cast)
    got = getattr(tib, fn)(tx).numpy()
    assert not np.array_equal(got.view(np.uint8), want.view(np.uint8))


def test_an_int64_sum_fails_the_wrapping_case(monkeypatch):
    jx, tx = _both("small_scores")
    want = np.asarray(jib.softmax_quantized(jx, 8))
    monkeypatch.setattr(tib, "_isum", _int64_sum)
    got = tib.softmax_quantized(tx, 8).numpy()
    assert not np.array_equal(got, want)


def test_close_to_float_as_the_reference():
    """The reference's accuracy bounds hold for the port's functions."""
    x = torch.linspace(-4.0, 4.0, 513)
    assert (tib.gelu_quantized(x) - torch.nn.functional.gelu(x)).abs(
    ).max() < 0.05
    s = torch.from_numpy((np.random.default_rng(0).normal(size=(8, 64))
                          * 3).astype(np.float32))
    got = tib.softmax_quantized(s)
    assert (got - torch.softmax(s, -1)).abs().max() < 0.05
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=0.05)
    y = torch.from_numpy((np.random.default_rng(1).normal(size=(4, 256))
                          * 2 + 0.5).astype(np.float32))
    want = (y - y.mean(-1, keepdim=True)) / y.std(-1, unbiased=False,
                                                  keepdim=True)
    assert (tib.layernorm_quantized(y) - want).abs().max() < 0.15
