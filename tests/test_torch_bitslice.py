"""The port's core/bitslice.py against the JAX package's, bit for bit:
quantisation (with exact .5 ties), plane slicing, recombination and
the exact integer matmul."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import bitslice as jb
from repro_torch.core import bitslice as tb


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_symmetric_bit_exact(axis, bits):
    x = np.random.default_rng(bits).normal(size=(7, 33)).astype(np.float32)
    jx, tx = _both(x)
    jq, js = jb.quantize_symmetric(jx, bits, axis=axis)
    tq, ts = tb.quantize_symmetric(tx, bits, axis=axis)
    assert tq.dtype == torch.int32 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_rounds_half_to_even_like_jax():
    """Values that land exactly on .5 after scaling: both frameworks
    round half to even (0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -2.5 -> -2)."""
    # absmax 127 makes the scale exactly 1.0, so x / scale = x
    x = np.array([[0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, 126.5, 127.0]],
                 np.float32)
    jx, tx = _both(x)
    jq, js = jb.quantize_symmetric(jx, 8, axis=1)
    tq, ts = tb.quantize_symmetric(tx, 8, axis=1)
    assert float(ts[0, 0]) == 1.0
    want = [0, 2, 2, 4, 0, -2, -2, 126, 127]
    assert tq[0].tolist() == want
    np.testing.assert_array_equal(np.asarray(jq)[0], want)


@given(seed=st.integers(0, 2**31 - 1), bits=st.sampled_from([4, 6, 8]),
       m=st.sampled_from([1, 2, 3]))
@settings(max_examples=8, deadline=None)
def test_slice_and_combine_bit_exact(seed, bits, m):
    rng = np.random.default_rng(seed)
    qmax = (1 << (bits - 1)) - 1
    q = rng.integers(-qmax, qmax + 1, size=(5, 9)).astype(np.int32)
    jq, tq = _both(q)
    jp = jb.slice_planes_signed(jq, bits, m)
    tp = tb.slice_planes_signed(tq, bits, m)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    tc = tb.combine_planes(tp, m)
    np.testing.assert_array_equal(tc.numpy(),
                                  np.asarray(jb.combine_planes(jp, m)))
    np.testing.assert_array_equal(tc.numpy(), q)


@pytest.mark.parametrize("k", [16, 11008])
def test_int_matmul_exact_past_f32_window(k):
    """At Qwen2.5-3B's d_ff the sums pass 2^24, where an f32 product
    would round; the port's plain matmul stays exact."""
    rng = np.random.default_rng(k)
    x = rng.integers(-127, 128, size=(3, k)).astype(np.int32)
    w = rng.integers(-127, 128, size=(k, 5)).astype(np.int32)
    x[0] = 127
    w[:, 0] = 127
    want = x.astype(np.int64) @ w.astype(np.int64)
    got = tb.int_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if k * 127 * 127 < (1 << 24):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jb.int_matmul(*map(jnp.asarray,
                                                       (x, w)))))


def test_bitsliced_matmul_exact_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.integers(-127, 128, size=(4, 40)).astype(np.int32)
    w = rng.integers(-127, 128, size=(40, 12)).astype(np.int32)
    want = np.asarray(jb.bitsliced_matmul_exact(jnp.asarray(x),
                                                jnp.asarray(w), 8, 2))
    got = tb.bitsliced_matmul_exact(torch.from_numpy(x),
                                    torch.from_numpy(w), 8, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_bf16_input_bit_exact():
    """The bf16 case: activations arrive in bf16 and are quantised after
    an exact widening to f32 in both frameworks."""
    x = np.random.default_rng(5).normal(size=(6, 64)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jq, js = jb.quantize_symmetric(jx.astype(jnp.float32), 8, axis=1)
    tq, ts = tb.quantize_symmetric(tx.float(), 8, axis=1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
