"""The port's keyed draws (``repro_torch.serve.prng``) and its
``sample_token`` against ``jax.random`` and the JAX package's
``sample_token``, on the CPU.

JAX runs in its partitionable threefry layout
(``jax.threefry_partitionable(True)``, the default of JAX 0.5 on; the
pinned 0.4.37 defaults to the original layout), which is the one the
port reproduces, so the comparison means the same under either JAX.

Tolerances:

* threefry, keys, ``fold_in`` (data -1 included), random bits and
  uniforms: bit for bit;
* Gumbel values: within ``GUMBEL_ULPS`` ulps of ``max(|g|, 1)``: the
  two frameworks' f32 ``log`` may differ by an ulp, and ``-log(-log u)``
  carries the inner log's error through the outer one (measured: 1);
* categorical draws: equal wherever JAX's top-2 score margin exceeds
  ``NEAR_TIE``, far above the Gumbel difference (at most 2 ulps of a
  value below 17, under 4e-6); the near-ties are counted and bounded.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from repro.serve.engine import sample_token as jsample
from repro_torch.serve import prng
from repro_torch.serve.engine import sample_token

GUMBEL_ULPS = 2
NEAR_TIE = 1e-5
TINY = np.finfo(np.float32).tiny


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _t(a) -> torch.Tensor:
    """uint32 values as the int32 tensor holding their bits."""
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _jkeys(seeds):
    return jnp.stack([jax.random.PRNGKey(s) for s in seeds])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threefry2x32_bit_exact(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 2, 257):
        key = rng.integers(0, 2**32, size=2, dtype=np.uint32)
        count = rng.integers(0, 2**32, size=2 * n, dtype=np.uint32)
        want = np.asarray(jprng.threefry_2x32(
            (jnp.uint32(key[0]), jnp.uint32(key[1])), jnp.asarray(count)))
        y0, y1 = prng.threefry2x32(_t(key[0]), _t(key[1]), _t(count[:n]),
                                   _t(count[n:]))
        np.testing.assert_array_equal(np.concatenate([_u(y0), _u(y1)]),
                                      want)


def test_threefry2x32_known_answers():
    """Threefry-2x32's known-answer vectors (20 rounds), which
    ``chip_smoke.py`` checks on the card too."""
    for key, count, want in [
            ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
             (0xc4923a9c, 0x483df7a0)),
            ((0, 0), (0, 0), (0x6b200159, 0x99ba4efe))]:
        got = prng.threefry2x32(*(_t([w]) for w in key + count))
        assert tuple(int(_u(g)[0]) for g in got) == want


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1])
def test_prng_key_bit_exact(seed):
    np.testing.assert_array_equal(_u(prng.prng_key(seed)),
                                  np.asarray(jax.random.PRNGKey(seed)))


def test_fold_in_bit_exact_including_minus_one():
    """``vmap(fold_in)`` with an int32 ``gen - 1``, as the reference's slot
    step folds: an empty slot's -1 folds as 0xFFFFFFFF."""
    seeds = [0, 7, 2**31 - 1, 12345, 99]
    gen = np.array([0, 1, 5, 2**31 - 1, -2**31], np.int32)
    want = np.asarray(jax.vmap(jax.random.fold_in)(
        _jkeys(seeds), jnp.asarray(gen) - 1))
    keys = torch.stack([prng.prng_key(s) for s in seeds])
    got = prng.fold_in(keys, torch.from_numpy(gen) - 1)
    np.testing.assert_array_equal(_u(got), want)
    # a Python int as the solo loop folds, -1 wrapping the same way
    np.testing.assert_array_equal(
        _u(prng.fold_in(prng.prng_key(7), -1)),
        np.asarray(jax.random.fold_in(jax.random.PRNGKey(7),
                                      np.uint32(0xFFFFFFFF))))
    np.testing.assert_array_equal(
        _u(prng.fold_in(prng.prng_key(7), 3)),
        np.asarray(jax.random.fold_in(jax.random.PRNGKey(7), 3)))


@pytest.mark.parametrize("shape", [(1000,), (4, 777), (3, 5, 7), (13,)])
def test_random_bits_and_uniform_bit_exact(shape):
    key = jax.random.PRNGKey(42)
    tkey = prng.prng_key(42)
    np.testing.assert_array_equal(_u(prng.random_bits(tkey, shape)),
                                  np.asarray(jax.random.bits(key, shape)))
    want = np.asarray(jax.random.uniform(key, shape, minval=TINY))
    got = prng.uniform(tkey, shape).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= TINY and got.max() < 1.0


def test_random_bits_and_uniform_with_a_key_a_row_bit_exact():
    """Keys [B, 2] draw over ``(V,)`` row by row: ``vmap`` over the key."""
    seeds, v = [3, 1, 4, 1, 5], 1001
    jkeys = _jkeys(seeds)
    keys = torch.stack([prng.prng_key(s) for s in seeds])
    np.testing.assert_array_equal(
        _u(prng.random_bits(keys, (v,))),
        np.asarray(jax.vmap(lambda k: jax.random.bits(k, (v,)))(jkeys)))
    want = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (v,), minval=TINY))(jkeys))
    np.testing.assert_array_equal(prng.uniform(keys, (v,)).numpy(), want)


def _ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return np.abs(got - want) / np.spacing(
        np.maximum(np.abs(want), 1).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 11, 2**31 - 1])
def test_gumbel_within_ulps(seed):
    shape = (8, 4096)
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
    got = prng.gumbel(prng.prng_key(seed), shape).numpy()
    assert np.isfinite(got).all()
    assert _ulps(got, want).max() <= GUMBEL_ULPS


def _margin(scores: np.ndarray) -> np.ndarray:
    top2 = np.sort(scores, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("form", ["one key", "a key a row"])
def test_categorical_equal_but_near_ties(form):
    """256 draws over 1000 classes, logits of a few units: each equals
    JAX's unless JAX's top-2 (gumbel + logits) margin is a near-tie."""
    b, v = 256, 1000
    logits = (2 * np.random.default_rng(5).standard_normal((b, v))
              ).astype(np.float32)
    if form == "one key":
        jkey, tkey = jax.random.PRNGKey(9), prng.prng_key(9)
        want = np.asarray(jax.random.categorical(jkey, logits))
        noise = np.asarray(jax.random.gumbel(jkey, (b, v)))
    else:
        jkey = _jkeys(range(b))
        tkey = torch.stack([prng.prng_key(s) for s in range(b)])
        want = np.asarray(jax.vmap(jax.random.categorical)(jkey, logits))
        noise = np.asarray(jax.vmap(
            lambda k: jax.random.gumbel(k, (v,)))(jkey))
    got = prng.categorical(tkey, torch.from_numpy(logits)).numpy()
    near = _margin(noise + logits) <= NEAR_TIE
    assert near.sum() <= 2, near.sum()
    np.testing.assert_array_equal(got[~near], want[~near])
    # the two forms draw differently for B > 1, in both frameworks
    other = (torch.stack([prng.prng_key(9)] * b) if form == "one key"
             else prng.prng_key(9))
    assert not np.array_equal(
        prng.categorical(other, torch.from_numpy(logits)).numpy(), got)


def test_sample_token_mixed_temperatures_match_jax():
    """The vector form at temperatures [0, 0.7, -1, 1.0] on JAX's own
    logits: the rows at t <= 0 are the argmax, the others JAX's draws
    (none of these draws is a near-tie: checked below)."""
    temps = np.array([0.0, 0.7, -1.0, 1.0], np.float32)
    seeds = [21, 22, 23, 24]
    jlogits = jax.random.normal(jax.random.PRNGKey(1), (4, 1, 512))
    logits = np.array(jlogits)
    jkeys = _jkeys(seeds)
    keys = torch.stack([prng.prng_key(s) for s in seeds])
    want = np.asarray(jsample(jlogits, jkeys, jnp.asarray(temps)))
    got = sample_token(torch.from_numpy(logits), keys,
                       torch.from_numpy(temps))
    assert got.dtype == torch.int32 and got.shape == (4, 1)
    got = got.numpy()
    np.testing.assert_array_equal(got[[0, 2], 0],
                                  logits[[0, 2], -1].argmax(-1))
    safe_t = np.where(temps > 0, temps, 1)[:, None]
    noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (512,)))(
        jkeys))
    assert (_margin(noise + logits[:, -1] / safe_t) > NEAR_TIE).all()
    np.testing.assert_array_equal(got, want)
    # the sampled rows draw: over 32 keys, row 3 (t = 1) takes more
    # than one token
    draws = {int(sample_token(torch.from_numpy(logits),
                              torch.stack([prng.prng_key(s)] * 4),
                              torch.from_numpy(temps))[3, 0])
             for s in range(32)}
    assert len(draws) > 1


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.0])
def test_sample_token_scalar_form_matches_jax(temperature):
    jlogits = jax.random.normal(jax.random.PRNGKey(2), (3, 2, 300))
    logits = np.array(jlogits)
    want = np.asarray(jsample(jlogits, jax.random.PRNGKey(4), temperature))
    got = sample_token(torch.from_numpy(logits), prng.prng_key(4),
                       temperature).numpy()
    noise = np.asarray(jax.random.gumbel(jax.random.PRNGKey(4), (3, 300)))
    scores = logits[:, -1] if temperature <= 0 else \
        noise + logits[:, -1] / np.float32(temperature)
    assert (_margin(scores) > NEAR_TIE).all()
    np.testing.assert_array_equal(got, want)


def test_greedy_needs_no_key_and_sampling_does():
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 1, 16)).astype(np.float32))
    assert torch.equal(sample_token(logits)[:, 0],
                       logits[:, -1].argmax(-1).to(torch.int32))
    with pytest.raises(ValueError, match="needs a key"):
        sample_token(logits, None, 0.5)
    with pytest.raises(TypeError, match="f32"):
        prng.categorical(prng.prng_key(0), logits.to(torch.float64))
