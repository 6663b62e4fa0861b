"""K4's state-byte entry (``gf2_mvm_packed``) on the CPU against the JAX
package's AES round composition, bit for bit: unpack the state bytes,
the parity MVM through JAX's gf2_mvm kernel (interpreted, as the JAX
package's own tests run it on the CPU), pack.  The CUDA kernel against
its plain version: ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import aes_app as jaes
from repro.kernels.gf2_mvm import gf2_mvm as j_gf2_mvm
from repro_torch.apps import aes_app as taes
from repro_torch.kernels import registry
from repro_torch.kernels.gf2_mvm import (gf2_mvm_packed, gf2_mvm_packed_ref,
                                         pack_bits, unpack_bits)

# ShiftRows∘MixColumns, ShiftRows, InvMixColumns
MATRICES = [0, 1, 2]


def _jax_round(s: np.ndarray, m: np.ndarray) -> np.ndarray:
    bits = jaes._unpack_bits_j(jnp.asarray(s))
    out = j_gf2_mvm(bits, jnp.asarray(m, jnp.int8), backend="interpret")
    return np.asarray(jaes._pack_bits_j(out))


@pytest.mark.parametrize("mat", MATRICES)
@pytest.mark.parametrize("m", [1, 7, 130, 4096])
def test_plain_equals_jax_round_composition(m, mat):
    rng = np.random.default_rng(m * 3 + mat)
    s = rng.integers(0, 256, size=(m, 16), dtype=np.uint8)
    a = jaes._linear_matrices()[mat]
    want = _jax_round(s, a)
    ta = torch.from_numpy(taes._linear_matrices()[mat]).to(torch.int8)
    got = gf2_mvm_packed_ref(torch.from_numpy(s), ta)
    assert got.dtype == torch.uint8 and got.shape == (m, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    registry.reset_launches()
    np.testing.assert_array_equal(
        gf2_mvm_packed(torch.from_numpy(s), ta).numpy(), want)
    assert sum(registry.LAUNCHES.values()) == 0     # CPU: the plain version


def test_bit_layout_equals_jax():
    """Byte-major, LSB-first, as the JAX app unpacks and packs."""
    s = np.arange(256, dtype=np.uint8).reshape(16, 16)
    bits = unpack_bits(torch.from_numpy(s))
    np.testing.assert_array_equal(bits.numpy(),
                                  np.asarray(jaes._unpack_bits_j(s)))
    assert bits.dtype == torch.int8
    np.testing.assert_array_equal(pack_bits(bits).numpy(), s)


def test_leading_dims_and_any_int8_matrix():
    """Only each matrix entry's low bit counts; leading dims pass
    through."""
    rng = np.random.default_rng(9)
    s = rng.integers(0, 256, size=(2, 5, 16), dtype=np.uint8)
    a = rng.integers(-128, 128, size=(128, 128)).astype(np.int8)
    got = gf2_mvm_packed(torch.from_numpy(s), torch.from_numpy(a))
    assert got.shape == (2, 5, 16)
    want = _jax_round(s.reshape(-1, 16), (a & 1).astype(np.int8))
    np.testing.assert_array_equal(got.numpy().reshape(-1, 16), want)


def test_rejects_what_it_cannot_take():
    s = torch.zeros((4, 16), dtype=torch.uint8)
    a = torch.zeros((128, 128), dtype=torch.int8)
    with pytest.raises(registry.KernelTileError, match="128x128"):
        gf2_mvm_packed(s, a[:, :64])
    with pytest.raises(registry.KernelTileError, match="128x128"):
        gf2_mvm_packed(s[:, :15], a)
    with pytest.raises(registry.KernelTileError):      # the kernel on a CPU
        gf2_mvm_packed(s, a, backend="cuda")
