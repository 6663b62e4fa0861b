"""The port's gf2_mvm (K4's wrapper and plain version) against the JAX
package's kernel and oracle on the CPU, bit for bit.  The CUDA kernel
against its plain version: ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gf2_mvm import gf2_mvm as j_gf2_mvm
from repro.kernels.gf2_mvm import gf2_mvm_ref as j_gf2_ref
from repro.kernels.gf2_mvm.kernel import gf2_mvm_pallas
from repro_torch.kernels import registry
from repro_torch.kernels.gf2_mvm import gf2_mvm, gf2_mvm_ref


def _case(seed, m, k, n, lo=0, hi=2):
    rng = np.random.default_rng(seed)
    x = rng.integers(lo, hi, size=(m, k)).astype(np.int8)
    a = rng.integers(0, 2, size=(k, n)).astype(np.int8)
    return x, a


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 128, 256),
                                   (128, 384, 128)])
def test_plain_equals_pallas_kernel_interpreted(m, k, n):
    """The TPU kernel's own body (interpreted) at its block shapes."""
    x, a = _case(m + k + n, m, k, n)
    want = np.asarray(gf2_mvm_pallas(jnp.asarray(x), jnp.asarray(a),
                                     interpret=True))
    got = gf2_mvm_ref(torch.from_numpy(x), torch.from_numpy(a))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,n", [(128, 128), (200, 129), (64, 32),
                                 (384, 32)])
@pytest.mark.parametrize("m", [1, 7, 130])
def test_wrapper_equals_jax_interpret_backend(m, k, n):
    """Any M, K, N: the JAX wrapper pads to its blocks, the port's takes
    the shapes as they are."""
    x, a = _case(m * 1000 + k + n, m, k, n)
    want = np.asarray(j_gf2_mvm(jnp.asarray(x), jnp.asarray(a),
                                backend="interpret"))
    registry.reset_launches()
    got = gf2_mvm(torch.from_numpy(x), torch.from_numpy(a))
    assert got.shape == (m, n) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert sum(registry.LAUNCHES.values()) == 0     # CPU: the plain version


def test_low_bits_of_any_int8_values():
    """The kernel reads each byte's low bit; for any integers that gives
    the parity of the integer product, as JAX's int32 oracle has it."""
    x, a = _case(3, 33, 200, 48, lo=-128, hi=128)
    a = np.random.default_rng(4).integers(-128, 128, size=a.shape).astype(
        np.int8)
    want = np.asarray(j_gf2_ref(jnp.asarray(x), jnp.asarray(a)))
    got = gf2_mvm(torch.from_numpy(x), torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), want)


def test_leading_dims_and_linearity():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(0, 2, size=(128, 128)).astype(np.int8))
    x = torch.from_numpy(rng.integers(0, 2, size=(2, 8, 128)).astype(np.int8))
    y = torch.from_numpy(rng.integers(0, 2, size=(2, 8, 128)).astype(np.int8))
    fx, fy, fxy = gf2_mvm(x, a), gf2_mvm(y, a), gf2_mvm(x ^ y, a)
    assert fx.shape == (2, 8, 128)
    assert torch.equal(fxy, fx ^ fy)
    np.testing.assert_array_equal(
        gf2_mvm(x[1], a).numpy(), fx[1].numpy())


def test_rejects_what_it_cannot_take():
    x = torch.zeros((4, 128), dtype=torch.int8)
    with pytest.raises(registry.KernelTileError, match="contract"):
        gf2_mvm(x, torch.zeros((64, 8), dtype=torch.int8))
    with pytest.raises(registry.KernelTileError):      # the kernel on a CPU
        gf2_mvm(x, torch.zeros((128, 8), dtype=torch.int8), backend="cuda")
