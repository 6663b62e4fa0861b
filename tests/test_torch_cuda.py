"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without a card every test here skips (the
kernels have no CPU mode).  Imports no JAX, so it runs on the machine
with the card: ``python -m pytest -q tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core import bitslice
from repro_torch.kernels import registry
from repro_torch.kernels.bitslice_mvm import ops as mvm
from repro_torch.kernels.gf2_mvm import ops as gf2
from repro_torch.kernels.paged_attention import ops as pa

# bf16 pools: the kernel sums in f32 in another order than the plain
# version, so a probability or an output may round to the neighbouring
# bf16 value (2^-8 relative); outputs of O(1) agree within 2e-2
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 64, 16), (7, 300, 48),
                                   (33, 2048, 256)])
def test_bitslice_mvm_kernels_bit_exact(dev, m, k, n):
    g = torch.Generator(device=dev).manual_seed(m * k + n)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int32)
    planes = bitslice.slice_planes_signed(wq, 8, 2).to(torch.int8)
    x = torch.randint(-127, 128, (2, m, k), generator=g, device=dev,
                      dtype=torch.int32)
    scale = torch.rand((2, m, 1), generator=g, device=dev)
    registry.reset_launches()
    got = mvm.bitslice_mvm_planes_scaled(x, planes, scale)
    want = mvm.bitslice_mvm_planes_scaled(x, planes, scale, backend="torch")
    assert torch.equal(got, want)
    one = wq.to(torch.int8)[None]
    got = mvm.bitslice_mvm_planes(x, one, bits_per_slice=8)
    assert torch.equal(got, mvm.bitslice_mvm_planes(
        x, one, bits_per_slice=8, backend="torch"))
    assert registry.LAUNCHES == {"bitslice_mvm_scaled": 1,
                                 "bitslice_mvm": 1}


@pytest.mark.cuda
def test_bitslice_mvm_rejects_what_it_cannot_take(dev):
    x = torch.zeros((2, 64), dtype=torch.int8, device=dev)
    with pytest.raises(registry.KernelTileError):      # N % 16 != 0
        mvm.bitslice_mvm_planes(x, torch.zeros((1, 64, 24), dtype=torch.int8,
                                               device=dev))
    with pytest.raises(registry.KernelTileError):      # not int8
        mvm.bitslice_mvm_planes(x, torch.zeros((1, 64, 32), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("s,softcap,q_dtype", [
    (1, 0.0, torch.bfloat16), (4, 0.0, torch.bfloat16),
    (16, 30.0, torch.bfloat16), (4, 0.0, torch.float32)])
def test_paged_attention_kernel_matches_plain(dev, s, softcap, q_dtype):
    rng = np.random.default_rng(s)
    b, kvh, grp, hd, bs, w = 3, 2, 4, 128, 16, 3
    nb = 1 + b * w

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    table = torch.arange(1, nb, dtype=torch.int32, device=dev).reshape(b, w)
    table[-1] = 0                       # an inactive (all-trash) row
    ci = torch.tensor([0, w * bs - s, 5], dtype=torch.int32, device=dev)
    args = [rnd(b, s, kvh, grp, hd, dtype=q_dtype),
            rnd(b, s, kvh, hd, dtype=q_dtype),
            rnd(b, s, kvh, hd, dtype=q_dtype),
            rnd(nb, bs, kvh, hd), rnd(nb, bs, kvh, hd), table, table.clone(),
            ci]
    rk, rv, ro = pa.paged_attention(*args, kv_len=w * bs - 3,
                                    softcap=softcap, backend="torch")
    registry.reset_launches()
    kk, kv, ko = pa.paged_attention(*args, kv_len=w * bs - 3,
                                    softcap=softcap)
    torch.cuda.synchronize()
    assert registry.LAUNCHES == {"paged_attention": 1}
    assert kk is args[3]                # updated in place
    assert torch.equal(kk[1:], rk[1:]) and torch.equal(kv[1:], rv[1:])
    torch.testing.assert_close(ko[:-1].float(), ro[:-1].float(), **BF16_TOL)
    with pytest.raises(registry.KernelTileError, match="bfloat16"):
        pa.paged_attention(*args[:3], args[3].float(), args[4].float(),
                           *args[5:], kv_len=w * bs - 3)


@pytest.mark.cuda
# K = 512 is the longest K the register-resident kernel takes; K = 1000
# runs the long-K kernel
@pytest.mark.parametrize("k,n", [(128, 128), (200, 129), (64, 32),
                                 (512, 48), (1000, 129)])
@pytest.mark.parametrize("m", [1, 7, 130, 4096])
def test_gf2_mvm_kernel_bit_exact(dev, m, k, n):
    rng = np.random.default_rng(m * 1000 + k + n)
    x = torch.from_numpy(rng.integers(0, 2, size=(m, k)).astype(np.int8))
    a = torch.from_numpy(rng.integers(0, 2, size=(k, n)).astype(np.int8))
    x, a = x.to(dev), a.to(dev)
    registry.reset_launches()
    got = gf2.gf2_mvm(x, a)
    want = gf2.gf2_mvm(x, a, backend="torch")
    torch.cuda.synchronize()
    assert registry.LAUNCHES == {"gf2_mvm": 1}
    assert got.dtype == torch.int8 and got.shape == (m, n)
    assert torch.equal(got, want)
    # only each byte's low bit counts: any int8 values give the parity of
    # the integer product
    xw = torch.from_numpy(rng.integers(-128, 128, size=(2, m, k)).astype(
        np.int8)).to(dev)
    got = gf2.gf2_mvm(xw, a)
    want = (xw.cpu().to(torch.int64) @ a.cpu().to(torch.int64)) & 1
    assert torch.equal(got.cpu().to(torch.int64), want)


@pytest.mark.cuda
def test_gf2_mvm_rejects_what_it_cannot_take(dev):
    x = torch.zeros((4, 128), dtype=torch.int8, device=dev)
    a = torch.zeros((128, 128), dtype=torch.int8, device=dev)
    with pytest.raises(registry.KernelTileError, match="int8"):
        gf2.gf2_mvm(x.to(torch.int32), a)
    with pytest.raises(registry.KernelTileError, match="int8"):
        gf2.gf2_mvm(x, a.to(torch.int32))
    with pytest.raises(registry.KernelTileError, match="on"):
        gf2.gf2_mvm(x, a.cpu())
