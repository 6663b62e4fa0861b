"""The port's CUDA kernels against their plain PyTorch versions, and its
compiled serving step (CUDA graphs) against eager dispatch, on the
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
# bf16 value (2^-8 relative); outputs of O(1) agree within 2e-2.  Paged
# attention must also stay within the plain version's own change when
# every V cell moves up by one bf16 ulp (times 1 + ULP), a bound that
# scales with the outputs: over a long window they are small.
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
ULP = 2.0 ** -7


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
@pytest.mark.parametrize("n", [4, 2, 24])
@pytest.mark.parametrize("m", [1, 4, 16])
def test_packed_entries_take_n_off_the_vector_width(dev, m, n):
    """The packed K1 and K2 entries at an N that is not a multiple of
    16 (mLSTM's gates: N = heads = 4; the reduced config's 2): the
    planes' N padded with zero columns on the kernel, the output cut
    back, bit for bit the plain versions, one launch each."""
    k = 1024
    g = torch.Generator(device=dev).manual_seed(m * n)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int32)
    planes = bitslice.slice_planes_signed(wq, 8, 2).to(torch.int8)
    x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                      dtype=torch.int32).to(torch.int8)
    scale = torch.rand((m, 1), generator=g, device=dev)
    one = wq.to(torch.int8)[None]
    registry.reset_launches()
    got1 = mvm.bitslice_mvm_planes_scaled(x, planes, scale)
    got2 = mvm.bitslice_mvm_planes(x, one, bits_per_slice=8)
    assert registry.LAUNCHES == {"bitslice_mvm_scaled": 1,
                                 "bitslice_mvm": 1}
    assert got1.shape == got2.shape == (m, n)
    assert torch.equal(got1, mvm.bitslice_mvm_planes_scaled(
        x, planes, scale, backend="torch"))
    assert torch.equal(got2, mvm.bitslice_mvm_planes(
        x, one, bits_per_slice=8, backend="torch"))


@pytest.mark.cuda
def test_bitslice_mvm_rejects_what_it_cannot_take(dev):
    x = torch.zeros((2, 64), dtype=torch.int8, device=dev)
    with pytest.raises(registry.KernelTileError):      # over MAX_SLICES
        mvm.bitslice_mvm_planes(x, torch.zeros((5, 64, 32), dtype=torch.int8,
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
@pytest.mark.parametrize("s", [1, 16])
def test_paged_attention_duplicate_trash_cells_take_the_last_row(dev, s):
    """Inactive rows (all-trash tables) at depths that meet in one trash
    cell, and a row writing past its table width: the kernel's pools
    equal the plain version's bit for bit, trash block included, the
    last row's value in each shared cell, in every call."""
    rng = np.random.default_rng(40 + s)
    b, kvh, grp, hd, bs, w = 6, 16, 1, 128, 16, 3
    nb = 1 + 2 * w

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, torch.bfloat16)

    table = torch.zeros((b, w), dtype=torch.int32, device=dev)
    table[0] = torch.arange(1, w + 1)
    table[3] = torch.arange(w + 1, 2 * w + 1)
    ci = torch.tensor([7, 3, 19, w * bs - 2 if s > 1 else 9, 35, 51],
                      dtype=torch.int32, device=dev)
    args = [rnd(b, s, kvh, grp, hd), rnd(b, s, kvh, hd), rnd(b, s, kvh, hd),
            rnd(nb, bs, kvh, hd), rnd(nb, bs, kvh, hd), table,
            table.clone(), ci]
    rk, rv, _ = pa.paged_attention(*args, kv_len=w * bs, backend="torch")
    assert torch.equal(rk[0, 3], args[1][5, 0])       # row 5 is the last
    for _ in range(3):
        kp, vp = args[3].clone(), args[4].clone()
        pa.paged_attention(*args[:3], kp, vp, *args[5:], kv_len=w * bs)
        torch.cuda.synchronize()
        assert torch.equal(kp, rk) and torch.equal(vp, rv)


# (K, N): K within one tile (no split), K not a multiple of the 64-row
# tile or of the 16-byte x row (x padded; split over K from 1000 on),
# the narrow projections (split over K in a cluster of 8 and of 16),
# and a wide N where the output tiles leave little room to split
MVM_PLAN_SHAPES = [(64, 16), (300, 48), (299, 32), (1000, 48), (2048, 256),
                   (11008, 2048), (2048, 12288)]


def _mvm_args(dev, m, k, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int32)
    planes = bitslice.slice_planes_signed(wq, 8, 2).to(torch.int8)
    x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                      dtype=torch.int32).to(torch.int8)
    scale = torch.rand((m, 1), generator=g, device=dev)
    return x, planes, wq.to(torch.int8)[None], scale


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", MVM_PLAN_SHAPES)
@pytest.mark.parametrize("m", [1, 4, 7, 16, 33])
def test_bitslice_mvm_launch_plans_bit_exact(dev, m, k, n):
    """Every row tile (1 and 4 on __dp4a, 8 and 16 on the tensor cores)
    and split-K plan, bit for bit, and the same bits on a second call
    (the split parts meet in a fixed order)."""
    x, planes, one, scale = _mvm_args(dev, m, k, n, 7 * m + k + n)
    plan = mvm.mvm_plan(m, k, n, 4, registry.device_props(dev.index))
    registry.reset_launches()
    first = None
    for _ in range(2):
        got = (mvm.bitslice_mvm_planes_scaled(x, planes, scale),
               mvm.bitslice_mvm_planes(x, one, bits_per_slice=8),
               mvm.bitslice_mvm_planes(x, planes))
        torch.cuda.synchronize()
        assert torch.equal(got[0], mvm.bitslice_mvm_planes_scaled(
            x, planes, scale, backend="torch"))
        want = mvm.bitslice_mvm_planes(x, one, bits_per_slice=8,
                                       backend="torch")
        assert torch.equal(got[1], want) and torch.equal(got[2], want)
        if first is not None:
            assert all(torch.equal(a, b) for a, b in zip(first, got))
        first = got
    assert registry.LAUNCHES == {"bitslice_mvm_scaled": 2,
                                 "bitslice_mvm": 4}
    # split over K wherever K has two splits' worth of tiles and the
    # output tiles leave a wave of CTAs unfilled (on an H100 SXM: K from
    # 1000 on, but not M=33 at N=12288)
    assert (plan.splits > 1) == (
        plan.ktiles >= 2 * mvm.MIN_SPLIT_KTILES and plan.row_tiles
        * plan.col_tiles * 2 <= mvm.CTAS_PER_SM
        * registry.device_props(dev.index).sms)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bps", [
    (5, 27, 10, 2), (300, 144, 10, 2), (1024, 64, 10, 2), (33, 576, 64, 2),
    (17, 27, 10, 8), ((1 << 20) + 16, 144, 16, 2),
    ((1 << 20) + 16, 27, 10, 8)])
def test_unpacked_bitslice_mvm_bit_exact(dev, m, k, n, bps):
    """The unpacked entry (planes sliced per call, N padded to 16 and
    cut back) bit for bit against its plain version, in one launch
    each: at N=10 (ResNet-20's classifier), and past 16 x 65535 rows,
    where the row tiles outnumber CUDA's gridDim.z limit."""
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                      dtype=torch.int32)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int32)
    plan = mvm.mvm_plan(m, k, -(-n // mvm.VEC) * mvm.VEC, 4 if bps == 2
                        else 1, registry.device_props(dev.index))
    assert plan.grid_rows == min(plan.row_tiles, mvm.MAX_GRID_Z)
    registry.reset_launches()
    got = mvm.bitslice_mvm(x, wq, weight_bits=8, bits_per_slice=bps)
    again = mvm.bitslice_mvm(x, wq, weight_bits=8, bits_per_slice=bps)
    torch.cuda.synchronize()
    assert registry.LAUNCHES == {"bitslice_mvm": 2}
    want = mvm.bitslice_mvm(x, wq, weight_bits=8, bits_per_slice=bps,
                            backend="torch")
    assert got.shape == (m, n) and got.dtype == torch.int32
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["pum", "int8"])
def test_resnet20_kernel_forward_equals_torch_backend(dev, mode):
    """ResNet-20 (width 8, 4 images) through K2 on the card: 22
    launches a forward, logits bit-equal to the torch backend's (every
    MVM is integer arithmetic on equal inputs, the float ops the same
    ops on the same device)."""
    from repro_torch.apps import resnet_app
    from repro_torch.config import PUMConfig
    from repro_torch.models import resnet
    gen = torch.Generator(dev).manual_seed(0)
    params = resnet.resnet20_init(gen, width=8, device=dev)
    x, _ = resnet_app.synthetic_images(gen, 4, device=dev)
    cfg = PUMConfig(mode=mode)
    registry.reset_launches()
    got = resnet.resnet20_apply(params, x, cfg)
    torch.cuda.synchronize()
    assert registry.LAUNCHES == {"bitslice_mvm": 22}
    with registry.use_backend("torch"):
        want = resnet.resnet20_apply(params, x, cfg)
    assert got.shape == (4, 10) and torch.isfinite(got).all()
    assert torch.equal(got, want)


def _attn_args(dev, *, s, q_dtype, hd, t, seed, bs=16, b=4, kvh=2, grp=8):
    """Rows 0 and 1 active, row 2 inactive (an all-trash table), row 3
    writing past its table width; a window of T keys, blocks shuffled."""
    rng = np.random.default_rng(seed)
    w = -(-max(t, s + 8) // bs) + 1
    nb = 1 + b * w

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    table = torch.from_numpy(rng.permutation(nb - 1).astype(np.int32) + 1)
    table = table.to(dev).reshape(b, w)
    table[2] = 0
    ci = torch.tensor([min(t, w * bs) - s, max(0, t // 2 - s), 3,
                       w * bs - s // 2], dtype=torch.int32, device=dev)
    return [rnd(b, s, kvh, grp, hd, dtype=q_dtype),
            rnd(b, s, kvh, hd, dtype=q_dtype),
            rnd(b, s, kvh, hd, dtype=q_dtype),
            rnd(nb, bs, kvh, hd), rnd(nb, bs, kvh, hd), table,
            table.clone(), ci]


ACTIVE = [0, 1, 3]


def _assert_within_one_ulp_of_v(got, args, t, rows, softcap=0.0):
    """max|got - plain| over ``rows`` is at most the plain version's
    change when every V cell, stored and new, moves up one bf16 ulp."""
    want = pa.paged_attention(*args, kv_len=t, softcap=softcap,
                              backend="torch")[2][rows].float()
    nudged = list(args)
    for i in (2, 4):
        nudged[i] = (args[i].float() * (1 + ULP)).to(args[i].dtype)
    moved = pa.paged_attention(*nudged, kv_len=t, softcap=softcap,
                               backend="torch")[2][rows].float()
    err = (got[rows].float() - want).abs().max().item()
    bound = (moved - want).abs().max().item()
    assert 0 < bound and err <= bound, (err, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("s,t,hd,softcap,q_dtype", [
    (1, 81, 128, 0.0, torch.bfloat16),      # one CTA per (row, head)
    (1, 128, 128, 0.0, torch.bfloat16),
    (1, 129, 128, 0.0, torch.bfloat16),     # a cluster of two
    (1, 1024, 128, 0.0, torch.bfloat16),    # a cluster of eight
    (16, 81, 128, 0.0, torch.bfloat16),     # 16 query groups
    (16, 1000, 128, 0.0, torch.bfloat16),
    (64, 200, 128, 0.0, torch.bfloat16),
    (64, 1000, 128, 0.0, torch.bfloat16),
    (1, 1000, 128, 30.0, torch.bfloat16),   # softcap: every key visited
    (16, 300, 128, 30.0, torch.bfloat16),
    (1, 1000, 128, 0.0, torch.float32),     # f32 queries
    (16, 120, 128, 0.0, torch.float32),
    (4, 150, 256, 0.0, torch.bfloat16),     # 8 dims per lane
    (64, 700, 256, 30.0, torch.float32),
    (1, 3000, 64, 0.0, torch.bfloat16),     # several tiles per CTA
    (64, 90, 64, 0.0, torch.bfloat16),
    (1, 70, 32, 0.0, torch.bfloat16),       # 1 dim per lane
    (3, 500, 96, 0.0, torch.float32)])      # 3 dims per lane
def test_paged_attention_kernel_launch_plans(dev, s, t, hd, softcap,
                                             q_dtype):
    """Every kind of plan against the plain version, and the same bits
    on a second call (the window's parts meet in a fixed order)."""
    args = _attn_args(dev, s=s, q_dtype=q_dtype, hd=hd, t=t,
                      seed=s * 1000 + t + hd)
    rk, rv, ro = pa.paged_attention(*args, kv_len=t, softcap=softcap,
                                    backend="torch")
    registry.reset_launches()
    kk, kv, ko = pa.paged_attention(*args, kv_len=t, softcap=softcap)
    torch.cuda.synchronize()
    assert registry.LAUNCHES == {"paged_attention": 1}
    assert torch.equal(kk[1:], rk[1:]) and torch.equal(kv[1:], rv[1:])
    assert torch.isfinite(ko[ACTIVE].float()).all()
    torch.testing.assert_close(ko[ACTIVE].float(), ro[ACTIVE].float(),
                               **BF16_TOL)
    _assert_within_one_ulp_of_v(ko, args, t, ACTIVE, softcap)
    _, _, again = pa.paged_attention(*args, kv_len=t, softcap=softcap)
    torch.cuda.synchronize()
    assert torch.equal(again[ACTIVE], ko[ACTIVE])


@pytest.mark.cuda
@pytest.mark.parametrize("kvh,grp,hd", [(8, 12, 128), (2, 16, 128),
                                        (36, 1, 64)])
@pytest.mark.parametrize("s,t", [(1, 81), (4, 81), (16, 81), (1, 1024),
                                 (16, 1024)])
def test_paged_attention_at_wide_groups(dev, kvh, grp, hd, s, t):
    """command-r-plus-104b's G = 12 and glm4-9b's G = 16, where one
    position's heads span two CTAs of 8 queries (at G = 12 a CTA may
    hold the tail of one position and the head of the next), and
    minicpm-2b's 36 KV heads at G = 1, hd 64: the pools bit for bit,
    the outputs within tolerance, two calls bit-equal."""
    args = _attn_args(dev, s=s, q_dtype=torch.bfloat16, hd=hd, t=t,
                      seed=grp * 100 + s + t, kvh=kvh, grp=grp)
    rk, rv, ro = pa.paged_attention(*args, kv_len=t, backend="torch")
    registry.reset_launches()
    kk, kv, ko = pa.paged_attention(*args, kv_len=t)
    torch.cuda.synchronize()
    assert registry.LAUNCHES == {"paged_attention": 1}
    assert torch.equal(kk, rk) and torch.equal(kv, rv)
    assert torch.isfinite(ko[ACTIVE].float()).all()
    torch.testing.assert_close(ko[ACTIVE].float(), ro[ACTIVE].float(),
                               **BF16_TOL)
    _assert_within_one_ulp_of_v(ko, args, t, ACTIVE)
    _, _, again = pa.paged_attention(*args, kv_len=t)
    torch.cuda.synchronize()
    assert torch.equal(again[ACTIVE], ko[ACTIVE])


@pytest.mark.cuda
@pytest.mark.parametrize("s,t", [(1, 81), (1, 1000), (16, 81)])
def test_paged_attention_attends_the_cells_it_stores(dev, s, t):
    """Each row's newest key is its query scaled up, so its last query
    puts nearly all weight on the cell this very call stores: a read of
    the pool before the store would return the old row."""
    args = _attn_args(dev, s=s, q_dtype=torch.bfloat16, hd=128, t=t,
                      seed=3)
    q, k_new = args[0], args[1]
    k_new[:, -1] = (8.0 * q[:, -1, :, 0]).to(k_new.dtype)
    q[:, -1] = q[:, -1, :, :1]              # every head of the last query
    rk, rv, ro = pa.paged_attention(*args, kv_len=t, backend="torch")
    kk, kv, ko = pa.paged_attention(*args, kv_len=t)
    torch.cuda.synchronize()
    rows = [0, 1]                           # their last key is in the window
    assert torch.equal(kk[1:], rk[1:]) and torch.equal(kv[1:], rv[1:])
    torch.testing.assert_close(ko[rows].float(), ro[rows].float(),
                               **BF16_TOL)
    _assert_within_one_ulp_of_v(ko, args, t, rows)
    last = ro[rows, -1].float()
    assert torch.allclose(last, args[2][rows, -1, :, None].float()
                          .expand_as(last), atol=0.1, rtol=0.1)


@pytest.mark.cuda
def test_kernels_on_two_streams_at_once(dev):
    """K1 split over K and K3 split over a window, each launched on two
    streams in turn, 20 times, with different inputs on each stream:
    nothing one stream's launch leaves behind reaches the other's, and
    every output equals its plain version."""
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    mvm_in = [_mvm_args(dev, 4, 2048, 256, seed) for seed in (1, 2)]
    attn_in = [_attn_args(dev, s=1, q_dtype=torch.bfloat16, hd=128, t=1024,
                          seed=seed) for seed in (1, 2)]
    assert mvm.mvm_plan(4, 2048, 256, 4,
                        registry.device_props(dev.index)).splits > 1
    want_mvm = [mvm.bitslice_mvm_planes_scaled(x, p, sc, backend="torch")
                for x, p, _, sc in mvm_in]
    want_attn = [pa.paged_attention(*a, kv_len=1024, backend="torch")[2]
                 for a in attn_in]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                x, p, _, sc = mvm_in[i]
                outs[i].append((mvm.bitslice_mvm_planes_scaled(x, p, sc),
                                pa.paged_attention(*attn_in[i],
                                                   kv_len=1024)[2]))
    torch.cuda.synchronize()
    for i in range(2):
        for got_mvm, got_attn in outs[i]:
            assert torch.equal(got_mvm, want_mvm[i])
            torch.testing.assert_close(got_attn[ACTIVE].float(),
                                       want_attn[i][ACTIVE].float(),
                                       **BF16_TOL)
            assert torch.equal(got_attn[ACTIVE], outs[i][0][1][ACTIVE])


@pytest.mark.cuda
# K = 512 is the longest K the tensor-core kernel takes; K = 1000 runs
# the long-K kernel; K = 200 and N = 129 take the byte copies; K = 48
# leaves half of the mma's last 32-byte K step to the zero padding
@pytest.mark.parametrize("k,n", [(128, 128), (200, 129), (64, 32),
                                 (48, 16), (512, 48), (1000, 129)])
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
    assert torch.equal(gf2.gf2_mvm(x, a), got)        # two calls bit-equal
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


def _aes_matrix(i):
    from repro_torch.apps import aes_app
    return torch.as_tensor(aes_app._linear_matrices()[i], dtype=torch.int8)


@pytest.mark.cuda
# the AES matrices (ShiftRows∘MixColumns, ShiftRows, InvMixColumns) and
# one of any int8 values, of which only each entry's low bit counts
@pytest.mark.parametrize("mat", [0, 1, 2, "int8"])
@pytest.mark.parametrize("m", [1, 7, 130, 4096])
def test_gf2_mvm_packed_kernel_bit_exact(dev, m, mat):
    rng = np.random.default_rng(m + 17 * len(str(mat)))
    a = (torch.from_numpy(rng.integers(-128, 128, size=(128, 128)).astype(
        np.int8)) if mat == "int8" else _aes_matrix(mat)).to(dev)
    s = torch.from_numpy(rng.integers(0, 256, size=(m, 16)).astype(
        np.uint8)).to(dev)
    registry.reset_launches()
    got = gf2.gf2_mvm_packed(s, a)
    want = gf2.gf2_mvm_packed(s, a, backend="torch")
    torch.cuda.synchronize()
    assert registry.LAUNCHES == {"gf2_mvm_packed": 1}
    assert got.dtype == torch.uint8 and got.shape == (m, 16)
    assert torch.equal(got, want)
    assert torch.equal(gf2.gf2_mvm_packed(s, a), got)   # two calls bit-equal
    # leading dims, and rows that do not start on a 16-byte boundary
    base = torch.empty(m * 16 + 1, dtype=torch.uint8, device=dev)
    base[1:] = s.reshape(-1)
    odd = base[1:].view(m, 16)
    assert odd.data_ptr() % 16
    assert torch.equal(gf2.gf2_mvm_packed(odd, a), want)
    assert torch.equal(gf2.gf2_mvm_packed(s.reshape(1, m, 16), a)[0], want)


@pytest.mark.cuda
def test_gf2_mvm_packed_rejects_what_it_cannot_take(dev):
    s = torch.zeros((4, 16), dtype=torch.uint8, device=dev)
    a = torch.zeros((128, 128), dtype=torch.int8, device=dev)
    with pytest.raises(registry.KernelTileError, match="uint8"):
        gf2.gf2_mvm_packed(s.to(torch.int8), a)
    with pytest.raises(registry.KernelTileError, match="int8"):
        gf2.gf2_mvm_packed(s, a.to(torch.int32))
    with pytest.raises(registry.KernelTileError, match="128x128"):
        gf2.gf2_mvm_packed(s, a[:64])
    with pytest.raises(registry.KernelTileError, match="128x128"):
        gf2.gf2_mvm_packed(s[:, :8], a)
    with pytest.raises(registry.KernelTileError, match="on"):
        gf2.gf2_mvm_packed(s, a.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("klen", [16, 24, 32])
def test_aes_rounds_launch_the_state_byte_entry(dev, klen):
    """With ``use_kernel`` the bulk cipher launches K4's state-byte entry
    once a round (Nr to encrypt, Nr - 1 to decrypt) and never its int8
    entry; both equal the numpy oracle."""
    from repro_torch.apps import aes_app
    rng = np.random.default_rng(klen)
    pt = rng.integers(0, 256, size=(1000, 16), dtype=np.uint8)
    key = rng.integers(0, 256, size=(klen,), dtype=np.uint8)
    nr = {16: 10, 24: 12, 32: 14}[klen]
    registry.reset_launches()
    ct = aes_app.aes_encrypt(pt, key, use_kernel=True, device=dev)
    assert registry.LAUNCHES == {"gf2_mvm_packed": nr}
    back = aes_app.aes_decrypt(ct, key, use_kernel=True, device=dev)
    assert registry.LAUNCHES == {"gf2_mvm_packed": 2 * nr - 1}
    want = aes_app.aes_encrypt_np(pt, key)
    np.testing.assert_array_equal(ct.cpu().numpy(), want)
    np.testing.assert_array_equal(back.cpu().numpy(), pt)


# ---------------------------------------------------------------------------
# The compiled serving step (``serve.compiled``): graphs against eager
# ---------------------------------------------------------------------------

def _served(dev, mode):
    """The reduced Qwen2.5-3B widened to a head dim of 64, which K3 takes
    (the reduced one has 16), prepacked for ``mode``."""
    from repro_torch.config import PUMConfig
    from repro_torch.configs import qwen2_5_3b
    from repro_torch.models import lm
    cfg = qwen2_5_3b.reduced().replace(
        d_model=256, num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512,
        pum=PUMConfig(mode=mode))
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, lm.prepack_for_serving(lm.init_params(cfg, gen, device=dev),
                                       cfg)


def _sched(dev, cfg, params, graphs):
    from repro_torch.serve import ContinuousBatchingScheduler
    return ContinuousBatchingScheduler(cfg, params, num_slots=2, max_len=32,
                                       kv_block_size=8, chunked_prefill=True,
                                       device=dev, cuda_graphs=graphs)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8", "pum"])
def test_graph_and_eager_steps_bit_equal(dev, mode):
    """One prefill chunk then 3 decode steps, with graphs and eagerly:
    the same kernels on the same inputs give the same logits bit for
    bit (the chunk's, and the decoding row's of each step) and tokens."""
    from repro_torch.serve import Request
    cfg, params = _served(dev, mode)
    runs = {}
    for graphs in (True, False):
        sched = _sched(dev, cfg, params, graphs)
        sched.start_request(Request(list(range(1, 9)), max_tokens=4, rid=0))
        events, logits = [], []
        for step in range(3):
            events += sched.tick(step).events
            last = sched.last_logits()
            logits += ([last[8].clone()] if step == 0 else []) \
                + [last["decode"][0].clone()]
        assert sched.step_programs() == {"decode": 1, "chunk": {8: 1}}
        assert sched.graphs_captured()[0] == (2 if graphs else 0)
        runs[graphs] = events, logits
    assert runs[True][0] == runs[False][0]
    assert len(runs[True][0]) == 4
    for a, b in zip(runs[True][1], runs[False][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_graph_replays_count_the_captured_launches(dev):
    """A replay counts what its capture recorded: N replays of the
    decode graph add N times its launches, one serving run counts what
    the same run counts eagerly, and warm-up launches count nowhere."""
    from repro_torch.serve import Request
    cfg, params = _served(dev, "pum")
    reqs = [Request(list(range(1, n + 1)), max_tokens=5, rid=i)
            for i, n in enumerate([8, 12, 3])]
    counts = {}
    for graphs in (True, False):
        sched = _sched(dev, cfg, params, graphs)
        registry.reset_launches()
        sched.run(reqs)
        steps = sched.decode_steps + sched.prefill_chunks
        counts[graphs] = dict(registry.LAUNCHES)
        assert counts[graphs] == {
            "bitslice_mvm_scaled": 7 * cfg.num_layers * steps,
            "paged_attention": cfg.num_layers * steps}
    assert counts[True] == counts[False]
    prog = _sched(dev, cfg, params, True).program("decode")
    assert prog.launches == {"bitslice_mvm_scaled": 7 * cfg.num_layers,
                             "paged_attention": cfg.num_layers}
    prog.stage(*[np.zeros(t.shape, np.int32) for t in prog.inputs])
    registry.reset_launches()
    for _ in range(5):
        prog.launch()
    torch.cuda.synchronize()
    assert registry.LAUNCHES == {k: 5 * v for k, v in prog.launches.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "pum"])
def test_reset_keeps_the_graphs_valid(dev, mode):
    """``_reset`` zeroes the pools in place, so the captured graphs stay
    bound to live memory: a second run after it builds nothing and gives
    the first run's completions, equal to the solo oracle's."""
    from repro_torch.serve import oracle_completion, synthetic_workload
    cfg, params = _served(dev, mode)
    sched = _sched(dev, cfg, params, True)
    reqs = synthetic_workload(5, cfg.vocab_size, min_prompt=3,
                              max_prompt=20, max_new=6, seed=4)
    first = sched.run(reqs)
    progs = sched.step_programs()
    pools = [t.data_ptr() for st in sched.states for t in st.values()]
    sched._reset()
    assert all(not t.any() for st in sched.states for t in st.values())
    assert [t.data_ptr() for st in sched.states for t in st.values()] == pools
    second = sched.run(reqs)
    assert sched.step_programs() == progs
    for req in reqs:
        assert second[req.rid].tokens == first[req.rid].tokens \
            == oracle_completion(sched.engine, req)


# ---------------------------------------------------------------------------
# Sampling: keyed draws on the card and the sampled serving step
# ---------------------------------------------------------------------------

# CUDA's logf and the CPU's log may differ by an ulp: Gumbel values
# within 2 ulps of max(|g|, 1), and a draw may differ only where the
# CPU's top-2 score margin is within 1e-5 (far above that difference)
GUMBEL_ULPS = 2
NEAR_TIE = 1e-5


@pytest.mark.cuda
def test_card_draws_equal_cpu_draws(dev):
    from repro_torch.serve import prng
    kat = prng.threefry2x32(*(
        torch.from_numpy(np.array([w], np.uint32).view(np.int32)).to(dev)
        for w in (0x13198a2e, 0x03707344, 0x243f6a88, 0x85a308d3)))
    assert [int(t.cpu().numpy().view(np.uint32)[0]) for t in kat] == \
        [0xc4923a9c, 0x483df7a0]
    keys = torch.stack([prng.prng_key(s) for s in (0, 1, 2**31 - 1, 77)])
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 4099)).astype(np.float32))
    for key in (keys[1], keys):                 # one key, a key a row
        shape = (4, 4099) if key.ndim == 1 else (4099,)
        on = {f.__name__: f(key.to(dev), shape).cpu()
              for f in (prng.random_bits, prng.uniform, prng.gumbel)}
        off = {f.__name__: f(key, shape)
               for f in (prng.random_bits, prng.uniform, prng.gumbel)}
        assert torch.equal(on["random_bits"], off["random_bits"])
        assert torch.equal(on["uniform"], off["uniform"])
        g, want = on["gumbel"].numpy(), off["gumbel"].numpy()
        ulps = np.abs(g - want) / np.spacing(
            np.maximum(np.abs(want), 1).astype(np.float32))
        assert ulps.max() <= GUMBEL_ULPS
        got = prng.categorical(key.to(dev), logits.to(dev)).cpu()
        scores = np.sort(want + logits.numpy(), axis=-1)
        near = torch.from_numpy(scores[:, -1] - scores[:, -2] <= NEAR_TIE)
        assert torch.equal(got[~near],
                           prng.categorical(key, logits)[~near])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "pum"])
def test_sampled_graph_and_eager_equal(dev, mode):
    """A trace at temperatures 0, 0.7 and 1.0 with graphs and eagerly:
    the same tokens, each equal to its solo oracle on the card, and one
    decode program."""
    from repro_torch.serve import oracle_completion, synthetic_workload
    cfg, params = _served(dev, mode)
    reqs = synthetic_workload(5, cfg.vocab_size, min_prompt=3,
                              max_prompt=20, max_new=6,
                              temperature_choices=(0.0, 0.7, 1.0), seed=6)
    assert {r.temperature for r in reqs} == {0.0, 0.7, 1.0}
    out = {}
    for graphs in (True, False):
        sched = _sched(dev, cfg, params, graphs)
        out[graphs] = {r: c.tokens for r, c in sched.run(reqs).items()}
        assert sched.step_programs()["decode"] == 1
    assert out[True] == out[False]
    for req in reqs:
        assert out[True][req.rid] == oracle_completion(sched.engine, req)


# ---------------------------------------------------------------------------
# Contiguous windows and the compiled token loop
# ---------------------------------------------------------------------------

MVM_OF = {"int8": "bitslice_mvm", "pum": "bitslice_mvm_scaled"}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "pum"])
def test_contiguous_scheduler_equals_solo_loop_on_the_card(dev, mode):
    """Contiguous windows attend through the solo loop's composition, so
    on the card every completion equals its solo ``generate_loop`` (the
    cuda backend), graphs and eager alike.  Staggered arrivals build
    prefill programs while other slots decode: each warms up on its
    admission's own inputs and moves no other row.  No K3 launch."""
    from repro_torch.serve import (ContinuousBatchingScheduler,
                                   oracle_completion, synthetic_workload)
    cfg, params = _served(dev, mode)
    reqs = synthetic_workload(6, cfg.vocab_size, min_prompt=3,
                              max_prompt=20, max_new=6,
                              mean_interarrival=1.5,
                              temperature_choices=(0.0, 0.7), seed=7)
    out = {}
    for graphs in (True, False):
        sched = ContinuousBatchingScheduler(
            cfg, params, num_slots=2, max_len=32, kv_block_size=0,
            device=dev, cuda_graphs=graphs)
        registry.reset_launches()
        out[graphs] = {r: c.tokens for r, c in sched.run(reqs).items()}
        steps = sched.decode_steps + sched.prefill_chunks
        assert registry.LAUNCHES == {MVM_OF[mode]: 7 * cfg.num_layers
                                     * steps}
        assert sched.step_programs()["decode"] == 1
    assert out[True] == out[False]
    for req in reqs:
        assert out[True][req.rid] == oracle_completion(sched.engine, req)


@pytest.mark.cuda
def test_long_prompt_online_softmax_on_the_card(dev, monkeypatch):
    """Blocks of 8: a 20-token prompt prefills through the online
    softmax, in the scheduler's prefill graph and in the solo loop, with
    the same tokens."""
    from repro_torch.models import attention
    from repro_torch.serve import (ContinuousBatchingScheduler, Request,
                                   oracle_completion)
    monkeypatch.setattr(attention, "CHUNK_Q", 8)
    monkeypatch.setattr(attention, "CHUNK_K", 8)
    cfg, params = _served(dev, "pum")
    sched = ContinuousBatchingScheduler(cfg, params, num_slots=2,
                                        max_len=32, kv_block_size=0,
                                        device=dev)
    reqs = [Request(list(range(3, 23)), 6, temperature=0.7, seed=1, rid=0),
            Request(list(range(40, 45)), 6, rid=1)]
    out = sched.run(reqs)
    for req in reqs:
        assert out[req.rid].tokens == oracle_completion(sched.engine, req)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "pum"])
def test_generate_graph_equals_loop_on_the_card(dev, mode):
    """``generate`` replays a prefill graph and one decode-step graph
    per token: the loop's tokens, eager dispatch's tokens, 7 MVM
    launches a layer a forward, one build per (batch, prompt length,
    temperature) whatever the step count."""
    from repro_torch.serve import ServeEngine
    cfg, params = _served(dev, mode)
    eng = ServeEngine(cfg, params, max_len=32, device=dev)
    eager = ServeEngine(cfg, params, max_len=32, device=dev,
                        cuda_graphs=False)
    prompt = torch.randint(0, cfg.vocab_size, (3, 9), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(5))
    prompt = prompt.to(dev)
    for temperature in (0.0, 0.8):
        registry.reset_launches()
        got = eng.generate(prompt, 6, temperature=temperature, seed=2)
        torch.cuda.synchronize()
        assert registry.LAUNCHES == {MVM_OF[mode]: 7 * cfg.num_layers * 6}
        assert torch.equal(got, eng.generate_loop(prompt, 6, temperature,
                                                  2))
        assert torch.equal(got, eager.generate(prompt, 6, temperature, 2))
        assert torch.equal(got, eng.generate(prompt, 6, temperature, 2))
        assert torch.equal(got[:, :12], eng.generate(prompt, 3,
                                                     temperature, 2))
    assert eng.graphs_captured()[0] == 4
    assert eng.scan_programs() == {(3, 9, 0.0): 1, (3, 9, 0.8): 1}


def _twice(monkeypatch, tensors):
    """Every call of every compiled step runs twice in a row, and the
    second must leave the state (``tensors()``) and the outputs that the
    first left: the idempotence rule of ``CompiledStep``, on which its
    warm-up on real inputs rests."""
    from repro_torch.serve.compiled import CompiledStep
    launch = CompiledStep.launch

    def twice(self):
        launch(self)
        first = [t.clone() for t in tensors()] + [self.ints.clone()]
        launch(self)
        again = tensors() + [self.ints]
        assert all(torch.equal(a, b) for a, b in zip(first, again))

    monkeypatch.setattr(CompiledStep, "launch", twice)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["paged", "contiguous", "generate"])
def test_every_step_is_idempotent_on_its_inputs(dev, kind, monkeypatch):
    """Each step kind (paged decode and chunk, contiguous decode and
    admission prefill, ``generate``'s prefill and decode step) run
    twice on the same inputs leaves what one run leaves, and a graph run
    in which every call repeats so gives the tokens and the final state
    of an eager run in which each call runs once."""
    from repro_torch.serve import (ContinuousBatchingScheduler,
                                   ServeEngine, synthetic_workload)
    cfg, params = _served(dev, "pum")
    reqs = synthetic_workload(5, cfg.vocab_size, min_prompt=3,
                              max_prompt=20, max_new=6,
                              temperature_choices=(0.0, 0.7), seed=4)
    prompt = torch.randint(0, cfg.vocab_size, (3, 9), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(5))
    runs = {}
    for graphs in (False, True):
        if kind == "generate":
            eng = ServeEngine(cfg, params, max_len=32, device=dev,
                              cuda_graphs=graphs)

            def tensors():
                return [t for *_, window in eng._scans.values()
                        for st in window for t in st.values()]
        else:
            sched = ContinuousBatchingScheduler(
                cfg, params, num_slots=2, max_len=32,
                kv_block_size=8 if kind == "paged" else 0,
                chunked_prefill=kind == "paged", device=dev,
                cuda_graphs=graphs)

            def tensors():
                return [t for st in sched.states + sched._one
                        for t in st.values()]
        if graphs:
            _twice(monkeypatch, tensors)
        if kind == "generate":
            toks = [eng.generate(prompt.to(dev), 6, temperature=t, seed=2)
                    for t in (0.0, 0.8)]
        else:
            toks = {r: c.tokens for r, c in sched.run(reqs).items()}
        torch.cuda.synchronize()
        runs[graphs] = toks, [t.clone() for t in tensors()]
    if kind == "generate":
        assert all(torch.equal(a, b) for a, b in zip(runs[True][0],
                                                     runs[False][0]))
    else:
        assert runs[True][0] == runs[False][0]
    assert len(runs[True][1]) == len(runs[False][1])
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1],
                                                 runs[False][1]))


# ---------------------------------------------------------------------------
# The xLSTM family: recurrent steps under the compiled step's rule
# ---------------------------------------------------------------------------

def _xlstm(dev, mode):
    """The reduced xLSTM-350M (period 2: sLSTM and mLSTM), prepacked."""
    from repro_torch.config import PUMConfig
    from repro_torch.configs import xlstm_350m
    from repro_torch.models import lm
    cfg = xlstm_350m.reduced().replace(pum=PUMConfig(mode=mode))
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, lm.prepack_for_serving(lm.init_params(cfg, gen, device=dev),
                                       cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["paged", "contiguous", "static"])
def test_recurrent_steps_advance_once(dev, kind):
    """Each recurrent step kind (paged chunk and decode, contiguous
    admission prefill and decode, the static batch's prefill and decode
    step) built and called once, as a graph (warm-up, capture, replay),
    leaves the recurrent state that one eager call leaves, bit for bit,
    after every call; and the tokens are equal."""
    _advance_once(dev, *_xlstm(dev, "pum"), kind)


def _advance_once(dev, cfg, params, kind):
    """``test_recurrent_steps_advance_once`` on ``cfg``'s stack."""
    from repro_torch.models import lm
    from repro_torch.serve import (ContinuousBatchingScheduler, Request,
                                   ServeEngine)
    runs = {}
    for graphs in (True, False):
        snaps, toks = [], []
        if kind == "static":
            eng = ServeEngine(cfg, params, max_len=32, device=dev,
                              cuda_graphs=graphs)
            prompt = torch.randint(0, cfg.vocab_size, (3, 9),
                                   dtype=torch.int32,
                                   generator=torch.Generator().manual_seed(5)
                                   ).to(dev)
            for steps in (1, 6):       # prefill alone (decode built), both
                toks.append(eng.generate(prompt, steps, temperature=0.7,
                                         seed=2).tolist())
                window = eng._scans[(3, 9, 0.7)][2]
                snaps.append([t.clone() for t in
                              lm.recurrent_tensors(cfg, window)])
            assert eng.graphs_captured()[0] == (2 if graphs else 0)
        else:
            paged = kind == "paged"
            sched = ContinuousBatchingScheduler(
                cfg, params, num_slots=2, max_len=32,
                kv_block_size=4 if paged else 0, chunked_prefill=paged,
                device=dev, cuda_graphs=graphs)
            reqs = [Request(list(range(1, 7)), 4, rid=0),
                    Request([7, 8, 9], 3, temperature=0.8, seed=3, rid=1)]
            for req in reqs:
                sched.start_request(req)
                snaps.append([t.clone() for t in
                              lm.recurrent_tensors(cfg, sched.states)])
            for step in range(6):
                toks += sched.tick(step).events
                snaps.append([t.clone() for t in
                              lm.recurrent_tensors(cfg, sched.states)])
            built = sched.graphs_captured()[0]
            assert built == (len(sched._programs) if graphs else 0)
        torch.cuda.synchronize()
        runs[graphs] = toks, snaps
    assert runs[True][0] == runs[False][0] and runs[True][0]
    for a, b in zip(runs[True][1], runs[False][1]):
        assert len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# The hybrid family: the Mamba mixer on the card
# ---------------------------------------------------------------------------

def _hybrid(dev, mode):
    """The reduced Jamba-v0.1 (8 layers: 7 Mamba, 1 attention, 4 MoE
    FFNs) widened to a head dim of 64, which K3 takes, prepacked."""
    from repro_torch.config import PUMConfig
    from repro_torch.configs import jamba_v0_1_52b
    from repro_torch.models import lm
    cfg = jamba_v0_1_52b.reduced().replace(
        d_model=256, num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512,
        pum=PUMConfig(mode=mode))
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, lm.prepack_for_serving(lm.init_params(cfg, gen, device=dev),
                                       cfg)


def _mamba_inputs(dev, cfg, batch, seed):
    """One Mamba layer's params of ``cfg`` (prepacked), an input of 6
    tokens and a state a few tokens old, on the card."""
    from repro_torch.core.prepack import prepack_params
    from repro_torch.models import ssm
    g = torch.Generator(device=dev).manual_seed(seed)
    p = prepack_params(ssm.init_mamba(g, cfg, dev), cfg.pum)
    x = torch.randn((batch, 6, cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    st = {n: torch.randn(t.shape, generator=g, device=dev)
          for n, t in ssm.make_ssm_state(cfg, batch, dev).items()}
    return p, x, st


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "pum"])
def test_mamba_on_the_card_equals_the_torch_backend(dev, mode):
    """The mixer on the ``cuda`` backend (its four projections on K1/K2)
    and on the ``torch`` backend: the same outputs and states bit for
    bit, in a prefill into a state and a decode step (the integer
    products are exact, the rest is the same ops on the same card);
    K1/K2 launched four times a call on ``cuda``."""
    from repro_torch.models import ssm
    cfg, _ = _hybrid(dev, mode)
    p, x, st = _mamba_inputs(dev, cfg, 2, seed=1)
    got = {}
    for backend in ("cuda", "torch"):
        registry.reset_launches()
        with torch.inference_mode(), registry.use_backend(backend):
            y1, s1 = ssm.mamba(p, x[:, :5], cfg, state=st)
            y2, s2 = ssm.mamba(p, x[:, 5:], cfg, state=s1)
        got[backend] = (y1, y2, s2["h"], s2["conv"], dict(registry.LAUNCHES))
    kern = "bitslice_mvm_scaled" if mode == "pum" else "bitslice_mvm"
    assert got["cuda"][4] == {kern: 8} and got["torch"][4] == {}
    assert all(torch.equal(a, b) for a, b in zip(got["cuda"][:4],
                                                 got["torch"][:4]))
    assert all(bool(torch.isfinite(t.float()).all()) for t in got["cuda"][:4])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "pum"])
def test_mamba_row_is_batch_invariant_on_the_card(dev, mode):
    """Row 0 of a batch of four equals that row run alone, bit for bit,
    in a prefill from a state and in a decode step: the state lanes are
    a fixed tree of adds, never a batched GEMM whose reduction the card
    may choose by the batch."""
    from repro_torch.models import ssm
    cfg, _ = _hybrid(dev, mode)
    p, x, st = _mamba_inputs(dev, cfg, 4, seed=2)
    one = {n: t[:1] for n, t in st.items()}
    with torch.inference_mode():
        for lo, hi in ((0, 5), (5, 6)):
            y4, st = ssm.mamba(p, x[:, lo:hi], cfg, state=st)
            y1, one = ssm.mamba(p, x[:1, lo:hi], cfg, state=one)
            assert torch.equal(y1, y4[:1])
            assert all(torch.equal(one[n], st[n][:1]) for n in one)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["paged", "contiguous", "static"])
def test_mamba_steps_advance_once(dev, kind):
    """``test_recurrent_steps_advance_once`` on the hybrid stack: each
    step kind built and called once as a graph leaves the Mamba rows
    (h and the conv window) one eager call leaves, bit for bit, beside
    a paged or contiguous KV layer and MoE FFNs."""
    _advance_once(dev, *_hybrid(dev, "pum"), kind)


# ---------------------------------------------------------------------------
# The prefix cache on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 16])
def test_paged_attention_keeps_shared_columns(dev, s):
    """K3 storing through the prefix cache's write table (each row's
    leading shared columns sent to the trash block) and reading through
    the real one: its pools equal the plain version's bit for bit, the
    blocks of shared columns are unchanged, the outputs within the
    one-ulp V bound."""
    from repro_torch.serve import kv_pool
    args = _attn_args(dev, s=s, q_dtype=torch.bfloat16, hd=128, t=81,
                      seed=7)
    shared = torch.tensor([3, 1, 2, 2], dtype=torch.int32, device=dev)
    args[6] = kv_pool.mask_shared_cols(args[5], shared)
    before = [args[3].clone(), args[4].clone()]
    rk, rv, _ = pa.paged_attention(*args, kv_len=81, backend="torch")
    kk, kv, ko = pa.paged_attention(*args, kv_len=81)
    torch.cuda.synchronize()
    assert torch.equal(kk, rk) and torch.equal(kv, rv)
    blocks = sorted({int(args[5][r, c]) for r in (0, 1, 3)
                     for c in range(int(shared[r]))})
    for now, old in zip((kk, kv), before):
        assert torch.equal(now[blocks], old[blocks])
    _assert_within_one_ulp_of_v(ko, args, 81, [0, 1])


def _prefix_config(dev, family):
    """A dense (reduced Qwen2.5-3B, widened) or hybrid (reduced
    Jamba-v0.1, widened, its FFNs dense: no capacity couples the rows)
    config in ``pum`` and its params."""
    from repro_torch.config import MoEConfig
    from repro_torch.models import lm
    if family == "dense":
        return _served(dev, "pum")
    cfg = _hybrid(dev, "pum")[0].replace(moe=MoEConfig())
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, lm.prepack_for_serving(lm.init_params(cfg, gen, device=dev),
                                       cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_prefix_cache_on_equals_off_on_the_card(dev, family):
    """A shared-prefix trace on the ``cuda`` backend with graphs: served
    cold and warm with the cache and once without, every completion the
    same bit for bit; the cache hits, and a drain and a flush leave no
    block live."""
    from repro_torch.serve import (ContinuousBatchingScheduler,
                                   synthetic_workload)
    cfg, params = _prefix_config(dev, family)
    kw = dict(num_slots=2, max_len=40, kv_block_size=8,
              chunked_prefill=True, device=dev)
    on = ContinuousBatchingScheduler(cfg, params, prefix_cache=True, **kw)
    off = ContinuousBatchingScheduler(cfg, params, **kw)
    reqs = synthetic_workload(6, cfg.vocab_size, min_prompt=4,
                              max_prompt=28, max_new=6,
                              mean_interarrival=1.0, shared_prefix_len=16,
                              seed=7)
    runs = [{r: c.tokens for r, c in s.run(reqs).items()}
            for s in (on, on, off)]
    assert runs[0] == runs[1] == runs[2]
    assert on.prefix_stats()["hits"] > 0
    on.drain()
    on.flush_prefix_cache()
    assert on._alloc.live_blocks == 0


# ---------------------------------------------------------------------------
# Speculative decoding: the verify shape and the spec step on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_paged_attention_at_the_verify_shape(dev):
    """A verify step's K3 call (4 rows of S = 4): one row inactive, one
    with its last drafts past the table width; the pools equal the
    plain version's bit for bit, trash block included, in every call,
    and the active rows' outputs within BF16_TOL of it."""
    rng = np.random.default_rng(44)
    b, s, kvh, grp, hd, bs, w = 4, 4, 2, 8, 128, 16, 6
    nb = 1 + b * w

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, torch.bfloat16)

    table = torch.arange(1, nb, dtype=torch.int32, device=dev).reshape(b, w)
    table[2] = 0
    ci = torch.tensor([38, 76, 0, w * bs - 2], dtype=torch.int32,
                      device=dev)
    args = [rnd(b, s, kvh, grp, hd), rnd(b, s, kvh, hd), rnd(b, s, kvh, hd),
            rnd(nb, bs, kvh, hd), rnd(nb, bs, kvh, hd), table,
            table.clone(), ci]
    rk, rv, ro = pa.paged_attention(*args, kv_len=81, backend="torch")
    for _ in range(2):
        kp, vp = args[3].clone(), args[4].clone()
        _, _, out = pa.paged_attention(*args[:3], kp, vp, *args[5:],
                                       kv_len=81)
        torch.cuda.synchronize()
        assert torch.equal(kp, rk) and torch.equal(vp, rv)
        active = [0, 1, 3]
        torch.testing.assert_close(out[active].float(), ro[active].float(),
                                   **BF16_TOL)


class _Replay:
    """The perfect drafter: recorded completions replayed."""

    def __init__(self, seqs):
        self.seqs = [list(q) for q in seqs]

    def propose(self, context, k):
        for q in self.seqs:
            if q[:len(context)] == list(context):
                return q[len(context):len(context) + k]
        return []


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dense", "hybrid", "xlstm",
                                    "dense-bf16"])
def test_spec_step_on_the_card_equals_one_token_steps(dev, family):
    """A greedy and sampled burst served at k = 0 and, with the n-gram
    and the replay drafter, at k = 3 (the verify step on K1 and K3 as a
    graph; in ``bf16`` its float projections on cuBLAS, position by
    position): the same tokens; the pools (the trash block excepted) and
    the recurrent rows the k = 0 run's, bit for bit; the graph run's
    whole state, trash block included, the eager run's (the spec step
    is warmed up on an all-inactive step, which leaves everything as it
    was); one spec program."""
    from repro_torch.serve import (ContinuousBatchingScheduler, kv_pool,
                                   synthetic_workload)
    if family == "xlstm":
        cfg, params = _xlstm(dev, "pum")
    elif family == "dense-bf16":
        cfg, params = _served(dev, "bf16")
    else:
        cfg, params = _prefix_config(dev, family)
    reqs = synthetic_workload(4, cfg.vocab_size, min_prompt=3,
                              max_prompt=20, max_new=10,
                              temperature_choices=(0.0, 0.7), seed=6)
    kw = dict(num_slots=4, max_len=32, kv_block_size=8,
              chunked_prefill=True, device=dev)
    base = ContinuousBatchingScheduler(cfg, params, **kw)
    want = {r: c.tokens for r, c in base.run(reqs).items()}
    replay = _Replay([list(r.prompt) + want[r.rid] for r in reqs])
    for drafter in ("ngram", replay):
        runs = []
        for graphs in (True, False):
            sched = ContinuousBatchingScheduler(
                cfg, params, speculate_k=3, drafter=drafter,
                cuda_graphs=graphs, **kw)
            assert {r: c.tokens for r, c in sched.run(reqs).items()} == want
            progs = sched.step_programs()
            assert progs["decode"] == 0 and progs["spec"] == 1
            torch.cuda.synchronize()
            for st0, st1 in zip(base.states, sched.states):
                for n, t in st0.items():
                    a = t[1:] if kv_pool.is_paged_cache(st0) else t
                    b = st1[n][1:] if kv_pool.is_paged_cache(st0) else st1[n]
                    assert torch.equal(a, b), n
            runs.append(sched)
        assert all(torch.equal(t, runs[1].states[i][n])
                   for i, st in enumerate(runs[0].states)
                   for n, t in st.items())
        if drafter is replay:
            assert runs[0].spec_stats()["advance_per_step"] > 1.5


# ---------------------------------------------------------------------------
# training: the straight-through gradient through K2, the train step
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["pum", "int8"])
def test_straight_through_forward_runs_k2(dev, mode):
    """A raw-weight quantised forward with a gradient launches K2 once
    (its unpacked entry) and equals the torch backend's bit for bit; the
    backward launches nothing and its gradients are the torch backend's
    bit for bit."""
    from repro_torch.config import PUMConfig
    from repro_torch.core import pum_linear as tpl
    g = torch.Generator(device=dev).manual_seed(30)
    x0 = torch.randn((4, 33, 256), generator=g, device=dev,
                     dtype=torch.bfloat16)
    w0 = torch.randn((256, 96), generator=g, device=dev) * 0.05
    runs = []
    for backend in ("cuda", "torch"):
        x = x0.clone().requires_grad_()
        w = w0.clone().requires_grad_()
        registry.reset_launches()
        with registry.use_backend(backend):
            y = tpl.pum_linear(x, w, PUMConfig(mode=mode))
            launched = dict(registry.LAUNCHES)
            y.float().square().sum().backward()
        torch.cuda.synchronize()
        assert dict(registry.LAUNCHES) == launched
        runs.append((launched, y.detach(), x.grad, w.grad))
    assert runs[0][0] == {"bitslice_mvm": 1} and runs[1][0] == {}
    for a, b in zip(runs[0][1:], runs[1][1:]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_train_steps_on_the_card_equal_the_torch_backend(dev):
    """Two train steps of the reduced Qwen2.5-3B in ``pum`` (remat on: the
    recomputation runs on the backward's own thread) on the cuda and the
    torch backend: the same params, optimiser state and metrics bit for
    bit, under deterministic algorithms (the embedding's backward sums
    without atomics); 14 K2 launches a layer and step on cuda, none on
    torch."""
    from repro_torch import configs
    from repro_torch.config import PUMConfig, TrainConfig
    from repro_torch.models import lm
    from repro_torch.train import step as tstep
    from repro_torch.tree import leaves
    cfg = configs.get_reduced("qwen2.5-3b").replace(pum=PUMConfig(
        mode="pum"))
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=1)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    # warn_only: cuBLAS asks for CUBLAS_WORKSPACE_CONFIG set before the
    # CUDA context exists, which an earlier test of the session may have
    # made; on one stream its GEMMs repeat their bits regardless
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ends = []
        for backend in ("cuda", "torch"):
            params = lm.init_params(cfg, torch.Generator(
                device=dev).manual_seed(0), dev)
            opt = tstep.init_opt_state(params, tcfg)
            step = tstep.make_train_step(cfg, tcfg)
            registry.reset_launches()
            with registry.use_backend(backend):
                metrics = [step(params, opt, {"tokens": toks})[2]
                           for _ in range(2)]
            torch.cuda.synchronize()
            want = {"bitslice_mvm": 2 * 14 * cfg.num_layers} \
                if backend == "cuda" else {}
            assert dict(registry.LAUNCHES) == want
            ends.append((leaves([params, opt]), metrics))
    finally:
        torch.use_deterministic_algorithms(False)
    assert all(torch.equal(a, b) for a, b in zip(ends[0][0], ends[1][0]))
    assert all(torch.equal(m0[k], m1[k]) for m0, m1 in zip(ends[0][1],
                                                         ends[1][1])
               for k in m0)


@pytest.mark.cuda
@pytest.mark.parametrize("absmax", [0.0, 1e-9, 1e-3, 3.0])
def test_ibert_on_the_card_equals_the_cpu(dev, absmax):
    """Every I-BERT wrapper and integer kernel on the card: the CPU's
    codes, scales and floats bit for bit (the same int32 ops with their
    wraparound, the same f32 scale arithmetic), at the absmaxes where
    the saturating cast and the subnormal flush act."""
    from repro_torch.core import ibert
    g = torch.Generator().manual_seed(int(absmax * 1e3) + 1)
    x = torch.randn((3, 4, 32, 48), generator=g)
    x = x / x.abs().max() * absmax
    for fn in ("gelu_quantized", "softmax_quantized",
               "layernorm_quantized"):
        got = getattr(ibert, fn)(x.to(dev)).cpu()
        assert torch.equal(got.view(torch.int32),
                           getattr(ibert, fn)(x).view(torch.int32)), fn
    t, td = ibert.quantize(x), ibert.quantize(x.to(dev))
    for fn in ("i_gelu", "i_softmax", "i_layernorm"):
        want, got = getattr(ibert, fn)(t.q, t.s), getattr(ibert, fn)(
            td.q, td.s)
        assert torch.equal(got[0].cpu(), want[0]), fn
        assert torch.equal(got[1].cpu().view(torch.int32),
                           want[1].view(torch.int32)), fn
    n = torch.randint(0, 2 ** 31 - 1, (4096,), generator=g,
                      dtype=torch.int32)
    assert torch.equal(ibert.i_sqrt(n.to(dev)).cpu(), ibert.i_sqrt(n))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,packed,kernel", [
    ("pum", True, "bitslice_mvm_scaled"), ("int8", True, "bitslice_mvm"),
    ("pum", False, "bitslice_mvm"), ("bf16", False, None)])
@pytest.mark.parametrize("ibert", [False, True])
def test_encoder_on_the_card_equals_the_torch_backend(dev, mode, packed,
                                                      kernel, ibert):
    """The encoder app at 2 layers: 6 MVM launches a layer on the mode's
    kernel (none in bf16), hidden states bit-equal to the torch
    backend's, which launches nothing."""
    from repro_torch.apps import encoder_app
    from repro_torch.config import PUMConfig
    g = torch.Generator(device=dev).manual_seed(3)
    p = encoder_app.encoder_init(g, layers=2, d_model=64, d_ff=128,
                                 vocab=100, device=dev)
    pum = PUMConfig(mode=mode, ibert=ibert)
    if packed:
        p = encoder_app.encoder_prepack(p, pum)
    toks = torch.randint(0, 100, (2, 16), generator=g, device=dev)
    registry.reset_launches()
    got = encoder_app.encoder_apply(p, toks, pum)
    assert dict(registry.LAUNCHES) == ({kernel: 12} if kernel else {})
    with registry.use_backend("torch"):
        registry.reset_launches()
        want = encoder_app.encoder_apply(p, toks, pum)
        assert not any(registry.LAUNCHES.values())
    assert torch.equal(got, want)
