"""The port's kernel families: the plain PyTorch versions against the
JAX package's oracles on the CPU, and the registry's dispatch rules.
The CUDA kernels against their plain versions: ``test_torch_cuda.py``."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import bitslice as jb
from repro.kernels.bitslice_mvm import ops as jmvm
from repro.kernels.bitslice_mvm.ref import bitslice_mvm_ref as j_mvm_ref
from repro.kernels.paged_attention.ref import paged_attention_ref as j_pa_ref
from repro.models import attention as jattn
from repro_torch.kernels import _build, registry
from repro_torch.kernels.bitslice_mvm import ops as tmvm
from repro_torch.kernels.gf2_mvm import ops as tgf2
from repro_torch.kernels.paged_attention import ops as tpa
from repro_torch.kernels.paged_attention.ref import paged_write_cells

F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 pools: probabilities are rounded to bf16 before the PV product,
# and XLA's CPU backend rounds bf16 at other points than torch does; one
# bf16 ulp is 2^-8 relative, so outputs of O(1) agree within 2e-2
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# bitslice_mvm: plain versions, bit for bit
# ---------------------------------------------------------------------------

def _mvm_case(seed, m, k, n, bps):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(k, n)).astype(np.int32)
    planes = np.asarray(jb.slice_planes_signed(jnp.asarray(wq), 8, bps)
                        ).astype(np.int8)
    scale = (rng.random((m, 1)) * 1e-3).astype(np.float32)
    return x, planes, scale


@given(seed=st.integers(0, 2**31 - 1), m=st.integers(1, 20),
       k=st.sampled_from([8, 40, 128, 300]), n=st.sampled_from([16, 48, 80]),
       bps=st.sampled_from([1, 2, 4]))
@settings(max_examples=12, deadline=None)
def test_bitslice_mvm_plain_equals_jax(seed, m, k, n, bps):
    x, planes, scale = _mvm_case(seed, m, k, n, bps)
    want = np.asarray(j_mvm_ref(jnp.asarray(x), jnp.asarray(planes),
                                bits_per_slice=bps))
    got = tmvm.bitslice_mvm_planes(torch.from_numpy(x),
                                   torch.from_numpy(planes),
                                   bits_per_slice=bps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    want_s = np.asarray(jmvm.bitslice_mvm_planes_scaled(
        jnp.asarray(x), jnp.asarray(planes), jnp.asarray(scale),
        bits_per_slice=bps, backend="xla"))
    got_s = tmvm.bitslice_mvm_planes_scaled(
        torch.from_numpy(x), torch.from_numpy(planes),
        torch.from_numpy(scale), bits_per_slice=bps)
    assert got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def test_bitslice_mvm_plain_equals_jax_interpret_kernel():
    """One shape through the Pallas kernel body itself (interpreted)."""
    x, planes, scale = _mvm_case(11, 5, 256, 128, 2)
    want = np.asarray(jmvm.bitslice_mvm_planes_scaled(
        jnp.asarray(x), jnp.asarray(planes), jnp.asarray(scale),
        bits_per_slice=2, backend="interpret"))
    got = tmvm.bitslice_mvm_planes_scaled(
        torch.from_numpy(x)[None], torch.from_numpy(planes),
        torch.from_numpy(scale)[None], bits_per_slice=2)
    assert got.shape == (1, 5, 128)
    np.testing.assert_array_equal(got[0].numpy(), want)
    want_i = np.asarray(jmvm.bitslice_mvm_planes(
        jnp.asarray(x), jnp.asarray(planes[:1]), bits_per_slice=8,
        backend="interpret"))
    got_i = tmvm.bitslice_mvm_planes(torch.from_numpy(x),
                                     torch.from_numpy(planes[:1]),
                                     bits_per_slice=8)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


@pytest.mark.parametrize("k", [16, 27, 144, 576])
@pytest.mark.parametrize("n", [10, 16, 64])
@pytest.mark.parametrize("bps", [2, 8])
def test_unpacked_bitslice_mvm_plain_equals_jax(k, n, bps):
    """The unpacked entry (planes sliced per call from a signed weight)
    at the ResNet-20 layer shapes, bit for bit against the JAX
    package's ``bitslice_mvm(..., backend="xla")``."""
    rng = np.random.default_rng(k * n + bps)
    x = rng.integers(-127, 128, size=(2, 7, k)).astype(np.int32)
    wq = rng.integers(-127, 128, size=(k, n)).astype(np.int32)
    want = np.asarray(jmvm.bitslice_mvm(jnp.asarray(x), jnp.asarray(wq),
                                        weight_bits=8, bits_per_slice=bps,
                                        backend="xla"))
    got = tmvm.bitslice_mvm(torch.from_numpy(x), torch.from_numpy(wq),
                            weight_bits=8, bits_per_slice=bps)
    assert got.dtype == torch.int32 and got.shape == (2, 7, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), x @ wq)
    with pytest.raises(registry.KernelTileError):
        tmvm.bitslice_mvm(torch.from_numpy(x)[..., 1:],
                          torch.from_numpy(wq))


# ---------------------------------------------------------------------------
# paged attention: plain version against JAX's oracle and composition
# ---------------------------------------------------------------------------

def _pa_case(seed, *, b, s, w, bs, kvh, g, hd, dtype, trash_row):
    rng = np.random.default_rng(seed)
    nb = 1 + b * w

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    arrs = [rnd(b, s, kvh, g, hd), rnd(b, s, kvh, hd), rnd(b, s, kvh, hd),
            rnd(nb, bs, kvh, hd), rnd(nb, bs, kvh, hd)]
    table = np.arange(1, nb).reshape(b, w).astype(np.int32)
    ci = np.asarray([int(rng.integers(0, w * bs - s + 1))
                     for _ in range(b)], np.int32)
    if trash_row:
        table[-1] = 0          # an inactive row: every write and read hits
        ci[-1] = 0             # the trash block
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tx = [torch.from_numpy(a).to({jnp.float32: torch.float32,
                                  jnp.bfloat16: torch.bfloat16}[dtype])
          for a in arrs]
    tables = (table, table.copy(), ci)
    return jx + [jnp.asarray(t) for t in tables], \
        tx + [torch.from_numpy(t) for t in tables]


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("crop", [False, True])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_attention_plain_equals_jax(s, crop, softcap):
    w, bs = 3, 4
    jargs, targs = _pa_case(s + 10 * crop, b=3, s=s, w=w, bs=bs, kvh=2,
                            g=2, hd=16, dtype=jnp.float32, trash_row=True)
    kv_len = w * bs - 2 if crop else None
    jk, jv, jo = j_pa_ref(*jargs, kv_len=kv_len, softcap=softcap)
    tk, tv, to = tpa.paged_attention(*targs, kv_len=kv_len,
                                     softcap=softcap)
    # real blocks bit for bit (the trash block takes colliding writes);
    # the active rows' outputs within f32 tolerance
    np.testing.assert_array_equal(tk.float().numpy()[1:],
                                  np.asarray(jk, np.float32)[1:])
    np.testing.assert_array_equal(tv.float().numpy()[1:],
                                  np.asarray(jv, np.float32)[1:])
    np.testing.assert_allclose(to.float().numpy()[:-1],
                               np.asarray(jo, np.float32)[:-1], **F32_TOL)
    # the input pools are untouched by the plain version
    assert not torch.equal(tk, targs[3])


def test_paged_attention_plain_equals_jax_bf16():
    jargs, targs = _pa_case(5, b=3, s=4, w=3, bs=4, kvh=2, g=4, hd=32,
                            dtype=jnp.bfloat16, trash_row=True)
    jk, _, jo = j_pa_ref(*jargs, kv_len=10)
    tk, _, to = tpa.paged_attention(*targs, kv_len=10)
    assert to.dtype == torch.bfloat16
    np.testing.assert_array_equal(tk.float().numpy()[1:],
                                  np.asarray(jk, np.float32)[1:])
    np.testing.assert_allclose(to.float().numpy()[:-1],
                               np.asarray(jo, np.float32)[:-1], **BF16_TOL)


@pytest.mark.parametrize("s", [1, 5])
def test_past_width_write_goes_to_trash(s):
    """Positions past the table width go to the trash block, as the JAX
    composition's ``paged_write_cells`` routes them (the TPU kernel
    clips the column instead)."""
    table = np.asarray([[3, 4], [5, 6]], np.int32)
    ci = np.asarray([6, 2], np.int32)           # row 0 crosses 2 * 4
    jp, jo = jattn.paged_write_cells(jnp.asarray(table), jnp.asarray(ci),
                                     s, 4)
    tp, to = paged_write_cells(torch.from_numpy(table),
                               torch.from_numpy(ci), s, 4)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    if s > 2:
        assert tp[0, 2:].tolist() == [0] * (s - 2)
    # and the whole plain version against the composition, past width
    jargs, targs = _pa_case(9, b=2, s=s, w=2, bs=4, kvh=1, g=2, hd=8,
                            dtype=jnp.float32, trash_row=False)
    jargs[-1] = jnp.asarray(ci)
    targs[-1] = torch.from_numpy(ci)
    cache = {"k_pool": jargs[3], "v_pool": jargs[4]}
    jcache, *_ = jattn._paged_update_and_gather(
        cache, jargs[1], jargs[2], jargs[5], jargs[7], None,
        write_table=jargs[6])
    tk, tv, _ = tpa.paged_attention(*targs)
    np.testing.assert_array_equal(tk.numpy()[1:],
                                  np.asarray(jcache["k_pool"])[1:])
    np.testing.assert_array_equal(tv.numpy()[1:],
                                  np.asarray(jcache["v_pool"])[1:])


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_selection_and_device_rules():
    cpu = torch.zeros(2)
    assert registry.resolve_backend(cpu) == registry.KernelBackend.TORCH
    with registry.use_backend("torch", paged_attention="cuda"):
        assert registry.get_backend("bitslice_mvm") == \
            registry.KernelBackend.TORCH
        assert registry.get_backend("paged_attention") == \
            registry.KernelBackend.CUDA
        with registry.use_backend(paged_attention="torch"):
            assert registry.get_backend("paged_attention") == \
                registry.KernelBackend.TORCH
        # the kernel takes CUDA tensors only: asking for it on a CPU
        # tensor raises rather than running anything else
        with pytest.raises(registry.KernelTileError):
            registry.resolve_backend(cpu, kernel="paged_attention")
    assert registry.get_backend("bitslice_mvm") is None
    with pytest.raises(ValueError):
        registry.coerce_backend("pallas")


def test_plain_versions_count_no_launches():
    registry.reset_launches()
    x, planes, scale = _mvm_case(1, 2, 16, 16, 2)
    tmvm.bitslice_mvm_planes_scaled(torch.from_numpy(x),
                                    torch.from_numpy(planes),
                                    torch.from_numpy(scale))
    assert sum(registry.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# the kernels' launch plans (plain arithmetic, checked here on the CPU for
# a card described by a stub of its properties)
# ---------------------------------------------------------------------------

H100 = registry.DeviceProps(sms=132, max_smem=232448, max_threads=2048)
PCIE = registry.DeviceProps(sms=114, max_smem=232448, max_threads=2048)
SERVED_MVM = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048)]
# Jamba-v0.1's projections (K, N): Mamba's in, x, dt and out, attention's
# q/o and k/v, the MLP's gate/up and down
JAMBA_MVM = [(4096, 16384), (8192, 288), (256, 8192), (8192, 4096),
             (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


@pytest.mark.parametrize("props", [H100, PCIE], ids=["sxm", "pcie"])
@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("m", [1, 3, 4, 5, 16, 17, 33, 200])
@pytest.mark.parametrize("k,n", [(1, 16), (64, 16), (300, 48), (2048, 256),
                                 (2048, 2048), (2048, 11008),
                                 (11008, 2048), (2048, 12288)] + JAMBA_MVM)
def test_mvm_plan_covers_k_once_and_fits(m, k, n, s, props):
    plan = tmvm.mvm_plan(m, k, n, s, props)
    assert plan.mt >= min(m, 16) and plan.mt in tmvm.ROW_TILES
    assert plan.mt * plan.row_tiles >= m > plan.mt * (plan.row_tiles - 1)
    assert plan.col_tiles * tmvm.BN >= n > (plan.col_tiles - 1) * tmvm.BN
    assert plan.ktiles * tmvm.BK >= k > (plan.ktiles - 1) * tmvm.BK
    # the K tiles [kt0, kt1) each split walks, as the kernel cuts them
    ranges = [(z * plan.ktiles // plan.splits,
               (z + 1) * plan.ktiles // plan.splits)
              for z in range(plan.splits)]
    covered = [kt for lo, hi in ranges for kt in range(lo, hi)]
    assert covered == list(range(plan.ktiles))      # each K tile once
    assert all(hi > lo for lo, hi in ranges)        # no empty split
    assert plan.smem + 4 * plan.mt * tmvm.BN <= props.max_smem
    assert plan.stages == (tmvm.DEEP if s == 1 else tmvm.SHALLOW)
    # a power-of-two cluster of splits, as large as one wave of CTAs,
    # the cluster limit and MIN_SPLIT_KTILES K tiles a split allow
    tiles = plan.row_tiles * plan.col_tiles
    wave = tmvm.CTAS_PER_SM * props.sms
    sp = plan.splits
    assert sp & (sp - 1) == 0 and 1 <= sp <= tmvm.MAX_SPLITS

    def fits(n):
        return n <= tmvm.MAX_SPLITS and n * tiles <= wave \
            and n * tmvm.MIN_SPLIT_KTILES <= plan.ktiles

    assert sp == 1 or fits(sp)
    assert not fits(2 * sp)


def test_mvm_plan_at_the_served_shapes():
    """Qwen2.5-3B's projections at decode (M=4) on an H100 SXM: the
    narrow ones split over a cluster of 8 or 16, the wide up-projection
    two ways (172 CTAs); the split follows the card's SMs."""
    got = {kn: tmvm.mvm_plan(4, *kn, 4, H100) for kn in SERVED_MVM}
    assert all(p.mt == 4 and p.row_tiles == 1 for p in got.values())
    assert {kn: p.splits for kn, p in got.items()} == {
        (2048, 2048): 8, (2048, 256): 8, (2048, 11008): 2,
        (11008, 2048): 16}
    assert got[(2048, 11008)].col_tiles * got[(2048, 11008)].splits == 172
    assert tmvm.mvm_plan(4, 2048, 2048, 4,
                         H100._replace(sms=48)).splits == 4
    assert tmvm.mvm_plan(1, 2048, 11008, 1, H100).stages == tmvm.DEEP
    # a card with too little shared memory for the ring is refused
    with pytest.raises(registry.KernelTileError):
        tmvm.mvm_plan(4, 2048, 256, 4, H100._replace(max_smem=48 * 1024))


# each launch plan at the serving path's decode and prefill shapes:
# (mt, row_tiles, col_tiles, ktiles, splits, stages, smem) by (M, K, N, S)
DECODE_PLANS = {
    (4, 2048, 2048, 1): (4, 1, 16, 32, 8, 8, 67584),
    (4, 2048, 2048, 4): (4, 1, 16, 32, 8, 3, 99072),
    (4, 2048, 256, 4): (4, 1, 2, 32, 8, 3, 99072),
    (4, 2048, 11008, 1): (4, 1, 86, 32, 2, 8, 67584),
    (4, 2048, 11008, 4): (4, 1, 86, 32, 2, 3, 99072),
    (4, 11008, 2048, 4): (4, 1, 16, 172, 16, 3, 99072),
    (1, 11008, 2048, 1): (1, 1, 16, 172, 16, 8, 66048),
    (16, 2048, 2048, 4): (16, 1, 16, 32, 8, 3, 101376),
    (16, 2048, 11008, 1): (16, 1, 86, 32, 2, 8, 73728),
    (16, 11008, 2048, 4): (16, 1, 16, 172, 16, 3, 101376),
    (32, 2048, 11008, 4): (16, 2, 86, 32, 1, 3, 101376),
}


@pytest.mark.parametrize("shape", sorted(DECODE_PLANS))
def test_mvm_plan_at_decode_shapes_unchanged(shape):
    """The row-tile walk changed no plan of the serving path: one CTA a
    row tile, as many on grid z as there are tiles."""
    plan = tmvm.mvm_plan(*shape, H100)
    assert tuple(plan[:7]) == DECODE_PLANS[shape]
    assert plan.grid_rows == plan.row_tiles


# ResNet-20's im2col MVMs over 1024 images: (M, K, N)
CNN_SHAPES = [(1 << 20, 27, 16), (1 << 20, 144, 16), (1 << 18, 144, 32),
              (1 << 18, 288, 32), (1 << 18, 16, 32), (1 << 16, 288, 64),
              (1 << 16, 576, 64), (1 << 16, 32, 64), (1024, 64, 16)]


@pytest.mark.parametrize("props", [H100, PCIE], ids=["sxm", "pcie"])
@pytest.mark.parametrize("m", [1 << 20, 1 << 22, 16 * 65535 + 1,
                               16 * 65535, 3 << 20])
@pytest.mark.parametrize("k,n", [(27, 16), (144, 16), (576, 64)])
@pytest.mark.parametrize("s", [1, 4])
def test_mvm_plan_past_the_grid_z_limit(m, k, n, s, props):
    """Over 65535 row tiles the launch stays within CUDA's gridDim.z
    limit, and the kernel's walk (CTA z takes tiles z, z + grid_rows,
    ...) covers every tile once, in one launch."""
    plan = tmvm.mvm_plan(m, k, n, s, props)
    assert plan.mt == 16
    assert plan.row_tiles == -(-m // 16)
    assert 1 <= plan.grid_rows <= tmvm.MAX_GRID_Z == 65535
    assert plan.grid_rows == min(plan.row_tiles, 65535)
    walked = [t for z in range(plan.grid_rows)
              for t in range(z, plan.row_tiles, plan.grid_rows)]
    assert len(walked) == plan.row_tiles
    assert set(walked) == set(range(plan.row_tiles))
    # the tiles alone fill the card: no split over K
    assert plan.splits == 1


@pytest.mark.parametrize("m,k,n", CNN_SHAPES)
def test_mvm_plan_at_the_cnn_shapes(m, k, n):
    plan = tmvm.mvm_plan(m, k, n, 4, H100)
    assert plan.grid_rows == min(plan.row_tiles, 65535)
    assert plan.grid_rows <= 65535 and plan.col_tiles == 1
    assert plan.smem + 4 * plan.mt * tmvm.BN <= H100.max_smem


@pytest.mark.parametrize("props", [H100, PCIE], ids=["sxm", "pcie"])
@pytest.mark.parametrize("hd", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("t", [1, 31, 81, 128, 129, 1000, 1024, 7136])
@pytest.mark.parametrize("s,g", [(1, 8), (1, 4), (1, 16), (16, 8), (64, 8)])
def test_attention_plan_covers_the_window_and_fits(hd, t, s, g, props):
    plan = tpa.attention_plan(s, g, hd, t, props)
    assert plan.query_groups * plan.warps >= s * g \
        > (plan.query_groups - 1) * plan.warps
    # every key in one tile of one split, a score slot for each
    chunks = -(-t // plan.chunk)
    assert 1 <= plan.splits <= min(tpa.MAX_SPLITS, chunks)
    assert plan.keys_per_cta % plan.chunk == 0
    assert plan.keys_per_cta * plan.splits >= chunks * plan.chunk
    assert plan.keys_per_cta - plan.chunk < -(-t // plan.splits)
    assert 2 <= plan.stages <= min(tpa.MAX_STAGES,
                                   max(2, 2 * plan.keys_per_cta
                                       // plan.chunk))
    assert plan.chunk % 16 == 0 and plan.warps <= tpa.MMA_ROWS
    assert plan.row >= hd and plan.row % 8 == 0
    lay = plan.layout
    assert lay == tpa.smem_layout(plan.warps, hd, plan.keys_per_cta,
                                  plan.chunk, plan.row, plan.stages)
    assert plan.smem == lay.bytes <= props.max_smem
    # the regions the kernel range-checks: 16-byte aligned, in order,
    # each as large as what it holds (p * V parts from 0, (max, sum),
    # scores, two query tiles, p, the ring)
    assert all(off % 16 == 0 for off in lay[:6])
    assert lay.stats >= plan.warps * hd * 4
    assert lay.scores >= lay.stats + plan.warps * 8
    assert lay.qhi >= lay.scores + plan.warps * plan.keys_per_cta * 4
    assert lay.qlo - lay.qhi == lay.probs - lay.qlo \
        == tpa.MMA_ROWS * plan.row * 2
    assert lay.prow >= plan.keys_per_cta and lay.prow % 8 == 0
    assert lay.tiles >= lay.probs + tpa.MMA_ROWS * lay.prow * 2
    assert lay.bytes == lay.tiles + plan.stages * plan.chunk * plan.row * 2


def test_attention_plan_at_the_served_shapes():
    """Qwen2.5-3B (G=8, hd=128): a decode step over the smoke window is
    one CTA per (row, head); a prefill chunk of 16 takes 16 query
    groups; T=1024 splits the window over a cluster of 8; the edges
    (S=64, hd=256, a long window) fit; a window too long for the card's
    shared memory is refused."""
    decode = tpa.attention_plan(1, 8, 128, 81, H100)
    assert decode[:-1] == (8, 128, 136, 1, 1, 128, 2,
                           (8 * 128 * 4 + 8 * 8) + 8 * 128 * 4
                           + 2 * 16 * 136 * 2 + 16 * 136 * 2
                           + 2 * 128 * 136 * 2)
    assert decode.layout == tpa.SmemLayout(
        stats=4096, scores=4160, qhi=8256, qlo=12608, probs=16960,
        tiles=21312, prow=136, bytes=decode.smem)
    chunk16 = tpa.attention_plan(16, 8, 128, 81, H100)
    assert (chunk16.query_groups, chunk16.splits) == (16, 1)
    long = tpa.attention_plan(1, 8, 128, 1024, H100)
    assert (long.splits, long.keys_per_cta, long.stages) == (8, 128, 2)
    edge = tpa.attention_plan(64, 8, 256, 1000, H100)
    assert (edge.query_groups, edge.splits) == (64, 8)
    deep = tpa.attention_plan(1, 8, 128, 7136, H100)
    assert (deep.splits, deep.keys_per_cta, deep.stages) == (8, 896, 4)
    with pytest.raises(registry.KernelTileError):
        tpa.attention_plan(1, 8, 128, 40_000, H100)


SMALL = registry.DeviceProps(sms=16, max_smem=48 * 1024, max_threads=1024)


@pytest.mark.parametrize("props", [H100, PCIE], ids=["sxm", "pcie"])
@pytest.mark.parametrize("k", [1, 16, 32, 100, 128, 200, 256, 384, 512])
def test_gf2_plan_lays_out_disjoint_regions_that_fit(k, props):
    """The tensor-core K4 kernel's shared memory: the ring of row tiles,
    a's transposed tile and the output tile, disjoint and within the
    card's limit; rows hold K padded to the mma's 32-byte steps plus
    ROW_PAD bytes, which keeps them 16-byte aligned and puts the 8 rows
    of a fragment load on 8 different groups of 4 banks."""
    plan = tgf2.gf2_plan(k, props)
    assert plan.stages in (2, tgf2.MAX_STAGES)
    kp = -(-k // 32) * 32
    assert plan.row == kp + tgf2.ROW_PAD
    assert plan.row % 16 == 0 and (plan.row // 4) % 8 == 4
    assert plan.a_off == plan.stages * tgf2.TILE_M * plan.row
    assert plan.out_off == plan.a_off + tgf2.TILE_N * plan.row
    assert plan.smem == plan.out_off + tgf2.TILE_M * (tgf2.TILE_N
                                                      + tgf2.ROW_PAD)
    assert plan.smem <= props.max_smem
    # the deepest ring that fits
    if plan.stages < tgf2.MAX_STAGES:
        deeper = (tgf2.MAX_STAGES - plan.stages) * tgf2.TILE_M * plan.row
        assert plan.smem + deeper > props.max_smem


def test_gf2_plan_long_k_and_small_cards():
    assert tgf2.gf2_plan(128, H100).stages == tgf2.MAX_STAGES
    assert tgf2.gf2_plan(512, H100).stages == 2
    assert tgf2.gf2_plan(tgf2.MAX_MMA_K + 1, H100) == (0, 0, 0, 0, 0)
    assert tgf2.gf2_plan(64, SMALL).smem <= SMALL.max_smem
    with pytest.raises(registry.KernelTileError, match="shared bytes"):
        tgf2.gf2_plan(512, SMALL)


def test_kernel_wrappers_refuse_exactly_what_the_kernels_cannot_take():
    """The wrappers' checks (plain Python, run here on CPU tensors)."""
    x = torch.zeros((3, 64), dtype=torch.int8)
    for s in range(0, 6):
        for n in (8, 16, 24, 32, 48, 100, 128):
            planes = torch.zeros((s, 64, n), dtype=torch.int8)
            if 1 <= s <= 4 and n % 16 == 0:
                tmvm._check_cuda(x, planes, 2)
            else:
                with pytest.raises(registry.KernelTileError):
                    tmvm._check_cuda(x, planes, 2)
    with pytest.raises(registry.KernelTileError):      # not int8
        tmvm._check_cuda(x, torch.zeros((1, 64, 16), dtype=torch.int32), 2)
    with pytest.raises(registry.KernelTileError):      # K mismatch
        tmvm._check_cuda(x, torch.zeros((1, 63, 16), dtype=torch.int8), 2)
    with pytest.raises(registry.KernelTileError):      # shift overflows
        tmvm._check_cuda(x, torch.zeros((4, 64, 16), dtype=torch.int8), 8)

    def pa_args(hd, q_dtype=torch.bfloat16, pool_dtype=torch.bfloat16):
        b, s, kvh, g, bs, w = 2, 3, 2, 4, 4, 3
        table = torch.zeros((b, w), dtype=torch.int32)
        return (torch.zeros((b, s, kvh, g, hd), dtype=q_dtype),
                torch.zeros((b, s, kvh, hd), dtype=q_dtype),
                torch.zeros((b, s, kvh, hd), dtype=q_dtype),
                torch.zeros((7, bs, kvh, hd), dtype=pool_dtype),
                torch.zeros((7, bs, kvh, hd), dtype=pool_dtype),
                table, table.clone(), torch.zeros((b,), dtype=torch.int32))

    for hd in (16, 32, 48, 64, 96, 128, 160, 256, 288, 512):
        if hd % 32 == 0 and hd <= 256:
            tpa._check(*pa_args(hd))
        else:
            with pytest.raises(registry.KernelTileError):
                tpa._check(*pa_args(hd))
    tpa._check(*pa_args(128, torch.float32))
    with pytest.raises(registry.KernelTileError, match="bfloat16"):
        tpa._check(*pa_args(128, torch.float32, torch.float32))
    with pytest.raises(registry.KernelTileError):
        tpa._check(*pa_args(128, torch.float16))


KERNEL_PACKAGES = {"bitslice_mvm": tmvm, "paged_attention": tpa,
                   "gf2_mvm": tgf2}


@pytest.mark.parametrize("name", sorted(KERNEL_PACKAGES))
def test_kernel_constants_have_one_owner(name):
    """The constants a kernel's launch plan shares with its CUDA source
    are stated once, in ``ops.NVCC_DEFINES``: the build passes each as a
    ``-D`` macro, the source uses it and defines none of them, and no
    card's SM count or shared-memory size is written into the port."""
    ops = KERNEL_PACKAGES[name]
    src = _build.sources()[name]
    text = src.read_text()
    assert _build.defines(src) == tuple(
        f"-D{k}={v}" for k, v in ops.NVCC_DEFINES.items())
    assert ops.NVCC_DEFINES
    # nvcc reads a comma in an option as a list separator
    assert not any("," in str(v) for v in ops.NVCC_DEFINES.values())
    for key in ops.NVCC_DEFINES:
        assert re.search(rf"\b{key}\b", text), key
        assert not re.search(rf"(constexpr\s+\w+\s+{key}\b|#define\s+{key}\b)",
                             text), key
    for path in [src, pathlib.Path(ops.__file__),
                 pathlib.Path(registry.__file__)]:
        assert not re.search(r"\b(132|114|1056|232448|227 \* 1024)\b",
                             _code(path.read_text())), path


def _code(text: str) -> str:
    """``text`` without its comments (C ``//`` and Python ``#``) and
    docstrings, which may name a card's numbers."""
    text = re.sub(r'""".*?"""', "", text, flags=re.S)
    return re.sub(r"(//|#(?!include|if|error|endif|define)).*", "", text)
