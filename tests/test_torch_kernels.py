"""The port's kernel families: the plain PyTorch versions against the
JAX package's oracles on the CPU, and the registry's dispatch rules.
The CUDA kernels against their plain versions: ``test_torch_cuda.py``."""
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
from repro_torch.kernels import registry
from repro_torch.kernels.bitslice_mvm import ops as tmvm
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
