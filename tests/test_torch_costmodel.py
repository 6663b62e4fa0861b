"""The port's copies of the µop timing model (``isa``), the cost model
and the HCT library surface against the JAX package's: equal numbers
(exactly, being the same Python arithmetic) and, for ``hct``'s MVMs,
equal within f32 1e-6 relative."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ADCConfig as JADC
from repro.core import costmodel as jcm
from repro.core import hct as jhct
from repro.core import isa as jisa
from repro_torch.config import ADCConfig
from repro_torch.core import costmodel as tcm
from repro_torch.core import hct as thct
from repro_torch.core import isa as tisa

# execMVM's dequantised f32 output: the int32 accumulators are equal and
# both scale by the same f32 factors, so 1e-6 relative bounds the ulps
F32_RTOL = 1e-6


@pytest.mark.parametrize("optimized", [True, False])
@pytest.mark.parametrize("bits,slices,kind,early,rows", [
    (8, 4, "sar", 0, 64), (3, 2, "sar", 0, 64), (1, 1, "ramp", 4, 64),
    (8, 4, "ramp", 0, 32), (1, 1, "sar", 0, 16)])
def test_schedule_mvm_equals_jax(bits, slices, kind, early, rows,
                                 optimized):
    kw = dict(adc_kind=kind, optimized=optimized, early_levels=early,
              rows=rows)
    t = tisa.schedule_mvm(bits, slices, **kw)
    assert dataclasses.astuple(t) == dataclasses.astuple(
        jisa.schedule_mvm(bits, slices, **kw))


def test_arbitrate_equals_jax():
    ops = ["AMVM", "DADD", "DXOR", "DSHL", "DLOADE", "SETM", "TRANSPOSE"]
    for iiu in (True, False):
        for kind in ("sar", "ramp"):
            t = tisa.arbitrate([tisa.Instr(o) for o in ops], adc_kind=kind,
                               iiu=iiu)
            j = jisa.arbitrate([jisa.Instr(o) for o in ops], adc_kind=kind,
                               iiu=iiu)
            assert t == j


def _result(r):
    return (r.arch, r.workload, r.latency_s, r.throughput, r.energy_j,
            r.detail)


@pytest.mark.parametrize("model,args", [
    ("DarthPUM", ("sar",)), ("DarthPUM", ("ramp",)), ("DigitalPUM", ()),
    ("DigitalPUM", ("DigitalPUM", True)), ("BaselineCPUAnalog", ()),
    ("AppAccel", ()), ("GPU", ())])
@pytest.mark.parametrize("workload", ["aes", "resnet20", "encoder"])
def test_models_equal_jax(model, args, workload):
    t = getattr(getattr(tcm, model)(*args), workload)()
    j = getattr(getattr(jcm, model)(*args), workload)()
    assert _result(t) == _result(j)


def test_aes_projection_and_naive_hybrid_equal_jax():
    for rounds in (10, 12, 14):
        w_t, w_j = tcm.AESWorkload(rounds), jcm.AESWorkload(rounds)
        for adc in ("sar", "ramp"):
            assert _result(tcm.DarthPUM(adc).aes(w_t)) == _result(
                jcm.DarthPUM(adc).aes(w_j))
    for frac in (0.0, 0.1, 0.5, 0.9):
        for ideal in (False, True):
            for opt in (False, True):
                kw = dict(ideal_logic=ideal, optimized_interface=opt)
                assert tcm.naive_hybrid_aes(frac, **kw) == \
                    jcm.naive_hybrid_aes(frac, **kw)
    assert tcm.NOR_PER_MAC_8B == jcm.NOR_PER_MAC_8B
    assert sorted(tcm.ALL_MODELS) == sorted(jcm.ALL_MODELS)
    assert tcm.hcts_for_matrix(200, 300, 8, 2) == \
        jcm.hcts_for_matrix(200, 300, 8, 2)


@pytest.mark.parametrize("precision", [0, 1, 2])
@pytest.mark.parametrize("kind,early", [("sar", 0), ("ramp", 4)])
def test_hct_set_and_exec_equal_jax(precision, kind, early):
    rng = np.random.default_rng(precision)
    w = rng.standard_normal((80, 24)).astype(np.float32)
    x = rng.standard_normal((3, 80)).astype(np.float32)
    jdev = jhct.DarthPUMDevice(n_hcts=8, adc=JADC(kind, 8, early))
    tdev = thct.DarthPUMDevice(n_hcts=8, adc=ADCConfig(kind, 8, early),
                               device="cpu")
    jh = jdev.setMatrix(jnp.asarray(w), element_size=8, precision=precision)
    th = tdev.setMatrix(w, element_size=8, precision=precision)
    assert (th.shape, th.tiles_k, th.tiles_n, th.hcts) == \
        (jh.shape, jh.tiles_k, jh.tiles_n, jh.hcts)
    assert [dataclasses.astuple(c) for c in th.vacores] == \
        [dataclasses.astuple(c) for c in jh.vacores]
    np.testing.assert_array_equal(th.w_q.numpy(), np.asarray(jh.w_q))
    for optimized in (True, False):
        assert tdev.mvm_cycles(th, optimized=optimized) == \
            jdev.mvm_cycles(jh, optimized=optimized)
    for analog_mode in (True, False):
        if not analog_mode:
            jdev.disableAnalogMode(jh)
            tdev.disableAnalogMode(th)
        want = np.asarray(jdev.execMVM(jh, jnp.asarray(x)))
        got = tdev.execMVM(th, torch.from_numpy(x))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL, atol=0)
    assert tdev.free_hcts() == jdev.free_hcts()


def test_hct_updates_and_allocation_equal_jax():
    w = np.eye(32, dtype=np.float32)
    jdev, tdev = jhct.DarthPUMDevice(n_hcts=2), thct.DarthPUMDevice(
        n_hcts=2, device="cpu")
    jh, th = jdev.setMatrix(jnp.asarray(w)), tdev.setMatrix(w)
    v = np.linspace(-1, 1, 32).astype(np.float32)
    jdev.updateRow(jh, 3, jnp.asarray(v))
    tdev.updateRow(th, 3, v)
    jdev.updateCol(jh, 5, jnp.asarray(v[::-1].copy()))
    tdev.updateCol(th, 5, v[::-1].copy())
    np.testing.assert_array_equal(th.w_q.numpy(), np.asarray(jh.w_q))
    for size, bpc in [(8, 2), (16, 2), (4, 1)]:
        tv, jv = tdev.allocVACore(size, bpc), jdev.allocVACore(size, bpc)
        assert dataclasses.astuple(tv) == dataclasses.astuple(jv)
    while True:
        try:
            jdev.allocVACore(8, 2)
        except RuntimeError:
            with pytest.raises(RuntimeError, match="out of analog arrays"):
                tdev.allocVACore(8, 2)
            break
        tdev.allocVACore(8, 2)
    assert thct.hcts_for_matrix(300, 100, 8, 2) == \
        jhct.hcts_for_matrix(300, 100, 8, 2)
