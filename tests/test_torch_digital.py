"""The port's DCE simulator against the JAX package's on random bit
planes: every gate and multi-bit op bit for bit, with equal
``GateCounter`` totals."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import digital as jd
from repro_torch.core import digital as td


def _planes(rng, bits, rows):
    v = rng.integers(0, 1 << bits, size=(rows,), dtype=np.uint32)
    return v, jd.unpack(jnp.asarray(v), bits), td.unpack(
        torch.from_numpy(v.astype(np.int64)), bits)


def _same(j, t):
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(j))


def _counters():
    return jd.GateCounter(), td.GateCounter()


def _same_count(jc, tc):
    assert (tc.nor, tc.copy, tc.total) == (jc.nor, jc.copy, jc.total)


GATES = ["nor", "or_", "and_", "xnor_", "xor_"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("gate", GATES + ["not_", "full_adder"])
def test_gates_equal_jax(gate, seed):
    rng = np.random.default_rng(seed)
    ab = rng.integers(0, 2, size=(3, 40)).astype(bool)
    jc, tc = _counters()
    jargs = [jnp.asarray(v) for v in ab]
    targs = [torch.from_numpy(v) for v in ab]
    n = {"not_": 1, "full_adder": 3}.get(gate, 2)
    jout = getattr(jd, gate)(*jargs[:n], jc)
    tout = getattr(td, gate)(*targs[:n], tc)
    if gate == "full_adder":
        for j, t in zip(jout, tout):
            _same(j, t)
    else:
        assert tout.dtype == torch.bool
        _same(jout, tout)
    _same_count(jc, tc)


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_pack_unpack_equal_jax(bits):
    v, jp, tp = _planes(np.random.default_rng(bits), bits, 33)
    _same(jp, tp)
    np.testing.assert_array_equal(td.pack(tp).numpy(),
                                  np.asarray(jd.pack(jp)).astype(np.int64))
    np.testing.assert_array_equal(td.pack(tp).numpy(), v)


@pytest.mark.parametrize("op", ["add", "sub", "xor_planes", "mul",
                                "greater_equal", "select"])
@pytest.mark.parametrize("bits", [4, 8])
def test_multibit_ops_equal_jax(op, bits):
    rng = np.random.default_rng(bits * 7)
    _, ja, ta = _planes(rng, bits, 16)
    _, jb, tb = _planes(rng, bits, 16)
    jc, tc = _counters()
    if op == "mul":
        jout, tout = jd.mul(ja, jb, 2 * bits, jc), td.mul(ta, tb, 2 * bits,
                                                          tc)
    elif op == "select":
        jout = jd.select(jd.greater_equal(ja, jb, jc), ja, jb, jc)
        tout = td.select(td.greater_equal(ta, tb, tc), ta, tb, tc)
    else:
        jout = getattr(jd, op)(ja, jb, jc)
        tout = getattr(td, op)(ta, tb, tc)
    _same(jout, tout)
    _same_count(jc, tc)


@pytest.mark.parametrize("op,arg", [("shift_left", 3), ("shift_right", 2),
                                    ("reverse_pipeline", None),
                                    ("rotate_rows", 5)])
def test_moves_equal_jax(op, arg):
    _, ja, ta = _planes(np.random.default_rng(9), 8, 12)
    jc, tc = _counters()
    if arg is None:
        jout, tout = getattr(jd, op)(ja, jc), getattr(td, op)(ta, tc)
    elif op == "rotate_rows":
        jout = jd.rotate_rows(ja[:, None], arg, axis=2, ctr=jc)
        tout = td.rotate_rows(ta[:, None], arg, axis=2, ctr=tc)
    else:
        jout, tout = getattr(jd, op)(ja, arg, jc), getattr(td, op)(ta, arg,
                                                                   tc)
    _same(jout, tout)
    _same_count(jc, tc)


def test_elementwise_load_gathers_not_masks():
    """The S-box load: addresses index the table (a uint8 index tensor
    would be a boolean mask in torch)."""
    rng = np.random.default_rng(0)
    table_v = rng.integers(0, 256, size=(256,), dtype=np.uint32)
    addr_v = rng.integers(0, 256, size=(64,), dtype=np.uint32)
    jc, tc = _counters()
    jout = jd.elementwise_load(jd.unpack(jnp.asarray(table_v), 8),
                               jd.unpack(jnp.asarray(addr_v), 8), jc)
    tout = td.elementwise_load(
        td.unpack(torch.from_numpy(table_v.astype(np.uint8)), 8),
        td.unpack(torch.from_numpy(addr_v.astype(np.uint8)), 8), tc)
    _same(jout, tout)
    np.testing.assert_array_equal(td.pack(tout).numpy(), table_v[addr_v])
    _same_count(jc, tc)


def test_cost_formulas_equal_jax_and_the_counter():
    for bits in (1, 8, 16, 24):
        assert td.add_cost(bits) == jd.add_cost(bits)
        assert td.xor_cost(bits) == jd.xor_cost(bits)
        assert td.mul_cost(bits, 2 * bits) == jd.mul_cost(bits, 2 * bits)
    ctr = td.GateCounter()
    a, b = torch.zeros((8, 4), dtype=torch.bool), torch.ones((8, 4),
                                                             dtype=torch.bool)
    td.add(a, b, ctr)
    assert ctr.nor == td.add_cost(8)
    ctr.reset()
    td.xor_planes(a, b, ctr)
    assert ctr.nor == td.xor_cost(8) and ctr.total == ctr.nor
