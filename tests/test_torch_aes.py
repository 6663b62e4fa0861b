"""The port's AES against the JAX package's on the CPU, bit for bit:
the FIPS-197 vectors through every path, the bulk cipher (GF(2) layer
on the kernel's wrapper and on the plain composition) against JAX's on
random blocks and keys, and the gate-accurate DCE path with equal gate
counts."""
import numpy as np
import pytest
import torch

from repro.apps import aes_app as jaes
from repro.core.digital import GateCounter as JGateCounter
from repro_torch.apps import aes_app as taes
from repro_torch.core.digital import GateCounter
from repro_torch.kernels import registry


def _hex(s: str) -> np.ndarray:
    return np.frombuffer(bytes.fromhex(s), np.uint8).copy()


PT = "00112233445566778899aabbccddeeff"
# FIPS-197 Appendix C.1-C.3 (key, ciphertext of PT) and Appendix B
VECTORS = [
    ("000102030405060708090a0b0c0d0e0f", "69c4e0d86a7b0430d8cdb78070b4c55a",
     PT),
    ("000102030405060708090a0b0c0d0e0f1011121314151617",
     "dda97ca4864cdfe06eaf70a0ec0d7191", PT),
    ("000102030405060708090a0b0c0d0e0f101112131415161718191a1b1c1d1e1f",
     "8ea2b7ca516745bfeafc49904b496089", PT),
    ("2b7e151628aed2a6abf7158809cf4f3c", "3925841d02dc09fbdc118597196a0b32",
     "3243f6a8885a308d313198a2e0370734"),
]
CPU = dict(device="cpu")


def test_tables_and_matrices_equal_jax():
    np.testing.assert_array_equal(taes.SBOX, jaes.SBOX)
    np.testing.assert_array_equal(taes.INV_SBOX, jaes.INV_SBOX)
    for t, j in zip(taes._linear_matrices(), jaes._linear_matrices()):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("key,ct,pt", VECTORS)
def test_fips197_through_every_path(key, ct, pt):
    key, ct, pt = _hex(key), _hex(ct), _hex(pt)
    np.testing.assert_array_equal(taes.key_expansion(key),
                                  jaes.key_expansion(key))
    np.testing.assert_array_equal(taes.aes_encrypt_np(pt, key), ct)
    np.testing.assert_array_equal(taes.aes_decrypt_np(ct, key), pt)
    for use_kernel in (False, True):
        got = taes.aes_encrypt(pt[None], key, use_kernel=use_kernel, **CPU)
        assert got.dtype == torch.uint8 and got.shape == (1, 16)
        np.testing.assert_array_equal(got[0].numpy(), ct)
        back = taes.aes_decrypt(got, key, use_kernel=use_kernel, **CPU)
        np.testing.assert_array_equal(back[0].numpy(), pt)
    ctr = GateCounter()
    np.testing.assert_array_equal(
        taes.aes_encrypt_dce(pt[None], key, ctr, **CPU)[0], ct)
    assert ctr.nor > 0 and ctr.copy > 0


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("klen", [16, 24, 32])
def test_bulk_equals_jax_and_oracle(klen, use_kernel):
    rng = np.random.default_rng(klen + use_kernel)
    pts = rng.integers(0, 256, size=(3, 11, 16), dtype=np.uint8)
    key = rng.integers(0, 256, size=(klen,), dtype=np.uint8)
    want = np.asarray(jaes.aes_encrypt(pts, key, use_kernel=use_kernel))
    registry.reset_launches()
    got = taes.aes_encrypt(torch.from_numpy(pts), key,
                           use_kernel=use_kernel, **CPU)
    assert sum(registry.LAUNCHES.values()) == 0     # CPU: plain versions
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), jaes.aes_encrypt_np(pts, key))
    np.testing.assert_array_equal(taes.aes_encrypt_np(pts, key),
                                  jaes.aes_encrypt_np(pts, key))
    want_back = np.asarray(jaes.aes_decrypt(want, key,
                                            use_kernel=use_kernel))
    back = taes.aes_decrypt(got, key, use_kernel=use_kernel, **CPU)
    np.testing.assert_array_equal(back.numpy(), want_back)
    np.testing.assert_array_equal(back.numpy(), pts)
    np.testing.assert_array_equal(taes.aes_decrypt_np(want, key), pts)


@pytest.mark.parametrize("klen", [16, 32])
def test_dce_path_equals_jax_with_equal_gate_counts(klen):
    rng = np.random.default_rng(klen)
    pts = rng.integers(0, 256, size=(4, 16), dtype=np.uint8)
    key = rng.integers(0, 256, size=(klen,), dtype=np.uint8)
    jc, tc = JGateCounter(), GateCounter()
    want = jaes.aes_encrypt_dce(pts, key, jc)
    got = taes.aes_encrypt_dce(pts, key, tc, **CPU)
    assert got.dtype == np.uint8 and got.shape == (4, 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, taes.aes_encrypt_np(pts, key))
    assert (tc.nor, tc.copy) == (jc.nor, jc.copy)


@pytest.mark.parametrize("klen", [16, 24, 32])
def test_kernel_rounds_call_the_state_byte_entry_once_a_round(
        klen, monkeypatch):
    """``use_kernel`` runs each round's GF(2) layer through K4's
    state-byte entry, Nr times to encrypt and Nr - 1 to decrypt, with no
    bit unpack or pack around it, and still equals JAX's kernel path."""
    rng = np.random.default_rng(100 + klen)
    pts = rng.integers(0, 256, size=(2, 9, 16), dtype=np.uint8)
    key = rng.integers(0, 256, size=(klen,), dtype=np.uint8)
    nr = {16: 10, 24: 12, 32: 14}[klen]
    calls = {"gf2_mvm_packed": 0, "unpack_bits": 0, "pack_bits": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(taes, "gf2_mvm_packed",
                        counted("gf2_mvm_packed", taes.gf2_mvm_packed))
    monkeypatch.setattr(taes, "_unpack_bits",
                        counted("unpack_bits", taes._unpack_bits))
    monkeypatch.setattr(taes, "_pack_bits",
                        counted("pack_bits", taes._pack_bits))
    got = taes.aes_encrypt(torch.from_numpy(pts), key, use_kernel=True,
                           **CPU)
    assert calls == {"gf2_mvm_packed": nr, "unpack_bits": 0, "pack_bits": 0}
    back = taes.aes_decrypt(got, key, use_kernel=True, **CPU)
    assert calls == {"gf2_mvm_packed": 2 * nr - 1, "unpack_bits": 0,
                     "pack_bits": 0}
    want = np.asarray(jaes.aes_encrypt(pts, key, use_kernel=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(back.numpy(), pts)
