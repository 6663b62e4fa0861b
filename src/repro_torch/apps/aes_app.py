"""AES on DARTH-PUM (paper §5.3, Fig. 12), in PyTorch.

Mapping (paper Fig. 12): SubBytes (1), ShiftRows (2) and AddRoundKey (4)
run in the DCE; MixColumns (3) runs in the ACE as a binary MVM with
1-bit cells whose ADCs read only the low bits ahead of the XOR.

ShiftRows ∘ MixColumns is GF(2)-*linear* on the whole 128-bit state, so
one 128x128 binary matrix ``M_LIN`` (built from the AES definition)
implements both steps as a single parity MVM, executed by K4's
state-byte entry ``gf2_mvm_packed`` (the MVM on the state's bits, its
parity epilogue the 1-bit ADC read-out), which takes and returns the
state bytes.
SubBytes is the paper's element-wise load against an S-box pipeline;
AddRoundKey is a DCE XOR.

Three execution paths, all validated against FIPS-197 vectors, as in
the JAX package's ``apps/aes_app.py``:
  * ``aes_encrypt`` / ``aes_decrypt``: bulk, vectorised over blocks on
    one device (the card unless the caller asks for the CPU), the GF(2)
    layer on K4 when ``use_kernel``;
  * ``aes_encrypt_dce``: gate-accurate, every step through the NOR-only
    DCE simulator (bit planes), with gate counts;
  * ``aes_encrypt_np`` / ``aes_decrypt_np``: the plain numpy oracle.

Key expansion for AES-128/192/256 (10/12/14 rounds).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.config import ADCConfig, NoiseConfig
from repro_torch.core import analog, digital
from repro_torch.device import resolve_device
from repro_torch.kernels.gf2_mvm import gf2_mvm_packed, gf2_mvm_packed_ref
from repro_torch.kernels.gf2_mvm import pack_bits as _pack_bits
from repro_torch.kernels.gf2_mvm import unpack_bits as _unpack_bits

# ---------------------------------------------------------------------------
# GF(2^8) arithmetic + S-box construction (no magic tables: derived)
# ---------------------------------------------------------------------------


def _xtime(a: int) -> int:
    a <<= 1
    if a & 0x100:
        a ^= 0x11B
    return a & 0xFF


def _gmul(a: int, b: int) -> int:
    p = 0
    for _ in range(8):
        if b & 1:
            p ^= a
        b >>= 1
        a = _xtime(a)
    return p


def _build_sbox() -> tuple[np.ndarray, np.ndarray]:
    # multiplicative inverse in GF(2^8) + affine transform (FIPS-197 §5.1.1)
    inv = np.zeros(256, np.uint8)
    for x in range(1, 256):
        for y in range(1, 256):
            if _gmul(x, y) == 1:
                inv[x] = y
                break
    sbox = np.zeros(256, np.uint8)
    for x in range(256):
        b = inv[x]
        res = 0
        for i in range(8):
            bit = ((b >> i) ^ (b >> ((i + 4) % 8)) ^ (b >> ((i + 5) % 8))
                   ^ (b >> ((i + 6) % 8)) ^ (b >> ((i + 7) % 8))
                   ^ (0x63 >> i)) & 1
            res |= bit << i
        sbox[x] = res
    inv_sbox = np.zeros(256, np.uint8)
    inv_sbox[sbox] = np.arange(256, dtype=np.uint8)
    return sbox, inv_sbox


SBOX, INV_SBOX = _build_sbox()

# ShiftRows permutation: state[r + 4c] -> state[r + 4((c + r) % 4)]
_SHIFT_PERM = np.array([(r + 4 * ((c + r) % 4))
                        for c in range(4) for r in range(4)], np.int32)
_INV_SHIFT_PERM = np.argsort(_SHIFT_PERM).astype(np.int32)

_MIX_MAT = np.array([[2, 3, 1, 1], [1, 2, 3, 1], [1, 1, 2, 3], [3, 1, 1, 2]],
                    np.uint8)
_INV_MIX_MAT = np.array([[14, 11, 13, 9], [9, 14, 11, 13],
                         [13, 9, 14, 11], [11, 13, 9, 14]], np.uint8)


def _mix_columns_np(state: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """state: [..., 16] uint8 column-major (byte i = row i%4, col i//4)."""
    out = np.zeros_like(state)
    for c in range(4):
        col = state[..., 4 * c:4 * c + 4]
        for r in range(4):
            acc = np.zeros(state.shape[:-1], np.uint8)
            for k in range(4):
                gm = np.array([_gmul(int(mat[r, k]), v) for v in range(256)],
                              np.uint8)
                acc ^= gm[col[..., k]]
            out[..., 4 * c + r] = acc
    return out


# ---------------------------------------------------------------------------
# GF(2)-linear layer matrices (the ACE-resident binary matrices)
# ---------------------------------------------------------------------------

def _bytes_to_bits(b: np.ndarray) -> np.ndarray:
    """[..., 16] uint8 -> [..., 128] bits (byte-major, LSB-first)."""
    return np.unpackbits(b[..., None], axis=-1,
                         bitorder="little").reshape(b.shape[:-1] + (128,))


@functools.lru_cache(maxsize=None)
def _linear_matrices() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build the 128x128 GF(2) matrices by probing basis vectors:
       M_LIN     = MixColumns ∘ ShiftRows   (encrypt rounds 1..Nr-1)
       M_SHIFT   = ShiftRows                (final round)
       M_INV_MIX = InvMixColumns            (decrypt rounds)
    Row-vector convention: bits_out = bits_in @ M (mod 2).  The 128
    basis states go through each map as one batch.
    """
    i = np.arange(128)
    basis = np.zeros((128, 16), np.uint8)
    basis[i, i // 8] = 1 << (i % 8)

    def probe(fn):
        return _bytes_to_bits(fn(basis))

    m_lin = probe(lambda s: _mix_columns_np(s[..., _SHIFT_PERM], _MIX_MAT))
    m_shift = probe(lambda s: s[..., _SHIFT_PERM])
    m_invmix = probe(lambda s: _mix_columns_np(s, _INV_MIX_MAT))
    return m_lin, m_shift, m_invmix


# ---------------------------------------------------------------------------
# Key expansion (FIPS-197 §5.2) — pure numpy, per key
# ---------------------------------------------------------------------------

def key_expansion(key: np.ndarray) -> np.ndarray:
    """key: [16|24|32] uint8 -> round keys [(rounds+1), 16] uint8."""
    key = np.asarray(key, np.uint8)
    nk = len(key) // 4
    rounds = {4: 10, 6: 12, 8: 14}[nk]
    nwords = 4 * (rounds + 1)
    w = np.zeros((nwords, 4), np.uint8)
    w[:nk] = key.reshape(nk, 4)
    rcon = 1
    for i in range(nk, nwords):
        t = w[i - 1].copy()
        if i % nk == 0:
            t = np.roll(t, -1)
            t = SBOX[t]
            t[0] ^= rcon
            rcon = _xtime(rcon)
        elif nk > 6 and i % nk == 4:
            t = SBOX[t]
        w[i] = w[i - nk] ^ t
    return w.reshape(rounds + 1, 16)


# ---------------------------------------------------------------------------
# Numpy reference cipher (oracle)
# ---------------------------------------------------------------------------

def aes_encrypt_np(pt: np.ndarray, key: np.ndarray) -> np.ndarray:
    rk = key_expansion(key)
    rounds = rk.shape[0] - 1
    s = np.asarray(pt, np.uint8) ^ rk[0]
    for r in range(1, rounds):
        s = SBOX[s]
        s = s[..., _SHIFT_PERM]
        s = _mix_columns_np(s, _MIX_MAT)
        s ^= rk[r]
    s = SBOX[s]
    s = s[..., _SHIFT_PERM]
    return s ^ rk[rounds]


def aes_decrypt_np(ct: np.ndarray, key: np.ndarray) -> np.ndarray:
    rk = key_expansion(key)
    rounds = rk.shape[0] - 1
    s = np.asarray(ct, np.uint8) ^ rk[rounds]
    for r in range(rounds - 1, 0, -1):
        s = s[..., _INV_SHIFT_PERM]
        s = INV_SBOX[s]
        s ^= rk[r]
        s = _mix_columns_np(s, _INV_MIX_MAT)
    s = s[..., _INV_SHIFT_PERM]
    s = INV_SBOX[s]
    return s ^ rk[0]


# ---------------------------------------------------------------------------
# Bulk cipher (the DARTH-PUM mapping, vectorised over blocks)
# ---------------------------------------------------------------------------

def _gf2_apply(s: torch.Tensor, mat: torch.Tensor,
               use_kernel: bool) -> torch.Tensor:
    """The ACE's binary MVM on [..., 16] state bytes: K4's state-byte
    entry, or without ``use_kernel`` the plain composition."""
    if use_kernel:
        return gf2_mvm_packed(s, mat)
    return gf2_mvm_packed_ref(s, mat)


def _state(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.uint8)
    return torch.as_tensor(np.asarray(x, np.uint8), device=dev)


def _consts(key, dev: torch.device):
    rks = torch.as_tensor(key_expansion(np.asarray(key)), device=dev)
    return rks, [torch.as_tensor(m, dtype=torch.int8, device=dev)
                 for m in _linear_matrices()]


def aes_encrypt(pt, key, *, use_kernel: bool = False,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """Encrypt a batch of 16-byte blocks. pt: [..., 16] uint8 (numpy or
    torch); returns uint8 on ``device``.  The rounds are a Python loop
    over round keys kept on the device: no host sync inside.
    ``use_kernel`` runs the GF(2) layer on K4's state-byte entry."""
    dev = resolve_device(device)
    rks, (m_lin, m_shift, _) = _consts(key, dev)
    sbox = torch.as_tensor(SBOX, device=dev)
    rounds = rks.shape[0] - 1
    s = _state(pt, dev) ^ rks[0]
    for r in range(1, rounds):
        s = sbox[s.long()]                            # DCE element-wise load
        s = _gf2_apply(s, m_lin, use_kernel)          # ACE: ShiftRows∘MixCols
        s = s ^ rks[r]                                # DCE XOR
    s = sbox[s.long()]
    return _gf2_apply(s, m_shift, use_kernel) ^ rks[rounds]


def aes_decrypt(ct, key, *, use_kernel: bool = False,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """Decrypt a batch of 16-byte blocks (the inverse of ``aes_encrypt``;
    ``use_kernel`` runs the GF(2) layer on K4's state-byte entry)."""
    dev = resolve_device(device)
    rks, (_, _, m_invmix) = _consts(key, dev)
    inv_sbox = torch.as_tensor(INV_SBOX, device=dev)
    inv_perm = torch.as_tensor(_INV_SHIFT_PERM, dtype=torch.long, device=dev)
    rounds = rks.shape[0] - 1
    s = _state(ct, dev) ^ rks[rounds]
    for i in range(rounds - 1):
        r = rounds - 1 - i
        s = inv_sbox[s[..., inv_perm].long()]
        s = s ^ rks[r]
        s = _gf2_apply(s, m_invmix, use_kernel)
    s = inv_sbox[s[..., inv_perm].long()]
    return s ^ rks[0]


# ---------------------------------------------------------------------------
# Gate-accurate DCE path (bit planes through the NOR simulator)
# ---------------------------------------------------------------------------

def aes_encrypt_dce(pt: np.ndarray, key: np.ndarray,
                    ctr: digital.GateCounter | None = None, *,
                    device: str | torch.device = "cuda") -> np.ndarray:
    """Every step through the DCE bit-plane simulator (rows = bytes of a
    batch of states; one vector register holds the whole batch's byte
    i).  Full in-memory execution + gate accounting; MixColumns uses the
    compensated ACE binary MVM (exact under the modelled noise).
    Returns numpy uint8 [B, 16]."""
    dev = resolve_device(device)
    ctr = ctr or digital.GateCounter()
    pt = np.asarray(pt, np.uint8).reshape(-1, 16)
    n_blocks = pt.shape[0]
    rk = key_expansion(key)
    rounds = rk.shape[0] - 1
    m_lin, m_shift, _ = (torch.as_tensor(m, dtype=torch.int32, device=dev)
                         for m in _linear_matrices())
    sbox_planes = digital.unpack(torch.as_tensor(SBOX, device=dev), 8)
    rk_dev = torch.as_tensor(rk, device=dev)

    state = digital.unpack(torch.as_tensor(pt.T.copy(), device=dev), 8)

    def add_round_key(state, r):
        rk_planes = digital.unpack(
            rk_dev[r][:, None].expand(16, n_blocks), 8)
        return digital.xor_planes(state, rk_planes, ctr)

    def sub_bytes(state):
        flat = state.reshape(8, -1)
        out = digital.elementwise_load(sbox_planes, flat, ctr)
        return out.reshape(state.shape)

    def linear(state, mat):
        # ACE: binary MVM with parasitic compensation; bits [B, 128]
        by = digital.pack(state).to(torch.uint8)               # [16, B]
        bits = _unpack_bits(by.T).to(torch.int32)              # [B, 128]
        # ir_alpha at the paper's operating point: the remapped rails
        # carry <= 64 half-unit cells -> droop 5e-5*64^2 = 0.2 < 1/2 LSB
        # (exact), while the naive mapping's full-unit rail (<= 128)
        # would droop 0.82 and mis-read.
        out = analog.compensated_binary_mvm(
            bits, mat, noise=NoiseConfig(enable=True, ir_alpha=5e-5),
            adc=ADCConfig("ramp", bits=8, early_levels=0)) & 1
        nb = _pack_bits(out)                                   # [B, 16]
        return digital.unpack(nb.T, 8)

    state = add_round_key(state, 0)
    for r in range(1, rounds):
        state = sub_bytes(state)
        state = linear(state, m_lin)
        state = add_round_key(state, r)
    state = sub_bytes(state)
    state = linear(state, m_shift)
    state = add_round_key(state, rounds)
    return digital.pack(state).to(torch.uint8).T.cpu().numpy().reshape(-1, 16)
