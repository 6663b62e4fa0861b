"""Public wrappers for the gf2_mvm kernels (the AES linear layer).

``gf2_mvm`` (the int8 entry, the TPU kernel's counterpart) takes any
leading dims on x and any K and N; ``gf2_mvm_packed`` (the state-byte
entry of the AES rounds) takes [..., 16] uint8 states and the 128x128
matrix.  Both dispatch through :mod:`repro_torch.kernels.registry`: CUDA
tensors launch the hand-written kernels (``csrc/gf2_mvm.cu``) and count
the launch, each under its own name; CPU tensors, or an explicit
``torch`` selection, take the plain versions (``ref.py``).  Nothing
falls back: a tensor a kernel does not take raises
:class:`KernelTileError`.
"""
from __future__ import annotations

import ctypes
import functools
import typing

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.gf2_mvm.ref import gf2_mvm_packed_ref, gf2_mvm_ref
from repro_torch.kernels.registry import KernelBackend, KernelTileError

NAME = "gf2_mvm"                         # int8 entry: backend key, counter
PACKED_NAME = "gf2_mvm_packed"           # state-byte entry: the same

# what the launch plan shares with csrc/gf2_mvm.cu (NVCC_DEFINES gives
# it these): the tensor-core kernel's tiles of TILE_M rows x TILE_N
# columns, staged rows padded by ROW_PAD bytes, a ring of 2 or MAX_STAGES
# row tiles, for K up to MAX_MMA_K (the long-K kernel beyond)
TILE_M, TILE_N, ROW_PAD = 128, 128, 16
MAX_STAGES, MAX_MMA_K = 3, 512
NVCC_DEFINES = dict(TILE_M=TILE_M, TILE_N=TILE_N, ROW_PAD=ROW_PAD,
                    MAX_STAGES=MAX_STAGES, MAX_MMA_K=MAX_MMA_K)
STATE_BYTES = 16                         # the state-byte entry's rows


class Gf2Plan(typing.NamedTuple):
    """The int8 entry's launch (all zero for the long-K kernel)."""
    stages: int          # x tiles in the ring
    row: int             # bytes per staged row of x and of a's transpose
    a_off: int           # byte offset of a's transposed column tile
    out_off: int         # byte offset of the staged output tile
    smem: int            # dynamic shared bytes per CTA


@functools.lru_cache(maxsize=1024)
def gf2_plan(k: int, props: registry.DeviceProps) -> Gf2Plan:
    """The shared-memory layout of the tensor-core kernel for depth K on
    a card with ``props``: the ring of row tiles, a's transposed tile and
    the output tile, each row padded so fragment loads miss no bank; as
    deep a ring as fits.  K > MAX_MMA_K takes the long-K kernel."""
    if k > MAX_MMA_K:
        return Gf2Plan(0, 0, 0, 0, 0)
    row = -(-k // 32) * 32 + ROW_PAD
    for stages in (MAX_STAGES, 2):
        a_off = stages * TILE_M * row
        out_off = a_off + TILE_N * row
        smem = out_off + TILE_M * (TILE_N + ROW_PAD)
        if smem <= props.max_smem:
            return Gf2Plan(stages, row, a_off, out_off, smem)
    raise KernelTileError(f"K={k} needs {smem} shared bytes per CTA, over "
                          f"the card's {props.max_smem}")


@functools.cache
def _kernels():
    lib = _build.load("gf2_mvm")
    mvm = lib.gf2_mvm_launch
    mvm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    mvm.restype = ctypes.c_int
    packed = lib.gf2_mvm_packed_launch
    packed.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
    packed.restype = ctypes.c_int
    return mvm, packed


def _same_card(x: torch.Tensor, a: torch.Tensor) -> None:
    if a.device != x.device:
        raise KernelTileError(f"x on {x.device} but a on {a.device}")


def _launch(x2: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x2: [M, K] int8 CUDA; a: [K, N] int8 on the same card."""
    _same_card(x2, a)
    if x2.dtype != torch.int8 or a.dtype != torch.int8:
        raise KernelTileError(f"the gf2_mvm kernel takes int8 x and a, got "
                              f"{x2.dtype} and {a.dtype}")
    m, k = x2.shape
    n = a.shape[1]
    x2, a = x2.contiguous(), a.contiguous()
    out = torch.empty((m, n), device=x2.device, dtype=torch.int8)
    if m == 0 or n == 0:
        return out
    props = registry.device_props(x2.device.index)
    plan = gf2_plan(k, props)
    status = _kernels()[0](x2.data_ptr(), a.data_ptr(), out.data_ptr(), m, k,
                           n, props.sms, *plan,
                           torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(status, NAME)
    registry.count_launch(NAME)
    return out


def _launch_packed(s2: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """s2: [R, 16] uint8 CUDA; a: [128, 128] int8 on the same card."""
    _same_card(s2, a)
    if s2.dtype != torch.uint8 or a.dtype != torch.int8:
        raise KernelTileError(f"the gf2_mvm_packed kernel takes uint8 states "
                              f"and an int8 matrix, got {s2.dtype} and "
                              f"{a.dtype}")
    s2, a = s2.contiguous(), a.contiguous()
    if s2.data_ptr() % 16:
        s2 = s2.clone()                   # rows are read as 16-byte vectors
    out = torch.empty_like(s2)
    if s2.shape[0] == 0:
        return out
    props = registry.device_props(s2.device.index)
    status = _kernels()[1](s2.data_ptr(), a.data_ptr(), out.data_ptr(),
                           s2.shape[0], props.sms,
                           torch.cuda.current_stream(s2.device).cuda_stream)
    _build.check(status, PACKED_NAME)
    registry.count_launch(PACKED_NAME)
    return out


def gf2_mvm(x: torch.Tensor, a: torch.Tensor, *,
            backend: KernelBackend | str | None = None) -> torch.Tensor:
    """Parity matmul ``y = (x @ a) & 1``.

    x: [..., K] integer; a: [K, N] integer (the kernel takes int8 and
    reads only each product's low bit, which is exact for any values).
    Returns [..., N] int8 in {0, 1}."""
    if a.ndim != 2 or x.shape[-1] != a.shape[0]:
        raise KernelTileError(f"x {tuple(x.shape)} and a {tuple(a.shape)} "
                              f"do not contract")
    k, n = a.shape
    b = registry.resolve_backend(x, backend, kernel=NAME)
    x2 = x.reshape(-1, k)
    if b == KernelBackend.TORCH:
        out = gf2_mvm_ref(x2, a)
    else:
        out = _launch(x2, a)
    return out.reshape(x.shape[:-1] + (n,))


def gf2_mvm_packed(s: torch.Tensor, a: torch.Tensor, *,
                   backend: KernelBackend | str | None = None
                   ) -> torch.Tensor:
    """The GF(2) MVM on state bytes: ``pack(unpack(s) @ a & 1)``.

    s: [..., 16] uint8, each row 128 bits, byte-major and LSB-first; a:
    [128, 128] integer (the kernel takes int8 and reads each entry's low
    bit).  Returns [..., 16] uint8."""
    width = 8 * STATE_BYTES
    if tuple(a.shape) != (width, width) or s.shape[-1] != STATE_BYTES:
        raise KernelTileError(f"gf2_mvm_packed takes [..., {STATE_BYTES}] "
                              f"states and a {width}x{width} matrix, got "
                              f"{tuple(s.shape)} and {tuple(a.shape)}")
    b = registry.resolve_backend(s, backend, kernel=PACKED_NAME)
    s2 = s.reshape(-1, STATE_BYTES)
    if b == KernelBackend.TORCH:
        out = gf2_mvm_packed_ref(s2, a)
    else:
        out = _launch_packed(s2, a)
    return out.reshape(s.shape)
