"""Public wrapper for the gf2_mvm kernel (the AES linear layer).

``gf2_mvm`` takes any leading dims on x and any K and N, and dispatches
through :mod:`repro_torch.kernels.registry`: CUDA tensors launch the
hand-written kernel (``csrc/gf2_mvm.cu``) and count the launch; CPU
tensors, or an explicit ``torch`` selection, take the plain version
(``ref.py``).  Nothing falls back: a tensor the kernel does not take
raises :class:`KernelTileError`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.gf2_mvm.ref import gf2_mvm_ref
from repro_torch.kernels.registry import KernelBackend, KernelTileError

NAME = "gf2_mvm"                         # backend key and launch counter
# threads per CTA of csrc/gf2_mvm.cu (NVCC_DEFINES gives it this); its
# grid is at most the CTAs the card holds at once, one wave
THREADS = 256
NVCC_DEFINES = dict(THREADS=THREADS)


@functools.cache
def _kernel():
    fn = _build.load("gf2_mvm").gf2_mvm_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x2: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x2: [M, K] int8 CUDA; a: [K, N] int8 on the same card."""
    if a.device != x2.device:
        raise KernelTileError(f"x on {x2.device} but a on {a.device}")
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
    wave = props.sms * (props.max_threads // THREADS)
    status = _kernel()(x2.data_ptr(), a.data_ptr(), out.data_ptr(), m, k, n,
                       wave, torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(status, "gf2_mvm")
    registry.count_launch(NAME)
    return out


def gf2_mvm(x: torch.Tensor, a: torch.Tensor, *,
            backend: KernelBackend | str | None = None) -> torch.Tensor:
    """Parity matmul ``y = (x @ a) & 1``.

    x: [..., K] integer; a: [K, N] integer (the kernel takes int8 and
    reads only each byte's low bit, which is exact for any values).
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
