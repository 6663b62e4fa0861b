"""Public wrappers for the bitslice_mvm kernel family.

``bitslice_mvm_planes`` (int32 out; the ``int8`` packed path as one
plane with ``bits_per_slice=8``) and ``bitslice_mvm_planes_scaled``
(the fused ``pum`` decode tile, f32 out) take any leading dims on x,
check what the kernel takes, and dispatch through
:mod:`repro_torch.kernels.registry`: CUDA tensors launch the hand-written
kernel (``csrc/bitslice_mvm.cu``) and count the launch; CPU tensors, or
an explicit ``torch`` selection, take the plain version (``ref.py``).
Nothing falls back: a tensor the kernel does not take raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.bitslice_mvm.ref import (bitslice_mvm_ref,
                                                  bitslice_mvm_scaled_ref)
from repro_torch.kernels.registry import KernelBackend, KernelTileError

KERNEL = "bitslice_mvm"                  # backend selection key
NAME_INT = "bitslice_mvm"                # launch counter: int32 out (K2)
NAME_SCALED = "bitslice_mvm_scaled"      # launch counter: fused scale (K1)


def _kernel():
    fn = _build.load("bitslice_mvm").bitslice_mvm_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(x2: torch.Tensor, planes: torch.Tensor,
                bits_per_slice: int) -> None:
    if planes.device != x2.device:
        raise KernelTileError(f"x on {x2.device} but planes on "
                              f"{planes.device}")
    if planes.dtype != torch.int8 or planes.ndim != 3 \
            or not planes.is_contiguous():
        raise KernelTileError(
            f"planes must be contiguous int8 [S, K, N], got "
            f"{planes.dtype} {tuple(planes.shape)}")
    s, k, n = planes.shape
    if not 1 <= s <= registry.MVM_MAX_SLICES:
        raise KernelTileError(f"{s} planes; the kernel takes 1.."
                              f"{registry.MVM_MAX_SLICES}")
    if n % registry.MVM_VEC_N or planes.data_ptr() % 16:
        raise KernelTileError(
            f"N={n} must be a multiple of {registry.MVM_VEC_N} and the "
            f"planes 16-byte aligned for the kernel's vector loads")
    if x2.shape[1] != k:
        raise KernelTileError(f"x has K={x2.shape[1]}, planes K={k}")
    if bits_per_slice * (s - 1) > 23:
        raise KernelTileError(f"shift {bits_per_slice * (s - 1)} overflows "
                              f"the int32 accumulator")


def _launch(x2: torch.Tensor, planes: torch.Tensor,
            row_scale: torch.Tensor | None, bits_per_slice: int,
            ) -> torch.Tensor:
    """x2: [M, K] int8 CUDA; planes: [S, K, N] int8; row_scale: [M] f32."""
    _check_cuda(x2, planes, bits_per_slice)
    m, k = x2.shape
    s, _, n = planes.shape
    scaled = row_scale is not None
    out = torch.empty((m, n), device=x2.device,
                      dtype=torch.float32 if scaled else torch.int32)
    status = _kernel()(
        x2.data_ptr(), planes.data_ptr(),
        row_scale.data_ptr() if scaled else None, out.data_ptr(),
        m, k, n, s, bits_per_slice, int(scaled),
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(status, "bitslice_mvm")
    registry.count_launch(NAME_SCALED if scaled else NAME_INT)
    return out


def _rows(x_q: torch.Tensor, k: int) -> torch.Tensor:
    x2 = x_q.reshape(-1, k)
    if x2.device.type == "cuda":
        x2 = x2.to(torch.int8).contiguous()
    return x2


def bitslice_mvm_planes(x_q: torch.Tensor, planes: torch.Tensor, *,
                        bits_per_slice: int = 2,
                        backend: KernelBackend | str | None = None,
                        ) -> torch.Tensor:
    """``sum_s (x_q @ planes[s]) << (bits_per_slice * s)``.

    x_q: [..., K] int (int8 range); planes: [S, K, N] int8 differential
    planes (``PackedLinear.planes``, or ``wq[None]`` for int8).
    Returns [..., N] int32."""
    k, n = planes.shape[1], planes.shape[2]
    b = registry.resolve_backend(x_q, backend, kernel=KERNEL)
    x2 = _rows(x_q, k)
    if b == KernelBackend.TORCH:
        out = bitslice_mvm_ref(x2, planes, bits_per_slice=bits_per_slice)
    else:
        out = _launch(x2, planes, None, bits_per_slice)
    return out.reshape(x_q.shape[:-1] + (n,))


def bitslice_mvm_planes_scaled(x_q: torch.Tensor, planes: torch.Tensor,
                               row_scale: torch.Tensor, *,
                               bits_per_slice: int = 2,
                               backend: KernelBackend | str | None = None,
                               ) -> torch.Tensor:
    """The fused decode tile: plane recombination and the per-row
    dequant scale in one kernel.

    x_q: [..., K] int; planes: [S, K, N] int8; row_scale: [..., 1] f32.
    Returns [..., N] f32 == ``(x_q @ w).to(f32) * row_scale``, the
    int32 accumulator never leaving the chip."""
    k, n = planes.shape[1], planes.shape[2]
    b = registry.resolve_backend(x_q, backend, kernel=KERNEL)
    x2 = _rows(x_q, k)
    scale2 = row_scale.reshape(-1, 1).to(torch.float32)
    if scale2.shape[0] != x2.shape[0]:
        raise KernelTileError(f"{scale2.shape[0]} row scales for "
                              f"{x2.shape[0]} rows")
    if b == KernelBackend.TORCH:
        out = bitslice_mvm_scaled_ref(x2, planes, scale2,
                                      bits_per_slice=bits_per_slice)
    else:
        out = _launch(x2, planes, scale2.reshape(-1).contiguous(),
                      bits_per_slice)
    return out.reshape(x_q.shape[:-1] + (n,))
