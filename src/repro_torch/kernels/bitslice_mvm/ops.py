"""Public wrappers for the bitslice_mvm kernel family.

``bitslice_mvm`` (int32 out from a signed quantised weight, sliced into
planes per call: the raw-weight ``pum`` and ``int8`` forwards),
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
import functools
import typing

import torch

from repro_torch.core import bitslice
from repro_torch.kernels import _build, registry
from repro_torch.kernels.bitslice_mvm.ref import (bitslice_mvm_ref,
                                                  bitslice_mvm_scaled_ref)
from repro_torch.kernels.registry import KernelBackend, KernelTileError

KERNEL = "bitslice_mvm"                  # backend selection key
NAME_INT = "bitslice_mvm"                # launch counter: int32 out (K2)
NAME_SCALED = "bitslice_mvm_scaled"      # launch counter: fused scale (K1)

# what csrc/bitslice_mvm.cu is built for (NVCC_DEFINES gives it these):
# a tile of BN columns and BK K rows a stage, ROW_TILES rows of x, a
# ring of SHALLOW stages (DEEP with one plane, whose stages are small),
# two CTAs per SM (its launch bounds), at most MAX_SLICES planes, N in
# vectors of VEC bytes, at most MAX_GRID_Z CTAs of row tiles (CUDA's
# limit on gridDim.z)
BN, BK, SHALLOW, DEEP = 128, 64, 3, 8
ROW_TILES = (1, 4, 8, 16)
CTAS_PER_SM = 2
MAX_SLICES = 4
VEC = 16
MAX_GRID_Z = 65535
NVCC_DEFINES = dict(BN=BN, BK=BK, VEC=VEC, MAX_S=MAX_SLICES,
                    CTAS_PER_SM=CTAS_PER_SM, SHALLOW=SHALLOW, DEEP=DEEP,
                    MAX_GRID_Z=MAX_GRID_Z,
                    **{f"ROW_TILE{i}": t for i, t in enumerate(ROW_TILES)})
# split-K parts form one thread block cluster of a power of two CTAs,
# at most MAX_SPLITS (over 8 is a non-portable size, which Hopper takes),
# each walking at least MIN_SPLIT_KTILES K tiles
MAX_SPLITS = 16
MIN_SPLIT_KTILES = 4


class MvmPlan(typing.NamedTuple):
    mt: int              # rows of x per CTA
    row_tiles: int
    col_tiles: int
    ktiles: int          # K tiles of BK rows
    splits: int          # parts of the K range: the cluster's CTAs
    stages: int          # cp.async ring depth
    smem: int            # dynamic shared bytes (the ring)
    grid_rows: int       # CTAs along the rows (grid z), each walking
    #                      row tiles grid_rows apart


@functools.lru_cache(maxsize=1024)
def mvm_plan(m: int, k: int, n: int, s: int,
             props: registry.DeviceProps) -> MvmPlan:
    """The launch of an [m, k] x [s, k, n] product on a card with
    ``props``: the least row tile that holds m, and, where the output
    tiles alone leave SMs idle, as many K splits as still fit in one wave
    of two CTAs per SM (a second, partial wave would leave most SMs idle
    while it runs), each at least MIN_SPLIT_KTILES K tiles.  The splits
    of a tile form one cluster, whose CTAs the card places in one GPC;
    a power of two of them packs a GPC's CTA slots (two per SM, 16 or
    18 SMs) without a remainder, where 3 of them left the last clusters
    of 2048 x 11008 a second wave on an H100.

    Row tiles go on grid z, which CUDA caps at MAX_GRID_Z = 65535 CTAs:
    16 x 65535 = 1 048 560 rows, one tile short of a ResNet-20 stage-0
    conv over 1024 images (1024 x 32 x 32 rows).  So the kernel walks its
    row tiles in a grid-stride loop over blockIdx.z, and the plan puts
    min(row_tiles, MAX_GRID_Z) CTAs there: one launch takes any M that
    fits memory, where splitting M into several launches would make the
    launch count of a forward depend on the batch.  Every plan with at
    most MAX_GRID_Z row tiles (every decode and prefill shape) has
    grid_rows == row_tiles, one tile a CTA, as before; the walk is a
    kernel instantiation of its own, which only plans with fewer CTAs
    than tiles launch."""
    mt = next((t for t in ROW_TILES if t >= m), ROW_TILES[-1])
    row_tiles = -(-m // mt)
    col_tiles = -(-n // BN)
    ktiles = -(-k // BK)
    wave = CTAS_PER_SM * props.sms
    most = min(MAX_SPLITS, ktiles // MIN_SPLIT_KTILES,
               wave // (row_tiles * col_tiles))
    splits = 1 << (max(1, most).bit_length() - 1)
    stages = DEEP if s == 1 else SHALLOW
    smem = stages * (s * BK * BN + mt * BK)
    static = 4 * mt * BN                 # the kernel's int32 tile sums
    if smem + static > props.max_smem:
        raise KernelTileError(f"{smem + static} shared bytes for {s} planes "
                              f"at {mt} rows, over the card's "
                              f"{props.max_smem}")
    return MvmPlan(mt, row_tiles, col_tiles, ktiles, splits, stages, smem,
                   min(row_tiles, MAX_GRID_Z))


@functools.cache
def _kernel():
    fn = _build.load("bitslice_mvm").bitslice_mvm_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 \
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
    if not 1 <= s <= MAX_SLICES:
        raise KernelTileError(f"{s} planes; the kernel takes 1..{MAX_SLICES}")
    if n % VEC or planes.data_ptr() % VEC:
        raise KernelTileError(
            f"N={n} must be a multiple of {VEC} and the planes {VEC}-byte "
            f"aligned for the kernel's vector loads")
    if x2.shape[1] != k:
        raise KernelTileError(f"x has K={x2.shape[1]}, planes K={k}")
    if bits_per_slice * (s - 1) > 23:
        raise KernelTileError(f"shift {bits_per_slice * (s - 1)} overflows "
                              f"the int32 accumulator")


def _launch(x2: torch.Tensor, planes: torch.Tensor,
            row_scale: torch.Tensor | None, bits_per_slice: int,
            ) -> torch.Tensor:
    """x2: [M, K] int8 CUDA; planes: [S, K, N] int8; row_scale: [M] f32.

    Keeps nothing between calls: the split-K parts meet in the CTAs'
    shared memory, so calls on any streams are independent."""
    _check_cuda(x2, planes, bits_per_slice)
    m, k = x2.shape
    s, _, n = planes.shape
    if k % VEC or x2.data_ptr() % VEC:
        # rows staged by 16-byte copies: pad them with zeros
        xp = torch.zeros((m, -(-k // VEC) * VEC), dtype=torch.int8,
                         device=x2.device)
        xp[:, :k] = x2
        x2 = xp
    plan = mvm_plan(m, k, n, s, registry.device_props(x2.device.index))
    scaled = row_scale is not None
    out = torch.empty((m, n), device=x2.device,
                      dtype=torch.float32 if scaled else torch.int32)
    status = _kernel()(
        x2.data_ptr(), planes.data_ptr(),
        row_scale.data_ptr() if scaled else None, out.data_ptr(),
        m, k, n, x2.shape[1], s, bits_per_slice, plan.mt, plan.stages,
        plan.splits, plan.grid_rows, plan.smem, int(scaled),
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(status, "bitslice_mvm")
    registry.count_launch(NAME_SCALED if scaled else NAME_INT)
    return out


def _padded(planes: torch.Tensor) -> torch.Tensor:
    """The planes with N padded by zero columns up to a multiple of VEC,
    as the kernel reads N in 16-byte vectors (the JAX package pads the
    planes to its block in every entry, ``ops._run``); the caller cuts
    the output back to N.  A no-op where N is a multiple already."""
    pad = -planes.shape[2] % VEC
    if pad:
        planes = torch.nn.functional.pad(planes, (0, pad))
    return planes.contiguous()


def _rows(x_q: torch.Tensor, k: int) -> torch.Tensor:
    x2 = x_q.reshape(-1, k)
    if x2.device.type == "cuda":
        x2 = x2.to(torch.int8).contiguous()
    return x2


def bitslice_mvm(x_q: torch.Tensor, w_q: torch.Tensor, *,
                 weight_bits: int = 8, bits_per_slice: int = 2,
                 backend: KernelBackend | str | None = None,
                 ) -> torch.Tensor:
    """``x_q @ w_q`` through the bit-sliced kernel, slicing the planes
    per call (the raw-weight forwards).

    x_q: [..., K] int (int8 range); w_q: [K, N] int, signed in
    ``weight_bits``.  Returns [..., N] int32.  The kernel reads N in
    16-byte vectors, so the planes' N is padded with zero columns up to
    a multiple of VEC and the output cut back, as the JAX package pads
    the planes to its block (``ops._run``); the plain version takes the
    same planes unpadded."""
    k, n = w_q.shape
    if x_q.shape[-1] != k:
        raise KernelTileError(f"x has K={x_q.shape[-1]}, the weight K={k}")
    b = registry.resolve_backend(x_q, backend, kernel=KERNEL)
    planes = bitslice.slice_planes_signed(w_q, weight_bits,
                                          bits_per_slice).to(torch.int8)
    x2 = _rows(x_q, k)
    if b == KernelBackend.TORCH:
        out = bitslice_mvm_ref(x2, planes, bits_per_slice=bits_per_slice)
    else:
        out = _launch(x2, _padded(planes), None, bits_per_slice)[:, :n]
    return out.reshape(x_q.shape[:-1] + (n,))


def bitslice_mvm_planes(x_q: torch.Tensor, planes: torch.Tensor, *,
                        bits_per_slice: int = 2,
                        backend: KernelBackend | str | None = None,
                        ) -> torch.Tensor:
    """``sum_s (x_q @ planes[s]) << (bits_per_slice * s)``.

    x_q: [..., K] int (int8 range); planes: [S, K, N] int8 differential
    planes (``PackedLinear.planes``, or ``wq[None]`` for int8).
    Returns [..., N] int32.  On the kernel, N is padded as in
    :func:`bitslice_mvm` (mLSTM's gates have N = heads = 4)."""
    k, n = planes.shape[1], planes.shape[2]
    b = registry.resolve_backend(x_q, backend, kernel=KERNEL)
    x2 = _rows(x_q, k)
    if b == KernelBackend.TORCH:
        out = bitslice_mvm_ref(x2, planes, bits_per_slice=bits_per_slice)
    else:
        out = _launch(x2, _padded(planes), None, bits_per_slice)[:, :n]
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
    int32 accumulator never leaving the chip.  N is padded on the kernel
    as in :func:`bitslice_mvm_planes`."""
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
        out = _launch(x2, _padded(planes), scale2.reshape(-1).contiguous(),
                      bits_per_slice)[:, :n]
    return out.reshape(x_q.shape[:-1] + (n,))
