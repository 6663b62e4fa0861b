"""Public wrapper for the paged-attention kernel, dispatched through
:mod:`repro_torch.kernels.registry`: CUDA tensors launch the
hand-written kernel (``csrc/paged_attention.cu``: a store launch, then
the attention launch, in one call; a window longer than one tile split
over a cluster of CTAs), which updates the pools in place, and count
the call as one launch; CPU tensors, or an explicit
``torch`` selection, take the plain version (``ref.py``).  A tensor the
kernel does not take raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import math
import typing

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.registry import KernelBackend, KernelTileError

NAME = "paged_attention"
_FLOATS = (torch.float32, torch.bfloat16)      # q, k_new, v_new

# what csrc/paged_attention.cu is built for (NVCC_DEFINES gives it the
# ones it needs): WARPS queries a CTA, held in the first rows of its
# MMA_ROWS-row mma tiles; CHUNK keys a tile (a multiple of the mma's
# 16-key steps); rows padded by ROW_PAD bf16 elements (16 bytes:
# conflict-free ldmatrix), a ring of 2 to MAX_STAGES tiles, head dims in
# multiples of 32 up to MAX_HD, a window split over at most MAX_SPLITS
# CTAs (one thread block cluster, 8 the portable limit), grid dims up to
# MAX_GRID
WARPS, CHUNK, ROW_PAD, MMA_ROWS = 8, 128, 8, 16
MAX_STAGES, MAX_SPLITS, MAX_HD = 4, 8, 256
MAX_GRID = 65535
NVCC_DEFINES = dict(MAX_WARPS=WARPS, MMA_ROWS=MMA_ROWS,
                    MAX_STAGES=MAX_STAGES, MAX_HD=MAX_HD)


class SmemLayout(typing.NamedTuple):
    """Where the regions of a CTA's dynamic shared memory sit (byte
    offsets, 16-byte aligned; each warp's p * V parts, f32, from 0)."""
    stats: int           # each warp's (max, sum)
    scores: int          # each warp's keys_per_cta f32 scores
    qhi: int             # the queries: MMA_ROWS bf16 rows, high parts
    qlo: int             # what f32 queries have below bf16, as qhi
    probs: int           # p: MMA_ROWS bf16 rows of prow elements
    tiles: int           # the ring of tiles of bf16 rows
    prow: int            # bf16 elements per row of p
    bytes: int           # in all


class AttnPlan(typing.NamedTuple):
    warps: int           # queries per CTA
    chunk: int           # keys per tile
    row: int             # bf16 elements per staged K or V row
    query_groups: int    # CTAs per (row, KV head) over the S * G queries
    splits: int          # CTAs (one cluster) over the window
    keys_per_cta: int    # score slots per warp
    stages: int          # tiles in the ring
    smem: int            # dynamic shared bytes per CTA
    layout: SmemLayout   # where the kernel puts what in them


def smem_layout(warps: int, hd: int, kpc: int, chunk: int, row: int,
                stages: int) -> SmemLayout:
    """The kernel's CTA's dynamic shared memory: each warp's p * V (f32),
    each warp's (max, sum), each warp's kpc f32 scores, the queries as
    MMA_ROWS bf16 rows twice (high part, and what an f32 query has
    below bf16), p as MMA_ROWS bf16 rows of kpc + ROW_PAD, then the
    ring of tiles of bf16 rows; regions 16-byte aligned."""
    def up16(n: int) -> int:
        return -(-n // 16) * 16
    stats = warps * hd * 4
    scores = up16(stats + warps * 8)
    qhi = up16(scores + warps * kpc * 4)
    qlo = qhi + MMA_ROWS * row * 2
    probs = qlo + MMA_ROWS * row * 2
    prow = kpc + ROW_PAD
    tiles = up16(probs + MMA_ROWS * prow * 2)
    return SmemLayout(stats, scores, qhi, qlo, probs, tiles, prow,
                      tiles + stages * chunk * row * 2)


@functools.lru_cache(maxsize=1024)
def attention_plan(s: int, g: int, hd: int, t: int,
                   props: registry.DeviceProps) -> AttnPlan:
    """The launch for S queries x G heads per (row, KV head) over a
    window of T keys on a card with ``props``: WARPS queries per CTA,
    the window's tiles of CHUNK keys spread over up to MAX_SPLITS CTAs
    of a cluster, as deep a ring as fits (at most one slot per tile)."""
    groups = -(-s * g // WARPS)
    chunks = -(-t // CHUNK)
    splits = min(MAX_SPLITS, chunks)
    kpc = -(-chunks // splits) * CHUNK
    row = hd + ROW_PAD
    stages = min(MAX_STAGES, 2 * kpc // CHUNK)
    while stages > 2 and smem_layout(WARPS, hd, kpc, CHUNK, row,
                                     stages).bytes > props.max_smem:
        stages -= 1
    layout = smem_layout(WARPS, hd, kpc, CHUNK, row, stages)
    smem = layout.bytes
    if smem > props.max_smem:
        raise KernelTileError(
            f"a window of {t} keys needs {smem} shared bytes per CTA, over "
            f"the card's {props.max_smem}")
    if groups > MAX_GRID:
        raise KernelTileError(f"{s * g} queries need {groups} CTAs per "
                              f"(row, head), over the grid's {MAX_GRID}")
    return AttnPlan(WARPS, CHUNK, row, groups, splits, kpc, stages, smem,
                    layout)


@functools.cache
def _kernel():
    fn = _build.load("paged_attention").paged_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 \
        + [ctypes.c_float] * 2 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_new, v_new, k_pool, v_pool, block_table, write_table,
           cache_index) -> None:
    dev = q.device
    for name, t in (("k_new", k_new), ("v_new", v_new), ("k_pool", k_pool),
                    ("v_pool", v_pool), ("block_table", block_table),
                    ("write_table", write_table),
                    ("cache_index", cache_index)):
        if t.device != dev:
            raise KernelTileError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise KernelTileError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise KernelTileError("q must be contiguous")
    if q.dtype not in _FLOATS or k_new.dtype != q.dtype \
            or v_new.dtype != q.dtype:
        raise KernelTileError(f"q/k_new/v_new must share one of {_FLOATS}")
    if k_pool.dtype != torch.bfloat16 or v_pool.dtype != torch.bfloat16:
        raise KernelTileError(f"pools must be bfloat16, got {k_pool.dtype} "
                              f"and {v_pool.dtype}")
    for name, t in (("block_table", block_table),
                    ("write_table", write_table),
                    ("cache_index", cache_index)):
        if t.dtype != torch.int32:
            raise KernelTileError(f"{name} must be int32, got {t.dtype}")
    b, s, kvh, g, hd = q.shape
    if k_new.shape != (b, s, kvh, hd) or v_new.shape != k_new.shape:
        raise KernelTileError(f"k_new/v_new {tuple(k_new.shape)} do not "
                              f"match q {tuple(q.shape)}")
    if k_pool.ndim != 4 or k_pool.shape[2:] != (kvh, hd) \
            or v_pool.shape != k_pool.shape:
        raise KernelTileError(f"pools {tuple(k_pool.shape)} do not match "
                              f"KV={kvh}, hd={hd}")
    if block_table.shape != write_table.shape or block_table.ndim != 2 \
            or block_table.shape[0] != b or cache_index.shape != (b,):
        raise KernelTileError("tables must be [B, W] and cache_index [B]")
    if hd % 32 or hd > MAX_HD:
        raise KernelTileError(f"head_dim {hd}: the kernel takes multiples "
                              f"of 32 up to {MAX_HD}")


def paged_attention(q, k_new, v_new, k_pool, v_pool, block_table,
                    write_table, cache_index, *, kv_len: int | None = None,
                    softcap: float = 0.0,
                    backend: KernelBackend | str | None = None):
    """Paged attention: store this step's K/V through the write table,
    read each row's blocks through the read table, plain-softmax
    attention.

    q: [B,S,KV,G,hd]; k_new/v_new: [B,S,KV,hd]; k_pool/v_pool:
    [NB,bs,KV,hd]; block_table/write_table: [B,W] int32; cache_index:
    [B] int32.  Returns (k_pool, v_pool, out [B,S,KV,G,hd] in the pool
    dtype).  On the kernel the returned pools are the inputs, updated in
    place; the plain version returns new pools."""
    b = registry.resolve_backend(q, backend, kernel=NAME)
    if b == KernelBackend.TORCH:
        return paged_attention_ref(q, k_new, v_new, k_pool, v_pool,
                                   block_table, write_table, cache_index,
                                   kv_len=kv_len, softcap=softcap)
    _check(q, k_new, v_new, k_pool, v_pool, block_table, write_table,
           cache_index)
    bsz, s, kvh, g, hd = q.shape
    bs = k_pool.shape[1]
    w = block_table.shape[1]
    t = w * bs if kv_len is None else min(kv_len, w * bs)
    if t <= 0:
        raise KernelTileError(f"an empty key window (kv_len={kv_len})")
    if bsz * kvh > MAX_GRID:
        raise KernelTileError(f"{bsz} rows x {kvh} KV heads, over the "
                              f"grid's {MAX_GRID}")
    plan = attention_plan(s, g, hd, t, registry.device_props(q.device.index))
    out = torch.empty((bsz, s, kvh, g, hd), dtype=k_pool.dtype,
                      device=q.device)
    status = _kernel()(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), block_table.data_ptr(),
        write_table.data_ptr(), cache_index.data_ptr(), out.data_ptr(),
        bsz, s, kvh, g, hd, bs, w, t, float(softcap), 1.0 / math.sqrt(hd),
        int(q.dtype == torch.bfloat16), plan.warps, plan.chunk, plan.row,
        plan.query_groups, plan.splits, plan.keys_per_cta, plan.stages,
        plan.smem, *plan.layout[:-1],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, NAME)
    registry.count_launch(NAME)
    return k_pool, v_pool, out
