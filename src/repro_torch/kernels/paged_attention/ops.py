"""Public wrapper for the paged-attention kernel, dispatched through
:mod:`repro_torch.kernels.registry`: CUDA tensors launch the
hand-written kernel (``csrc/paged_attention.cu``: a store launch, then
the attention launch, in one call), which updates the pools in place,
and count the call as one launch; CPU tensors, or an explicit
``torch`` selection, take the plain version (``ref.py``).  A tensor the
kernel does not take raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.registry import KernelBackend, KernelTileError

NAME = "paged_attention"
_FLOATS = (torch.float32, torch.bfloat16)      # q, k_new, v_new


def _kernel():
    fn = _build.load("paged_attention").paged_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 \
        + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
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
    if hd % 32 or hd > 256:
        raise KernelTileError(f"head_dim {hd}: the kernel takes multiples "
                              f"of 32 up to 256")


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
    warps = registry.ATTN_WARPS
    smem = warps * (t + hd) * 4
    if smem > registry.ATTN_MAX_SMEM:
        raise KernelTileError(
            f"{t} keys need {smem} bytes of scores in shared memory, over "
            f"the {registry.ATTN_MAX_SMEM} a CTA may use")
    out = torch.empty((bsz, s, kvh, g, hd), dtype=k_pool.dtype,
                      device=q.device)
    scale = 1.0 / math.sqrt(hd)
    status = _kernel()(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), block_table.data_ptr(),
        write_table.data_ptr(), cache_index.data_ptr(), out.data_ptr(),
        bsz, s, kvh, g, hd, bs, w, t, float(softcap), scale,
        int(q.dtype == torch.bfloat16), warps,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, NAME)
    registry.count_launch(NAME)
    return k_pool, v_pool, out
