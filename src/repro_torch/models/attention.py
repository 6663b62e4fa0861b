"""GQA attention with RoPE, optional QKV bias and a KV cache: the
contiguous per-slot cache (the solo oracle's) and the paged block pool
(the scheduler's).

The score/value products are dynamic: per the paper's §5.2 mapping they
never route through the PUM path — only the Q/K/V/O projections do.
The paged branch runs the ``paged_attention`` kernel on CUDA tensors
for chunks of up to ``_KERNEL_MAX_S`` tokens, and the composition below
otherwise; the composition updates the pools in place, as the kernel
does.  Online-softmax (chunked) attention for prompts over
``2 * CHUNK_Q`` tokens and cross-attention are not ported yet.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import registry
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import (causal_mask,
                                                     gather_rows,
                                                     paged_write_cells,
                                                     plain_attention)
from repro_torch.kernels.registry import KernelBackend
from repro_torch.models import layers

Params = dict[str, Any]

CHUNK_Q = 1024

# The kernel keeps one f32 score row per query in shared memory; decode
# (S=1) and chunk-prefill steps qualify, longer monolithic prefills stay
# on the composition.
_KERNEL_MAX_S = 64

__all__ = ["init_attention", "make_cache", "make_paged_cache",
           "paged_write_cells", "attention", "apply_rope_gqa"]


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   device: torch.device | str = "cpu") -> Params:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    return {
        "wq": layers.linear_init(gen, d, cfg.num_heads * hd, cfg.qkv_bias,
                                 device=device),
        "wk": layers.linear_init(gen, d, cfg.num_kv_heads * hd,
                                 cfg.qkv_bias, device=device),
        "wv": layers.linear_init(gen, d, cfg.num_kv_heads * hd,
                                 cfg.qkv_bias, device=device),
        "wo": layers.linear_init(gen, cfg.num_heads * hd, d, device=device),
    }


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device: torch.device | str = "cpu",
               ) -> Params:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def make_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16,
                     device: torch.device | str = "cpu") -> Params:
    """One shared pool of KV blocks; ``num_blocks`` counts physical
    blocks including the reserved trash block 0."""
    shape = (num_blocks, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k_pool": torch.zeros(shape, dtype=dtype, device=device),
            "v_pool": torch.zeros(shape, dtype=dtype, device=device)}


def _paged_update_and_gather(cache: Params, k: torch.Tensor,
                             v: torch.Tensor, block_table: torch.Tensor,
                             cache_index: torch.Tensor, kv_len: int | None,
                             write_table: torch.Tensor | None = None):
    """Scatter this step's K/V through the write table into the pool (in
    place), then gather each row's logical view through the read table,
    cropped to ``kv_len``.  Returns (k_all, v_all), [B, T, KV, hd]."""
    if write_table is None:
        write_table = block_table
    phys, off = paged_write_cells(write_table, cache_index, k.shape[1],
                                  cache["k_pool"].shape[1])
    cache["k_pool"][phys, off] = k.to(cache["k_pool"].dtype)
    cache["v_pool"][phys, off] = v.to(cache["v_pool"].dtype)
    return (gather_rows(cache["k_pool"], block_table, kv_len),
            gather_rows(cache["v_pool"], block_table, kv_len))


def _write_contiguous(c: torch.Tensor, new: torch.Tensor,
                      cache_index: torch.Tensor) -> None:
    """Write ``new`` [B, S, ...] at ``cache_index`` (scalar or [B]) of a
    [B, max_len, ...] cache in place; the start is clamped into the
    window, as ``dynamic_update_slice`` does."""
    b, s = new.shape[:2]
    start = torch.clamp(cache_index.to(torch.int64), 0, c.shape[1] - s)
    if start.ndim == 0:
        start = start.expand(b)
    cols = start[:, None] + torch.arange(s, device=c.device)[None, :]
    rows = torch.arange(b, device=c.device)[:, None]
    c[rows, cols] = new.to(c.dtype)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor,
              cache: Params | None = None,
              cache_index: torch.Tensor | None = None,
              use_rope: bool = True,
              block_table: torch.Tensor | None = None,
              kv_len: int | None = None,
              write_table: torch.Tensor | None = None,
              ) -> tuple[torch.Tensor, Params | None]:
    """x: [B, S, D].  Modes: causal self-attention (cache None); decode /
    prefill into a contiguous cache (``k``/``v``; cache_index a scalar or
    [B]); paged (``k_pool``/``v_pool`` with ``block_table`` [B, W],
    cache_index [B]).  Caches are updated in place and returned."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    kvh = cfg.num_kv_heads
    g = cfg.num_heads // kvh
    pum = cfg.pum
    if pum.ibert:
        raise NotImplementedError("I-BERT integer softmax is not ported")
    if s > 2 * CHUNK_Q:
        raise NotImplementedError(
            f"{s} tokens at once need the online-softmax path, not ported "
            f"yet; stream the prompt in chunks (chunked prefill)")

    q = layers.linear(p["wq"], x, pum).reshape(b, s, kvh, g, hd)
    k = layers.linear(p["wk"], x, pum).reshape(b, s, kvh, hd)
    v = layers.linear(p["wv"], x, pum).reshape(b, s, kvh, hd)
    if use_rope:
        cos, sin = layers.rope_tables(positions, hd, cfg.rope_theta)
        q = apply_rope_gqa(q, cos, sin)
        k = layers.apply_rope(k, cos, sin)

    softcap = cfg.attn_logit_softcap
    if cache is not None and "k_pool" in cache:
        cache_index = torch.as_tensor(cache_index, dtype=torch.int32,
                                      device=x.device)
        if cache_index.ndim != 1:
            raise ValueError("paged attention is slot-wise: cache_index "
                             "must be [B]")
        if block_table is None:
            raise ValueError("paged attention requires a block_table")
        backend = registry.resolve_backend(x, kernel=pa_ops.NAME)
        if backend == KernelBackend.CUDA and s <= _KERNEL_MAX_S:
            _, _, out = pa_ops.paged_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                cache["k_pool"], cache["v_pool"], block_table,
                write_table if write_table is not None else block_table,
                cache_index, kv_len=kv_len, softcap=softcap,
                backend=KernelBackend.CUDA)
        else:
            k_all, v_all = _paged_update_and_gather(
                cache, k, v, block_table, cache_index, kv_len,
                write_table=write_table)
            mask = causal_mask(cache_index, s, k_all.shape[1])
            out = plain_attention(q, k_all, v_all, mask, softcap)
    elif cache is not None:
        cache_index = torch.as_tensor(cache_index, device=x.device)
        _write_contiguous(cache["k"], k, cache_index)
        _write_contiguous(cache["v"], v, cache_index)
        t = cache["k"].shape[1]
        kpos = torch.arange(t, device=x.device)
        if cache_index.ndim == 1:
            mask = causal_mask(cache_index, s, t)
        else:
            mask = kpos[None, :] <= (cache_index + torch.arange(
                s, device=x.device))[:, None]
        out = plain_attention(q, cache["k"], cache["v"], mask, softcap)
    else:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=x.device))
        out = plain_attention(q, k, v, mask, softcap)

    out = out.to(x.dtype).reshape(b, s, cfg.num_heads * hd)
    return layers.linear(p["wo"], out, pum), cache


def apply_rope_gqa(q: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                   ) -> torch.Tensor:
    """q: [B, S, KV, G, hd]."""
    b, s, kvh, g, hd = q.shape
    q2 = layers.apply_rope(q.reshape(b, s, kvh * g, hd), cos, sin)
    return q2.reshape(b, s, kvh, g, hd)
