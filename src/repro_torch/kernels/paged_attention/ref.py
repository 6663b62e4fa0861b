"""Plain PyTorch version of the paged-attention kernel (the oracle).

Op for op the composition the JAX package's serving stack runs
(``models.attention``: ``paged_write_cells``, the pool scatter, the
block-table gather and ``_plain_attention``), on the same layouts.  The
model's ``torch`` backend runs the same pieces, updating the pools in
place; :func:`paged_attention_ref` returns new pools instead, so a
comparison can run it beside the kernel on the same inputs.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_write_cells(write_table: torch.Tensor, cache_index: torch.Tensor,
                      s: int, block_size: int,
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (physical block, in-block offset) each of a row's next ``s``
    positions is written to; both [B, S] int64.  Positions past the
    table width go to the trash block 0 instead of wrapping into the
    row's last block."""
    w = write_table.shape[1]
    pos = cache_index.to(torch.int64)[:, None] + torch.arange(
        s, dtype=torch.int64, device=cache_index.device)[None, :]
    cols = pos // block_size
    phys = torch.gather(write_table.to(torch.int64), 1,
                        torch.clamp(cols, 0, w - 1))
    phys = torch.where(cols < w, phys, torch.zeros_like(phys))
    return phys, pos % block_size


def softmax(scores: torch.Tensor, softcap: float) -> torch.Tensor:
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    return e / torch.sum(e, dim=-1, keepdim=True)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, softcap: float) -> torch.Tensor:
    """q: [B,S,KV,G,hd]; k/v: [B,T,KV,hd]; mask: [S,T] shared across the
    batch, or [B,S,T] per row.  Scores in f32, probabilities cast to the
    V dtype, output in the V dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bskgd,btkd->bksgt", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    m = mask[None, None, :, None, :] if mask.ndim == 2 \
        else mask[:, None, :, None, :]
    scores = torch.where(m, scores, torch.full((), NEG_INF,
                                               device=scores.device))
    probs = softmax(scores, softcap)
    return torch.einsum("bksgt,btkd->bskgd", probs.to(v.dtype), v)


def gather_rows(pool: torch.Tensor, block_table: torch.Tensor,
                kv_len: int | None) -> torch.Tensor:
    """Each row's logical [T, KV, hd] view of a [NB, bs, KV, hd] pool
    through its block-table row, cropped to ``kv_len``."""
    b, w = block_table.shape
    bs, kvh, hd = pool.shape[1:]
    out = pool[block_table.to(torch.int64)].reshape(b, w * bs, kvh, hd)
    if kv_len is not None and kv_len < w * bs:
        out = out[:, :kv_len]
    return out


def causal_mask(cache_index: torch.Tensor, s: int, t: int) -> torch.Tensor:
    """[B, S, T]: key position <= the row's query position."""
    pos = cache_index.to(torch.int64)[:, None] + torch.arange(
        s, device=cache_index.device)[None, :]
    kpos = torch.arange(t, device=cache_index.device)
    return kpos[None, None, :] <= pos[..., None]


def paged_attention_ref(q, k_new, v_new, k_pool, v_pool, block_table,
                        write_table, cache_index, *,
                        kv_len: int | None = None, softcap: float = 0.0):
    """Scatter + gather + plain-softmax attention over the block pool.

    q: [B,S,KV,G,hd]; k_new/v_new: [B,S,KV,hd]; pools: [NB,bs,KV,hd];
    tables: [B,W] int32 (0 = trash block); cache_index: [B] int32.
    Returns (new k_pool, new v_pool, out [B,S,KV,G,hd] in the pool
    dtype); the input pools are left as they were."""
    s = k_new.shape[1]
    phys, off = paged_write_cells(write_table, cache_index, s,
                                  k_pool.shape[1])
    k_pool = k_pool.clone()
    v_pool = v_pool.clone()
    k_pool[phys, off] = k_new.to(k_pool.dtype)
    v_pool[phys, off] = v_new.to(v_pool.dtype)
    k_all = gather_rows(k_pool, block_table, kv_len)
    v_all = gather_rows(v_pool, block_table, kv_len)
    mask = causal_mask(cache_index, s, k_all.shape[1])
    return k_pool, v_pool, plain_attention(q, k_all, v_all, mask, softcap)
