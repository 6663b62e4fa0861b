"""GQA attention with RoPE, optional QKV bias and a KV cache: the
contiguous per-slot cache (the solo oracle's) and the paged block pool
(the scheduler's).

The score/value products are dynamic: per the paper's §5.2 mapping they
never route through the PUM path — only the Q/K/V/O projections do.
The paged branch runs the ``paged_attention`` kernel on CUDA tensors
for chunks of up to ``_KERNEL_MAX_S`` tokens, and the composition below
otherwise; the composition updates the pools in place, as the kernel
does.  The contiguous cache and the cache-free branch attend through
the plain composition, and a prompt of more than ``2 * CHUNK_Q`` tokens
at once through :func:`_chunked_attention`, the reference's online
softmax (plain PyTorch, as the reference's is XLA code); the paged
branch refuses such a prompt, as the reference's does: chunked prefill
streams it.  Cross-attention (``cross_kv``: an encoder-decoder's, and
the bidirectional self-attention of its encoder) takes its K/V as
given, no RoPE and a full mask, through the plain composition, as the
reference's does.

Under ``pum.ibert`` every plain composition takes the I-BERT integer
softmax (:func:`repro_torch.core.ibert.softmax_quantized`, 8 bits, one
scale over the whole score tensor) in place of the float softmax, with
no softcap, and the paged branch never takes the kernel, as the
reference's does; the online softmax of a long prompt stays float.  The
whole-tensor scale is the reference's: a masked score (``NEG_INF``)
sets it so that every real score quantises to code 0, and a masked
I-BERT softmax gives zero probabilities there too.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core import ibert
from repro_torch.kernels import registry
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import (NEG_INF, causal_mask,
                                                     gather_rows,
                                                     paged_write_cells,
                                                     plain_attention,
                                                     write_cells)
from repro_torch.kernels.registry import KernelBackend
from repro_torch.models import layers

Params = dict[str, Any]

# the online softmax's query and key blocks; read when it is called, so
# a test can shrink them
CHUNK_Q = 1024
CHUNK_K = 1024

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
    write_cells(cache["k_pool"], phys, off, k)
    write_cells(cache["v_pool"], phys, off, v)
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
              cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
              use_rope: bool = True,
              block_table: torch.Tensor | None = None,
              kv_len: int | None = None,
              write_table: torch.Tensor | None = None,
              ) -> tuple[torch.Tensor, Params | None]:
    """x: [B, S, D].  Modes: causal self-attention (cache None); decode /
    prefill into a contiguous cache (``k``/``v``; cache_index a scalar or
    [B]); paged (``k_pool``/``v_pool`` with ``block_table`` [B, W],
    cache_index [B]); cross-attention (``cross_kv``: K and V [B, T, KV,
    hd] as given, every key attended, no cache and no RoPE on them).
    Caches are updated in place and returned."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    kvh = cfg.num_kv_heads
    g = cfg.num_heads // kvh
    pum = cfg.pum

    q = layers.linear(p["wq"], x, pum).reshape(b, s, kvh, g, hd)
    if cross_kv is None:
        k = layers.linear(p["wk"], x, pum).reshape(b, s, kvh, hd)
        v = layers.linear(p["wv"], x, pum).reshape(b, s, kvh, hd)
        if use_rope:
            cos, sin = layers.rope_tables(positions, hd, cfg.rope_theta)
            q = apply_rope_gqa(q, cos, sin)
            k = layers.apply_rope(k, cos, sin)
    else:
        k, v = cross_kv

    softcap = cfg.attn_logit_softcap

    def attend(q, k, v, mask):
        return _plain_attention(q, k, v, mask, softcap, pum.ibert)

    if cross_kv is not None:
        mask = torch.ones((s, k.shape[1]), dtype=torch.bool,
                          device=x.device)
        out = attend(q, k, v, mask)
    elif cache is not None and "k_pool" in cache:
        cache_index = torch.as_tensor(cache_index, dtype=torch.int32,
                                      device=x.device)
        if cache_index.ndim != 1:
            raise ValueError("paged attention is slot-wise: cache_index "
                             "must be [B]")
        if block_table is None:
            raise ValueError("paged attention requires a block_table")
        # the paged path reduces with plain softmax over a [B,S,T] score
        # tensor: longer prompts stream through chunked prefill
        if s > 2 * CHUNK_Q:
            raise ValueError(
                f"paged prefill chunk of {s} tokens exceeds "
                f"{2 * CHUNK_Q}; enable chunked_prefill to stream long "
                f"prompts")
        backend = registry.resolve_backend(x, kernel=pa_ops.NAME)
        if (backend == KernelBackend.CUDA and not pum.ibert
                and s <= _KERNEL_MAX_S):
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
            out = attend(q, k_all, v_all, mask)
    elif cache is not None:
        cache_index = torch.as_tensor(cache_index, device=x.device)
        _write_contiguous(cache["k"], k, cache_index)
        _write_contiguous(cache["v"], v, cache_index)
        t = cache["k"].shape[1]
        if s > 2 * CHUNK_Q:
            # a long prefill into the cache is one request's: a scalar
            # offset
            if cache_index.ndim:
                raise ValueError("chunked prefill expects a scalar "
                                 "cache_index")
            out = _chunked_attention(q, cache["k"], cache["v"],
                                     cache_index, softcap)
        elif cache_index.ndim == 1:
            out = attend(q, cache["k"], cache["v"],
                         causal_mask(cache_index, s, t))
        else:
            kpos = torch.arange(t, device=x.device)
            mask = kpos[None, :] <= (cache_index + torch.arange(
                s, device=x.device))[:, None]
            out = attend(q, cache["k"], cache["v"], mask)
    elif s > 2 * CHUNK_Q:
        out = _chunked_attention(q, k, v, 0, softcap)
    else:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=x.device))
        out = attend(q, k, v, mask)

    out = out.to(x.dtype).reshape(b, s, cfg.num_heads * hd)
    return layers.linear(p["wo"], out, pum), cache


def _plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, softcap: float, ibert_mode: bool
                     ) -> torch.Tensor:
    """The plain composition (:func:`plain_attention`, the kernel's
    oracle), or under ``ibert_mode`` the reference's I-BERT variant:
    the same f32 scores and mask, then ``softmax_quantized`` over the
    whole tensor in place of the float softmax, without the softcap."""
    if not ibert_mode:
        return plain_attention(q, k, v, mask, softcap)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bskgd,btkd->bksgt", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    m = mask[None, None, :, None, :] if mask.ndim == 2 \
        else mask[:, None, :, None, :]
    scores = torch.where(m, scores, torch.full((), NEG_INF,
                                               device=scores.device))
    probs = ibert.softmax_quantized(scores, bits=8, axis=-1)
    return torch.einsum("bksgt,btkd->bskgd", probs.to(v.dtype), v)


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_offset: torch.Tensor | int, softcap: float
                       ) -> torch.Tensor:
    """Causal online-softmax attention, the reference's block for block:
    score memory of one [CHUNK_Q, CHUNK_K] block instead of [S, T].

    q: [B,S,KV,G,hd], the queries at positions ``q_offset + [0, S)``
    (``q_offset`` a scalar); k/v: [B,T,KV,hd].  Queries and keys are
    zero-padded to whole blocks, and padded keys masked.  Each query
    block walks the key blocks in order with a running max, sum and
    accumulator in f32; scores are taken in f32, softcapped, then
    masked, and p is cast to V's dtype before p @ V.  Returns
    [B,S,KV,G,hd] f32: ``acc / max(l, 1e-30)``."""
    cq, ck = CHUNK_Q, CHUNK_K
    b, s, kvh, g, hd = q.shape
    t = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    nq, nk = -(-s // cq), -(-t // ck)
    q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, nq * cq - s)).to(torch.float32)
    k = F.pad(k, (0, 0, 0, 0, 0, nk * ck - t)).to(torch.float32)
    v = F.pad(v, (0, 0, 0, 0, 0, nk * ck - t))
    dev = q.device
    q_base = torch.arange(cq, device=dev)
    k_base = torch.arange(ck, device=dev)
    neg = torch.full((), NEG_INF, device=dev)
    outs = []
    for qi in range(nq):
        qblk = q[:, qi * cq:(qi + 1) * cq]
        qpos = q_offset + qi * cq + q_base
        m = torch.full((b, kvh, g, cq), NEG_INF, device=dev)
        lsum = torch.zeros((b, kvh, g, cq), device=dev)
        acc = torch.zeros((b, kvh, g, cq, hd), device=dev)
        for ki in range(nk):
            kblk = k[:, ki * ck:(ki + 1) * ck]
            vblk = v[:, ki * ck:(ki + 1) * ck]
            sc = torch.einsum("bqkgd,btkd->bkgqt", qblk, kblk) * scale
            if softcap > 0:
                sc = torch.tanh(sc / softcap) * softcap
            kpos = ki * ck + k_base
            keep = (qpos[:, None] >= kpos[None, :]) & (kpos < t)[None, :]
            sc = torch.where(keep, sc, neg)
            m_new = torch.maximum(m, torch.amax(sc, dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p.to(vblk.dtype), vblk
            ).to(torch.float32)
            m = m_new
        out = acc / torch.clamp_min(lsum[..., None], 1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))        # [B, CQ, KV, G, hd]
    return torch.cat(outs, dim=1)[:, :s]


def apply_rope_gqa(q: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                   ) -> torch.Tensor:
    """q: [B, S, KV, G, hd]."""
    b, s, kvh, g, hd = q.shape
    q2 = layers.apply_rope(q.reshape(b, s, kvh * g, hd), cos, sin)
    return q2.reshape(b, s, kvh, g, hd)
