"""LLM encoder on DARTH-PUM (paper §5.2), in PyTorch.

The JAX package's ``apps/encoder_app.py``.  The paper's mapping, followed
exactly:
  * feed-forward network (static weights) -> ACE via ``pum_linear``;
  * QKV / output projections (static)     -> ACE via ``pum_linear``;
  * attention score/value matmuls (dynamic matrices) -> DCE (plain
    compute, f32 ``torch.einsum``);
  * softmax / layer-norm / GELU -> DCE using I-BERT integer algorithms
    (``core/ibert.py``) when ``pum.ibert``.

A compact functional encoder (BERT-style, post-LN, no biases, a
2048-row learned position table) whose every op routes per the
mapping.  On CUDA tensors the six projections of a layer launch the
``bitslice_mvm`` kernels (K1 with prepacked ``pum`` weights, K2
otherwise); on CPU tensors they take the kernels' plain versions.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.config import PUMConfig
from repro_torch.core import ibert, prepack
from repro_torch.core.pum_linear import pum_linear
from repro_torch.device import resolve_device

Params = dict[str, Any]

LINEARS = ("wq", "wk", "wv", "wo", "w1", "w2")
MAX_POSITIONS = 2048


def encoder_init(gen: torch.Generator, *, layers: int = 4,
                 d_model: int = 256, d_ff: int = 1024, heads: int = 4,
                 vocab: int = 1000, device: str | torch.device = "cuda"
                 ) -> Params:
    """Random f32 params drawn from ``gen`` (on its device), with the
    reference's laws: embedding and positions N(0, 0.02^2), each linear
    N(0, 1/k).  ``heads`` is the reference's argument; the params do not
    depend on it.  Returned on ``device``."""
    dev = resolve_device(device)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=gen.device)
                * scale).to(dev)

    shapes = {"wq": (d_model, d_model), "wk": (d_model, d_model),
              "wv": (d_model, d_model), "wo": (d_model, d_model),
              "w1": (d_model, d_ff), "w2": (d_ff, d_model)}
    p: Params = {"embed": normal((vocab, d_model), 0.02),
                 "pos": normal((MAX_POSITIONS, d_model), 0.02),
                 "layers": []}
    for _ in range(layers):
        p["layers"].append({name: normal(shapes[name],
                                         1.0 / math.sqrt(shapes[name][0]))
                            for name in LINEARS})
    return p


def encoder_prepack(p: Params, pum: PUMConfig) -> Params:
    """Pack every projection weight once for serving (the weights are
    bare arrays, so the ``{"w": ...}`` tree walk of ``prepack_params``
    does not apply: each named matrix is packed directly).
    ``pum_linear`` takes the resulting ``PackedLinear`` in place of the
    raw weight.  ``bf16`` returns the params unchanged."""
    if pum.mode == "bf16":
        return p
    packed = dict(p)
    packed["layers"] = [
        {name: prepack.pack_weight(wm, pum) for name, wm in lp.items()}
        for lp in p["layers"]]
    return packed


def _softmax(x: torch.Tensor, pum: PUMConfig) -> torch.Tensor:
    if pum.ibert:
        return ibert.softmax_quantized(x, bits=8, axis=-1)
    return torch.softmax(x, dim=-1)


def _layernorm(x: torch.Tensor, pum: PUMConfig) -> torch.Tensor:
    if pum.ibert:
        return ibert.layernorm_quantized(x, bits=8, axis=-1)
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.var(x, -1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + 1e-5)


def _gelu(x: torch.Tensor, pum: PUMConfig) -> torch.Tensor:
    if pum.ibert:
        return ibert.gelu_quantized(x, bits=8)
    return F.gelu(x, approximate="none")


def encoder_apply(p: Params, tokens: torch.Tensor, pum: PUMConfig,
                  heads: int = 4) -> torch.Tensor:
    """tokens: [B, S] int -> hidden states [B, S, D] (f32)."""
    b, s = tokens.shape
    h = p["embed"][tokens.to(torch.int64)] + p["pos"][:s][None]
    d = h.shape[-1]
    hd = d // heads
    root = torch.full((), math.sqrt(hd), dtype=torch.float32,
                      device=h.device)
    for lp in p["layers"]:
        # ---- attention: projections on ACE, score/value matmuls in DCE
        q = pum_linear(h, lp["wq"], pum).reshape(b, s, heads, hd)
        k = pum_linear(h, lp["wk"], pum).reshape(b, s, heads, hd)
        v = pum_linear(h, lp["wv"], pum).reshape(b, s, heads, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / root
        attn = _softmax(scores, pum)
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, s, d)
        h = _layernorm(h + pum_linear(ctx, lp["wo"], pum), pum)
        # ---- FFN on the ACE
        f = _gelu(pum_linear(h, lp["w1"], pum), pum)
        h = _layernorm(h + pum_linear(f, lp["w2"], pum), pum)
    return h


def encoder_logits(p: Params, tokens: torch.Tensor, pum: PUMConfig,
                   heads: int = 4) -> torch.Tensor:
    h = encoder_apply(p, tokens, pum, heads)
    return h @ p["embed"].T          # tied head
