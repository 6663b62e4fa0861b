"""Shared layers: norms, RoPE, linear (PUM-routed), embeddings.

Params are plain dicts of tensors, initialised from an explicit
``torch.Generator`` with the JAX package's distributions (the numbers
differ from JAX's, the law is the same; parity tests carry JAX's
weights across through ``repro_torch.bridge`` instead)."""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, PUMConfig
from repro_torch.core.pum_linear import by_position, pum_linear

Params = dict[str, Any]


def linear_init(gen: torch.Generator, d_in: int, d_out: int,
                bias: bool = False, scale: float | None = None,
                device: torch.device | str = "cpu") -> Params:
    scale = 1.0 / math.sqrt(d_in) if scale is None else scale
    p = {"w": torch.randn((d_in, d_out), generator=gen, device=device,
                          dtype=torch.float32) * scale}
    if bias:
        p["b"] = torch.zeros((d_out,), device=device)
    return p


def linear(p: Params, x: torch.Tensor, pum: PUMConfig) -> torch.Tensor:
    """``p["w"]`` is a float weight or a prepacked ``PackedLinear``."""
    return pum_linear(x, p["w"], pum, bias=p.get("b"))


def norm_init(d: int, device: torch.device | str = "cpu") -> Params:
    return {"scale": torch.ones((d,), device=device)}


def layernorm_init(d: int, device: torch.device | str = "cpu") -> Params:
    return {"scale": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def make_norm(cfg: ModelConfig, device: torch.device | str = "cpu"
              ) -> Params:
    return norm_init(cfg.d_model, device) if cfg.use_rmsnorm \
        else layernorm_init(cfg.d_model, device)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the last axis; position by position under
    ``pum_linear.positionwise``, as the norms' statistics go there (a
    reduction kernel may sum a row otherwise at another row count)."""
    return by_position(lambda t: torch.mean(t, dim=-1, keepdim=True), x)


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = _mean(x32 * x32)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p["scale"].to(torch.float32)).to(x.dtype)


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = _mean(x32)
    var = by_position(lambda t: torch.var(t, dim=-1, keepdim=True,
                                          unbiased=False), x32)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"]
    if "bias" in p:
        out = out + p["bias"]
    return out.to(x.dtype)


def norm_apply(p: Params, x: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    if cfg.use_rmsnorm:
        return rmsnorm(p, x, cfg.norm_eps)
    return layernorm(p, x, cfg.norm_eps)


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by halving it with elementwise adds (zero
    padded up to a power of two), the same tree for every row: a row's
    sum never depends on how many rows run with it, as a reduction or
    batched GEMM kernel's may (it can pick its launch shape, and with it
    its summation order, from the batch)."""
    n = x.shape[-1]
    width = 1 << max(0, (n - 1).bit_length())
    if width != n:
        x = F.pad(x, (width - n, 0))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: [...] int -> (cos, sin) of shape [..., head_dim/2]."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    # a fill, not a host-to-device copy: the step may be captured
    freqs = 1.0 / (torch.full((), theta, dtype=torch.float32,
                              device=positions.device) ** exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [..., S, H, hd]; cos/sin: [..., S, hd/2] (broadcast over heads);
    computed in f32 (the tables' type) and cast back to x's type."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1
                     ).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding, activations
# ---------------------------------------------------------------------------

def padded_vocab(vocab: int, mult: int = 256) -> int:
    return -(-vocab // mult) * mult


def embed_init(gen: torch.Generator, vocab: int, d: int,
               device: torch.device | str = "cpu") -> torch.Tensor:
    return torch.randn((padded_vocab(vocab), d), generator=gen,
                       device=device, dtype=torch.float32) * 0.02


def activation(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]
