"""Feed-forward blocks: gated SiLU (llama family) and plain GELU.

FFN weights are the paper's canonical ACE residents (§5.2): they route
through PUMLinear; the activation runs on the digital path (the I-BERT
integer GELU on the plain GELU block when ``pum.ibert``; the gated SiLU
block has no integer form and runs as it is)."""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core import ibert
from repro_torch.models import layers

Params = dict[str, Any]


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: int = 0,
             device: torch.device | str = "cpu") -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.activation == "silu":           # gated
        return {"wg": layers.linear_init(gen, d, f, device=device),
                "wu": layers.linear_init(gen, d, f, device=device),
                "wd": layers.linear_init(gen, f, d, device=device)}
    return {"wu": layers.linear_init(gen, d, f, bias=True, device=device),
            "wd": layers.linear_init(gen, f, d, bias=True, device=device)}


def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    pum = cfg.pum
    if "wg" in p:
        gate = layers.linear(p["wg"], x, pum)
        up = layers.linear(p["wu"], x, pum)
        h = F.silu(gate) * up
    else:
        h = layers.linear(p["wu"], x, pum)
        if pum.ibert:
            h = ibert.gelu_quantized(h.to(torch.float32), 8).to(h.dtype)
        else:
            h = layers.activation(cfg.activation)(h)
    return layers.linear(p["wd"], h, pum)
