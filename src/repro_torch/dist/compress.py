"""int8 gradient compression with error feedback, the JAX package's
``dist/compress.py`` without its mesh collective.

:func:`ef_compress_grads` quantises each gradient leaf to int8 against
its own abs-max scale, carrying the quantisation residual in the
optimiser state (``opt_state["ef"]``) and adding it back next step, so
the accumulated update stays unbiased (Karimireddy et al., 2019).  On
one card it models the quantisation of what a data-parallel all-reduce
would move.  The reference's ``compressed_psum``, an all-reduce with an
int8 wire format over a mesh axis, needs several cards and is not
ported.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import leaves, tree_map, unflatten_like

_EPS = 1e-12
_QMAX = 127.0


def _quantise(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.round(x / torch.clamp(scale, min=_EPS) * _QMAX)
    return torch.clamp(q, -_QMAX, _QMAX).to(torch.int8)


def _dequantise(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * (scale / _QMAX)


def zeros_like_residual(params: Any) -> Any:
    """The f32 zero tree carried in ``opt_state["ef"]``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _ef_leaf(g: torch.Tensor, r: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    corrected = g.to(torch.float32) + r
    scale = torch.amax(torch.abs(corrected))
    dec = _dequantise(_quantise(corrected, scale), scale)
    return dec.to(g.dtype), corrected - dec


@torch.no_grad()
def ef_compress_grads(grads: Any, residual: Any) -> tuple[Any, Any]:
    """Quantise grads to int8 (a scale a leaf) with error feedback.

    Returns ``(decompressed_grads, new_residual)``; the caller feeds the
    decompressed tree to the optimiser and keeps the residual for the
    next step."""
    out = [_ef_leaf(g, r) for g, r in zip(leaves(grads), leaves(residual))]
    return (unflatten_like(grads, [d for d, _ in out]),
            unflatten_like(grads, [r for _, r in out]))
