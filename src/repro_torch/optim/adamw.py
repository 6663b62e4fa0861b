"""AdamW with decoupled weight decay and global-norm clipping, the JAX
package's ``optim/adamw.py`` operation for operation.

The state mirrors the params: ``m`` and ``v`` in f32, and ``count``, an
int32 scalar on the params' device.  :func:`clip_by_global_norm` and
:func:`adamw_update` return new trees, as the reference's do; with
``inplace`` they write them into the given trees instead (the train
step's way, where the reference's jit donates its buffers), so a step
holds no second copy of the gradients, params, ``m`` or ``v``: the same
f32 operations in the same order either way.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.config import TrainConfig
from repro_torch.tree import leaves, tree_map, unflatten_like

OptState = dict[str, Any]


def adamw_init(params: Any) -> OptState:
    device = leaves(params)[0].device
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    total = 0
    for leaf in leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float, *,
                        inplace: bool = False) -> tuple[Any, torch.Tensor]:
    """(grads scaled so that their global norm is at most ``max_norm``,
    the norm before); with ``inplace`` written into ``grads``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)

    def clip(g):
        return (g.to(torch.float32) * scale).to(g.dtype)

    if inplace:
        for g in leaves(grads):
            g.copy_(clip(g))
        return grads, norm
    return tree_map(clip, grads), norm


def bias_corrections(count: torch.Tensor, cfg: TrainConfig
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """1 - b1^count and 1 - b2^count in f32, for the incremented count."""
    c = count.to(torch.float32)
    return 1.0 - cfg.b1 ** c, 1.0 - cfg.b2 ** c


def update_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, lr: torch.Tensor, bc1: torch.Tensor,
                bc2: torch.Tensor, cfg: TrainConfig
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leaf's (p_new in p's dtype, m_new, v_new)."""
    b1, b2 = cfg.b1, cfg.b2
    g32 = g.to(torch.float32)
    m_new = b1 * m + (1 - b1) * g32
    v_new = b2 * v + (1 - b2) * g32 * g32
    mhat = m_new / bc1
    vhat = v_new / bc2
    step = mhat / (torch.sqrt(vhat) + cfg.eps)
    step = step + cfg.weight_decay * p.to(torch.float32)
    p_new = p.to(torch.float32) - lr * step
    return p_new.to(p.dtype), m_new, v_new


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: OptState,
                 lr: torch.Tensor, cfg: TrainConfig, *,
                 inplace: bool = False) -> tuple[Any, OptState]:
    count = state["count"] + 1
    bc1, bc2 = bias_corrections(count, cfg)
    flat = zip(leaves(params), leaves(grads), leaves(state["m"]),
               leaves(state["v"]))
    if inplace:
        for p, g, m, v in flat:
            p_new, m_new, v_new = update_leaf(p, g, m, v, lr, bc1, bc2, cfg)
            p.copy_(p_new)
            m.copy_(m_new)
            v.copy_(v_new)
            del p_new, m_new, v_new
        state["count"].copy_(count)
        return params, state
    out = [update_leaf(p, g, m, v, lr, bc1, bc2, cfg) for p, g, m, v in flat]
    new = [unflatten_like(params, [o[i] for o in out]) for i in range(3)]
    return new[0], {"m": new[1], "v": new[2], "count": count}
