"""Mixture-of-Experts FFN: top-k routing and the reference's
capacity-bounded sort dispatch, function for function the JAX package's
``models/moe.py``.

  1. router logits in f32 -> top-k experts per token, the lower expert
     index first among equal probabilities (as ``jax.lax.top_k``);
  2. the (token, k) assignments flattened token-major and sorted by
     expert id, stably;
  3. each assignment's slot within its expert = its rank among that
     expert's assignments (from the sorted order and ``searchsorted``),
     so the lower flat index ``t * k + j`` wins a contested slot;
  4. per-expert buffers [E, C, D]; assignments at slot C or later are
     dropped (the capacity C = ceil(T * k / E * capacity_factor) over
     the call's T rows, computed on the host from static shapes, so a
     CUDA graph holds one shape);
  5. the expert FFN as three batched float products (``torch.bmm``;
     the reference's einsums run outside any kernel);
  6. each token's outputs weighted by its gates and summed over its k
     assignments.

Every row of a call shares the capacity, so under the serving
schedulers a row's output depends on the rows beside it, idle ones
included (``serve/scheduler.py``).

Numerics kept equal to the reference's on every device:

  * the router is ``layers.linear`` in ``bf16`` mode on f32 inputs, a
    plain f32 matmul; on the card TF32 must stay off for it
    (``torch.backends.cuda.matmul.allow_tf32``, False by default);
  * the expert stacks are cast to the activation dtype on every call,
    as the reference's ``.astype(xf.dtype)``;
  * the dispatch writes each kept (expert, slot) once; the dropped
    assignments go to a spare row past the buffers, which nothing reads
    (the reference adds a zero into slot C - 1 instead: the same up to
    the sign of a zero);
  * the combine sums a token's k contributions onto zeros in a fixed
    left-to-right chain, the order of the reference's sequential
    scatter-add on the CPU, never with ``index_add_``, whose atomics
    on the card sum in no fixed order.

``moe_ffn`` returns the load-balancing and router z losses beside the
output; the serving block asks for none (``aux=False``).  The
reference's expert-parallel parts, ``shard_act`` and the group-local
dispatch (``set_grouped_dispatch``, which keeps its sort off the
devices' shared axis), have no counterpart: on one card there is no
axis to keep it off, and the sort is always over the call's T rows.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, PUMConfig
from repro_torch.models import layers

Params = dict[str, Any]

# the router runs in f32 whatever the serving mode
_ROUTER_PUM = PUMConfig(mode="bf16")


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             device: torch.device | str = "cpu") -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(scale)

    return {
        "router": layers.linear_init(gen, d, e, scale=0.02, device=device),
        "experts_wg": normal(e, d, f, scale=1.0 / math.sqrt(d)),
        "experts_wu": normal(e, d, f, scale=1.0 / math.sqrt(d)),
        "experts_wd": normal(e, f, d, scale=1.0 / math.sqrt(f)),
    }


def capacity(rows: int, cfg: ModelConfig) -> int:
    """Slots an expert takes from a group of ``rows`` tokens."""
    k, e = cfg.moe.top_k, cfg.moe.num_experts
    return int(math.ceil(rows * k / e * cfg.moe.capacity_factor))


def top_k(probs: torch.Tensor, k: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row and their indices, the lower index
    first among equal values (``torch.topk`` orders ties in no fixed
    way)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: Params, xf: torch.Tensor, cfg: ModelConfig
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                     torch.Tensor]:
    """xf: [T, D] -> (router logits [T, E] in f32, probabilities, each
    row's top-k gates normalised to sum to 1 [T, k], and their expert
    indices [T, k])."""
    logits = layers.linear(p["router"], xf.to(torch.float32), _ROUTER_PUM)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, cfg.moe.top_k)
    return (logits, probs,
            gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True), gate_idx)


def dispatch_slots(gate_idx: torch.Tensor, e: int
                   ) -> torch.Tensor:
    """Each (token, k) assignment's rank among its expert's, in flat
    token-major order: [T * k] int64."""
    flat_expert = gate_idx.reshape(-1)
    n = flat_expert.numel()
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    experts = torch.arange(e, device=gate_idx.device,
                           dtype=sorted_expert.dtype)
    seg_start = torch.searchsorted(sorted_expert, experts, right=False)
    slot_sorted = torch.arange(n, device=gate_idx.device) \
        - seg_start[sorted_expert]
    return torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)


def _dispatch_ffn(p: Params, xf: torch.Tensor, gate_vals: torch.Tensor,
                  gate_idx: torch.Tensor, cfg: ModelConfig,
                  cap: int) -> torch.Tensor:
    """Sort-based capacity dispatch for one token group.

    xf: [T, D]; gate_vals/idx: [T, k].  Returns [T, D]."""
    t, d = xf.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    flat_expert = gate_idx.reshape(-1)
    slot = dispatch_slots(gate_idx, e)
    keep = slot < cap

    # each kept assignment to its (expert, slot) row; the dropped ones
    # to the spare row e * cap
    rows = torch.where(keep, flat_expert * cap + slot,
                       torch.full_like(slot, e * cap))
    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf[rows] = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = buf[:e * cap].view(e, cap, d)

    gate = torch.bmm(buf, p["experts_wg"].to(xf.dtype))
    up = torch.bmm(buf, p["experts_wu"].to(xf.dtype))
    act = F.silu(gate) * up
    out_e = torch.bmm(act, p["experts_wd"].to(xf.dtype))

    gathered = out_e.reshape(e * cap, d)[
        flat_expert * cap + torch.clamp(slot, max=cap - 1)]
    contrib = torch.where(
        keep[:, None], gathered * gate_vals.reshape(-1, 1).to(xf.dtype),
        0).view(t, k, d)
    out = torch.zeros((t, d), dtype=xf.dtype, device=xf.device)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
            aux: bool = True
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """x: [B, S, D] -> (out [B, S, D], aux losses ``{"moe_lb",
    "moe_z"}``, or ``{}`` with ``aux=False``)."""
    b, s, d = x.shape
    e = cfg.moe.num_experts
    t = b * s
    xf = x.reshape(t, d)

    logits, probs, gate_vals, gate_idx = route(p, xf, cfg)

    out = _dispatch_ffn(p, xf, gate_vals, gate_idx, cfg, capacity(t, cfg))
    if not aux:
        return out.reshape(b, s, d), {}

    me = torch.mean(probs, dim=0)                               # mean prob
    ce = torch.mean(F.one_hot(gate_idx[:, 0], e).to(torch.float32),
                    dim=0)                                      # top-1 load
    lb_loss = e * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return out.reshape(b, s, d), {"moe_lb": lb_loss, "moe_z": z_loss}
