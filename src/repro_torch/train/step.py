"""Loss and train step, the JAX package's ``train/step.py``.

``make_train_step`` gives ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``: gradients by autograd (microbatches accumulated
in f32 and divided by their count), then error-feedback int8
compression (``scfg.grad_compress``), global-norm clipping, the
schedule's rate at the optimiser's count, and the AdamW update.  The
step writes the new params and optimiser state into the tensors it was
given and returns those trees (the reference's jit donates its
buffers): at Qwen2.5-3B's 3.09 B params the f32 params, gradients, m
and v take 49 GB of the card's 80, with no room for a second copy.

In ``int8``/``pum`` every projection's forward is the quantised product
(K2, ``kernels/bitslice_mvm``, on the card) and its gradient the
straight-through one (``core/pum_linear._ShadowSTE``).  With ``remat``
(``scfg.remat`` other than ``"none"``) each block is recomputed in the
backward, its projections with it.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.config import ModelConfig, ShardingConfig, TrainConfig
from repro_torch.dist import compress
from repro_torch.models import lm
from repro_torch.optim import adamw, schedules
from repro_torch.tree import leaves, tree_map, unflatten_like

MOE_LB_WEIGHT = 0.01
MOE_Z_WEIGHT = 0.001

Batch = dict[str, torch.Tensor]


def make_loss_fn(cfg: ModelConfig, scfg: ShardingConfig = ShardingConfig()):
    def loss_fn(params, batch: Batch
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        tokens = batch["tokens"]
        if scfg.bf16_params:
            params = tree_map(
                lambda p: p.to(torch.bfloat16)
                if p.dtype == torch.float32 and p.ndim >= 2 else p, params)
        logits, _, aux = lm.forward(
            params, tokens, cfg,
            image_embeds=batch.get("image_embeds"),
            encoder_frames=batch.get("encoder_frames"),
            remat=scfg.remat != "none", with_aux=True)
        # next-token loss over the *text* positions only
        logits_t = logits[:, -tokens.shape[1]:]
        pred = logits_t[:, :-1]
        tgt = tokens[:, 1:].to(torch.int64)
        ll = torch.log_softmax(pred.to(torch.float32), dim=-1)
        nll = -torch.gather(ll, -1, tgt[..., None])[..., 0]
        loss = torch.mean(nll)
        metrics = {"loss": loss}
        if "moe_lb" in aux:
            loss = loss + MOE_LB_WEIGHT * aux["moe_lb"] \
                + MOE_Z_WEIGHT * aux["moe_z"]
            metrics["moe_lb"] = aux["moe_lb"]
        metrics["total_loss"] = loss
        return loss, metrics

    return loss_fn


def value_and_grad(loss_fn: Callable, params: Any, batch: Batch
                   ) -> tuple[dict[str, torch.Tensor], Any]:
    """(metrics, gradients of the loss in every param leaf): a leaf the
    loss does not reach gets zeros, as ``jax.grad`` gives."""
    flat = leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss, metrics = loss_fn(unflatten_like(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return ({k: v.detach() for k, v in metrics.items()},
            unflatten_like(params, grads))


def init_opt_state(params, tcfg: TrainConfig,
                   scfg: ShardingConfig = ShardingConfig()):
    state = adamw.adamw_init(params)
    if scfg.grad_compress:
        state["ef"] = compress.zeros_like_residual(params)
    return state


def make_grad_fn(cfg: ModelConfig, tcfg: TrainConfig,
                 scfg: ShardingConfig = ShardingConfig()):
    """``(params, batch) -> (gradients, metrics)``: over the whole batch,
    or with ``tcfg.microbatch`` over ``batch // microbatch`` equal
    slices, their gradients and metrics summed in f32 onto zeros and
    divided by the count, as the reference's ``lax.scan``."""
    loss_fn = make_loss_fn(cfg, scfg)

    def compute_grads(params, batch: Batch):
        if not (tcfg.microbatch and tcfg.microbatch > 0):
            metrics, grads = value_and_grad(loss_fn, params, batch)
            return grads, metrics
        n_micro = max(1, batch["tokens"].shape[0] // tcfg.microbatch)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        msum = {"loss": 0.0, "total_loss": 0.0}
        if cfg.moe.num_experts > 0:
            msum["moe_lb"] = 0.0
        for i in range(n_micro):
            mb = {k: v[i * (v.shape[0] // n_micro):
                       (i + 1) * (v.shape[0] // n_micro)]
                  for k, v in batch.items()}
            metrics, g = value_and_grad(loss_fn, params, mb)
            for a, b in zip(leaves(acc), leaves(g)):
                a.add_(b)
            del g
            msum = {k: msum[k] + metrics[k] for k in msum}
        return (tree_map(lambda g: g / n_micro, acc),
                {k: m / n_micro for k, m in msum.items()})

    return compute_grads


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    scfg: ShardingConfig = ShardingConfig()):
    compute_grads = make_grad_fn(cfg, tcfg, scfg)
    sched = schedules.make_schedule(tcfg)

    @torch.no_grad()
    def train_step(params, opt_state, batch: Batch):
        grads, metrics = compute_grads(params, batch)
        if scfg.grad_compress:
            grads, new_ef = compress.ef_compress_grads(grads,
                                                       opt_state["ef"])
        grads, norm = adamw.clip_by_global_norm(grads, tcfg.grad_clip,
                                                inplace=True)
        lr = sched(opt_state["count"])
        params, opt_state = adamw.adamw_update(params, grads, opt_state, lr,
                                               tcfg, inplace=True)
        if scfg.grad_compress:
            opt_state["ef"] = new_ef
        metrics = dict(metrics)
        metrics["grad_norm"] = norm
        metrics["lr"] = lr
        return params, opt_state, metrics

    return train_step
