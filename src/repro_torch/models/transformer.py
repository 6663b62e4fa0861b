"""Decoder block assembly: per-layer kind selection and the blocks the
port serves.  The mixers are attention, the xLSTM family's mLSTM and
sLSTM, and the hybrid family's Mamba (``models/ssm.py``: Jamba's 7:1
interleave of Mamba and attention); the FFN is a dense MLP, the MoE
family's routed experts (``models/moe.py``, beside attention or Mamba),
or none (xLSTM's ``d_ff`` is 0).  Layer ``l`` takes the kinds of
position ``l % period(cfg)`` of the repeating pattern, as the
reference's grouped stack does.  An encoder-decoder's decoder blocks
(``cross=True``) add a cross-attention block over the encoder's output
between the mixer and the FFN; the decoder takes no RoPE."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention, layers, mlp, moe, ssm, xlstm

Params = dict[str, Any]

RECURRENT = ("mlstm", "slstm", "mamba")
# each recurrent mixer's leaves and the values a fresh state holds
STATE_INIT = {"mlstm": xlstm.STATE_INIT, "slstm": xlstm.STATE_INIT,
              "mamba": ssm.STATE_INIT}
_MIXERS = {"mlstm": xlstm.mlstm, "slstm": xlstm.slstm, "mamba": ssm.mamba}


def mixer_kind(cfg: ModelConfig, layer_idx: int) -> str:
    if cfg.xlstm_slstm_every > 0:
        return "slstm" if layer_idx % cfg.xlstm_slstm_every == 0 else "mlstm"
    if cfg.attn_period > 0:
        return "attn" if layer_idx % cfg.attn_period == (
            cfg.attn_period // 2) else "mamba"
    return "attn"


def ffn_kind(cfg: ModelConfig, layer_idx: int) -> str:
    if cfg.moe.num_experts <= 0:
        return "mlp" if cfg.d_ff > 0 else "none"
    if layer_idx % cfg.moe_layer_period == (cfg.moe_layer_period - 1):
        return "moe"
    return "mlp" if cfg.d_ff > 0 else "none"


def period(cfg: ModelConfig) -> int:
    """Smallest repeating pattern of (mixer, ffn) kinds."""
    p = 1
    if cfg.attn_period > 0:
        p = max(p, cfg.attn_period)
    if cfg.xlstm_slstm_every > 0:
        p = max(p, cfg.xlstm_slstm_every)
    if cfg.moe.num_experts > 0:
        p = max(p, cfg.moe_layer_period)
    while cfg.num_layers % p != 0:       # fall back to unrolled if ragged
        p += 1
        if p > cfg.num_layers:
            return cfg.num_layers
    return p


def layer_kinds(cfg: ModelConfig, layer: int) -> tuple[str, str]:
    """(mixer, ffn) kind of layer ``layer`` of the stack."""
    j = layer % period(cfg)
    return mixer_kind(cfg, j), ffn_kind(cfg, j)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for layer layouts the port does not serve."""
    for j in range(cfg.num_layers):
        mk, fk = layer_kinds(cfg, j)
        if fk == "moe" and mk not in ("attn", "mamba"):
            raise NotImplementedError(
                f"{cfg.name}: layer {j} is ({mk}, {fk}); MoE FFNs are "
                f"ported beside attention and Mamba mixers only")


def init_block(gen: torch.Generator, cfg: ModelConfig, layer_idx: int,
               device: torch.device | str = "cpu", cross: bool = False
               ) -> Params:
    """One layer's params, drawn mixer, FFN, then (``cross``, an
    encoder-decoder's decoder) the cross-attention, the reference's
    order of keys."""
    check_supported(cfg)
    mk, fk = layer_kinds(cfg, layer_idx)
    p: Params = {"norm1": layers.make_norm(cfg, device)}
    if mk == "attn":
        p["attn"] = attention.init_attention(gen, cfg, device)
    elif mk == "mamba":
        p["mamba"] = ssm.init_mamba(gen, cfg, device)
    elif mk == "mlstm":
        p["mlstm"] = xlstm.init_mlstm(gen, cfg, device)
    else:
        p["slstm"] = xlstm.init_slstm(gen, cfg, device)
    if fk != "none":
        p["norm2"] = layers.make_norm(cfg, device)
    if fk == "mlp":
        p["mlp"] = mlp.init_mlp(gen, cfg, device=device)
    elif fk == "moe":
        p["moe"] = moe.init_moe(gen, cfg, device)
    if cross:
        p["norm_x"] = layers.make_norm(cfg, device)
        p["cross"] = attention.init_attention(gen, cfg, device)
    return p


def make_block_state(cfg: ModelConfig, layer_idx: int, batch: int,
                     max_len: int, device: torch.device | str = "cpu"
                     ) -> Params:
    """A fresh decode state of layer ``layer_idx``: a contiguous KV
    cache, or the recurrent state of its mixer."""
    mk, _ = layer_kinds(cfg, layer_idx)
    if mk == "attn":
        return attention.make_cache(cfg, batch, max_len, device=device)
    if mk == "mamba":
        return ssm.make_ssm_state(cfg, batch, device)
    if mk == "mlstm":
        return xlstm.make_mlstm_state(cfg, batch, device)
    return xlstm.make_slstm_state(cfg, batch, device)


def commit_state(state: Params, new: Params,
                 rows: torch.Tensor | None = None) -> None:
    """Write a recurrent mixer's ``new`` state into ``state``'s tensors
    in place; with ``rows`` ([B] bool) only those rows advance and the
    others keep their values."""
    for name, t in state.items():
        value = new[name].to(t.dtype)
        if rows is not None:
            value = torch.where(rows.reshape((-1,) + (1,) * (t.ndim - 1)),
                                value, t)
        t.copy_(value)


def apply_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                layer_idx: int, *, positions: torch.Tensor,
                state: Params | None = None,
                cache_index: torch.Tensor | None = None,
                encoder_out: torch.Tensor | None = None,
                block_table: torch.Tensor | None = None,
                kv_len: int | None = None,
                write_table: torch.Tensor | None = None,
                commit: bool = True, collect_states: bool = False,
                aux: dict[str, torch.Tensor] | None = None,
                ) -> tuple[torch.Tensor, Params | None]:
    """Returns (x, state).  A KV cache in ``state`` is updated in place;
    a recurrent state is written in place too (``commit``), or left as
    it was and its successor returned (``commit=False``).
    ``collect_states`` (the speculative verify step's) returns a
    recurrent mixer's state after every position ([B, S, ...] leaves)
    and writes none of it: it implies ``commit=False``; KV caches are
    written as ever, and the step rolls back what it rejects.  An MoE
    FFN's aux losses are computed only when ``aux`` is a dict (the
    train mode's), which they are written into; serving passes none.
    With
    ``encoder_out`` [B, T, D], a block with ``cross`` params attends
    over it, its K and V projected from it on every call, as the
    reference's block does; without, the block skips it."""
    mk, _ = layer_kinds(cfg, layer_idx)
    h = layers.norm_apply(p["norm1"], x, cfg)
    if mk == "attn":
        h, state = attention.attention(
            p["attn"], h, cfg, positions=positions, cache=state,
            cache_index=cache_index, use_rope=not cfg.is_encoder_decoder,
            block_table=block_table, kv_len=kv_len,
            write_table=write_table)
    else:
        h, new = _MIXERS[mk](p[mk], h, cfg, state=state,
                             collect_states=collect_states)
        if new is not None and commit and not collect_states:
            commit_state(state, new)
        elif new is not None:
            state = new
    x = x + h
    if "cross" in p and encoder_out is not None:
        h = layers.norm_apply(p["norm_x"], x, cfg)
        b, t, _ = encoder_out.shape
        kv = (cfg.num_kv_heads, cfg.resolved_head_dim)
        cross_kv = tuple(
            layers.linear(p["cross"][w], encoder_out, cfg.pum).reshape(
                b, t, *kv) for w in ("wk", "wv"))
        h, _ = attention.attention(p["cross"], h, cfg, positions=positions,
                                   cross_kv=cross_kv, use_rope=False)
        x = x + h
    if "mlp" in p:
        h = layers.norm_apply(p["norm2"], x, cfg)
        x = x + mlp.mlp(p["mlp"], h, cfg)
    elif "moe" in p:
        h = layers.norm_apply(p["norm2"], x, cfg)
        h, losses = moe.moe_ffn(p["moe"], h, cfg, aux=aux is not None)
        x = x + h
        if aux is not None:
            aux.update(losses)
    return x, state
