"""Decoder block assembly: per-layer kind selection and the blocks the
port serves.  The mixers are attention and the xLSTM family's mLSTM and
sLSTM; the FFN is a dense MLP, the MoE family's routed experts
(``models/moe.py``, beside attention), or none (xLSTM's ``d_ff`` is 0).
Layer ``l`` takes the kinds of position ``l % period(cfg)`` of the
repeating pattern, as the reference's grouped stack does.  Mamba
mixers, cross-attention, encoder-decoder and vision models are not
ported yet and raise ``NotImplementedError``."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention, layers, mlp, moe, xlstm

Params = dict[str, Any]

RECURRENT = ("mlstm", "slstm")


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
    """Raise for model families the port does not serve yet."""
    if cfg.is_encoder_decoder or cfg.vision_stub:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and vision models are not "
            f"ported yet")
    for j in range(cfg.num_layers):
        mk, fk = layer_kinds(cfg, j)
        dense = mk in ("attn",) + RECURRENT and fk in ("mlp", "none")
        if not dense and (mk, fk) != ("attn", "moe"):
            raise NotImplementedError(
                f"{cfg.name}: layer {j} is ({mk}, {fk}); only attention, "
                f"mLSTM and sLSTM mixers with dense MLPs, and attention "
                f"with MoE FFNs, are ported yet")


def init_block(gen: torch.Generator, cfg: ModelConfig, layer_idx: int,
               device: torch.device | str = "cpu") -> Params:
    check_supported(cfg)
    mk, fk = layer_kinds(cfg, layer_idx)
    p: Params = {"norm1": layers.make_norm(cfg, device)}
    if mk == "attn":
        p["attn"] = attention.init_attention(gen, cfg, device)
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
    return p


def make_block_state(cfg: ModelConfig, layer_idx: int, batch: int,
                     max_len: int, device: torch.device | str = "cpu"
                     ) -> Params:
    """A fresh decode state of layer ``layer_idx``: a contiguous KV
    cache, or the recurrent state of its mixer."""
    mk, _ = layer_kinds(cfg, layer_idx)
    if mk == "attn":
        return attention.make_cache(cfg, batch, max_len, device=device)
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
                block_table: torch.Tensor | None = None,
                kv_len: int | None = None,
                write_table: torch.Tensor | None = None,
                commit: bool = True,
                ) -> tuple[torch.Tensor, Params | None]:
    """Returns (x, state).  A KV cache in ``state`` is updated in place;
    a recurrent state is written in place too (``commit``), or left as
    it was and its successor returned (``commit=False``).  An MoE FFN's
    aux losses are not computed (serving needs none)."""
    mk, _ = layer_kinds(cfg, layer_idx)
    h = layers.norm_apply(p["norm1"], x, cfg)
    if mk == "attn":
        h, state = attention.attention(
            p["attn"], h, cfg, positions=positions, cache=state,
            cache_index=cache_index, block_table=block_table, kv_len=kv_len,
            write_table=write_table)
    else:
        mixer = xlstm.mlstm if mk == "mlstm" else xlstm.slstm
        h, new = mixer(p[mk], h, cfg, state=state)
        if new is not None and commit:
            commit_state(state, new)
        elif new is not None:
            state = new
    x = x + h
    if "mlp" in p:
        h = layers.norm_apply(p["norm2"], x, cfg)
        x = x + mlp.mlp(p["mlp"], h, cfg)
    elif "moe" in p:
        h = layers.norm_apply(p["norm2"], x, cfg)
        x = x + moe.moe_ffn(p["moe"], h, cfg, aux=False)[0]
    return x, state
