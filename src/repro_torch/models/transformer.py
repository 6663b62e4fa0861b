"""Decoder block assembly.  This slice ports the dense family: an
attention mixer and a dense-MLP FFN in every layer.  The recurrent
mixers (Mamba, mLSTM, sLSTM), MoE FFNs and cross-attention are not
ported yet and raise ``NotImplementedError``."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention, layers, mlp

Params = dict[str, Any]


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


def check_supported(cfg: ModelConfig) -> None:
    """Raise for model families this slice does not port."""
    if cfg.is_encoder_decoder or cfg.vision_stub:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and vision models are not "
            f"ported yet")
    for j in range(cfg.num_layers):
        mk, fk = mixer_kind(cfg, j), ffn_kind(cfg, j)
        if mk != "attn" or fk not in ("mlp", "none"):
            raise NotImplementedError(
                f"{cfg.name}: layer {j} is ({mk}, {fk}); only dense "
                f"attention + MLP blocks are ported yet")


def init_block(gen: torch.Generator, cfg: ModelConfig, layer_idx: int,
               device: torch.device | str = "cpu") -> Params:
    check_supported(cfg)
    p: Params = {"norm1": layers.make_norm(cfg, device),
                 "attn": attention.init_attention(gen, cfg, device)}
    if ffn_kind(cfg, layer_idx) == "mlp":
        p["norm2"] = layers.make_norm(cfg, device)
        p["mlp"] = mlp.init_mlp(gen, cfg, device=device)
    return p


def apply_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                layer_idx: int, *, positions: torch.Tensor,
                state: Params | None = None,
                cache_index: torch.Tensor | None = None,
                block_table: torch.Tensor | None = None,
                kv_len: int | None = None,
                write_table: torch.Tensor | None = None,
                ) -> tuple[torch.Tensor, Params | None]:
    """Returns (x, state); a KV cache in ``state`` is updated in place."""
    h = layers.norm_apply(p["norm1"], x, cfg)
    h, state = attention.attention(
        p["attn"], h, cfg, positions=positions, cache=state,
        cache_index=cache_index, block_table=block_table, kv_len=kv_len,
        write_table=write_table)
    x = x + h
    if "mlp" in p:
        h = layers.norm_apply(p["norm2"], x, cfg)
        x = x + mlp.mlp(p["mlp"], h, cfg)
    return x, state
