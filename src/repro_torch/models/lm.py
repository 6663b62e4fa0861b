"""The assembled language model: embeddings -> block stack -> head.

Dense decoders (Qwen2.5-3B), the xLSTM family (xLSTM-350M) and the
MoE family (OLMoE-1B-7B, granite-moe-1b-a400m: attention with routed
experts), and the small test configs of each.  Params are per layer —
``params["blocks"][l]`` — and a Python loop over layers takes the place
of the JAX package's ``scan`` over stacked groups; decode states are per
layer too (``states[l]``): a KV cache or pool, or a recurrent mixer's
per-slot rows, all updated in place.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import prepack
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, transformer, xlstm

Params = dict[str, Any]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: str | torch.device = "cuda") -> Params:
    """Random weights drawn on ``device`` from ``generator`` (which must
    live on that device) with the JAX package's distributions; an MoE
    layer's router and f32 expert stacks [E, D, F] / [E, F, D] too."""
    dev = resolve_device(device)
    transformer.check_supported(cfg)
    params: Params = {
        "embed": layers.embed_init(generator, cfg.vocab_size, cfg.d_model,
                                   dev),
        "final_norm": layers.make_norm(cfg, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.randn(
            (cfg.d_model, layers.padded_vocab(cfg.vocab_size)),
            generator=generator, device=dev) * 0.02
    params["blocks"] = [transformer.init_block(generator, cfg, j, dev)
                        for j in range(cfg.num_layers)]
    return params


def prepack_for_serving(params: Params, cfg: ModelConfig) -> Params:
    """Pack every linear weight once for inference (crossbar
    programming); a no-op for bf16.  The embedding, an MoE layer's
    router (f32 in every mode) and its expert stacks stay float."""
    return prepack.prepack_params(params, cfg.pum)


def init_state(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> list[Params]:
    """Per-layer decode states: contiguous KV caches [batch, max_len,
    KV, hd] (bf16) for attention, recurrent rows [batch, ...] (f32) for
    mLSTM and sLSTM."""
    dev = resolve_device(device)
    return [transformer.make_block_state(cfg, j, batch, max_len, dev)
            for j in range(cfg.num_layers)]


def init_paged_state(cfg: ModelConfig, batch: int, max_len: int, *,
                     num_blocks: int, block_size: int,
                     device: str | torch.device = "cuda") -> list[Params]:
    """Per-layer KV pools of ``num_blocks + 1`` blocks (block 0 is the
    reserved trash block — ``serve.kv_pool``) for attention layers; the
    recurrent layers keep their per-slot ``[batch, ...]`` rows beside
    them.  A pure-recurrent stack has no pool."""
    dev = resolve_device(device)
    return [attention.make_paged_cache(cfg, num_blocks + 1, block_size,
                                       device=dev)
            if transformer.layer_kinds(cfg, j)[0] == "attn"
            else transformer.make_block_state(cfg, j, batch, max_len, dev)
            for j in range(cfg.num_layers)]


def recurrent_tensors(cfg: ModelConfig, states: list[Params]
                      ) -> list[torch.Tensor]:
    """The tensors of ``states`` that a step advances in place: every
    leaf of every recurrent layer (KV cells are only ever overwritten)."""
    return [t for j, st in enumerate(states)
            if transformer.layer_kinds(cfg, j)[0] in transformer.RECURRENT
            for t in st.values()]


def reset_states(cfg: ModelConfig, states: list[Params],
                 row: int | None = None, *, kv_from: int = 0) -> None:
    """Set ``states`` back to their init values in place (the captured
    graphs hold their addresses): recurrent leaves to the values of a
    fresh state (``m`` at -1e30, the rest zero), KV caches and pools to
    zero from position ``kv_from`` on.  With ``row``, only that slot's
    recurrent rows, as the reference's ``reset_slot_recurrent``: a KV
    pool is shared, and a slot's stale blocks are handled by allocation
    and masking."""
    for j, st in enumerate(states):
        if transformer.layer_kinds(cfg, j)[0] == "attn":
            if row is None:
                for t in st.values():
                    t[:, kv_from:].zero_()
            continue
        for name, t in st.items():
            (t if row is None else t[row]).fill_(xlstm.STATE_INIT[name])


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            states: list[Params] | None = None,
            cache_index: torch.Tensor | int | None = None,
            last_only: bool = False,
            block_table: torch.Tensor | None = None,
            kv_len: int | None = None,
            write_table: torch.Tensor | None = None,
            commit: bool = True,
            ) -> tuple[torch.Tensor, list[Params] | None]:
    """tokens: [B, S] int -> (logits [B, S or 1, V_padded] f32, states).

    Modes: train/score (states None); prefill (contiguous states,
    cache_index 0); decode (cache_index a scalar or [B] per-slot
    depths); paged (states from :func:`init_paged_state`, per-row
    ``block_table`` [B, W] and the engine window ``kv_len``).  KV
    storage is written in place; recurrent states too, unless
    ``commit=False``, which leaves them as they were and returns their
    successors in the returned list (the paged slot step keeps the rows
    of slots that are not decoding: ``serve.kv_pool``)."""
    b, s = tokens.shape
    dev = tokens.device
    h = params["embed"][tokens].to(
        torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)
    if cache_index is not None:
        cache_index = torch.as_tensor(cache_index, dtype=torch.int32,
                                      device=dev)
        offs = torch.arange(s, dtype=torch.int32, device=dev)
        positions = (cache_index[:, None] + offs[None, :]
                     if cache_index.ndim == 1 else cache_index + offs)
    else:
        positions = torch.arange(s, dtype=torch.int32, device=dev)

    out_states = None if states is None else []
    for j, blk in enumerate(params["blocks"]):
        st = states[j] if states is not None else None
        h, st = transformer.apply_block(
            blk, h, cfg, j, positions=positions, state=st,
            cache_index=cache_index, block_table=block_table,
            kv_len=kv_len, write_table=write_table, commit=commit)
        if out_states is not None:
            out_states.append(st)

    h = layers.norm_apply(params["final_norm"], h, cfg)
    if last_only:
        h = h[:, -1:]
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = torch.matmul(h.to(torch.float32), head.to(torch.float32))
    return logits, out_states
