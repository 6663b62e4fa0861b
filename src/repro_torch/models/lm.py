"""The assembled language model: embeddings -> block stack -> head.

Dense decoders (Qwen2.5-3B, glm4-9b, minicpm-2b, command-r-plus-104b),
the xLSTM family (xLSTM-350M), the MoE family (OLMoE-1B-7B,
granite-moe-1b-a400m: attention with routed experts), the hybrid family
(Jamba-v0.1: Mamba and attention mixers, dense and routed FFNs), the
vision-language stub (llava-next-mistral-7b: precomputed image
embeddings, projected and put in front of the tokens) and the
encoder-decoder (whisper-tiny: an encoder over precomputed frames, and
cross-attention over its output in every decoder block), and the small
test configs of each.  Params are
per layer — ``params["blocks"][l]`` — and a Python loop over layers
takes the place of the JAX package's ``scan`` over stacked groups;
decode states are per layer too (``states[l]``): a KV cache or pool, or
a recurrent mixer's per-slot rows, all updated in place.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch.utils import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.core import prepack, pum_linear
from repro_torch.device import resolve_device
from repro_torch.kernels import registry
from repro_torch.models import attention, layers, mlp, transformer

Params = dict[str, Any]


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The encoder's config: the decoder's widths, every layer attention
    and a dense MLP."""
    return cfg.replace(attn_period=0, xlstm_slstm_every=0,
                       moe=cfg.moe.__class__())


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: str | torch.device = "cuda", *,
                pack: bool = False) -> Params:
    """Random weights drawn on ``device`` from ``generator`` (which must
    live on that device) with the JAX package's distributions; an MoE
    layer's router and f32 expert stacks [E, D, F] / [E, F, D] too.
    In the reference's order: the embedding, the lm head, the decoder
    blocks, an encoder-decoder's encoder (blocks, then its positional
    embedding [encoder_seq, D]), a vision stub's ``vision_proj``.

    ``pack`` packs each layer's linears as soon as it is drawn and drops
    its float weights (``prepack_for_serving`` of the whole tree, bit
    for bit, the draws being the same): the float tree never lives
    whole, so loading peaks at the packed tree and one float layer."""
    dev = resolve_device(device)
    transformer.check_supported(cfg)

    def packed(tree):
        return prepack_for_serving(tree, cfg) if pack else tree

    params: Params = {
        "embed": layers.embed_init(generator, cfg.vocab_size, cfg.d_model,
                                   dev),
        "final_norm": layers.make_norm(cfg, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.randn(
            (cfg.d_model, layers.padded_vocab(cfg.vocab_size)),
            generator=generator, device=dev) * 0.02
    params["blocks"] = [
        packed(transformer.init_block(generator, cfg, j, dev,
                                      cross=cfg.is_encoder_decoder))
        for j in range(cfg.num_layers)]
    if cfg.is_encoder_decoder:
        enc = encoder_config(cfg)
        params["encoder"] = {
            "blocks": [packed(transformer.init_block(generator, enc, 0, dev))
                       for _ in range(cfg.encoder_layers)],
            "norm": layers.make_norm(cfg, dev),
            "pos_embed": torch.randn((cfg.encoder_seq, cfg.d_model),
                                     generator=generator, device=dev) * 0.02,
        }
    if cfg.vision_stub:
        params["vision_proj"] = packed(
            layers.linear_init(generator, cfg.d_model, cfg.d_model,
                               device=dev))
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
    mLSTM, sLSTM and Mamba."""
    dev = resolve_device(device)
    return [transformer.make_block_state(cfg, j, batch, max_len, dev)
            for j in range(cfg.num_layers)]


def init_paged_state(cfg: ModelConfig, batch: int, max_len: int, *,
                     num_blocks: int, block_size: int,
                     device: str | torch.device = "cuda") -> list[Params]:
    """Per-layer KV pools of ``num_blocks + 1`` blocks (block 0 is the
    reserved trash block — ``serve.kv_pool``) for attention layers; the
    recurrent layers keep their per-slot ``[batch, ...]`` rows beside
    them (a hybrid stack holds both).  A pure-recurrent stack has no
    pool."""
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
    and masking.  Each mixer kind has its own init values
    (``transformer.STATE_INIT``): an xLSTM ``m`` at -1e30, the rest
    (Mamba's ``h`` and conv window too) zero."""
    for j, st in enumerate(states):
        mk = transformer.layer_kinds(cfg, j)[0]
        if mk == "attn":
            if row is None:
                for t in st.values():
                    t[:, kv_from:].zero_()
            continue
        init = transformer.STATE_INIT[mk]
        for name, t in st.items():
            (t if row is None else t[row]).fill_(init[name])


def _run_encoder(params: Params, cfg: ModelConfig,
                encoder_frames: torch.Tensor) -> torch.Tensor:
    """The encoder over precomputed frame embeddings [B, T, D] (the conv
    front end is a stub, as in the reference): the positional embedding
    added, then per block bidirectional self-attention (K and V of the
    block's own input through ``cross_kv``: a full mask, no RoPE) and
    the MLP, then the final norm.  The frames' dtype is the encoder's:
    ``forward`` passes them in the activation dtype, the engine as
    given, as the reference's do."""
    enc_cfg = encoder_config(cfg)
    enc = params["encoder"]
    t = encoder_frames.shape[1]
    h = encoder_frames + enc["pos_embed"][None, :t]
    positions = torch.arange(t, dtype=torch.int32, device=h.device)
    hd = enc_cfg.resolved_head_dim
    for blk in enc["blocks"]:
        hh = layers.norm_apply(blk["norm1"], h, enc_cfg)
        b = hh.shape[0]
        k, v = (layers.linear(blk["attn"][w], hh, enc_cfg.pum).reshape(
            b, t, enc_cfg.num_kv_heads, hd) for w in ("wk", "wv"))
        hh, _ = attention.attention(blk["attn"], hh, enc_cfg,
                                    positions=positions, cross_kv=(k, v),
                                    use_rope=False)
        h = h + hh
        hh = layers.norm_apply(blk["norm2"], h, enc_cfg)
        h = h + mlp.mlp(blk["mlp"], hh, enc_cfg)
    return layers.norm_apply(enc["norm"], h, cfg)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            states: list[Params] | None = None,
            cache_index: torch.Tensor | int | None = None,
            image_embeds: torch.Tensor | None = None,
            encoder_frames: torch.Tensor | None = None,
            encoder_out: torch.Tensor | None = None,
            last_only: bool = False,
            block_table: torch.Tensor | None = None,
            kv_len: int | None = None,
            write_table: torch.Tensor | None = None,
            commit: bool = True, collect_states: bool = False,
            remat: bool = False, with_aux: bool = False,
            ) -> tuple:
    """tokens: [B, S] int -> (logits [B, S or 1, V_padded] f32, states),
    and with ``with_aux`` a third value: the MoE FFNs' aux losses
    (``{"moe_lb", "moe_z"}`` summed over the layers, as the reference's
    train mode returns them; ``{}`` without MoE).

    Modes: train/score (states None; ``remat`` recomputes each block in
    the backward, ``torch.utils.checkpoint`` around it, as the
    reference's ``jax.checkpoint`` around each group); prefill
    (contiguous states, cache_index 0); decode (cache_index a scalar
    or [B] per-slot depths); paged (states from
    :func:`init_paged_state`, per-row ``block_table`` [B, W] and the
    engine window ``kv_len``).  KV
    storage is written in place; recurrent states too, unless
    ``commit=False``, which leaves them as they were and returns their
    successors in the returned list (the paged slot step keeps the rows
    of slots that are not decoding: ``serve.kv_pool``).
    ``collect_states`` (the speculative verify step's, with states):
    every recurrent leaf of the returned list gains a position axis,
    [B, S, ...], index j the state after position j, bit for bit what
    j + 1 one-token steps leave; it writes no recurrent state (it
    implies ``commit=False``), while KV storage is written as ever.
    The f32 lm head is a :func:`~repro_torch.core.pum_linear.float_matmul`
    (position by position under ``pum_linear.positionwise``).

    ``image_embeds`` [B, N, D] (a vision stub's): projected through
    ``vision_proj`` in the activation dtype and put in front of the
    token embeddings; S and the positions are then the joined length's.
    ``encoder_frames`` [B, T, D] (an encoder-decoder's) runs the encoder
    (:func:`_run_encoder`, the frames cast to the activation dtype), or
    pass its output as ``encoder_out``; the decoder blocks attend over
    it."""
    b, s = tokens.shape
    dev = tokens.device
    h = params["embed"][tokens].to(
        torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)
    if image_embeds is not None:
        img = layers.linear(params["vision_proj"], image_embeds.to(h.dtype),
                            cfg.pum)
        h = torch.cat([img, h], dim=1)
        s = h.shape[1]
    if cache_index is not None:
        cache_index = torch.as_tensor(cache_index, dtype=torch.int32,
                                      device=dev)
        offs = torch.arange(s, dtype=torch.int32, device=dev)
        positions = (cache_index[:, None] + offs[None, :]
                     if cache_index.ndim == 1 else cache_index + offs)
    else:
        positions = torch.arange(s, dtype=torch.int32, device=dev)
    if (cfg.is_encoder_decoder and encoder_out is None
            and encoder_frames is not None):
        encoder_out = _run_encoder(params, cfg, encoder_frames.to(h.dtype))

    out_states = None if states is None else []
    aux_total: dict[str, torch.Tensor] = {}
    recompute = remat and states is None
    if recompute:
        # the recomputation runs where the backward does (on the card, a
        # thread of its own): it takes the caller's kernel selection
        restore = registry.snapshot()
    for j, blk in enumerate(params["blocks"]):
        st = states[j] if states is not None else None
        aux = {} if with_aux else None
        if recompute:
            def block(h, blk=blk, j=j, aux=aux):
                h, _ = transformer.apply_block(
                    blk, h, cfg, j, positions=positions,
                    encoder_out=encoder_out, aux=aux)
                return h, aux

            h, aux = checkpoint.checkpoint(
                block, h, use_reentrant=False,
                context_fn=lambda: (contextlib.nullcontext(), restore()))
        else:
            h, st = transformer.apply_block(
                blk, h, cfg, j, positions=positions, state=st,
                cache_index=cache_index, encoder_out=encoder_out,
                block_table=block_table,
                kv_len=kv_len, write_table=write_table, commit=commit,
                collect_states=collect_states, aux=aux)
        if out_states is not None:
            out_states.append(st)
        for k, v in (aux or {}).items():
            aux_total[k] = aux_total[k] + v if k in aux_total else v

    h = layers.norm_apply(params["final_norm"], h, cfg)
    if last_only:
        h = h[:, -1:]
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = pum_linear.float_matmul(h.to(torch.float32),
                                     head.to(torch.float32))
    if with_aux:
        return logits, out_states, aux_total
    return logits, out_states
