"""Frozen dataclass configuration for the PyTorch port.

A copy of the JAX package's configs that the port runs: ``PUMConfig``
and the ``ModelConfig`` it lives in, ``TrainConfig``, and the one-card
part of ``ShardingConfig``.  The port shares no module with the JAX
package, so the configs are kept field for field alike and the parity
tests build both from the same keyword arguments.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from dataclasses import dataclass, field


# ---------------------------------------------------------------------------
# PUM (paper-technique) execution config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ADCConfig:
    """Analog-to-digital converter model (paper Table 2).

    ``sar``: 1-cycle conversion, 2 units per HCT (multiplexed over bitlines).
    ``ramp``: 256-cycle full conversion, 1 unit, all 64 bitlines in parallel;
    supports early termination at ``early_levels`` levels (paper: AES needs
    only 4 states -> 4 cycles).
    """
    kind: str = "sar"                  # "sar" | "ramp"
    bits: int = 8                      # output resolution
    early_levels: int = 0              # ramp-only: terminate after N levels (0 = full)

    def __post_init__(self):
        assert self.kind in ("sar", "ramp"), self.kind


@dataclass(frozen=True)
class NoiseConfig:
    """Analog non-ideality model (CrossSim-style proxies).

    prog_sigma  — programming noise: relative stddev of stored conductance.
    read_sigma  — per-MVM read noise on bitline current (absolute, in LSBs).
    ir_alpha    — IR-drop proxy: measured current droops quadratically with
                  total bitline current, I_meas = I - ir_alpha * I^2.
    """
    enable: bool = False
    prog_sigma: float = 0.0
    read_sigma: float = 0.0
    ir_alpha: float = 0.0


@dataclass(frozen=True)
class PUMConfig:
    """How linear layers execute (the paper's technique as a feature).

    mode:
      "bf16" — standard dense matmul (baseline float path).
      "int8" — TPU-native symmetric int8 quantised matmul (deployment path;
               single-plane special case of bit-slicing).
      "pum"  — bit-sliced execution: weights decomposed into
               ``weight_bits / bits_per_slice`` planes (vACore abstraction),
               integer plane-matmuls recombined by shift-and-add.  The
               Pallas kernel ``kernels/bitslice_mvm`` fuses recombination
               into the matmul epilogue (the paper's shift-during-transfer
               optimisation, §4.1).
    """
    mode: str = "bf16"                 # "bf16" | "int8" | "pum"
    weight_bits: int = 8
    bits_per_slice: int = 2            # bits stored per analog cell
    input_bits: int = 8
    adc: ADCConfig = field(default_factory=ADCConfig)
    noise: NoiseConfig = field(default_factory=NoiseConfig)
    use_kernel: bool = False           # route through the Pallas kernel
    ibert: bool = False                # integer-only nonlinearities (DCE role)
    # serving fast path: skip the dense bf16 shadow matmul + STE entirely
    # (no gradients flow; forward values are identical to the QAT forward).
    # Weights prepacked via ``repro.core.prepack`` imply this per-layer.
    inference: bool = False

    def __post_init__(self):
        assert self.mode in ("bf16", "int8", "pum"), self.mode
        if self.mode == "pum":
            assert self.weight_bits % self.bits_per_slice == 0

    @property
    def n_slices(self) -> int:
        # one sign bit handled by the differential encoding; magnitude planes
        return max(1, (self.weight_bits - 1 + self.bits_per_slice - 1)
                   // self.bits_per_slice)


# ---------------------------------------------------------------------------
# Model architecture config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    # capacity factor for expert dispatch (dropless-ish; tokens beyond
    # capacity are dropped, standard for TPU MoE)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"     # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: int = 0                  # 0 -> d_model // num_heads
    # attention
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0
    # MoE
    moe: MoEConfig = field(default_factory=MoEConfig)
    moe_layer_period: int = 1          # every k-th layer is MoE (jamba: 2)
    # hybrid (jamba): attention every `attn_period` layers, rest are Mamba
    attn_period: int = 0               # 0 -> all layers attention
    # ssm (mamba) params
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    # xlstm: pattern of block kinds, e.g. ("slstm","mlstm",...)
    xlstm_slstm_every: int = 0         # 0 -> not xlstm; else every k-th is sLSTM
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500            # whisper: 30s @ 50 Hz after conv stub
    # vlm
    vision_stub: bool = False
    num_image_tokens: int = 0
    # norms / activations
    norm_eps: float = 1e-5
    use_rmsnorm: bool = True
    activation: str = "silu"           # silu | gelu
    tie_embeddings: bool = False
    # numerics
    dtype: str = "bfloat16"
    # paper technique
    pum: PUMConfig = field(default_factory=PUMConfig)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Training configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardingConfig:
    """The reference's ``ShardingConfig`` knobs that mean something on
    one card.  Its mesh and serving knobs (``fsdp``, ``seq_shard``,
    ``scan_layers``, ``donate``, ``serve_weight_dtype``) have no
    counterpart: the port's step always writes its results into the
    tensors it was given, where the reference's jit donates them."""
    remat: str = "block"               # "none" | "block" | "full"
    grad_compress: bool = False        # int8 gradients with error feedback
    # cast f32 matrices to bf16 before use (the reference's FSDP gathers
    # then move bf16)
    bf16_params: bool = False

    def __post_init__(self):
        assert self.remat in ("none", "block", "full"), self.remat


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_ckpt")


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatch: int = 0                # 0 -> no accumulation
    learning_rate: float = 3e-4
    warmup_steps: int = 10
    schedule: str = "cosine"           # cosine | wsd | constant
    wsd_decay_frac: float = 0.1
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    ckpt_keep: int = 3


def small_test_config(**kw) -> ModelConfig:
    """A tiny config for CPU tests."""
    base = dict(name="tiny", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=128, vocab_size=256)
    base.update(kw)
    return ModelConfig(**base)
