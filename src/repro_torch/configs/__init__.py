"""Architecture registry of the port: ``get(name)`` returns the full
published config, ``get_reduced(name)`` a same-family miniature for CPU
tests.  It carries the reference's ten configs, value for value: the
dense Qwen2.5-3B, glm4-9b, minicpm-2b and command-r-plus-104b (the card
holds a cut of its 64 layers), the recurrent xLSTM-350M (mLSTM and
sLSTM mixers), the MoE family's OLMoE-1B-7B and granite-moe-1b-a400m
(attention with a top-k routed expert FFN in every layer), the hybrid
Jamba-v0.1 (Mamba and attention mixers 7:1, MoE FFNs in every other
layer; the card holds one 8-layer period of it, not its 32 layers), the
vision-language llava-next-mistral-7b (a projected image-embedding
prefix) and the encoder-decoder whisper-tiny (cross-attention over an
encoder of precomputed frames)."""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

ARCH_IDS = {
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "glm4-9b": "glm4_9b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen2.5-3b": "qwen2_5_3b",
    "minicpm-2b": "minicpm_2b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "xlstm-350m": "xlstm_350m",
    "whisper-tiny": "whisper_tiny",
}


def _module(name: str):
    if name not in ARCH_IDS:
        raise ValueError(f"unknown arch {name!r}; the port has "
                         f"{sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_IDS[name]}")


def get(name: str) -> ModelConfig:
    return _module(name).config()


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()


def all_arch_ids() -> list[str]:
    return list(ARCH_IDS)
