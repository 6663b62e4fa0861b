"""Architecture registry of the port: ``get(name)`` returns the full
published config, ``get_reduced(name)`` a same-family miniature for CPU
tests.  It carries the configs the port serves at full width: the
dense Qwen2.5-3B, the recurrent xLSTM-350M (mLSTM and sLSTM mixers),
and the MoE family's OLMoE-1B-7B and granite-moe-1b-a400m (attention
with a top-k routed expert FFN in every layer)."""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

ARCH_IDS = {
    "qwen2.5-3b": "qwen2_5_3b",
    "xlstm-350m": "xlstm_350m",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
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
