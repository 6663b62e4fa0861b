"""Architecture registry of the port: ``get(name)`` returns the full
published config, ``get_reduced(name)`` a same-family miniature for CPU
tests.  It carries the configs the port serves at full width: the
dense Qwen2.5-3B and the recurrent xLSTM-350M (mLSTM and sLSTM
mixers)."""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

ARCH_IDS = {
    "qwen2.5-3b": "qwen2_5_3b",
    "xlstm-350m": "xlstm_350m",
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
