"""Architecture registry: ``get_config("olmoe-1b-7b")`` etc.

Importing ``repro_torch.configs`` registers all shipped architectures.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config.base import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {}

_SHIPPED_MODULES = [
    "olmoe_1b_7b",
    "llama4_scout_17b_a16e",
    "llama3_2_1b",
    "deepseek_67b",
    "qwen3_1_7b",
    "smollm_360m",
    "musicgen_medium",
    "xlstm_125m",
    "zamba2_2_7b",
    "internvl2_26b",
    "bert_base_pit",
]


def register_config(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY and _REGISTRY[cfg.name] != cfg:
        raise ValueError(f"config {cfg.name!r} already registered with different values")
    _REGISTRY[cfg.name] = cfg
    return cfg


def _ensure_loaded() -> None:
    for mod in _SHIPPED_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)
