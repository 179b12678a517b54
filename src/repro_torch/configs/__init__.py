"""Architecture registry: ``--arch <id>`` → ModelConfig (the reference's ten
architectures, each file a copy of its ``repro.configs`` counterpart)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES = {
    "stablelm-1.6b": "stablelm_1_6b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen3-8b": "qwen3_8b",
    "starcoder2-15b": "starcoder2_15b",
    "whisper-tiny": "whisper_tiny",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "rwkv6-3b": "rwkv6_3b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "internvl2-2b": "internvl2_2b",
}

ARCH_NAMES: List[str] = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_module(name: str):
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}
