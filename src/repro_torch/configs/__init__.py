"""Architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (LM_SHAPES, ModelConfig, RuntimeConfig,
                                ShapeConfig, applicable_shapes)

_MODULES = {
    "mamba2-2.7b": "mamba2_2p7b",
    "deepseek-7b": "deepseek_7b",
    "qwen2.5-32b": "qwen2p5_32b",
    "qwen2.5-14b": "qwen2p5_14b",
    "minitron-8b": "minitron_8b",
    "hubert-xlarge": "hubert_xlarge",
    "paligemma-3b": "paligemma_3b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "zamba2-7b": "zamba2_7b",
    "brainslug-cnn": "brainslug_cnn",
}

ARCH_IDS = tuple(k for k in _MODULES if k != "brainslug-cnn")


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


__all__ = ["ARCH_IDS", "LM_SHAPES", "ModelConfig", "RuntimeConfig",
           "ShapeConfig", "applicable_shapes", "get_config"]
