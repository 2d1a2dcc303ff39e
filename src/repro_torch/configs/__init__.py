"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig  # noqa: F401

_ARCHS = {
    "pixtral-12b": "pixtral_12b",
    "musicgen-medium": "musicgen_medium",
    "gemma2-27b": "gemma2_27b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "phi3-medium-14b": "phi3_medium_14b",
    "nemotron-4-15b": "nemotron_4_15b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen2-0.5b": "qwen2_0_5b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-350m": "xlstm_350m",
}


def list_archs() -> list[str]:
    return sorted(_ARCHS)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")
    return mod.CONFIG
