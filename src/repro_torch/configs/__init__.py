"""Architecture config registry (``--arch <id>``)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES, InputShape, MLAConfig, MoEConfig, ModelConfig, SSMConfig,
)

# arch-id -> module name
_REGISTRY = {
    "hymba-1.5b": "hymba_1_5b",
    "mamba2-780m": "mamba2_780m",
    "qwen2.5-14b": "qwen2_5_14b",
    "whisper-large-v3": "whisper_large_v3",
    "internlm2-20b": "internlm2_20b",
    "deepseek-7b": "deepseek_7b",
    "smollm-135m": "smollm_135m",
    "internvl2-26b": "internvl2_26b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "chatglm-6b": "chatglm_6b",
}

ARCH_IDS = [a for a in _REGISTRY if a != "chatglm-6b"]  # the 10 assigned
ALL_ARCH_IDS = list(_REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    key = arch_id.replace("_", "-").lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[key]}")
    return mod.CONFIG
