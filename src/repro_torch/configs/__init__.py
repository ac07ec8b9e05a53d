"""Architecture registry: one module per assigned architecture.

``get_config(name)`` returns the exact published configuration;
``get_smoke_config(name)`` a reduced same-family config for CPU tests.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig, reduce_for_smoke

ARCHS: List[str] = [
    "hymba_1p5b",
    "qwen2_72b",
    "deepseek_coder_33b",
    "qwen2_0p5b",
    "starcoder2_3b",
    "grok_1_314b",
    "granite_moe_3b_a800m",
    "rwkv6_3b",
    "whisper_base",
    "paligemma_3b",
]

ALIASES: Dict[str, str] = {
    "hymba-1.5b": "hymba_1p5b",
    "qwen2-72b": "qwen2_72b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen2-0.5b": "qwen2_0p5b",
    "starcoder2-3b": "starcoder2_3b",
    "grok-1-314b": "grok_1_314b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "rwkv6-3b": "rwkv6_3b",
    "whisper-base": "whisper_base",
    "paligemma-3b": "paligemma_3b",
}


def canonical(name: str) -> str:
    return ALIASES.get(name, name)


def get_config(name: str, **overrides) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    cfg = mod.config()
    if overrides:
        import dataclasses
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_smoke_config(name: str) -> ModelConfig:
    return reduce_for_smoke(get_config(name))


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}
