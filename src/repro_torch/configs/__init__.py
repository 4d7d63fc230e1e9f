"""Assigned-architecture registry: ``get_config(name)`` / ``--arch <id>``
(the same shape-only data as :mod:`repro.configs`)."""

from __future__ import annotations

import importlib

ARCHITECTURES = [
    "deepseek_v3_671b",
    "granite_moe_3b_a800m",
    "llama_3_2_vision_11b",
    "mamba2_780m",
    "starcoder2_15b",
    "deepseek_7b",
    "qwen1_5_4b",
    "qwen3_0_6b",
    "musicgen_large",
    "jamba_1_5_large_398b",
]


def normalize(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{normalize(name)}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCHITECTURES}
