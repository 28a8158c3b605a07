"""Architecture registry (port of ``repro.configs.registry``).

The ids are the reference's ten. Only ``qwen2-0.5b`` (dense, GQA) is
ported so far; the others raise until their model family lands
(ROADMAP queue 1 item 13).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "granite-moe-3b-a800m",
    "deepseek-v3-671b",
    "qwen2-0.5b",
    "internlm2-20b",
    "gemma3-27b",
    "gemma-2b",
    "hymba-1.5b",
    "xlstm-125m",
    "qwen2-vl-7b",
    "whisper-tiny",
]

PORTED = ("qwen2-0.5b",)


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported yet (ported: {list(PORTED)}; "
            "ROADMAP queue 1 item 13)")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
