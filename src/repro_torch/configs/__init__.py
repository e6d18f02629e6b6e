"""Config registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

Every architecture of the reference's registry is registered (the dense,
SSM, hybrid and MoE decoders, the vision-prefixed internvl2-1b and the
encoder-decoder seamless-m4t-large-v2), each a copy of its reference
config; any other name raises ``KeyError``.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    ModelConfig,
    ParallelConfig,
    ShapeConfig,
    reduced_config,
)

# arch id -> module name
ARCHITECTURES: dict[str, str] = {
    "deepseek-7b": "deepseek_7b",
    "gemma-7b": "gemma_7b",
    "gemma2-9b": "gemma2_9b",
    "qwen2-72b": "qwen2_72b",
    "internvl2-1b": "internvl2_1b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "mamba2-780m": "mamba2_780m",
    "zamba2-2.7b": "zamba2_2_7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "deepseek-v3-moe": "deepseek_v3_moe",
}


def _module(arch: str):
    if arch not in ARCHITECTURES:
        raise KeyError(
            f"unknown arch {arch!r} (known: {sorted(ARCHITECTURES)})")
    mod = ARCHITECTURES[arch]
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


__all__ = [
    "ARCHITECTURES",
    "ModelConfig",
    "ParallelConfig",
    "ShapeConfig",
    "get_config",
    "get_reduced",
    "reduced_config",
]
