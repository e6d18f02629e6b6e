"""Config registry for the ported architectures:
``get_config(arch_id)`` / ``get_reduced(arch_id)``.

Only architectures whose every layer kind the port runs are registered;
any other name raises ``KeyError`` (the reference's registry lists all
eleven; ROADMAP.md queues the rest).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    ModelConfig,
    ParallelConfig,
    ShapeConfig,
    reduced_config,
)

# arch id -> module name (ported architectures only)
ARCHITECTURES: dict[str, str] = {
    "deepseek-7b": "deepseek_7b",
    "mamba2-780m": "mamba2_780m",
    "zamba2-2.7b": "zamba2_2_7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "deepseek-v3-moe": "deepseek_v3_moe",
}


def _module(arch: str):
    if arch not in ARCHITECTURES:
        raise KeyError(
            f"arch {arch!r} is not ported to repro_torch yet "
            f"(ported: {sorted(ARCHITECTURES)}; see ROADMAP.md)"
        )
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
