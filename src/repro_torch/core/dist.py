"""Distribution context (counterpart of ``repro.core.dist``).

The reference's ``Dist`` wraps a JAX mesh with ``pod``/``data``/``model``
axes and its model code runs inside ``shard_map``.  This slice of the port
runs on one device: ``Dist`` carries that ``torch.device`` and reports
``model_degree == 1``.  The multi-rank ``Dist`` over
``torch.distributed`` groups is ROADMAP.md item A3 (the ring).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

MODEL_AXIS = "model"  # the TATP ring axis


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device must exist.  Entry points
    call this so a missing GPU raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; repro_torch runs on the GPU by "
            "default — pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev


@dataclass(frozen=True)
class Dist:
    """Single-device distribution descriptor."""

    device: torch.device
    model_axis: str = MODEL_AXIS

    @property
    def model_degree(self) -> int:
        return 1
