"""Shared model building blocks (counterpart of ``repro.models.common``).

Plain functions on tensors.  Norms and rotary embeddings compute in fp32
and cast back to the input's dtype, as the reference does; initialisers
draw from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (int).

    Split-half rotation (not interleaved), computed in fp32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # [hd/2]
    pos = torch.as_tensor(positions, device=x.device)
    angles = pos[..., None].float() * freqs  # [..., seq, hd/2]
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    if name == "swiglu":
        return F.silu
    if name in ("geglu", "gelu"):
        return _gelu_tanh
    raise ValueError(name)


def is_gated(name: str) -> bool:
    return name in ("swiglu", "geglu")


# ---------------------------------------------------------------------------
# initialisers
# ---------------------------------------------------------------------------


def dense_init(
    generator: torch.Generator,
    shape,
    in_dim: Optional[int] = None,
    dtype=torch.float32,
    device=None,
):
    """Normal × 1/sqrt(fan_in), drawn in fp32 then cast."""
    fan_in = in_dim if in_dim is not None else shape[0]
    std = 1.0 / math.sqrt(fan_in)
    w = torch.randn(
        shape, generator=generator, dtype=torch.float32, device=device
    )
    return (w * std).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype=torch.float32,
               device=None):
    """Normal × 0.02, drawn in fp32 then cast."""
    w = torch.randn(
        shape, generator=generator, dtype=torch.float32, device=device
    )
    return (w * 0.02).to(dtype)
