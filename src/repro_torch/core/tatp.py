"""TATP — topology-aware tensor-stream partitioned matmul (counterpart of
``repro.core.tatp``), forward at ring degree 1.

``O[M, K] = I[M, N] @ W[N, K]``: on a ring of R devices each device holds an
M-block of the input and a K-block of the weight and computes its output
row-block tile by tile while the weight blocks stream past over one-hop
transfers.  At R = 1 the whole linear is the one local tile, so
:func:`ag_matmul_stream_w` is a single call of its ``dot`` hook — here the
hand-written Hopper GEMM (:func:`repro_torch.kernels.tatp_matmul.ops.
tatp_dot`), which accumulates in fp32 and casts to the input's dtype as the
reference's ``_dot`` does.

The ring (R > 1), the wire codecs and the explicit backward are ROADMAP.md
items A3 (ring) and A2 (train step).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import not_ported
from repro_torch.kernels.tatp_matmul.ops import tatp_dot

Dot = Callable[..., torch.Tensor]


def ag_matmul_stream_w(x, w, axis: str, axis_size: int, *,
                       bidirectional: bool = True, dot: Dot = tatp_dot,
                       wire: str = "native"):
    """``y[..., m, R*kb] = x[..., m, N] @ W_full`` with W K-sharded and
    streamed; at R = 1, ``dot(x, w)``."""
    if axis_size != 1:
        raise not_ported(f"the TATP ring (axis_size={axis_size})", "A3")
    return dot(x, w)


def tatp_matmul(x, w, axis: str, axis_size: int, bidirectional: bool = True,
                wire: str = "native", dot: Dot = tatp_dot):
    """TATP streamed linear, forward only (no autograd in this slice)."""
    return ag_matmul_stream_w(x, w, axis, axis_size,
                              bidirectional=bidirectional, dot=dot,
                              wire=wire)
