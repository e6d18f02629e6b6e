"""TATP — topology-aware tensor-stream partitioned matmul (counterpart of
``repro.core.tatp``) at ring degree 1, forward and backward.

``O[M, K] = I[M, N] @ W[N, K]``: on a ring of R devices each device holds an
M-block of the input and a K-block of the weight and computes its output
row-block tile by tile while the weight blocks stream past over one-hop
transfers.  At R = 1 the whole linear is the one local tile, so each of the
three schedules is a single call of its ``dot`` hook — here the
hand-written Hopper GEMM (:func:`repro_torch.kernels.tatp_matmul.ops.
tatp_dot`), which accumulates in fp32 and casts to its first operand's
dtype as the reference's ``_dot`` does:

* forward, :func:`ag_matmul_stream_w`: ``y = dot(x, w)``;
* dgrad, :func:`dgrad_stream_w`: ``dx = dot(dy, w.T)``, in x's dtype;
* wgrad, :func:`wgrad_rs`: ``dw = dot(x.T, dy)``, cast to w's dtype.

:func:`tatp_matmul` ties them together as the reference's ``custom_vjp``
does, as a ``torch.autograd.Function``; the transposed operands are views,
which the GEMM reads through their strides.  Under the ``tatp_outputs``
remat policy its output is saved (:mod:`repro_torch.core.remat`), so the
recompute runs no forward product.  The ring (R > 1) and the wire codecs
are ROADMAP.md item A3.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import not_ported
from repro_torch.core import remat
from repro_torch.kernels.tatp_matmul.ops import tatp_dot

Dot = Callable[..., torch.Tensor]


def _check_degree(axis_size: int):
    if axis_size != 1:
        raise not_ported(f"the TATP ring (axis_size={axis_size})", "A3")


def ag_matmul_stream_w(x, w, axis: str, axis_size: int, *,
                       bidirectional: bool = True, dot: Dot = tatp_dot,
                       wire: str = "native"):
    """``y[..., m, R*kb] = x[..., m, N] @ W_full`` with W K-sharded and
    streamed; at R = 1, ``dot(x, w)``."""
    _check_degree(axis_size)
    return dot(x, w)


def dgrad_stream_w(dy, w, axis: str, axis_size: int, *,
                   bidirectional: bool = True, dot: Dot = tatp_dot,
                   wire: str = "native"):
    """``dx[..., m, N] = dy[..., m, R*kb] @ W_full.T``; at R = 1,
    ``dot(dy, w.T)``."""
    _check_degree(axis_size)
    return dot(dy, w.t())


def wgrad_rs(x, dy, axis: str, axis_size: int, *, bidirectional: bool = True,
             dot: Dot = tatp_dot):
    """This die's ``dW`` block ``[N, kb]``; at R = 1, ``x.T @ dy`` over the
    flattened leading dims, in x's dtype."""
    _check_degree(axis_size)
    xm = x.reshape(-1, x.shape[-1])
    dym = dy.reshape(-1, dy.shape[-1])
    return dot(xm.t(), dym)


class _TatpMatmul(torch.autograd.Function):
    """The reference's ``tatp_matmul`` custom_vjp (``_tatp_fwd`` /
    ``_tatp_bwd``): the forward saves (x, w); the backward runs the dgrad
    and wgrad schedules, ``dx`` in x's dtype and ``dw`` cast to w's."""

    @staticmethod
    def forward(ctx, x, w, axis, axis_size, bidirectional, wire, dot):
        ctx.save_for_backward(x, w)
        ctx.cfg = (axis, axis_size, bidirectional, wire, dot)
        # tatp_outputs saves y: the reference's "tatp_y"
        return remat.saved_or_run("linear", lambda: ag_matmul_stream_w(
            x, w, axis, axis_size, bidirectional=bidirectional, dot=dot,
            wire=wire))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        axis, axis_size, bidirectional, wire, dot = ctx.cfg
        if dy.stride(-1) != 1:  # e.g. the expanded cotangent of a sum
            dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = dgrad_stream_w(dy, w, axis, axis_size,
                                bidirectional=bidirectional, dot=dot,
                                wire=wire)
        if ctx.needs_input_grad[1]:
            dw = wgrad_rs(x, dy, axis, axis_size,
                          bidirectional=bidirectional, dot=dot).to(w.dtype)
        return dx, dw, None, None, None, None, None


def tatp_matmul(x, w, axis: str, axis_size: int, bidirectional: bool = True,
                wire: str = "native", dot: Dot = tatp_dot):
    """TATP streamed linear ``y = x @ W_full`` with the explicit dgrad and
    wgrad schedules as its backward.  Without autograd (no grad mode, or
    no input that requires grad) it is the forward schedule alone."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _TatpMatmul.apply(x, w, axis, axis_size, bidirectional, wire,
                                 dot)
    return ag_matmul_stream_w(x, w, axis, axis_size,
                              bidirectional=bidirectional, dot=dot,
                              wire=wire)
