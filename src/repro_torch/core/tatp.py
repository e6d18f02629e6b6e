"""TATP — topology-aware tensor-stream partitioned matmul (counterpart of
``repro.core.tatp``).

``O[M, K] = I[M, N] @ W[N, K]``: on a ring of R ranks each rank holds an
M-block of the input and a K-block of the weight and computes its output
row-block tile by tile while the weight blocks stream past over one-hop
transfers (:meth:`repro_torch.core.dist.Dist.ppermute`).  Every tile is
one call of the ``dot`` hook — the hand-written Hopper GEMM
(:func:`repro_torch.kernels.tatp_matmul.ops.tatp_dot`), which accumulates
in fp32 and casts to its first operand's dtype as the reference's
``_dot`` does.  At R = 1 each schedule is that one call:

* forward, :func:`ag_matmul_stream_w`: ``y = dot(x, w)``; above R = 1
  the ring, bidirectional (⌈R/2⌉ rounds, two fresh tiles a round; even R
  ends with one antipodal tile) or naive (R - 1 shifts one way), its
  blocks on the wire natively, as bf16 or as fp8 e4m3 with one fp32 scale
  a block (:func:`wire_encode`; the own tile always at full precision);
* dgrad, :func:`dgrad_stream_w`: ``dx = dot(dy, w.T)``, in x's dtype;
* wgrad, :func:`wgrad_rs`: ``dw = dot(x.T, dy)``, cast to w's dtype.

:func:`tatp_matmul` ties them together as the reference's ``custom_vjp``
does, as a ``torch.autograd.Function``; the transposed operands are views,
which the GEMM reads through their strides.  Under the ``tatp_outputs``
remat policy its output is saved (:mod:`repro_torch.core.remat`), so the
recompute runs no forward product.  The backward rings (dgrad, wgrad,
``wire_relay``'s straight-through gradient) are ROADMAP.md item A3a: above
R = 1 they raise, and so does :func:`tatp_matmul` under autograd.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import not_ported
from repro_torch.core import remat
from repro_torch.kernels.tatp_matmul.ops import tatp_dot

Dot = Callable[..., torch.Tensor]

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def _perm_from_right(r: int):
    """rank p receives from rank p+1 (blocks move toward lower indices)."""
    return [((p + 1) % r, p) for p in range(r)]


def _perm_from_left(r: int):
    return [((p - 1) % r, p) for p in range(r)]


def _shift_perm(r: int, shift: int):
    """Values move by +shift around the ring (rank p receives from
    p - shift)."""
    return [((p - shift) % r, p) for p in range(r)]


def _n_rounds(r: int) -> int:
    return r // 2 + 1 if r % 2 == 0 else (r + 1) // 2


def _train_ring(what: str, axis_size: int):
    if axis_size != 1:
        raise not_ported(f"{what} over the ring (axis_size={axis_size})",
                         "A3a")


# ---------------------------------------------------------------------------
# wire codecs: raw bytes on the wire
# ---------------------------------------------------------------------------


def wire_encode(x, wire: str):
    """``x`` as the tuple of tensors that travel: ``fp8`` — e4m3 codes as
    uint8 bytes and one fp32 scale (the block's absolute max over 448);
    ``bf16`` — bf16 bits as uint8 bytes; ``native`` — ``x`` itself.
    Every division is tensor by tensor (a CUDA division by a Python
    scalar multiplies by its reciprocal, which rounds differently)."""
    if wire == "fp8":
        xf = x.float()
        big = torch.tensor(FP8_MAX, dtype=torch.float32, device=x.device)
        scale = xf.abs().amax().clamp_min(1e-12) / big
        q = (xf / scale).to(torch.float8_e4m3fn)
        return (q.view(torch.uint8), scale)
    if wire == "bf16":
        return (x.to(torch.bfloat16).view(torch.uint8),)
    if wire == "native":
        return (x,)
    raise ValueError(f"unknown wire {wire!r}")


def wire_decode(blk, wire: str, dtype):
    """The block :func:`wire_encode` sent, in ``dtype``."""
    if wire == "fp8":
        q, scale = blk
        return (q.view(torch.float8_e4m3fn).float() * scale).to(dtype)
    if wire == "bf16":
        return blk[0].view(torch.bfloat16).to(dtype)
    return blk[0]


def wire_relay(x, axis: str, axis_size: int, shift: int,
               wire: str = "native", *, dist):
    """One ring hop of ``x`` by ``shift`` on the ``wire`` format (no
    gradient: its straight-through backward is the train ring's,
    A3a)."""
    if torch.is_grad_enabled() and x.requires_grad:
        _train_ring("wire_relay's backward", axis_size)
    enc = dist.ppermute(wire_encode(x, wire), axis,
                        _shift_perm(axis_size, shift))
    return wire_decode(enc, wire, x.dtype)


# ---------------------------------------------------------------------------
# forward: all-gather-overlap matmul, streaming the weight tiles
# ---------------------------------------------------------------------------


def ag_matmul_stream_w(x, w, axis: str, axis_size: int, *,
                       bidirectional: bool = True, dot: Dot = tatp_dot,
                       wire: str = "native", dist=None):
    """``y[..., m, R*kb] = x[..., m, N] @ W_full`` with W K-sharded and
    streamed: ``w`` [N, kb] is this rank's block (index
    ``dist.axis_index(axis)``).  Both directions of a bidirectional round
    move in one batch of transfers; the tiles are independent, so the
    order they are computed in changes nothing."""
    r = axis_size
    if r == 1:
        return dot(x, w)
    kb = w.shape[-1]
    y = torch.empty(*x.shape[:-1], r * kb, dtype=x.dtype, device=x.device)

    def put(tile, j):
        y[..., j * kb:(j + 1) * kb] = tile

    def use(blk):
        return wire_decode(blk, wire, w.dtype)

    i = dist.axis_index(axis)
    w_enc = wire_encode(w, wire)
    put(dot(x, w), i)  # own block at full precision
    if not bidirectional:
        blk = w_enc
        for t in range(1, r):
            blk = dist.ppermute(blk, axis, _perm_from_right(r))
            put(dot(x, use(blk)), (i + t) % r)
        return y
    up, dn = w_enc, w_enc
    for t in range(1, _n_rounds(r)):
        if r % 2 == 0 and t == r // 2:  # antipodal: one block, from right
            up = dist.ppermute(up, axis, _perm_from_right(r))
            put(dot(x, use(up)), (i + t) % r)
            continue
        # up from the right (block i+t), dn from the left (block i-t)
        up, dn = dist.ppermute_many(
            [(up, _perm_from_right(r)), (dn, _perm_from_left(r))], axis)
        put(dot(x, use(up)), (i + t) % r)
        put(dot(x, use(dn)), (i - t) % r)
    return y


# ---------------------------------------------------------------------------
# backward schedules (the rings above R = 1 are the train slice, A3a)
# ---------------------------------------------------------------------------


def dgrad_stream_w(dy, w, axis: str, axis_size: int, *,
                   bidirectional: bool = True, dot: Dot = tatp_dot,
                   wire: str = "native", dist=None):
    """``dx[..., m, N] = dy[..., m, R*kb] @ W_full.T``; at R = 1,
    ``dot(dy, w.T)``."""
    _train_ring("dgrad_stream_w", axis_size)
    return dot(dy, w.t())


def wgrad_rs(x, dy, axis: str, axis_size: int, *, bidirectional: bool = True,
             dot: Dot = tatp_dot, dist=None):
    """This rank's ``dW`` block ``[N, kb]``; at R = 1, ``x.T @ dy`` over
    the flattened leading dims, in x's dtype."""
    _train_ring("wgrad_rs", axis_size)
    xm = x.reshape(-1, x.shape[-1])
    dym = dy.reshape(-1, dy.shape[-1])
    return dot(xm.t(), dym)


class _TatpMatmul(torch.autograd.Function):
    """The reference's ``tatp_matmul`` custom_vjp (``_tatp_fwd`` /
    ``_tatp_bwd``): the forward saves (x, w); the backward runs the dgrad
    and wgrad schedules, ``dx`` in x's dtype and ``dw`` cast to w's."""

    @staticmethod
    def forward(ctx, x, w, axis, axis_size, bidirectional, wire, dot, dist):
        _train_ring("tatp_matmul under autograd", axis_size)
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
        return dx, dw, None, None, None, None, None, None


def tatp_matmul(x, w, axis: str, axis_size: int, bidirectional: bool = True,
                wire: str = "native", dot: Dot = tatp_dot, dist=None):
    """TATP streamed linear ``y = x @ W_full`` with the explicit dgrad and
    wgrad schedules as its backward.  Without autograd (no grad mode, or
    no input that requires grad) it is the forward schedule alone; under
    autograd above R = 1 it raises (A3a)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _TatpMatmul.apply(x, w, axis, axis_size, bidirectional, wire,
                                 dot, dist)
    return ag_matmul_stream_w(x, w, axis, axis_size,
                              bidirectional=bidirectional, dot=dot,
                              wire=wire, dist=dist)


# ---------------------------------------------------------------------------
# stream-inputs variant (selective transfer policy) — transposed schedule
# ---------------------------------------------------------------------------


def ag_matmul_stream_x(x, w, axis: str, axis_size: int, *,
                       bidirectional: bool = True, dot: Dot = tatp_dot,
                       dist=None):
    """``y_j[R*m, kb] = I_full @ W_j``: the M-sharded input streamed, the
    weight block stationary; the output is feature-sharded (kb columns,
    all rows).  The transposed schedule of :func:`ag_matmul_stream_w`
    (its tiles read both operands transposed, in place)."""
    if x.dim() != 2:
        raise ValueError("flatten leading dims before ag_matmul_stream_x")
    yt = ag_matmul_stream_w(w.t(), x.t(), axis, axis_size,
                            bidirectional=bidirectional, dot=dot,
                            dist=dist)  # [kb, R*m]
    return yt.t()


def choose_stream(m_loc: int, n: int, kb: int, requested: str = "auto") -> str:
    """Selective transfer policy: stream the smaller sub-tensor (weight
    block N*kb elements, input block m_loc*N)."""
    if requested != "auto":
        return requested
    return "weights" if kb <= m_loc else "inputs"


def stream_blocks(block, axis: str, axis_size: int, n_rounds: int,
                  direction: str = "up", dist=None):
    """``[(t, block_index, block), ...]``: ``block`` relayed ``n_rounds -
    1`` hops one way (``up``: toward lower indices, so rank i sees block
    i + t at round t)."""
    r = axis_size
    i = dist.axis_index(axis) if r > 1 else 0
    perm = _perm_from_right(r) if direction == "up" else _perm_from_left(r)
    sign = 1 if direction == "up" else -1
    out = []
    for t in range(n_rounds):
        out.append((t, (i + sign * t) % r, block))
        if t < n_rounds - 1:
            block = dist.ppermute(block, axis, perm) if r > 1 else block
    return out
