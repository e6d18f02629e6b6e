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
which the GEMM reads through their strides.  Above R = 1 the backward rings
are the reference's: the dgrad streams the weight blocks again (on the
forward's wire) and sums its tiles locally, each tile ``dot(dy[..., j
block], w_j.T)``; the wgrad is a reduce-scatter ring whose partial ``[N,
kb]`` accumulators travel (natively) and collect each rank's tile
``dot(x.T, dy[..., j block])``, two half-ring accumulators a block when
bidirectional.  :func:`wire_relay`'s straight-through backward sends the
cotangent along the inverse hop at native precision.  Under the
``tatp_outputs`` remat policy its output is saved
(:mod:`repro_torch.core.remat`), so the recompute runs no forward product.
"""

from __future__ import annotations

from typing import Callable

import torch

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


def _relay(xs, axis, axis_size, shift, wire, dist):
    """The tensors ``xs`` one hop by ``shift`` on ``wire``, all in one
    batch of point-to-point operations."""
    encs = [wire_encode(x, wire) for x in xs]
    moved = dist.ppermute(tuple(t for e in encs for t in e), axis,
                          _shift_perm(axis_size, shift))
    out, k = [], 0
    for x, e in zip(xs, encs):
        out.append(wire_decode(moved[k:k + len(e)], wire, x.dtype))
        k += len(e)
    return tuple(out)


class _WireRelay(torch.autograd.Function):
    """:func:`wire_relay` under autograd (the reference's custom_vjp): the
    cotangents ride the inverse hop at native precision, in one batch."""

    @staticmethod
    def forward(ctx, axis, axis_size, shift, wire, dist, *xs):
        ctx.cfg = (axis, axis_size, shift, dist)
        return _relay(xs, axis, axis_size, shift, wire, dist)

    @staticmethod
    def backward(ctx, *gs):
        axis, axis_size, shift, dist = ctx.cfg
        back = dist.ppermute(tuple(gs), axis, _shift_perm(axis_size, -shift))
        return (None, None, None, None, None, *back)


def wire_relay(x, axis: str, axis_size: int, shift: int,
               wire: str = "native", *, dist):
    """One ring hop of ``x`` by ``shift`` on the ``wire`` format, with the
    straight-through backward of :class:`_WireRelay`.  ``x`` is a tensor,
    or a tuple of tensors that move in one batch (each encoded on its own,
    bitwise what separate hops would deliver); the result has its
    structure."""
    xs = x if isinstance(x, tuple) else (x,)
    if torch.is_grad_enabled() and any(t.requires_grad for t in xs):
        out = _WireRelay.apply(axis, axis_size, shift, wire, dist, *xs)
    else:
        out = _relay(xs, axis, axis_size, shift, wire, dist)
    return tuple(out) if isinstance(x, tuple) else out[0]


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
# backward schedules
# ---------------------------------------------------------------------------


def dgrad_stream_w(dy, w, axis: str, axis_size: int, *,
                   bidirectional: bool = True, dot: Dot = tatp_dot,
                   wire: str = "native", dist=None):
    """``dx[..., m, N] = dy[..., m, R*kb] @ W_full.T``: the weight blocks
    stream as in the forward and each tile ``dot(dy[..., j block],
    w_j.T)`` adds into ``dx`` (in dy's dtype, the reference's order)."""
    r = axis_size
    kb = w.shape[-1]

    def contrib(blk, j):
        return dot(dy[..., j * kb:(j + 1) * kb], blk.t())

    if r == 1:
        return contrib(w, 0)

    def use(blk):
        return wire_decode(blk, wire, w.dtype)

    i = dist.axis_index(axis)
    w_enc = wire_encode(w, wire)
    acc = contrib(w, i)
    if not bidirectional:
        blk = w_enc
        for t in range(1, r):
            blk = dist.ppermute(blk, axis, _perm_from_right(r))
            acc = acc + contrib(use(blk), (i + t) % r)
        return acc
    up, dn = w_enc, w_enc
    for t in range(1, _n_rounds(r)):
        if r % 2 == 0 and t == r // 2:  # antipodal: one block
            up = dist.ppermute(up, axis, _perm_from_right(r))
            acc = acc + contrib(use(up), (i + t) % r)
            continue
        up, dn = dist.ppermute_many(
            [(up, _perm_from_right(r)), (dn, _perm_from_left(r))], axis)
        acc = acc + contrib(use(up), (i + t) % r)
        acc = acc + contrib(use(dn), (i - t) % r)
    return acc


def wgrad_rs(x, dy, axis: str, axis_size: int, *, bidirectional: bool = True,
             dot: Dot = tatp_dot, dist=None):
    """This rank's ``dW`` block ``[N, kb]``, summed over the ring: ``x``
    ``[..., m, N]`` and ``dy`` ``[..., m, R*kb]`` are both M-sharded, and
    each rank's tile for block j is ``dot(x.T, dy[..., j block])`` (in x's
    dtype).  Naive: block b's accumulator starts on rank b + 1 and moves
    +1 a hop, collecting every rank's tile, to land on b.  Bidirectional:
    two accumulators a block, one collecting ranks b + 1 .. b + h while
    moving -1, the other b - h' .. b - 1 while moving +1 (h = R // 2, h' =
    R - h - 1), moved in one batch a hop; the owner adds its own tile
    last, as the reference does."""
    r = axis_size
    kb = dy.shape[-1] // r
    xt = x.reshape(-1, x.shape[-1]).t()
    dym = dy.reshape(-1, dy.shape[-1])

    def contrib(j):
        return dot(xt, dym[:, j * kb:(j + 1) * kb])

    if r == 1:
        return contrib(0)
    i = dist.axis_index(axis)
    if not bidirectional:
        acc = contrib((i - 1) % r)
        for s in range(1, r):
            acc = dist.ppermute(acc, axis, _perm_from_left(r))
            acc = acc + contrib((i - 1 - s) % r)
        return acc
    h, hp = r // 2, r - r // 2 - 1
    accl = contrib((i - h) % r)
    accr = contrib((i + hp) % r) if hp else None
    for s in range(1, h + 1):
        if accr is not None and s <= hp:
            accl, accr = dist.ppermute_many(
                [(accl, _perm_from_right(r)), (accr, _perm_from_left(r))],
                axis)
        else:
            accl = dist.ppermute(accl, axis, _perm_from_right(r))
        if s < h:  # at s == h the accumulator has reached its owner
            accl = accl + contrib((i - h + s) % r)
        if accr is not None and s < hp:
            accr = accr + contrib((i + hp - s) % r)
    acc = accl if accr is None else accl + accr
    return acc + contrib(i)


class _TatpMatmul(torch.autograd.Function):
    """The reference's ``tatp_matmul`` custom_vjp (``_tatp_fwd`` /
    ``_tatp_bwd``): the forward saves (x, w); the backward runs the dgrad
    ring (on the wire) and the wgrad ring (native), ``dx`` in x's dtype
    and ``dw`` cast to w's."""

    @staticmethod
    def forward(ctx, x, w, axis, axis_size, bidirectional, wire, dot, dist,
                save):
        ctx.save_for_backward(x, w)
        ctx.cfg = (axis, axis_size, bidirectional, wire, dot, dist)

        def run():
            return ag_matmul_stream_w(x, w, axis, axis_size,
                                      bidirectional=bidirectional, dot=dot,
                                      wire=wire, dist=dist)

        # tatp_outputs saves y: the reference's "tatp_y"
        return remat.saved_or_run("linear", run) if save else run()

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        axis, axis_size, bidirectional, wire, dot, dist = ctx.cfg
        if dy.stride(-1) != 1:  # e.g. the expanded cotangent of a sum
            dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = dgrad_stream_w(dy, w, axis, axis_size,
                                bidirectional=bidirectional, dot=dot,
                                wire=wire, dist=dist)
        if ctx.needs_input_grad[1]:
            dw = wgrad_rs(x, dy, axis, axis_size,
                          bidirectional=bidirectional, dot=dot,
                          dist=dist).to(w.dtype)
        return dx, dw, None, None, None, None, None, None, None


def tatp_matmul(x, w, axis: str, axis_size: int, bidirectional: bool = True,
                wire: str = "native", dot: Dot = tatp_dot, dist=None,
                save: bool = True):
    """TATP streamed linear ``y = x @ W_full`` with the explicit dgrad and
    wgrad schedules as its backward.  Without autograd (no grad mode, or
    no input that requires grad) it is the forward schedule alone.
    ``save``: the ``tatp_outputs`` policy keeps the output (as the
    reference's ``"tatp_y"`` name); False for a product it does not
    name."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _TatpMatmul.apply(x, w, axis, axis_size, bidirectional, wire,
                                 dot, dist, save)
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
