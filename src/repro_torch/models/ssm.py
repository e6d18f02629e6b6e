"""Mamba-2 (SSD, state-space duality) pieces (counterpart of
``repro.models.ssm``).

:func:`ssd_chunked` is the reference's plain chunked SSD (the oracle the
kernel-backed :func:`repro_torch.kernels.ssd.ops.ssd_chunked` is held
against): quadratic intra-chunk outputs, chunk states and a sequential
inter-chunk recurrence (arXiv:2405.21060).  :func:`ssd_decode_step` and
:func:`conv_decode_step` are the reference's single-token steps.

Above ring degree 1 training and prefill run with the sequence sharded
over the TATP ring (:func:`ssd_sequence_sharded`): every rank runs its
local chunks with a zero inbound state (the ``ssd`` hook: the SSD kernel
on CUDA), the ranks' (decay, state) segments are combined by
:func:`ring_exclusive_scan` (the paper's R - 1 one-hop steps, or
⌈log₂R⌉ hops at power-of-two distances), and each rank adds its inbound
prefix state's contribution to its outputs.  :func:`causal_conv1d` takes
its first ``K - 1`` inputs from the rank before (the one-hop halo).

Every rank runs every hop, forward and backward: a rank selects a
received value with ``torch.where`` on a rank mask, as the reference's
``jnp.where``, never with a Python ``if``, so each relay stays in every
rank's autograd graph (with a zero cotangent where it is not taken) and
the inverse hops of the backward meet on all ranks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.tatp import _shift_perm, wire_relay


class SSDOut(NamedTuple):
    y: torch.Tensor  # [B, L, H, P]
    state: torch.Tensor  # [B, H, P, N] final state
    decay: torch.Tensor  # [B, H] total decay


def check_chunking(length: int, chunk: int) -> int:
    """The number of chunks; a sequence is never padded to a chunk."""
    if chunk <= 0 or length % chunk:
        raise ValueError(
            f"SSD sequence length {length} is not a multiple of the chunk "
            f"size {chunk} (ssm_chunk); sequences are never padded, so the "
            f"prompt length must be a multiple of it"
        )
    return length // chunk


def ssd_chunked(x, dt, a, bmat, cmat, chunk: int, h_init=None) -> SSDOut:
    """Local chunked SSD (plain torch; the reference's jnp oracle).

    x: [B, L, H, P] · dt: [B, L, H] (post-softplus) · a: [H] (negative)
    bmat/cmat: [B, L, N] (single B/C group) · h_init: [B, H, P, N] or None.
    """
    b, l, h, p = x.shape
    n = bmat.shape[-1]
    nc = check_chunking(l, chunk)

    da = dt * a  # [B, L, H]
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    dac = da.reshape(b, nc, chunk, h)
    bc = bmat.reshape(b, nc, chunk, n)
    cc = cmat.reshape(b, nc, chunk, n)

    cum = torch.cumsum(dac, dim=2)  # [B, nc, Q, H]
    # intra-chunk (quadratic, attention-like).  The mask selects the
    # exponent, not the exp: above the diagonal exp(rel) overflows to inf,
    # and a select after it would send 0 * inf = NaN into the gradient
    # (the reference does; ROADMAP.md C).  exp(-inf) = 0 keeps the forward
    # bitwise the reference's.
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,q,s,H]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    decay = torch.exp(torch.where(mask[None, None, :, :, None], rel,
                                  -torch.inf))
    cb = torch.einsum("bcqn,bcsn->bcqs", cc, bc)  # [B,nc,q,s]
    m = cb[..., None] * decay * dtc[:, :, None, :, :]  # [B,nc,q,s,H]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", m, xc)

    # chunk states
    dec_out = torch.exp(cum[:, :, -1:, :] - cum)  # decay from s to chunk end
    s_chunk = torch.einsum("bcsh,bcsn,bcshp->bchpn", dtc * dec_out, bc, xc)
    g_chunk = torch.exp(cum[:, :, -1, :])  # [B, nc, H]

    h0 = (torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
          if h_init is None else h_init.to(x.dtype))
    hprevs, hfin = chunk_recurrence(g_chunk, s_chunk, h0)
    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", cc, torch.exp(cum),
                           hprevs)
    y = (y_intra + y_inter).reshape(b, l, h, p)
    total_decay = torch.exp(torch.sum(da, dim=1))  # [B, H]
    return SSDOut(y, hfin, total_decay)


def chunk_recurrence(g, st, h0):
    """The inter-chunk recurrence (the reference's ``lax.scan``):
    h_c = g_c h_{c-1} + st_c over the chunk axis.  g: [B, nc, H] ·
    st: [B, nc, H, P, N] · h0: [B, H, P, N].  Returns (the state entering
    each chunk [B, nc, H, P, N], the final state [B, H, P, N])."""
    hprev, hprevs = h0, []
    for c in range(g.shape[1]):
        hprevs.append(hprev)
        hprev = g[:, c, :, None, None] * hprev + st[:, c]
    return torch.stack(hprevs, dim=1), hprev


def ssd_decode_step(x, dt, a, bmat, cmat, d_skip, state):
    """Single-token SSD update.  x: [B,H,P] · dt: [B,H] · state: [B,H,P,N].
    Returns (y, state_new); ``state`` is not modified."""
    da = torch.exp(dt * a)  # [B,H]
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, x, bmat)
    state_new = da[:, :, None, None] * state + upd
    y = torch.einsum("bn,bhpn->bhp", cmat, state_new)
    y = y + d_skip[None, :, None] * x
    return y, state_new


# ---------------------------------------------------------------------------
# the sequence-sharded SSD over the ring
# ---------------------------------------------------------------------------


def segsum_combine(left, right):
    """Segment monoid: h_out = G·h_in + S.  combine(left, then right)."""
    gl, sl = left
    gr, sr = right
    return gl * gr, gr * sl + sr


def rank_mask(cond: bool, device):
    """A rank's ``cond`` as a 0-d bool tensor on ``device``, to select
    with (``torch.where``) where a Python ``if`` would give the ranks
    different graphs."""
    return torch.full((), cond, dtype=torch.bool, device=device)


def _select(take, new, old):
    return tuple(torch.where(take, a, b) for a, b in zip(new, old))


def ring_exclusive_scan(seg, axis: str, axis_size: int, mode: str = "seq",
                        wire: str = "fp32", *, dist):
    """Exclusive scan of segment values over the ring axis.

    ``seg = (G, S)`` with G broadcastable to S.  Returns the exclusive
    prefix (the identity on rank 0).  ``seq``: R - 1 one-hop steps (the
    paper's); ``log``: ⌈log₂R⌉ steps at power-of-two hop distances.  Both
    end in the exclusive hop.  ``wire="bf16"`` sends the segments as bf16
    (the local math stays fp32); G and S move in one batch a hop
    (:func:`repro_torch.core.tatp.wire_relay`), whose backward sends the
    cotangents along the inverse hop at native precision."""
    r = axis_size
    g, s = seg
    if r == 1:
        return torch.ones_like(g), torch.zeros_like(s)
    code = "bf16" if wire == "bf16" else "native"

    def relay(pair, shift):
        return wire_relay(pair, axis, r, shift, code, dist=dist)

    i, dev = dist.axis_index(axis), s.device
    if mode == "log":
        pfx = (g, s)
        d = 1
        while d < r:
            comb = segsum_combine(relay(pfx, d), pfx)
            pfx = _select(rank_mask(i >= d, dev), comb, pfx)
            d *= 2
    elif mode == "seq":
        pfx = (g, s)
        for t in range(1, r):
            comb = segsum_combine(relay(pfx, 1), (g, s))
            pfx = _select(rank_mask(i >= t, dev), comb, pfx)
    else:
        raise ValueError(f"unknown ssm_scan_mode {mode!r}")
    # inclusive -> exclusive: take from the left neighbour; rank 0 the
    # identity
    first = rank_mask(i == 0, dev)
    ge, se = relay(pfx, 1)
    return (torch.where(first, torch.ones_like(ge), ge),
            torch.where(first, torch.zeros_like(se), se))


def ssd_sequence_sharded(x, dt, a, bmat, cmat, chunk: int, *, axis: str,
                         axis_size: int, scan_mode: str = "seq",
                         wire: str = "fp32", dist, ssd=ssd_chunked):
    """SSD with the sequence sharded over the ring axis (context
    parallel): the local pass ``ssd`` (the kernel-backed
    ``kernels.ssd.ops.ssd_chunked`` in the model; this module's plain
    :func:`ssd_chunked` by default) with a zero inbound state, the scan of
    the ranks' (decay, state) segments, then the inbound prefix state's
    contribution to the local outputs.  Returns (y, the state after this
    rank's block)."""
    local = ssd(x, dt, a, bmat, cmat, chunk)
    if axis_size == 1:
        return local.y, local.state
    g = local.decay[:, :, None, None]  # [B,H,1,1]
    _, se = ring_exclusive_scan((g, local.state), axis, axis_size,
                                mode=scan_mode, wire=wire, dist=dist)
    # for local token t the inbound state contributes C_t · (exp(cum_t)
    # · h_in)
    cum = torch.cumsum(dt * a, dim=1)  # [B, L, H]
    y_corr = torch.einsum("bln,blh,bhpn->blhp", cmat, torch.exp(cum), se)
    state_out = g * se + local.state
    return local.y + y_corr, state_out


# ---------------------------------------------------------------------------
# depthwise causal conv
# ---------------------------------------------------------------------------


def causal_conv1d(x, w, b, *, axis: str, axis_size: int, dist=None):
    """x: [B, S_loc, C] (sequence-sharded over ``axis`` above degree 1);
    w: [K, C]; b: [C].  Rank 0 sees zero history before its first
    position; above degree 1 every other rank takes the last ``K - 1``
    inputs of the rank before it (a one-hop halo exchange over ``dist``).
    The reference's order of sums (tap 0 first)."""
    k = w.shape[0]
    b_, s, c = x.shape
    halo = k - 1
    if axis_size > 1:
        if dist is None:
            raise ValueError("causal_conv1d over a ring of "
                             f"{axis_size} needs its dist for the halo")
        prev = dist.ppermute(x[:, -halo:, :], axis,
                             _shift_perm(axis_size, 1))
        first = rank_mask(dist.axis_index(axis) == 0, x.device)
        prev = torch.where(first, torch.zeros_like(prev), prev)
    else:
        prev = x.new_zeros((b_, halo, c))
    xp = torch.cat([prev, x], dim=1)  # [B, S+K-1, C]
    out = xp[:, 0:s, :] * w[0][None, None, :]
    for j in range(1, k):
        out = out + xp[:, j:j + s, :] * w[j][None, None, :]
    return out + b[None, None, :]


def conv_decode_step(x_new, conv_cache, w, b):
    """x_new: [B, C]; conv_cache: [B, K-1, C] (previous inputs).  Returns
    (out [B, C], the next conv cache [B, K-1, C]) as new tensors."""
    window = torch.cat([conv_cache, x_new[:, None, :]], dim=1)
    out = torch.einsum("bkc,kc->bc", window, w) + b
    return out, window[:, 1:, :]
