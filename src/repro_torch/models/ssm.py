"""Mamba-2 (SSD, state-space duality) pieces (counterpart of
``repro.models.ssm``) at ring degree 1.

:func:`ssd_chunked` is the reference's plain chunked SSD (the oracle the
kernel-backed :func:`repro_torch.kernels.ssd.ops.ssd_chunked` is held
against): quadratic intra-chunk outputs, chunk states and a sequential
inter-chunk recurrence (arXiv:2405.21060).  :func:`ssd_decode_step`,
:func:`causal_conv1d` and :func:`conv_decode_step` are the reference's
single-device paths.  The sequence-sharded scan over the ring
(``ring_exclusive_scan``, ``ssd_sequence_sharded``) and the conv's halo
exchange are ROADMAP.md item A3c: ``mamba_block`` and
:func:`causal_conv1d` raise for a ring degree above 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import not_ported


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
# depthwise causal conv
# ---------------------------------------------------------------------------


def causal_conv1d(x, w, b, *, axis: str, axis_size: int):
    """x: [B, S, C]; w: [K, C]; b: [C].  Zero history before the first
    position, and the reference's order of sums (tap 0 first)."""
    if axis_size != 1:
        raise not_ported("the conv halo exchange over the ring", "A3c")
    k = w.shape[0]
    b_, s, c = x.shape
    xp = torch.cat([x.new_zeros((b_, k - 1, c)), x], dim=1)  # [B, S+K-1, C]
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
