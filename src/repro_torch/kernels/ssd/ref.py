"""Plain PyTorch version of the SSD intra-chunk pass (counterpart of
``repro.kernels.ssd.ref``; mirrors ``repro.models.ssm.ssd_chunked``'s
intra-chunk math on a single chunk batch), in fp32.

The causal decay masks the exponent, ``exp(where(s <= q, rel, -inf))``,
where the reference selects after it, ``where(s <= q, exp(rel), 0)``.
The forward is bitwise the same (``exp(-inf)`` is exactly 0), but above
the diagonal ``rel`` is positive and ``exp(rel)`` overflows to inf over a
256-token chunk, so the reference's gradient there is ``0 * inf = NaN``
(ROADMAP.md C); this one is finite."""

import torch


def ssd_intra_chunk_ref(x, dt, a, bmat, cmat):
    """x: [B, Q, H, P] · dt: [B, Q, H] · a: [H] · bmat/cmat: [B, Q, N].

    Returns (y_intra [B,Q,H,P], state [B,H,P,N], decay [B,H]).
    """
    x = x.float()
    dt = dt.float()
    bmat = bmat.float()
    cmat = cmat.float()
    q = x.shape[1]
    da = dt * a[None, None, :]
    cum = torch.cumsum(da, dim=1)  # [B, Q, H]
    rel = cum[:, :, None, :] - cum[:, None, :, :]  # [B,q,s,H]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(tri[None, :, :, None], rel, -torch.inf))
    cb = torch.einsum("bqn,bsn->bqs", cmat, bmat)
    m = cb[..., None] * decay * dt[:, None, :, :]
    y = torch.einsum("bqsh,bshp->bqhp", m, x)
    dec_out = torch.exp(cum[:, -1:, :] - cum)
    st = torch.einsum("bsh,bsn,bshp->bhpn", dt * dec_out, bmat, x)
    g = torch.exp(cum[:, -1, :])
    return y, st, g


def ssd_intra_chunk_bwd_ref(x, dt, a, bmat, cmat, dy=None, dst=None,
                            dg=None):
    """The gradients of :func:`ssd_intra_chunk_ref` at the cotangents
    ``dy`` [B,Q,H,P], ``dst`` [B,H,P,N] and ``dg`` [B,H] (each may be
    ``None``, read as zero), written out: the math the backward kernel
    (``csrc/ssd_bwd.cu``) follows, not autograd.  Returns (dx [B,Q,H,P],
    ddt [B,Q,H], da [H], dB [B,Q,N], dC [B,Q,N]), fp32.

    With cum the prefix sum of dt * a, per chunk row and head:
    L[q,s] = select(s <= q, exp(cum_q - cum_s), 0), M = (C B^T) * L * dt_s,
    w_s = exp(cum_{Q-1} - cum_s) dt_s, y = M x, st = x^T (w B), g =
    exp(cum_{Q-1}).  B and C are shared by every head, so dM * L * dt_s is
    summed over the heads before its products with B and C.

    The gradient reaches cum through the exponents cum_q - cum_s (and
    cum_{Q-1} - cum_s): +R on the q side, -R on the s side.  The pairs
    whose exponent is identically 0 (s = q, and s = Q - 1 in w) are left
    out: their two terms cancel exactly, but summed apart they leave a
    rounding residue of an O(1) term, while at large decays (a = -16
    over a 256-token chunk) everything else that reaches cum is ~1e-5 of
    it, and da would be wrong by ~10 %.
    """
    x, dt, bmat, cmat = (t.float() for t in (x, dt, bmat, cmat))
    a = a.float()
    q = x.shape[1]
    cum = torch.cumsum(dt * a[None, None, :], dim=1)  # [B, Q, H]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    below = torch.tril(tri, diagonal=-1)  # s < q
    rel = cum[:, :, None, :] - cum[:, None, :, :]  # [B,q,s,H]
    decay = torch.exp(torch.where(tri[None, :, :, None], rel, -torch.inf))
    dx = torch.zeros_like(x)
    ddt = torch.zeros_like(dt)
    dcum = torch.zeros_like(dt)  # d loss / d cum
    db = torch.zeros_like(bmat)
    dc = torch.zeros_like(cmat)
    if dy is not None:
        dy = dy.float()
        cb = torch.einsum("bqn,bsn->bqs", cmat, bmat)
        m = cb[..., None] * decay * dt[:, None, :, :]
        dx = dx + torch.einsum("bqsh,bqhp->bshp", m, dy)
        dm = torch.einsum("bqhp,bshp->bqsh", dy, x)
        dm_l = dm * decay  # zero above the diagonal
        dcb = torch.sum(dm_l * dt[:, None, :, :], dim=-1)  # head sum first
        dc = dc + torch.einsum("bqs,bsn->bqn", dcb, bmat)
        db = db + torch.einsum("bqs,bqn->bsn", dcb, cmat)
        t = dm_l * cb[..., None]  # d loss / d (L dt_s), times L
        ddt = ddt + torch.sum(t, dim=1)
        # d loss / d rel, without the diagonal (rel = 0 there)
        r = torch.where(below[None, :, :, None], t * dt[:, None, :, :], 0.0)
        dcum = dcum + torch.sum(r, dim=2) - torch.sum(r, dim=1)
    if dst is not None:
        dst = dst.float()
        e = torch.exp(cum[:, -1:, :] - cum)  # [B, Q, H]
        w = e * dt
        ebp = torch.einsum("bsn,bhpn->bshp", bmat, dst)
        dx = dx + w[..., None] * ebp
        db = db + torch.einsum("bsh,bshp,bhpn->bsn", w, x, dst)
        dw = torch.sum(x * ebp, dim=-1)  # [B, Q, H]
        ddt = ddt + dw * e
        dww = (dw * w)[:, :-1]  # without s = Q - 1 (exponent 0)
        dcum[:, :-1] = dcum[:, :-1] - dww
        dcum[:, -1] = dcum[:, -1] + torch.sum(dww, dim=1)
    if dg is not None:
        dcum[:, -1] = dcum[:, -1] + dg.float() * torch.exp(cum[:, -1])
    # cum = cumsum(dt * a): d loss / d (dt * a) is the reverse cumsum
    dda = torch.flip(torch.cumsum(torch.flip(dcum, (1,)), dim=1), (1,))
    ddt = ddt + dda * a[None, None, :]
    da = torch.sum(dda * dt, dim=(0, 1))
    return dx, ddt, da, db, dc
