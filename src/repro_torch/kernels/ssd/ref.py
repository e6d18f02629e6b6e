"""Plain PyTorch version of the SSD intra-chunk pass (counterpart of
``repro.kernels.ssd.ref``; mirrors ``repro.models.ssm.ssd_chunked``'s
intra-chunk math on a single chunk batch), in fp32."""

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
    decay = torch.where(tri[None, :, :, None], torch.exp(rel), 0.0)
    cb = torch.einsum("bqn,bsn->bqs", cmat, bmat)
    m = cb[..., None] * decay * dt[:, None, :, :]
    y = torch.einsum("bqsh,bshp->bqhp", m, x)
    dec_out = torch.exp(cum[:, -1:, :] - cum)
    st = torch.einsum("bsh,bsn,bshp->bhpn", dt * dec_out, bmat, x)
    g = torch.exp(cum[:, -1, :])
    return y, st, g
