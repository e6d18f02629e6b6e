"""Plain PyTorch version of flash attention (counterpart of
``repro.kernels.flash_attention.ref``): masked softmax attention with GQA,
a causal mask, a sliding window and logit soft-capping, in fp32.  Query
row ``r`` sits at position ``r + q_offset`` and key column ``c`` at ``c``
(top-left aligned at the default offset 0).  Fully masked rows give 0, not
NaN.

:func:`attention_bwd_ref` is the plain version of the backward kernel:
the gradients written out from the forward's output and row log-sum-exp,
as the kernel computes them."""

import math

import torch


def _scores(q, k, causal, window, cap, scale, q_offset=0):
    """fp32 scores [B, Hkv, G, Sq, Skv] (soft-capped, masked to -1e30),
    the mask, tanh of the capped scores (None without a cap) and the
    grouped fp32 q; the causal and window terms compare query position
    ``row + q_offset`` with key position ``col``."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    t = None
    if cap is not None:
        t = torch.tanh(s / cap)
        s = t * cap
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return torch.where(mask, s, -1e30), mask, t, qg


def attention_ref(q, k, v, *, causal=True, window=None, cap=None,
                  scale=None, return_lse=False, q_offset: int = 0):
    """q: [B, Hq, Sq, D]; k/v: [B, Hkv, Skv, D].  With ``return_lse``
    also each row's fp32 log-sum-exp of the scores, [B, Hq, Sq] (about
    -1e30 on a fully masked row).  ``q_offset``: the first query's
    position relative to the first key's (a ring round's rows sit that
    far past its block's keys); the reference's
    ``local_attention(q_offset=...)`` masks so."""
    b, hq, sq, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s, mask, _, _ = _scores(q, k, causal, window, cap, scale, q_offset)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(mask, p, 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    p = p / denom
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    o = o.reshape(b, hq, sq, d).to(q.dtype)
    if not return_lse:
        return o
    return o, (m + torch.log(denom)).reshape(b, hq, sq)


def attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=None,
                      cap=None, scale=None, delta=None, q_offset: int = 0):
    """(dq, dk, dv) of :func:`attention_ref` at ``do``, from its row
    ``lse``: P = exp(S - lse) on the unmasked pairs, dV = P^T dO,
    dP = dO V^T, dS = P (dP - rowsum(P dP)), through the cap's tanh,
    dQ = dS K scale and dK = dS^T Q scale (GQA groups summed into dK and
    dV).  fp32 arithmetic; each gradient in its input's dtype.

    rowsum(P dP) equals rowsum(dO O) (O = P V) but is formed in fp32 from
    P, so the rounded output ``o`` is not read (it is taken for the
    kernel's signature): where scores pass a soft-cap the softmax is nearly
    one-hot, dP - rowsum cancels, and a bf16 O's rounding would be all of
    dS.  An outside ``delta`` ([B, Hq, Sq] fp32) replaces that rowsum, as
    the kernel's ``delta_in`` does: with ``lse`` and ``delta`` of a whole
    row, k/v may be one block of its keys (a ring round), whose first query
    sits ``q_offset`` positions past its first key: the masks are
    :func:`attention_ref`'s at that offset, so a row that sees no key gets
    dQ 0 and a key that no row sees dK and dV 0."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s, mask, t, qg = _scores(q, k, causal, window, cap, scale, q_offset)
    p = torch.where(mask, torch.exp(s - lse.reshape(b, hkv, g, sq, 1)),
                    0.0)
    dog = do.reshape(b, hkv, g, sq, d).float()
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, v.float())
    if delta is None:
        delta = (p * dp).sum(dim=-1, keepdim=True)
    else:
        delta = delta.reshape(b, hkv, g, sq, 1)
    ds = p * (dp - delta)
    if t is not None:
        ds = ds * (1 - t * t)
    ds = ds * scale
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float())
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg)
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
