"""Plain PyTorch version of flash attention (counterpart of
``repro.kernels.flash_attention.ref``): masked softmax attention with GQA,
a top-left causal mask, a sliding window and logit soft-capping, in fp32.
Fully masked rows give 0, not NaN."""

import math

import torch


def attention_ref(q, k, v, *, causal=True, window=None, cap=None,
                  scale=None):
    """q: [B, Hq, Sq, D]; k/v: [B, Hkv, Skv, D]."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, g, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if cap is not None:
        s = torch.tanh(s / cap) * cap
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)
