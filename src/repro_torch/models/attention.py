"""Attention cores (counterpart of ``repro.models.attention``) at ring
degree 1.

:func:`local_attention` is the plain single-device online-softmax
attention (decode, and the reference for the prefill kernel);
:func:`decode_attention` and :func:`write_kv_cache` are the reference's
``axis_size == 1`` branches.  Prefill self-attention runs on the flash
kernel instead (``models/transformer.py:attn_block``).  Ring and zigzag
attention, and the sharded decode combine, are ROADMAP.md item A3.

Masking keeps the reference's numerics: NEG_INF = -1e30, masked
probabilities zeroed after the exp, and the row sum clamped at 1e-20, so a
fully masked row gives 0, not NaN.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import not_ported
from repro_torch.models.common import softcap

NEG_INF = -1e30


def _block_update(q, k, v, m, l, acc, qpos, kpos, *, scale, causal,
                  window: Optional[int], cap: Optional[float],
                  valid_len=None):
    """One online-softmax block update.

    q: [B, sq, Hk, G, dh]   (G = q heads per kv head)
    k/v: [B, sk, Hk, dh]
    m/l: [B, Hk, G, sq]     acc: [B, Hk, G, sq, dh]
    qpos: [sq] query positions, or [B, sq] when rows sit at different
    positions.  valid_len: optional scalar or [B]; keys with
    kpos > valid_len are masked.
    """
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    s = softcap(s, cap)
    qp = qpos[..., :, None]  # [sq, 1] or [B, sq, 1]
    kp = kpos[None, :]
    mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & ((qp - kp) < window)
    if valid_len is not None:
        vl = torch.as_tensor(valid_len, device=s.device)
        mask = mask & (kp <= (vl[..., None, None] if vl.ndim else vl))
    if mask.ndim == 3:  # per-row mask: broadcast over (Hk, G)
        mask = mask[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    p = torch.where(mask, p, 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bhgqk,bkhd->bhgqd", p, v.float()
    )
    return m_new, l_new, acc_new


def _init_state(b, hk, g, sq, dh, device=None):
    m = torch.full((b, hk, g, sq), NEG_INF, dtype=torch.float32,
                   device=device)
    l = torch.zeros((b, hk, g, sq), dtype=torch.float32, device=device)
    acc = torch.zeros((b, hk, g, sq, dh), dtype=torch.float32, device=device)
    return m, l, acc


def _finish(m, l, acc, dtype):
    l = l.clamp_min(1e-20)
    out = acc / l[..., None]  # [B, Hk, G, sq, dh]
    b, hk, g, sq, dh = out.shape
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hk * g, dh)
    return out.to(dtype)


def _group(q, n_kv):
    b, sq, hq, dh = q.shape
    return q.reshape(b, sq, n_kv, hq // n_kv, dh)


def local_attention(q, k, v, *, causal=True, window=None, cap=None,
                    q_offset=0, scale=None, valid_len=None):
    """q: [B, sq, Hq, dh], k/v: [B, sk, Hkv, dh] — all local.

    ``q_offset`` is a scalar or a [B] vector of query start positions."""
    b, sq, hq, dh = q.shape
    hk = k.shape[2]
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = _group(q, hk)
    m, l, acc = _init_state(b, hk, hq // hk, sq, dh, dev)
    qo = torch.as_tensor(q_offset, device=dev)
    ar = torch.arange(sq, device=dev)
    qpos = qo[..., None] + ar if qo.ndim else qo + ar
    kpos = torch.arange(k.shape[1], device=dev)
    m, l, acc = _block_update(qg, k, v, m, l, acc, qpos, kpos, scale=scale,
                              causal=causal, window=window, cap=cap,
                              valid_len=valid_len)
    return _finish(m, l, acc, q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, axis: str,
                     axis_size: int, window=None, cap=None, scale=None):
    """One-step decoding against the KV cache.

    q: [B, 1, Hq, dh]; k_cache/v_cache: [B, S, Hkv, dh]; cache_len: scalar
    or [B] — valid positions *including* the token written this step.
    The query sits at position ``cache_len - 1``, so a sliding window is
    live."""
    if axis_size != 1:
        raise not_ported(f"decode_attention at axis_size={axis_size}", "A3")
    cl = torch.as_tensor(cache_len, device=q.device)
    return local_attention(q, k_cache, v_cache, causal=False, window=window,
                           cap=cap, scale=scale, q_offset=cl - 1,
                           valid_len=cl - 1)


def write_kv_cache(k_cache, v_cache, k_new, v_new, pos, *, axis: str,
                   axis_size: int):
    """Write this step's K/V into the cache at position ``pos``.

    ``pos`` is a scalar (the whole batch writes ``k_new``'s window there,
    the start clamped so it fits, as ``dynamic_update_slice`` does) or a
    [B] vector (each row writes its one (Hkv, dh) slab at its own
    position).  Unlike the reference, which returns new arrays, the caches
    are updated in place (no second copy of the cache) and returned."""
    if axis_size != 1:
        raise not_ported(f"write_kv_cache at axis_size={axis_size}", "A3")
    pos = torch.as_tensor(pos, device=k_cache.device)
    if pos.ndim:
        rows = torch.arange(k_cache.shape[0], device=k_cache.device)
        k_cache[rows, pos] = k_new[:, 0].to(k_cache.dtype)
        v_cache[rows, pos] = v_new[:, 0].to(v_cache.dtype)
        return k_cache, v_cache
    s_new = k_new.shape[1]
    start = pos.clamp(0, k_cache.shape[1] - s_new)
    idx = start + torch.arange(s_new, device=k_cache.device)
    k_cache.index_copy_(1, idx, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v_new.to(v_cache.dtype))
    return k_cache, v_cache
