"""Attention cores (counterpart of ``repro.models.attention``).

:func:`local_attention` is the plain single-device online-softmax
attention (decode, and the reference for the prefill kernel).  Prefill
self-attention at ring degree 1 runs on the flash kernel instead
(``models/transformer.py:attn_block``).  Above degree 1 the sequence is
sharded over the ring:

* :func:`ring_attention` streams the K/V blocks around the ring (both
  directions by default, as TATP streams weights) while each rank absorbs
  every block into its queries' softmax.  With an ``attention`` hook (the
  flash kernel, or its plain version) each round is one launch — causal on
  the rank's own block, unmasked on an earlier one, skipped for a later
  one, whose keys every query masks — and the rounds merge in fp32 by each
  launch's row log-sum-exp; without one, the reference's online-softmax
  loop (:func:`_block_update`) absorbs them.
* :func:`decode_attention` attends the token to the rank's slice of the
  sequence-sharded cache and merges the slices with the reference's
  (pmax, psum, psum) combine; :func:`write_kv_cache` writes the token's
  K/V on the rank that owns its position.

A sliding window above degree 1 needs a key offset the flash kernel does
not take, and raises (ROADMAP.md A3f); zigzag attention belongs to the
train ring (A3a).

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


def _merge(acc, lse, o, lse_o):
    """Fold one round's output ``o`` [B, H, S, D] with its row
    log-sum-exp ``lse_o`` [B, H, S] into the running fp32 ``(acc,
    lse)``."""
    o = o.float()
    if acc is None:
        return o, lse_o
    new = torch.logaddexp(lse, lse_o)
    return (acc * torch.exp(lse - new)[..., None]
            + o * torch.exp(lse_o - new)[..., None]), new


def ring_attention(q, k, v, *, axis: str, axis_size: int, causal=True,
                   window=None, cap=None, bidirectional=True, scale=None,
                   wire: str = "native", dist=None, attention=None):
    """Sequence-sharded attention; K/V blocks stream around the ring.

    q/k/v: [B, s_loc, H(,kv), dh], this rank's token block (index
    ``dist.axis_index(axis)``): local token t sits at ``i * s_loc + t``.
    The blocks travel as ``wire`` (``core/tatp.py:wire_relay``).  With
    ``attention`` (the flash kernel's signature, ``[B, H, S, D]`` views,
    ``return_lse=True``) each round that has a visible key is one call;
    without it the reference's online-softmax loop."""
    from repro_torch.core.tatp import _n_rounds, wire_relay

    r = axis_size
    b, sl, hq, dh = q.shape
    hk = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    if r == 1:
        return local_attention(q, k, v, causal=causal, window=window, cap=cap,
                               scale=scale)
    if window is not None:
        raise not_ported("a sliding window in ring attention", "A3f")
    i = dist.axis_index(axis)

    def relay(kv, shift):
        return (wire_relay(kv[0], axis, r, shift, wire, dist=dist),
                wire_relay(kv[1], axis, r, shift, wire, dist=dist))

    if attention is None:
        qg = _group(q, hk)
        ar = torch.arange(sl, device=q.device)
        qpos = i * sl + ar
        state = _init_state(b, hk, hq // hk, sl, dh, q.device)

        def upd(state, kv, j):
            return _block_update(qg, kv[0], kv[1], *state, qpos, j * sl + ar,
                                 scale=scale, causal=causal, window=None,
                                 cap=cap)
    else:
        qt = q.transpose(1, 2)

        def upd(state, kv, j):
            if causal and j > i:  # every key lies after every query
                return state
            o, lse = attention(qt, kv[0].transpose(1, 2),
                               kv[1].transpose(1, 2),
                               causal=causal and j == i, cap=cap,
                               scale=scale, return_lse=True)
            return _merge(*state, o, lse)

        state = (None, None)

    state = upd(state, (k, v), i)
    if not bidirectional:
        blk = (k, v)
        for t in range(1, r):
            blk = relay(blk, -1)  # block index grows
            state = upd(state, blk, (i + t) % r)
    else:
        up, dn = (k, v), (k, v)
        for t in range(1, _n_rounds(r)):
            up = relay(up, -1)
            state = upd(state, up, (i + t) % r)
            if not (r % 2 == 0 and t == r // 2):  # antipodal: one block
                dn = relay(dn, +1)
                state = upd(state, dn, (i - t) % r)
    if attention is None:
        return _finish(*state, q.dtype)
    return state[0].to(q.dtype).transpose(1, 2)


def decode_attention(q, k_cache, v_cache, cache_len, *, axis: str,
                     axis_size: int, window=None, cap=None, scale=None,
                     dist=None):
    """One-step decoding against the KV cache.

    q: [B, 1, Hq, dh] (replicated over the ring); k_cache/v_cache: [B,
    S_loc, Hkv, dh], this rank's slice of the sequence (positions ``i *
    S_loc`` on); cache_len: scalar or [B] — valid positions *including*
    the token written this step.  The query sits at position ``cache_len
    - 1``, so a sliding window is live.  Above degree 1 the slices' (max,
    sum, acc) partials merge over the ring as the reference's do."""
    cl = torch.as_tensor(cache_len, device=q.device)
    if axis_size == 1:
        return local_attention(q, k_cache, v_cache, causal=False,
                               window=window, cap=cap, scale=scale,
                               q_offset=cl - 1, valid_len=cl - 1)
    b, sq, hq, dh = q.shape
    hk = k_cache.shape[2]
    sloc = k_cache.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    i = dist.axis_index(axis)
    kpos = i * sloc + torch.arange(sloc, device=q.device)
    qpos = (cl - 1)[..., None] + torch.zeros(sq, dtype=cl.dtype,
                                             device=q.device)
    m, l, acc = _block_update(_group(q, hk), k_cache, v_cache,
                              *_init_state(b, hk, hq // hk, sq, dh,
                                           q.device),
                              qpos, kpos, scale=scale, causal=False,
                              window=window, cap=cap, valid_len=cl - 1)
    m_g = dist.pmax(m, axis)
    alpha = torch.exp(m - m_g)
    num = dist.psum(acc * alpha[..., None], axis)
    den = dist.psum(l * alpha, axis)
    return _finish(m_g, den, num, q.dtype)


def write_kv_cache(k_cache, v_cache, k_new, v_new, pos, *, axis: str,
                   axis_size: int, dist=None):
    """Write this step's K/V into the cache at position ``pos``.

    ``pos`` is a scalar (the whole batch writes ``k_new``'s window there,
    the start clamped so it fits, as ``dynamic_update_slice`` does) or a
    [B] vector (each row writes its one (Hkv, dh) slab at its own
    position).  Unlike the reference, which returns new arrays, the caches
    are updated in place (no second copy of the cache) and returned.

    Above degree 1 the cache holds this rank's slice of the sequence
    (``S_loc`` positions from ``i * S_loc``) and only the rank that owns
    ``pos`` writes, as in the reference (no host synchronisation: the
    other ranks write back what they hold)."""
    dev = k_cache.device
    pos = torch.as_tensor(pos, device=dev)
    sloc, s_new = k_cache.shape[1], k_new.shape[1]
    rows = torch.arange(k_cache.shape[0], device=dev)
    if axis_size == 1:
        if pos.ndim:
            k_cache[rows, pos] = k_new[:, 0].to(k_cache.dtype)
            v_cache[rows, pos] = v_new[:, 0].to(v_cache.dtype)
        else:
            idx = pos.clamp(0, sloc - s_new) + torch.arange(s_new, device=dev)
            k_cache.index_copy_(1, idx, k_new.to(k_cache.dtype))
            v_cache.index_copy_(1, idx, v_new.to(v_cache.dtype))
        return k_cache, v_cache
    i = dist.axis_index(axis)
    keep = pos // sloc == i
    local = torch.where(keep, pos - i * sloc, 0)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        new = new.to(cache.dtype)
        if pos.ndim:
            cache[rows, local] = torch.where(keep[:, None, None], new[:, 0],
                                             cache[rows, local])
        else:
            idx = local.clamp(0, sloc - s_new) + torch.arange(s_new,
                                                              device=dev)
            cache.index_copy_(1, idx, torch.where(keep, new, cache[:, idx]))
    return k_cache, v_cache
    s_new = k_new.shape[1]
    idx = local.clamp(0, sloc - s_new) + torch.arange(s_new, device=dev)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache.index_copy_(1, idx, torch.where(keep, new.to(cache.dtype),
                                              cache[:, idx]))
    return k_cache, v_cache
