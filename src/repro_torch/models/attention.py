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
  launch's row log-sum-exp; its backward (:class:`_RingAttention`) is one
  backward launch a visible round with the global LSE and one outside
  delta.  Under a sliding window each launch passes its ``q_offset`` (its
  first query's global position less its first key's), so the window
  masks global positions, and a round whose nearest pair lies outside the
  window launches nothing (:meth:`_Ring.launches`); the backward's call
  for each launch takes the same masks and offset.  Without a hook, the
  reference's online-softmax loop (:func:`_block_update`) absorbs them
  with their global positions, and autograd differentiates it.
* :func:`decode_attention` attends the token to the rank's slice of the
  sequence-sharded cache and merges the slices with the reference's
  (pmax, psum, psum) combine; :func:`write_kv_cache` writes the token's
  K/V on the rank that owns its position.

* :func:`zigzag_ring_attention` is the causal ring over the zigzag chunk
  layout (rank i holds chunks i and 2R - 1 - i; the caller permutes the
  sequence with :func:`zigzag_permutation`): uniform work a rank, 2R + 1
  c x c launches on the hook path, sharing :class:`_RingAttention`.

Masking keeps the reference's numerics: NEG_INF = -1e30, masked
probabilities zeroed after the exp, and the row sum clamped at 1e-20, so a
fully masked row gives 0, not NaN.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import remat
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


def _rounds(k, v, i: int, r: int, bidirectional: bool, relay):
    """The K/V blocks rank ``i`` sees, in the forward's order, as
    ``(stream, t, j, k_j, v_j)``: its own block (stream None, t 0), then
    round by round the block from the right (``"up"``, j = i + t, relayed
    by shift -1) and, bidirectional, the one from the left (``"dn"``, j = i
    - t, shift +1; none in an even ring's antipodal round).  Naive rings
    relay one way for R - 1 rounds."""
    from repro_torch.core.tatp import _n_rounds

    yield None, 0, i, k, v
    if not bidirectional:
        blk = (k, v)
        for t in range(1, r):
            blk = relay(blk, -1)  # block index grows
            yield "up", t, (i + t) % r, *blk
        return
    up, dn = (k, v), (k, v)
    for t in range(1, _n_rounds(r)):
        up = relay(up, -1)
        yield "up", t, (i + t) % r, *up
        if not (r % 2 == 0 and t == r // 2):  # antipodal: one block
            dn = relay(dn, +1)
            yield "dn", t, (i - t) % r, *dn


_BACK_SHIFT = {"up": +1, "dn": -1}  # a stream's hop, reversed


def _hook_rounds(q, k, v, ring):
    """The hook path's forward: one ``attention`` call a launch of each
    round (:meth:`_Ring.launches`, with its masks and query offset), each
    query slice's launches merged in fp32 by their row log-sum-exp.
    Returns the merged output [B, Hq, S, D] in fp32 and the global row LSE
    [B, Hq, S]."""
    i = ring.dist.axis_index(ring.axis)
    qt = q.transpose(1, 2)
    merged = {}  # query rows (start, stop) -> (acc, lse)
    for _, _, j, kj, vj in _rounds(k, v, i, ring.r, ring.bidirectional,
                                   ring.relay):
        kt, vt = kj.transpose(1, 2), vj.transpose(1, 2)
        for qs, ks, causal, q_offset, window in ring.launches(
                i, j, q.shape[1]):
            o, lse_j = ring.attention(qt[:, :, qs], kt[:, :, ks],
                                      vt[:, :, ks], causal=causal,
                                      window=window, cap=ring.cap,
                                      scale=ring.scale, return_lse=True,
                                      q_offset=q_offset)
            key = (qs.start, qs.stop)
            merged[key] = _merge(*merged.get(key, (None, None)), o, lse_j)
    return (_join({key: m[0] for key, m in merged.items()}),
            _join({key: m[1] for key, m in merged.items()}))


def _join(parts):
    """Slices' tensors ``{(start, stop): t}`` in row order, concatenated
    along dim 2 (rows of [B, H, S, D] and [B, H, S])."""
    ts = [parts[key] for key in sorted(parts)]
    return ts[0] if len(ts) == 1 else torch.cat(ts, dim=2)


_ALL = slice(0, None)


class _Ring:
    """One ring attention call's settings (its hook path's closure)."""

    def __init__(self, axis, r, causal, cap, bidirectional, scale, wire,
                 dist, attention, zigzag=False, window=None):
        from repro_torch.core.tatp import wire_relay

        self.axis, self.r, self.causal, self.cap = axis, r, causal, cap
        self.window = window
        self.bidirectional, self.scale, self.dist = bidirectional, scale, dist
        self.attention, self.zigzag = attention, zigzag

        def relay(kv, shift):
            return tuple(wire_relay(t, axis, r, shift, wire, dist=dist)
                         for t in kv)

        self.relay = relay

    def launches(self, i: int, j: int, s_loc: int):
        """The kernel launches of rank ``i``'s round on block ``j``, as
        ``(query rows, key rows, causal, q_offset, window)``: ``q_offset``
        is the first query's global position less the first key's, and a
        mask is passed only where it hides some pair (where neither does,
        the offset changes nothing and is given as 0).  Contiguous: the
        whole block at offset (i - j) s_loc, causal on the own one, none
        for a later one (every key lies after every query).  Zigzag (rank
        i holds chunks i and 2R - 1 - i, c rows each, as A and B): on the
        own block q_A x k_A and q_B x k_B causal and q_B x k_A unmasked
        at (2R - 1 - 2i) c (q_A x k_B is invisible); on an earlier block
        (j < i) q_A x k_A at (i - j) c and q_B x k_A at (2R - 1 - i - j)
        c, on a later one q_B x k_A at (2R - 1 - i - j) c and q_B x k_B
        at (j - i) c: 2R + 1 launches a rank.  Under a window a launch
        whose nearest pair lies outside it is dropped."""
        if not self.zigzag:
            got = self._launch(_ALL, _ALL, s_loc, s_loc, (i - j) * s_loc)
            return [got] if got else []
        c, r = s_loc // 2, self.r
        out = []
        for qs, qc in ((slice(0, c), i), (slice(c, s_loc), 2 * r - 1 - i)):
            for ks, kc in ((slice(0, c), j), (slice(c, s_loc),
                                              2 * r - 1 - j)):
                got = self._launch(qs, ks, c, c, (qc - kc) * c)
                if got:
                    out.append(got)
        return out

    def _launch(self, qs, ks, sq: int, sk: int, off: int):
        """One launch of ``sq`` query rows ``off`` positions past ``sk``
        keys, or None where the causal mask or the window hides every
        pair."""
        if self.causal and off + sq - 1 < 0:  # every key after every query
            return None
        w = self.window
        if w is not None and off - (sk - 1) >= w:  # the nearest pair
            return None
        causal = self.causal and sk - 1 > off  # some key after some query
        window = w if w is not None and off + sq - 1 >= w else None
        return (qs, ks, causal, off if causal or window else 0, window)


class _RingAttention(torch.autograd.Function):
    """Ring attention's hook path under autograd (the counterpart of
    ``jax.vjp`` through the reference's ``ring_attention``).

    Forward: :func:`_hook_rounds`, saving q, the own K/V block, the merged
    fp32 output O and the global row LSE.  Backward: delta = rowsum(dO ∘
    O) once, from the fp32 O (not its rounded cast); the K/V blocks stream
    again in the forward's order, and each forward launch
    (:meth:`_Ring.launches`) is one call of the hook's backward (the flash
    kernel's on CUDA, its plain version on the CPU) on the same rows, with
    the launch's causal mask, query offset and window, their global LSE
    and that outside delta.  dQ sums locally in
    fp32.  Under ``tatp_outputs`` the forward records O and the LSE
    (:mod:`repro_torch.core.remat`), so the recompute runs no round.  Each block's dK/dV partials
    (fp32) return to its owner by retracing its stream: from the last
    round back, an accumulator hops the reverse way and adds the rank's
    partial at each stop (the transposes jax takes through the relays),
    the two streams' hops in one batch."""

    @staticmethod
    def forward(ctx, q, k, v, ring):
        # tatp_outputs records what the backward reads (the fp32 output
        # and the global LSE): the recompute runs no round and relays no
        # K/V block
        o32, lse = remat.saved_or_run("attention",
                                      lambda: _hook_rounds(q, k, v, ring))
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.ring = ring
        return o32.to(q.dtype).transpose(1, 2)

    @staticmethod
    def backward(ctx, do):
        from repro_torch.core.tatp import _shift_perm

        q, k, v, o32, lse = ctx.saved_tensors
        ring = ctx.ring
        dist, axis, r = ring.dist, ring.axis, ring.r
        i = dist.axis_index(axis)
        bwd = _attention_bwd(ring.attention, q)
        qt, dot = q.transpose(1, 2), do.transpose(1, 2)
        if dot.stride(3) != 1:
            dot = dot.contiguous()
        delta = (dot.float() * o32).sum(dim=-1).contiguous()
        dq = {}  # query rows (start, stop) -> fp32 dQ
        parts = {}  # (stream, t) -> this rank's (dK, dV) of that block
        for stream, t, j, kj, vj in _rounds(k, v, i, r, ring.bidirectional,
                                            ring.relay):
            kt, vt = kj.transpose(1, 2), vj.transpose(1, 2)
            got = {}  # key rows -> (dK, dV) in [B, H, S, D]
            for qs, ks, causal, q_offset, window in ring.launches(
                    i, j, q.shape[1]):
                # o is not read with an outside delta; do stands in for it
                d = dot[:, :, qs]
                g = bwd(qt[:, :, qs], kt[:, :, ks], vt[:, :, ks], d,
                        _rows(lse, qs), d, causal=causal, window=window,
                        cap=ring.cap, scale=ring.scale,
                        delta=_rows(delta, qs), q_offset=q_offset)
                qk, kk = (qs.start, qs.stop), (ks.start, ks.stop)
                dq[qk] = g[0].float() if qk not in dq \
                    else dq[qk] + g[0].float()
                got[kk] = tuple(x.float() for x in g[1:]) if kk not in got \
                    else tuple(a + x.float() for a, x in zip(got[kk], g[1:]))
            parts[stream, t] = _kv_partial(got, k, v) if got else None

        def part(key):
            p = parts[key]
            if p is None:
                return torch.zeros(k.shape, dtype=torch.float32,
                                   device=k.device), torch.zeros(
                    v.shape, dtype=torch.float32, device=v.device)
            return p

        rounds = {s: max(t for (s2, t) in parts if s2 == s)
                  for s in ("up", "dn") if any(s2 == s for s2, _ in parts)}
        acc = {}
        for t in range(max(rounds.values()), 0, -1):
            back = [s for s in acc]  # round t + 1's accumulators hop back
            if back:
                moved = dist.ppermute_many(
                    [(acc[s], _shift_perm(r, _BACK_SHIFT[s])) for s in back],
                    axis)
                acc.update(zip(back, moved))
            for s, n in rounds.items():
                if t <= n:
                    c = part((s, t))
                    acc[s] = c if s not in acc else (acc[s][0] + c[0],
                                                     acc[s][1] + c[1])
        dk, dv = part((None, 0))
        moved = dist.ppermute_many(
            [(acc[s], _shift_perm(r, _BACK_SHIFT[s])) for s in acc], axis)
        for gk, gv in moved:
            dk, dv = dk + gk, dv + gv
        dq = _join(dq)
        return (dq.transpose(1, 2).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None)


def _rows(t, qs):
    """Rows ``qs`` of a [B, H, S] LSE or delta, contiguous for the
    kernel."""
    return t if qs == _ALL else t[..., qs].contiguous()


def _kv_partial(got, k, v):
    """A block's fp32 (dK, dV) in k's [B, S, H, D] layout from its key
    slices' [B, H, S, D] partials, zeros in rows no launch read."""
    whole = (_ALL.start, _ALL.stop)
    if list(got) == [whole]:
        return tuple(x.transpose(1, 2) for x in got[whole])
    out = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
           for t in (k, v)]
    for (lo, hi), gs in got.items():
        for o, g in zip(out, gs):
            o[:, lo:hi] += g.transpose(1, 2)
    return tuple(out)


def _attention_bwd(attention, q):
    """The backward of the ``attention`` hook for tensors like ``q``: the
    plain version on the CPU and for the plain hook, else the flash
    kernel's backward."""
    from repro_torch.kernels.flash_attention.ops import attention_bwd
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_ref)

    if q.device.type == "cpu" or attention is attention_ref:
        return attention_bwd_ref
    return attention_bwd



def ring_attention(q, k, v, *, axis: str, axis_size: int, causal=True,
                   window=None, cap=None, bidirectional=True, scale=None,
                   wire: str = "native", dist=None, attention=None):
    """Sequence-sharded attention; K/V blocks stream around the ring.

    q/k/v: [B, s_loc, H(,kv), dh], this rank's token block (index
    ``dist.axis_index(axis)``): local token t sits at ``i * s_loc + t``.
    The blocks travel as ``wire`` (``core/tatp.py:wire_relay``).  With
    ``attention`` (the flash kernel's signature, ``[B, H, S, D]`` views,
    ``return_lse=True``, ``q_offset``) each round that has a visible key
    is one call, and under autograd :class:`_RingAttention` gives the
    backward; without it the reference's online-softmax loop, which
    autograd differentiates through the relays' straight-through backward.
    A ``window`` masks global positions on both paths, forward and
    backward."""
    r = axis_size
    b, sl, hq, dh = q.shape
    hk = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    if r == 1:
        return local_attention(q, k, v, causal=causal, window=window, cap=cap,
                               scale=scale)
    i = dist.axis_index(axis)
    ring = _Ring(axis, r, causal, cap, bidirectional, scale, wire, dist,
                 attention, window=window)
    if attention is not None:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return _RingAttention.apply(q, k, v, ring)
        o32, _ = _hook_rounds(q, k, v, ring)
        return o32.to(q.dtype).transpose(1, 2)
    qg = _group(q, hk)
    ar = torch.arange(sl, device=q.device)
    qpos = i * sl + ar
    state = _init_state(b, hk, hq // hk, sl, dh, q.device)
    for _, _, j, kj, vj in _rounds(k, v, i, r, bidirectional, ring.relay):
        state = _block_update(qg, kj, vj, *state, qpos, j * sl + ar,
                              scale=scale, causal=causal, window=window,
                              cap=cap)
    return _finish(*state, q.dtype)


def zigzag_local_positions(axis: str, axis_size: int, s_loc: int,
                           dist=None, device=None):
    """Positions of this rank's tokens under the zigzag chunk layout: rank
    i owns global sequence chunks ``i`` and ``2R - 1 - i`` (c = s_loc / 2
    each)."""
    c = s_loc // 2
    i = dist.axis_index(axis) if axis_size > 1 else 0
    ar = torch.arange(c, device=device)
    return torch.cat([i * c + ar, (2 * axis_size - 1 - i) * c + ar])


def zigzag_permutation(axis_size: int, seq_len: int):
    """Host-side permutation of the global sequence dim so that sharding
    dim 1 over the ring delivers zigzag chunks: [chunk_i ‖
    chunk_{2R−1−i}]."""
    import numpy as _np
    r = axis_size
    c = seq_len // (2 * r)
    idx = []
    for i in range(r):
        idx.append(_np.arange(i * c, (i + 1) * c))
        j = 2 * r - 1 - i
        idx.append(_np.arange(j * c, (j + 1) * c))
    return _np.concatenate(idx)


def zigzag_ring_attention(q, k, v, *, axis: str, axis_size: int,
                          window=None, cap=None, bidirectional=True,
                          scale=None, wire: str = "native", dist=None,
                          attention=None):
    """Causal ring attention over the zigzag chunk layout.

    q/k/v: [B, s_loc, H(,kv), dh] with local tokens = global chunks (i,
    2R - 1 - i).  Each streamed source costs exactly two (c x c) updates,
    with uniform work a rank.  With ``attention`` (the flash kernel's
    signature) every update is one launch on c x c blocks at its chunks'
    position offset (:meth:`_Ring.launches`: 2R + 1 a rank, fewer where a
    window hides a launch), merged in fp32 by row LSE, and under autograd
    :class:`_RingAttention` gives the backward (a backward launch for each
    forward launch, at its masks and offset).  Without it, the reference's
    online-softmax loop, which autograd differentiates through the
    relays."""
    r = axis_size
    b, sl, hq, dh = q.shape
    hk = k.shape[2]
    c = sl // 2
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    if r == 1:
        return local_attention(q, k, v, causal=True, window=window, cap=cap,
                               scale=scale)
    i = dist.axis_index(axis)
    ring = _Ring(axis, r, True, cap, bidirectional, scale, wire, dist,
                 attention, zigzag=True, window=window)
    if attention is not None:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return _RingAttention.apply(q, k, v, ring)
        o32, _ = _hook_rounds(q, k, v, ring)
        return o32.to(q.dtype).transpose(1, 2)
    ar = torch.arange(c, device=q.device)
    pos_a, pos_b = i * c + ar, (2 * r - 1 - i) * c + ar
    qg = _group(q, hk)
    qa, qb = qg[:, :c], qg[:, c:]
    kw = dict(scale=scale, causal=True, window=window, cap=cap)
    # round 0: the whole local block (the causal mask hides q_A x k_B)
    my_pos = torch.cat([pos_a, pos_b])
    state = _block_update(qg, k, v, *_init_state(b, hk, hq // hk, sl, dh,
                                                 q.device),
                          my_pos, my_pos, **kw)
    sa = tuple(t[:, :, :, :c] for t in state)
    sb = tuple(t[:, :, :, c:] for t in state)

    def source(sa, sb, kv, j):
        """Zigzag selection: exactly two (c x c) updates a source."""
        kk, vv = kv
        src_a = j * c + ar
        if j < i:  # q_A and q_B x the source's chunk A
            sa = _block_update(qa, kk[:, :c], vv[:, :c], *sa, pos_a, src_a,
                               **kw)
            sb = _block_update(qb, kk[:, :c], vv[:, :c], *sb, pos_b, src_a,
                               **kw)
        else:  # q_B x the source's chunks A and B
            sb = _block_update(qb, kk[:, :c], vv[:, :c], *sb, pos_b, src_a,
                               **kw)
            sb = _block_update(qb, kk[:, c:], vv[:, c:], *sb, pos_b,
                               (2 * r - 1 - j) * c + ar, **kw)
        return sa, sb

    if not bidirectional:  # the reference's order: blocks move +1
        blk = (k, v)
        for t in range(1, r):
            blk = ring.relay(blk, +1)
            sa, sb = source(sa, sb, blk, (i - t) % r)
    else:
        from repro_torch.core.tatp import _n_rounds
        up, dn = (k, v), (k, v)
        for t in range(1, _n_rounds(r)):
            up = ring.relay(up, -1)
            sa, sb = source(sa, sb, up, (i + t) % r)
            if not (r % 2 == 0 and t == r // 2):  # antipodal: one block
                dn = ring.relay(dn, +1)
                sa, sb = source(sa, sb, dn, (i - t) % r)
    state = tuple(torch.cat([x, y], dim=3) for x, y in zip(sa, sb))
    return _finish(*state, q.dtype)


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
