"""Top-level language-model assembly (counterpart of ``repro.models.lm``):
the training loss :func:`loss_fn` with
:func:`vocab_parallel_xent`, the serving entry points :func:`prefill` and
:func:`decode_step`, the decode cache, and the slot graft.

The reference scans the stacked layer reps with ``lax.scan``; here a Python
loop walks the rep axis, indexing each stacked parameter (a view, no copy,
so gradients accumulate into the stacked leaf).  With
``ParallelConfig.remat`` the ``train`` phase checkpoints each rep, as the
reference wraps its scan body in ``jax.checkpoint``; with
``remat_policy="tatp_outputs"`` the rep's TATP linear outputs and attention
outputs are saved and the recompute reuses them
(:mod:`repro_torch.core.remat`), as the reference's
``save_only_these_names("tatp_y")``.  Layer kinds ``G``/``L`` (attention +
MLP, or + MoE FFN for MoE models, whose load-balance losses sum into
``aux``), ``M`` (Mamba-2) and ``S`` (zamba2's shared attention + MLP, one
parameter set for every slot) run; each slot keeps its own cache (K/V, or
the SSM state and conv tail).  An encoder-decoder first runs its encoder
(:func:`_encoder`) over the batch's ``enc_embeds``; the decoder then
cross-attends to its output after every ``G`` slot.  A vision-prefixed
model's ``prefix_embeds`` take the first ``frontend_tokens`` positions
(:func:`embed_tokens`).

Above model degree 1 (strategy ``tatp``) the embedding and the head are
vocab-parallel: train's and prefill's sequence-sharded tokens are
embedded by :func:`streamed_vocab_embed` (each rank adds its vocab rows
as the token blocks pass), a decode token by each rank's rows and a psum;
the training loss is :func:`streamed_vocab_xent` (the activation blocks
pass every rank's head shard, then each block's statistics ring back to
its owner); the last position's activation comes from the ring's last
rank; the greedy token is the argmax over the vocab shards (pmax, then
pmin of the global index: ties go to the lowest).  The caches are
sequence-sharded (:func:`init_cache`, :func:`shard_prompt_cache`).  The
encoder-decoder (its encoder's blocks bidirectional ring attention, its
cross blocks streaming the sequence-sharded encoder output), the vision
prefix (replicated over the ring, each rank taking its positions), zigzag
ring attention (``ParallelConfig(zigzag=True)`` on a batch permuted by
``attention.zigzag_permutation``), ``remat_policy="tatp_outputs"`` and
the Mamba-2 slots (the sequence-sharded SSD and the conv halo; their
decode state head-sharded) and the MoE slots (expert-parallel, their
slots moved by all-to-all) run on the ring as in the reference.

``megatron`` above degree 1 trains and prefills with the tokens
replicated over ``model``: each rank embeds the ids in its vocab rows and
the contributions psum (:meth:`Dist.psum_id_bwd`); the head gives the
rank's vocab block (its input through :meth:`Dist.id_psum_bwd`) and
:func:`vocab_parallel_xent` reduces the statistics over the ring; prefill
takes the last position where it is and returns each rank's kv heads of
the cache.  Its decode, like ``fsdp`` above degree 1, is a path the
reference cannot run (``transformer.check_strategy``, ROADMAP.md C5).
"""

from __future__ import annotations

from dataclasses import replace
from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.remat import SavedOutputs
from repro_torch.models.common import rms_norm, softcap
from repro_torch.models.transformer import (CONV_K, RunCtx, _unit_and_reps,
                                            attn_block, check_strategy,
                                            mamba_block, mlp_block,
                                            moe_block)


def _vocab_contrib(embed, tokens, off):
    """This rank's vocab-slice contribution to the embedding of
    ``tokens``: its rows for the ids in ``[off, off + Vloc)``, zero for
    the rest."""
    vloc = embed.shape[0]
    in_range = (tokens >= off) & (tokens < off + vloc)
    x = embed[torch.where(in_range, tokens - off, 0)]
    return torch.where(in_range[..., None], x, 0)


def streamed_vocab_embed(ctx: RunCtx, embed, tokens):
    """Vocab-parallel embedding of *sequence-sharded* tokens: the
    (token-block, partial-embedding) pair streams around the ring, every
    rank adds its vocab slice's rows as the block passes, and after R
    one-hop transfers the block arrives home fully embedded."""
    r, axis, dist = ctx.r, ctx.axis, ctx.dist
    off = dist.axis_index(axis) * embed.shape[0]
    perm = [((p - 1) % r, p) for p in range(r)]  # blocks move +1
    tok, acc = tokens, _vocab_contrib(embed, tokens, off)
    for t in range(1, r + 1):
        tok, acc = dist.ppermute((tok, acc), axis, perm)
        if t < r:
            acc = acc + _vocab_contrib(embed, tok, off)
    return acc  # back at the owner, complete


def embed_tokens(ctx: RunCtx, embed, tokens, prefix_embeds=None):
    """tokens: [B, s] (this rank's sequence block in a sharded prefill);
    embed: [Vp/R, D], this rank's vocab rows.

    With a modality frontend (``cfg.frontend_tokens``) and
    ``prefix_embeds`` [B, frontend_tokens, D], the first
    ``frontend_tokens`` global positions take the precomputed embeddings
    instead, after the embedding scale.  (The reference's ``pos_offset``
    counts positions from a decode step's offset, where no prefix is
    passed.)"""
    cfg, r = ctx.cfg, ctx.r
    seq_sharded = (ctx.par.strategy == "tatp" and r > 1
                   and ctx.phase != "decode")
    if seq_sharded:
        x = streamed_vocab_embed(ctx, embed, tokens)
    elif r > 1:  # tokens replicated over the ring (megatron, decode)
        off = ctx.dist.axis_index(ctx.axis) * embed.shape[0]
        x = ctx.dist.psum_id_bwd(_vocab_contrib(embed, tokens, off),
                                 ctx.axis)
    else:
        x = embed[tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype,
                             device=x.device)
    if prefix_embeds is not None and cfg.frontend_tokens:
        f, s = cfg.frontend_tokens, tokens.shape[1]
        pos = torch.arange(s, device=x.device)
        if seq_sharded:
            pos = pos + ctx.dist.axis_index(ctx.axis) * s
        pref = prefix_embeds[:, pos.clamp(0, f - 1)].to(x.dtype)
        x = torch.where((pos < f)[None, :, None], pref, x)
    return x


def _bf16_terms(g):
    """fp32 ``g`` as three bf16 tensors whose sum is ``g`` (each term holds
    the next 8 significant bits of the remainder, so the split is exact
    to fp32 precision)."""
    hi = g.to(torch.bfloat16)
    r = g - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


class _HeadMatmul(torch.autograd.Function):
    """``logits = x @ w`` in the train phase: the operands in the model
    dtype, accumulated and returned in fp32 on the ``dot`` hook, as the
    reference's einsum with fp32 preferred element type.

    JAX transposes that einsum into products of the fp32 cotangent with
    the operands *promoted to fp32* (``dot_general(g_f32, w_bf16)``, which
    XLA evaluates in fp32; checked on a small bf16 case on the CPU), then
    casts dx and dw to the model dtype.  Where the model dtype is bf16 the
    backward therefore splits g exactly into three bf16 terms
    (:func:`_bf16_terms`): every term times a bf16 operand is exact in the
    GEMM's fp32 accumulator, so the bf16 tensor cores give the fp32
    products.  The dgrad stacks the terms on M in one GEMM and sums the
    three fp32 partials; the wgrad stacks them on the contraction (x
    repeated three times) in one GEMM."""

    @staticmethod
    def forward(ctx, x, w, dot):
        ctx.save_for_backward(x, w)
        ctx.dot = dot
        return dot(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dot = ctx.dot
        if g.stride(-1) != 1:  # e.g. the expanded cotangent of a sum
            g = g.contiguous()
        if x.dtype == g.dtype:
            return dot(g, w.t()), dot(x.t(), g).to(w.dtype), None
        m = g.shape[0]
        gs = torch.cat(_bf16_terms(g), dim=0)  # [3M, V]
        dx = dot(gs, w.t(), out_dtype=torch.float32).view(3, m, -1)
        dx = (dx[0] + dx[1] + dx[2]).to(x.dtype)
        xs = torch.cat([x, x, x], dim=0)  # [3M, D]
        return dx, dot(xs.t(), gs, out_dtype=w.dtype), None


def lm_head_logits(ctx: RunCtx, params, x):
    """fp32 logits over the padded vocab.  In the ``train`` phase the
    product runs on the ``dot`` hook with the operands in the model dtype
    (:class:`_HeadMatmul`), as the reference computes it; the serve phases
    keep a plain product of fp32 upcasts."""
    cfg = ctx.cfg
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    if ctx.r > 1:  # a replicated input to this rank's vocab columns
        x = ctx.dist.id_psum_bwd(x, ctx.axis)
    if ctx.phase == "train":
        lead = x.shape[:-1]
        logits = _HeadMatmul.apply(x.reshape(-1, x.shape[-1]), w, ctx.dot)
        logits = logits.reshape(*lead, -1)
    else:
        logits = torch.matmul(x.float(), w.float())
    return softcap(logits, cfg.logit_softcap)


def vocab_parallel_xent(ctx: RunCtx, logits, labels, valid):
    """Cross-entropy of ring-*replicated* tokens (``megatron``, or one
    device) over vocab-parallel logits.

    logits: [B, s, Vp/R] fp32, this rank's vocab block; labels/valid:
    [B, s].  Padded columns are masked to -1e30; the max shift is a
    stop-gradient, as the reference's.  Above degree 1 the shift is the
    pmax of the blocks' maxima and the sums of exponentials and the
    target logits psum over the ring (:meth:`Dist.psum_id_bwd`: every
    rank's loss is the whole one, so each block's cotangent is whole).
    Returns (sum_nll, sum_count).  ``tatp`` above degree 1 takes
    :func:`streamed_vocab_xent`."""
    cfg, r, dist = ctx.cfg, ctx.r, ctx.dist
    vloc = logits.shape[-1]
    off = dist.axis_index(ctx.axis) * vloc if r > 1 else 0
    cols = off + torch.arange(vloc, device=logits.device)
    logits = torch.where(cols < cfg.vocab_size, logits, -1e30)
    m = logits.amax(dim=-1).detach()
    if r > 1:
        m = dist.pmax(m, ctx.axis)
    se = torch.exp(logits - m[..., None]).sum(dim=-1)
    if r > 1:
        se = dist.psum_id_bwd(se, ctx.axis)
    lse = torch.log(se) + m
    in_range = (labels >= off) & (labels < off + vloc)
    local = torch.where(in_range, labels - off, 0)
    tgt = torch.gather(logits, -1, local[..., None].long())[..., 0]
    if r > 1:
        tgt = dist.psum_id_bwd(torch.where(in_range, tgt, 0.0), ctx.axis)
    nll = (lse - tgt) * valid
    return nll.sum(), valid.float().sum()


def streamed_vocab_xent(ctx: RunCtx, params, x, labels, valid):
    """Head and cross-entropy for *sequence-sharded* tokens (``tatp``
    above degree 1; the reference's ``streamed_vocab_xent``).

    Pass 1 streams the (activation, label) blocks around the ring (+1 a
    hop): each rank computes every block's partial (max, sum of exp,
    target logit) against its vocab shard, its head product on the
    ``dot`` hook as :class:`_HeadMatmul` (fp32 logits of model-dtype
    operands).  Pass 2 rings each block's statistics back to its owner
    (-1 a hop), combining them.  No rank ever holds more than one [B,
    s_loc, Vp/R] logits block.  The max shifts are stop-gradients; the
    relays are differentiable (``Dist.ppermute``), so each rank's head
    shard gathers the gradient of every block.  Returns (sum_nll,
    sum_count) of this rank's block."""
    cfg, r, axis, dist = ctx.cfg, ctx.r, ctx.axis, ctx.dist
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    vloc = w.shape[1]
    off = dist.axis_index(axis) * vloc
    cols_ok = (off + torch.arange(vloc, device=x.device)) < cfg.vocab_size

    def slice_stats(xb, lb):
        logits = _HeadMatmul.apply(xb.reshape(-1, xb.shape[-1]), w, ctx.dot)
        logits = softcap(logits.reshape(*xb.shape[:-1], vloc),
                         cfg.logit_softcap)
        logits = torch.where(cols_ok, logits, -1e30)
        m = logits.amax(dim=-1).detach()
        se = torch.exp(logits - m[..., None]).sum(dim=-1)
        in_r = (lb >= off) & (lb < off + vloc)
        ids = torch.where(in_r, lb - off, 0)
        tgt = torch.gather(logits, -1, ids[..., None].long())[..., 0]
        return m, se, torch.where(in_r, tgt, 0.0)

    def combine(a, b):
        (m1, s1, t1), (m2, s2, t2) = a, b
        m1, m2 = m1.detach(), m2.detach()
        m = torch.maximum(m1, m2)
        return m, s1 * torch.exp(m1 - m) + s2 * torch.exp(m2 - m), t1 + t2

    if r == 1:
        m, se, tgt = slice_stats(x, labels)
    else:
        blk, stats = (x, labels), []
        for t in range(r):  # pass 1: rank j's stats[t] covers block j - t
            stats.append(slice_stats(*blk))
            if t < r - 1:
                blk = dist.ppermute(blk, axis,
                                    [((p - 1) % r, p) for p in range(r)])
        acc = stats[r - 1]  # pass 2: back to each block's owner
        for s in range(1, r):
            acc = dist.ppermute(acc, axis,
                                [((p + 1) % r, p) for p in range(r)])
            acc = combine(acc, stats[r - 1 - s])
        m, se, tgt = acc
    nll = (torch.log(se) + m - tgt) * valid
    return nll.sum(), valid.float().sum()


def loss_fn(ctx: RunCtx, params, batch):
    """Training loss.  batch: tokens/labels [B, s] (+ an optional ``valid``
    mask, ones by default; ``prefix_embeds`` for a vision-prefixed model,
    ``enc_embeds`` [B, T, D] for an encoder-decoder).  Returns (nll_sum,
    count, aux_total)."""
    cfg = ctx.cfg
    ctx = replace(ctx, phase="train")
    check_strategy(cfg, ctx.par.strategy, ctx.r, ctx.phase)
    enc_out = _encoder(ctx, params, batch)
    x = embed_tokens(ctx, params["embed"], batch["tokens"],
                     batch.get("prefix_embeds"))
    x, aux, _ = _stack(ctx, params, x, enc_out=enc_out)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    valid = batch.get("valid")
    if valid is None:
        valid = torch.ones(batch["labels"].shape, dtype=torch.float32,
                           device=x.device)
    if ctx.par.strategy == "tatp" and ctx.r > 1:
        nll_sum, cnt = streamed_vocab_xent(ctx, params, x, batch["labels"],
                                           valid)
    else:
        logits = lm_head_logits(ctx, params, x)
        nll_sum, cnt = vocab_parallel_xent(ctx, logits, batch["labels"],
                                           valid)
    aux_total = cfg.aux_coef * aux if cfg.is_moe else 0.0
    return nll_sum, cnt, aux_total


def _encoder(ctx: RunCtx, params, batch):
    """The encoder of an encoder-decoder (None for any other model): its
    blocks (bidirectional self-attention + MLP) over ``enc_embeds`` [B, T,
    D], cast to the model dtype, then its own final norm.  In the
    ``train`` phase with ``par.remat`` each block is checkpointed in full,
    whatever ``remat_policy`` says, as the reference wraps the encoder's
    scan body in a plain ``jax.checkpoint``: it saves no outputs for the
    ``tatp_outputs`` policy and its recompute takes none."""
    cfg = ctx.cfg
    if not cfg.n_enc_layers:
        return None
    x = batch["enc_embeds"].to(ctx.dtype)
    blocks = params["enc"]["blocks"]

    def body(i, x):
        p = {n: t[i] for n, t in blocks.items()}
        x, _ = attn_block(ctx, p, x, kind="G", pos_offset=0, bidir_self=True)
        return mlp_block(ctx, p, x)

    for i in range(cfg.n_enc_layers):
        if ctx.par.remat and ctx.phase == "train":
            x = checkpoint(partial(body, i), x, use_reentrant=False)
        else:
            x = body(i, x)
    return rms_norm(x, params["enc"]["final_ln"], cfg.norm_eps)


def _stack(ctx: RunCtx, params, x, caches=None, cache_len=None,
           enc_out=None):
    """Run the decoder stack.  Returns (x, aux_loss, new_caches).

    ``prefill`` returns each block's cache leaves stacked on the rep axis
    (``{"k", "v"}`` for attention slots, ``{"state", "conv"}`` for Mamba-2
    slots); ``decode`` updates ``caches`` in place and returns it.  An
    encoder-decoder runs a cross-attention block over ``enc_out`` after
    every ``G`` slot, with the rep's ``cross`` parameters; its cache is
    the rep's ``"cross"`` leaves (the encoder's K/V, written by prefill
    and read by decode).  In the ``train`` phase with ``par.remat`` each
    rep is checkpointed (its activations are recomputed in the backward;
    with the ``tatp_outputs`` policy but for the saved outputs, the cross
    blocks' included).  ``aux`` is the fp32 sum of the MoE blocks'
    load-balance losses (0 without MoE)."""
    cfg = ctx.cfg
    unit, reps = _unit_and_reps(cfg)
    shared = params.get("shared")
    has_cross = cfg.n_enc_layers > 0
    collect = caches is None and ctx.phase == "prefill"
    remat = ctx.par.remat and ctx.phase == "train"
    policy = ctx.par.remat_policy
    if remat and policy not in ("full", "tatp_outputs"):
        raise ValueError(f"unknown remat_policy {policy!r}")
    new: dict[str, dict[str, list]] = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def rep_cache(key, i):
        if caches is None:
            return None
        return {n: t[i] for n, t in caches[key].items()}

    def rep_body(i, x, enc_out):
        out = {}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for pos, kind in enumerate(unit):
            key = f"u{pos}"
            if kind == "S":
                p = shared
            else:
                p = {n: t[i] for n, t in params["layers"][key].items()}
            c = rep_cache(key, i)
            if kind in ("G", "L", "S"):
                x, nc = attn_block(ctx, p, x, kind=kind, pos_offset=0,
                                   cache=c, cache_len=cache_len)
                if cfg.is_moe and kind != "S":
                    x, a = moe_block(ctx, p, x, i * len(unit) + pos)
                    aux = aux + a
                else:
                    x = mlp_block(ctx, p, x)
            elif kind == "M":
                x, nc = mamba_block(ctx, p, x, cache=c, cache_len=cache_len)
            else:
                raise ValueError(f"layer kind {kind!r}")
            out[key] = nc
            if has_cross and kind == "G":
                pc = {n: t[i] for n, t in params["cross"].items()}
                x, out["cross"] = attn_block(
                    ctx, pc, x, kind="G", pos_offset=0,
                    cache=rep_cache("cross", i), cache_len=cache_len,
                    xattn_kv=enc_out, is_cross=True)
        return x, aux, out

    for i in range(reps):
        if remat:  # partial binds i: the recompute runs after the loop
            body = partial(_rep_outputs, partial(rep_body, i))
            if policy == "tatp_outputs":
                body = partial(SavedOutputs().run, body)
            x, a = checkpoint(body, x, enc_out, use_reentrant=False)
            aux = aux + a
            continue
        x, a, out = rep_body(i, x, enc_out)
        aux = aux + a
        if collect:
            for key, nc in out.items():
                for n, t in nc.items():
                    new.setdefault(key, {}).setdefault(n, []).append(t)
    if collect:
        return x, aux, {key: {n: torch.stack(ts) for n, ts in leaves.items()}
                        for key, leaves in new.items()}
    return x, aux, caches


def _rep_outputs(body, x, enc_out):
    """A checkpointed rep's outputs: (x, aux); its caches are None."""
    return body(x, enc_out)[:2]


def prefill(ctx: RunCtx, params, batch):
    """Build caches from a full prompt.  Returns (caches, last_logits):
    caches ``{"u<pos>": leaves}`` in :func:`init_cache`'s layout with the
    prompt's length on the K/V sequence axis (an encoder-decoder's
    ``"cross"`` leaves hold the encoder's K/V, the batch's
    ``enc_embeds`` length), and fp32 logits [B, 1, Vp] for the final
    position.  With Mamba-2 layers the prompt length must
    be a multiple of ``cfg.ssm_chunk`` (it is never padded).

    Above degree 1 the batch holds this rank's sequence block, the caches
    its block of positions, and the logits its vocab block [B, 1, Vp/R]
    (under ``tatp`` the final position lives on the ring's last rank,
    whose activation every rank takes by a psum; under ``megatron`` the
    batch is the whole sequence, replicated over the ring, and the caches
    hold this rank's kv heads)."""
    cfg = ctx.cfg
    ctx = replace(ctx, phase="prefill")
    check_strategy(cfg, ctx.par.strategy, ctx.r, ctx.phase)
    enc_out = _encoder(ctx, params, batch)
    x = embed_tokens(ctx, params["embed"], batch["tokens"],
                     batch.get("prefix_embeds"))
    x, _, caches = _stack(ctx, params, x, enc_out=enc_out)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    last = x[:, -1:, :]
    if ctx.par.strategy == "tatp" and ctx.r > 1:
        if ctx.dist.axis_index(ctx.axis) != ctx.r - 1:
            last = torch.zeros_like(last)
        last = ctx.dist.psum(last, ctx.axis)
    logits = lm_head_logits(ctx, params, last)
    return caches, logits


def decode_step(ctx: RunCtx, params, tokens, caches, cache_len):
    """One decode step.  tokens: [B, 1]; cache_len includes the token being
    processed — a scalar or a [B] vector.  Returns (next_token [B, 1],
    logits [B, 1, Vp/R], caches); the caches are updated in place.  The
    greedy token is the argmax over the real vocab (padded columns masked
    to -inf); above degree 1 over the vocab shards: the largest logit by
    pmax, then the lowest global index that holds it by pmin, the
    reference's tie-break."""
    cfg = ctx.cfg
    ctx = replace(ctx, phase="decode")
    check_strategy(cfg, ctx.par.strategy, ctx.r, ctx.phase)
    x = embed_tokens(ctx, params["embed"], tokens)
    x, _, caches = _stack(ctx, params, x, caches=caches, cache_len=cache_len)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = lm_head_logits(ctx, params, x)
    vloc = logits.shape[-1]
    off = ctx.dist.axis_index(ctx.axis) * vloc
    cols = off + torch.arange(vloc, device=logits.device)
    lmask = torch.where(cols < cfg.vocab_size, logits, float("-inf"))
    next_tok = off + lmask.argmax(dim=-1)
    if ctx.r > 1:
        best = lmask.amax(dim=-1)
        top = ctx.dist.pmax(best, ctx.axis)
        next_tok = ctx.dist.pmin(
            torch.where(best >= top, next_tok, torch.iinfo(torch.int64).max),
            ctx.axis)
    return next_tok, logits, caches


def init_cache(ctx: RunCtx, batch_local: int, max_seq: int,
               enc_len=None):
    """Zero caches matching :func:`_stack`'s layout (axis 0 the rep, axis 1
    the batch slot): attention slots ``{"k", "v"}`` [reps, B, max_seq / R,
    Hkv, D] (this rank's block of positions) in the activation dtype;
    Mamba-2 slots ``{"state"}`` [reps, B, H / R, P, N] (this rank's
    heads) in fp32 and ``{"conv"}`` [reps, B, CONV_K - 1, d_inner + 2N]
    in the activation dtype; an encoder-decoder's ``"cross"`` ``{"k",
    "v"}`` [reps, B, T / R, Hkv, D] with T ``enc_len`` (default
    ``frontend_tokens``)."""
    cfg = ctx.cfg
    unit, reps = _unit_and_reps(cfg)
    kw = dict(dtype=ctx.dtype, device=ctx.device)

    def kv(seq):
        shape = (reps, batch_local, seq // ctx.r, cfg.n_kv_heads,
                 cfg.head_dim)
        return {n: torch.zeros(shape, **kw) for n in ("k", "v")}

    caches = {}
    for pos, kind in enumerate(unit):
        if kind in ("G", "L", "S"):
            leaves = kv(max_seq)
        elif kind == "M":
            conv_dim = cfg.d_inner + 2 * cfg.ssm_state
            leaves = {
                "state": torch.zeros(
                    (reps, batch_local, cfg.ssm_heads // ctx.r,
                     cfg.ssm_head_dim, cfg.ssm_state),
                    dtype=torch.float32, device=ctx.device),
                "conv": torch.zeros((reps, batch_local, CONV_K - 1,
                                     conv_dim), **kw),
            }
        else:
            raise ValueError(f"layer kind {kind!r}")
        caches[f"u{pos}"] = leaves
    if cfg.n_enc_layers:
        caches["cross"] = kv(enc_len or cfg.frontend_tokens)
    return caches


def cache_specs(ctx: RunCtx, batch: int):
    """Each leaf's mesh axis per dim, in :func:`init_cache`'s structure,
    for a cache of ``batch`` global rows (the reference's ``cache_specs``
    on the port's layout): the batch over ``data`` where its degree
    divides ``batch``; K/V positions, the cross blocks' encoder positions
    and the Mamba-2 state's heads over the ring; the conv tail replicated
    over it.  An axis of degree 1 is None."""
    dist = ctx.dist
    deg = dist.batch_degree
    b = "data" if deg > 1 and batch % deg == 0 else None
    mx = ctx.axis if ctx.r > 1 else None
    unit, _ = _unit_and_reps(ctx.cfg)
    kv = {n: (None, b, mx, None, None) for n in ("k", "v")}
    ssm = {"state": (None, b, mx, None, None), "conv": (None, b, None, None)}
    specs = {f"u{pos}": dict(kv if kind in ("G", "L", "S") else ssm)
             for pos, kind in enumerate(unit)}
    if ctx.cfg.n_enc_layers:
        specs["cross"] = dict(kv)
    return specs


def shard_prompt_cache(ctx: RunCtx, caches, max_seq: int):
    """Prefill's self-attention K/V (sequence blocks of ``prompt / R``)
    moved to the ranks that own those positions in a ``max_seq`` decode
    cache (blocks of ``max_seq / R``): each leaf is all-gathered along the
    sequence and this rank keeps its block's prompt positions (fewer than
    ``max_seq / R``, or none, where the prompt ends inside or before it;
    :func:`graft_cache_slots` copies the common head).  The cross blocks'
    encoder K/V keep their blocks.  At R = 1 the caches as they are."""
    if ctx.r == 1:
        return caches
    i = ctx.dist.axis_index(ctx.axis)
    sloc = max_seq // ctx.r
    out = {}
    for key, leaves in caches.items():
        if key == "cross" or "k" not in leaves:
            out[key] = leaves
            continue
        out[key] = {n: ctx.dist.all_gather(t, ctx.axis, dim=2)[
            :, :, i * sloc:(i + 1) * sloc] for n, t in leaves.items()}
    return out


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def graft_cache_slots(big, small, slots, rows=None):
    """Write ``small``'s batch rows into ``big``'s batch *slots* (axis 1 of
    every cache leaf; axis 0 is the rep axis) and return ``big``.

    Attention K/V leaves copy the common head of the sequence axis (a
    prompt window into the head of a longer slot); SSM state and conv
    leaves, whose axis 2 has no context length, copy whole rows.  The
    reference does this on the host with numpy; here it is an in-place
    copy on the device."""
    rows = list(rows) if rows is not None else list(range(len(slots)))
    slots = list(slots)
    if not slots:
        return big
    for path, d in _leaves(big):
        s = _leaf(small, path)
        si = torch.as_tensor(slots, device=d.device)
        ri = torch.as_tensor(rows, device=s.device)
        if d.ndim >= 3 and d.shape[2] != s.shape[2]:
            w = min(d.shape[2], s.shape[2])
            d[:, si, :w] = s[:, ri, :w].to(d.dtype)
        else:
            d[:, si] = s[:, ri].to(d.dtype)
    return big
