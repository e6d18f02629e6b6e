"""Train and serve step factories (counterpart of
``repro.train.train_loop``'s ``TrainBundle`` / ``make_train_step`` and
``ServeBundle`` / ``make_serve_fns``).

The reference wraps its steps in ``jit(shard_map(...))`` with partition
specs for params, optimizer state, batches and caches.  Here every rank
runs its own shard and the bundles hold plain closures: the serve steps
take the global batch and slice this rank's part (:func:`shard_batch`,
the counterpart of ``batch_specs``: rows over ``data``, the prompt's
sequence over ``model``), and gather what the reference's ``out_specs``
assemble (prefill's logits over both axes, decode's tokens over
``data``); parameters and caches stay this rank's shards (``param_specs``,
``lm.init_cache``).  On one device all of it is the identity.

The train step runs at ring degree 1 (above it, ROADMAP.md A3a).  It is
the reference's: the loss's gradients (autograd through the TATP
linears' explicit dgrad/wgrad and the attention and SSD kernels'
backwards), the gradient bookkeeping over the token and ring axes
(identities at degree 1: :func:`token_axes` is empty and
:func:`reduce_model_axis_grads` returns the grads), then AdamW.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch import not_ported
from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.core.dist import Dist
from repro_torch.models import lm
from repro_torch.models.transformer import RunCtx, init_params
from repro_torch.train.optimizer import (AdamW, AdamWConfig, OptState,
                                         tree_leaves)


def token_axes(par: ParallelConfig, dist: Dist) -> tuple[str, ...]:
    """Mesh axes over which training tokens are partitioned: none on one
    device."""
    if dist.model_degree > 1:
        raise not_ported("sequence-sharded training tokens", "A3a")
    return ()


def reduce_model_axis_grads(grads, par: ParallelConfig, dist: Dist):
    """The ring's gradient reduction of ring-replicated leaves; at degree
    1 the gradients are already complete."""
    if par.strategy == "tatp" and dist.model_degree > 1:
        raise not_ported("the ring's gradient reduction", "A3a")
    return grads


@dataclass(frozen=True)
class TrainBundle:
    step_fn: Callable  # (params, opt, batch) -> (params, opt, metrics)
    init_fn: Callable  # (generator) -> (params, opt)
    ctx: RunCtx
    opt: AdamW


def make_train_step(cfg: ModelConfig, par: ParallelConfig, dist: Dist,
                    shape: ShapeConfig,
                    opt_cfg: Optional[AdamWConfig] = None,
                    **hooks) -> TrainBundle:
    """``step_fn(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with the reference's metric keys (``loss``, ``tokens``,
    ``grad_norm``, ``lr``; 0-d tensors), and ``init_fn(generator) ->
    (params, opt_state)``.  ``step_fn`` updates ``params`` and the state
    in place (see :class:`AdamW`).  ``hooks`` override :class:`RunCtx`'s
    kernel hooks (``dot``, ``attention``, ``ssd``)."""
    if shape.kind != "train":
        raise ValueError(f"make_train_step needs a train shape, got "
                         f"{shape.kind!r}")
    ctx = RunCtx(cfg, par, dist, phase="train", **hooks)
    opt_cfg = opt_cfg or AdamWConfig(zero1=par.zero1,
                                     grad_compress=par.grad_compress)
    opt = AdamW(opt_cfg)
    token_axes(par, dist)  # none: the counts need no reduction

    def step_fn(params, opt_state: OptState, batch):
        nll, cnt, grads = loss_and_grads(ctx, params, batch)
        grads = reduce_model_axis_grads(grads, par, dist)
        params, opt_state, om = opt.update(params, grads, opt_state)
        metrics = {"loss": nll / cnt, "tokens": cnt, **om}
        return params, opt_state, metrics

    def init_fn(generator: torch.Generator):
        params = init_params(cfg, generator, dist.device)
        return params, opt.init(params)

    return TrainBundle(step_fn, init_fn, ctx, opt)


def loss_and_grads(ctx: RunCtx, params, batch):
    """The gradient half of the train step: ``(nll_sum, count, grads)``,
    the sums detached and ``grads`` in ``params``' layout.  The parameters
    require grad only during the call."""
    flat = [p for _, p in tree_leaves(params)]
    for p in flat:
        p.requires_grad_(True)
    try:
        nll, cnt, aux = lm.loss_fn(ctx, params, batch)
        cnt = cnt.detach()
        loss = nll / cnt + aux  # one loss shard
        grads = torch.autograd.grad(loss, flat)
    finally:
        for p in flat:
            p.requires_grad_(False)
    return nll.detach(), cnt, _unflatten(params, grads)


def _unflatten(tree, leaves):
    """``leaves`` (in :func:`tree_leaves` order) in ``tree``'s layout."""
    return _build(tree, iter(leaves))


def _build(node, it):
    # a plain function, not a closure that calls itself: that would be a
    # reference cycle keeping the step's gradients alive until the next gc
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    return next(it)


def check_prompt_len(dist: Dist, prompt_len: int) -> None:
    """A sequence-sharded prompt must split evenly over the ring."""
    if prompt_len % dist.model_degree:
        raise ValueError(f"prompt length {prompt_len} is not a multiple of "
                         f"the ring degree {dist.model_degree}")


def batch_rows(dist: Dist, n: int) -> slice:
    """This rank's rows of a batch of ``n``: a block over ``data`` when
    the data degree divides ``n``, else all (``Dist.batch_spec``)."""
    deg = dist.batch_degree
    if deg > 1 and n % deg == 0:
        i = dist.axis_index("data")
        return slice(i * n // deg, (i + 1) * n // deg)
    return slice(None)


def _seq_block(dist: Dist, t):
    """This rank's block of dim 1 over the ring."""
    r = dist.model_degree
    blk = t.shape[1] // r
    i = dist.axis_index(dist.model_axis)
    return t[:, i * blk:(i + 1) * blk]


def shard_batch(cfg: ModelConfig, batch: dict, dist: Dist) -> dict:
    """This rank's part of a global prefill batch (the reference's
    ``batch_specs`` for ``tatp``): the rows over ``data``; the tokens' and
    an encoder's frames' sequence over ``model``; a vision prefix
    replicated over ``model``."""
    check_prompt_len(dist, batch["tokens"].shape[1])
    out = {}
    for name, t in batch.items():
        t = t[batch_rows(dist, t.shape[0])]
        if name in ("tokens", "enc_embeds"):
            t = _seq_block(dist, t)
        out[name] = t
    return out


def _gather_rows(dist: Dist, t, n: int):
    """The global batch of ``n`` rows from each rank's :func:`batch_rows`."""
    if batch_rows(dist, n) == slice(None):
        return t
    return dist.all_gather(t, "data", dim=0)


@dataclass(frozen=True)
class ServeBundle:
    prefill_fn: Callable
    decode_fn: Callable
    ctx: RunCtx


def make_serve_fns(cfg: ModelConfig, par: ParallelConfig, dist: Dist,
                   **hooks) -> ServeBundle:
    """``prefill_fn(params, batch) -> (caches, logits)`` and
    ``decode_fn(params, tokens, caches, cache_len) -> (next_tok, logits,
    caches)``; ``cache_len`` is a [B] vector (or a scalar).  The prefill
    batch carries ``prefix_embeds`` or ``enc_embeds`` where the model
    takes them (as the train step's batch does).  ``hooks``
    override :class:`RunCtx`'s kernel hooks (``dot``, ``attention``).

    ``params`` and ``caches`` are this rank's shards; ``batch``,
    ``tokens`` and ``cache_len`` the global ones.  ``prefill_fn`` returns
    the global logits [B, 1, Vp] and ``decode_fn`` the global next tokens
    [B, 1] with this rank's logits (its rows and vocab block)."""
    ctx = RunCtx(cfg, par, dist, phase="prefill", **hooks)

    @torch.no_grad()
    def prefill_fn(params, batch):
        b = batch["tokens"].shape[0]
        caches, logits = lm.prefill(ctx, params, shard_batch(cfg, batch,
                                                             dist))
        logits = dist.all_gather(logits, dist.model_axis, dim=-1)
        return caches, _gather_rows(dist, logits, b)

    @torch.no_grad()
    def decode_fn(params, tokens, caches, cache_len):
        b = tokens.shape[0]
        rows = batch_rows(dist, b)
        if torch.is_tensor(cache_len) and cache_len.ndim:
            cache_len = cache_len[rows]
        tok, logits, caches = lm.decode_step(ctx, params, tokens[rows],
                                             caches, cache_len)
        return _gather_rows(dist, tok, b), logits, caches

    return ServeBundle(prefill_fn, decode_fn, ctx)
