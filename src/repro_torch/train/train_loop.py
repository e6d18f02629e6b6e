"""Train and serve step factories (counterpart of
``repro.train.train_loop``'s ``TrainBundle`` / ``make_train_step`` and
``ServeBundle`` / ``make_serve_fns``) at ring degree 1 on one device.

The reference wraps its steps in ``jit(shard_map(...))`` with partition
specs for params, optimizer state, batches and caches.  On one device the
port needs none of that: the bundles hold plain closures.  The train step
is the reference's: the loss's gradients (autograd through the TATP
linears' explicit dgrad/wgrad and the attention and SSD kernels'
backwards), the
gradient bookkeeping over the token and ring axes (identities at degree
1: :func:`token_axes` is empty and :func:`reduce_model_axis_grads`
returns the grads), then AdamW.
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
        raise not_ported("sequence-sharded training tokens", "A3")
    return ()


def reduce_model_axis_grads(grads, par: ParallelConfig, dist: Dist):
    """The ring's gradient reduction of ring-replicated leaves; at degree
    1 the gradients are already complete."""
    if par.strategy == "tatp" and dist.model_degree > 1:
        raise not_ported("the ring's gradient reduction", "A3")
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
    override :class:`RunCtx`'s kernel hooks (``dot``, ``attention``)."""
    ctx = RunCtx(cfg, par, dist, phase="prefill", **hooks)

    @torch.no_grad()
    def prefill_fn(params, batch):
        return lm.prefill(ctx, params, batch)

    @torch.no_grad()
    def decode_fn(params, tokens, caches, cache_len):
        return lm.decode_step(ctx, params, tokens, caches, cache_len)

    return ServeBundle(prefill_fn, decode_fn, ctx)
