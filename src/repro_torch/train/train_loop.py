"""Serve-step factory (counterpart of ``repro.train.train_loop``'s
``ServeBundle`` / ``make_serve_fns``).

The reference wraps :func:`lm.prefill` and :func:`lm.decode_step` in
``jit(shard_map(...))`` with partition specs for params, batches and
caches, which is why it also takes the serve shape.  On one device the
port needs none of that: the bundle holds plain closures that run the
model without autograd.  The train step is ROADMAP.md item A2.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.dist import Dist
from repro_torch.models import lm
from repro_torch.models.transformer import RunCtx


@dataclass(frozen=True)
class ServeBundle:
    prefill_fn: Callable
    decode_fn: Callable
    ctx: RunCtx


def make_serve_fns(cfg: ModelConfig, par: ParallelConfig, dist: Dist,
                   **hooks) -> ServeBundle:
    """``prefill_fn(params, batch) -> (caches, logits)`` and
    ``decode_fn(params, tokens, caches, cache_len) -> (next_tok, logits,
    caches)``; ``cache_len`` is a [B] vector (or a scalar).  ``hooks``
    override :class:`RunCtx`'s kernel hooks (``dot``, ``attention``)."""
    ctx = RunCtx(cfg, par, dist, phase="prefill", **hooks)

    @torch.no_grad()
    def prefill_fn(params, batch):
        return lm.prefill(ctx, params, batch)

    @torch.no_grad()
    def decode_fn(params, tokens, caches, cache_len):
        return lm.decode_step(ctx, params, tokens, caches, cache_len)

    return ServeBundle(prefill_fn, decode_fn, ctx)
