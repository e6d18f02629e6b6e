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

The train step is the reference's: each rank's loss over its rows (over
``data``) and its sequence block (over the ring, ``tatp``) and its
gradients (autograd through the TATP rings' explicit dgrad/wgrad, ring
attention's rounds, the SSD's ring scan, the streamed cross-entropy and
the collectives' transposes, on the GEMM, attention and SSD kernels),
the gradient bookkeeping over the token and ring axes
(:func:`token_axes`: the count psummed over them, each rank's loss
``nll / count + aux / shards``;
:func:`reduce_model_axis_grads`: ring-replicated leaves psummed over the
ring), then AdamW over the data axes (ZeRO-1 shards its state over
``data``).  Every rank takes its part of the global batch
(:func:`shard_batch`; ``SyntheticDataset`` does it).  On one device all
of the bookkeeping is the identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.core.dist import Dist
from repro_torch.models import lm
from repro_torch.models.transformer import (RunCtx, check_strategy,
                                            init_params, param_specs)
from repro_torch.train.optimizer import (AdamW, AdamWConfig, OptState,
                                         tree_leaves)


def token_axes(par: ParallelConfig, dist: Dist) -> tuple[str, ...]:
    """Mesh axes over which training tokens are partitioned: the batch
    axes, and the ring under ``tatp`` above degree 1 (the reference's)."""
    axes = dist.present_batch_axes
    if par.strategy == "tatp" and dist.model_degree > 1:
        axes = axes + (dist.model_axis,)
    return axes


def _has_axis(spec, axis: str) -> bool:
    return any(e == axis or (isinstance(e, (tuple, list)) and axis in e)
               for e in spec)


def reduce_model_axis_grads(grads, pspecs, par: ParallelConfig, dist: Dist):
    """Under ``tatp`` the tokens are sharded over the ring, so the grads
    of ring-replicated leaves (norm scales, biases, ...) psum over it;
    ring-sharded leaves arrive complete through the collectives'
    transposes.  Under ``megatron`` the tokens are replicated and every
    rank's loss is the whole one: the sharded leaves and the norm scales
    (each at a column-parallel group's input, whose cotangent is already
    psummed) arrive complete, and the other replicated leaves, used only
    through this rank's block (the biases, ``wk``/``wv`` below 16 kv
    heads), psum over the ring.  ``pspecs``: :func:`param_specs` of the
    tree.  At degree 1 the grads as they are."""
    if par.strategy not in ("tatp", "megatron") or dist.model_degree <= 1:
        return grads
    mx = dist.model_axis

    def partial_(name, spec):
        if _has_axis(spec, mx):
            return False
        return par.strategy == "tatp" or not name.endswith("ln")

    def red(g, spec, name=""):
        if isinstance(g, dict):
            return {k: red(g[k], spec[k], k) for k in g}
        return dist.psum(g, mx) if partial_(name, spec) else g

    return red(grads, pspecs)


@dataclass(frozen=True)
class TrainBundle:
    step_fn: Callable  # (params, opt, batch) -> (params, opt, metrics)
    init_fn: Callable  # (generator) -> (params, opt)
    ctx: RunCtx
    opt: AdamW
    pspecs: Any = None  # param_specs of the tree (the checkpoints' layout)

    def specs(self, params):
        """Each leaf's layout over the mesh for ``(params, opt_state)``
        (:mod:`repro_torch.train.checkpoint`)."""
        return self.pspecs, self.opt.state_specs(params, self.pspecs)


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
    check_strategy(cfg, par.strategy, dist.model_degree)
    ctx = RunCtx(cfg, par, dist, phase="train", **hooks)
    opt_cfg = opt_cfg or AdamWConfig(zero1=par.zero1,
                                     grad_compress=par.grad_compress)
    opt = AdamW(opt_cfg, dist)
    pspecs = param_specs(cfg, par.strategy)
    tok_axes = token_axes(par, dist)

    def step_fn(params, opt_state: OptState, batch):
        nll, cnt_g, grads = loss_and_grads(ctx, params, batch)
        grads = reduce_model_axis_grads(grads, pspecs, par, dist)
        params, opt_state, om = opt.update(params, grads, opt_state)
        for a in tok_axes:
            nll = dist.psum(nll, a)
        metrics = {"loss": nll / cnt_g, "tokens": cnt_g, **om}
        return params, opt_state, metrics

    def init_fn(generator: torch.Generator):
        if dist.n_devices > 1:  # this rank's shards, drawn shard by shard
            from repro_torch.weights import init_sharded_params
            params = init_sharded_params(cfg, generator, dist, par.strategy)
        else:
            params = init_params(cfg, generator, dist.device)
        return params, opt.init(params)

    return TrainBundle(step_fn, init_fn, ctx, opt, pspecs)


def loss_and_grads(ctx: RunCtx, params, batch):
    """The gradient half of the train step: ``(nll_sum, count, grads)``,
    the sums detached and ``grads`` in ``params``' layout.  ``nll_sum``
    is this rank's; ``count`` is psummed over :func:`token_axes`, and
    each rank's loss is ``nll / count + aux / shards`` (shards: the
    ranks over those axes), as the reference's.  The parameters require
    grad only during the call."""
    dist = ctx.dist
    axes = token_axes(ctx.par, dist)
    shards = 1
    for a in axes:
        shards *= dist.axis_size(a)
    flat = [p for _, p in tree_leaves(params)]
    for p in flat:
        p.requires_grad_(True)
    try:
        nll, cnt, aux = lm.loss_fn(ctx, params, batch)
        cnt = cnt.detach()
        for a in axes:
            cnt = dist.psum(cnt, a)
        loss = nll / cnt + (aux / shards if shards > 1 else aux)
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


def check_prompt_len(dist: Dist, prompt_len: int, cfg=None) -> None:
    """A sequence-sharded prompt must split evenly over the ring; with
    Mamba-2 layers (``cfg``'s ``M``) each rank's block must also be whole
    SSD chunks, so the sequence must be a multiple of the ring degree
    times ``ssm_chunk`` (sequences are never padded).  Raises before any
    collective."""
    r = dist.model_degree
    if prompt_len % r:
        raise ValueError(f"prompt length {prompt_len} is not a multiple of "
                         f"the ring degree {r}")
    if cfg is not None and "M" in cfg.layer_pattern:
        step = r * cfg.ssm_chunk
        if prompt_len % step:
            raise ValueError(
                f"sequence length {prompt_len} is not a multiple of the "
                f"chunk size {cfg.ssm_chunk} (ssm_chunk) times the ring "
                f"degree {r}, {step}: every rank's block must be whole SSD "
                f"chunks and sequences are never padded")


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


def shard_batch(cfg: ModelConfig, batch: dict, dist: Dist,
                strategy: str = "tatp") -> dict:
    """This rank's part of a global prefill or train batch (the
    reference's ``batch_specs``): the rows over ``data``; under ``tatp``
    the tokens', labels' and an encoder's frames' sequence over ``model``
    (checked by :func:`check_prompt_len` first, as at degree 1), under
    ``megatron`` the whole sequence, replicated over ``model``; a vision
    prefix replicated over ``model``."""
    seq_sharded = strategy == "tatp"
    if seq_sharded or dist.model_degree == 1:
        check_prompt_len(dist, batch["tokens"].shape[1], cfg)
    out = {}
    for name, t in batch.items():
        t = t[batch_rows(dist, t.shape[0])]
        if seq_sharded and name in ("tokens", "labels", "valid",
                                    "enc_embeds"):
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
    [B, 1] with this rank's logits (its rows and vocab block).  Under
    ``megatron`` above degree 1 the prefill takes each rank's rows and the
    whole sequence and returns its kv heads' caches; its ``decode_fn``
    raises (ROADMAP.md C5), as what the reference cannot run raises here
    (:func:`~repro_torch.models.transformer.check_strategy`)."""
    check_strategy(cfg, par.strategy, dist.model_degree, "prefill")
    ctx = RunCtx(cfg, par, dist, phase="prefill", **hooks)

    @torch.no_grad()
    def prefill_fn(params, batch):
        b = batch["tokens"].shape[0]
        caches, logits = lm.prefill(ctx, params, shard_batch(
            cfg, batch, dist, par.strategy))
        logits = dist.all_gather(logits, dist.model_axis, dim=-1)
        return caches, _gather_rows(dist, logits, b)

    @torch.no_grad()
    def decode_fn(params, tokens, caches, cache_len):
        check_strategy(cfg, par.strategy, dist.model_degree, "decode")
        b = tokens.shape[0]
        rows = batch_rows(dist, b)
        if torch.is_tensor(cache_len) and cache_len.ndim:
            cache_len = cache_len[rows]
        tok, logits, caches = lm.decode_step(ctx, params, tokens[rows],
                                             caches, cache_len)
        return _gather_rows(dist, tok, b), logits, caches

    return ServeBundle(prefill_fn, decode_fn, ctx)
