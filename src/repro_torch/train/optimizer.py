"""AdamW with fp32 master weights and ZeRO-1 (counterpart of
``repro.train.optimizer``).

A copy of the reference's update rule: fp32 master copies of every leaf,
the learning rate from warmup plus cosine evaluated at the pre-increment
step, bias correction at ``t = step + 1``, global-norm clipping at
``grad_clip / (gnorm + 1e-6)``, decoupled weight decay on every leaf with
``ndim >= 2`` (stacked norm scales included), and the new parameters cast
back to the model dtype.  Leaves are visited in the reference's tree
order (dict keys sorted), so the global norm sums in the same order.

Over the data axes, as the reference: the gradients psum over every data
axis but the shard axis (``data``); under ZeRO-1 with ``data`` above 1
each rank owns a 1/dp slice of every flattened, zero-padded leaf's
master, m and v, the gradient is psum-scattered to the owner
(:meth:`~repro_torch.core.dist.Dist.psum_scatter`), the global norm is
psummed over ``data``, and the updated slices are all-gathered back into
the parameters.  Without ZeRO-1 (or at dp = 1) every rank keeps the full
copy.  The leaves are this rank's shards (``param_specs``), so on a
``(data, model)`` mesh each slice is of the rank's model shard.

Unlike the reference, which returns new arrays (and donates the old ones
to ``jit``), :meth:`AdamW.update` updates the parameters, masters and
moments in place and returns the same tensors: no second copy of the
state exists at any time.

int8 gradient compression with error feedback (``grad_compress``, the
reference's ``_compressed_reduce``): each leaf's gradient plus its
residual (under ZeRO-1 the residual slices all-gathered over ``data``)
is quantised with one scale, the absolute max pmaxed over the data axes
over 127, rounded half to even and clipped to [-127, 127]; the
dequantised values are reduced as above, and the rounding error is the
new residual (this rank's slice under ZeRO-1).  It runs at every mesh,
one device included, as the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    zero1: bool = True
    grad_compress: bool = False  # int8 + error feedback on the DP reduction
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step) -> float:
    """The learning rate at (pre-increment) ``step``, computed in fp32 as
    the reference computes it."""
    f = np.float32
    step = f(step)
    warm = np.minimum(f(1.0), (step + f(1)) / f(max(cfg.warmup_steps, 1)))
    prog = np.clip((step - f(cfg.warmup_steps))
                   / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f(0.0), f(1.0))
    cos = f(0.5) * (f(1) + np.cos(f(np.pi) * prog))
    ratio = f(cfg.min_lr_ratio)
    return float(f(cfg.lr) * warm * (ratio + (f(1) - ratio) * cos))


class ZeroSlice(NamedTuple):
    """The layout of a ZeRO-1 state leaf (:meth:`AdamW.state_specs`): this
    rank's slice over ``axis`` of its model shard (``shape``, laid over
    the mesh by the parameter's ``spec``) flattened and zero-padded."""

    spec: tuple
    shape: tuple
    axis: str = "data"


class OptState(NamedTuple):
    step: int
    master: Any  # fp32 master copies
    m: Any
    v: Any
    err: Any  # error-feedback residuals (0-d zeros: no grad_compress)


def tree_leaves(tree, prefix=()):
    """``(path, leaf)`` pairs in the reference's order (dict keys sorted,
    as ``jax.tree.leaves`` visits them)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over ``tree``, ``other`` in its layout."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def _flat_pad(x, dp: int):
    """``x`` flattened, zero-padded to a multiple of ``dp`` and viewed as
    ``[dp, -1]`` (the reference's ``_flat_pad``)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % dp
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(dp, -1)


class AdamW:
    """The reference's manual-SPMD ``AdamW`` on ``dist``'s mesh (the
    one-device ``Dist`` by default): ``data_axes`` the batch axes the
    gradients reduce over, ZeRO-1's shard axis ``data`` when it has more
    than one rank and ``cfg.zero1``."""

    def __init__(self, cfg: AdamWConfig, dist=None):
        self.cfg = cfg
        self.dist = dist
        self.data_axes = dist.present_batch_axes if dist is not None else ()
        dp = dist.axis_size("data") if dist is not None else 1
        self.shard_axis = "data" if dp > 1 and cfg.zero1 else None
        self.dp = dp if self.shard_axis else 1

    def _own(self, x):
        """This rank's ZeRO-1 slice of ``x`` (a copy), or ``x`` itself."""
        if self.shard_axis is None:
            return x
        idx = self.dist.axis_index(self.shard_axis)
        return _flat_pad(x, self.dp)[idx].clone()

    def init(self, params) -> OptState:
        master = tree_map(lambda p: self._own(p.detach().float().clone()),
                          params)
        if self.cfg.grad_compress:  # the residuals: the master's layout
            err = tree_map(torch.zeros_like, master)
        else:
            err = tree_map(lambda p: torch.zeros((), dtype=torch.float32,
                                                 device=p.device), master)
        return OptState(0, master, tree_map(torch.zeros_like, master),
                        tree_map(torch.zeros_like, master), err)

    def state_specs(self, params, pspecs) -> OptState:
        """The layout of :meth:`init`'s state over the mesh, for the
        checkpoints (the reference's ``state_specs``): ``master``, ``m``
        and ``v`` as ``pspecs`` (a leaf's spec: the mesh axis of each dim),
        or a :class:`ZeroSlice` a leaf under ZeRO-1; the integer step
        replicated, and ``err`` as the master under ``grad_compress``,
        else its 0-d leaves replicated."""
        if self.shard_axis:
            sliced = _map2(lambda p, s: ZeroSlice(tuple(s), tuple(p.shape),
                                                  self.shard_axis),
                           params, pspecs)
        else:
            sliced = pspecs
        err = sliced if self.cfg.grad_compress else tree_map(lambda _: (),
                                                            params)
        return OptState(None, sliced, sliced, sliced, err)

    @torch.no_grad()
    def update(self, params, grads, state: OptState):
        """One step; ``grads`` has ``params``' tree structure.  Returns
        (params, state, {"grad_norm", "lr"}) with ``params`` and the
        state's tensors updated in place."""
        cfg = self.cfg
        flat_p = [p for _, p in tree_leaves(params)]
        flat_g = [g for _, g in tree_leaves(grads)]
        flat_master = [t for _, t in tree_leaves(state.master)]
        flat_m = [t for _, t in tree_leaves(state.m)]
        flat_v = [t for _, t in tree_leaves(state.v)]
        if len(flat_g) != len(flat_p):
            raise ValueError("grads do not match the parameter tree")

        if cfg.grad_compress:
            flat_e = [t for _, t in tree_leaves(state.err)]
            flat_g = [self._compressed_reduce(g, e)
                      for g, e in zip(flat_g, flat_e)]
        else:
            flat_g = [self._reduce(g) for g in flat_g]
        # global grad-norm clip (over the full parameter set), fp32
        sq = None
        for g in flat_g:
            g32 = g.float()
            s = (g32 * g32).sum()
            sq = s if sq is None else sq + s
        if self.shard_axis:
            sq = self.dist.psum(sq, self.shard_axis)
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-6), max=1.0)

        lr = lr_schedule(cfg, state.step)
        f = np.float32
        t = f(state.step + 1)
        bc1 = float(f(1) - f(cfg.b1) ** t)
        bc2 = float(f(1) - f(cfg.b2) ** t)
        for p, pm, g, m, v in zip(flat_p, flat_master, flat_g, flat_m,
                                  flat_v):
            g = g.float() * scale
            m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
            upd = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
            # decay matrices only (norm scales / biases / scalars exempt)
            if p.dim() >= 2:
                upd.add_(pm, alpha=cfg.weight_decay)
            pm.sub_(upd.mul_(lr))
            p.copy_(self._gather(pm, p))  # at model precision
        new_state = OptState(state.step + 1, state.master, state.m, state.v,
                             state.err)
        return params, new_state, {"grad_norm": gnorm,
                                   "lr": torch.tensor(lr)}

    def _reduce(self, g):
        """The data-parallel reduction: psum over the data axes but the
        shard axis, then this rank's slice of the psum over it (fp32).
        With nothing to reduce, ``g`` itself (no fp32 copy of every leaf
        at once)."""
        axes = [a for a in self.data_axes
                if a != self.shard_axis and self.dist.axis_size(a) > 1]
        if not axes and self.shard_axis is None:
            return g
        g = g.float()
        for a in axes:
            g = self.dist.psum(g, a)
        if self.shard_axis is None:
            return g
        return self.dist.psum_scatter(_flat_pad(g, self.dp), self.shard_axis)

    def _compressed_reduce(self, g, err):
        """:meth:`_reduce` of ``g`` through int8 with error feedback: the
        residual ``err`` (this rank's slice under ZeRO-1) is added, the
        sum quantised with the data axes' shared scale, its dequantised
        values reduced; ``err`` becomes the rounding error, in place."""
        dist = self.dist
        g = g.float()
        e = err
        if self.shard_axis:  # the residual slices, whole
            e = dist.all_gather(err, self.shard_axis, dim=0)[
                :g.numel()].view(g.shape)
        gq = g + e
        amax = gq.abs().amax()
        for a in self.data_axes:
            amax = dist.pmax(amax, a)
        # tensor by tensor: a CUDA division by a Python scalar multiplies
        # by its reciprocal, which rounds differently
        scale = amax.clamp_min(1e-12) / torch.tensor(
            127.0, dtype=torch.float32, device=g.device)
        deq = torch.round(gq / scale).clamp_(-127, 127).mul_(scale)
        residual = gq.sub_(deq)
        red = deq
        for a in self.data_axes:
            if a != self.shard_axis:
                red = dist.psum(red, a)
        if self.shard_axis:
            red = dist.psum_scatter(_flat_pad(red, self.dp), self.shard_axis)
            residual = _flat_pad(residual, self.dp)[
                dist.axis_index(self.shard_axis)]
        err.copy_(residual)
        return red

    def _gather(self, pm, p):
        """The full leaf from every rank's master slice (or ``pm``)."""
        if self.shard_axis is None:
            return pm
        full = self.dist.all_gather(pm, self.shard_axis, dim=0)
        return full[:p.numel()].view(p.shape)
