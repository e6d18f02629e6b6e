"""Carry the reference's weights across.

:func:`params_from_jax` takes ``repro``'s parameter tree as numpy arrays
(for example ``jax.tree.map(np.asarray, init_params(key, cfg))``) and
returns the port's parameters, leaf for leaf: both packages share the tree
layout and the ``[in, out]`` weight layout, so no leaf is transposed.
:func:`dnn_params_from_jax` does the same for the wafer cost surrogate's
MLP (``repro.wafer.dnn_cost``'s ``w{i}`` / ``b{i}`` dict).

Above model degree 1 each rank holds its shard of the tree
(``models/transformer.py:param_specs``): :func:`shard_params` slices a
full tree, and :func:`init_sharded_params` draws ``init_params``' values
leaf by leaf and keeps the rank's slice, so no rank ever holds the whole
model and the shards put back together are ``init_params``' tree bit for
bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dist import resolve_device
from repro_torch.models.common import dense_init, embed_init
from repro_torch.models.transformer import (_init_leaf, padded_vocab,
                                            param_shapes, param_specs)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "/"))
        else:
            out[name] = v
    return out


def _to_tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.kind not in "fiub":  # bfloat16 (ml_dtypes) and the like
        a = a.astype(np.float32)  # exact for bf16
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def params_from_jax(tree, cfg: ModelConfig, device, dtype=None):
    """The port's parameter tree from the reference's (numpy leaves).

    Every leaf of ``tree`` must match a leaf of the port's layout
    (:func:`param_shapes`) in name and shape, and every port leaf must be
    given; otherwise ``ValueError`` names the difference.  ``dtype``
    defaults to ``cfg.dtype``."""
    dtype = dtype or getattr(torch, cfg.dtype)
    want = _flat(param_shapes(cfg))
    got = _flat(tree)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    bad = sorted(n for n in set(want) & set(got)
                 if tuple(np.shape(got[n])) != tuple(want[n]))
    if missing or extra or bad:
        raise ValueError(
            f"parameter tree does not match {cfg.name}: missing {missing}, "
            f"unexpected {extra}, wrong shape {bad}"
        )

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _to_tensor(node, device, dtype)

    return conv(tree)


def dnn_params_from_jax(tree, device="cuda") -> dict:
    """The cost surrogate's MLP parameters (``repro_torch.wafer.dnn_cost``)
    from the reference's ``w{i}`` / ``b{i}`` dict (numpy leaves), as
    float32 tensors on ``device``.  Each ``w{i}`` is ``[in, out]`` with a
    ``b{i}`` of ``out``, layer ``i``'s ``out`` the next one's ``in``;
    otherwise ``ValueError``."""
    n = len(tree) // 2
    names = {f"{p}{i}" for i in range(n) for p in "wb"}
    shapes = {k: np.shape(v) for k, v in tree.items()}
    chained = set(tree) == names and all(
        len(shapes[f"w{i}"]) == 2
        and shapes[f"b{i}"] == (shapes[f"w{i}"][1],)
        and (i == 0 or shapes[f"w{i - 1}"][1] == shapes[f"w{i}"][0])
        for i in range(n))
    if not chained:
        raise ValueError(f"not an MLP parameter dict: {shapes}")
    dev = resolve_device(device)
    return {k: _to_tensor(v, dev, torch.float32) for k, v in tree.items()}


def _shard(t, spec, dist):
    """``t``'s block on this rank: each dim that ``spec`` shards over the
    model axis cut into ``R`` blocks, block ``axis_index``."""
    for dim, axis in enumerate(spec):
        if axis is not None and dist.axis_size(axis) > 1:
            n = dist.axis_size(axis)
            blk = t.shape[dim] // n
            t = t.narrow(dim, dist.axis_index(axis) * blk, blk)
    return t


def _map_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def shard_params(params, cfg: ModelConfig, strategy: str, dist):
    """This rank's shard of the full tree ``params`` by
    :func:`param_specs` (copies, so the full tree can be freed)."""
    return _map_specs(lambda t, spec: _shard(t, spec, dist).clone(), params,
                      param_specs(cfg, strategy))


def init_sharded_params(cfg: ModelConfig, generator: torch.Generator, dist,
                        strategy: str = "tatp"):
    """``init_params(cfg, generator, dist.device)``'s values, drawn in its
    order (the embedding, the head, then each stacked leaf by name, one
    rep at a time), of which this rank keeps its shard.  The largest
    staging is one full leaf of one rep (the embedding)."""
    dtype, dev = getattr(torch, cfg.dtype), dist.device
    kw = dict(dtype=dtype, device=dev)
    specs = param_specs(cfg, strategy)
    vp, d = padded_vocab(cfg), cfg.d_model
    params = {"embed": _shard(embed_init(generator, (vp, d), **kw),
                              specs["embed"], dist).clone(),
              "final_ln": torch.zeros(d, **kw)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _shard(dense_init(generator, (d, vp), in_dim=d,
                                              **kw),
                                   specs["lm_head"], dist).clone()
    shapes = param_shapes(cfg)

    def stacked(block, block_specs):
        out = {}
        for name, shape in sorted(block.items()):
            spec = block_specs[name][1:]
            reps = [_shard(_init_leaf(name, shape[1:], generator, **kw),
                           spec, dist).clone() for _ in range(shape[0])]
            out[name] = torch.stack(reps)
        return out

    params["layers"] = {u: stacked(b, specs["layers"][u])
                        for u, b in shapes["layers"].items()}
    if "shared" in shapes:
        params["shared"] = {
            name: _shard(_init_leaf(name, shape, generator, **kw),
                         specs["shared"][name], dist).clone()
            for name, shape in sorted(shapes["shared"].items())}
    if "enc" in shapes:
        params["enc"] = {"blocks": stacked(shapes["enc"]["blocks"],
                                           specs["enc"]["blocks"]),
                         "final_ln": torch.zeros(d, **kw)}
        params["cross"] = stacked(shapes["cross"], specs["cross"])
    return params
