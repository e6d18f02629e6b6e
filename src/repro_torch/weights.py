"""Carry the reference's weights across.

:func:`params_from_jax` takes ``repro``'s parameter tree as numpy arrays
(for example ``jax.tree.map(np.asarray, init_params(key, cfg))``) and
returns the port's parameters, leaf for leaf: both packages share the tree
layout and the ``[in, out]`` weight layout, so no leaf is transposed.
:func:`dnn_params_from_jax` does the same for the wafer cost surrogate's
MLP (``repro.wafer.dnn_cost``'s ``w{i}`` / ``b{i}`` dict).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dist import resolve_device
from repro_torch.models.transformer import param_shapes


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
