"""Checkpointing (counterpart of ``repro.train.checkpoint``) on one device:
atomic, keep-k, restartable.

The reference's on-disk layout, one directory per step::

    ckpt_dir/step_000100/
        manifest.json        # step, meta, every leaf's key, shape, dtype
        proc00.npz           # every leaf (one process, no shards)
    ckpt_dir/LATEST          # atomic pointer file

A step is written into ``step_%08d.tmp`` and renamed into place, then
``LATEST`` is rewritten through a rename, so a crash leaves either the old
or the new checkpoint published, never half of one.  Leaf keys are the
reference's: the tree flattened in ``jax.tree_util`` order (dict keys
sorted, tuples by index, NamedTuple fields as ``.name``) and joined with
``/``, e.g. ``0/layers/u0/wq`` and ``1/.master/embed`` for
``(params, opt_state)``.  The optimizer's integer step is stored as a 0-d
int32 leaf, as the reference's ``OptState.step`` array is.  numpy has no
bfloat16, so bf16 leaves are stored as their 16-bit patterns (uint16) with
``"bfloat16"`` in the manifest, and viewed back on restore.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

def _flatten(tree, prefix=()) -> list[tuple[str, Any]]:
    """(key, leaf) pairs in the reference's order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for n in tree._fields
                for kv in _flatten(getattr(tree, n), prefix + (f".{n}",))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, t in enumerate(tree)
                for kv in _flatten(t, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(template, leaves: dict, prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _unflatten(getattr(template, n), leaves, prefix + (f".{n}",))
            for n in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(t, leaves, prefix + (str(i),))
                              for i, t in enumerate(template))
    return leaves["/".join(prefix)]


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    if isinstance(leaf, (bool, int)):
        return "int32"
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf)}")


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (taken now, so later in-place updates of the
    tensor cannot reach the file)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf, np.int32)
    t = leaf.detach()
    if t.dtype == torch.bfloat16:  # numpy has none: keep the bit patterns
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(
            np.uint16)
    return t.to("cpu", copy=True).numpy()


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
         blocking: bool = True, meta: Optional[dict] = None) -> str:
    """Write a checkpoint; returns its directory.  Idempotent: a step
    already published is left as it is.  ``meta`` lands verbatim in the
    manifest.  With ``blocking=False`` the files are written by a thread;
    every leaf is copied to the host before it starts."""
    tag = f"step_{step:08d}"
    final = os.path.join(ckpt_dir, tag)
    if os.path.exists(final):
        return final
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)  # stale tmp from a crashed writer
    os.makedirs(tmp, exist_ok=True)

    leaves = _flatten(tree)
    manifest = {
        "step": step,
        "meta": meta or {},
        "leaves": [{"key": k, "shape": list(np.shape(leaf)),
                    "dtype": _dtype_name(leaf)} for k, leaf in leaves],
    }
    arrays = {k: _host(leaf) for k, leaf in leaves}

    def _write():
        np.savez(os.path.join(tmp, "proc00.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, final)  # atomic publish
        with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
            f.write(tag)
        os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
                   os.path.join(ckpt_dir, "LATEST"))
        _gc(ckpt_dir, keep)

    if blocking:
        _write()
    else:
        threading.Thread(target=_write, daemon=True).start()
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def read_meta(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """Manifest ``meta`` of a checkpoint (latest by default); {} if absent."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return {}
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")
    try:
        with open(path) as f:
            return json.load(f).get("meta", {})
    except (FileNotFoundError, json.JSONDecodeError):
        return {}


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip().split("_")[1])


def restore(ckpt_dir: str, template: Any,
            step: Optional[int] = None) -> tuple[Any, int]:
    """(tree, step): the checkpoint (latest by default) in ``template``'s
    structure, each tensor leaf new, on the template leaf's device and in
    its dtype; integer leaves come back as ints.  The checkpoint must hold
    exactly the template's leaves, in its shapes."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        dtypes = {leaf["key"]: leaf["dtype"]
                  for leaf in json.load(f)["leaves"]}
    want = dict(_flatten(template))
    if set(dtypes) != set(want):
        raise ValueError(
            f"checkpoint {d} does not match the template: missing "
            f"{sorted(set(want) - set(dtypes))}, unexpected "
            f"{sorted(set(dtypes) - set(want))}")
    out = {}
    with np.load(os.path.join(d, "proc00.npz")) as data:
        for key, like in want.items():
            arr = data[key]
            if tuple(arr.shape) != tuple(np.shape(like)):
                raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                                 f"template {tuple(np.shape(like))}")
            if not isinstance(like, torch.Tensor):
                out[key] = int(arr)
                continue
            if dtypes[key] == "bfloat16":  # stored as its bit patterns
                t = torch.from_numpy(np.array(arr).view(np.int16)).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            out[key] = t.to(device=like.device, dtype=like.dtype)
    return _unflatten(template, out), step
