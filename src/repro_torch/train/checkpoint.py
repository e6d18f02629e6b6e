"""Checkpointing (counterpart of ``repro.train.checkpoint``): atomic,
keep-k, restartable, and elastic over the ranks of a mesh.

The reference's on-disk layout, one directory per step::

    ckpt_dir/step_000100/
        manifest.json        # step, meta, every leaf's key, shape, dtype
        proc00.npz           # every leaf's global array
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

Over several ranks (``dist`` and ``specs``: each leaf's layout, the
parameters' ``param_specs`` and the optimizer's
:meth:`~repro_torch.train.optimizer.AdamW.state_specs`) every leaf is
stored as its global array, as the reference's single process writes it
(``proc00.npz``): a ring-sharded leaf gathered over ``model``, a ZeRO-1
slice (:class:`~repro_torch.train.optimizer.ZeroSlice`) gathered over
``data`` into its model shard's flat padded leaf, cropped to the shard and
gathered over ``model``, a replicated leaf from one rank.  So the files
do not depend on the mesh: a ZeRO-1 state is stored in its parameter's
shape, which is the reference's layout at data degree 1 (the reference's
own ZeRO-1 out spec, a 1-D concatenation over ``data`` replicated over
``model``, keeps one model rank's slices only).  :func:`restore` gives
every rank its block for the mesh it runs on, which may differ from the
writer's.  The reference's 1-D ZeRO-1 layout is read where it is exact:
its length the leaf's padded for this data degree, and the leaf whole on
this rank (not split over ``model``).  A leaf that cannot be placed raises
``ValueError`` naming it; nothing is padded or cropped but ZeRO-1's own
pad.

A replicated leaf's copies may differ between the ring's ranks (above
model degree 1 each rank clips by the norm of its own shards, as the
reference does).  Its global array is model rank 0's, as the reference's
out spec takes one device's; where the copies differ, ``proc00.npz`` also
holds them stacked under ``<key>@model`` (listed in the manifest's
``ring_copies``, which the reference's restore does not read), and a
restore at the same model degree gives each rank its own, so a restart is
bitwise the run it resumes.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.train.optimizer import ZeroSlice

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


COPIES = "@model"  # suffix of a replicated leaf's stacked per-ring-rank copies


def _flatten_specs(tree, specs, prefix=()) -> dict:
    """``{key: spec}``: ``specs`` read along ``tree``'s structure (a spec
    is itself a tuple, so it is taken whole where ``tree`` has a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten_specs(tree[k], specs[k], prefix + (str(k),)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for n in tree._fields:
            out.update(_flatten_specs(getattr(tree, n), getattr(specs, n),
                                      prefix + (f".{n}",)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, t in enumerate(tree):
            out.update(_flatten_specs(t, specs[i], prefix + (str(i),)))
        return out
    return {"/".join(prefix): specs}


def _sharded(spec, dist):
    """``(dim, axis, degree)`` of each dim ``spec`` lays over an axis of
    more than one rank."""
    return [(dim, axis, dist.axis_size(axis))
            for dim, axis in enumerate(spec or ())
            if axis is not None and dist.axis_size(axis) > 1]


def _global_leaf(leaf, spec, dist):
    """``(global, copies)`` of this rank's ``leaf`` (every rank calls this
    for every leaf, in one order: the gathers are collectives).  A leaf
    replicated over an axis of several ranks may still differ between
    them (above model degree 1 each rank clips by the norm of its own
    shards, as the reference does, so the ring's copies of a replicated
    leaf drift apart): its global array is model rank 0's, and ``copies``
    stacks every model rank's where they differ (else None)."""
    if not isinstance(leaf, torch.Tensor):
        return leaf, None
    if isinstance(spec, ZeroSlice):
        n = math.prod(spec.shape)
        flat = dist.all_gather(leaf, spec.axis, dim=0)
        leaf, spec = flat[:n].view(spec.shape), spec.spec
    sharded = _sharded(spec, dist)
    for dim, axis, _ in sharded:
        leaf = dist.all_gather(leaf, axis, dim=dim)
    mx = dist.model_axis
    if sharded or dist.axis_size(mx) == 1:
        return leaf, None
    copies = dist.all_gather(leaf[None], mx, dim=0)
    same = all(torch.equal(c, copies[0]) for c in copies[1:])
    return copies[0], None if same else copies


def _global_shape(shape, spec, dist):
    shape = list(shape)
    for dim, _, n in _sharded(spec, dist):
        shape[dim] *= n
    return tuple(shape)


def _block(arr, spec, dist):
    for dim, axis, n in _sharded(spec, dist):
        blk = arr.shape[dim] // n
        lo = dist.axis_index(axis) * blk
        arr = arr[(slice(None),) * dim + (slice(lo, lo + blk),)]
    return arr


def _place(key, arr, like, spec, dist):
    """This rank's block of the stored global ``arr`` for a leaf shaped
    like ``like`` (its local shard), laid out by ``spec``."""
    if isinstance(spec, ZeroSlice):
        dp, idx = dist.axis_size(spec.axis), dist.axis_index(spec.axis)
        n = math.prod(spec.shape)
        glob = _global_shape(spec.shape, spec.spec, dist)
        padded = n + (-n) % dp
        if tuple(arr.shape) == glob:
            flat = np.ascontiguousarray(_block(arr, spec.spec,
                                               dist)).reshape(-1)
            if padded > n:  # ZeRO-1's own pad
                flat = np.concatenate([flat, np.zeros(padded - n, flat.dtype)])
        elif arr.ndim == 1 and arr.shape[0] == padded and glob == spec.shape:
            flat = arr  # the reference's 1-D ZeRO-1 layout, exact here
        else:
            raise ValueError(
                f"{key}: a checkpoint leaf of shape {tuple(arr.shape)} "
                f"cannot be placed as ZeRO-1's slice over {dp} {spec.axis} "
                f"ranks of a leaf of global shape {glob} (its shard "
                f"{tuple(spec.shape)}): neither the leaf's global shape nor "
                f"the flat leaf padded to {padded}")
        k = padded // dp
        return flat[idx * k:(idx + 1) * k]
    glob = _global_shape(np.shape(like), spec, dist)
    if tuple(arr.shape) != glob:
        raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)}, "
                         f"template's global shape {glob}")
    return _block(arr, spec, dist)


def _several(dist) -> bool:
    return dist is not None and dist.n_devices > 1


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
         blocking: bool = True, meta: Optional[dict] = None, dist=None,
         specs: Any = None) -> str:
    """Write a checkpoint; returns its directory.  Idempotent: a step
    already published is left as it is.  ``meta`` lands verbatim in the
    manifest.  With ``blocking=False`` the files are written by a thread;
    every leaf is copied to the host before it starts.

    Over several ranks (``dist`` with more than one, and ``specs``, each
    leaf's layout in ``tree``'s structure) every rank calls ``save``: the
    leaves are gathered into their global arrays in one order on every
    rank, global rank 0 writes the files, and every rank passes a barrier
    after the publish; such a save blocks."""
    several = _several(dist)
    if several and not blocking:
        raise ValueError("a checkpoint over several ranks blocks: every "
                         "rank waits for the publish")
    tag = f"step_{step:08d}"
    final = os.path.join(ckpt_dir, tag)
    if os.path.exists(final):  # every rank sees it: it was published
        return final          # before this save began
    writer = not several or tdist.get_rank() == 0
    leaves = _flatten(tree)
    if several:
        spec_of = _flatten_specs(tree, specs)
        glob = [(k, _global_leaf(leaf, spec_of[k], dist))
                for k, leaf in leaves]
        leaves = [(k, g) for k, (g, _) in glob]
        copies = {k + COPIES: c for k, (_, c) in glob if c is not None}
    else:
        copies = {}
    if not writer:
        tdist.barrier()
        return final
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)  # stale tmp from a crashed writer
    os.makedirs(tmp, exist_ok=True)

    manifest = {
        "step": step,
        "meta": meta or {},
        "leaves": [{"key": k, "shape": list(np.shape(leaf)),
                    "dtype": _dtype_name(leaf)} for k, leaf in leaves],
    }
    if copies:
        manifest["ring_copies"] = sorted(copies)
    arrays = {k: _host(leaf) for k, leaf in [*leaves, *copies.items()]}

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
        if several:
            tdist.barrier()
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


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None,
            dist=None, specs: Any = None) -> tuple[Any, int]:
    """(tree, step): the checkpoint (latest by default) in ``template``'s
    structure, each tensor leaf new, on the template leaf's device and in
    its dtype; integer leaves come back as ints.  The checkpoint must hold
    exactly the template's leaves.  On one device they have the
    template's shapes; over several ranks (``dist`` and ``specs`` as
    :func:`save` takes them) every rank reads the global leaves and keeps
    its block for the mesh it runs on (``ValueError`` naming a leaf that
    cannot be placed there)."""
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
    spec_of = _flatten_specs(template, specs) if _several(dist) else None
    out = {}
    with np.load(os.path.join(d, "proc00.npz")) as data:
        for key, like in want.items():
            arr = data[key]
            if spec_of is not None and key + COPIES in data.files:
                mine = data[key + COPIES]  # this ring rank's own copy
                if mine.shape[0] == dist.axis_size(dist.model_axis):
                    arr = mine[dist.axis_index(dist.model_axis)]
            if spec_of is not None:
                arr = _place(key, arr, like, spec_of[key], dist)
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
