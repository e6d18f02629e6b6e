"""Multi-pod dry-run (counterpart of ``repro.launch.dryrun``): trace every
(architecture x input shape) on the production meshes and report one
rank's memory, FLOPs and collective bytes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Single-pod mesh: ``(data 16, model 16)``, 256 devices.  Multi-pod mesh:
``(pod 2, data 16, model 16)``, 512 devices.

The reference lowers and compiles each cell for 512 host CPU devices and
reads the compiled program.  Here one process traces one rank of the
mesh: it joins a ``fake`` process group of the mesh's size (which moves
nothing), builds that rank's :class:`~repro_torch.core.dist.Dist`, and
runs the port's own step (``make_train_step``'s ``step_fn``, or
``make_serve_fns``' ``prefill_fn`` / ``decode_fn``) once under
``FakeTensorMode`` on the CPU device.  Parameters, optimizer state, batch
and caches are fake tensors shaped from ``param_specs``,
``global_batch_shapes`` and ``cache_shapes``, so nothing is allocated and
no weight is drawn.  The rank is the last on the model axis at pod and
data index 0: under the causal ring it runs the most rounds (the
reference's uniform program computes every round on every device).

What a record holds, against the reference's:

* ``flops``: ``FlopCounterMode``'s count of the rank's step.  An eager
  trace runs every layer, so ``flops == flops_raw``,
  ``collectives["extrapolated"]`` is false and the reference's 1-/2-unit
  extrapolation of a scanned body is not needed.
* ``collectives``: the rank's :class:`~repro_torch.core.dist.Census`, by
  the reference's per-device conventions (:func:`collective_census`).
* ``memory``: :class:`MemoryMeter`'s storage bytes: ``argument_bytes``
  (parameters, optimizer state, batch and caches as the step is given
  them), ``output_bytes`` (the new storages the step returns),
  ``peak_bytes`` (the most alive during the step, arguments included)
  and ``temp_bytes`` (peak less arguments).
* ``trace_s`` in place of ``lower_s`` and ``compile_s``; ``rank``, the
  traced rank's global index.

The reference's ``hlo_bytes``, ``hlo_bytes_raw`` and
``generated_code_bytes`` have no eager meaning and are left out.  The
trace runs the kernels' plain versions (the tensors are on the CPU), as
the reference's dry-run compiles its jnp path rather than its Pallas
kernels; it builds and launches no kernel.  Records go to
``results/dryrun_torch/``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
import weakref
from dataclasses import replace

import torch
import torch.distributed as tdist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

MESHES = {"pod": (16, 16), "multipod": (2, 16, 16)}
SKIP_REASON = ("long_500k requires sub-quadratic sequence mixing "
               "(configs.shape_applicable)")


# ---------------------------------------------------------------------------
# what a trace measures
# ---------------------------------------------------------------------------


class MemoryMeter(TorchDispatchMode):
    """Live storage bytes under a dispatch mode: each output storage's
    bytes are added when an op creates it and taken off when it is freed
    (``weakref.finalize`` on the storage, which lives as long as any
    tensor or autograd record holds it); ``peak`` is the most alive at
    once.  :meth:`track` adds tensors made before the mode."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._sizes: dict = {}

    def _free(self, key):
        self.live -= self._sizes.pop(key)

    def track(self, tensors) -> int:
        """Count the storages of ``tensors`` (a tree) not yet counted;
        returns the bytes of all of them."""
        total, seen = 0, set()
        for t in tree_flatten(tensors)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in seen:
                continue
            seen.add(key)
            total += st.nbytes()
            if key not in self._sizes:
                self._sizes[key] = st.nbytes()
                self.live += st.nbytes()
                weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)
        return total

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.track(out)
        return out


def collective_census(dist) -> dict:
    """The rank's collectives by kind (``count``, ``bytes``) and
    ``total_bytes``, from ``dist``'s census rather than HLO text, under
    the reference's conventions: collective-permute its output bytes,
    all-gather output less input, all-reduce twice its output,
    reduce-scatter input less output, all-to-all its output.  Nothing is
    extrapolated."""
    return {**dist.census.as_dict(), "extrapolated": False}


# ---------------------------------------------------------------------------
# the rank's arguments as fake tensors
# ---------------------------------------------------------------------------


def _empty(shapes, specs, dist, dtype=None):
    """Fake (or empty) tensors of each leaf's local shape: ``shapes``
    holds global shapes, or ``(shape, dtype)`` pairs; ``specs`` the
    layout (None: replicated)."""
    if isinstance(shapes, dict):
        return {k: _empty(v, specs[k] if specs else None, dist, dtype)
                for k, v in shapes.items()}
    if len(shapes) == 2 and isinstance(shapes[1], torch.dtype):
        shapes, dtype = shapes
    shape = list(shapes)
    for dim, entry in enumerate(specs or ()):
        shape[dim] //= dist.split(entry)[0]
    return torch.empty(shape, dtype=dtype)


def _arguments(cfg, shape, par, dist, bundle):
    """The step's arguments on this rank, as the step takes them: empty
    (fake under ``FakeTensorMode``) parameter shards, optimizer state,
    batch and caches."""
    from repro_torch.models import lm
    from repro_torch.models.transformer import param_shapes, param_specs
    from repro_torch.train.train_loop import (cache_shapes,
                                              global_batch_shapes,
                                              shard_batch)

    params = _empty(param_shapes(cfg), param_specs(cfg, par.strategy),
                    dist, getattr(torch, cfg.dtype))
    batch = _empty(global_batch_shapes(cfg, shape), None, dist)
    if shape.kind == "train":
        part = shard_batch(cfg, batch, dist, par.strategy)
        batch = {k: v.clone() for k, v in part.items()}
        return (params, bundle.opt.init(params), batch)
    if shape.kind == "prefill":
        return (params, batch)
    b = shape.global_batch
    caches = _empty(cache_shapes(cfg, shape, dist),
                    lm.cache_specs(bundle.ctx, b), dist)
    cache_len = torch.empty((b,), dtype=torch.int64)
    return (params, batch["tokens"], caches, cache_len)


def _storages(tree) -> dict:
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)}


def _new_bytes(out, args) -> int:
    """The bytes of ``out``'s storages that are not ``args``' (a step that
    updates its arguments in place returns them)."""
    old = _storages(args)
    return sum(n for k, n in _storages(out).items() if k not in old)


def _fake_world(n: int, rank: int):
    """A ``fake`` process group of ``n`` ranks as ``rank`` (none for one
    device)."""
    if n == 1:
        return contextlib.nullcontext()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    @contextlib.contextmanager
    def world():
        tdist.init_process_group("fake", store=FakeStore(), rank=rank,
                                 world_size=n)
        try:
            yield
        finally:
            tdist.destroy_process_group()

    return world()


def traced_rank(mesh_shape) -> int:
    """The global rank a cell traces: the last on the model axis at pod
    and data index 0."""
    return mesh_shape[-1] - 1


# ---------------------------------------------------------------------------
# per-cell trace
# ---------------------------------------------------------------------------


def trace_cell(cfg, shape, mesh_shape, strategy: str = "tatp",
               bidirectional: bool = True, par_overrides=None,
               opt_cfg=None, rank=None) -> dict:
    """Trace one rank (default :func:`traced_rank`) of ``cfg``'s step for
    ``shape`` on ``mesh_shape`` (``(data, model)`` or ``(pod, data,
    model)``) under ``FakeTensorMode`` on the CPU; ``opt_cfg`` the train
    step's :class:`AdamWConfig` (default the step's own).  Returns the
    record's measured part: ``rank``, ``n_devices``, ``trace_s``,
    ``flops``, ``collectives`` and ``memory``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core.dist import make_mesh_dist

    mesh_shape = tuple(mesh_shape)
    n = math.prod(mesh_shape)
    rank = traced_rank(mesh_shape) if rank is None else rank
    par = ParallelConfig(strategy=strategy, bidirectional=bidirectional)
    if par_overrides:
        par = replace(par, **par_overrides)
    t0 = time.perf_counter()
    with _fake_world(n, rank):
        dist = make_mesh_dist(mesh_shape, "cpu")
        step, bundle = _step(cfg, shape, par, dist, opt_cfg)
        with FakeTensorMode():
            got = measure(step, lambda: _arguments(cfg, shape, par, dist,
                                                   bundle), dist)
    return {"rank": rank, "n_devices": n,
            "trace_s": round(time.perf_counter() - t0, 3), **got}


def _step(cfg, shape, par, dist, opt_cfg=None):
    """``(step, bundle)``: the port's step for ``shape`` on ``dist``."""
    from repro_torch.train.train_loop import make_serve_fns, make_train_step

    if shape.kind == "train":
        bundle = make_train_step(cfg, par, dist, shape, opt_cfg)
        return bundle.step_fn, bundle
    bundle = make_serve_fns(cfg, par, dist)
    return (bundle.prefill_fn if shape.kind == "prefill"
            else bundle.decode_fn), bundle


def measure(step, make_args, dist) -> dict:
    """Run ``step(*make_args())`` once under :class:`MemoryMeter` and
    ``FlopCounterMode``, on fake tensors (inside ``FakeTensorMode``) or
    real ones alike: ``flops``, ``collectives`` (``dist``'s census of the
    step alone) and ``memory``."""
    from torch.utils.flop_counter import FlopCounterMode

    meter = MemoryMeter()
    with meter:
        args = make_args()
        arg_bytes = meter.track(args)
        meter.peak = meter.live
        dist.census.reset()
        with FlopCounterMode(display=False) as flops:
            out = step(*args)
        out_bytes = _new_bytes(out, args)
        peak = meter.peak
        del out, args
    return {
        "flops": float(flops.get_total_flops()),
        "collectives": collective_census(dist),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": peak - arg_bytes, "peak_bytes": peak},
    }


def lower_cell(arch: str, shape_name: str, mesh_kind: str,
               strategy: str = "tatp", bidirectional: bool = True,
               variant: str = "baseline", par_overrides: dict | None = None,
               cfg=None) -> dict:
    """One cell's record (the reference's ``lower_cell``): ``skipped``
    where the shape does not apply to the architecture, else the traced
    rank's figures (:func:`trace_cell`).  ``cfg`` replaces the registry's
    config of ``arch`` (a cut in depth)."""
    from repro_torch.configs import SHAPES, get_config, shape_applicable

    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": SKIP_REASON}
    got = trace_cell(cfg, shape, MESHES[mesh_kind], strategy,
                     bidirectional, par_overrides)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "strategy": strategy, "bidirectional": bidirectional,
        "variant": variant, "par_overrides": par_overrides or {},
        "status": "ok",
        "n_devices": got["n_devices"], "rank": got["rank"],
        "trace_s": got["trace_s"],
        "flops_raw": got["flops"], "flops": got["flops"],
        "collectives": got["collectives"],
        "memory": got["memory"],
        "params": cfg.param_count(),
        "active_params": cfg.param_count(active_only=True),
    }


def cell_id(arch, shape, mesh):
    return f"{arch}__{shape}__{mesh}"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod",
                                                      "both"])
    ap.add_argument("--strategy", default="tatp")
    ap.add_argument("--unidirectional", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    help="label for perf-iteration records")
    ap.add_argument("--zigzag", action="store_true")
    ap.add_argument("--remat-policy", default=None,
                    choices=[None, "full", "tatp_outputs"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--fp8", action="store_true",
                    help="fp8 wire for TATP weight + ring-KV streams")
    ap.add_argument("--ssm-log", action="store_true",
                    help="log2(R) Hillis-Steele SSM state relay")
    ap.add_argument("--ssm-wire-bf16", action="store_true")
    return ap


def par_overrides_of(args) -> dict:
    out = {}
    if args.zigzag:
        out["zigzag"] = True
    if args.remat_policy:
        out["remat_policy"] = args.remat_policy
    if args.no_remat:
        out["remat"] = False
    if args.fp8:
        out["stream_dtype"] = "fp8"
    if args.ssm_log:
        out["ssm_scan_mode"] = "log"
    if args.ssm_wire_bf16:
        out["ssm_state_wire"] = "bf16"
    return out


def main(argv=None, cfg_of=None) -> int:
    """The CLI; ``cfg_of(arch)``, if given, replaces the registry's config
    (the tests cut depth with it).  Returns the exit code: 1 if any cell
    failed."""
    from repro_torch.configs import ARCHITECTURES, SHAPES

    args = build_parser().parse_args(argv)
    overrides = par_overrides_of(args)
    os.makedirs(args.out, exist_ok=True)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s, m) for a in ARCHITECTURES for s in SHAPES
                 for m in meshes]
    else:
        cells = [(args.arch, args.shape, m) for m in meshes]

    failures = 0
    for arch, shape, mesh_kind in cells:
        suffix = "" if args.variant == "baseline" else f"__{args.variant}"
        path = os.path.join(args.out, cell_id(arch, shape, mesh_kind)
                            + suffix + ".json")
        if args.skip_existing and os.path.exists(path):
            print(f"skip {path}")
            continue
        print(f"=== {arch} × {shape} × {mesh_kind} [{args.variant}] ===",
              flush=True)
        try:
            rec = lower_cell(arch, shape, mesh_kind,
                             strategy=args.strategy,
                             bidirectional=not args.unidirectional,
                             variant=args.variant,
                             par_overrides=overrides or None,
                             cfg=cfg_of(arch) if cfg_of else None)
        except Exception as e:
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                   "status": "error", "error": f"{type(e).__name__}: {e}"}
            failures += 1
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        if rec["status"] == "ok":
            c = rec["collectives"]["total_bytes"]
            print(f"  ok: trace={rec['trace_s']}s"
                  f" flops={rec['flops']:.3g}"
                  f" coll={c/1e6:.1f}MB"
                  f" peak={rec['memory']['peak_bytes']/2**30:.2f}GiB",
                  flush=True)
        else:
            print(f"  {rec['status']}: {rec.get('reason', rec.get('error'))}",
                  flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
